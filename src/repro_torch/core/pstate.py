"""P-state (DVFS) actuator and power model.

Modeled on the paper's target (Intel Broadwell E5-2697 v4, §3.2/§6.1):
  * nominal 2.3 GHz, all-core turbo ~2.8 GHz (baseline), min 1.2 GHz;
  * the PCU commits frequency changes only every ~500 µs (Hackenberg) —
    the *reason* the timeout policy exists;
  * package+DRAM power ≈ static + dynamic·(f/fmax)^3·activity, calibrated so
    MinFreq power saving ≈ 36 % (paper Table 3 average).

Frequency-sensitivity of run time uses the standard two-component model:
  T(f) = T(fmax) · ((1-β) + β · fmax/f)
with β the CPU-bound fraction of the phase (β=0: memory/network-bound).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class HwModel:
    f_min: float = 1.2e9
    f_nom: float = 2.3e9
    f_max: float = 2.8e9                 # all-core turbo (baseline)
    switch_latency: float = 500e-6       # PCU commit interval (Hackenberg)
    # three-component power model (relative to full-load at f_max = 1.0):
    #   P = p_base + p_uncore*mem_act + p_coredyn*core_act*(f/fmax)^3
    # calibrated so Min-Freq power saving under full load ~ 40 %
    # (paper Table 3 avg 36 %, range 26-51 %).
    p_base: float = 0.30                 # leakage + fixed uncore
    p_uncore: float = 0.25               # DRAM + LLC + fabric, ~ memory activity
    p_coredyn: float = 0.45              # core dynamic at f_max, activity 1
    watts_at_fmax: float = 10.1          # 145W TDP + ~36W DRAM over 18 cores
    # per-phase (core_activity, memory_activity):
    #   compute crunches (1,1); busy-wait spin has high issue rate but no
    #   memory traffic; copy stalls the core on DMA/NIC but keeps DRAM busy
    act_comp: Tuple[float, float] = (1.0, 1.0)
    act_slack: Tuple[float, float] = (0.6, 0.1)
    act_copy: Tuple[float, float] = (0.5, 0.9)

    def pstates(self) -> np.ndarray:
        """Available frequency grid (Hz): 1.2–2.3 in 100 MHz steps + turbo."""
        grid = np.arange(self.f_min, self.f_nom + 1e6, 0.1e9)
        return np.append(grid, self.f_max)

    # ---- power -----------------------------------------------------------
    def power(self, f, act: Tuple[float, float] = (1.0, 1.0)):
        """Relative package+DRAM power at frequency ``f`` (vectorized)."""
        f = np.asarray(f, dtype=np.float64)
        core_act, mem_act = act
        return (
            self.p_base
            + self.p_uncore * mem_act
            + self.p_coredyn * core_act * (f / self.f_max) ** 3
        )

    def watts(self, f, act: Tuple[float, float] = (1.0, 1.0)):
        return self.watts_at_fmax * self.power(f, act)

    def f_for_power(self, watts_per_rank, act: Tuple[float, float] = (1.0, 1.0)):
        """Largest frequency whose power stays under ``watts_per_rank``.

        The RAPL inverse of :meth:`watts`: a package cap is enforced by
        clamping the frequency, so a cap below the static + uncore floor
        maps to ``f_min`` (the PCU cannot shed leakage), and a cap above
        full-load power maps to ``f_max``.  Vectorized like the forward
        model.
        """
        rel = np.asarray(watts_per_rank, dtype=np.float64) / self.watts_at_fmax
        core_act, mem_act = act
        dyn = rel - self.p_base - self.p_uncore * mem_act
        f = self.f_max * np.cbrt(
            np.maximum(dyn, 0.0) / (self.p_coredyn * max(core_act, 1e-12))
        )
        return np.clip(f, self.f_min, self.f_max)

    # ---- timing ----------------------------------------------------------
    def slowdown(self, f, beta):
        """T(f)/T(fmax) for a phase with CPU-bound fraction ``beta``."""
        f = np.asarray(f, dtype=np.float64)
        return (1.0 - beta) + beta * (self.f_max / f)

    def theta_eff(self, theta: float) -> float:
        """Effective timeout threshold: timer expiry plus the expected PCU
        commit quantization (half the commit interval).  The one formula
        both the governor's pricing and the simulator's trajectory use —
        keep them identical or replay loses bit-exactness."""
        return theta + 0.5 * self.switch_latency

    def theta_bounds(self, theta_max: float = 50e-3) -> Tuple[float, float]:
        """Realizable reactive-timeout range ``[switch_latency/2, theta_max]``.

        Below half the PCU commit interval the timer fires faster than the
        hardware can commit the P-state change, so a smaller theta cannot
        be realized; above ``theta_max`` the timeout never fires in practice
        and the policy degenerates to baseline.  The :class:`~repro_torch.core.
        timeout.ThetaTuner` clamps every adjustment to this interval.
        """
        return (self.switch_latency / 2.0, theta_max)


DEFAULT_HW = HwModel()
