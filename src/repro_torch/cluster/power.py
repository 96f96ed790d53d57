"""Node/rack power aggregation + the RAPL-style cap actuator.

The simulator and the live governor both price energy per *rank*; a
facility budget is enforced per *package* (node) and planned per *rack*.
This module rolls per-rank power series up that hierarchy and models the
one piece of physics the arbiter must respect: a cap command is not
instantaneous.  :class:`PowerCapActuator` commits a requested cap only
after ``latency`` seconds (the PCU/RAPL analogue of
``HwModel.switch_latency``) and applies the same theta discipline as the
``core.pstate`` timeout policies — ``theta_eff = theta + latency/2`` —
as a hysteresis window: requests that arrive inside it, or that move the
cap by less than the watt deadband, are suppressed rather than committed,
so a flapping arbiter cannot thrash the PCU faster than it can act.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.core.pstate import DEFAULT_HW, HwModel


def aggregate_power(series: np.ndarray, group_size: int) -> np.ndarray:
    """Sum a per-rank power series into per-group watts.

    ``series`` is ``(n_bins, n_ranks)`` (``SimResult.power_series``);
    returns ``(n_bins, n_groups)`` with a ragged final group when
    ``n_ranks % group_size != 0``.
    """
    if group_size <= 0:
        raise ValueError(f"group_size must be positive, got {group_size}")
    series = np.asarray(series, np.float64)
    n_bins, n_ranks = series.shape
    n_groups = -(-n_ranks // group_size)
    padded = np.zeros((n_bins, n_groups * group_size))
    padded[:, :n_ranks] = series
    return padded.reshape(n_bins, n_groups, group_size).sum(axis=2)


def node_power_series(result, ranks_per_node: int) -> np.ndarray:
    """Per-node watts from a ``SimResult`` run with ``power_dt`` set."""
    if result.power_series is None:
        raise ValueError(
            f"SimResult {result.name!r} has no power series — "
            f"run simulate(..., power_dt=...) to collect one"
        )
    return aggregate_power(result.power_series, ranks_per_node)


def rack_power_series(node_series: np.ndarray, nodes_per_rack: int) -> np.ndarray:
    """Per-rack watts from a per-node series (one more roll-up level)."""
    return aggregate_power(node_series, nodes_per_rack)


@dataclass
class CapCommit:
    """One committed cap change (requests that survive the hysteresis)."""

    t_request: float
    t_commit: float              # t_request + enforcement latency
    watts: float


@dataclass
class PowerCapActuator:
    """RAPL-style package/cluster cap with enforcement latency + hysteresis.

    ``request(t, watts)`` schedules a cap change that takes effect at
    ``t + latency``.  Two suppression rules (the pstate theta logic, turned
    around): a request inside ``theta_eff`` of the previous accepted
    request is dropped (rate limit — the PCU quantizes commits), and a
    request that moves the cap by less than ``deadband_w`` is dropped
    (watt hysteresis).  ``cap_at(t)`` is the enforced cap an observer —
    the simulator's ``power_cap`` input, a live governor — sees at ``t``.
    """

    cap_w: float                             # initial enforced cap
    latency: float = DEFAULT_HW.switch_latency
    theta: float = 500e-6
    deadband_w: float = 1.0
    floor_w: float = 0.0
    commits: List[CapCommit] = field(default_factory=list)
    n_suppressed: int = 0

    def __post_init__(self):
        self.theta_eff = self.theta + 0.5 * self.latency
        self._t_last_accept: Optional[float] = None

    @property
    def target_w(self) -> float:
        """The most recently accepted cap (committed or still in flight)."""
        return self.commits[-1].watts if self.commits else self.cap_w

    def request(self, t: float, watts: float) -> bool:
        """Ask for a new cap; returns True iff a commit was scheduled."""
        watts = max(float(watts), self.floor_w)
        if abs(watts - self.target_w) < self.deadband_w:
            self.n_suppressed += 1
            return False
        if self._t_last_accept is not None and t - self._t_last_accept < self.theta_eff:
            self.n_suppressed += 1
            return False
        self._t_last_accept = t
        self.commits.append(CapCommit(t, t + self.latency, watts))
        return True

    def cap_at(self, t: float) -> float:
        """The cap actually enforced at time ``t`` (commit-latency aware)."""
        cap = self.cap_w
        for c in self.commits:
            if c.t_commit <= t:
                cap = c.watts
            else:
                break
        return cap

    def f_cap_at(self, t: float, n_ranks: int, hw: HwModel = DEFAULT_HW) -> float:
        """The frequency clamp the enforced cap implies for ``n_ranks``."""
        return float(hw.f_for_power(self.cap_at(t) / max(n_ranks, 1), hw.act_comp))
