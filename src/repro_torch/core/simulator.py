"""Vectorized discrete-event engine for multi-rank MPI-style execution.

Semantics follow the paper's execution model (Fig. 1): each rank alternates
Tcomp -> (blocking comm = Tslack + Tcopy).  Collectives synchronize the whole
communicator; P2P synchronizes pairs.  Slack is *emergent*: the barrier
resolves when the critical rank arrives.  Policies act through

  * the compute P-state (Andante/Adagio/MinFreq),
  * a timeout during the comm (Fermata/COUNTDOWN: slack+copy;
    COUNTDOWN Slack/Adagio: barrier-isolated slack only),
  * per-call fixed costs (stack hash for proactive policies, artificial
    barrier for COUNTDOWN Slack / Andante / Adagio, timer syscalls),
  * the PCU commit latency: a restore issued at slack end leaves the core
    pinned at f_min for up to ``switch_latency`` into the next phase —
    the engine carries this residue (``ell``) across phases.

Everything is vectorized over ranks; one python-level loop over tasks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.events import EventBus
from repro_torch.core.policies import Policy
from repro_torch.core.pstate import DEFAULT_HW, HwModel

HASH_COST = 25e-6       # stack walk + hash + table lookup per MPI call (§6.4)
BARRIER_COST = 1.5e-6   # artificial MPI_Barrier / Isend+Wait pair latency
TIMER_COST = 0.5e-6     # setitimer syscall
PMU_COST = 15e-6        # Andante: per-region PMU reads + P-state computation


@dataclass
class Workload:
    """A generated multi-rank trace (base durations measured at f_max)."""

    name: str
    n_ranks: int
    comp: np.ndarray            # (T, N) compute work, f_max-seconds
    copy: np.ndarray            # (T,)   copy work, f_max-seconds
    is_p2p: np.ndarray          # (T,)   bool
    partner: np.ndarray         # (T, N) pair partner (valid where is_p2p)
    site: np.ndarray            # (T,)   call-site id ("stack hash")
    nbytes: np.ndarray          # (T,)   message payload bytes
    beta_comp: float = 0.3      # CPU-bound fraction of compute
    beta_copy: float = 0.15     # CPU-bound fraction of copy
    copy_jitter: Optional[np.ndarray] = None    # (T,N) per-rank copy factor
    overlap: Optional[np.ndarray] = None        # (T,) async dispatch->wait secs:
                                                # compute hidden under the flying
                                                # collective (non-slack)

    @property
    def n_tasks(self) -> int:
        return self.comp.shape[0]

    @property
    def n_sites(self) -> int:
        return int(self.site.max()) + 1


@dataclass
class SimResult:
    name: str
    time: float                 # wall time (s) = slowest rank
    energy: float               # watt-seconds, summed over ranks
    tcomp: float                # per-rank-summed phase seconds
    tslack: float
    tcopy: float
    exploited: float            # seconds spent at f_min inside comm phases
    exploited_slack: float      # ... restricted to slack
    calls: int
    power_dt: float = 0.0                           # bin width (s), 0 = off
    power_series: Optional[np.ndarray] = None       # (n_bins, n_ranks) watts
    toverlap: float = 0.0                           # overlap booked non-slack (s)
    theta_series: Optional[np.ndarray] = None       # (T,) theta_eff armed per task
    theta_bins: Optional[np.ndarray] = None         # (n_bins,) theta_eff active
                                                    # per power_dt bin
    n_prearm: int = 0                               # predictive pre-arms issued
    n_mispredict: int = 0                           # ... whose slack fell short
    n_guard_trips: int = 0                          # sites tripped to pure tuner
    t_dvfs_stretch: float = 0.0                     # per-rank-summed seconds of
    # busy-phase stretch induced by DVFS actions (pinned residue bleeding
    # into compute/copy, and comm-scope copies run below f_run) — the cost
    # the runtime's rho budget bounds against busy time

    def overhead_vs(self, base: "SimResult") -> float:
        return 100.0 * (self.time / base.time - 1.0)

    def dvfs_cost_pct(self) -> float:
        """DVFS-induced busy-time cost, percent — the quantity the paper's
        1% budget (``rho``) actually constrains: per-rank stretch seconds
        from downshift residue over per-rank busy seconds.  Unlike
        :meth:`overhead_vs`, barrier absorption cannot hide it — a rank's
        stretch counts even when another rank's wait swallows it."""
        busy = self.tcomp + self.tslack + self.tcopy
        return 100.0 * self.t_dvfs_stretch / busy if busy > 0 else 0.0

    def energy_saving_vs(self, base: "SimResult") -> float:
        return 100.0 * (1.0 - self.energy / base.energy)

    def power_saving_vs(self, base: "SimResult") -> float:
        p_self = self.energy / self.time
        p_base = base.energy / base.time
        return 100.0 * (1.0 - p_self / p_base)


@dataclass
class TraceRecord:
    """Per-(task, rank) baseline trace for analysis / ML (paper §6.2)."""

    site: np.ndarray            # (T,)
    is_p2p: np.ndarray          # (T,)
    nbytes: np.ndarray          # (T,)
    comp: np.ndarray            # (T, N) realized durations at f_max
    slack: np.ndarray           # (T, N)
    copy: np.ndarray            # (T, N)
    partner: Optional[np.ndarray] = None    # (T, N) p2p pair partner — feeds
    # the locality feature (node distance of the pair) in predictor.py


def _phase(hw: HwModel, work, beta, f, ell, activity):
    """Run ``work`` f_max-seconds of work at frequency ``f`` with the first
    ``ell`` seconds pinned at f_min.  Returns (duration, energy, ell_left)."""
    work = np.asarray(work, dtype=np.float64)
    slow_min = hw.slowdown(hw.f_min, beta)
    slow_f = hw.slowdown(f, beta)
    w_pin = ell / slow_min                              # work done while pinned
    full_pin = w_pin >= work
    dur = np.where(full_pin, work * slow_min, ell + (work - w_pin) * slow_f)
    ell_left = np.where(full_pin, ell - work * slow_min, 0.0)
    t_min = np.minimum(ell, dur)
    energy = hw.watts(hw.f_min, activity) * t_min + hw.watts(f, activity) * np.maximum(
        dur - t_min, 0.0
    )
    return dur, energy, ell_left


def _two_rate_phase(hw: HwModel, work, beta, t_hi, f_hi, activity):
    """Work at ``f_hi`` for up to ``t_hi`` seconds, then f_min until done."""
    work = np.asarray(work, dtype=np.float64)
    t_hi = np.minimum(t_hi, 1e30)                       # keep inf out of arithmetic
    slow_hi = hw.slowdown(f_hi, beta)
    slow_min = hw.slowdown(hw.f_min, beta)
    w_hi = t_hi / slow_hi
    fits = w_hi >= work
    dur = np.where(fits, work * slow_hi, t_hi + (work - w_hi) * slow_min)
    t_at_hi = np.minimum(dur, t_hi)
    t_at_min = np.maximum(dur - t_hi, 0.0)
    energy = hw.watts(f_hi, activity) * t_at_hi + hw.watts(hw.f_min, activity) * t_at_min
    return dur, energy, t_at_min


def _bin_energy(series: np.ndarray, dt: float, t0, dur, e) -> None:
    """Deposit per-rank phase energies uniformly over their time spans into
    ``series`` (n_bins, n_ranks) watt bins.  Vectorized for the common case
    (phase inside one bin); only bin-spanning ranks take the python path."""
    n_bins = series.shape[0]
    t0 = np.asarray(t0, np.float64)
    dur = np.maximum(np.asarray(dur, np.float64), 0.0)
    e = np.asarray(e, np.float64)
    b0 = np.clip((t0 / dt).astype(np.int64), 0, n_bins - 1)
    b1 = np.clip(((t0 + dur) / dt).astype(np.int64), 0, n_bins - 1)
    same = b0 == b1
    idx = np.arange(series.shape[1])
    np.add.at(series, (b0[same], idx[same]), e[same] / dt)
    for r in np.nonzero(~same)[0]:
        bins = np.arange(b0[r], b1[r] + 1)
        lo = np.maximum(bins * dt, t0[r])
        hi = np.minimum((bins + 1) * dt, t0[r] + dur[r])
        series[bins, r] += e[r] * np.clip(hi - lo, 0.0, None) / dur[r] / dt


def simulate(
    wl: Workload,
    pol: Policy,
    hw: HwModel = DEFAULT_HW,
    collect_trace: bool = False,
    power_dt: Optional[float] = None,
    power_cap: Optional[float] = None,
    overlap_aware: bool = True,
    bus: Optional[EventBus] = None,
    ingest: str = "event",
) -> Tuple[SimResult, Optional[TraceRecord]]:
    """Run ``wl`` under ``pol``.

    ``power_dt`` turns on the per-interval power series: phase energies are
    binned into ``power_dt``-second buckets per rank and returned on
    ``SimResult.power_series`` (the cluster layer aggregates these into
    node/rack watts — DESIGN.md §7).

    ``power_cap`` is the external cap input in aggregate watts over this
    workload's ranks: the RAPL semantics, enforced by clamping every
    frequency the policy would choose to ``hw.f_for_power(cap / n_ranks)``
    (inverted at compute activity, the worst case).

    ``overlap_aware`` governs how ``Workload.overlap`` (async dispatch->wait
    compute hidden under a flying collective) is accounted.  Aware (the
    5-phase taxonomy, default): overlapped seconds are busy compute — priced
    at compute activity, excluded from slack, never downshifted.  Unaware
    (the legacy 3-phase view, for contrast): the whole in-barrier window
    counts as slack, so the timeout can pin the core *while it is computing*
    — the pinned overlap stalls the hidden compute and the rank pays the
    lost work back after the barrier (the "misprediction jeopardizes the
    benefit" failure mode, measurable).

    ``theta_mode="adaptive"`` policies run an online
    :class:`~repro_torch.core.timeout.ThetaTuner`: theta for task ``k`` is the
    tuner's per-site value armed *before* observing task ``k`` (same
    causality as the live governor).  The per-task thresholds come back on
    ``SimResult.theta_series`` (and, with ``power_dt``, resampled onto the
    power bins as ``theta_bins``).

    ``bus`` makes the simulator a producer of the canonical event stream
    (:mod:`repro_torch.core.events`): each task's realized per-rank phases are
    published as 5-phase events (``dispatch_enter``/``wait_enter`` for
    overlapped tasks, ``barrier_enter`` otherwise, then ``barrier_exit``
    and ``copy_exit``) with the task's *site* as the recurring call id, so
    a live :class:`~repro_torch.core.governor.Governor`, a trace recorder, or
    any other subscriber consumes simulated runs through exactly the
    pipeline the instrumented collectives feed.  Zero cost when ``None``.

    ``ingest`` selects the production path when ``bus`` is set: ``"event"``
    publishes one call per event (the legacy path); ``"batched"`` buffers
    each task's per-rank phase columns in a :class:`~repro_torch.core.events.
    BatchAccumulator` and publishes full columnar chunks through
    ``publish_batch`` — the same events in the same stream order, so any
    subscriber sees an identical stream either way (the batched-ingest
    equivalence suite holds the governor to bit-for-bit on this).
    """
    if ingest not in ("event", "batched"):
        raise ValueError(ingest)
    n, t_tasks = wl.n_ranks, wl.n_tasks
    fmax, fmin, lat = hw.f_max, hw.f_min, hw.switch_latency
    grid = hw.pstates()
    # `is not None`, not truthiness: a 0 W cap means "pin to f_min" (the
    # inverse maps it there), the opposite of uncapped
    f_cap = float(hw.f_for_power(power_cap / n, hw.act_comp)) if power_cap is not None else fmax
    f_run = min(fmax, f_cap)                            # capped "full speed"

    t = np.zeros(n)
    ell = np.zeros(n)                                   # pinned-at-fmin residue
    energy = np.zeros(n)
    tcomp = tslack = tcopy = 0.0
    exploited = exploited_slack = toverlap = 0.0
    t_stretch = 0.0              # DVFS-induced busy stretch (rho's denominator
    #                              is busy time; barriers cannot absorb this)

    tuner = None
    hybrid = None                # PredictiveTuner view of tuner, when predictive
    if pol.theta_mode == "adaptive" and pol.comm_mode == "timeout":
        from repro_torch.core.timeout import ThetaTuner   # deferred: keeps import light

        tuner = ThetaTuner(hw=hw, theta0=pol.theta)
    elif pol.theta_mode in ("predictive", "predict_only") and pol.comm_mode == "timeout":
        from repro_torch.core.timeout import PredictiveTuner

        # predict_only is the paper's prediction-only strawman: pre-arm on
        # ANY predicted slack, with no reactive fallback, no guard, and no
        # arm bar (PredictiveTuner zeroes the bar for that configuration)
        _hyb = pol.theta_mode == "predictive"
        tuner = hybrid = PredictiveTuner(
            hw=hw, theta0=pol.theta, reactive=_hyb, guarded=_hyb,
        )
    arm_eff = hw.theta_eff(0.0)  # a pre-armed downshift waits only for the
    # PCU commit quantization, not for any timer
    theta_series = np.full(t_tasks, np.nan)
    t_arm = np.zeros(t_tasks)                           # theta arm time per task

    # per-site last-value tables
    n_sites = wl.n_sites
    last_comm = np.full((n_sites, n), np.nan)           # fermata
    last_comp = np.full((n_sites, n), np.nan)           # andante (work units)
    last_slack = np.full((n_sites, n), np.nan)

    trace_comp = np.zeros((t_tasks, n)) if collect_trace else None
    trace_slack = np.zeros((t_tasks, n)) if collect_trace else None
    trace_copy = np.zeros((t_tasks, n)) if collect_trace else None

    # (start, duration, energy) per-rank segments for the power series
    segs: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    acc = None
    ranks_col = None
    if bus is not None and ingest == "batched":
        from repro_torch.core.events import BatchAccumulator

        acc = BatchAccumulator(max(65536, n))
        ranks_col = np.arange(n, dtype=np.int32)

        def push_phase(code: int, times: np.ndarray) -> None:
            if acc.free < n:
                bus.publish_batch(acc.flush())
            acc.extend(ranks_col, np.full(n, code, dtype=np.int8),
                       np.full(n, site, dtype=np.int64),
                       np.asarray(times, dtype=np.float64))

    for k in range(t_tasks):
        site = int(wl.site[k])
        work = wl.comp[k].astype(np.float64).copy()

        # ---- per-call fixed costs (CPU work at current frequency) ----
        if pol.uses_hash:
            work = work + HASH_COST
        if pol.uses_barrier:
            work = work + BARRIER_COST
        if pol.comm_mode in ("timeout", "predict_timeout"):
            work = work + TIMER_COST
        if pol.compute_mode == "andante":
            work = work + PMU_COST

        # ---- compute P-state ----
        if pol.compute_mode == "max":
            f_comp = np.full(n, fmax)
        elif pol.compute_mode == "min":
            f_comp = np.full(n, fmin)
        else:                                           # andante
            pred_w = last_comp[site]
            pred_s = last_slack[site]
            have = ~np.isnan(pred_w) & ~np.isnan(pred_s) & (pred_w > 0)
            # lowest f with W*slow(f) <= W + S  ->  f >= fmax / (1 + S/(W*beta))
            with np.errstate(divide="ignore", invalid="ignore"):
                f_req = fmax / (1.0 + pred_s / (pred_w * max(wl.beta_comp, 1e-9)))
            idx = np.searchsorted(grid, np.nan_to_num(f_req, nan=fmax))
            idx = np.clip(idx, 0, len(grid) - 1)
            f_comp = np.where(have, grid[idx], fmax)
        f_comp = np.minimum(f_comp, f_run)              # external cap clamp

        d_comp, e_comp, ell = _phase(hw, work, wl.beta_comp, f_comp, ell, hw.act_comp)
        # residue-free counterfactual is closed-form: work at f_comp
        t_stretch += float(np.sum(d_comp - work * hw.slowdown(f_comp, wl.beta_comp)))
        energy += e_comp
        tcomp += float(d_comp.sum())
        if power_dt:
            segs.append((t.copy(), d_comp, e_comp))
        arrival = t + d_comp

        # ---- barrier resolution ----
        if wl.is_p2p[k]:
            partner = wl.partner[k]
            t_bar = np.maximum(arrival, arrival[partner])
        else:
            t_bar = np.full(n, arrival.max())
        slack = t_bar - arrival

        # ---- overlap isolation (5-phase accounting) ----
        # dispatch->wait: EVERY rank (critical one included) computes ov_k
        # seconds under the flying collective before blocking on the wait,
        # so the barrier resolves ov_k later and per-rank slack is
        # unchanged — the overlap must not be clamped by emergent slack or
        # the critical rank's overlapped compute would vanish from time,
        # energy and toverlap
        ov_k = float(wl.overlap[k]) if wl.overlap is not None else 0.0
        if ov_k > 0.0:
            ov = np.full(n, ov_k)
            t_bar = t_bar + ov_k
            if overlap_aware:
                window = slack                          # t_bar - (arrival + ov)
                window_start = arrival + ov
                e_ov = hw.watts(f_comp, hw.act_comp) * ov
                energy += e_ov
                if power_dt:
                    segs.append((arrival, ov, e_ov))
                toverlap += float(ov.sum())
            else:
                # 3-phase view: slack measured from dispatch — inflated by
                # the busy overlap, which the timeout may then pin (energy
                # for the overlap span is priced below, once the pinned
                # split is known)
                window = slack + ov
                window_start = arrival
        else:
            ov = None
            window = slack
            window_start = arrival
        tslack += float(window.sum())

        # ---- per-task theta: the policy constant, or the tuner's value
        # armed before this task's slack is observed (online causality) ----
        theta_k = tuner.theta_for(site) if tuner is not None else pol.theta
        theta_eff = hw.theta_eff(theta_k)               # + PCU commit quantization
        if pol.comm_mode in ("timeout", "predict_timeout"):
            theta_series[k] = theta_eff
        t_arm[k] = float(arrival.min())

        # ---- slack trajectory ----
        preds = prearm = None
        if pol.comm_mode == "pin_min":                  # minfreq: already low
            armed = np.zeros(n, dtype=bool)
            t_hi = np.zeros(n)
            f_slack_hi = np.full(n, fmin)
        elif pol.comm_mode == "timeout":
            armed = np.ones(n, dtype=bool)
            if hybrid is not None:
                # pre-arm decision BEFORE this task's slack is observed
                # (same causality as the live governor's decide())
                preds, pred_src = hybrid.predict_ranks(site, n)
                prearm = hybrid.arm_mask(site, preds)
                hi_armed = np.minimum(window, arm_eff)
                if hybrid.reactive:                     # hybrid: timeout fallback
                    t_hi = np.where(prearm, hi_armed, np.minimum(window, theta_eff))
                else:                                   # prediction-only strawman
                    t_hi = np.where(prearm, hi_armed, window)
            else:
                t_hi = np.minimum(window, theta_eff)
            f_slack_hi = f_comp
        elif pol.comm_mode == "predict_timeout":        # fermata
            armed = np.nan_to_num(last_comm[site], nan=0.0) >= 2.0 * theta_k
            t_hi = np.where(armed, np.minimum(window, theta_eff), window)
            f_slack_hi = f_comp
        else:                                           # none
            armed = np.zeros(n, dtype=bool)
            t_hi = window
            f_slack_hi = f_comp
        t_lo = window - t_hi
        fired = t_lo > 0            # downshift engaged within the window
        # PCU serialization: the restore issued at slack end completes one
        # switch latency after the in-flight down leg commits, pinning the
        # next phase for max(lat, 2*lat - window).  Timer paths always have
        # window >= theta_eff >= lat when they fire (the down leg committed
        # long before the restore), which leaves the residue at lat — only
        # pre-armed short slacks pay the early-restore penalty
        resid = np.maximum(lat, 2.0 * lat - window)
        if prearm is not None:
            # a pre-armed rank issues the P-state command at comm entry
            # even if the slack ends mid-transition — the residue applies
            # regardless of whether t_lo ever opened
            fired = fired | prearm
        if ov is not None and not overlap_aware:
            # unaware contrast: the window's head is busy overlap, not idle.
            # The timer cannot tell: past theta_eff it pins the core WHILE
            # IT COMPUTES — the pinned overlap runs compute at f_min and
            # the lost work is paid back after the barrier (delaying this
            # rank); only the idle tail is true slack-activity time
            pinned_ov = np.maximum(ov - t_hi, 0.0)
            e_ov = hw.watts(f_comp, hw.act_comp) * (ov - pinned_ov)
            e_ov = e_ov + hw.watts(fmin, hw.act_comp) * pinned_ov
            energy += e_ov
            if power_dt:
                segs.append((arrival, ov, e_ov))
            t_hi_idle = np.maximum(t_hi - ov, 0.0)
            e_slack = hw.watts(f_slack_hi, hw.act_slack) * t_hi_idle
            e_slack = e_slack + hw.watts(fmin, hw.act_slack) * (slack - t_hi_idle)
            seg_start, seg_dur = arrival + ov, slack
            penalty = pinned_ov * (hw.slowdown(fmin, wl.beta_comp) - 1.0)
            e_pen = hw.watts(f_run, hw.act_comp) * penalty
            energy += e_pen
            # the payback window sits AFTER the copy phase — its power
            # series segment is appended once d_copy is known, so the bins
            # around t_bar don't stack copy + payback watts while the real
            # payback window reads zero
        else:
            e_slack = hw.watts(f_slack_hi, hw.act_slack) * t_hi
            e_slack = e_slack + hw.watts(fmin, hw.act_slack) * t_lo
            seg_start, seg_dur = window_start, window
            penalty = 0.0
            e_pen = None
        energy += e_slack
        if power_dt:
            segs.append((seg_start, seg_dur, e_slack))
        exploited += float(t_lo.sum())
        exploited_slack += float(t_lo.sum())
        if pol.comm_mode == "pin_min":
            exploited += float(window.sum())
            exploited_slack += float(window.sum())

        if tuner is not None:
            # busy denominator must match the live governor's: its comp gap
            # (enter minus previous phase end) spans the dispatch->wait
            # overlap, so count ov here too (unaware mode already carries
            # it inside the inflated window)
            comp_obs = d_comp + ov if (ov is not None and overlap_aware) else d_comp
            tuner.observe_slack_batch(site, window, t=float(t_bar.max()),
                                      comp=comp_obs)
            if hybrid is not None and prearm is not None:
                # guard bookings (c_down per mispredicted pre-arm) + the
                # predictor's training rows for this task
                hybrid.account_outcome_batch(site, preds, window, prearm,
                                             t=float(t_bar.max()),
                                             source=pred_src, comp=comp_obs)

        # ---- copy phase ----
        wc = float(wl.copy[k])
        jit = wl.copy_jitter[k] if wl.copy_jitter is not None else 1.0
        if wc > 0.0:
            wc_r = np.full(n, wc) * jit
            if pol.comm_mode == "pin_min":
                d_copy, e_copy, _ = _phase(
                    hw, wc_r, wl.beta_copy, np.full(n, fmin),
                    np.zeros(n), hw.act_copy,
                )
                t_min_in_copy = d_copy
            elif pol.comm_mode in ("timeout", "predict_timeout") and pol.comm_scope == "comm":
                # timer keeps running inside the MPI call: after theta_eff
                # total in-call time, frequency drops; copy may start below it
                if prearm is not None:
                    # pre-armed ranks committed the downshift at entry
                    # (effective after the arm quantization); the rest
                    # follow the reactive timer, or never fire for the
                    # prediction-only strawman
                    fallback = theta_eff if hybrid.reactive else np.inf
                    t_to_fire = np.maximum(
                        np.where(prearm, arm_eff, fallback) - window, 0.0
                    )
                else:
                    t_to_fire = np.where(armed, np.maximum(theta_eff - window, 0.0), np.inf)
                d_copy, e_copy, t_min_in_copy = _two_rate_phase(
                    hw, wc_r, wl.beta_copy, t_to_fire, f_run, hw.act_copy
                )
                # restore at MPI exit pins the next phase start at f_min
                ell = np.where(t_min_in_copy > 0, lat, ell)
            else:
                # slack scope: frequency restored at barrier exit; commit
                # latency pins the start of the copy at f_min
                ell = np.where(fired, resid, ell)
                d_copy, e_copy, ell = _phase(
                    hw, wc_r, wl.beta_copy, np.full(n, f_run),
                    ell, hw.act_copy,
                )
                t_min_in_copy = np.minimum(d_copy, np.where(fired, resid, 0.0))
            energy += e_copy
            tcopy += float(d_copy.sum())
            # any copy time beyond the full-speed copy is DVFS-induced
            # (residue bleed in slack scope, deliberate in comm scope)
            t_stretch += float(np.sum(d_copy - wc_r * hw.slowdown(f_run, wl.beta_copy)))
            if power_dt:
                segs.append((t_bar, d_copy, e_copy))
            exploited += float(np.sum(t_min_in_copy))
            t = t_bar + d_copy + penalty
            if power_dt and e_pen is not None:
                segs.append((t_bar + d_copy, penalty, e_pen))
            if tuner is not None:
                # feedback: realized copy slowdown of this task's downshifted
                # ranks vs the residue-free copy (known exactly offline, the
                # EMA estimate live) — the AIMD raise trigger
                base_copy = wc_r * hw.slowdown(f_run, wl.beta_copy)
                pinned = t_lo > 0
                extra = frac = 0.0
                if pinned.any():
                    extra = float(np.max(d_copy[pinned] - base_copy[pinned]))
                    frac = float(np.max(
                        d_copy[pinned] / np.maximum(base_copy[pinned], 1e-30) - 1.0
                    ))
                tuner.observe_copy_slowdown(site, float(d_copy.sum()), extra,
                                            frac, t=float(t.max()))
                if hybrid is not None:
                    hybrid.predictor.note_copy_ranks(site, d_copy)
                    if prearm is not None and prearm.any():
                        # stretch on ranks ONLY the pre-arm downshifted
                        # (reactive theta would not have fired) is
                        # misprediction cost — book it to the guard
                        mis = prearm & (window < theta_eff)
                        if mis.any():
                            extras = d_copy[mis] - base_copy[mis]
                            fracs = (d_copy[mis]
                                     / np.maximum(base_copy[mis], 1e-30) - 1.0)
                            hybrid.guard_copy_batch(site, extras, fracs,
                                                    t=float(t.max()))
        else:
            # pure synchronization primitive: restore pins next compute
            if pol.comm_scope == "slack" or pol.comm_mode in ("timeout", "predict_timeout"):
                ell = np.where(fired, resid, ell)
            t = t_bar + penalty
            if power_dt and e_pen is not None:
                segs.append((t_bar, penalty, e_pen))

        # ---- synthetic event production (the canonical vocabulary) ----
        if bus is not None:
            # the site is the recurring call id, so a governor subscriber
            # rotates occurrences exactly as with instrumented collectives.
            # The async split is published only in overlap-aware mode —
            # the naive 3-phase contrast prices the whole window as slack,
            # so its stream starts the barrier at the window start too
            # (subscriber reports track the SimResult they ride along with)
            if acc is not None:
                if ov_k > 0.0 and overlap_aware:
                    push_phase(3, arrival)
                    push_phase(4, arrival + ov_k)
                else:
                    push_phase(0, window_start)
                push_phase(1, t_bar)
                if wc > 0.0:
                    push_phase(2, t_bar + d_copy)
            elif ov_k > 0.0 and overlap_aware:
                for r in range(n):
                    bus.publish(r, "dispatch_enter", site, float(arrival[r]))
                for r in range(n):
                    bus.publish(r, "wait_enter", site, float(arrival[r] + ov_k))
            else:
                for r in range(n):
                    bus.publish(r, "barrier_enter", site, float(window_start[r]))
            if acc is None:
                for r in range(n):
                    bus.publish(r, "barrier_exit", site, float(t_bar[r]))
                if wc > 0.0:
                    copy_ends = t_bar + d_copy
                    for r in range(n):
                        bus.publish(r, "copy_exit", site, float(copy_ends[r]))

        # ---- table updates (what the runtime could actually measure) ----
        if pol.comm_mode == "predict_timeout":
            last_comm[site] = (t - arrival)             # slack + copy
        if pol.compute_mode == "andante":
            last_comp[site] = work
            last_slack[site] = slack

        if collect_trace:
            trace_comp[k] = d_comp
            trace_slack[k] = slack
            trace_copy[k] = t - t_bar

    if acc is not None and len(acc):
        bus.publish_batch(acc.flush())      # tail chunk: no event left behind

    power_series = None
    if power_dt:
        wall = float(t.max())
        n_bins = max(int(np.ceil(wall / power_dt)), 1)
        power_series = np.zeros((n_bins, n))
        for t0_seg, dur_seg, e_seg in segs:
            _bin_energy(power_series, power_dt, t0_seg, dur_seg, e_seg)

    has_theta = bool(np.isfinite(theta_series).any())
    theta_bins = None
    if power_series is not None and has_theta:
        # theta as a per-bin series: the threshold armed at each power bin
        # (piecewise-constant between task arm times)
        bin_end = (np.arange(power_series.shape[0]) + 1) * power_dt
        idx = np.clip(np.searchsorted(t_arm, bin_end, side="right") - 1,
                      0, t_tasks - 1)
        theta_bins = theta_series[idx]

    n_prearm = n_mispredict = n_trips = 0
    if hybrid is not None:
        for g in hybrid.guard_summary().values():
            n_prearm += int(g["n_armed"])
            n_mispredict += int(g["n_mispredict"])
            n_trips += int(g["tripped"])
    res = SimResult(
        name=pol.name,
        time=float(t.max()),
        energy=float(energy.sum()),
        tcomp=tcomp,
        tslack=tslack,
        tcopy=tcopy,
        exploited=exploited,
        exploited_slack=exploited_slack,
        calls=t_tasks,
        power_dt=power_dt or 0.0,
        power_series=power_series,
        toverlap=toverlap,
        theta_series=theta_series if has_theta else None,
        theta_bins=theta_bins,
        n_prearm=n_prearm,
        n_mispredict=n_mispredict,
        n_guard_trips=n_trips,
        t_dvfs_stretch=t_stretch,
    )
    trace = (
        TraceRecord(wl.site, wl.is_p2p, wl.nbytes, trace_comp, trace_slack,
                    trace_copy, partner=wl.partner)
        if collect_trace
        else None
    )
    return res, trace


# --------------------------------------------------------------------------
# trace-analysis mode (paper Table 2): coverage each policy achieves on the
# *baseline* trace, without timing feedback.
# --------------------------------------------------------------------------

def coverage_on_trace(trace: TraceRecord, pol: Policy, hw: HwModel = DEFAULT_HW) -> float:
    """Fraction [%] of total rank-time the policy would run at f_min."""
    theta_eff = hw.theta_eff(pol.theta)
    slack, copy = trace.slack, trace.copy
    total = trace.comp.sum() + slack.sum() + copy.sum()
    n_sites = int(trace.site.max()) + 1
    n = slack.shape[1]
    if pol.comm_mode == "pin_min":
        return 100.0          # min P-state everywhere, by definition
    if pol.comm_mode == "timeout":
        low_slack = np.maximum(slack - theta_eff, 0.0)
        if pol.comm_scope == "slack":
            return 100.0 * low_slack.sum() / total
        comm = slack + copy
        low = np.maximum(comm - theta_eff, 0.0)
        return 100.0 * low.sum() / total
    if pol.comm_mode == "predict_timeout":
        last = np.full((n_sites, n), np.nan)
        low_total = 0.0
        for k in range(slack.shape[0]):
            site = int(trace.site[k])
            comm = slack[k] + copy[k]
            armed = np.nan_to_num(last[site], nan=0.0) >= 2.0 * pol.theta
            low_total += np.where(armed, np.maximum(comm - theta_eff, 0.0), 0.0).sum()
            last[site] = comm
        return 100.0 * low_total / total
    return 0.0
