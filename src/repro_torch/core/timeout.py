"""Online theta auto-tuning: close the loop the fixed 500 us timeout leaves open.

The paper tunes its reactive timeout once, to one machine's PCU commit
latency (COUNTDOWN Slack §5).  That constant is the single shared knob of
every policy in :mod:`repro_torch.core.policies` — and a misprediction in either
direction "jeopardizes the benefit": too low and the restore latency bleeds
into the copy/compute phases (overhead), too high and exploitable slack is
left on the table (lost saving).  :class:`ThetaTuner` replaces the constant
with a measured quantity per call site:

* **Slack CDF target (decay)** — each site keeps a log-binned histogram of
  its observed slack.  Downshifting a call costs one PCU residue: the
  restore pins the next phase at f_min for up to ``switch_latency``, which
  stretches that phase by ``c ~= residue_cost_frac * switch_latency``
  (the fraction is the time lost to running a partially CPU-bound phase at
  f_min — ~0.15 for the calibrated beta range; the AIMD loop below corrects
  the prior when a phase is hungrier).  The tuner picks the smallest
  threshold whose downshift cost stays under ``target_overhead`` of the
  busy time observed at that site::

      theta_target = min { theta : c * N_down(theta) <= rho * T_busy }

  with ``N_down(theta) = #{slack >= theta}``, ``T_busy`` the accumulated
  compute+slack+copy seconds observed at the site (the governor measures
  compute as the gap from a rank's previous phase end to its barrier
  enter, so the budget is a fraction of *time to completion*, the paper's
  bar — not of the comm window alone), and ``rho = target_overhead``
  (1 % by default).  ``theta_eff`` then relaxes toward the target
  geometrically: ``theta += decay * (theta_target - theta)``.

* **AIMD raise** — prediction is checked against the one signal the
  runtime can actually observe: the copy phase directly after a downshift.
  If a downshifted call's copy ran ``slow_tol`` slower than the site's
  reference (EMA live, exact offline) *and* the extra seconds are material
  against the per-call overhead budget (``rho * mean busy``), the model
  under-priced the residue — theta is raised multiplicatively
  (``raise_factor``) and allowed to decay back.  This is the classic
  congestion-control shape: gentle probing toward the CDF target, sharp
  backoff on observed harm.  The materiality condition keeps a relatively
  slow but tiny copy (60 us extra on a 30 ms task) from stampeding theta
  upward.

* **Hard bounds** — theta is always clamped to
  ``[switch_latency / 2, theta_max]`` (:meth:`HwModel.theta_bounds`): below
  half the commit interval the timer fires faster than the PCU can commit,
  so a lower theta cannot be realized in hardware; above ``theta_max`` the
  timeout never fires and the policy degenerates to baseline.

Every adjustment is a structured :class:`ThetaDecision`; the governor logs
them next to actuations and the trace recorder serializes them (schema v2),
so an adaptive run replays bit-for-bit: the tuner is a pure function of the
observation order.

:class:`PredictiveTuner` (the ``cntd_predictive`` policy) layers the online
:class:`~repro_torch.core.predictor.OnlinePredictor` on top: when the predicted
slack for a (site, rank) clears the residue-cost bar, the P-state downshift
is *pre-armed* at comm entry — it no longer waits for theta to expire, so
the exploited window starts at the PCU commit quantization instead of
``theta_eff``.  The paper's central claim is that such prediction
mispredicts and slows applications (COUNTDOWN §2; Fermata/Adagio pay this
cost); the tuner therefore wraps every pre-arm in a **misprediction
guard**: realized costs per site (the ``c_down`` early-restore residue for
pre-arms whose slack never materialized, plus observed copy-stretch on
pre-arms the reactive path would not have issued) accumulate against the
same 1% overhead budget the CDF target uses, and a site whose cost exceeds
its budget falls back — permanently — to the pure :class:`ThetaTuner`
path.  Guard bookings and pre-arms are structured
:class:`PredictorDecision` records (trace schema v3), replayed
bit-for-bit like theta decisions.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from repro_torch.core.pstate import DEFAULT_HW, HwModel


class PredictorDecision(NamedTuple):
    """One predictor-path event (structured like :class:`ThetaDecision`, so
    recorders and benchmarks consume it without scraping).

    ``kind`` is one of:

    * ``"prearm"`` — the downshift was pre-armed and the slack cleared the
      bar; ``predicted``/``observed`` are the predicted and realized slack.
    * ``"mispredict"`` — pre-armed, but the realized slack fell short of
      the bar; ``cost`` seconds (the early-restore residue) were booked
      against the site's guard.
    * ``"trip"`` — the site's cumulative misprediction cost exceeded its
      overhead budget; the site falls back to the pure ThetaTuner path.
      ``predicted`` carries the cumulative booked cost, ``observed`` the
      budget at trip time.
    """

    t: float
    site: int
    rank: int                    # -1 for batched (simulator) observations
    kind: str                    # "prearm" | "mispredict" | "trip"
    predicted: float
    observed: float
    cost: float                  # seconds booked against the guard by this record
    source: str                  # prediction regime ("forest" | "ema"); for
    #                              trips, the gate that fired ("budget" | "ev")


class ThetaDecision(NamedTuple):
    """One tuner adjustment (structured like :class:`~repro_torch.core.governor.
    Actuation`, so recorders and benchmarks consume it without scraping)."""

    t: float
    site: int
    rank: int                    # -1 for batched (simulator) observations
    theta_before: float
    theta_after: float
    reason: str                  # "decay" | "raise"
    slack: float                 # observation that triggered it (copy for raises)


@dataclass
class _SiteState:
    theta: float
    counts: np.ndarray           # histogram over the shared log bin edges
    busy: float = 0.0            # accumulated compute + slack + copy seconds
    n_slack: int = 0
    copy_ema: Optional[float] = None   # residue-free copy reference
    copy_min: Optional[float] = None   # least-stretched downshifted copy:
    # the fallback reference for sites where every call downshifts


@dataclass
class ThetaTuner:
    """Per-callsite online theta adaptation against the measured HwModel.

    Deterministic given the observation order — the property the trace
    replay differential test pins down.
    """

    hw: HwModel = DEFAULT_HW
    theta0: float = 500e-6
    theta_max: float = 50e-3
    target_overhead: float = 0.01    # rho: downshift cost bound vs busy time
    decay: float = 0.25              # geometric pull toward the CDF target
    raise_factor: float = 2.0        # AIMD multiplicative backoff
    slow_tol: float = 0.10           # relative copy slowdown raise trigger
    residue_cost_frac: float = 0.15  # expected time lost per pinned residue
    ema_alpha: float = 0.2           # copy reference EMA weight
    min_samples: int = 8             # observations before leaving theta0
    decision_tol: float = 1e-9       # suppress no-op decision records

    def __post_init__(self) -> None:
        self.theta_min, _ = self.hw.theta_bounds(self.theta_max)
        self.theta0 = self._clamp(self.theta0)
        # shared log-spaced slack bins: 1 us .. 30 s
        self._edges = np.geomspace(1e-6, 30.0, 97)
        self._sites: Dict[int, _SiteState] = {}
        self.decisions: List[ThetaDecision] = []
        # expected per-downshift cost: the pinned residue's time stretch
        self._c_down = self.residue_cost_frac * self.hw.switch_latency

    # ---- queries ---------------------------------------------------------
    def _clamp(self, theta: float) -> float:
        return float(min(max(theta, self.hw.switch_latency / 2.0), self.theta_max))

    def theta_for(self, site: int) -> float:
        """Current theta for ``site`` (theta0, clamped, when unseen)."""
        st = self._sites.get(site)
        return st.theta if st is not None else self.theta0

    def summary(self) -> Dict[int, float]:
        return {site: st.theta for site, st in self._sites.items()}

    # ---- internals -------------------------------------------------------
    def _state(self, site: int) -> _SiteState:
        st = self._sites.get(site)
        if st is None:
            st = _SiteState(theta=self.theta0,
                            counts=np.zeros(len(self._edges) - 1, np.int64))
            self._sites[site] = st
        return st

    def _target(self, st: _SiteState) -> float:
        """Smallest threshold whose worst-case downshift cost respects the
        overhead budget — the percentile of the slack CDF the docstring
        derives.  Conservative (theta0) until ``min_samples`` accrue."""
        if st.n_slack < self.min_samples or st.busy <= 0.0:
            return self.theta0
        total = int(st.counts.sum())
        budget = self.target_overhead * st.busy
        # N_down(edge[i]) = samples at or above edge i = total - cum[i]
        cum = np.concatenate(([0], np.cumsum(st.counts)))
        n_down = total - cum
        feasible = self._c_down * n_down <= budget
        idx = int(np.argmax(feasible)) if feasible.any() else len(self._edges) - 1
        return self._clamp(float(self._edges[idx]))

    def _decide(self, st: _SiteState, site: int, rank: int, t: float,
                new_theta: float, reason: str, obs: float) -> Optional[ThetaDecision]:
        new_theta = self._clamp(new_theta)
        # relative suppression: the geometric decay approaches its target
        # asymptotically — without this, every observation would log an
        # ever-smaller no-op decision into the trace forever
        if abs(new_theta - st.theta) <= self.decision_tol + 1e-4 * st.theta:
            st.theta = new_theta
            return None
        dec = ThetaDecision(t, site, rank, st.theta, new_theta, reason, obs)
        st.theta = new_theta
        self.decisions.append(dec)
        return dec

    # ---- observations (governor path: scalar, event-ordered) -------------
    def observe_slack(self, site: int, slack: float, t: float, rank: int = 0,
                      comp: float = 0.0) -> Optional[ThetaDecision]:
        """Account one measured slack (plus the ``comp`` seconds that led
        into the call, when the caller can measure them — they widen the
        overhead budget to the paper's time-to-completion denominator);
        relax theta toward the CDF target."""
        st = self._state(site)
        slack = max(float(slack), 0.0)
        b = int(np.clip(np.searchsorted(self._edges, slack, side="right") - 1,
                        0, len(st.counts) - 1))
        st.counts[b] += 1
        st.busy += slack + max(float(comp), 0.0)
        st.n_slack += 1
        target = self._target(st)
        return self._decide(st, site, rank, t,
                            st.theta + self.decay * (target - st.theta),
                            "decay", slack)

    def _raise_budget(self, st: _SiteState) -> float:
        """Extra seconds per call that breach the overhead target: rho times
        the mean per-observation busy time at this site."""
        return self.target_overhead * st.busy / max(st.n_slack, 1)

    def observe_copy(self, site: int, copy: float, t: float, rank: int = 0,
                     downshifted: bool = False) -> Optional[ThetaDecision]:
        """Account a copy phase; AIMD-raise if a downshifted call's copy ran
        ``slow_tol`` over the site's EMA reference (the residue bled) by a
        margin that matters against the overhead budget."""
        st = self._state(site)
        copy = max(float(copy), 0.0)
        st.busy += copy
        dec = None
        # the reference must stay residue-free: an EMA of clean copies when
        # the site has any, else the least-stretched downshifted copy seen
        # (a downshifted copy must never SEED the EMA — on a site whose
        # first call downshifts, that would lock the reference at the
        # stretched duration and permanently disarm the raise)
        ref = st.copy_ema if st.copy_ema is not None else st.copy_min
        if (downshifted and ref is not None
                and copy > ref * (1.0 + self.slow_tol)
                and copy - ref > self._raise_budget(st)):
            dec = self._decide(st, site, rank, t, st.theta * self.raise_factor,
                               "raise", copy)
        if downshifted:
            st.copy_min = copy if st.copy_min is None else min(st.copy_min, copy)
        elif st.copy_ema is None:
            st.copy_ema = copy
        else:
            st.copy_ema = (1.0 - self.ema_alpha) * st.copy_ema + self.ema_alpha * copy
        return dec

    # ---- observations (simulator path: one batch per task) ---------------
    def observe_slack_batch(self, site: int, slacks: np.ndarray, t: float,
                            comp: Optional[np.ndarray] = None) -> Optional[ThetaDecision]:
        """Vectorized :meth:`observe_slack`: histogram the whole rank vector,
        apply ONE decay step (the task is one decision epoch)."""
        st = self._state(site)
        slacks = np.maximum(np.asarray(slacks, np.float64), 0.0)
        hist, _ = np.histogram(np.clip(slacks, self._edges[0], self._edges[-1]),
                               bins=self._edges)
        st.counts += hist
        st.busy += float(slacks.sum())
        if comp is not None:
            st.busy += float(np.maximum(np.asarray(comp, np.float64), 0.0).sum())
        st.n_slack += int(slacks.size)
        target = self._target(st)
        return self._decide(st, site, -1, t,
                            st.theta + self.decay * (target - st.theta),
                            "decay", float(slacks.mean()) if slacks.size else 0.0)

    def observe_copy_slowdown(self, site: int, copy_busy: float, extra: float,
                              frac: float, t: float) -> Optional[ThetaDecision]:
        """Simulator feedback: the realized copy-phase slowdown of a
        downshifted task — ``extra`` seconds over the residue-free copy,
        ``frac`` relative (exactly known offline, EMA-estimated live)."""
        st = self._state(site)
        st.busy += max(float(copy_busy), 0.0)
        if frac > self.slow_tol and extra > self._raise_budget(st):
            return self._decide(st, site, -1, t, st.theta * self.raise_factor,
                                "raise", float(frac))
        return None

    def reset(self) -> None:
        self._sites.clear()
        self.decisions.clear()


@dataclass
class _GuardState:
    """Per-site misprediction ledger for :class:`PredictiveTuner`."""

    cost: float = 0.0            # booked misprediction seconds
    gain: float = 0.0            # booked extra f_min residency pre-arms won
    n_armed: int = 0             # pre-arms issued
    n_mispredict: int = 0        # pre-arms whose slack fell below break-even
    tripped: bool = False        # permanent fallback to the pure tuner path


@dataclass
class PredictiveTuner(ThetaTuner):
    """Hybrid predictor+timeout theta source (the ``cntd_predictive``
    policy): a :class:`ThetaTuner` whose per-occurrence decision may be
    *pre-armed* by the online predictor, under a per-site misprediction
    guard.

    ``reactive=True`` (the hybrid): a non-armed occurrence keeps the pure
    tuner threshold — prediction can only accelerate the downshift, never
    lose the reactive safety net.  ``reactive=False`` is the paper's
    prediction-only strawman (Fermata/Adagio-style): non-armed occurrences
    never downshift, and with ``guarded=False`` nothing bounds the
    misprediction cost — the configuration the Table-3 bench shows
    overshooting the 1% budget.

    The pre-arm bar: a predicted slack must at least cover the PCU commit
    quantization (``hw.theta_eff(0)`` — a shorter slack ends before the
    pinned P-state even commits) plus ``arm_margin`` expected residue
    costs.  The guard keeps a two-sided per-site ledger.  Cost: each
    mispredicted pre-arm books its *unabsorbed serialization residue* —
    the restore issued at slack end completes only after the in-flight
    down leg commits, pinning ``2*lat - min(slack, lat)`` seconds of the
    following copy/compute at f_min, of which the site's median slack
    (read off the tuner's own histogram) is typically re-absorbed by the
    next wait — floored at ``c_down``; realized copy-stretch seconds on
    pre-arms the reactive threshold would not have issued book on top.
    Gain: each correct pre-arm books the extra f_min residency it won over
    the reactive path, ``min(slack, theta_eff(theta)) - theta_eff(0)``.
    A site trips (permanently — :meth:`decide` returns the pure tuner path
    forever, making its decisions identical to a plain
    :class:`ThetaTuner`'s, property-tested) on either gate: booked cost
    exceeds ``target_overhead`` of its observed busy time (the 1% budget,
    the paper's headline condition), or — after ``ev_min_armed`` pre-arms
    — booked cost exceeds booked gain (the site is negative-EV: the paper
    families where slack straddles the bar lose more to mispredicted
    residue than marginal pre-arms can ever win back).  Both gates share a
    small ``guard_grace`` floor so one early misprediction on a young site
    does not condemn it.

    Deterministic like its base: predictor refits are counter-triggered and
    seeded, so the whole hybrid remains a pure function of the observation
    order and replays bit-for-bit from a v3 trace.
    """

    reactive: bool = True        # keep the timeout fallback on non-armed calls
    guarded: bool = True         # False: the unguarded prediction-only strawman
    arm_margin: float = 4.0      # bar = theta_eff(0) + arm_margin * c_down
    guard_grace: float = 3.0     # min booked residues before a trip can fire
    ev_min_armed: int = 32       # pre-arms before the cost>gain gate can trip
    predictor: Optional[object] = None   # OnlinePredictor (built if absent)

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.predictor is None:
            # deferred: predictor.py imports simulator; keep this module light
            from repro_torch.core.predictor import OnlinePredictor

            self.predictor = OnlinePredictor()
        self._guards: Dict[int, _GuardState] = {}
        self.pred_decisions: List[PredictorDecision] = []
        self._arm_eff = self.hw.theta_eff(0.0)
        self._bar = self._arm_eff + self.arm_margin * self._c_down
        if not self.reactive and not self.guarded:
            # the naive strawman pre-arms on ANY predicted slack — no
            # break-even bar, no safety margin; the bar+margin (and the
            # guard) are exactly what the hybrid adds on top
            self._bar = 0.0

    # ---- queries ---------------------------------------------------------
    @property
    def arm_bar(self) -> float:
        """Predicted slack below this never pre-arms (seconds)."""
        return self._bar

    def guard_state(self, site: int) -> _GuardState:
        g = self._guards.get(site)
        if g is None:
            g = _GuardState()
            self._guards[site] = g
        return g

    def tripped(self, site: int) -> bool:
        g = self._guards.get(site)
        return g is not None and g.tripped

    def trip_site(self, site: int) -> None:
        """Force a site onto the pure ThetaTuner path (operator override;
        also how the fallback property test pins equivalence)."""
        self.guard_state(site).tripped = True

    def guard_summary(self) -> Dict[int, Dict[str, float]]:
        return {
            site: {"cost": g.cost, "gain": g.gain, "n_armed": g.n_armed,
                   "n_mispredict": g.n_mispredict, "tripped": g.tripped}
            for site, g in self._guards.items()
        }

    # ---- guard pricing ---------------------------------------------------
    def _slack_median(self, site: int) -> float:
        """Median of the site's observed slack, read off the tuner's own
        log-binned histogram (left edge of the median bin: conservative,
        deterministic)."""
        st = self._sites.get(site)
        if st is None or st.n_slack == 0:
            return 0.0
        total = int(st.counts.sum())
        if total == 0:
            return 0.0
        cum = np.cumsum(st.counts)
        idx = int(np.searchsorted(cum, (total + 1) // 2))
        return float(self._edges[min(idx, len(self._edges) - 1)])

    def _mispredict_cost(self, site: int, slack: float) -> float:
        """Seconds a mispredicted pre-arm costs: the serialization residue
        (the restore completes one switch latency after the in-flight down
        leg commits: ``2*lat - min(slack, lat)`` pinned at f_min) minus
        what the site's median slack typically re-absorbs at the next
        wait, floored at ``c_down`` (the booking a correct-but-marginal
        downshift would also pay)."""
        lat = self.hw.switch_latency
        resid = 2.0 * lat - min(max(slack, 0.0), lat)
        return max(self._c_down, resid - self._slack_median(site))

    def _prearm_gain(self, site: int, slack: float) -> float:
        """Seconds of extra f_min residency a correct pre-arm won over the
        reactive path (which waits out ``theta_eff(theta)`` first)."""
        reactive_eff = self.hw.theta_eff(self.theta_for(site))
        return max(0.0, min(slack, reactive_eff) - self._arm_eff)

    # ---- the pre-arm decision (BEFORE the occurrence is observed) --------
    def decide(self, site: int, rank: int):
        """(armed, predicted_slack, source) for one occurrence — consulted
        at comm entry, i.e. strictly before this occurrence's slack is
        observed (the same causality the live runtime has)."""
        if self.guarded and self.tripped(site):
            return False, float("nan"), "tripped"
        pred, src = self.predictor.predict(site, rank)
        armed = bool(pred >= self._bar) if pred == pred else False  # NaN-safe
        return armed, pred, src

    def predict_ranks(self, site: int, n: int):
        """Delegate to the predictor's vectorized per-rank prediction (the
        simulator path); returns ``(preds, source)`` with NaN for cold
        ranks."""
        return self.predictor.predict_ranks(site, n)

    def arm_mask(self, site: int, preds: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`decide` arm test over a rank vector of
        predictions (the simulator path)."""
        if self.guarded and self.tripped(site):
            return np.zeros(len(preds), dtype=bool)
        with np.errstate(invalid="ignore"):
            return np.asarray(preds, np.float64) >= self._bar

    # ---- outcome accounting (guard bookings + predictor training) -------
    def _check_trip(self, site: int, g: _GuardState, t: float,
                    rank: int) -> List[PredictorDecision]:
        if not self.guarded or g.tripped:
            return []
        if g.cost <= self.guard_grace * self._c_down:
            return []
        st = self._state(site)
        budget = self.target_overhead * st.busy
        gate = ""
        if g.cost > budget:
            gate = "budget"              # the 1% overhead bound
        elif g.n_armed >= self.ev_min_armed and g.cost > g.gain:
            gate = "ev"                  # negative expected value: cost > gain
        if not gate:
            return []
        g.tripped = True
        dec = PredictorDecision(t, site, rank, "trip", g.cost,
                                budget if gate == "budget" else g.gain,
                                0.0, gate)
        self.pred_decisions.append(dec)
        return [dec]

    def account_outcome(self, site: int, rank: int, t: float, predicted: float,
                        slack: float, armed: bool, source: str,
                        comp: float = 0.0) -> List[PredictorDecision]:
        """Book one occurrence's realized outcome against its pre-arm
        decision, then roll the predictor forward.  Returns the structured
        records this outcome produced (0–2: a prearm/mispredict, plus a
        trip when the booking crosses the budget)."""
        decs: List[PredictorDecision] = []
        slack = max(float(slack), 0.0)
        if armed:
            g = self.guard_state(site)
            g.n_armed += 1
            # a mispredict is a pre-arm whose slack fell below break-even
            # (theta_eff(0)): it ended before the pinned P-state committed
            if slack < self._arm_eff:
                g.n_mispredict += 1
                cost = self._mispredict_cost(site, slack)
                g.cost += cost
                dec = PredictorDecision(t, site, rank, "mispredict",
                                        float(predicted), slack, cost, source)
            else:
                g.gain += self._prearm_gain(site, slack)
                dec = PredictorDecision(t, site, rank, "prearm",
                                        float(predicted), slack, 0.0, source)
            self.pred_decisions.append(dec)
            decs.append(dec)
            decs.extend(self._check_trip(site, g, t, rank))
        self.predictor.observe(site, rank, slack, comp)
        return decs

    def account_outcome_batch(self, site: int, preds: np.ndarray,
                              slacks: np.ndarray, armed: np.ndarray, t: float,
                              source: str,
                              comp: Optional[np.ndarray] = None,
                              ) -> List[PredictorDecision]:
        """Vectorized :meth:`account_outcome` for one task's rank vector
        (the simulator path): guard bookings per armed rank in rank order,
        one trip check per booking, then the predictor rolls forward over
        the whole vector."""
        decs: List[PredictorDecision] = []
        slacks = np.maximum(np.asarray(slacks, np.float64), 0.0)
        if armed.any():
            g = self.guard_state(site)
            for r in np.nonzero(armed)[0].tolist():
                g.n_armed += 1
                s = float(slacks[r])
                if s < self._arm_eff:
                    g.n_mispredict += 1
                    cost = self._mispredict_cost(site, s)
                    g.cost += cost
                    dec = PredictorDecision(t, site, r, "mispredict",
                                            float(preds[r]), s, cost, source)
                else:
                    g.gain += self._prearm_gain(site, s)
                    dec = PredictorDecision(t, site, r, "prearm",
                                            float(preds[r]), s, 0.0, source)
                self.pred_decisions.append(dec)
                decs.append(dec)
                decs.extend(self._check_trip(site, g, t, r))
        self.predictor.observe_ranks(site, slacks, comp)
        return decs

    def copy_reference(self, site: int) -> Optional[float]:
        """The site's residue-free copy reference (EMA when clean copies
        exist, else the least-stretched downshifted copy) — read *before*
        ``observe_copy`` folds the current copy in."""
        st = self._sites.get(site)
        if st is None:
            return None
        return st.copy_ema if st.copy_ema is not None else st.copy_min

    def guard_copy(self, site: int, copy: float, t: float,
                   rank: int = -1) -> List[PredictorDecision]:
        """Book the realized copy-stretch of a pre-arm the reactive path
        would not have issued (the caller has established that: the
        occurrence was armed and its slack was below the reactive
        threshold).  Uses the same materiality test as the AIMD raise so a
        tiny stretch on a huge task cannot trip the guard."""
        if not self.guarded:
            return []
        g = self.guard_state(site)
        if g.tripped:
            return []
        ref = self.copy_reference(site)
        if ref is None or copy <= ref * (1.0 + self.slow_tol):
            return []
        g.cost += copy - ref
        return self._check_trip(site, g, t, rank)

    def guard_copy_batch(self, site: int, extras: np.ndarray,
                         fracs: np.ndarray, t: float) -> List[PredictorDecision]:
        """Simulator feedback: exact per-rank copy-stretch seconds of
        pre-armed ranks the reactive threshold would not have downshifted
        (``extras`` absolute, ``fracs`` relative).  Same materiality test
        as :meth:`guard_copy`, booked in rank order."""
        if not self.guarded:
            return []
        g = self.guard_state(site)
        decs: List[PredictorDecision] = []
        for extra, frac in zip(np.asarray(extras, np.float64).tolist(),
                               np.asarray(fracs, np.float64).tolist()):
            if g.tripped:
                break
            if frac > self.slow_tol and extra > 0.0:
                g.cost += extra
                decs.extend(self._check_trip(site, g, t, -1))
        return decs

    def reset(self) -> None:
        super().reset()
        self._guards.clear()
        self.pred_decisions.clear()
        self.predictor.reset()
