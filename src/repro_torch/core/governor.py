"""Host-side governor: the live streaming engine that consumes phase events.

This is the analogue of the paper's timer+callback machinery (§4.3): the
instrumented collectives emit (rank, phase, call_id, t) events onto the
:class:`~repro_torch.core.events.EventBus` (``repro_torch.core.instrument`` owns the
ambient bus); the governor subscribes, reconstructs per-call slack/copy
durations, applies the configured policy's timeout decision, logs the
P-state actuation it *would* issue (on Intel: wrmsr via MSR_SAFE; on a
TPU host: SMC power capping — see DESIGN.md §2), estimates energy via the
calibrated HwModel, and feeds the straggler detector.

The accounting is **streaming and constant-memory** (DESIGN.md §9): the
runtime lives inside every MPI call on week-long runs, so it cannot
retain history.  Slack/copy/overlap/energy accumulate incrementally when
a call occurrence *retires* (a rank re-enters its call id — the rotation
rule — or an ingested phase closes); retired records are evicted into a
small bounded ring (``retention``, debugging only), the straggler
detector observes arrivals at retirement, and :meth:`finalize` /
:meth:`interval_snapshot` are O(in-flight) / O(1) reads of the
accumulators instead of re-walking the full history.  The accumulation
order is exactly the retirement order followed by the in-flight records,
i.e. the same float-addition sequence the historical batch tally
performed — reports are bit-for-bit identical (the golden conformance
suite and the streaming/batch property test in ``tests/test_events.py``
pin this down).

Consumers that hang off the same stream: an optional
:class:`~repro_torch.cluster.trace.TraceRecorder` (``Governor(recorder=)``)
tees every event/phase/actuation the governor books so a run replays
offline bit-for-bit, and :meth:`interval_snapshot` reports the
slack/overlap/energy booked since the previous snapshot — the per-epoch
poll the :class:`~repro_torch.cluster.arbiter.PowerBudgetArbiter` redistributes
watts on.

An optional :class:`~repro_torch.core.timeout.ThetaTuner` (``Governor(tuner=)``,
auto-created for ``theta_mode="adaptive"`` policies) closes the timeout
feedback loop: each barrier_exit is priced against the tuner's per-site
theta instead of the policy constant, the observation feeds the site's
slack histogram, and every adjustment is logged as a structured
:class:`~repro_torch.core.timeout.ThetaDecision` next to the actuations (and
into the trace, schema v2, so adaptive runs replay bit-for-bit).  The
5-phase taxonomy (``dispatch_enter``/``wait_enter`` from the async
collectives) books compute/communication overlap as *non-slack*: slack
for an async pair starts at the wait, and the overlap window is reported
separately on ``GovernorReport.total_overlap``.
"""
from __future__ import annotations

import collections
import threading
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.core.events import PHASE_NAMES, EventBatch, PhaseRecord
from repro_torch.core.policies import COUNTDOWN_SLACK, Policy
from repro_torch.core.pstate import DEFAULT_HW, HwModel
from repro_torch.core.timeout import (PredictiveTuner, PredictorDecision,
                                ThetaDecision, ThetaTuner)
from repro_torch.dist.straggler import StragglerDetector


class Actuation(NamedTuple):
    """One P-state command the runtime would issue (structured so the trace
    recorder and benchmarks can consume it without attribute scraping).
    Index layout keeps the legacy ``(t, rank, action)`` prefix."""

    t: float
    rank: int
    action: str              # "set_pstate_min" | "restore_pstate_max"
    call_id: int
    slack: float             # the slack duration that triggered the pair


class CallRecord:
    """Per-occurrence reconstruction state (one barrier/async pair).

    A plain ``__slots__`` class, not a dataclass: one instance is created
    per *occurrence* on the hot path and its construction cost is part of
    the per-event budget.
    """

    __slots__ = ("call_id", "enter", "slack_end", "copy_end", "dispatch",
                 "theta_used", "site", "observed", "prearm")

    def __init__(self, call_id: int, site: Optional[int] = None):
        self.call_id = call_id
        self.enter: Dict[int, float] = {}       # rank -> t (slack start)
        self.slack_end: Dict[int, float] = {}
        self.copy_end: Dict[int, float] = {}
        self.dispatch: Dict[int, float] = {}    # async overlap start
        self.theta_used: Dict[int, float] = {}  # raw theta armed per rank at
        # slack end (only populated under a tuner; fixed policies price the
        # constant default, saving a dict store per event)
        self.prearm: Optional[Dict[int, float]] = None  # rank -> the reactive
        # threshold displaced by a predictive pre-arm (lazy: only predictive
        # tuners pay the dict; the copy close reads it for guard attribution)
        self.site = site                        # tuner histogram key override
        self.observed = 0                       # arrival count already fed to
        # the straggler detector (a mid-run finalize() observes the record
        # partially; more ranks entering later re-qualify it)

    def __repr__(self) -> str:   # debugging aid for ring inspection
        return (f"CallRecord(call_id={self.call_id}, ranks={len(self.enter)}, "
                f"site={self.site})")


_EMPTY_I = np.empty(0, dtype=np.int64)
_EMPTY_F = np.empty(0, dtype=np.float64)


class _Tail:
    """Columnar in-flight occurrence state under the batched path.

    The per-event path keeps one :class:`CallRecord` (four dicts) per
    in-flight call id; materializing those dicts per batch would put a
    Python loop right back on the hot path.  The batched engine instead
    carries the open tail of each call id as per-class ``(rank, t)``
    column pairs — array views cut from the batch, in first-write
    (insertion) order with last-write values, exactly the dict contents.
    A tail converts to/from a :class:`CallRecord` losslessly at the
    per-event/batched seams (a stray ``sink()`` call, ``finalize``).
    """

    __slots__ = ("e_rk", "e_t", "s_rk", "s_t", "c_rk", "c_t",
                 "d_rk", "d_t", "observed", "_seen")

    def __init__(self, e_rk=_EMPTY_I, e_t=_EMPTY_F, s_rk=_EMPTY_I,
                 s_t=_EMPTY_F, c_rk=_EMPTY_I, c_t=_EMPTY_F,
                 d_rk=_EMPTY_I, d_t=_EMPTY_F, observed: int = 0):
        self.e_rk, self.e_t = e_rk, e_t
        self.s_rk, self.s_t = s_rk, s_t
        self.c_rk, self.c_t = c_rk, c_t
        self.d_rk, self.d_t = d_rk, d_t
        self.observed = observed
        self._seen = None

    @property
    def seen(self) -> set:
        """Ranks in enter ∪ dispatch — the rotation rule's membership set."""
        s = self._seen
        if s is None:
            s = set(self.e_rk.tolist())
            s.update(self.d_rk.tolist())
            self._seen = s
        return s

    @staticmethod
    def from_record(rec: CallRecord) -> "_Tail":
        def cols(d: Dict[int, float]):
            if not d:
                return _EMPTY_I, _EMPTY_F
            return (np.fromiter(d.keys(), np.int64, len(d)),
                    np.fromiter(d.values(), np.float64, len(d)))

        e_rk, e_t = cols(rec.enter)
        s_rk, s_t = cols(rec.slack_end)
        c_rk, c_t = cols(rec.copy_end)
        d_rk, d_t = cols(rec.dispatch)
        return _Tail(e_rk, e_t, s_rk, s_t, c_rk, c_t, d_rk, d_t, rec.observed)

    def to_record(self, call_id: int) -> CallRecord:
        rec = CallRecord(call_id)
        rec.enter = dict(zip(self.e_rk.tolist(), self.e_t.tolist()))
        rec.slack_end = dict(zip(self.s_rk.tolist(), self.s_t.tolist()))
        rec.copy_end = dict(zip(self.c_rk.tolist(), self.c_t.tolist()))
        rec.dispatch = dict(zip(self.d_rk.tolist(), self.d_t.tolist()))
        rec.observed = self.observed
        return rec


class _ActBlock(NamedTuple):
    """One batch's qualifying actuation pairs, columnar, appended to the
    lazy spine log whole (expanding per pair would put a Python loop back
    on the batch path; :attr:`Governor.actuation_log` expands on read)."""

    t: np.ndarray
    rank: np.ndarray
    call_id: np.ndarray
    slack: np.ndarray


class RetiredBlock:
    """One batch's retired occurrences, columnar — the batch analogue of
    the sequence of :class:`CallRecord` values the per-event path would
    have retired, in the identical retirement order.

    Row arrays hold the *accounting view* (one row per entered rank, in
    per-record dict-insertion order; ``row_off[i]:row_off[i+1]`` is
    record ``i``): rank, enter/slack-end/copy-end/dispatch times (NaN
    when the phase is missing).  The class arrays hold the *full* per-
    class ``(rank, t)`` entries (exit-only ranks included) for lossless
    :meth:`record` materialization, which the retention ring and any
    debugging consumer use.  Everything is a view onto the batch-sized
    working arrays: building a block costs object construction, not
    copies.
    """

    __slots__ = ("n", "cids", "observed", "n_enter", "sid_of_rid",
                 "row_rid", "row_rank", "row_t0", "row_t1", "row_t2",
                 "row_td", "row_off", "classes")

    def __init__(self, n, cids, observed, n_enter, sid_of_rid,
                 row_rid, row_rank, row_t0, row_t1, row_t2, row_td,
                 row_off, classes):
        self.n = n
        self.cids = cids
        self.observed = observed
        self.n_enter = n_enter
        self.sid_of_rid = sid_of_rid
        self.row_rid = row_rid
        self.row_rank = row_rank
        self.row_t0 = row_t0
        self.row_t1 = row_t1
        self.row_t2 = row_t2
        self.row_td = row_td
        self.row_off = row_off
        self.classes = classes       # name -> (sid, rank, t, pos) key-sorted

    def __len__(self) -> int:
        return self.n

    def class_counts(self, name: str) -> np.ndarray:
        """Per-record entry count of one phase class (len ``n``)."""
        sid_arr = self.classes[name][0]
        counts = np.zeros(self.n, dtype=np.int64)
        if sid_arr.size:
            lo = np.searchsorted(sid_arr, self.sid_of_rid, side="left")
            hi = np.searchsorted(sid_arr, self.sid_of_rid, side="right")
            counts = hi - lo
        return counts

    def wait_counts(self) -> np.ndarray:
        """Per-record count of entered ranks that also dispatched (the
        async pairs — ``wait_enter`` rows in the 5-phase taxonomy)."""
        if self.row_rid.size == 0:
            return np.zeros(self.n, dtype=np.int64)
        return np.bincount(self.row_rid[~np.isnan(self.row_td)],
                           minlength=self.n)

    def record(self, i: int) -> CallRecord:
        """Materialize retired occurrence ``i`` as a :class:`CallRecord`
        (cold path: the ring/debug view)."""
        rec = CallRecord(int(self.cids[i]))
        sid = int(self.sid_of_rid[i])
        for name, target in (("enter", "enter"), ("slack", "slack_end"),
                             ("copy", "copy_end"), ("dispatch", "dispatch")):
            sid_arr, rank_arr, t_arr, pos_arr = self.classes[name]
            lo = np.searchsorted(sid_arr, sid, side="left")
            hi = np.searchsorted(sid_arr, sid, side="right")
            if hi > lo:
                o = np.argsort(pos_arr[lo:hi], kind="stable")
                setattr(rec, target,
                        dict(zip(rank_arr[lo:hi][o].tolist(),
                                 t_arr[lo:hi][o].tolist())))
        rec.observed = int(self.observed[i])
        return rec

    def records(self):
        for i in range(self.n):
            yield self.record(i)


class _Accum:
    """Streaming counters behind reports and snapshots.

    ``add_record`` replays the historical batch tally's inner loop against
    *running* sums — feeding records through in the same order as the old
    one-shot walk performs the identical float-addition sequence, which is
    what keeps the golden fixtures bit-for-bit stable across the
    streaming refactor.
    """

    __slots__ = ("n_records", "n_down", "slack", "copy", "busy",
                 "exploited", "e_base", "e_pol", "overlap")

    def __init__(self) -> None:
        self.n_records = 0
        self.n_down = 0
        self.slack = 0.0
        self.copy = 0.0
        self.busy = 0.0
        self.exploited = 0.0
        self.e_base = 0.0
        self.e_pol = 0.0
        self.overlap = 0.0

    def clone(self) -> "_Accum":
        c = _Accum()
        for f in _Accum.__slots__:
            setattr(c, f, getattr(self, f))
        return c


@dataclass
class GovernorReport:
    n_calls: int
    n_downshifts: int
    total_slack: float
    total_copy: float
    exploited_slack: float
    energy_baseline: float           # J during instrumented phases, no policy
    energy_policy: float             # J with the policy's P-state trajectory
    straggler_summary: Dict[int, float]
    stragglers: List[Tuple[int, float]]
    total_overlap: float = 0.0       # dispatch->wait seconds, accounted NON-slack
    n_theta_decisions: int = 0       # tuner adjustments booked (0 = fixed theta)

    @property
    def energy_saving_pct(self) -> float:
        # energy_policy can dip epsilon-negative when float cancellation
        # meets zero-length phases; clamp both edges so the percentage
        # stays in [0, 100] instead of exceeding it by rounding artifacts
        if self.energy_baseline <= 0:
            return 0.0
        return 100.0 * (1.0 - max(self.energy_policy, 0.0) / self.energy_baseline)

    def to_dict(self) -> Dict[str, object]:
        """JSON-ready view (trace artifacts, benchmarks) — one place, not
        per-consumer attribute scraping."""
        return {
            "n_calls": int(self.n_calls),
            "n_downshifts": int(self.n_downshifts),
            "total_slack": float(self.total_slack),
            "total_copy": float(self.total_copy),
            "exploited_slack": float(self.exploited_slack),
            "energy_baseline": float(self.energy_baseline),
            "energy_policy": float(self.energy_policy),
            "energy_saving_pct": float(self.energy_saving_pct),
            "straggler_summary": {int(r): float(v) for r, v in self.straggler_summary.items()},
            "stragglers": [[int(r), float(z)] for r, z in self.stragglers],
            "total_overlap": float(self.total_overlap),
            "n_theta_decisions": int(self.n_theta_decisions),
        }


@dataclass
class IntervalStats:
    """Slack/energy booked between two ``interval_snapshot`` calls."""

    n_calls: int
    n_downshifts: int
    slack: float
    copy: float
    busy: float                      # sum over ranks of enter->copy_end spans
    exploited: float
    energy_baseline: float
    energy_policy: float
    overlap: float = 0.0             # dispatch->wait seconds booked non-slack

    @property
    def exploited_ratio(self) -> float:
        """Fraction of instrumented rank-time the policy spent at f_min —
        the arbiter's signal that this job has watts to give away."""
        return self.exploited / self.busy if self.busy > 0 else 0.0

    @property
    def overlap_ratio(self) -> float:
        """Overlap seconds per instrumented busy second — distinguishes an
        overlap-heavy job (compute hidden under flying collectives: watts
        convert to progress) from a slack-heavy one (watts stranded)."""
        return self.overlap / self.busy if self.busy > 0 else 0.0


class Governor:
    """Streaming engine: reconstructs phases from bus events, applies the
    policy, and keeps O(1)-memory accounting.

    Subscribe it to an :class:`~repro_torch.core.events.EventBus` (it exposes the
    canonical ``on_event``/``on_phase`` consumer interface) or feed it
    directly through :meth:`sink` / :meth:`ingest_phase`.

    ``retention`` bounds the debugging ring of retired
    :class:`CallRecord` occurrences (``recent_records()``); accounting
    never needs them back.  ``log_retention`` optionally bounds the
    actuation/theta decision logs the same way — counts survive eviction
    (``n_actuations``, and ``n_theta_decisions`` on the report).
    """

    def __init__(
        self,
        policy: Policy = COUNTDOWN_SLACK,
        hw: HwModel = DEFAULT_HW,
        detector: Optional[StragglerDetector] = None,
        recorder=None,
        tuner: Optional[ThetaTuner] = None,
        retention: int = 256,
        log_retention: Optional[int] = None,
    ):
        self.policy = policy
        self.hw = hw
        self.detector = detector or StragglerDetector()
        self.recorder = recorder     # cluster.trace.TraceRecorder-compatible
        # Recorder hooks are resolved once: sink() runs per event, so an
        # absent hook must cost one None check, not a getattr + no-op call.
        # A recorder exposing the *spine* hooks (``on_actuation_pair``,
        # ``on_retired`` — see repro_torch.obs.tracer.GovernorTap) keeps the
        # lazy/cheap paths the bare governor uses; one exposing only the
        # eager ``on_actuation`` (cluster.trace.TraceRecorder) still gets
        # fully-built Actuation values in stream order.
        self._rec_event = getattr(recorder, "on_event", None)
        self._rec_phase = getattr(recorder, "on_phase", None)
        self._rec_act = getattr(recorder, "on_actuation", None)
        self._rec_theta = getattr(recorder, "on_theta", None)
        self._rec_pred = getattr(recorder, "on_predictor", None)
        self._rec_pair = getattr(recorder, "on_actuation_pair", None)
        self._rec_retire = getattr(recorder, "on_retired", None)
        self._rec_retire_batch = getattr(recorder, "on_retired_batch", None)
        if tuner is None and policy.theta_mode == "adaptive":
            tuner = ThetaTuner(hw=hw, theta0=policy.theta)
        elif tuner is None and policy.theta_mode in ("predictive", "predict_only"):
            # predict_only is the paper's strawman: pre-arm on ANY
            # predicted slack, no reactive fallback, no guard
            # (PredictiveTuner zeroes the arm bar for that configuration) —
            # the misprediction cost it incurs is the point
            hyb = policy.theta_mode == "predictive"
            tuner = PredictiveTuner(
                hw=hw, theta0=policy.theta, reactive=hyb, guarded=hyb,
            )
        self.tuner = tuner
        self._predictive = isinstance(tuner, PredictiveTuner)
        self.retention = int(retention)
        # call_ids are assigned at TRACE time, so the same id recurs on every
        # executed step: rotate to a fresh occurrence when a rank re-enters,
        # retiring the previous one into the accumulators + ring
        self._calls: Dict[int, CallRecord] = {}
        self._ring: collections.deque = collections.deque(maxlen=self.retention)
        self._acc = _Accum()         # cumulative, behind finalize()
        self._mark = _Accum()        # checkpoint of _acc at the last snapshot
        self._last_end: Dict[int, float] = {}   # rank -> last phase end (the
        # enter-minus-this gap is the rank's compute, widening the tuner's
        # overhead budget to the time-to-completion denominator)
        self._lock = threading.Lock()
        self.n_actuations = 0
        # the log materializes lazily: the hot path appends one compact
        # (t, rank, call_id, slack) spine tuple per pair and the
        # ``actuation_log`` property expands it on first read (eagerly only
        # under a recorder, which needs the pair in stream order).  Under
        # log_retention the spine is ring-bounded too — each entry expands
        # to a pair, so half the retention covers the whole window and an
        # unread governor stays bounded-RSS on week-long runs
        self._act_raw = (
            collections.deque(maxlen=(log_retention + 1) // 2)
            if log_retention is not None else []
        )
        self._act_log: List[Actuation] = (
            collections.deque(maxlen=log_retention) if log_retention is not None
            else []
        )
        self._n_theta = 0
        self._theta_log = (
            collections.deque(maxlen=log_retention) if log_retention is not None
            else []
        )
        self._n_pred = 0
        self._pred_log = (
            collections.deque(maxlen=log_retention) if log_retention is not None
            else []
        )
        # policy/hw are frozen for the governor's lifetime: pre-derive the
        # per-event constants off the hot path
        self._theta_default = policy.theta
        self._timeout_armed = policy.comm_mode in ("timeout", "predict_timeout")
        self._scope_comm = policy.comm_scope == "comm"
        # float() strips the numpy scalar wrapper: identical IEEE doubles,
        # faster accumulate arithmetic
        self._w_slack_hi = float(hw.watts(hw.f_max, hw.act_slack))
        self._w_slack_lo = float(hw.watts(hw.f_min, hw.act_slack))
        self._w_copy_hi = float(hw.watts(hw.f_max, hw.act_copy))
        self._w_copy_lo = float(hw.watts(hw.f_min, hw.act_copy))
        self._theta_eff: Dict[float, float] = {}     # theta -> hw.theta_eff

    def _actuate(self, t: float, rank: int, call_id: int, slack: float) -> None:
        self.n_actuations += 2
        rec_pair = self._rec_pair
        if rec_pair is not None:
            # spine-aware recorder: keep the lazy path (one tuple append)
            # and hand it the compact pair
            self._act_raw.append((t, rank, call_id, slack))
            rec_pair(t, rank, call_id, slack)
            return
        if self._rec_act is None:
            # no recorder, or one that (like the obs GovernorTap) reads
            # actuations back from the spine log after the run instead of
            # paying a per-downshift call on the hot path
            self._act_raw.append((t, rank, call_id, slack))
            return
        pair = (
            Actuation(t, rank, "set_pstate_min", call_id, slack),
            Actuation(t, rank, "restore_pstate_max", call_id, slack),
        )
        self._act_log.extend(pair)
        for act in pair:
            self._rec_act(act)

    @property
    def actuation_log(self) -> List[Actuation]:
        """Every P-state pair booked so far (cold read: pending spine
        tuples are expanded into :class:`Actuation` values on access).

        Always a ``list``: the live backing list when unbounded, a snapshot
        copy of the retention ring under ``log_retention`` (a deque would
        compare unequal to a replayed governor's list even element-for-
        element identical).
        """
        raw = self._act_raw
        if raw:
            with self._lock:
                log = self._act_log
                for entry in raw:
                    if type(entry) is _ActBlock:
                        # batched spine block: expand in stream order
                        for t, rank, call_id, slack in zip(
                                entry.t.tolist(), entry.rank.tolist(),
                                entry.call_id.tolist(), entry.slack.tolist()):
                            log.append(Actuation(t, rank, "set_pstate_min",
                                                 call_id, slack))
                            log.append(Actuation(t, rank, "restore_pstate_max",
                                                 call_id, slack))
                        continue
                    t, rank, call_id, slack = entry
                    log.append(Actuation(t, rank, "set_pstate_min", call_id, slack))
                    log.append(Actuation(t, rank, "restore_pstate_max", call_id, slack))
                raw.clear()
        log = self._act_log
        return log if type(log) is list else list(log)

    def _record_theta(self, dec: Optional[ThetaDecision]) -> None:
        if dec is None:
            return
        self._n_theta += 1
        self._theta_log.append(dec)
        if self._rec_theta is not None:
            self._rec_theta(dec)

    @property
    def theta_log(self) -> List[ThetaDecision]:
        """Tuner decisions booked so far — always a ``list`` (a snapshot
        copy of the retention ring under ``log_retention``), mirroring
        :attr:`actuation_log` so cross-governor comparisons stay honest."""
        log = self._theta_log
        return log if type(log) is list else list(log)

    def _record_pred(self, dec: PredictorDecision) -> None:
        self._n_pred += 1
        self._pred_log.append(dec)
        if self._rec_pred is not None:
            self._rec_pred(dec)

    @property
    def n_predictor_decisions(self) -> int:
        """Predictor-path records booked so far (pre-arms, mispredictions,
        guard trips) — survives ``log_retention`` eviction."""
        return self._n_pred

    @property
    def predictor_log(self) -> List[PredictorDecision]:
        """Predictor decisions booked so far — always a ``list``, mirroring
        :attr:`theta_log`."""
        log = self._pred_log
        return log if type(log) is list else list(log)

    def _close_slack(self, rec: CallRecord, rank: int, t: float) -> None:
        """Shared barrier_exit tail: price the slack against the (possibly
        tuned or pre-armed) threshold, book the actuation pair, feed the
        tuner (and, under a predictive tuner, the guard + predictor)."""
        rec.slack_end[rank] = t
        t0 = rec.enter.get(rank, t)
        slack = t - t0
        if self.tuner is None:
            theta = self._theta_default
        else:
            key = rec.site if rec.site is not None else rec.call_id
            theta = self.tuner.theta_for(key)   # threshold armed BEFORE this obs
            armed = False
            pred = float("nan")
            src = ""
            if self._predictive:
                # the pre-arm decision is causal: it consults predictor +
                # guard state from strictly before this occurrence
                armed, pred, src = self.tuner.decide(key, rank)
                if armed:
                    if rec.prearm is None:
                        rec.prearm = {}
                    rec.prearm[rank] = theta    # displaced reactive threshold
                    theta = 0.0                 # downshift issued at entry:
                    # only the PCU commit quantization (theta_eff(0)) gates it
                elif not self.tuner.reactive:
                    theta = float("inf")        # prediction-only: no fallback
            rec.theta_used[rank] = theta
            last = self._last_end.get(rank)
            comp = max(t0 - last, 0.0) if last is not None else 0.0
            self._record_theta(
                self.tuner.observe_slack(key, slack, t, rank=rank, comp=comp)
            )
            if self._predictive:
                for pdec in self.tuner.account_outcome(
                        key, rank, t, pred, slack, armed, src, comp=comp):
                    self._record_pred(pdec)
        self._last_end[rank] = t
        if slack >= theta and self._timeout_armed:
            self._actuate(t, rank, rec.call_id, slack)

    def _close_copy(self, rec: CallRecord, rank: int, t: float) -> None:
        rec.copy_end[rank] = t
        self._last_end[rank] = t
        if self.tuner is None or rank not in rec.slack_end:
            return
        t1 = rec.slack_end[rank]
        slack = t1 - rec.enter.get(rank, t1)
        downshifted = slack >= rec.theta_used.get(rank, self._theta_default)
        key = rec.site if rec.site is not None else rec.call_id
        if self._predictive:
            if rec.prearm is not None:
                reactive_theta = rec.prearm.get(rank)
                if reactive_theta is not None and slack < reactive_theta:
                    # this downshift exists only because of the pre-arm — its
                    # copy stretch is misprediction cost, booked to the guard
                    for pdec in self.tuner.guard_copy(key, t - t1, t, rank=rank):
                        self._record_pred(pdec)
            self.tuner.predictor.note_copy(key, rank, t - t1)
        self._record_theta(
            self.tuner.observe_copy(key, t - t1, t, rank=rank, downshifted=downshifted)
        )

    # streaming accounting ----------------------------------------------------
    def _accumulate(self, rec: CallRecord, acc: _Accum) -> None:
        """Fold one record into running sums — the historical batch tally's
        inner loop, verbatim in addition order, against persistent
        accumulators (the sums ride in locals across the rank loop; same
        float sequence, one attribute write per field per record)."""
        acc.n_records += 1
        enter = rec.enter
        if not enter:
            return
        slack_end = rec.slack_end
        copy_end = rec.copy_end
        dispatch = rec.dispatch
        theta_used = rec.theta_used
        theta_eff_of = self._theta_eff
        default_theta = self._theta_default
        # fixed-theta records (no tuner) price one threshold: hoist the
        # two per-rank dict lookups out of the loop
        te_fixed = None
        if not theta_used:
            te_fixed = theta_eff_of.get(default_theta)
            if te_fixed is None:
                te_fixed = self.hw.theta_eff(default_theta)
                theta_eff_of[default_theta] = te_fixed
        w_slack_hi, w_slack_lo = self._w_slack_hi, self._w_slack_lo
        w_copy_hi, w_copy_lo = self._w_copy_hi, self._w_copy_lo
        scope_comm = self._scope_comm
        n_down = acc.n_down
        a_slack, a_copy, a_busy = acc.slack, acc.copy, acc.busy
        a_expl, a_ebase, a_epol, a_ov = (acc.exploited, acc.e_base,
                                         acc.e_pol, acc.overlap)
        for rank, t0 in enter.items():
            t1 = slack_end.get(rank)
            if t1 is None:
                continue
            # async pair: [dispatch, enter] is compute/comm overlap — the
            # core is busy, so it is *not* slack and is not priced here
            # (the caller's compute never is); it is reported separately
            if dispatch:
                td = dispatch.get(rank)
                if td is not None:
                    ov = t0 - td
                    if ov > 0.0:
                        a_ov += ov
            slack = t1 - t0
            if slack < 0.0:
                slack = 0.0
            a_slack += slack
            t2 = copy_end.get(rank)
            copy = 0.0 if t2 is None else t2 - t1
            if copy < 0.0:
                copy = 0.0
            a_copy += copy
            a_busy += slack + copy
            a_ebase += w_slack_hi * slack
            a_ebase += w_copy_hi * copy
            if te_fixed is not None:
                theta_eff = te_fixed
            else:
                theta = theta_used.get(rank, default_theta)
                theta_eff = theta_eff_of.get(theta)
                if theta_eff is None:
                    if len(theta_eff_of) >= 4096:
                        # adaptive tuners mint a fresh theta per decision;
                        # the memo must not become the history it replaces
                        theta_eff_of.clear()
                    theta_eff = self.hw.theta_eff(theta)
                    theta_eff_of[theta] = theta_eff
            low = slack - theta_eff
            if low > 0.0:
                n_down += 1
                a_expl += low
            else:
                low = 0.0
            a_epol += w_slack_hi * (slack - low)
            a_epol += w_slack_lo * low
            if scope_comm and low > 0.0:
                a_epol += w_copy_lo * copy
            else:
                a_epol += w_copy_hi * copy
        acc.n_down = n_down
        acc.slack, acc.copy, acc.busy = a_slack, a_copy, a_busy
        acc.exploited, acc.e_base, acc.e_pol, acc.overlap = (
            a_expl, a_ebase, a_epol, a_ov)

    def _observe(self, rec: CallRecord) -> None:
        """Feed an occurrence's arrivals to the straggler detector, at most
        once per arrival set: a record partially observed by a mid-run
        finalize() is observed again if new ranks entered since."""
        n = len(rec.enter)
        if n > rec.observed:
            rec.observed = n
            self.detector.observe_barrier(rec.enter)

    def _retire(self, rec: CallRecord) -> None:
        """A call occurrence is final: observe its arrivals, fold it into
        the cumulative accumulators, evict it into the bounded ring."""
        self._observe(rec)
        self._accumulate(rec, self._acc)
        self._ring.append(rec)

    # the bus consumer interface ----------------------------------------------
    def sink(self, rank: int, phase: str, call_id: int, t: float) -> None:
        with self._lock:
            # recorded under the lock: the trace order must be the order the
            # governor processed events in, or replay() loses bit-exactness
            if self._rec_event is not None:
                self._rec_event(rank, phase, call_id, t)
            calls = self._calls
            rec = calls.get(call_id)
            if rec is None:
                rec = CallRecord(call_id)
                calls[call_id] = rec
            elif rec.__class__ is not CallRecord:
                # in-flight tail left columnar by the batched path: a
                # per-event producer is cutting in — materialize once
                rec = rec.to_record(call_id)
                calls[call_id] = rec
            if phase == "barrier_enter":
                if rank in rec.enter or rank in rec.dispatch:
                    self._retire(rec)                   # new occurrence
                    if self._rec_retire is not None:
                        self._rec_retire(rec)
                    rec = CallRecord(call_id)
                    calls[call_id] = rec
                rec.enter[rank] = t
            elif phase == "barrier_exit":
                if self.tuner is None:
                    # _close_slack without the tuner bookkeeping, inlined:
                    # this is the single hottest branch of the runtime
                    rec.slack_end[rank] = t
                    self._last_end[rank] = t
                    slack = t - rec.enter.get(rank, t)
                    if slack >= self._theta_default and self._timeout_armed:
                        self._actuate(t, rank, call_id, slack)
                else:
                    self._close_slack(rec, rank, t)
            elif phase == "copy_exit":
                if self.tuner is None:
                    rec.copy_end[rank] = t
                    self._last_end[rank] = t
                else:
                    self._close_copy(rec, rank, t)
            elif phase == "dispatch_enter":
                if rank in rec.enter or rank in rec.dispatch:
                    self._retire(rec)                   # new occurrence
                    if self._rec_retire is not None:
                        self._rec_retire(rec)
                    rec = CallRecord(call_id)
                    calls[call_id] = rec
                rec.dispatch[rank] = t                  # overlap starts
            elif phase == "wait_enter":
                rec.enter[rank] = t                     # slack starts at the wait

    on_event = sink          # canonical EventBus subscriber method

    # batched ingest ------------------------------------------------------------
    def on_batch(self, batch: EventBatch) -> None:
        """Consume one columnar event chunk (the EventBus ``publish_batch``
        consumer) — observably identical to feeding the same events through
        :meth:`sink` one at a time, bit for bit: reports, snapshots,
        actuation log, straggler state and the retention ring all match.

        The vectorized fast path folds the chunk with numpy in the exact
        float-addition order of the per-event path (``np.add.accumulate``
        is a strictly sequential left fold, so prepending the running
        accumulator replays the scalar ``+=`` chain).  It engages when
        nothing needs per-event callbacks: a tuner (sequential per-
        observation feedback), an ``on_event`` recorder, or an
        ``on_retired`` recorder without the batch-capable
        ``on_retired_batch`` hook all fall back to an internal per-event
        replay — as do pathologically malformed streams (duplicate
        same-phase events for one rank inside one occurrence), detected
        *before* any state is touched.
        """
        # rank/code keep their narrow dtypes: integer key arithmetic
        # upcasts where needed, and materialization always goes through
        # tolist() (python ints) -- no copies on the hot path
        rk = np.asarray(batch.rank)
        cd = np.asarray(batch.code)
        ci = np.asarray(batch.call_id).astype(np.int64, copy=False)
        ts = np.asarray(batch.t, dtype=np.float64)
        if rk.shape[0] == 0:
            return
        if (self.tuner is not None or self._rec_event is not None
                or (self._rec_retire is not None
                    and self._rec_retire_batch is None)):
            self._sink_loop(rk, cd, ci, ts)
            return
        with self._lock:
            ok = self._batch_fast(rk, cd, ci, ts)
        if not ok:
            self._sink_loop(rk, cd, ci, ts)

    def _sink_loop(self, rk, cd, ci, ts) -> None:
        """Per-event replay of a chunk: the correctness reference and the
        fallback for consumers/streams the fast path cannot serve."""
        names = PHASE_NAMES
        sink = self.sink
        for r, c, i, t in zip(rk.tolist(), cd.tolist(), ci.tolist(),
                              ts.tolist()):
            sink(r, names.get(c, f"code_{c}"), i, t)

    def _batch_fast(self, rk, cd, ci, ts) -> bool:
        """Vectorized chunk fold (lock held).  Returns False — with no
        state touched — when the stream needs the per-event replay.

        The pipeline: group events by call id; find occurrence-rotation
        boundaries (a rank re-entering — the per-event rule, via a
        segmented previous-same-rank-write scan); assign every retired
        segment a global retirement index ordered by its trigger event's
        stream position; join enter/slack/copy/dispatch per (segment,
        rank); then fold each accumulator chain with
        ``np.add.accumulate`` seeded by its running value, padding
        skipped terms with ``+0.0`` (bitwise identity: the accumulators
        are non-negative).  Open tails stay columnar in ``_calls`` as
        :class:`_Tail` views and seed the next chunk's first segments.
        """
        n = rk.shape[0]
        if int(rk.min()) < 0:
            return False             # negative ranks break the key packing
        if int(cd.min()) < 0 or int(cd.max()) > 4:
            return False             # unknown phase codes: replay per-event
            # (sink() ignores them but still creates the call record)
        # ---- 1. group by call id (stable sort: stream order within) ----
        # stable int argsort is a byte-wise LSD radix sort, so shifting the
        # ids into the narrowest unsigned dtype that holds their span cuts
        # radix passes; the order (hence the bitwise fold) is unchanged
        cmin, cmax = int(ci.min()), int(ci.max())
        span = cmax - cmin + 1
        if span <= 256:
            ord_c = (ci - cmin).astype(np.uint8).argsort(kind="stable")
        elif span <= 65536:
            ord_c = (ci - cmin).astype(np.uint16).argsort(kind="stable")
        elif -2 ** 31 <= cmin and cmax < 2 ** 31:
            ord_c = ci.astype(np.int32).argsort(kind="stable")
        else:
            ord_c = ci.argsort(kind="stable")
        ci_s = ci[ord_c]
        new_g = np.empty(n, dtype=bool)
        new_g[0] = True
        np.not_equal(ci_s[1:], ci_s[:-1], out=new_g[1:])
        gstart = np.nonzero(new_g)[0]
        n_groups = gstart.shape[0]
        gcids = ci_s[gstart]
        # group indices fit int32 (a chunk is memory-bounded far below
        # 2^31 events) — and int32 keys halve the radix sorts below
        gidx_s = np.cumsum(new_g, dtype=np.int32)
        gidx_s -= 1
        gidx = np.empty(n, dtype=np.int32)
        gidx[ord_c] = gidx_s
        gcids_l = gcids.tolist()
        calls = self._calls
        tails: List[Optional[_Tail]] = []
        for c in gcids_l:
            tl = calls.get(c)
            if tl is not None and tl.__class__ is CallRecord:
                tl = _Tail.from_record(tl)   # pure: not written back unless
                tails.append(tl)             # the batch commits
            else:
                tails.append(tl)
        carried = [(g, tl) for g, tl in enumerate(tails) if tl is not None]
        # the (segment, rank) packing key must cover carried-in ranks too —
        # a chunk touching only low ranks can inherit a tail from a wider one
        R = int(rk.max()) + 1
        if carried:
            c_rks = [a for _, tl in carried
                     for a in (tl.e_rk, tl.s_rk, tl.c_rk, tl.d_rk) if a.size]
            if c_rks:
                all_c = np.concatenate(c_rks)
                if int(all_c.min()) < 0:
                    return False
                hi = int(all_c.max()) + 1
                if hi > R:
                    R = hi
        # ---- 2. previous same-(group, rank) write (codes 0/3/4) ----
        # writes = events that put the rank into enter/dispatch (the
        # rotation rule's membership); only they need sorting, and a
        # write's predecessor within its (group, rank) run is simply the
        # previous element
        # integer index lists beat boolean-mask gathers ~6x here: a mask
        # gather rescans all n elements per column, nonzero pays that once
        w_idx = np.nonzero((cd == 0) | (cd >= 3))[0]
        w_pos = w_idx                  # pos is arange(n): pos[w_idx] == w_idx
        w_gi = gidx[w_idx]
        w_rk = rk[w_idx]
        if n_groups * R <= 65536:
            w_key = (w_gi * R
                     + w_rk.astype(np.int32, copy=False)).astype(np.uint16)
        elif n_groups * R < 2 ** 31:
            w_key = w_gi * R + w_rk.astype(np.int32, copy=False)
        else:
            w_key = w_gi.astype(np.int64) * R + w_rk
        nw = w_pos.shape[0]
        prev_w = np.empty(nw, dtype=np.int64)
        if nw:
            ow = w_key.argsort(kind="stable")
            k_s = w_key[ow]
            run_start = np.empty(nw, dtype=bool)
            run_start[0] = True
            np.not_equal(k_s[1:], k_s[:-1], out=run_start[1:])
            prev_s = np.empty(nw, dtype=np.int64)
            prev_s[0] = -1
            prev_s[1:] = w_pos[ow][:-1]
            prev_s[run_start] = -1
            prev_w[ow] = prev_s
        # ---- 3. boundary scan: rotations, per group in stream order ----
        w_cd = cd[w_idx]
        t_idx = np.nonzero(w_cd != 4)[0]     # codes 0 and 3 trigger rotation
        trig_g = w_gi[t_idx]
        if n_groups <= 256:
            t_ord = trig_g.astype(np.uint8).argsort(kind="stable")
        elif n_groups <= 65536:
            t_ord = trig_g.astype(np.uint16).argsort(kind="stable")
        else:
            t_ord = trig_g.argsort(kind="stable")
        tio = t_idx[t_ord]
        tg = trig_g[t_ord]
        t_lo = tg.searchsorted(np.arange(n_groups, dtype=np.int32))
        t_hi = np.append(t_lo[1:], tg.shape[0])
        tp_arr = w_pos[tio]
        tv_arr = prev_w[tio]
        tr_arr = w_rk[tio]
        t_lo_l, t_hi_l = t_lo.tolist(), t_hi.tolist()
        # A group whose trigger prev-write sequence is non-decreasing admits
        # a searchsorted boundary chain: the next boundary after seg_start
        # is the first trigger with prev >= seg_start, so the walk costs one
        # step per *boundary* instead of one per *trigger*.  Real streams
        # (ranks re-entering in a stable order) are monotone; anything else
        # drops to the literal per-trigger scan for that group.
        nonmono = np.zeros(n_groups, dtype=bool)
        any_nonmono = False
        if tv_arr.shape[0] > 1:
            bad = (tv_arr[1:] < tv_arr[:-1]) & (tg[1:] == tg[:-1])
            if bad.any():
                nonmono[tg[1:][bad]] = True
                any_nonmono = True
        if not any_nonmono and tg.shape[0]:
            # every group monotone: the chain of boundaries is pointer
            # jumping through "first trigger with prev >= p" successors,
            # and every group's chain advances in lockstep — one
            # vectorized searchsorted per *wave* (the w-th boundary of
            # every still-active group) over (group, prev)-packed keys,
            # so the walk costs O(max boundaries per group) searchsorteds
            # instead of one successor per trigger.  Keys partition by
            # group, so a miss lands at/after the next group's run and
            # the "< t_hi" liveness test simply retires the group.
            big2 = n + 1
            small_tv = n_groups * big2 < 2 ** 31
            if small_tv:
                kg = tg * np.int32(big2)
                key_tv = kg + (tv_arr + 1).astype(np.int32)
                j_cur = key_tv.searchsorted(
                    np.arange(n_groups, dtype=np.int32) * np.int32(big2) + 1)
            else:
                kg = tg.astype(np.int64) * big2
                key_tv = kg + (tv_arr + 1)
                j_cur = key_tv.searchsorted(
                    np.arange(n_groups, dtype=np.int64) * big2 + 1)
            if carried:
                # a pre-boundary trigger with no in-chunk prev still
                # rotates if its rank lives in the carried tail
                j_l = j_cur.tolist()
                for g, tl in carried:
                    lo, j = t_lo_l[g], j_l[g]
                    if j > lo:
                        seen = tl.seen
                        for jj in range(lo, j):
                            if int(tr_arr[jj]) in seen:
                                j_cur[g] = jj
                                break
            wave_g: List[np.ndarray] = []
            wave_p: List[np.ndarray] = []
            alive = np.nonzero(j_cur < t_hi)[0]
            while alive.size:
                j = j_cur[alive]
                p = tp_arr[j]                # strictly ascending per group:
                wave_g.append(alive)         # prev(j) < pos(j), so the
                wave_p.append(p)             # successor is always beyond j
                if small_tv:
                    nxt = key_tv.searchsorted(
                        kg[j] + (p + 1).astype(np.int32))
                else:
                    nxt = key_tv.searchsorted(kg[j] + (p + 1))
                j_cur[alive] = nxt
                alive = alive[nxt < t_hi[alive]]
            if wave_g:
                all_g = np.concatenate(wave_g)
                all_p = np.concatenate(wave_p)
                m = all_g.shape[0]
                nb_g = np.bincount(all_g, minlength=n_groups)
                # group-major boundary order == per-group chain order
                # (stable sort keeps the ascending wave order per group)
                if n_groups <= 256:
                    gor = all_g.astype(np.uint8).argsort(kind="stable")
                elif n_groups <= 65536:
                    gor = all_g.astype(np.uint16).argsort(kind="stable")
                else:
                    gor = all_g.argsort(kind="stable")
                sg_sorted = all_g[gor]
                p_sorted = all_p[gor]
            else:
                m = 0
                nb_g = np.zeros(n_groups, dtype=np.int64)
                sg_sorted = p_sorted = _EMPTY_I
            seg_cnt = nb_g + 1
            grp_lo_arr = np.zeros(n_groups + 1, dtype=np.int64)
            np.cumsum(seg_cnt, out=grp_lo_arr[1:])
            n_segs = int(grp_lo_arr[-1])
            seg_g = np.repeat(np.arange(n_groups, dtype=np.int64), seg_cnt)
            sp_arr = np.full(n_segs, -1, dtype=np.int64)
            if m:
                nb_lo = np.zeros(n_groups, dtype=np.int64)
                np.cumsum(nb_g[:-1], out=nb_lo[1:])
                # boundary w of group g retires segment grp_lo[g] + w and
                # opens grp_lo[g] + w + 1 at the trigger position
                rs_arr = (grp_lo_arr[sg_sorted]
                          + np.arange(m, dtype=np.int64) - nb_lo[sg_sorted])
                sp_arr[rs_arr + 1] = p_sorted
                rp_arr = p_sorted
            else:
                rs_arr = rp_arr = _EMPTY_I
            grp_seg_lo = grp_lo_arr.tolist()
        else:
            nonmono_l = nonmono.tolist()
            seg_gidx: List[int] = []
            seg_sp: List[int] = []           # segment start pos (-1: head)
            grp_seg_lo = [0] * (n_groups + 1)
            ret_pos: List[int] = []          # trigger pos per retired segment
            ret_seg: List[int] = []
            sg_append, sp_append = seg_gidx.append, seg_sp.append
            rp_append, rs_append = ret_pos.append, ret_seg.append
            for g in range(n_groups):
                grp_seg_lo[g] = len(seg_gidx)
                sg_append(g)
                sp_append(-1)
                tl = tails[g]
                carry_active = tl is not None
                lo, hi = t_lo_l[g], t_hi_l[g]
                if lo == hi:
                    continue
                if nonmono_l[g]:
                    seen = None              # built lazily: only a carried
                    seg_start = 0            # group's pre-boundary triggers
                    for j in range(lo, hi):  # consult it
                        pv = tv_arr[j]
                        if pv < seg_start:
                            if not carry_active:
                                continue
                            if seen is None:
                                seen = tl.seen
                            if int(tr_arr[j]) not in seen:
                                continue
                        p = int(tp_arr[j])
                        rp_append(p)
                        rs_append(len(seg_gidx) - 1)
                        sg_append(g)
                        sp_append(p)
                        seg_start = p
                        carry_active = False
                    continue
                # per-group successor table: if trigger j rotates at pos
                # p, the next boundary is the first trigger with
                # prev >= p -- then the chain is pure pointer jumping
                tvg = tv_arr[lo:hi]
                nxt_g = (tvg.searchsorted(tp_arr[lo:hi]) + lo).tolist()
                j = int(tvg.searchsorted(0)) + lo
                if carry_active and j > lo:
                    # a pre-boundary trigger with no in-chunk prev still
                    # rotates if its rank lives in the carried tail
                    seen = tl.seen
                    for jj in range(lo, j):
                        if int(tr_arr[jj]) in seen:
                            j = jj
                            break
                while j < hi:
                    p = int(tp_arr[j])
                    rp_append(p)
                    rs_append(len(seg_gidx) - 1)
                    sg_append(g)
                    sp_append(p)
                    j = nxt_g[j - lo]
            grp_seg_lo[n_groups] = len(seg_gidx)
            seg_g = np.asarray(seg_gidx, dtype=np.int64)
            n_segs = seg_g.shape[0]
            sp_arr = np.asarray(seg_sp, dtype=np.int64)
            m = len(ret_pos)
            rp_arr = np.asarray(ret_pos, dtype=np.int64)
            rs_arr = np.asarray(ret_seg, dtype=np.int64)
        # event -> segment in O(n): segments are emitted in (group, pos)
        # order and group-sorted events are pos-ordered within each group,
        # so each segment covers a contiguous run starting at its trigger's
        # group-sorted index (group head: the group's first event).  The
        # (group-major, pos-ascending) key over sorted events is strictly
        # monotone, so the few boundary lookups are binary searches
        # instead of a full inverse-permutation scatter.
        head = sp_arr < 0
        seg_start_ix = np.empty(n_segs, dtype=np.int64)
        seg_start_ix[head] = gstart
        kq = gidx_s.astype(np.int64) * n + ord_c
        nh = ~head
        seg_start_ix[nh] = kq.searchsorted(seg_g[nh] * n + sp_arr[nh])
        counts = np.diff(np.append(seg_start_ix, n))
        sid = np.empty(n, dtype=np.int64)
        sid[ord_c] = np.repeat(np.arange(n_segs, dtype=np.int64), counts)
        # ---- 4. retirement order: global trigger-position order ----
        rid_of_seg = np.full(n_segs, -1, dtype=np.int64)
        if m:
            rp = rp_arr.astype(np.int32, copy=False)   # positions < n
            rorder = rp.argsort(kind="stable")
            sid_of_rid = rs_arr[rorder]
            rid_of_seg[sid_of_rid] = np.arange(m, dtype=np.int64)
        else:
            sid_of_rid = _EMPTY_I
        # ---- 5. per-class (segment, rank) tables, carry first ----
        if carried:
            base_sids = np.asarray([grp_seg_lo[g] for g, _ in carried],
                                   dtype=np.int64)

        def carry_cols(attr_rk, attr_t):
            """Concatenate one class across every carried tail: sids by
            repeat, positions ``-k..-1`` per tail (before any batch event
            under the stable keysort) via one arange minus group ends."""
            if not carried:
                return None
            rks = [getattr(tl, attr_rk) for _, tl in carried]
            cnt = np.asarray([a.shape[0] for a in rks], dtype=np.int64)
            tot = int(cnt.sum())
            if tot == 0:
                return None
            s = np.repeat(base_sids, cnt)
            r = np.concatenate(rks)
            t = np.concatenate([getattr(tl, attr_t) for _, tl in carried])
            p = (np.arange(tot, dtype=np.int64)
                 - np.repeat(np.cumsum(cnt), cnt))
            return s, r, t, p

        small_key = n_segs * R < 2 ** 31
        if small_key:
            sid_k = sid.astype(np.int32)
            rk_k = rk.astype(np.int32, copy=False)
        else:
            sid_k, rk_k = sid, rk
        key_u16 = n_segs * R <= 65536

        def cls_table(idx, carry):
            ev_key = sid_k[idx] * R + rk_k[idx]
            if carry is not None:
                cs, cr, ct2, cp2 = carry
                s = np.concatenate((cs, sid[idx]))
                r = np.concatenate((cr, rk[idx]))
                t = np.concatenate((ct2, ts[idx]))
                p = np.concatenate((cp2, idx))
                c_key = cs * R + cr
                key = np.concatenate(
                    (c_key.astype(ev_key.dtype, copy=False), ev_key))
            else:
                s, r, t, p = sid[idx], rk[idx], ts[idx], idx
                key = ev_key
            if key_u16:
                o = key.astype(np.uint16).argsort(kind="stable")
            else:
                o = key.argsort(kind="stable")
            ks = key[o]
            if ks.shape[0] > 1 and (ks[1:] == ks[:-1]).any():
                return None          # same-phase duplicate inside one segment
            return ks, s[o], r[o], t[o], p[o]

        ew = cls_table(np.nonzero((cd == 0) | (cd == 4))[0],
                       carry_cols("e_rk", "e_t"))
        s_idx = np.nonzero(cd == 1)[0]
        sl = cls_table(s_idx, carry_cols("s_rk", "s_t"))
        cp = cls_table(np.nonzero(cd == 2)[0], carry_cols("c_rk", "c_t"))
        dp = cls_table(np.nonzero(cd == 3)[0], carry_cols("d_rk", "d_t"))
        if ew is None or sl is None or cp is None or dp is None:
            return False
        # ---------------- point of no return: state mutation below ----------------
        acc = self._acc
        acc.n_records += m
        ek, es, er, et, ep = ew
        has_disp = np.zeros(n_segs, dtype=bool)
        if dp[0].size:
            has_disp[dp[1]] = True
        observed_base = np.zeros(m, dtype=np.int64) if m else _EMPTY_I
        if m and carried:
            obs = np.asarray([tl.observed for _, tl in carried],
                             dtype=np.int64)
            rid0 = rid_of_seg[base_sids]
            omask = (rid0 >= 0) & (obs > 0)
            observed_base[rid0[omask]] = obs[omask]
        # rows: one per entered rank of a retired segment, ordered by
        # (retirement index, dict-insertion position) — the per-event
        # accumulation sequence, concatenated
        e_rid = rid_of_seg[es]
        r_ix = np.nonzero(e_rid >= 0)[0]
        r_rid = e_rid[r_ix]
        r_sid = es[r_ix]
        r_rank = er[r_ix]
        r_t0 = et[r_ix]
        r_pos = ep[r_ix]
        if r_pos.size:
            shift = max(0, -int(r_pos.min()))
            rkey_o = r_rid * (n + shift + 1) + (r_pos + shift)
            if m * (n + shift + 1) < 2 ** 31:
                rkey_o = rkey_o.astype(np.int32)
            row_o = rkey_o.argsort(kind="stable")
            r_rid = r_rid[row_o]
            r_sid = r_sid[row_o]
            r_rank = r_rank[row_o]
            r_t0 = r_t0[row_o]
            r_pos = r_pos[row_o]
        n_enter = (np.bincount(r_rid, minlength=m) if m
                   else np.zeros(0, dtype=np.int64))

        # (segment, rank) keys live in a dense domain < n_segs*R, so when
        # that domain is about chunk-sized a scatter/gather lookup table
        # (one write + one read per key) beats per-key binary search
        lut_ok = small_key and n_segs * R <= 4 * n + 4096

        def join(cls, keys):
            ks = cls[0]
            if ks.size == 0 or keys.size == 0:
                return np.full(keys.shape, np.nan)
            if lut_ok:
                lut = np.full(n_segs * R, np.nan)
                lut[ks] = cls[3]
                return lut[keys]
            ix = np.minimum(ks.searchsorted(keys), ks.size - 1)
            return np.where(ks[ix] == keys, cls[3][ix], np.nan)

        rkey = r_sid * R + r_rank
        t1 = join(sl, rkey)
        t2 = join(cp, rkey)
        td = join(dp, rkey) if dp[0].size else np.full(rkey.shape, np.nan)
        valid = ~np.isnan(t1)
        slack = np.where(valid, t1 - r_t0, 0.0)
        slack = np.where(slack > 0.0, slack, 0.0)
        copyv = np.where(valid & ~np.isnan(t2), t2 - t1, 0.0)
        copyv = np.where(copyv > 0.0, copyv, 0.0)
        if dp[0].size:
            ovv = np.where(valid & has_disp[r_sid] & ~np.isnan(td),
                           r_t0 - td, 0.0)
            ovv = np.where(ovv > 0.0, ovv, 0.0)
        else:
            # no dispatches in scope: every overlap term is the +0.0 the
            # per-event replay would add, and +0.0 is a bitwise identity
            ovv = _EMPTY_F
        te_fixed = self._theta_eff.get(self._theta_default)
        if te_fixed is None:
            te_fixed = self.hw.theta_eff(self._theta_default)
            self._theta_eff[self._theta_default] = te_fixed
        low = slack - te_fixed
        down = valid & (low > 0.0)
        low = np.where(down, low, 0.0)
        w_slack_hi, w_slack_lo = self._w_slack_hi, self._w_slack_lo
        w_copy_hi, w_copy_lo = self._w_copy_hi, self._w_copy_lo
        nrows = slack.shape[0]
        eb = np.empty((nrows, 2))
        eb[:, 0] = w_slack_hi * slack
        eb[:, 1] = w_copy_hi * copyv
        ep3 = np.empty((nrows, 3))
        ep3[:, 0] = w_slack_hi * (slack - low)
        ep3[:, 1] = w_slack_lo * low
        if self._scope_comm:
            ep3[:, 2] = np.where(down, w_copy_lo, w_copy_hi) * copyv
        else:
            ep3[:, 2] = w_copy_hi * copyv

        def fold(start: float, terms: np.ndarray) -> float:
            # ufunc.accumulate is a strictly sequential left fold: this
            # replays the scalar `+=` chain bit for bit.  It consumes the
            # (freshly-built, chunk-local) term array: seeding by one
            # scalar add to the head (IEEE addition commutes bitwise) and
            # accumulating in place skips an alloc + full copy per fold.
            if terms.size == 0:
                return start
            flat = terms.ravel()
            flat[0] += start
            return float(np.add.accumulate(flat, out=flat)[-1])

        busy_t = slack + copyv               # before fold() consumes them
        acc.overlap = fold(acc.overlap, ovv)
        acc.slack = fold(acc.slack, slack)
        acc.copy = fold(acc.copy, copyv)
        acc.busy = fold(acc.busy, busy_t)
        acc.e_base = fold(acc.e_base, eb)
        acc.n_down += int(np.count_nonzero(down))
        acc.exploited = fold(acc.exploited, low)
        acc.e_pol = fold(acc.e_pol, ep3)
        # ---- 6. straggler detector: retired records with new arrivals ----
        if m:
            det_rec = (n_enter >= 2) & (n_enter > observed_base)
            if det_rec.all():
                # the common shape — every retired record qualifies —
                # skips the gather entirely
                off = np.zeros(m + 1, dtype=np.int64)
                np.cumsum(n_enter, out=off[1:])
                self.detector.observe_barriers_cols(r_rank, r_t0, off)
            elif det_rec.any():
                off = np.zeros(m + 1, dtype=np.int64)
                np.cumsum(n_enter, out=off[1:])
                det_rids = np.nonzero(det_rec)[0]
                counts = n_enter[det_rids]
                doff = np.zeros(det_rids.size + 1, dtype=np.int64)
                np.cumsum(counts, out=doff[1:])
                take = np.concatenate([
                    np.arange(off[i], off[i] + c) for i, c in
                    zip(det_rids.tolist(), counts.tolist())
                ])
                self.detector.observe_barriers_cols(
                    r_rank[take], r_t0[take], doff)
            observed_fin = np.maximum(n_enter, observed_base)
        else:
            observed_fin = _EMPTY_I
        # ---- 7. actuations: qualifying barrier_exit events, stream order ----
        if self._timeout_armed:
            a_idx = s_idx                    # the barrier_exit events again
            a_t = ts[a_idx]
            if a_t.size:
                a_sid = sid[a_idx]
                a_rank = rk[a_idx]
                a_pos = a_idx                # pos is arange(n)
                akey = a_sid * R + a_rank
                if ek.size:
                    if lut_ok:
                        et_lut = np.full(n_segs * R, np.nan)
                        et_lut[ek] = et
                        ep_lut = np.full(n_segs * R, n, dtype=np.int64)
                        ep_lut[ek] = ep
                        fnd = ep_lut[akey] < a_pos
                        t0a = np.where(fnd, et_lut[akey], a_t)
                    else:
                        ix = np.minimum(ek.searchsorted(akey), ek.size - 1)
                        fnd = (ek[ix] == akey) & (ep[ix] < a_pos)
                        t0a = np.where(fnd, et[ix], a_t)
                else:
                    t0a = a_t
                slk = a_t - t0a
                q_ix = np.nonzero(slk >= self._theta_default)[0]
                nq = q_ix.shape[0]
                if nq:
                    self.n_actuations += 2 * nq
                    rec_pair, rec_act = self._rec_pair, self._rec_act
                    ring_cap = (None if rec_pair is not None
                                or rec_act is not None
                                or type(self._act_raw) is list
                                else self._act_raw.maxlen)
                    if ring_cap is not None and nq > ring_cap:
                        # bounded spine ring: entries past the capacity
                        # would be evicted on arrival — gather only the
                        # survivors
                        q_ix = q_ix[-ring_cap:]
                    qt = a_t[q_ix]
                    qr = a_rank[q_ix]
                    qc = ci[a_idx[q_ix]]
                    qs = slk[q_ix]
                    if rec_pair is not None:
                        raw = self._act_raw
                        for row in zip(qt.tolist(), qr.tolist(),
                                       qc.tolist(), qs.tolist()):
                            raw.append(row)
                            rec_pair(*row)
                    elif rec_act is not None:
                        log = self._act_log
                        for t_, r_, c_, s_ in zip(qt.tolist(), qr.tolist(),
                                                  qc.tolist(), qs.tolist()):
                            pair = (Actuation(t_, r_, "set_pstate_min", c_, s_),
                                    Actuation(t_, r_, "restore_pstate_max",
                                              c_, s_))
                            log.extend(pair)
                            rec_act(pair[0])
                            rec_act(pair[1])
                    elif type(self._act_raw) is list:
                        self._act_raw.append(_ActBlock(qt, qr, qc, qs))
                    else:
                        self._act_raw.extend(zip(qt.tolist(), qr.tolist(),
                                                 qc.tolist(), qs.tolist()))
        # ---- 8. ring + batch recorder ----
        if m:
            row_off = np.zeros(m + 1, dtype=np.int64)
            np.cumsum(n_enter, out=row_off[1:])
            block = RetiredBlock(
                m, gcids[seg_g[sid_of_rid]], observed_fin, n_enter,
                sid_of_rid, r_rid, r_rank, r_t0, t1, t2, td, row_off,
                {"enter": (es, er, et, ep), "slack": sl[1:],
                 "copy": cp[1:], "dispatch": dp[1:]},
            )
            ring = self._ring
            cap = ring.maxlen
            start = 0 if cap is None or m <= cap else m - cap
            for i in range(start, m):
                ring.append((block, i))
            if self._rec_retire_batch is not None:
                self._rec_retire_batch(block)
        # ---- 9. open tails back into _calls, columnar ----
        tail_sids = np.asarray([grp_seg_lo[g + 1] - 1 for g in range(n_groups)],
                               dtype=np.int64)
        new_tails: List[Optional[_Tail]] = [None] * n_groups
        cls_cols = []
        for cls in (ew, sl, cp, dp):
            c_sid, c_rank, c_t, c_pos = cls[1], cls[2], cls[3], cls[4]
            t_ix = (np.nonzero(rid_of_seg[c_sid] < 0)[0] if c_sid.size
                    else _EMPTY_I)
            t_sid = c_sid[t_ix]
            t_rank = c_rank[t_ix]
            t_t = c_t[t_ix]
            t_pos = c_pos[t_ix]
            if t_pos.size:
                shift = max(0, -int(t_pos.min()))
                tkey = t_sid * (n + shift + 1) + (t_pos + shift)
                if n_segs * (n + shift + 1) < 2 ** 31:
                    tkey = tkey.astype(np.int32)
                o3 = tkey.argsort(kind="stable")
                t_sid, t_rank, t_t = t_sid[o3], t_rank[o3], t_t[o3]
            lo = np.searchsorted(t_sid, tail_sids, side="left")
            hi = np.searchsorted(t_sid, tail_sids, side="right")
            cls_cols.append((t_rank, t_t, lo.tolist(), hi.tolist()))
        for g in range(n_groups):
            cols = []
            for t_rank, t_t, lo_l, hi_l in cls_cols:
                a, b = lo_l[g], hi_l[g]
                cols.append(t_rank[a:b])
                cols.append(t_t[a:b])
            nb = grp_seg_lo[g + 1] - grp_seg_lo[g] == 1   # no rotation: the
            tl = tails[g]                                 # carry stays open
            obs = tl.observed if (nb and tl is not None) else 0
            new_tails[g] = _Tail(*cols, observed=obs)
        forder = np.argsort(ord_c[gstart], kind="stable")
        for g in forder.tolist():
            calls[gcids_l[g]] = new_tails[g]
        return True

    def on_phase(self, record: PhaseRecord) -> None:
        """Book one fully-formed phase (the EventBus ``publish_phase``
        consumer): same CallRecord, same timeout-policy actuation, and
        immediate retirement — the occurrence is complete by construction.
        """
        rec = CallRecord(record.call_id, site=record.site)
        rec.enter[record.rank] = record.t_enter
        with self._lock:
            if self._rec_phase is not None:
                self._rec_phase(record)
            self._close_slack(rec, record.rank, record.t_slack_end)
            self._close_copy(rec, record.rank, record.t_copy_end)
            self._retire(rec)

    # non-collective event sources ---------------------------------------------
    def ingest_phase(
        self,
        rank: int,
        call_id: int,
        t_enter: float,
        t_slack_end: float,
        t_copy_end: Optional[float] = None,
        site: Optional[int] = None,
    ) -> None:
        """Book one fully-formed phase from a non-collective source.

        Kwargs-shaped convenience over :meth:`on_phase` — producers that
        already speak the canonical vocabulary publish a
        :class:`~repro_torch.core.events.PhaseRecord` through the bus instead.
        """
        if t_copy_end is None:
            t_copy_end = t_slack_end
        self.on_phase(PhaseRecord(rank, call_id, t_enter, t_slack_end,
                                  t_copy_end, site))

    # accounting ---------------------------------------------------------------
    def recent_records(self) -> List[CallRecord]:
        """The last ``retention`` retired occurrences (debugging only —
        accounting never re-reads them).  Batched retirements sit in the
        ring as ``(RetiredBlock, i)`` views and materialize here."""
        with self._lock:
            return [r if r.__class__ is CallRecord else r[0].record(r[1])
                    for r in self._ring]

    @property
    def n_inflight(self) -> int:
        return len(self._calls)

    def interval_snapshot(self) -> IntervalStats:
        """Stats over the phases retired since the previous snapshot.

        An O(1) read: the cumulative accumulators minus the checkpoint
        taken at the previous snapshot (clamped at zero — differencing
        two running float sums can produce a negative ulp).  Non-
        destructive for :meth:`finalize` and does not feed the straggler
        detector — it is the arbiter's per-epoch poll, not the end-of-run
        report.  In-flight occurrences are picked up by a later snapshot
        once they rotate into retirement.
        """
        with self._lock:
            acc, mark = self._acc, self._mark
            stats = IntervalStats(
                n_calls=acc.n_records - mark.n_records,
                n_downshifts=acc.n_down - mark.n_down,
                slack=max(acc.slack - mark.slack, 0.0),
                copy=max(acc.copy - mark.copy, 0.0),
                busy=max(acc.busy - mark.busy, 0.0),
                exploited=max(acc.exploited - mark.exploited, 0.0),
                energy_baseline=max(acc.e_base - mark.e_base, 0.0),
                energy_policy=max(acc.e_pol - mark.e_pol, 0.0),
                overlap=max(acc.overlap - mark.overlap, 0.0),
            )
            self._mark = acc.clone()
        return stats

    def finalize(self) -> GovernorReport:
        """End-of-run report: the cumulative accumulators plus the records
        still in flight — O(in-flight), however long the run was."""
        with self._lock:
            acc = self._acc.clone()
            calls = self._calls
            for cid, rec in calls.items():
                if rec.__class__ is not CallRecord:
                    # columnar tail from the batched path: materialize in
                    # place (same key, so the dict position — and with it
                    # the accumulation order — is preserved)
                    rec = rec.to_record(cid)
                    calls[cid] = rec
                self._observe(rec)
                self._accumulate(rec, acc)
        return GovernorReport(
            n_calls=acc.n_records,
            n_downshifts=acc.n_down,
            total_slack=acc.slack,
            total_copy=acc.copy,
            exploited_slack=acc.exploited,
            energy_baseline=acc.e_base,
            energy_policy=acc.e_pol,
            straggler_summary=self.detector.summary(),
            stragglers=self.detector.stragglers(),
            total_overlap=acc.overlap,
            n_theta_decisions=self._n_theta,
        )

    def reset(self) -> None:
        """Return to the just-constructed state: in-flight records, ring,
        both accumulator sets, per-rank phase ends, logs and their
        counters, the straggler detector, and the tuner.  Two back-to-back
        identical runs on one governor produce identical reports (pinned
        by a regression test)."""
        with self._lock:
            self._calls.clear()
            self._ring.clear()
            self._acc = _Accum()
            self._mark = _Accum()
            self._last_end.clear()
            self.n_actuations = 0
            self._act_raw.clear()
            self._act_log.clear()
            self._n_theta = 0
            self._theta_log.clear()
            self._n_pred = 0
            self._pred_log.clear()
            self.detector.reset()
            if self.tuner is not None:
                self.tuner.reset()

