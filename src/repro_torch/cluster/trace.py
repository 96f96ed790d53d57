"""Durable run traces: record the governor's event stream, replay offline.

The live runtime is ephemeral — phase events stream through the governor
and are gone.  :class:`TraceRecorder` makes the stream durable: a bounded
ring buffer of exactly the records the governor consumes (instrument
phase events, fully-formed ingested phases) plus the actuations it
emits, serialized as versioned JSONL.  Because the capture *is* the
governor's input, :func:`replay` pushes a recorded trace through a fresh
:class:`~repro_torch.core.governor.Governor` and reproduces the live run's
slack/copy/energy totals bit-for-bit (tier-1 asserted), and
:func:`to_workload` lifts the same records into a
``core.simulator.Workload`` so :func:`what_if` can re-run the measured
phases under a different policy, HwModel, or power cap — the offline
what-if loop the cap arbiter is tuned against.

Record kinds (one JSON object per line; line 1 is the header):

  {"k": "hdr", "version": 3, "meta": {...}}
  {"k": "ev",    "rank": R, "phase": P, "call": C, "t": T}
  {"k": "phase", "rank": R, "call": C, "t0": .., "t1": .., "t2": .., "site": S?}
  {"k": "act",   "t": T, "rank": R, "action": A, "call": C, "slack": S}
  {"k": "theta", "t": T, "site": S, "rank": R, "before": .., "after": ..,
                 "reason": "decay"|"raise", "obs": ..}
  {"k": "pred",  "t": T, "site": S, "rank": R, "kind": "prearm"|"mispredict"
                 |"trip", "predicted": .., "observed": .., "cost": ..,
                 "source": "forest"|"ema"|""}

Version history: v1 was the 3-phase taxonomy without tuner records; v2 adds
the 5-phase events (``dispatch_enter``/``wait_enter``), the optional
``site`` on ingested phases, and ``theta`` tuner-decision records; v3 adds
``pred`` predictor-decision records (pre-arms, guard bookings, guard trips
from the cntd_predictive hybrid).  v1/v2 traces still load (each is a
strict subset of its successor).  ``theta``, ``act`` and ``pred`` records
are *outputs* of the live governor: replay re-derives all three, and the
differential tests assert the re-derived streams match the recorded ones.

Floats round-trip through ``repr`` so replay sees the identical bits.
"""
from __future__ import annotations

import collections
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.events import EventBus, PhaseRecord
from repro_torch.core.governor import Actuation, Governor, GovernorReport
from repro_torch.core.policies import COUNTDOWN_SLACK, Policy
from repro_torch.core.pstate import DEFAULT_HW, HwModel
from repro_torch.core.simulator import SimResult, Workload, simulate
from repro_torch.core.timeout import PredictorDecision, ThetaDecision, ThetaTuner

TRACE_VERSION = 3
SUPPORTED_VERSIONS = (1, 2, 3)


class TraceRecorder:
    """Ring-buffered, versioned capture of a governor's event stream.

    Speaks the canonical :mod:`repro_torch.core.events` subscriber protocol
    (``on_event``/``on_phase``), so it attaches anywhere in the pipeline:
    via ``Governor(recorder=rec)`` (captures sink events, ingested phases,
    actuations, and tuner decisions) or directly on the instrument bus —
    ``instrument.get_event_bus().subscribe(rec)`` — for sink-less capture
    of the raw collective events.
    """

    def __init__(self, capacity: int = 1_000_000, meta: Optional[Dict] = None):
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self.capacity = capacity
        self.meta = dict(meta or {})
        self.n_seen = 0

    # ---- capture hooks (the events.py subscriber protocol) ---------------
    def on_event(self, rank: int, phase: str, call_id: int, t: float) -> None:
        self._append({"k": "ev", "rank": int(rank), "phase": phase,
                      "call": int(call_id), "t": float(t)})

    def on_phase(self, record: PhaseRecord) -> None:
        rec = {"k": "phase", "rank": int(record.rank), "call": int(record.call_id),
               "t0": float(record.t_enter), "t1": float(record.t_slack_end),
               "t2": float(record.t_copy_end)}
        if record.site is not None:
            rec["site"] = int(record.site)
        self._append(rec)

    def on_actuation(self, act: Actuation) -> None:
        self._append({"k": "act", "t": float(act.t), "rank": int(act.rank),
                      "action": act.action, "call": int(act.call_id),
                      "slack": float(act.slack)})

    def on_theta(self, dec: ThetaDecision) -> None:
        self._append({"k": "theta", "t": float(dec.t), "site": int(dec.site),
                      "rank": int(dec.rank), "before": float(dec.theta_before),
                      "after": float(dec.theta_after), "reason": dec.reason,
                      "obs": float(dec.slack)})

    def on_predictor(self, dec: PredictorDecision) -> None:
        self._append({"k": "pred", "t": float(dec.t), "site": int(dec.site),
                      "rank": int(dec.rank), "kind": dec.kind,
                      "predicted": float(dec.predicted),
                      "observed": float(dec.observed),
                      "cost": float(dec.cost), "source": dec.source})

    def _append(self, rec: Dict) -> None:
        self.n_seen += 1
        self._buf.append(rec)

    # ---- access / persistence -------------------------------------------
    @property
    def n_dropped(self) -> int:
        """Records evicted by the ring bound (oldest-first)."""
        return self.n_seen - len(self._buf)

    def records(self) -> List[Dict]:
        return list(self._buf)

    def save(self, path: str) -> str:
        header = {"k": "hdr", "version": TRACE_VERSION, "meta": self.meta,
                  "n_records": len(self._buf), "n_dropped": self.n_dropped}
        with open(path, "w") as f:
            f.write(json.dumps(header) + "\n")
            for rec in self._buf:
                f.write(json.dumps(rec) + "\n")
        return path


def load(path: str, allow_truncated: bool = False) -> Tuple[Dict, List[Dict]]:
    """(header, records) from a JSONL trace; rejects unknown versions.

    A trace whose ring buffer evicted records (``n_dropped > 0`` in the
    header) cannot replay faithfully — enter events may be missing their
    exits — so it is refused unless ``allow_truncated`` is passed.
    """
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"empty trace file: {path}")
    header = json.loads(lines[0])
    if header.get("k") != "hdr":
        raise ValueError(f"{path}: first record is {header.get('k')!r}, not a header")
    if header.get("version") not in SUPPORTED_VERSIONS:
        raise ValueError(
            f"{path}: trace version {header.get('version')!r} not in "
            f"{SUPPORTED_VERSIONS}"
        )
    if header.get("n_dropped", 0) > 0 and not allow_truncated:
        raise ValueError(
            f"{path}: ring buffer dropped {header['n_dropped']} records — the "
            f"stream is truncated and will not replay exactly; pass "
            f"allow_truncated=True to load anyway"
        )
    return header, [json.loads(ln) for ln in lines[1:]]


def replay(
    records: List[Dict],
    policy: Policy = COUNTDOWN_SLACK,
    hw: HwModel = DEFAULT_HW,
    governor: Optional[Governor] = None,
    tuner: Optional[ThetaTuner] = None,
) -> Tuple[Governor, GovernorReport]:
    """Feed a recorded stream through a (fresh) governor, in capture order.

    With the same policy/hw as the live run this reproduces its report
    exactly; with a different policy/theta it is the cheapest what-if.
    ``act``, ``theta`` and ``pred`` records are outputs of the live
    governor and are skipped — the replayed governor re-derives its own (a
    fresh tuner — predictive included: seeded, counter-triggered refits —
    is a pure function of the observation order, so an adaptive or
    predictive run replayed under the same policy reproduces the recorded
    decisions bit-for-bit; pass ``tuner`` to replay under different tuner
    settings —
    mutually exclusive with ``governor``, which carries its own).
    """
    if governor is not None and tuner is not None:
        raise ValueError("pass either governor= or tuner=, not both — a "
                         "provided governor already carries its tuner")
    gov = governor if governor is not None else Governor(policy=policy, hw=hw,
                                                         tuner=tuner)
    # a private bus with the governor subscribed: replay is just another
    # producer of the canonical stream (identical to the live path, so the
    # reproduced report is bit-for-bit)
    bus = EventBus()
    bus.subscribe(gov)
    for r in records:
        if r["k"] == "ev":
            bus.publish(r["rank"], r["phase"], r["call"], r["t"])
        elif r["k"] == "phase":
            bus.publish_phase(PhaseRecord(r["rank"], r["call"], r["t0"],
                                          r["t1"], r["t2"], r.get("site")))
    return gov, gov.finalize()


def to_workload(records: List[Dict], name: str = "replayed",
                beta_comp: float = 0.3, beta_copy: float = 0.15) -> Workload:
    """Lift recorded phases into a ``Workload`` the simulator can re-run.

    Occurrences are reconstructed with the governor's rotation rule (a
    rank re-entering a call id starts a new occurrence); per-rank compute
    is the gap from that rank's previous phase end to its barrier enter
    (a rank's first phase anchors to the occurrence's earliest enter), so
    the simulator's emergent barrier reproduces the recorded arrival
    pattern, and recorded copy durations become copy work at f_max.
    Collective slack therefore survives the lift exactly; single-rank
    ingested phases (serve underfill/idle) have no arrival imbalance to
    re-emerge from and contribute compute+copy only.

    Async (5-phase) occurrences lift their ``dispatch_enter -> wait_enter``
    window into ``Workload.overlap``: the rank "arrives" at dispatch, and
    the overlapped seconds are marked so the simulator accounts them as
    busy compute rather than exploitable slack.
    """
    # normalize both record kinds into per-occurrence
    # {rank: [t0, t1, t2, overlap]} (t0 = slack-window anchor, i.e. the
    # dispatch for async pairs; overlap = dispatch->wait seconds).  The
    # grouping key for the lifted Workload.site honors a recorded ``site``
    # override (serve meters mint a fresh call id per phase but tag a
    # stable site — without the override every phase would become its own
    # one-observation site and an adaptive what_if could never adapt)
    open_calls: Dict[int, Dict[int, List[float]]] = {}
    order: List[Tuple[Tuple[str, int], Dict[int, List[float]]]] = []
    for r in records:
        if r["k"] == "phase":
            key = ("site", r["site"]) if "site" in r else ("call", r["call"])
            order.append((key, {r["rank"]: [r["t0"], r["t1"], r["t2"], 0.0]}))
        elif r["k"] == "ev":
            rank, call = r["rank"], r["call"]
            occ = open_calls.get(call)
            if r["phase"] in ("barrier_enter", "dispatch_enter"):
                if occ is None or rank in occ:
                    occ = {}
                    open_calls[call] = occ
                    order.append((("call", call), occ))
                occ[rank] = [r["t"], r["t"], r["t"], 0.0]
            elif occ is not None and rank in occ:
                if r["phase"] == "wait_enter":
                    occ[rank][3] = max(r["t"] - occ[rank][0], 0.0)
                    occ[rank][1] = occ[rank][2] = r["t"]
                elif r["phase"] == "barrier_exit":
                    occ[rank][1] = occ[rank][2] = r["t"]
                elif r["phase"] == "copy_exit":
                    occ[rank][2] = r["t"]

    ranks = sorted({rk for _, occ in order for rk in occ})
    if not ranks:
        raise ValueError("trace contains no phase records")
    rank_pos = {rk: i for i, rk in enumerate(ranks)}
    n, t_tasks = len(ranks), len(order)
    comp = np.zeros((t_tasks, n))
    copy = np.zeros(t_tasks)
    copy_rank = np.zeros((t_tasks, n))
    overlap = np.zeros(t_tasks)
    site = np.zeros(t_tasks, np.int64)
    site_of: Dict[int, int] = {}
    prev_end = {rk: None for rk in ranks}
    for k, (key, occ) in enumerate(order):
        site[k] = site_of.setdefault(key, len(site_of))
        t_base = min(t0 for t0, _, _, _ in occ.values())
        for rk, (t0, t1, t2, ov) in occ.items():
            start = prev_end[rk] if prev_end[rk] is not None else t_base
            comp[k, rank_pos[rk]] = max(t0 - start, 0.0)
            prev_end[rk] = t2
            copy_rank[k, rank_pos[rk]] = max(t2 - t1, 0.0)
        copy[k] = float(np.mean([copy_rank[k, rank_pos[rk]] for rk in occ])) if occ else 0.0
        overlap[k] = float(np.mean([occ[rk][3] for rk in occ])) if occ else 0.0
    # per-rank copy durations survive through the jitter channel, so the
    # simulated phase ends match each recorded t2, not just the task mean
    with np.errstate(invalid="ignore", divide="ignore"):
        copy_jitter = np.where(copy[:, None] > 0, copy_rank / copy[:, None], 1.0)
    return Workload(
        name=name, n_ranks=n, comp=comp, copy=copy,
        is_p2p=np.zeros(t_tasks, bool), partner=np.zeros((t_tasks, n), np.int64),
        site=site, nbytes=np.zeros(t_tasks),
        beta_comp=beta_comp, beta_copy=beta_copy,
        copy_jitter=copy_jitter,
        overlap=overlap if overlap.any() else None,
    )


def what_if(
    records: List[Dict],
    policy: Policy,
    hw: HwModel = DEFAULT_HW,
    power_cap: Optional[float] = None,
    beta_comp: float = 0.3,
    beta_copy: float = 0.15,
    power_dt: Optional[float] = None,
) -> SimResult:
    """Re-run a recorded trace through ``core.simulator`` under a different
    policy and/or cap: the offline answer to "what would this run have
    cost under theta X / cap Y" without touching the cluster."""
    wl = to_workload(records, beta_comp=beta_comp, beta_copy=beta_copy)
    res, _ = simulate(wl, policy, hw, power_dt=power_dt, power_cap=power_cap)
    return res
