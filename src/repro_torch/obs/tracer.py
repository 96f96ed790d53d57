"""Span tracer: fold the run's event streams into a Perfetto-loadable
Chrome-trace-event JSON.

One run produces several concurrent narratives — per-rank phase spans from
the instrumented collectives, the governor's P-state actuations and theta
decisions, arbiter watt grants, serve batch joins/evictions, SLO
percentiles — and the paper's whole argument is about *seeing* them on one
timeline.  :class:`SpanTracer` captures all of them with an O(1) hot path
(a bounded deque append per event; spans are reconstructed at export time,
mirroring :class:`~repro_torch.cluster.trace.TraceRecorder`'s design) and
renders the Chrome trace-event flavor Perfetto loads natively:

* pid 1 ``ranks`` — one thread per rank; ``slack``/``copy``/``overlap``
  complete spans ("X") reconstructed with the governor's rotation rule.
* pid 2 ``governor`` — actuation instants per action, plus counter tracks
  ("C"): ``theta_us[site]`` from tuner decisions and anything the driver
  samples onto the ``governor`` track (cumulative slack, saving %).
* pid 3 ``serve`` — batch ``join``/``evict`` instants from the continuous
  engine, and its serving loop's complete spans (``span``): the loop's on
  thread 0 (``loop``), the requests' ``queue`` waits, which overlap, on a
  pool of ``queue`` lanes, a lane reused once its last wait has ended.
* pid 4 ``arbiter`` — per-job watt-grant counter tracks.
* pid 5 ``slo`` — TTFT/TPOT percentile counter tracks.

Two capture wirings exist.  The production one (both launch drivers, the
bench guard) hangs the tracer off the governor's ``recorder=`` slot via
:class:`GovernorTap`: spans come from *retired* CallRecords and ingested
PhaseRecords (occurrence-granular — one hook call per ~3·n_ranks raw
events), and actuations are not streamed at all: the governor books its
compact spine log as if unobserved and :meth:`SpanTracer.ingest_governor`
reads it back once before export.  That is what keeps the full stack
inside the 10% ``sink_throughput`` budget.  Direct bus subscription
(``on_event``) still works and captures raw 5-phase streams — useful for
probes and tests — but pays a Python call per event, which the budget
does not cover.

Timestamps are host-monotonic seconds on capture and are rebased to the
earliest captured instant on export (Chrome traces want microseconds from
an arbitrary epoch).  Export ordering is deterministic: events are sorted
by ``(ts, pid, tid, ph, name)`` with a stable sort, so the same capture
always serializes to the same bytes — the golden-fixture property the
conformance test pins.

:func:`validate_trace` is the schema gate the tests and the CI smoke step
run against produced artifacts.
"""
from __future__ import annotations

import collections
import heapq
import json
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.events import PhaseRecord

# fixed track layout (process ids in the Chrome trace)
PID_RANKS = 1
PID_GOVERNOR = 2
PID_SERVE = 3
PID_ARBITER = 4
PID_SLO = 5

TRACK_PIDS = {"ranks": PID_RANKS, "governor": PID_GOVERNOR,
              "serve": PID_SERVE, "arbiter": PID_ARBITER, "slo": PID_SLO}


class GovernorTap:
    """The obs stack's view of the governor's ``recorder=`` slot: forwards
    ingested phases, theta decisions, and retired occurrences to a
    :class:`SpanTracer` and/or a :class:`~repro_torch.obs.metrics.BusMetrics`.

    Deliberately exposes **no** ``on_event`` and **no** actuation hook: a
    per-event (or per-downshift) recorder call is the cost the 10%
    telemetry budget cannot afford.  A retired
    :class:`~repro_torch.core.governor.CallRecord` already carries every
    per-rank timestamp the spans need, and actuations already live in the
    governor's compact spine log — :meth:`SpanTracer.ingest_governor`
    reads them back once before export.  The governor pre-resolves
    recorder hooks, so each absent method costs it one ``None`` check and
    the hot path stays byte-for-byte the bare spine path."""

    __slots__ = ("_tracer", "_metrics")

    def __init__(self, tracer: Optional["SpanTracer"] = None, metrics=None):
        self._tracer = tracer
        self._metrics = metrics

    def on_phase(self, record: PhaseRecord) -> None:
        if self._tracer is not None:
            self._tracer.on_phase(record)
        if self._metrics is not None:
            self._metrics.on_phase(record)

    def on_theta(self, dec) -> None:
        if self._tracer is not None:
            self._tracer.on_theta(dec)

    def on_retired(self, rec) -> None:
        if self._tracer is not None:
            self._tracer.on_retired(rec)
        if self._metrics is not None:
            self._metrics.on_retired(rec)

    def on_retired_batch(self, block) -> None:
        """One :class:`~repro_torch.core.governor.RetiredBlock` from the batched
        ingest path.  The tap advertising this hook is what lets the
        governor keep its vectorized fold while recording; a child that
        only speaks ``on_retired`` gets the block expanded to per-record
        calls (identical materialization to the retention ring)."""
        for child in (self._tracer, self._metrics):
            if child is None:
                continue
            cb = getattr(child, "on_retired_batch", None)
            if cb is not None:
                cb(block)
            else:
                for rec in block.records():
                    child.on_retired(rec)


class RecorderFanout:
    """Fan the governor's single ``recorder=`` slot out to N recorder-likes
    (e.g. a :class:`~repro_torch.cluster.trace.TraceRecorder` and a
    :class:`GovernorTap`).  Children missing a hook are skipped for that
    hook; call lists are resolved once at construction so the per-event
    cost is one loop over bound methods."""

    def __init__(self, children):
        self.children = list(children)

        def hooks(name):
            # getattr-not-None, not hasattr: a nested fanout (or any
            # child using the None-shadowing convention below) carries
            # the attribute but may have disowned the hook
            return [cb for c in self.children
                    if (cb := getattr(c, name, None)) is not None]

        self._on_event = hooks("on_event")
        self._on_phase = hooks("on_phase")
        self._on_act = hooks("on_actuation")
        self._on_theta = hooks("on_theta")
        self._on_pair = hooks("on_actuation_pair")
        self._on_retired = hooks("on_retired")
        self._on_retired_batch = hooks("on_retired_batch")
        # children that speak only the per-record retirement form get
        # batched blocks expanded (same materialization as the ring)
        self._on_ret_only = [
            c.on_retired for c in self.children
            if getattr(c, "on_retired", None) is not None
            and getattr(c, "on_retired_batch", None) is None]
        # children that speak only the eager actuation form (TraceRecorder)
        # get expanded pairs when the governor uses the spine hook
        self._on_act_only = [
            c.on_actuation for c in self.children
            if getattr(c, "on_actuation", None) is not None
            and getattr(c, "on_actuation_pair", None) is None]
        # a hook no child subscribes to is *absent*, not a no-op: shadow
        # the class method with None so the governor's recorder
        # pre-resolution sees a missing hook — in particular, a fanout of
        # batch-capable children must not advertise ``on_event`` (which
        # would force the per-event replay and defeat the vectorized
        # batch path the children opted into)
        if not self._on_event:
            self.on_event = None
        if not self._on_phase:
            self.on_phase = None
        if not self._on_act:
            self.on_actuation = None
        if not self._on_theta:
            self.on_theta = None
        if not self._on_pair and not self._on_act_only:
            self.on_actuation_pair = None
        if not self._on_retired:
            self.on_retired = None
        if not self._on_retired_batch and not self._on_ret_only:
            self.on_retired_batch = None

    def on_event(self, rank, phase, call_id, t):
        for cb in self._on_event:
            cb(rank, phase, call_id, t)

    def on_phase(self, record):
        for cb in self._on_phase:
            cb(record)

    def on_actuation(self, act):
        for cb in self._on_act:
            cb(act)

    def on_actuation_pair(self, t, rank, call_id, slack):
        for cb in self._on_pair:
            cb(t, rank, call_id, slack)
        if self._on_act_only:
            from repro_torch.core.governor import Actuation

            for act in (Actuation(t, rank, "set_pstate_min", call_id, slack),
                        Actuation(t, rank, "restore_pstate_max", call_id,
                                  slack)):
                for cb in self._on_act_only:
                    cb(act)

    def on_theta(self, dec):
        for cb in self._on_theta:
            cb(dec)

    def on_retired(self, rec):
        for cb in self._on_retired:
            cb(rec)

    def on_retired_batch(self, block):
        for cb in self._on_retired_batch:
            cb(block)
        if self._on_ret_only:
            for rec in block.records():
                for cb in self._on_ret_only:
                    cb(rec)


class SpanTracer:
    """Capture phase/actuation/decision/grant streams; export Chrome JSON.

    The capture side is an :class:`~repro_torch.core.events.EventBus` subscriber
    (``on_event``/``on_phase``) plus the governor-output hooks
    (``on_actuation``/``on_theta`` — wire via :class:`GovernorTap`), the
    serve hooks (``serve_event`` for instants, ``span`` for the serving
    loop's complete spans), and a generic counter sampler (``sample``).
    Everything lands in one bounded ring; ``n_dropped`` reports evictions
    exactly like the trace recorder.
    """

    def __init__(self, capacity: int = 1_000_000,
                 meta: Optional[Dict[str, Any]] = None):
        self._raw: collections.deque = collections.deque(maxlen=capacity)
        self._append = self._raw.append
        self.capacity = capacity
        self.meta = dict(meta or {})
        self.n_seen = 0

    # ---- capture (hot path) ----------------------------------------------
    def on_event(self, rank: int, phase: str, call_id: int, t: float) -> None:
        self.n_seen += 1
        self._append(("ev", rank, phase, call_id, t))

    def on_phase(self, record: PhaseRecord) -> None:
        self.n_seen += 1
        self._append(("ph", record))

    def on_actuation_pair(self, t: float, rank: int, call_id: int,
                          slack: float) -> None:
        """Spine-form actuation pair from the governor's cheap path (one
        capture record; expands to the set/restore instants on export)."""
        self.n_seen += 1
        self._append(("actp", t, rank, call_id, slack))

    def on_retired(self, rec) -> None:
        """One retired :class:`~repro_torch.core.governor.CallRecord`.  The
        record is immutable once retired (rotation mints a fresh object),
        so the capture is a reference append; per-rank slack/copy/overlap
        spans are reconstructed from it at export."""
        self.n_seen += 1
        self._append(("ret", rec))

    def on_retired_batch(self, block) -> None:
        """One :class:`~repro_torch.core.governor.RetiredBlock` — the batched
        ingest form of :meth:`on_retired`: a single reference append
        carrying ``block.n`` retirements (it counts as one capture record
        for ring/drop accounting, like any other append); spans come out
        of the block's row arrays at export, identical to what the same
        stream's per-record captures would produce."""
        self.n_seen += 1
        self._append(("retb", block))

    # ---- capture (cold hooks) --------------------------------------------
    def ingest_governor(self, governor) -> None:
        """Pull the governor's actuation log into the capture.  Call once
        before :meth:`build`/:meth:`save`: actuations never ride the hot
        path — the governor books one compact spine tuple per downshift
        pair and the trace reads the log back here, in stream order, with
        original timestamps.  (Theta decisions arrive live via
        :class:`GovernorTap`; do not pull ``theta_log`` too or the counter
        track double-counts.)"""
        for act in governor.actuation_log:
            if act.action == "set_pstate_min":
                self.on_actuation_pair(act.t, act.rank, act.call_id,
                                       act.slack)

    def on_actuation(self, act) -> None:
        self.n_seen += 1
        self._append(("act", act))

    def on_theta(self, dec) -> None:
        self.n_seen += 1
        self._append(("theta", dec))

    def serve_event(self, kind: str, t: float, rid: int, slot: int) -> None:
        """A continuous-engine lifecycle instant: ``join`` or ``evict``."""
        self.n_seen += 1
        self._append(("serve", kind, t, rid, slot))

    def span(self, name: str, t0: float, t1: float, rid: Optional[int], n: int) -> None:
        """One complete span of the serving loop, ``t0`` to ``t1``: ``rid``
        is the request it belongs to (None for the loop's own), ``n`` the
        count its work is measured against (active slots for a decode step,
        prompt tokens for a join).  A span nests in those that hold it in
        time."""
        self.n_seen += 1
        self._append(("span", name, t0, t1, rid, n))

    def sample(self, track: str, name: str, t: float, value: float) -> None:
        """One counter sample on a named track (``governor`` | ``arbiter``
        | ``slo``): watt grants, cumulative slack, SLO percentiles, ..."""
        self.n_seen += 1
        self._append(("ctr", track, t, name, value))

    @property
    def n_dropped(self) -> int:
        return self.n_seen - len(self._raw)

    # ---- export ----------------------------------------------------------
    def _anchor(self) -> float:
        t0 = None
        for rec in self._raw:
            kind = rec[0]
            if kind == "ev" or kind == "serve" or kind == "span":
                t = rec[4] if kind == "ev" else rec[2]
            elif kind == "ph":
                t = rec[1].t_enter
            elif kind == "ctr":
                t = rec[2]
            elif kind == "actp":
                t = rec[1]
            elif kind == "ret":
                r = rec[1]
                times = list(r.dispatch.values()) + list(r.enter.values())
                if not times:
                    continue
                t = min(times)
            elif kind == "retb":
                b = rec[1]
                t = float(b.row_t0.min()) if b.row_t0.size else None
                # dispatch-only ranks have no row; pull their times from
                # the dispatch class restricted to this block's segments
                sid_arr, _dr, dt_arr, _dp = b.classes["dispatch"]
                if sid_arr.size:
                    lo = sid_arr.searchsorted(b.sid_of_rid, "left")
                    hi = sid_arr.searchsorted(b.sid_of_rid, "right")
                    for l, h in zip(lo.tolist(), hi.tolist()):
                        if h > l:
                            td = float(dt_arr[l:h].min())
                            if t is None or td < t:
                                t = td
                if t is None:
                    continue
            else:                       # act / theta carry .t
                t = rec[1].t
            if t0 is None or t < t0:
                t0 = t
        return t0 or 0.0

    def build(self) -> Dict[str, Any]:
        """Assemble the Chrome trace dict (pure function of the capture)."""
        t0 = self._anchor()

        def us(t: float) -> float:
            return round((t - t0) * 1e6, 3)

        events: List[Dict[str, Any]] = []
        tracks_used = set()
        ranks_seen = set()
        # the queue waits of requests due together overlap: each goes on
        # the lowest lane free at its start (lane k is thread 1 + k)
        lane_of: Dict[int, int] = {}
        busy: List[Tuple[float, int]] = []     # (end, lane) of the open waits
        free: List[int] = []
        n_lanes = 0
        for rec in sorted((r for r in self._raw if r[0] == "span" and r[1] == "queue"),
                          key=lambda r: (r[2], r[3])):
            while busy and busy[0][0] <= rec[2]:
                heapq.heappush(free, heapq.heappop(busy)[1])
            if free:
                lane = heapq.heappop(free)
            else:
                lane, n_lanes = n_lanes, n_lanes + 1
            lane_of[id(rec)] = lane
            heapq.heappush(busy, (rec[3], lane))
        serve_spans = False

        def span(rank: int, name: str, ts: float, te: float,
                 args: Dict[str, Any]) -> None:
            tracks_used.add("ranks")
            ranks_seen.add(rank)
            events.append({"ph": "X", "pid": PID_RANKS, "tid": int(rank),
                           "name": name, "cat": "phase", "ts": us(ts),
                           "dur": round(max(te - ts, 0.0) * 1e6, 3),
                           "args": args})

        # span reconstruction state (the governor's rotation rule: a fresh
        # enter for an already-open (rank, call) restarts the occurrence)
        opens: Dict[Tuple[int, int], float] = {}
        disp: Dict[Tuple[int, int], float] = {}
        exits: Dict[Tuple[int, int], float] = {}
        for rec in self._raw:
            kind = rec[0]
            if kind == "ev":
                _, rank, phase, call_id, t = rec
                key = (rank, call_id)
                if phase == "barrier_enter":
                    opens[key] = t
                elif phase == "dispatch_enter":
                    disp[key] = t
                elif phase == "wait_enter":
                    td = disp.pop(key, None)
                    if td is not None and t > td:
                        span(rank, "overlap", td, t, {"call": call_id})
                    opens[key] = t
                elif phase == "barrier_exit":
                    ts = opens.pop(key, None)
                    if ts is not None:
                        span(rank, "slack", ts, t, {"call": call_id})
                    exits[key] = t
                elif phase == "copy_exit":
                    ts = exits.pop(key, None)
                    if ts is not None:
                        span(rank, "copy", ts, t, {"call": call_id})
            elif kind == "ph":
                r: PhaseRecord = rec[1]
                args: Dict[str, Any] = {"call": r.call_id}
                if r.site is not None:
                    args["site"] = r.site
                span(r.rank, "slack", r.t_enter, r.t_slack_end, args)
                if r.t_copy_end > r.t_slack_end:
                    span(r.rank, "copy", r.t_slack_end, r.t_copy_end, args)
            elif kind == "ret":
                # per-rank spans from a retired CallRecord — the governor's
                # own reconstruction, so spans match what was accounted
                r = rec[1]
                args = {"call": r.call_id}
                if r.site is not None:
                    args = {"call": r.call_id, "site": r.site}
                for rank, t0r in r.enter.items():
                    td = r.dispatch.get(rank)
                    if td is not None and t0r > td:
                        span(rank, "overlap", td, t0r, args)
                    t1 = r.slack_end.get(rank)
                    if t1 is None:
                        continue
                    span(rank, "slack", t0r, t1, args)
                    t2 = r.copy_end.get(rank)
                    if t2 is not None and t2 > t1:
                        span(rank, "copy", t1, t2, args)
            elif kind == "retb":
                # a RetiredBlock's row arrays are exactly the retired
                # records' entered ranks in per-record insertion order, so
                # walking them yields the same spans the "ret" branch
                # would over block.records() (NaN marks a missing phase)
                b = rec[1]
                cids_l = b.cids.tolist()
                rid_l = b.row_rid.tolist()
                rank_l = b.row_rank.tolist()
                t0_l = b.row_t0.tolist()
                t1_l = b.row_t1.tolist()
                t2_l = b.row_t2.tolist()
                td_l = b.row_td.tolist()
                for i in range(len(rid_l)):
                    args = {"call": cids_l[rid_l[i]]}
                    rank, t0r = rank_l[i], t0_l[i]
                    td = td_l[i]
                    if td == td and t0r > td:
                        span(rank, "overlap", td, t0r, args)
                    t1 = t1_l[i]
                    if t1 != t1:
                        continue
                    span(rank, "slack", t0r, t1, args)
                    t2 = t2_l[i]
                    if t2 == t2 and t2 > t1:
                        span(rank, "copy", t1, t2, args)
            elif kind == "act":
                act = rec[1]
                tracks_used.add("governor")
                events.append({"ph": "i", "pid": PID_GOVERNOR, "tid": 0,
                               "name": act.action, "cat": "actuation",
                               "ts": us(act.t), "s": "t",
                               "args": {"rank": act.rank, "call": act.call_id,
                                        "slack": act.slack}})
            elif kind == "actp":
                _, t, rank, call_id, slack = rec
                tracks_used.add("governor")
                for name in ("set_pstate_min", "restore_pstate_max"):
                    events.append({"ph": "i", "pid": PID_GOVERNOR, "tid": 0,
                                   "name": name, "cat": "actuation",
                                   "ts": us(t), "s": "t",
                                   "args": {"rank": rank, "call": call_id,
                                            "slack": slack}})
            elif kind == "theta":
                dec = rec[1]
                tracks_used.add("governor")
                events.append({"ph": "C", "pid": PID_GOVERNOR, "tid": 0,
                               "name": f"theta_us[{dec.site}]",
                               "ts": us(dec.t),
                               "args": {"theta_us": dec.theta_after * 1e6}})
            elif kind == "serve":
                _, skind, t, rid, slot = rec
                tracks_used.add("serve")
                events.append({"ph": "i", "pid": PID_SERVE, "tid": 0,
                               "name": skind, "cat": "serve", "ts": us(t),
                               "s": "t", "args": {"rid": rid, "slot": slot}})
            elif kind == "span":
                _, name, ts, te, rid, n = rec
                tracks_used.add("serve")
                serve_spans = True
                events.append({"ph": "X", "pid": PID_SERVE, "tid": 1 + lane_of.get(id(rec), -1),
                               "name": name, "cat": "serve", "ts": us(ts),
                               "dur": round(max(te - ts, 0.0) * 1e6, 3),
                               "args": {"rid": rid, "n": n}})
            elif kind == "ctr":
                _, track, t, name, value = rec
                pid = TRACK_PIDS.get(track)
                if pid is None:
                    continue
                tracks_used.add(track)
                events.append({"ph": "C", "pid": pid, "tid": 0, "name": name,
                               "ts": us(t), "args": {"value": float(value)}})

        meta_events: List[Dict[str, Any]] = []
        for track in sorted(tracks_used):
            meta_events.append({"ph": "M", "pid": TRACK_PIDS[track], "tid": 0,
                                "name": "process_name",
                                "args": {"name": track}})
        for rank in sorted(ranks_seen):
            meta_events.append({"ph": "M", "pid": PID_RANKS, "tid": int(rank),
                                "name": "thread_name",
                                "args": {"name": f"rank {rank}"}})
        if serve_spans:
            for tid, name in enumerate(["loop"] + [f"queue {k}" for k in range(n_lanes)]):
                meta_events.append({"ph": "M", "pid": PID_SERVE, "tid": tid,
                                    "name": "thread_name", "args": {"name": name}})
        # deterministic ordering: stable sort on the event identity tuple —
        # identical captures serialize to identical bytes (golden fixture);
        # a serve span that starts with the span holding it follows it
        # (longer first), so that Perfetto nests it there
        events.sort(key=lambda e: (e["ts"], e["pid"], e["tid"], e["ph"],
                                   -e["dur"] if e["pid"] == PID_SERVE and e["ph"] == "X"
                                   else 0.0, e["name"]))
        other = dict(self.meta)
        other["n_dropped"] = self.n_dropped
        return {"displayTimeUnit": "ms",
                "traceEvents": meta_events + events,
                "otherData": other}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.build(), f, sort_keys=True)
        return path


def validate_trace(trace: Any, require_tracks: Tuple[str, ...] = ()) -> List[str]:
    """Schema-check a Chrome trace dict (or a path to one); returns the
    list of problems (empty = valid).  Checks the structural contract
    Perfetto needs — ``traceEvents`` with well-formed "X"/"i"/"C"/"M"
    events — plus the track-layout expectations of this tracer: every
    required track has its process_name metadata, per-rank spans carry
    non-negative durations, counter events carry numeric args.
    """
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    problems: List[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    named_tracks = {}
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "i", "C", "M"):
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        for key in ("pid", "tid", "name"):
            if key not in e:
                problems.append(f"event {i} ({ph}): missing {key}")
        if ph == "M":
            if e.get("name") == "process_name":
                named_tracks[e.get("args", {}).get("name")] = e.get("pid")
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i} ({ph} {e.get('name')!r}): bad ts {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i} (X {e.get('name')!r}): bad dur {dur!r}")
        if ph == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not args or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                problems.append(f"event {i} (C {e.get('name')!r}): "
                                f"args must be a non-empty numeric map")
    for track in require_tracks:
        if track not in named_tracks:
            problems.append(f"required track {track!r} missing "
                            f"(have {sorted(named_tracks)})")
        elif named_tracks[track] != TRACK_PIDS.get(track):
            problems.append(f"track {track!r} on pid {named_tracks[track]} "
                            f"(expected {TRACK_PIDS.get(track)})")
    return problems
