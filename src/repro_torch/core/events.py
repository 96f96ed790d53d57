"""Canonical phase-event vocabulary and the one event bus every producer
and consumer shares.

Phase semantics used to live in four places at once: ``instrument``'s
ambient ``_SINK``/``_TEE`` globals (one consumer slot each), the
governor's ``ingest_phase`` kwargs, ``cluster.trace``'s JSONL record
shapes, and ad-hoc synthetic feeders.  This module is now the single
home:

* :class:`PhaseEvent` — one timestamped event of the 5-phase taxonomy
  (``barrier_enter``/``barrier_exit``/``copy_exit`` for blocking
  collectives, plus ``dispatch_enter``/``wait_enter`` for the async
  start/wait pairs).  On the hot path events travel as positional args,
  not objects — the NamedTuple exists for storage and tests.
* :class:`PhaseRecord` — one *fully-formed* single-rank phase from a
  producer that knows the whole span at once (serve decode underfill,
  idle gaps, trace replay): enter / slack-end / copy-end timestamps plus
  an optional stable ``site`` for the theta tuner's histograms.
* :class:`EventBus` — N registered subscribers fed the identical stream.
  A subscriber is any object with ``on_event(rank, phase, call_id, t)``
  and/or ``on_phase(record)`` methods (a bare callable subscribes as an
  ``on_event`` consumer).  The bus replaces the single-slot sink/tee
  globals: the governor, a :class:`~repro_torch.cluster.trace.TraceRecorder`,
  a straggler probe and any future consumer attach side by side.
* :class:`EventBatch` / :class:`BatchAccumulator` — the batched ingest
  spine (DESIGN.md §9): producers accumulate events into fixed-dtype
  columns (rank ``int32``, phase code ``int8``, call id ``int64``,
  timestamp ``float64`` — 21 B/event) and publish whole chunks through
  :meth:`EventBus.publish_batch`, which hands the columns to
  batch-capable subscribers (``on_batch``) and falls back to a decoded
  per-event loop for legacy ``on_event`` subscribers.  One batch costs
  one callback per subscriber instead of one per event, which is what
  lifts the spine from ~0.6M ev/s to the multi-M ev/s a week-long,
  thousand-rank trace needs.

The module is deliberately torch-free so ``import repro_torch.core.events`` stays
cheap for host-side tooling (recorders, replayers, benchmarks); numpy is
the only array dependency.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np

# the 5-phase event taxonomy (codes are what crosses the io_callback wire)
PHASE_NAMES = {
    0: "barrier_enter",      # blocking call entered; slack starts
    1: "barrier_exit",       # artificial barrier resolved; slack ends
    2: "copy_exit",          # real collective done; copy ends
    3: "dispatch_enter",     # async collective dispatched; overlap starts
    4: "wait_enter",         # caller blocks on the async handle; slack starts
}
PHASE_CODES = {name: code for code, name in PHASE_NAMES.items()}


class PhaseEvent(NamedTuple):
    """One timestamped phase event, as a value (storage/testing shape; the
    bus hot path passes the same four fields positionally)."""

    rank: int
    phase: str               # one of PHASE_NAMES.values()
    call_id: int
    t: float                 # host-side monotonic seconds


class PhaseRecord(NamedTuple):
    """One fully-formed single-rank phase from a non-streaming producer.

    ``t_enter <= t_slack_end <= t_copy_end``; ``site`` keys the theta
    tuner's per-callsite histogram when the producer mints a fresh
    ``call_id`` per phase (serve meters do) — without it every phase
    would start a cold histogram.
    """

    rank: int
    call_id: int
    t_enter: float
    t_slack_end: float
    t_copy_end: float
    site: Optional[int] = None


class EventBatch(NamedTuple):
    """A chunk of streamed events as fixed-dtype columns.

    Dtype layout (21 B/event; see DESIGN.md §9):

    ======== ========= =============================================
    column   dtype     meaning
    ======== ========= =============================================
    rank     int32     producing rank
    code     int8      phase code (:data:`PHASE_NAMES` key)
    call_id  int64     recurring call id / site (64-bit: serve meters
                       mint one id per phase, week-long runs overflow
                       int32)
    t        float64   host-monotonic seconds
    ======== ========= =============================================

    ``capacity`` carries the producer buffer size the chunk was cut
    from, so consumers can report batch occupancy (``n / capacity``)
    without knowing the producer.  Rows are in stream order — the batch
    is the same event sequence ``publish`` would have carried, just
    columnar.
    """

    rank: np.ndarray
    code: np.ndarray
    call_id: np.ndarray
    t: np.ndarray
    capacity: Optional[int] = None

    @property
    def n(self) -> int:
        return int(self.rank.shape[0])

    @property
    def occupancy(self) -> float:
        return self.n / self.capacity if self.capacity else 1.0

    @staticmethod
    def from_rows(rows: Iterable[Tuple[int, Any, int, float]],
                  capacity: Optional[int] = None) -> "EventBatch":
        """Build a batch from ``(rank, phase, call_id, t)`` rows (phase as
        name or code) — the tests'/replayers' convenience constructor."""
        rows = list(rows)
        codes = [PHASE_CODES.get(p, p) for _, p, _, _ in rows]
        return EventBatch(
            np.asarray([r for r, _, _, _ in rows], dtype=np.int32),
            np.asarray(codes, dtype=np.int8),
            np.asarray([c for _, _, c, _ in rows], dtype=np.int64),
            np.asarray([t for _, _, _, t in rows], dtype=np.float64),
            capacity,
        )

    def iter_events(self) -> Iterable[PhaseEvent]:
        """Decode back to per-event values (the legacy-subscriber view)."""
        names = PHASE_NAMES
        for r, c, i, t in zip(self.rank.tolist(), self.code.tolist(),
                              self.call_id.tolist(), self.t.tolist()):
            yield PhaseEvent(r, names.get(c, f"code_{c}"), i, t)


class BatchAccumulator:
    """Fixed-capacity columnar event buffer on the producer side.

    Producers call :meth:`append` per event (host callbacks) or
    :meth:`extend` with whole columns (vectorized producers — the
    simulator, device-side buffers fetched once per step), then
    :meth:`flush` cuts an :class:`EventBatch` copy and resets the write
    cursor.  ``full`` tells streaming producers when to flush; a final
    flush drains the remainder.  Not thread-safe — one producer owns one
    accumulator (the instrument layer's ordered ``io_callback`` already
    serializes its events).
    """

    __slots__ = ("capacity", "_rank", "_code", "_cid", "_t", "_n")

    def __init__(self, capacity: int = 8192):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._rank = np.empty(self.capacity, dtype=np.int32)
        self._code = np.empty(self.capacity, dtype=np.int8)
        self._cid = np.empty(self.capacity, dtype=np.int64)
        self._t = np.empty(self.capacity, dtype=np.float64)
        self._n = 0

    def __len__(self) -> int:
        return self._n

    @property
    def full(self) -> bool:
        return self._n >= self.capacity

    def append(self, rank: int, code: int, call_id: int, t: float) -> bool:
        """Buffer one event; returns True when the buffer just filled."""
        n = self._n
        self._rank[n] = rank
        self._code[n] = code
        self._cid[n] = call_id
        self._t[n] = t
        self._n = n + 1
        return self._n >= self.capacity

    def extend(self, ranks, codes, call_ids, ts) -> None:
        """Buffer whole columns (must fit the remaining capacity — block
        producers size their blocks or flush first)."""
        m = len(ranks)
        n = self._n
        if n + m > self.capacity:
            raise ValueError(
                f"extend of {m} events overflows capacity "
                f"{self.capacity} (cursor at {n}); flush first"
            )
        self._rank[n:n + m] = ranks
        self._code[n:n + m] = codes
        self._cid[n:n + m] = call_ids
        self._t[n:n + m] = ts
        self._n = n + m

    @property
    def free(self) -> int:
        return self.capacity - self._n

    def flush(self) -> Optional[EventBatch]:
        """Cut the buffered events into an :class:`EventBatch` (copied —
        the buffer is immediately reusable); None when empty."""
        n = self._n
        if n == 0:
            return None
        batch = EventBatch(
            self._rank[:n].copy(), self._code[:n].copy(),
            self._cid[:n].copy(), self._t[:n].copy(), self.capacity,
        )
        self._n = 0
        return batch

    def clear(self) -> None:
        self._n = 0


class _Entry(NamedTuple):
    name: Optional[str]
    subscriber: Any
    ident: Any               # stable identity key (bound methods resolve to
    # (owner id, function id): every attribute access mints a fresh bound-
    # method object, so `is` comparisons would silently never match)
    on_event: Optional[Callable[[int, str, int, float], None]]
    on_phase: Optional[Callable[[PhaseRecord], None]]
    on_batch: Optional[Callable[["EventBatch"], None]] = None


def _ident(subscriber: Any) -> Any:
    owner = getattr(subscriber, "__self__", None)
    func = getattr(subscriber, "__func__", None)
    if owner is not None and func is not None:
        return ("bound", id(owner), id(func))
    return id(subscriber)


class EventBus:
    """Fan one (rank, phase, call_id, t) / :class:`PhaseRecord` stream out
    to N subscribers, in subscription order.

    Subscription management takes a lock; ``publish``/``publish_phase``
    iterate an immutable snapshot tuple, so the hot path is a plain loop
    over bound methods with no locking of its own (per-subscriber
    consumers do their own locking — the governor does).
    """

    __slots__ = ("_entries", "_lock", "_event_cbs", "_phase_cbs",
                 "_batch_plan", "_queue", "_stat_events", "_stat_batches",
                 "_stat_occupancy", "_stat_fallback_events")

    def __init__(self) -> None:
        self._entries: List[_Entry] = []
        self._lock = threading.Lock()
        self._event_cbs: Tuple[Callable, ...] = ()
        self._phase_cbs: Tuple[Callable, ...] = ()
        # per-subscriber delivery plan for batches, in subscription order:
        # (on_batch, on_event) — exactly one is used per subscriber
        self._batch_plan: Tuple[Tuple[Optional[Callable], Optional[Callable]], ...] = ()
        self._queue: collections.deque = collections.deque()
        self._stat_events = 0            # events published via publish_batch
        self._stat_batches = 0
        self._stat_occupancy = 0.0       # sum of per-batch occupancy
        self._stat_fallback_events = 0   # events replayed per-event for
        # legacy (on_event-only) subscribers

    # ---- subscription management -----------------------------------------
    def _rebuild(self) -> None:
        self._event_cbs = tuple(e.on_event for e in self._entries
                                if e.on_event is not None)
        self._phase_cbs = tuple(e.on_phase for e in self._entries
                                if e.on_phase is not None)
        self._batch_plan = tuple(
            (e.on_batch, e.on_event) for e in self._entries
            if e.on_batch is not None or e.on_event is not None
        )

    @staticmethod
    def _resolve(subscriber: Any) -> Tuple[Optional[Callable], Optional[Callable],
                                           Optional[Callable]]:
        on_event = getattr(subscriber, "on_event", None)
        on_phase = getattr(subscriber, "on_phase", None)
        on_batch = getattr(subscriber, "on_batch", None)
        if on_event is None and on_phase is None and on_batch is None:
            if callable(subscriber):
                return subscriber, None, None
            raise TypeError(
                f"not a subscriber: {subscriber!r} has none of on_event / "
                f"on_phase / on_batch and is not callable"
            )
        return on_event, on_phase, on_batch

    def subscribe(self, subscriber: Any, *, name: Optional[str] = None) -> Any:
        """Register ``subscriber``; returns it (decorator-friendly).

        ``name`` creates a *named slot*: a later subscribe with the same
        name replaces the previous occupant and only it (the legacy
        single-slot ``set_event_sink``/``set_event_tee`` semantics ride on
        this — one callable may occupy both slots, and is then delivered
        twice, exactly as the two globals used to).  An *unnamed*
        re-subscribe of the same subscriber — object or bound method —
        replaces its previous unnamed entry rather than duplicating it.
        """
        on_event, on_phase, on_batch = self._resolve(subscriber)
        ident = _ident(subscriber)
        with self._lock:
            if name is not None:
                self._entries = [e for e in self._entries if e.name != name]
            else:
                self._entries = [
                    e for e in self._entries
                    if e.name is not None or e.ident != ident
                ]
            self._entries.append(_Entry(name, subscriber, ident,
                                        on_event, on_phase, on_batch))
            self._rebuild()
        return subscriber

    def unsubscribe(self, target: Any) -> bool:
        """Remove by subscriber identity (object or bound method — every
        entry it occupies, named or not) or by slot name; True if found.
        ``None`` is a no-op (it would otherwise match every unnamed
        entry's ``name``)."""
        if target is None:
            return False
        ident = _ident(target)
        with self._lock:
            before = len(self._entries)
            self._entries = [
                e for e in self._entries
                if e.ident != ident and e.name != target
            ]
            if len(self._entries) != before:
                self._rebuild()
                return True
            return False

    def clear(self) -> None:
        """Back to the just-constructed state: subscribers, the pending
        batch queue and the ingest counters (the ambient bus is reused
        across tests/runs — stats must not leak between them)."""
        with self._lock:
            self._entries = []
            self._rebuild()
            self._queue.clear()
            self._stat_events = 0
            self._stat_batches = 0
            self._stat_occupancy = 0.0
            self._stat_fallback_events = 0

    def subscribers(self) -> List[Any]:
        return [e.subscriber for e in self._entries]

    def __len__(self) -> int:
        return len(self._entries)

    def __bool__(self) -> bool:
        # truthiness == "anyone listening?" so producers can skip the
        # timestamp + publish entirely when nobody subscribed
        return bool(self._entries)

    # ---- publishing (hot path) -------------------------------------------
    def publish(self, rank: int, phase: str, call_id: int, t: float) -> None:
        """Fan one streamed event out to every on_event subscriber."""
        for cb in self._event_cbs:
            cb(rank, phase, call_id, t)

    def publish_event(self, event: PhaseEvent) -> None:
        """Value-shaped convenience over :meth:`publish`."""
        for cb in self._event_cbs:
            cb(event.rank, event.phase, event.call_id, event.t)

    def publish_phase(self, record: PhaseRecord) -> None:
        """Fan one fully-formed phase out to every on_phase subscriber."""
        for cb in self._phase_cbs:
            cb(record)

    # ---- batched ingest ----------------------------------------------------
    def publish_batch(self, batch: EventBatch) -> None:
        """Fan one columnar chunk out, in subscription order.

        Batch-capable subscribers (``on_batch``) get the columns whole —
        one callback per chunk.  Legacy ``on_event`` subscribers get the
        identical stream replayed as a decoded per-event loop, so mixing
        consumer generations on one bus stays correct (just not fast for
        the legacy ones).  The chunk carries the same stream order
        ``publish`` would have: a consumer cannot tell the paths apart by
        anything but wall-clock.
        """
        n = batch.rank.shape[0]
        if n == 0:
            return
        self._stat_events += n
        self._stat_batches += 1
        self._stat_occupancy += batch.occupancy
        plan = self._batch_plan
        decoded = None
        for on_batch, on_event in plan:
            if on_batch is not None:
                on_batch(batch)
                continue
            if decoded is None:
                names = PHASE_NAMES
                decoded = (batch.rank.tolist(),
                           [names.get(c, f"code_{c}") for c in batch.code.tolist()],
                           batch.call_id.tolist(), batch.t.tolist())
                self._stat_fallback_events += n
            ranks, phases, cids, ts = decoded
            for i in range(n):
                on_event(ranks[i], phases[i], cids[i], ts[i])

    def enqueue(self, batch: EventBatch) -> None:
        """Queue a chunk for a later :meth:`drain` — producers that must
        not run consumer code inline (a flush inside an ordered
        ``io_callback``, a device-buffer fetch loop) hand chunks over
        here and a drain point on the host loop delivers them."""
        if batch.rank.shape[0]:
            self._queue.append(batch)

    def drain(self, max_batches: Optional[int] = None) -> int:
        """Deliver queued chunks in FIFO order; returns events delivered.

        ``max_batches`` bounds one drain call so a latency-sensitive host
        loop can spread delivery over iterations."""
        delivered = 0
        budget = max_batches if max_batches is not None else -1
        while self._queue and budget != 0:
            batch = self._queue.popleft()
            self.publish_batch(batch)
            delivered += batch.rank.shape[0]
            budget -= 1
        return delivered

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def queued_events(self) -> int:
        return sum(b.rank.shape[0] for b in self._queue)

    def ingest_stats(self) -> dict:
        """Cumulative batched-ingest counters (the obs layer's
        :class:`~repro_torch.obs.metrics.IngestMetrics` collector derives rates
        and occupancy gauges from these)."""
        batches = self._stat_batches
        return {
            "events_total": self._stat_events,
            "batches_total": batches,
            "mean_occupancy": (self._stat_occupancy / batches) if batches else 0.0,
            "fallback_events_total": self._stat_fallback_events,
            "queue_depth": self.queue_depth,
            "queued_events": self.queued_events,
        }
