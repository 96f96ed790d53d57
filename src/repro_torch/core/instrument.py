"""Collective instrumentation on ``torch.distributed``: artificial barriers
and host phase events.

This is the port of the paper's PMPI interception layer (§4.1-4.2):

* ``cd_psum`` / ``cd_pmean`` / ``cd_all_gather`` / ``cd_ppermute`` wrap the
  real collective with (i) an *artificial barrier*, a 1-element fp32
  all-reduce on the payload's device (``MPI_Barrier``), or for
  ``cd_ppermute`` a 1-element send/recv over the same pairs (``Isend +
  Wait``), that contains exactly the slack, and (ii) host phase events
  (barrier-enter, barrier-exit = slack end, collective-exit = copy end)
  that drive the host :class:`~repro_torch.core.governor.Governor`, which
  applies the timeout policy.  The real collective starts only after the
  barrier has completed.

* ``cd_psum_async`` / ``cd_all_gather_async`` + ``cd_wait`` are the
  nonblocking-collective analogue (``MPI_Iallreduce`` + ``MPI_Wait``).  They
  extend the 3-phase barrier/copy taxonomy to 5 phases: ``dispatch_enter``
  at the async start and ``wait_enter`` when the caller blocks.  The window
  ``[dispatch_enter, wait_enter]`` is compute/communication *overlap*: the
  core is busy, so the governor accounts it as non-slack.  Slack for an
  async pair starts at the wait, as the paper's P2P ``Isend + Wait``
  barrier starts at the wait.

* Every barrier runs on a second process group with the same ranks as the
  payload's, made once per group and cached.  A group runs its operations
  in issue order (gloo and NCCL alike), so a barrier issued behind an
  in-flight async payload on the payload's own group would resolve only
  when the transfer had finished, and book wire time as slack.

* Events are stamped on the device's clock of progress, not the host's.
  On CUDA the host runs ahead of the card, and on NCCL ``work.wait()``
  makes the current stream wait, not the host.  So in "profile" mode
  every stamp follows a synchronise of the payload's stream: an enter
  stamp (``barrier_enter``, ``dispatch_enter``, ``wait_enter``) when the
  rank's device has reached the call, so compute still queued before it
  is not booked as slack, and an exit stamp when the operation has
  completed.  In "barrier" mode, which stamps nothing, ``work.wait()``
  alone orders the real collective after the barrier.

* The instrumentation mode is ambient (``set_mode``), mirroring the paper's
  LD_PRELOAD transparency: model / optimizer code always calls the wrappers
  and pays no barrier when the mode is "off".

* Host events fan out through one ambient :class:`~repro_torch.core.events.
  EventBus` (``get_event_bus()``).  The legacy single-slot
  ``set_event_sink``/``set_event_tee`` setters are thin shims over two
  named bus slots.

The wrappers take a tensor or a dict, list or tuple of them (nested) and a
``group`` (``None``: the world).  They return new tensors and never write
into the caller's input, as ``lax``'s functional collectives do.

Modes:
  off      — wrapper == real collective (baseline).
  barrier  — artificial barrier issued (no host events).
  profile  — barrier + host phase events, with ``enable_events(True)``.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.events import PHASE_NAMES, BatchAccumulator, EventBus
from repro_torch.tree import leaves as _leaves
from repro_torch.tree import unflatten as _unflatten

Group = Optional[dist.ProcessGroup]

_MODE = "off"
_EVENTS_ENABLED = False
_BUS = EventBus()
_LOCK = threading.Lock()
_CALL_COUNTER = [0]
_INGEST_MODE = "event"
_ACC: Optional[BatchAccumulator] = None
_BARRIER_GROUPS: Dict[Any, Any] = {}     # (world, ranks) -> their barrier group
DEFAULT_BATCH_SIZE = 65536      # 65536 events x 21 B/event ~= 1.4 MB buffer;
# the size where the governor's vectorized fold peaks (DESIGN.md §10)


def set_mode(mode: str) -> None:
    """Set ambient instrumentation mode: off | barrier | profile."""
    global _MODE
    if mode not in ("off", "barrier", "profile"):
        raise ValueError(mode)
    _MODE = mode


def enable_events(on: bool) -> None:
    """Host phase events synchronise the payload's stream at each stamp
    (a CUDA payload's collective would otherwise be stamped when it is
    enqueued); callers that want them opt in."""
    global _EVENTS_ENABLED
    _EVENTS_ENABLED = on


def get_mode() -> str:
    return _MODE


def get_event_bus() -> EventBus:
    """The ambient bus the instrumented collectives publish onto.

    Subscribe consumers directly: ``get_event_bus().subscribe(governor)``
    attaches anything exposing ``on_event``/``on_phase`` (the canonical
    subscriber protocol — see :mod:`repro_torch.core.events`).
    """
    return _BUS


def set_ingest_mode(mode: str, batch_size: int = DEFAULT_BATCH_SIZE) -> None:
    """Choose how host phase events reach the bus: ``"event"`` publishes
    each event as it happens (the low-latency path), ``"batched"`` buffers
    events in a fixed-dtype :class:`~repro_torch.core.events.
    BatchAccumulator` and publishes full columnar chunks.

    Switching modes flushes any buffered partial batch first, so no event
    is lost or reordered across the switch.
    """
    global _INGEST_MODE, _ACC
    if mode not in ("event", "batched"):
        raise ValueError(mode)
    flush_events()
    with _LOCK:
        _INGEST_MODE = mode
        _ACC = BatchAccumulator(batch_size) if mode == "batched" else None


def get_ingest_mode() -> str:
    return _INGEST_MODE


def flush_events() -> int:
    """Deliver everything the batched ingest mode is holding: the partial
    accumulator batch is enqueued behind any already-queued full chunks,
    then the bus queue is drained in FIFO order (so flushing never
    reorders events around chunks still in flight).  Drivers call this at
    loop boundaries and end-of-run so the governor sees every event
    before ``finalize``.  Returns events delivered; in ``"event"`` mode
    it still drains the queue (normally a no-op)."""
    with _LOCK:
        acc = _ACC
        batch = acc.flush() if acc is not None else None
    if batch is not None:
        _BUS.enqueue(batch)
    return _BUS.drain()


def set_event_sink(sink: Optional[Callable[[int, str, int, float], None]]) -> None:
    """Deprecated single-slot shim over :func:`get_event_bus`.

    Occupies the bus's ``"sink"`` named slot: installing replaces the
    previous sink, ``None`` vacates it, and any other subscribers are
    untouched.  New code should subscribe to the bus directly.
    """
    if sink is None:
        _BUS.unsubscribe("sink")
    else:
        _BUS.subscribe(sink, name="sink")


def set_event_tee(tee: Optional[Callable[[int, str, int, float], None]]) -> None:
    """Deprecated single-slot shim over :func:`get_event_bus` (slot
    ``"tee"``): a secondary consumer fed the identical stream, kept for
    sink-less recording call sites.  Any number of consumers can
    subscribe to the bus side by side.
    """
    if tee is None:
        _BUS.unsubscribe("tee")
    else:
        _BUS.subscribe(tee, name="tee")


def reset_instrumentation() -> None:
    """Restore every piece of ambient instrumentation state to its default:
    mode off, events disabled, empty bus, call counter at zero.  Ambient
    state otherwise leaks across tests.  The barrier groups stay: they
    belong to the process group they were made for."""
    global _MODE, _EVENTS_ENABLED, _INGEST_MODE, _ACC
    _MODE = "off"
    _EVENTS_ENABLED = False
    _BUS.clear()
    with _LOCK:
        _CALL_COUNTER[0] = 0
        _INGEST_MODE = "event"
        _ACC = None


def _emit(rank, phase_code, call_id) -> None:
    """Timestamp and publish onto the event bus: directly per event, or
    via the ingest accumulator when the batched spine is on (full buffers
    are queued and delivered at the next :func:`flush_events`, as the
    reference's producer does)."""
    if not _BUS:
        return
    t = time.monotonic()
    acc = _ACC
    if acc is None:
        _BUS.publish(int(rank), PHASE_NAMES[int(phase_code)], int(call_id), t)
        return
    with _LOCK:
        batch = acc.flush() if acc.append(
            int(rank), int(phase_code), int(call_id), t) else None
    if batch is not None:
        _BUS.enqueue(batch)


def _next_call_id() -> int:
    with _LOCK:
        _CALL_COUNTER[0] += 1
        return _CALL_COUNTER[0]


# --------------------------------------------------------------------------
# groups, completion
# --------------------------------------------------------------------------

def _world(group: Group):
    return dist.group.WORLD if group is None else group


def _global_rank(group: Group, rank: int) -> int:
    g = _world(group)
    return rank if g is dist.group.WORLD else dist.get_global_rank(g, rank)


def _barrier_group(group: Group):
    """The group the artificial barriers of ``group`` run on: the same
    ranks, its own queue.  Made on the first instrumented call over those
    ranks (every member makes that call), then kept for the life of the
    world: a second group over the same ranks would take the same name."""
    world = dist.group.WORLD
    key = (world, tuple(dist.get_process_group_ranks(_world(group))))
    with _LOCK:
        bg = _BARRIER_GROUPS.get(key)
    if bg is None:
        bg = dist.new_group(ranks=list(key[1]), use_local_synchronization=True)
        with _LOCK:
            for k in [k for k in _BARRIER_GROUPS if k[0] is not world]:
                del _BARRIER_GROUPS[k]                # groups of a destroyed world
            _BARRIER_GROUPS[key] = bg
    return bg


def _arrive(device: torch.device) -> None:
    """Wait until ``device`` has run what was queued before the call: the
    rank arrives at a collective when its device does."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _settle(works: Sequence[Any], device: torch.device, synchronize: bool) -> None:
    """Wait on ``works``; with ``synchronize``, also until the device has
    finished them (NCCL's ``wait`` only orders the current stream)."""
    for w in works:
        w.wait()
    if synchronize:
        _arrive(device)


def _device(tree: Any) -> torch.device:
    return _leaves(tree)[0].device


def _probe(tree: Any) -> torch.Tensor:
    """The barrier's 1-element fp32 payload, on the payload's device."""
    return torch.ones(1, dtype=torch.float32, device=_device(tree))


def _all_reduce_barrier(probe: torch.Tensor, group: Group, profile: bool) -> None:
    """The artificial barrier: a 1-element all-reduce over ``group``'s
    ranks, completed before it returns."""
    work = dist.all_reduce(probe, group=_barrier_group(group), async_op=True)
    _settle([work], probe.device, profile)


def _ppermute_barrier(perm) -> Callable[[torch.Tensor, Group, bool], None]:
    """The P2P artificial barrier: a 1-element send/recv over ``perm``'s
    pairs, completed before it returns."""
    def barrier(probe: torch.Tensor, group: Group, profile: bool) -> None:
        works, _ = _issue_ppermute(probe, group, perm, _barrier_group(group))
        _settle(works, probe.device, profile)

    return barrier


# --------------------------------------------------------------------------
# the real collectives: issue returns (works, finish); finish() assembles
# the output once the works are done
# --------------------------------------------------------------------------

Issued = Tuple[List[Any], Callable[[], Any]]


def _issue_psum(tree: Any, group: Group, mean: bool = False) -> Issued:
    outs = [x.clone(memory_format=torch.contiguous_format) for x in _leaves(tree)]
    works = [dist.all_reduce(o, group=group, async_op=True) for o in outs]
    n = dist.get_world_size(group)

    def finish():
        return _unflatten(tree, [o / n for o in outs] if mean else outs)

    return works, finish


def _issue_all_gather(tree: Any, group: Group, axis: int, tiled: bool) -> Issued:
    n = dist.get_world_size(group)
    parts, works = [], []
    for x in _leaves(tree):
        x = x.contiguous()
        bufs = [torch.empty_like(x) for _ in range(n)]
        works.append(dist.all_gather(bufs, x, group=group, async_op=True))
        parts.append(bufs)

    def finish():
        join = torch.cat if tiled else torch.stack
        return _unflatten(tree, [join(bufs, dim=axis) for bufs in parts])

    return works, finish


def _peers(group: Group, perm) -> Tuple[int, Optional[int], Optional[int]]:
    """This rank, and its destination and source under ``perm`` (pairs of
    group ranks ``(src, dst)``; None where it has none)."""
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    n = dist.get_world_size(group)
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute sources and destinations must be unique: {perm}")
    if not all(0 <= r < n for r in srcs + dsts):
        raise ValueError(f"ppermute pairs must name ranks below {n}: {perm}")
    me = dist.get_rank(group)
    dst = next((d for s, d in perm if s == me), None)
    src = next((s for s, d in perm if d == me), None)
    return me, dst, src


def _issue_ppermute(tree: Any, group: Group, perm, p2p_group: Group = None) -> Issued:
    """Each rank sends to its destination and receives from its source;
    zeros where no source exists, a local copy for a pair ``(r, r)``."""
    me, dst, src = _peers(group, perm)
    g = group if p2p_group is None else p2p_group
    outs, ops = [], []
    for x in _leaves(tree):
        x = x.contiguous()
        if src == me:
            outs.append(x.clone())
            continue
        out = torch.zeros_like(x)
        outs.append(out)
        if dst is not None and dst != me:
            ops.append(dist.P2POp(dist.isend, x, _global_rank(group, dst), g))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, out, _global_rank(group, src), g))
    works = dist.batch_isend_irecv(ops) if ops else []
    return list(works), lambda: _unflatten(tree, outs)


def _complete(issued: Issued, device: torch.device, synchronize: bool) -> Any:
    works, finish = issued
    _settle(works, device, synchronize)
    return finish()


def _instrumented(issue: Callable[[Any], Issued], tree: Any, group: Group,
                  barrier=_all_reduce_barrier) -> Any:
    mode = _MODE
    device = _device(tree)
    if mode == "off":
        return _complete(issue(tree), device, False)
    call_id = _next_call_id()
    profile = mode == "profile" and _EVENTS_ENABLED
    if profile:
        rank = dist.get_rank(group)
        _arrive(device)
        _emit(rank, 0, call_id)                       # barrier enter (slack start)
    barrier(_probe(tree), group, profile)             # ---- artificial barrier ----
    if profile:
        _emit(rank, 1, call_id)                       # barrier exit (slack end)
    # the real collective is issued only after the barrier has completed
    out = _complete(issue(tree), device, profile)
    if profile:
        _emit(rank, 2, call_id)                       # copy exit
    return out


# --------------------------------------------------------------------------
# public wrappers (the "PMPI interface")
# --------------------------------------------------------------------------

def warm_up(device: torch.device, group: Group = None) -> None:
    """Make the communicators of ``group`` and of its barrier group with
    one uninstrumented 1-element all-reduce on each, completed.  A backend
    such as NCCL builds a group's communicator on the group's first
    collective; without this, that setup (hundreds of ms on NCCL) would
    land inside the first instrumented call's barrier and be booked as
    slack.  Counts no call and emits no event."""
    probe = torch.zeros(1, dtype=torch.float32, device=device)
    for g in (group, _barrier_group(group)):
        dist.all_reduce(probe, group=g)
    _arrive(probe.device)


def cd_psum(tree: Any, group: Group = None) -> Any:
    """Instrumented all-reduce sum (collective COUNTDOWN Slack barrier §4.2.1)."""
    return _instrumented(lambda t: _issue_psum(t, group), tree, group)


def cd_pmean(tree: Any, group: Group = None) -> Any:
    """Instrumented all-reduce mean: the sum over the group divided by its size."""
    return _instrumented(lambda t: _issue_psum(t, group, mean=True), tree, group)


def cd_all_gather(tree: Any, group: Group = None, *, axis: int = 0,
                  tiled: bool = True) -> Any:
    """Instrumented all-gather: the ranks' tensors in rank order,
    concatenated along ``axis`` (``tiled``) or stacked on a new ``axis``."""
    return _instrumented(lambda t: _issue_all_gather(t, group, axis, tiled), tree, group)


class AsyncCollective(NamedTuple):
    """Handle returned by ``cd_*_async``: the in-flight collective plus the
    bookkeeping ``cd_wait`` needs to close the 5-phase event sequence."""

    works: List[Any]             # the payload's work handles
    finish: Callable[[], Any]    # assembles the output once they are done
    device: torch.device
    group: Group
    call_id: int                 # 0 when mode is off (no events were armed)
    profile: bool
    rank: Optional[int]          # group rank, None unless profiling
    probe: Optional[torch.Tensor]  # 1-element barrier payload, made at dispatch:
    # the wait-side barrier must resolve on rank arrival, independent of
    # the in-flight payload (else the transfer would be booked as slack)


def _async_start(issue: Callable[[Any], Issued], tree: Any, group: Group) -> AsyncCollective:
    """Dispatch an async collective: emit ``dispatch_enter`` and start the
    real op.  Whatever the caller computes between start and ``cd_wait`` is
    the overlap window — accounted as non-slack by the governor."""
    mode = _MODE
    device = _device(tree)
    if mode == "off":
        return AsyncCollective(*issue(tree), device, group, 0, False, None, None)
    call_id = _next_call_id()
    profile = mode == "profile" and _EVENTS_ENABLED
    rank = None
    if profile:
        rank = dist.get_rank(group)
        _arrive(device)
        _emit(rank, 3, call_id)                       # dispatch enter (overlap start)
    return AsyncCollective(*issue(tree), device, group, call_id, profile, rank,
                           _probe(tree))


def cd_wait(handle: AsyncCollective) -> Any:
    """Block on an async collective (the ``MPI_Wait`` analogue).

    Emits ``wait_enter`` (slack starts HERE, not at dispatch), runs the
    artificial barrier that isolates the remaining wait, then completes the
    dispatched payload: ``barrier_exit`` closes the slack, ``copy_exit``
    closes the copy remainder — same tail as the blocking wrappers, so the
    governor reconstructs async and sync calls with one code path.

    The barrier runs on the barrier group, over the probe made at dispatch,
    so it resolves on rank arrival at the wait and not behind the in-flight
    transfer: booking the wire time as exploitable slack would collapse the
    copy remainder to zero and lose the copy-at-full-speed protection the
    slack scope exists for.
    """
    issued = (handle.works, handle.finish)
    if handle.call_id == 0:                           # dispatched with mode off
        return _complete(issued, handle.device, False)
    if handle.profile:
        _arrive(handle.device)                        # the overlapped compute is done
        _emit(handle.rank, 4, handle.call_id)         # wait enter (slack start)
    _all_reduce_barrier(handle.probe, handle.group, handle.profile)  # -- barrier --
    if handle.profile:
        _emit(handle.rank, 1, handle.call_id)         # barrier exit (slack end)
    # what remains of the transfer past this point is the copy phase
    out = _complete(issued, handle.device, handle.profile)
    if handle.profile:
        _emit(handle.rank, 2, handle.call_id)         # copy exit
    return out


def cd_psum_async(tree: Any, group: Group = None) -> AsyncCollective:
    """Nonblocking ``cd_psum``: start/wait pair (``MPI_Iallreduce`` analogue)."""
    return _async_start(lambda t: _issue_psum(t, group), tree, group)


def cd_all_gather_async(tree: Any, group: Group = None, *, axis: int = 0,
                        tiled: bool = True) -> AsyncCollective:
    """Nonblocking ``cd_all_gather``: start/wait pair."""
    return _async_start(lambda t: _issue_all_gather(t, group, axis, tiled), tree, group)


def cd_ppermute(tree: Any, perm, group: Group = None) -> Any:
    """Instrumented ``lax.ppermute`` (P2P COUNTDOWN Slack barrier §4.2.2).

    ``perm`` holds ``(src, dst)`` pairs of group ranks.  The artificial
    barrier for P2P is a 1-element send/recv over the same pairs — the
    non-blocking send/recv + wait analogue: it involves exactly the
    communicating pair, not the world.
    """
    return _instrumented(lambda t: _issue_ppermute(t, group, perm), tree, group,
                         _ppermute_barrier(perm))
