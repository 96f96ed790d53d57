"""Continuous-batching scheduler: arrival queue, admission, slot lifecycle.

The decode analogue of the paper's slack story is *underfill*: a static
batch burns f_max on finished/padded slots and on idle waits between
arrivals.  The scheduler's one job is to keep the decode batch full:

* requests queue with their arrival timestamps (FIFO by arrival — no
  skip-ahead, so admission is SLO-fair and head-of-line need is bounded
  by the pool-capacity check at submit);
* **admission control** is bounded by free *pages*: a request joins only
  when a decode slot is free AND :meth:`PagedKVPool.reserve` can book its
  worst-case page need (prompt + max_new) — so lazy page growth during
  decode can never fail;
* **join-on-prefill**: admitted requests are handed to the engine to
  prefill straight into a free slot of the running batch;
* **evict-on-EOS**: a finished request releases its slot and pages in the
  same step, making room for the next arrival.

An optional :class:`~repro_torch.serve.slo.SLOTracker` caps concurrency below
the slot count when decode-step latency (TPOT) blows its target.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.serve.kvcache import PagedKVPool

_RID = itertools.count()


@dataclass
class Request:
    """One generation request plus its runtime bookkeeping."""

    prompt: np.ndarray                       # (S,) int32 token ids
    max_new: int
    arrival: float = 0.0                     # seconds, relative to trace start
    eos_id: Optional[int] = None
    key: Optional[Any] = None                # per-request PRNG key (sampling)
    prefix_embeds: Optional[np.ndarray] = None   # (P, d) frontend prefix
    session: Optional[int] = None            # session id (fleet traces)
    out_script: Optional[np.ndarray] = None  # scripted continuation tokens
    # (fleet *sim* replicas emit these instead of model logits; the real
    # engine ignores them)
    rid: int = field(default_factory=lambda: next(_RID))

    # runtime state (engine-owned)
    slot: int = -1
    pages: List[int] = field(default_factory=list)
    prefix_match: Optional[Any] = None       # PrefixMatch committed at admit
    out: List[int] = field(default_factory=list)
    t_admit: float = -1.0
    t_first: float = -1.0                    # first-token completion (TTFT end)
    t_prev: float = -1.0                     # last token completion (TPOT base)
    t_done: float = -1.0

    @property
    def n_generated(self) -> int:
        return len(self.out)

    def wants_more(self) -> bool:
        if self.out and self.eos_id is not None and self.out[-1] == self.eos_id:
            return False
        return self.n_generated < self.max_new


class Scheduler:
    """Arrival queue + slot/page admission for :class:`ContinuousEngine`."""

    def __init__(self, pool: PagedKVPool, n_slots: int, n_prefix: int = 0,
                 slo=None, prefix_cache=None):
        self.pool = pool
        self.n_slots = n_slots
        self.n_prefix = n_prefix
        self.slo = slo
        # optional repro_torch.serve.fleet.prefix.PrefixCache: admission becomes
        # prefix-aware (matched full blocks are shared, not re-reserved)
        self.prefix_cache = prefix_cache
        self._heap: List = []                # (arrival, rid, Request)
        self._free_slots: List[int] = list(range(n_slots))
        self.active: Dict[int, Request] = {}  # slot -> request
        self.peak_active = 0

    # ---- queue -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        need = len(req.prompt) + self.n_prefix + req.max_new
        if need > self.pool.max_len:
            raise ValueError(
                f"request {req.rid} needs {need} positions > max_len {self.pool.max_len}"
            )
        if self.pool.pages_needed(need) > self.pool.capacity_pages:
            raise ValueError(
                f"request {req.rid} needs {self.pool.pages_needed(need)} pages "
                f"> pool capacity {self.pool.capacity_pages}"
            )
        heapq.heappush(self._heap, (req.arrival, req.rid, req))

    @property
    def n_queued(self) -> int:
        return len(self._heap)

    @property
    def n_active(self) -> int:
        return len(self.active)

    @property
    def done(self) -> bool:
        return not self._heap and not self.active

    def next_arrival(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    # ---- admission (join-on-prefill) ------------------------------------
    def admit(self, now: float) -> List[Request]:
        """Pop every arrived request that fits a slot + page reservation."""
        limit = self.n_slots
        if self.slo is not None:
            limit = max(1, min(limit, self.slo.max_concurrency(self.n_slots)))
        joins: List[Request] = []
        while self._heap and self._heap[0][0] <= now and self._free_slots \
                and len(self.active) < limit:
            req = self._heap[0][2]
            need = len(req.prompt) + self.n_prefix + req.max_new
            need_pages = self.pool.pages_needed(need)
            match, shared = None, []
            if self.prefix_cache is not None:
                # prefix-aware admission: matched full blocks are shared
                # references, so only the unshared remainder is reserved
                # (the CoW clone of a partial hit is part of that remainder).
                # match() is a stats-free trial — a head-of-line-blocked
                # request re-tries it every poll without skewing hit_rate
                match = self.prefix_cache.match(req.prompt)
                shared = list(match.full_pages)
                if match.partial_page is not None:
                    shared.append(match.partial_page)
                need_pages -= len(match.full_pages)
                # pin the matched pages: reservation pressure may evict
                # their trie nodes, but the pages must outlive this window
                self.pool.retain(shared)
            if not self.pool.reserve_pages(req.rid, need_pages):
                if shared:
                    self.pool.unretain(shared)
                break                                  # FIFO: wait for pages
            if match is not None:
                # commit: one reference per shared page rides the request,
                # released with the rest of its pages; drop the pin.  Only
                # now do lookup/hit counters and LRU clocks move
                if shared:
                    self.pool.share(req.rid, shared)
                    self.pool.unretain(shared)
                self.prefix_cache.commit(match)
                req.prefix_match = match
            heapq.heappop(self._heap)
            req.slot = self._free_slots.pop()
            req.t_admit = now
            self.active[req.slot] = req
            joins.append(req)
        self.peak_active = max(self.peak_active, len(self.active))
        return joins

    # ---- completion (evict-on-EOS) --------------------------------------
    def release(self, req: Request) -> None:
        self.active.pop(req.slot, None)
        self._free_slots.append(req.slot)
        self.pool.release(req.rid)
        req.slot = -1
        req.pages = []


def poisson_arrivals(n: int, rate: float, seed: int = 0,
                     burst_every: int = 0, burst_gap: float = 0.0) -> np.ndarray:
    """Arrival offsets (s) for ``n`` requests at ``rate`` req/s.

    ``burst_every > 0`` inserts an extra ``burst_gap`` pause after every
    k-th request — the bursty trace that makes static batching idle.
    """
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    gaps[0] = 0.0
    if burst_every:
        gaps[burst_every::burst_every] += burst_gap
    return np.cumsum(gaps)
