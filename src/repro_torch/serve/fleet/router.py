"""Prefix-aware + load-aware request routing across fleet replicas.

Placement is where prefix caching is won or lost in a fleet: pages are
resident *per replica*, so sending a session's next turn to a different
replica than its last one recomputes everything.  The router scores every
routable replica as

    score = w_prefix * matched_frac + w_free * free_frac - w_load * load_frac

where ``matched_frac`` is the longest resident prefix (``PrefixCache.
peek`` — no LRU side effects) over the prompt length, ``free_frac`` is
the pool's unreserved-page fraction, and ``load_frac`` is (active +
queued) over decode slots, allowed above 1 so backlog keeps repelling.
Ties (and the no-signal cold start) break to the **lowest replica id**,
which makes routing a pure function of replica state — the determinism
the fleet tests pin.

Replicas are duck-typed through :class:`ReplicaView` so the same router
fronts simulator replicas and real :class:`~repro_torch.serve.engine.
EngineSession` wrappers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence

_TIE_EPS = 1e-12


@dataclass
class ReplicaView:
    """What the router sees of one replica at decision time."""

    replica_id: int
    n_slots: int
    n_active: int
    n_queued: int
    free_pages: int
    capacity_pages: int
    prefix_cache: Any = None         # .peek(prompt) -> matched token count

    @property
    def load_frac(self) -> float:
        return (self.n_active + self.n_queued) / max(self.n_slots, 1)

    @property
    def free_frac(self) -> float:
        return self.free_pages / max(self.capacity_pages, 1)


@dataclass
class RouteDecision:
    """One dispatch: request -> replica, with the scores that chose it."""

    rid: int
    replica_id: int
    score: float
    matched_tokens: int
    scores: List[float] = field(default_factory=list)   # by candidate order


class FleetRouter:
    """Scores candidates, keeps the dispatch log, counts prefix affinity."""

    def __init__(self, w_prefix: float = 1.0, w_free: float = 0.3,
                 w_load: float = 0.5):
        self.w_prefix = w_prefix
        self.w_free = w_free
        self.w_load = w_load
        self.decisions: List[RouteDecision] = []
        self.n_prefix_routed = 0     # dispatches that followed a resident prefix

    def score(self, view: ReplicaView, prompt: Sequence[int]) -> float:
        matched = 0
        if view.prefix_cache is not None and len(prompt) > 1:
            matched = view.prefix_cache.peek(prompt)
        matched_frac = matched / max(len(prompt), 1)
        return (self.w_prefix * matched_frac
                + self.w_free * view.free_frac
                - self.w_load * view.load_frac)

    def route(self, req, views: List[ReplicaView]) -> RouteDecision:
        """Pick the best replica for ``req``; raises when none routable."""
        if not views:
            raise ValueError("no routable replicas")
        best: Optional[ReplicaView] = None
        best_score = -float("inf")
        best_matched = 0
        scores: List[float] = []
        # iterate in replica-id order so the < tie test is the lowest-id rule
        for view in sorted(views, key=lambda v: v.replica_id):
            matched = 0
            if view.prefix_cache is not None and len(req.prompt) > 1:
                matched = view.prefix_cache.peek(req.prompt)
            s = (self.w_prefix * matched / max(len(req.prompt), 1)
                 + self.w_free * view.free_frac
                 - self.w_load * view.load_frac)
            scores.append(s)
            if s > best_score + _TIE_EPS:
                best, best_score, best_matched = view, s, matched
        dec = RouteDecision(rid=req.rid, replica_id=best.replica_id,
                            score=best_score, matched_tokens=best_matched,
                            scores=scores)
        self.decisions.append(dec)
        if best_matched > 0:
            self.n_prefix_routed += 1
        return dec

    def export_metrics(self, registry) -> None:
        """``fleet_router_*`` series into a MetricsRegistry."""
        registry.gauge("fleet_router_decisions",
                       "requests dispatched").set(float(len(self.decisions)))
        registry.gauge("fleet_router_prefix_routed",
                       "dispatches that followed a resident prefix").set(
                           float(self.n_prefix_routed))
