"""Fleet orchestration: router + replicas + autoscaler under one watt cap.

:class:`FleetSim` is the deterministic virtual-clock fleet: epoch by
epoch it (1) routes the trace's due arrivals through the
:class:`~repro_torch.serve.fleet.router.FleetRouter` against live replica
state, (2) advances every replica's serving loop to the epoch boundary,
(3) lets the :class:`~repro_torch.cluster.arbiter.PowerBudgetArbiter` reprice
watts from the replicas' governor snapshots (membership changes included
— a newcomer enters at the floor, a depart returns its grant to the
pool), and (4) asks the :class:`~repro_torch.serve.fleet.autoscaler.Autoscaler`
whether fleet TTFT pressure or stranded fill justifies a membership
change.  Same trace + seed ⇒ identical dispatch log and bit-identical
per-replica ``GovernorReport``s (pinned by tests).

:func:`run_engine_fleet` is the same control loop over *real*
:class:`~repro_torch.serve.engine.EngineSession` replicas on the wall clock —
the ``launch/serve.py --fleet`` path.  It shares the router and arbiter
epoch logic but not the clock, so it demonstrates wiring, not
reproducibility.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.cluster.arbiter import PowerBudgetArbiter
from repro_torch.core.policies import COUNTDOWN_SLACK, Policy
from repro_torch.core.pstate import DEFAULT_HW, HwModel
from repro_torch.serve.fleet.autoscaler import Autoscaler
from repro_torch.serve.fleet.replica import (
    ACTIVE,
    DRAINING,
    STOPPED,
    WARMING,
    SimReplica,
)
from repro_torch.serve.fleet.router import FleetRouter, ReplicaView
from repro_torch.serve.fleet.scenarios import FleetTrace


def _pct(samples: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(samples), q)) if samples else 0.0


@dataclass
class FleetConfig:
    """Shape of one fleet run (sim or real)."""

    cfg: Any                              # arch config (page geometry source)
    n_replicas: int = 2                   # static size / autoscale maximum
    autoscale: bool = False
    min_replicas: int = 1
    n_slots: int = 4
    max_len: int = 128
    page: int = 16
    num_pages: Optional[int] = None
    cap_w: float = 40.0                   # cluster cap across the fleet
    floor_w: float = 4.0
    epoch_s: float = 0.25
    step_s: float = 2e-3
    prefill_tok_s: float = 1e-4
    warmup_s: float = 0.5
    ttft_target: float = 0.5
    tpot_target: float = 0.05
    # autoscaler trigger: scale up when recent TTFT p95 crosses this (None
    # ⇒ 60% of the SLO target — proactive, so capacity arrives *before*
    # the SLO is violated rather than after)
    scaleup_ttft_s: Optional[float] = None
    hw: HwModel = DEFAULT_HW
    policy: Policy = COUNTDOWN_SLACK
    max_epochs: int = 100_000

    def __post_init__(self):
        # min_replicas == 0 would start an autoscaled fleet with zero
        # routable replicas: the router raises on the first arrival long
        # before the autoscaler could warm anything
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}")
        if self.n_replicas < self.min_replicas:
            raise ValueError(
                f"n_replicas {self.n_replicas} < min_replicas "
                f"{self.min_replicas}")


@dataclass
class FleetResult:
    """What one fleet run produced, ready for the bench table."""

    trace: str
    autoscaled: bool
    n_requests: int
    n_completed: int
    tokens_out: int
    energy_j: float
    duration_s: float
    ttft: Dict[str, float]
    tpot: Dict[str, float]
    ttft_attainment: float                # fraction of samples within target
    tpot_attainment: float
    prefix_hit_rate: float
    prefix_lookups: int
    prefix_hits: int
    n_replicas_peak: int
    n_scale_ups: int
    n_scale_downs: int
    cap_w: float
    max_alloc_sum_w: float                # max over epochs of granted watts
    reports: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    epochs: List[Dict[str, float]] = field(default_factory=list)

    @property
    def joules_per_token(self) -> float:
        return self.energy_j / max(self.tokens_out, 1)

    def to_dict(self) -> Dict[str, Any]:
        d = {k: getattr(self, k) for k in (
            "trace", "autoscaled", "n_requests", "n_completed", "tokens_out",
            "energy_j", "duration_s", "ttft", "tpot", "ttft_attainment",
            "tpot_attainment", "prefix_hit_rate", "prefix_lookups",
            "prefix_hits", "n_replicas_peak", "n_scale_ups", "n_scale_downs",
            "cap_w", "max_alloc_sum_w",
        )}
        d["joules_per_token"] = self.joules_per_token
        return d


class FleetSim:
    """Deterministic multi-replica serving fleet on a virtual clock."""

    def __init__(self, fc: FleetConfig, router: Optional[FleetRouter] = None):
        self.fc = fc
        self.router = router or FleetRouter()
        self.arbiter = PowerBudgetArbiter(cap_w=fc.cap_w, floor_w=fc.floor_w)
        trigger = (fc.scaleup_ttft_s if fc.scaleup_ttft_s is not None
                   else 0.6 * fc.ttft_target)
        self.autoscaler = Autoscaler(
            min_replicas=fc.min_replicas, max_replicas=fc.n_replicas,
            ttft_target=trigger, cap_w=fc.cap_w, floor_w=fc.floor_w,
        ) if fc.autoscale else None
        self.replicas: Dict[int, SimReplica] = {}
        self._next_id = 0
        self._activate_at: Dict[int, float] = {}
        n0 = fc.min_replicas if fc.autoscale else fc.n_replicas
        for _ in range(n0):
            self._spawn(t=0.0, state=ACTIVE)
        self.max_alloc_sum = 0.0
        self.energy_j = 0.0
        self.epoch_log: List[Dict[str, float]] = []
        # scaling signal: TTFT samples tagged with their landing epoch, so
        # pressure is judged on *recent* traffic — a count-based tail would
        # keep replaying peak-era latencies all through the valley
        self._ttft_seen: Dict[int, int] = {}
        self._ttft_recent: List[tuple] = []      # (epoch, ttft_s)
        self.signal_epochs = 8

    def _spawn(self, t: float, state: str) -> SimReplica:
        fc = self.fc
        rep = SimReplica(
            self._next_id, fc.cfg, n_slots=fc.n_slots, max_len=fc.max_len,
            page=fc.page, num_pages=fc.num_pages, hw=fc.hw, policy=fc.policy,
            step_s=fc.step_s, prefill_tok_s=fc.prefill_tok_s,
            ttft_target=fc.ttft_target, tpot_target=fc.tpot_target,
            t_created=t, state=state,
        )
        self.replicas[self._next_id] = rep
        if state == WARMING:
            self._activate_at[rep.replica_id] = t + fc.warmup_s
        self._next_id += 1
        return rep

    # ---- membership ------------------------------------------------------
    def _live(self) -> List[SimReplica]:
        return [r for r in self.replicas.values() if r.state != STOPPED]

    def _routable(self) -> List[SimReplica]:
        return [r for r in self.replicas.values() if r.state == ACTIVE]

    def _membership_count(self) -> int:
        return sum(1 for r in self.replicas.values()
                   if r.state in (ACTIVE, WARMING))

    def _scale_down_victim(self) -> Optional[SimReplica]:
        """Least-loaded active replica (ties: highest id — retire newest)."""
        cands = self._routable()
        if len(cands) <= 1:
            return None
        return min(cands, key=lambda r: (r.sched.n_active + r.sched.n_queued,
                                         -r.replica_id))

    def _ttft_signal(self, epoch: int) -> List[float]:
        """TTFT samples that landed within the last ``signal_epochs``
        epochs.  An idle valley therefore reads as *no* pressure — not as
        the peak's latencies replayed forever — which is what lets the
        scale-down branch ever fire."""
        for r in self._live():
            seen = self._ttft_seen.get(r.replica_id, 0)
            fresh = r.slo.ttft[seen:]
            if fresh:
                self._ttft_recent.extend((epoch, s) for s in fresh)
            self._ttft_seen[r.replica_id] = len(r.slo.ttft)
        cutoff = epoch - self.signal_epochs
        self._ttft_recent = [(e, s) for e, s in self._ttft_recent
                             if e >= cutoff]
        return [s for _, s in self._ttft_recent]

    # ---- main loop -------------------------------------------------------
    def run(self, trace: FleetTrace) -> FleetResult:
        fc = self.fc
        requests = trace.fresh_requests()
        i = 0
        t = 0.0
        epoch = 0
        while True:
            t_end = t + fc.epoch_s
            # 1) warmed replicas come online at the epoch boundary
            for rid, t_on in list(self._activate_at.items()):
                if t_on <= t:
                    rep = self.replicas[rid]
                    rep.state = ACTIVE
                    rep.now = max(rep.now, t)
                    del self._activate_at[rid]
            # 2) route the epoch's due arrivals against live replica state
            routable = self._routable()
            while i < len(requests) and requests[i].arrival < t_end:
                req = requests[i]
                dec = self.router.route(req, [r.view() for r in routable])
                self.replicas[dec.replica_id].submit(req)
                i += 1
            # 3) every serving replica advances to the epoch boundary
            for rep in self._live():
                rep.advance_to(t_end)
            for rep in self._live():
                if rep.state == DRAINING and rep.done:
                    rep.stop()
            # 4) arbiter reprices from governor snapshots (membership-aware)
            live = self._live()
            samples = [r.job_sample(fc.epoch_s) for r in live]
            alloc = self.arbiter.step(samples)
            self.max_alloc_sum = max(self.max_alloc_sum,
                                     sum(alloc.values(), 0.0))
            for rep, s in zip(live, samples):
                self.energy_j += s.power_w * fc.epoch_s
                if rep.job_id in alloc:
                    rep.set_cap(alloc[rep.job_id])
            # 5) autoscaler: TTFT pressure up, stranded fill down
            n_members = self._membership_count()
            if self.autoscaler is not None:
                recent = self._ttft_signal(epoch)
                fills = [r.sched.n_active / max(r.n_slots, 1)
                         for r in self._routable()]
                queued = sum(r.sched.n_queued for r in self._routable())
                action = self.autoscaler.decide(
                    epoch, n_members, _pct(recent, 95),
                    float(np.mean(fills)) if fills else 0.0, queued)
                if action > 0:
                    self._spawn(t=t_end, state=WARMING)
                elif action < 0:
                    victim = self._scale_down_victim()
                    if victim is not None:
                        victim.state = DRAINING
            self.epoch_log.append({
                "t": t_end, "n_replicas": float(n_members),
                "alloc_sum_w": sum(alloc.values(), 0.0),
                "queued": float(sum(r.sched.n_queued for r in live)),
                "active": float(sum(r.sched.n_active for r in live)),
            })
            t = t_end
            epoch += 1
            if i >= len(requests) and all(r.done for r in self._live()):
                break
            if epoch > fc.max_epochs:
                raise RuntimeError(f"fleet exceeded {fc.max_epochs} epochs")
        return self._result(trace, requests, t)

    # ---- reporting -------------------------------------------------------
    def _result(self, trace: FleetTrace, requests, duration: float) -> FleetResult:
        fc = self.fc
        reps = list(self.replicas.values())
        ttft = [s for r in reps for s in r.slo.ttft]
        tpot = [s for r in reps for s in r.slo.tpot]
        lookups = sum(r.prefix_cache.n_lookups for r in reps)
        hits = sum(r.prefix_cache.n_hits for r in reps)
        t_matched = sum(r.prefix_cache.tokens_matched for r in reps)
        t_looked = sum(r.prefix_cache.tokens_looked_up for r in reps)
        peak = max((int(e["n_replicas"]) for e in self.epoch_log), default=0)
        return FleetResult(
            trace=trace.name, autoscaled=fc.autoscale,
            n_requests=len(requests),
            n_completed=sum(len(r.finished) for r in reps),
            tokens_out=sum(r.tokens_out for r in reps),
            energy_j=self.energy_j, duration_s=duration,
            ttft={"n": len(ttft), "p50": _pct(ttft, 50),
                  "p95": _pct(ttft, 95), "p99": _pct(ttft, 99)},
            tpot={"n": len(tpot), "p50": _pct(tpot, 50),
                  "p95": _pct(tpot, 95), "p99": _pct(tpot, 99)},
            ttft_attainment=(
                sum(s <= fc.ttft_target for s in ttft) / len(ttft)
                if ttft else 1.0),
            tpot_attainment=(
                sum(s <= fc.tpot_target for s in tpot) / len(tpot)
                if tpot else 1.0),
            prefix_hit_rate=t_matched / max(t_looked, 1),
            prefix_lookups=lookups, prefix_hits=hits,
            n_replicas_peak=peak,
            n_scale_ups=(self.autoscaler.n_scale_ups
                         if self.autoscaler else 0),
            n_scale_downs=(self.autoscaler.n_scale_downs
                           if self.autoscaler else 0),
            cap_w=fc.cap_w, max_alloc_sum_w=self.max_alloc_sum,
            reports={r.job_id: r.governor.finalize().to_dict() for r in reps},
            epochs=self.epoch_log,
        )

    def export_metrics(self, registry) -> None:
        """Fleet-level series (``fleet_*``) plus router/arbiter exports."""
        registry.gauge("fleet_replicas", "live replicas").set(
            float(self._membership_count()))
        registry.gauge("fleet_energy_joules", "energy booked so far").set(
            self.energy_j)
        lookups = sum(r.prefix_cache.tokens_looked_up
                      for r in self.replicas.values())
        matched = sum(r.prefix_cache.tokens_matched
                      for r in self.replicas.values())
        registry.gauge("fleet_prefix_hit_rate",
                       "prompt tokens served from resident pages").set(
                           matched / max(lookups, 1))
        self.router.export_metrics(registry)
        if self.autoscaler is not None:
            self.autoscaler.export_metrics(registry)
        self.arbiter.export_metrics(registry)


# --------------------------------------------------------------------------
# real-engine fleet (wall clock)
# --------------------------------------------------------------------------

def session_view(session, replica_id: int) -> ReplicaView:
    """Router view over a live :class:`~repro_torch.serve.engine.EngineSession`."""
    eng = session.engine
    return ReplicaView(
        replica_id=replica_id, n_slots=eng.n_slots,
        n_active=session.n_active, n_queued=session.n_queued,
        free_pages=eng.pool.free_pages,
        capacity_pages=eng.pool.capacity_pages,
        prefix_cache=eng.prefix_cache,
    )


def run_engine_fleet(engines, requests, *, cap_w: float, floor_w: float,
                     epoch_s: float = 0.25, slos=None, governors=None,
                     router: Optional[FleetRouter] = None,
                     hw: HwModel = DEFAULT_HW, max_steps: int = 200_000):
    """Drive N real :class:`~repro_torch.serve.engine.ContinuousEngine` replicas
    as one fleet on the wall clock.

    Routing happens at arrival time against live prefix/pool/load state;
    replicas interleave one batched decode step per round (all idle ⇒ one
    metered sleep toward the next arrival); the arbiter reprices per
    epoch from each replica's governor snapshot, same power model as
    :class:`~repro_torch.cluster.job.GovernorJob`.  Replicas may run either
    decode path (``attn_kernel="plain"``/``"cuda"``) — the two round
    once differently, so give every replica the same one where a request's
    tokens must not depend on which replica serves it.  Returns
    ``(finished, router, arbiter, sessions)``.
    """
    import time as _time

    from repro_torch.cluster.arbiter import JobSample
    from repro_torch.serve.engine import EngineSession

    slos = slos or [None] * len(engines)
    governors = governors or [None] * len(engines)
    t_start = _time.monotonic()
    sessions = [EngineSession(e, governor=g, slo=s, t_start=t_start)
                for e, g, s in zip(engines, governors, slos)]
    router = router or FleetRouter()
    arbiter = PowerBudgetArbiter(cap_w=cap_w, floor_w=floor_w)
    pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
    i = 0
    next_epoch = epoch_s
    steps = 0
    stalls = 0
    while True:
        now = sessions[0].now()
        routed = False
        while i < len(pending) and pending[i].arrival <= now:
            req = pending[i]
            dec = router.route(
                req, [session_view(s, k) for k, s in enumerate(sessions)])
            sessions[dec.replica_id].submit(req)
            i += 1
            routed = True
        any_active = False
        for sess in sessions:
            sess.admit()
            if sess.n_active:
                any_active = True
                sess.decode_step()
                steps += 1
        if steps > max_steps:
            raise RuntimeError(f"fleet exceeded {max_steps} decode steps")
        if routed or any_active:
            stalls = 0
        if sessions[0].now() >= next_epoch:
            samples = []
            for k, gov in enumerate(governors):
                if gov is None:
                    continue
                stats = gov.interval_snapshot()
                exploited = min(stats.exploited, epoch_s)
                energy = (hw.watts(hw.f_max, hw.act_comp)
                          * (epoch_s - exploited)
                          + hw.watts(hw.f_min, hw.act_slack) * exploited)
                samples.append(JobSample(f"replica{k}", float(energy) / epoch_s,
                                         exploited / epoch_s))
            if samples:
                arbiter.step(samples)
            next_epoch += epoch_s
        if any_active:
            continue
        if i >= len(pending) and all(s.done for s in sessions):
            break
        # every replica idle: one metered sleep toward the next arrival
        # (routed-but-future ones live in session queues, unrouted in pending)
        targets = [s.next_arrival() for s in sessions]
        targets = [x for x in targets if x is not None]
        if i < len(pending):
            targets.append(pending[i].arrival)
        t0 = _time.monotonic()
        wait = (t_start + min(targets)) - t0
        if wait > 0:
            _time.sleep(min(wait, epoch_s))
            stalls = 0
        else:
            # every replica idle yet the next target is already due: only
            # routing or admission can make progress, and neither did this
            # round.  A queued request whose admission keeps failing (e.g.
            # pool pages pinned elsewhere) would otherwise busy-spin here
            # forever — decode steps never increment, so the max_steps
            # guard can't trip.  Bound the spin and fail loudly instead.
            stalls += 1
            if stalls > 10_000:
                queued = sum(s.n_queued for s in sessions)
                raise RuntimeError(
                    "fleet stalled: all replicas idle with a due arrival "
                    f"that cannot be admitted ({queued} queued, "
                    f"{len(pending) - i} unrouted) — likely page-pool "
                    "exhaustion by pinned/resident pages")
        t1 = _time.monotonic()
        for s in sessions:
            s.note_idle(t0, t1)
    finished: List[Any] = []
    for sess in sessions:
        finished.extend(sess.finished)
    return finished, router, arbiter, sessions
