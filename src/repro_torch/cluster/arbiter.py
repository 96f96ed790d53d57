"""Slack-driven power-budget arbitration across concurrent jobs.

The paper saves energy *inside* one job by spending measured slack at the
minimum P-state; at the cluster the same signal prices *watts between
jobs*: a job whose governor reports a high exploited-slack ratio is
demonstrably not frequency-bound — watts allocated to it above its floor
are stranded — while a job reporting near-zero slack is on the critical
path and converts every extra watt into progress (Medhat et al., power
redistribution for MPI clusters).

:class:`PowerBudgetArbiter` redistributes a fixed cluster cap each epoch
with AIMD convergence:

* **multiplicative decrease** — a job above ``target_ratio`` releases a
  ``beta`` fraction of its headroom above the per-job floor;
* **additive increase** — the freed pool (plus any unallocated cap) is
  shared among below-target jobs proportional to their slack deficit, at
  most ``alpha_w`` watts per job per epoch (the AIMD probe step);
* departed jobs return their entire allocation to the pool; new jobs
  enter at the floor and climb additively.

Invariants, property-tested in ``tests/test_cluster.py``: the sum of
allocations never exceeds ``cap_w`` and no active job is ever below
``floor_w``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

_EPS = 1e-9


@dataclass
class JobSample:
    """One epoch of telemetry from a power-managed tenant.

    ``exploited_ratio`` comes from ``Governor.interval_snapshot()`` (live
    jobs) or ``SimResult.exploited / rank-time`` (simulated jobs);
    ``power_w`` is the measured average draw over the epoch.
    ``overlap_ratio`` (dispatch->wait compute hidden under flying
    collectives, per rank-second) separates an overlap-heavy job — whose
    in-barrier time is busy compute that converts watts to progress —
    from a slack-heavy one whose watts are stranded.  Telemetry today:
    ``exploited_ratio`` already excludes overlap (the governor never books
    it as slack), so allocation is overlap-honest; the explicit ratio
    lets operators and future policies see the split directly.
    """

    job_id: str
    power_w: float
    exploited_ratio: float
    done: bool = False
    overlap_ratio: float = 0.0
    # serving health (zero for non-serving tenants): the arbiter allocates
    # on slack alone, but the dashboard and the fleet autoscaler read SLO
    # attainment and prefix reuse off the same sample stream
    ttft_p50: float = 0.0
    ttft_p99: float = 0.0
    tpot_p50: float = 0.0
    tpot_p99: float = 0.0
    prefix_hits: int = 0
    prefix_lookups: int = 0
    prefix_hit_rate: float = 0.0


@dataclass
class PowerBudgetArbiter:
    cap_w: float
    floor_w: float
    target_ratio: float = 0.10        # slack ratio above which watts move away
    beta: float = 0.5                 # multiplicative-decrease factor
    alpha_w: float = 25.0             # additive-increase step (W/job/epoch)
    alloc: Dict[str, float] = field(default_factory=dict)
    history: List[Dict[str, float]] = field(default_factory=list)
    # observability hook: called with the new grants at the end of every
    # step (epoch index, {job: watts}) — the tracer/registry wire here
    grant_hook: Optional[Callable[[int, Dict[str, float]], None]] = None

    def allocations(self) -> Dict[str, float]:
        return dict(self.alloc)

    def export_metrics(self, registry) -> None:
        """Publish the current grants into a :class:`repro_torch.obs.metrics.
        MetricsRegistry`: ``arbiter_grant_watts{job=...}`` plus the fixed
        cluster cap and the unallocated pool."""
        grants = registry.gauge("arbiter_grant_watts",
                                "watts granted per job", ("job",))
        for job, w in self.alloc.items():
            grants.labels(job).set(w)
        registry.gauge("arbiter_cap_watts", "cluster cap").set(self.cap_w)
        registry.gauge("arbiter_pool_watts", "unallocated watts").set(
            self.cap_w - sum(self.alloc.values()))
        registry.counter("arbiter_epochs_total", "arbitration epochs").labels() \
            .set(float(len(self.history)))

    def step(self, samples: List[JobSample]) -> Dict[str, float]:
        """One arbitration epoch: consume telemetry, return new caps."""
        active = [s for s in samples if not s.done]
        ids = [s.job_id for s in active]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate job ids in samples: {ids}")
        if len(active) * self.floor_w > self.cap_w + _EPS:
            raise ValueError(
                f"{len(active)} jobs x floor {self.floor_w} W exceeds "
                f"cluster cap {self.cap_w} W"
            )
        # departures free their watts; arrivals enter at the floor
        self.alloc = {j: self.alloc.get(j, self.floor_w) for j in ids}
        if not self.alloc:
            self.history.append({})
            if self.grant_hook is not None:
                self.grant_hook(len(self.history) - 1, {})
            return {}

        # multiplicative decrease: slack-rich jobs release headroom
        by_id = {s.job_id: s for s in active}
        for j in ids:
            if by_id[j].exploited_ratio > self.target_ratio:
                self.alloc[j] = self.floor_w + self.beta * (self.alloc[j] - self.floor_w)

        # additive increase from the freed pool, weighted by slack deficit
        pool = self.cap_w - sum(self.alloc.values())
        needy = [j for j in ids if by_id[j].exploited_ratio <= self.target_ratio]
        if pool > _EPS and needy:
            weights = {
                j: (self.target_ratio - by_id[j].exploited_ratio) + _EPS for j in needy
            }
            w_sum = sum(weights.values())
            for j in needy:
                give = min(self.alpha_w, pool * weights[j] / w_sum)
                self.alloc[j] += give

        # float-safety normalization: scale headroom above the floors down
        # if rounding pushed the sum past the cap (invariant, not policy)
        total = sum(self.alloc.values())
        if total > self.cap_w:
            head = total - len(ids) * self.floor_w
            budget = self.cap_w - len(ids) * self.floor_w
            scale = 0.0 if head <= _EPS else max(budget, 0.0) / head
            self.alloc = {
                j: self.floor_w + (a - self.floor_w) * scale for j, a in self.alloc.items()
            }

        self.history.append(dict(self.alloc))
        if self.grant_hook is not None:
            self.grant_hook(len(self.history) - 1, dict(self.alloc))
        return dict(self.alloc)


@dataclass
class StaticEqualSplit:
    """The baseline discipline: cap / n_jobs forever, no redistribution.

    Same ``step`` interface as :class:`PowerBudgetArbiter` so the
    co-schedule driver and benchmark can swap them.
    """

    cap_w: float
    floor_w: float = 0.0
    alloc: Dict[str, float] = field(default_factory=dict)
    history: List[Dict[str, float]] = field(default_factory=list)
    _n_initial: int = 0

    def step(self, samples: List[JobSample]) -> Dict[str, float]:
        active = [s for s in samples if not s.done]
        if self._n_initial == 0:
            self._n_initial = max(len(active), 1)
        # watts of finished jobs stay stranded: that is the point of static
        self.alloc = {s.job_id: self.cap_w / self._n_initial for s in active}
        self.history.append(dict(self.alloc))
        return dict(self.alloc)
