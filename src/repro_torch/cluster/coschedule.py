"""Multi-job co-scheduling scenarios over the discrete-event simulator.

Evaluates the arbiter on heterogeneous mixes without a cluster: each
tenant is a :class:`~repro_torch.cluster.job.SimJob` on its own nodes (jobs run
concurrently, so cluster makespan is the slowest tenant and cluster
energy is the sum), the arbiter re-splits the shared cap once per epoch.

Three canonical tenant flavors (the mixes the paper's story spans):

* ``compute_bound`` — EP-like: frequency-sensitive (high beta), almost no
  slack.  Every watt above its floor is progress; capping it costs
  makespan 1:1.
* ``comm_bound``    — FT/LU-like: low beta, large emergent slack.  Watts
  above the floor are mostly stranded in busy-waiting.
* ``bursty_serve``  — decode-shaped: low beta with heavy-tailed task
  scales (bursts + underfill lulls), the simulator-space image of the
  serve engine's idle/underfill profile.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.cluster.arbiter import PowerBudgetArbiter, StaticEqualSplit
from repro_torch.cluster.job import EpochReport, SimJob
from repro_torch.core.policies import COUNTDOWN_SLACK, Policy
from repro_torch.core.pstate import DEFAULT_HW, HwModel
from repro_torch.core.workloads import AppSpec, generate

# scenario specs: calibrated generators, scaled to co-scheduling size
MIX_SPECS: Dict[str, AppSpec] = {
    "compute_bound": AppSpec(
        "compute_bound", 8, 400, comp_mean=30e-3, slack_mean=0.4e-3,
        copy_mean=0.3e-3, beta_comp=0.95, beta_copy=0.15,
        sigma_noise=0.08, sigma_rank=0.03, sigma_task=0.10, n_sites=6,
    ),
    "comm_bound": AppSpec(
        "comm_bound", 8, 400, comp_mean=18e-3, slack_mean=9e-3,
        copy_mean=6e-3, beta_comp=0.15, beta_copy=0.10,
        sigma_noise=0.45, sigma_rank=0.20, sigma_task=0.5, n_sites=10,
    ),
    "bursty_serve": AppSpec(
        "bursty_serve", 8, 400, comp_mean=12e-3, slack_mean=14e-3,
        copy_mean=2e-3, beta_comp=0.15, beta_copy=0.10,
        sigma_noise=0.70, sigma_rank=0.10, sigma_task=1.2, site_sigma=1.5,
        n_sites=8,
    ),
}


def make_job(kind: str, job_id: Optional[str] = None, seed: int = 0,
             policy: Policy = COUNTDOWN_SLACK, hw: HwModel = DEFAULT_HW,
             tasks_per_epoch: int = 40, floor_w: float = 0.0,
             n_tasks: Optional[int] = None) -> SimJob:
    """One simulated tenant of the named flavor (see ``MIX_SPECS``)."""
    spec = MIX_SPECS[kind]
    if n_tasks is not None:
        spec = dataclasses.replace(spec, n_tasks=n_tasks)
    wl = generate(spec, seed=seed, hw=hw)
    return SimJob(job_id or kind, wl, policy=policy, hw=hw,
                  tasks_per_epoch=tasks_per_epoch, floor_w=floor_w)


@dataclass
class CoScheduleResult:
    """What a mix did under one arbitration discipline."""

    discipline: str
    cap_w: float
    makespan_s: float                 # slowest tenant (jobs run concurrently)
    energy_j: float                   # summed over tenants
    per_job: Dict[str, Dict[str, float]]
    allocations: List[Dict[str, float]] = field(default_factory=list)
    reports: Dict[str, List[EpochReport]] = field(default_factory=dict)

    def summary(self) -> Dict[str, object]:
        return {
            "discipline": self.discipline,
            "cap_w": self.cap_w,
            "makespan_s": self.makespan_s,
            "energy_j": self.energy_j,
            "per_job": self.per_job,
            "n_epochs": len(self.allocations),
        }


def run_coschedule(
    jobs: List[SimJob],
    cap_w: float,
    arbiter=None,
    max_epochs: int = 10_000,
    on_epoch: Optional[Callable[[int, Dict[str, float]], None]] = None,
) -> CoScheduleResult:
    """Drive a mix of tenants to completion under a shared cap.

    ``arbiter`` is anything with the ``step(samples) -> {job: watts}``
    contract — :class:`PowerBudgetArbiter` (default) or
    :class:`StaticEqualSplit` for the baseline discipline.  Each epoch
    every unfinished tenant runs one chunk under its current cap, then the
    arbiter re-splits based on the fresh samples.
    """
    if arbiter is None:
        arbiter = PowerBudgetArbiter(cap_w=cap_w, floor_w=0.0)
    alloc = arbiter.step([j.last_sample() for j in jobs])
    for epoch in range(max_epochs):
        running = [j for j in jobs if not j.done]
        if not running:
            break
        for job in running:
            job.run_epoch(alloc.get(job.job_id, 0.0))
        alloc = arbiter.step([j.last_sample() for j in jobs])
        if on_epoch is not None:
            on_epoch(epoch, alloc)
    else:
        raise RuntimeError(f"mix did not finish within {max_epochs} epochs")

    per_job = {
        j.job_id: {
            "wall_s": j.total_wall_s,
            "energy_j": j.total_energy_j,
            "mean_power_w": j.total_energy_j / max(j.total_wall_s, 1e-30),
            "n_epochs": len(j.reports),
            "cap_commits": len(j.actuator.commits),
            "cap_suppressed": j.actuator.n_suppressed,
        }
        for j in jobs
    }
    return CoScheduleResult(
        discipline=type(arbiter).__name__,
        cap_w=cap_w,
        makespan_s=max(j.total_wall_s for j in jobs),
        energy_j=sum(j.total_energy_j for j in jobs),
        per_job=per_job,
        allocations=list(getattr(arbiter, "history", [])),
        reports={j.job_id: j.reports for j in jobs},
    )


def compare_disciplines(
    job_factory: Callable[[], List[SimJob]],
    cap_w: float,
    floor_w: float = 0.0,
    **arbiter_kw,
) -> Dict[str, CoScheduleResult]:
    """Run the same mix under static equal-split and the slack arbiter.

    ``job_factory`` must build fresh tenants per call (they are stateful).
    """
    static = run_coschedule(
        job_factory(), cap_w, arbiter=StaticEqualSplit(cap_w=cap_w, floor_w=floor_w)
    )
    arbited = run_coschedule(
        job_factory(), cap_w,
        arbiter=PowerBudgetArbiter(cap_w=cap_w, floor_w=floor_w, **arbiter_kw),
    )
    return {"static": static, "arbiter": arbited}
