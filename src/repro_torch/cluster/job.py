"""Power-managed tenants: one report interface over train, serve, and sim.

The arbiter does not care whether a tenant is an instrumented training
job (collective phase events through ``Governor.sink``), a continuous-
batching serve engine (decode underfill through ``ingest_phase``), or a
discrete-event simulation — it needs one epoch-granular contract:

    report = job.run_epoch(cap_w)       # run/observe one epoch under cap
    sample = job.last_sample()          # -> arbiter.JobSample

``exploited_ratio`` is normalized identically everywhere — exploited
f_min time over *total rank-time* (``n_ranks * epoch_wall``) — so a
compute-bound job whose tiny comm happens to be all-slack does not
masquerade as slack-rich.

Every tenant owns a :class:`~repro_torch.cluster.power.PowerCapActuator`; the
arbiter's cap lands through ``actuator.request`` so enforcement latency
and hysteresis apply before the job sees the new budget (live tenants
log the commit exactly like the governor logs P-state writes).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

from repro_torch.cluster.arbiter import JobSample
from repro_torch.cluster.power import PowerCapActuator
from repro_torch.core.governor import Governor
from repro_torch.core.policies import COUNTDOWN_SLACK, Policy
from repro_torch.core.pstate import DEFAULT_HW, HwModel
from repro_torch.core.simulator import Workload, simulate


@dataclass
class EpochReport:
    """What one tenant did during one arbitration epoch."""

    job_id: str
    epoch: int
    cap_w: float                 # cap in force (post-actuator)
    wall_s: float                # epoch duration for this tenant
    energy_j: float
    power_w: float               # energy_j / wall_s
    exploited_ratio: float       # f_min time / (n_ranks * wall_s)
    n_calls: int
    done: bool
    overlap_ratio: float = 0.0   # dispatch->wait overlap / (n_ranks * wall_s)


class ManagedJob:
    """Base tenant: cap plumbing + sample bookkeeping; subclasses run."""

    def __init__(self, job_id: str, n_ranks: int, cap_w: float,
                 hw: HwModel = DEFAULT_HW, floor_w: float = 0.0):
        self.job_id = job_id
        self.n_ranks = n_ranks
        self.hw = hw
        self.actuator = PowerCapActuator(cap_w, latency=hw.switch_latency,
                                         floor_w=floor_w)
        self.reports: List[EpochReport] = []
        self.total_energy_j = 0.0
        self.total_wall_s = 0.0
        self._obs = None                 # (gauges dict, tracer) once attached

    def attach_obs(self, registry, tracer=None, clock=None) -> None:
        """Publish every booked epoch into a :class:`repro_torch.obs.metrics.
        MetricsRegistry` (``job_*{job=...}`` series) and, when a
        :class:`repro_torch.obs.tracer.SpanTracer` is given, sample cap/power
        counter tracks on its ``arbiter`` track.

        ``clock`` sets the trace time base: live tenants pass
        ``time.monotonic`` so arbiter samples line up with the bus's phase
        events; the default (tenant wall clock) is right for simulated
        tenants, whose events live on their own clock anyway."""
        jid = self.job_id
        gauges = {
            "cap": registry.gauge("job_cap_watts",
                                  "cap in force (post-actuator)",
                                  ("job",)).labels(jid),
            "power": registry.gauge("job_power_watts",
                                    "epoch average draw", ("job",)).labels(jid),
            "exploited": registry.gauge("job_exploited_ratio",
                                        "f_min time per rank-second",
                                        ("job",)).labels(jid),
            "overlap": registry.gauge("job_overlap_ratio",
                                      "dispatch->wait overlap per rank-second",
                                      ("job",)).labels(jid),
            "energy": registry.counter("job_energy_joules_total",
                                       "energy booked across epochs",
                                       ("job",)).labels(jid),
            "epochs": registry.counter("job_epochs_total",
                                       "arbitration epochs booked",
                                       ("job",)).labels(jid),
        }
        self._obs = (gauges, tracer, clock)

    def _book(self, rep: EpochReport) -> EpochReport:
        self.reports.append(rep)
        self.total_energy_j += rep.energy_j
        self.total_wall_s += rep.wall_s
        if self._obs is not None:
            gauges, tracer, clock = self._obs
            gauges["cap"].set(rep.cap_w)
            gauges["power"].set(rep.power_w)
            gauges["exploited"].set(rep.exploited_ratio)
            gauges["overlap"].set(rep.overlap_ratio)
            gauges["energy"].inc(rep.energy_j)
            gauges["epochs"].inc()
            if tracer is not None:
                t = clock() if clock is not None else self.total_wall_s
                tracer.sample("arbiter", f"cap_w[{self.job_id}]", t, rep.cap_w)
                tracer.sample("arbiter", f"power_w[{self.job_id}]", t,
                              rep.power_w)
        return rep

    @property
    def done(self) -> bool:
        return bool(self.reports) and self.reports[-1].done

    def last_sample(self) -> JobSample:
        if not self.reports:
            return JobSample(self.job_id, 0.0, 0.0)
        r = self.reports[-1]
        return JobSample(self.job_id, r.power_w, r.exploited_ratio, done=r.done,
                         overlap_ratio=r.overlap_ratio)

    def run_epoch(self, cap_w: float) -> EpochReport:
        raise NotImplementedError


class SimJob(ManagedJob):
    """Simulator-backed tenant: consumes its workload in task chunks, each
    chunk simulated under the enforced cap (``simulate(power_cap=...)``).
    The co-schedule driver and ``benchmarks/bench_cluster.py`` run on
    these."""

    def __init__(self, job_id: str, workload: Workload,
                 policy: Policy = COUNTDOWN_SLACK, hw: HwModel = DEFAULT_HW,
                 tasks_per_epoch: int = 50, cap_w: Optional[float] = None,
                 floor_w: float = 0.0):
        full = workload.n_ranks * hw.watts_at_fmax
        super().__init__(job_id, workload.n_ranks,
                         cap_w if cap_w is not None else full, hw, floor_w)
        self.workload = workload
        self.policy = policy
        self.tasks_per_epoch = tasks_per_epoch
        self._cursor = 0
        self._t = 0.0                       # this tenant's own clock

    def _chunk(self, k0: int, k1: int) -> Workload:
        wl = self.workload
        return Workload(
            name=f"{wl.name}[{k0}:{k1}]", n_ranks=wl.n_ranks,
            comp=wl.comp[k0:k1], copy=wl.copy[k0:k1], is_p2p=wl.is_p2p[k0:k1],
            partner=wl.partner[k0:k1], site=wl.site[k0:k1],
            nbytes=wl.nbytes[k0:k1], beta_comp=wl.beta_comp,
            beta_copy=wl.beta_copy,
            copy_jitter=None if wl.copy_jitter is None else wl.copy_jitter[k0:k1],
        )

    def run_epoch(self, cap_w: float) -> EpochReport:
        self.actuator.request(self._t, cap_w)
        cap = self.actuator.cap_at(self._t + self.actuator.latency)
        k0 = self._cursor
        k1 = min(k0 + self.tasks_per_epoch, self.workload.n_tasks)
        self._cursor = k1
        res, _ = simulate(self._chunk(k0, k1), self.policy, self.hw,
                          power_cap=cap)
        self._t += res.time
        rank_s = max(self.n_ranks * res.time, 1e-30)
        return self._book(EpochReport(
            job_id=self.job_id, epoch=len(self.reports), cap_w=cap,
            wall_s=res.time, energy_j=res.energy,
            power_w=res.energy / max(res.time, 1e-30),
            exploited_ratio=res.exploited / rank_s, n_calls=res.calls,
            done=self._cursor >= self.workload.n_tasks,
            overlap_ratio=res.toverlap / rank_s,
        ))


class GovernorJob(ManagedJob):
    """Live tenant over a :class:`Governor` — the train loop's collective
    events or any ``ingest_phase`` producer.  ``run_epoch`` does not drive
    the job (the loop runs elsewhere); it polls the governor's interval
    snapshot, so call it on the arbiter's cadence.

    The governor only *sees* instrumented phases, so epoch power is
    modeled, not measured: every rank draws compute power at f_max except
    during exploited slack, which draws f_min slack power — the same
    accounting ``finalize()`` applies inside phases, extended to the
    epoch.
    """

    def __init__(self, job_id: str, governor: Governor, n_ranks: int,
                 cap_w: float, hw: HwModel = DEFAULT_HW, floor_w: float = 0.0):
        super().__init__(job_id, n_ranks, cap_w, hw, floor_w)
        self.governor = governor
        self._t0 = time.monotonic()
        self._t_prev = self._t0
        self.finished = False            # owner flips when the loop exits

    def run_epoch(self, cap_w: float, stats=None) -> EpochReport:
        """Book one epoch.  ``stats`` (an :class:`~repro_torch.core.governor.
        IntervalStats`) lets a caller that already polls the governor —
        e.g. a :class:`repro_torch.obs.metrics.GovernorCollector` on the same
        cadence — hand its poll over instead of double-polling: the
        governor keeps a single snapshot mark, so two independent pollers
        would each see only half the interval stream."""
        now = time.monotonic()
        self.actuator.request(now - self._t0, cap_w)
        cap = self.actuator.cap_at(now - self._t0 + self.actuator.latency)
        dt = max(now - self._t_prev, 1e-9)
        self._t_prev = now
        if stats is None:
            stats = self.governor.interval_snapshot()
        hw = self.hw
        rank_s = self.n_ranks * dt
        exploited = min(stats.exploited, rank_s)
        energy = (
            hw.watts(hw.f_max, hw.act_comp) * (rank_s - exploited)
            + hw.watts(hw.f_min, hw.act_slack) * exploited
        )
        return self._book(EpochReport(
            job_id=self.job_id, epoch=len(self.reports), cap_w=cap,
            wall_s=dt, energy_j=float(energy),
            power_w=float(energy) / dt,
            exploited_ratio=exploited / rank_s, n_calls=stats.n_calls,
            done=self.finished,
            # IntervalStats now carries the overlap term instead of
            # discarding it: overlap-heavy != slack-heavy to the arbiter
            overlap_ratio=min(stats.overlap, rank_s) / rank_s,
        ))


class ServeJob(GovernorJob):
    """:class:`repro_torch.serve.ContinuousEngine` as a tenant: the engine's
    :class:`DecodeSlackMeter` already books underfill/idle into the
    governor, so the snapshot path is identical; the engine is kept (duck-
    typed, no serve import) to surface decode fill in the report stream.

    Given an :class:`~repro_torch.serve.slo.SLOTracker`, ``last_sample``
    additionally carries TTFT/TPOT percentiles and — when the engine has a
    prefix cache attached — prefix-hit counters, so the arbiter's sample
    stream shows serving *health*, not just watts and slack.
    """

    def __init__(self, job_id: str, engine, governor: Governor,
                 cap_w: float, n_ranks: int = 1,
                 hw: HwModel = DEFAULT_HW, floor_w: float = 0.0,
                 slo=None):
        super().__init__(job_id, governor, n_ranks, cap_w, hw, floor_w)
        self.engine = engine
        self.slo = slo

    @property
    def fill_fraction(self) -> float:
        meter = getattr(self.engine, "_last_meter", None)
        return meter.fill_fraction if meter is not None else 1.0

    def last_sample(self) -> JobSample:
        sample = super().last_sample()
        if self.slo is not None:
            s = self.slo.summary()
            sample.ttft_p50 = s["ttft"]["p50"]
            sample.ttft_p99 = s["ttft"]["p99"]
            sample.tpot_p50 = s["tpot"]["p50"]
            sample.tpot_p99 = s["tpot"]["p99"]
        cache = getattr(self.engine, "prefix_cache", None)
        if cache is not None:
            sample.prefix_hits = cache.n_hits
            sample.prefix_lookups = cache.n_lookups
            sample.prefix_hit_rate = cache.hit_rate
        return sample
