"""``repro_torch.cluster`` — the power-budget layer above per-job governors.

The paper prices slack *within* one job; this package prices it *between*
jobs sharing a facility cap (DESIGN.md §7):

``power``      node/rack roll-ups of per-rank power series and the
               RAPL-style :class:`PowerCapActuator` (enforcement latency
               + the pstate theta/hysteresis discipline).
``arbiter``    :class:`PowerBudgetArbiter` — AIMD watt redistribution
               under a fixed cluster cap, driven by per-job exploited-
               slack ratios; :class:`StaticEqualSplit` baseline.
``trace``      versioned JSONL :class:`TraceRecorder` for the governor's
               event stream; ``replay()`` reproduces a live run's report
               bit-for-bit, ``what_if()`` re-runs the measured phases
               through ``core.simulator`` under a different policy/cap.
``job``        :class:`ManagedJob` tenants: simulated (``SimJob``), live
               train (``GovernorJob``), live serve (``ServeJob``) — one
               slack/power report interface for the arbiter.
``coschedule`` heterogeneous multi-job scenario driver + canonical
               compute-bound / comm-bound / bursty-serve mixes.
"""
from repro_torch.cluster.arbiter import JobSample, PowerBudgetArbiter, StaticEqualSplit  # noqa: F401
from repro_torch.cluster.coschedule import (  # noqa: F401
    MIX_SPECS,
    CoScheduleResult,
    compare_disciplines,
    make_job,
    run_coschedule,
)
from repro_torch.cluster.job import EpochReport, GovernorJob, ManagedJob, ServeJob, SimJob  # noqa: F401
from repro_torch.cluster.power import (  # noqa: F401
    CapCommit,
    PowerCapActuator,
    aggregate_power,
    node_power_series,
    rack_power_series,
)
from repro_torch.cluster.trace import (  # noqa: F401
    TRACE_VERSION,
    TraceRecorder,
    load,
    replay,
    to_workload,
    what_if,
)

__all__ = [
    "CapCommit",
    "CoScheduleResult",
    "EpochReport",
    "GovernorJob",
    "JobSample",
    "MIX_SPECS",
    "ManagedJob",
    "PowerBudgetArbiter",
    "PowerCapActuator",
    "ServeJob",
    "SimJob",
    "StaticEqualSplit",
    "TRACE_VERSION",
    "TraceRecorder",
    "aggregate_power",
    "compare_disciplines",
    "load",
    "make_job",
    "node_power_series",
    "rack_power_series",
    "replay",
    "run_coschedule",
    "to_workload",
    "what_if",
]
