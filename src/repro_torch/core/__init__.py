"""COUNTDOWN Slack core, ported: the paper's contribution on PyTorch.

The same public surface as the reference's ``core``: the :class:`Governor`
pipeline, the instrument-mode helpers (``cd_*`` collectives over
``torch.distributed``, ambient mode switches, event sink/tee), the
calibrated :class:`HwModel`, the policy table, and the simulator entry
points.  Symbols resolve lazily (PEP 562) so ``import repro_torch.core``
stays cheap for tooling: ``instrument`` in particular pulls in torch.
"""
import importlib

_EXPORTS = {
    # canonical event vocabulary + bus (pure python, torch-free)
    "EventBus": "repro_torch.core.events",
    "PHASE_NAMES": "repro_torch.core.events",
    "PhaseEvent": "repro_torch.core.events",
    "PhaseRecord": "repro_torch.core.events",
    # governor pipeline
    "Actuation": "repro_torch.core.governor",
    "Governor": "repro_torch.core.governor",
    "GovernorReport": "repro_torch.core.governor",
    "IntervalStats": "repro_torch.core.governor",
    # instrument mode helpers (torch-bearing; loaded on first touch)
    "AsyncCollective": "repro_torch.core.instrument",
    "get_event_bus": "repro_torch.core.instrument",
    "cd_all_gather": "repro_torch.core.instrument",
    "cd_all_gather_async": "repro_torch.core.instrument",
    "cd_pmean": "repro_torch.core.instrument",
    "cd_ppermute": "repro_torch.core.instrument",
    "cd_psum": "repro_torch.core.instrument",
    "cd_psum_async": "repro_torch.core.instrument",
    "cd_wait": "repro_torch.core.instrument",
    "enable_events": "repro_torch.core.instrument",
    "get_mode": "repro_torch.core.instrument",
    "reset_instrumentation": "repro_torch.core.instrument",
    "set_event_sink": "repro_torch.core.instrument",
    "set_event_tee": "repro_torch.core.instrument",
    "set_mode": "repro_torch.core.instrument",
    # theta auto-tuning
    "ThetaDecision": "repro_torch.core.timeout",
    "ThetaTuner": "repro_torch.core.timeout",
    # hardware / power model
    "DEFAULT_HW": "repro_torch.core.pstate",
    "HwModel": "repro_torch.core.pstate",
    # policies
    "ALL_POLICIES": "repro_torch.core.policies",
    "BASELINE": "repro_torch.core.policies",
    "CNTD_ADAPTIVE": "repro_torch.core.policies",
    "COUNTDOWN": "repro_torch.core.policies",
    "COUNTDOWN_SLACK": "repro_torch.core.policies",
    "FIXED_POLICIES": "repro_torch.core.policies",
    "MINFREQ": "repro_torch.core.policies",
    "Policy": "repro_torch.core.policies",
    # simulator entry points
    "SimResult": "repro_torch.core.simulator",
    "TraceRecord": "repro_torch.core.simulator",
    "Workload": "repro_torch.core.simulator",
    "coverage_on_trace": "repro_torch.core.simulator",
    "simulate": "repro_torch.core.simulator",
    # calibrated workload generators
    "APPS": "repro_torch.core.workloads",
    "generate": "repro_torch.core.workloads",
    "make_all": "repro_torch.core.workloads",
}

_SUBMODULES = (
    "events", "governor", "instrument", "policies", "predictor", "profiler",
    "pstate", "simulator", "timeout", "workloads",
)

__all__ = sorted(_EXPORTS) + list(_SUBMODULES)


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    if name in _SUBMODULES:
        return importlib.import_module(f"repro_torch.core.{name}")
    raise AttributeError(f"module 'repro_torch.core' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
