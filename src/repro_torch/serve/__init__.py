"""``repro_torch.serve`` — continuous-batching serving, ported from ``repro.serve``.

``kvcache``    paged KV pool (host accounting copied, device blocks as
               tensors), the paged single-token decode attention and the
               copy-on-write page clone for prefix sharing.
``scheduler``  copied: arrival queue, page-bounded admission, Poisson traces.
``slack``      copied: decode underfill and idle gaps as governor phases.
``slo``        copied: TTFT/TPOT percentiles and the concurrency cap.
``engine``     :class:`ContinuousEngine` (with prefix-cache joins, the
               tracer's join/evict instants and the serving loop's spans),
               :class:`EngineSession` and
               the legacy :class:`ServeEngine` and :func:`make_serve_steps`.
``fleet``      copied: multi-replica serving, the prefix-cache-aware
               router, SLO autoscaler, watt arbitration, scenarios, the
               deterministic fleet simulator and the real-engine fleet.

Exports resolve lazily (PEP 562), as the reference's do: importing
``repro_torch.serve`` loads no submodule until a symbol is touched, and
``dir()`` lists everything importable, symbols and submodules.
"""
import importlib

# symbol -> defining submodule (the lazy-import table; every name here is
# importable as `from repro_torch.serve import <name>`).
_EXPORTS = {
    "ContinuousEngine": "repro_torch.serve.engine",
    "EngineSession": "repro_torch.serve.engine",
    "ServeEngine": "repro_torch.serve.engine",
    "make_serve_steps": "repro_torch.serve.engine",
    "PagedKVPool": "repro_torch.serve.kvcache",
    "Request": "repro_torch.serve.scheduler",
    "Scheduler": "repro_torch.serve.scheduler",
    "poisson_arrivals": "repro_torch.serve.scheduler",
    "DecodeSlackMeter": "repro_torch.serve.slack",
    "SLOTracker": "repro_torch.serve.slo",
    # fleet layer
    "Autoscaler": "repro_torch.serve.fleet.autoscaler",
    "FleetConfig": "repro_torch.serve.fleet.fleet",
    "FleetResult": "repro_torch.serve.fleet.fleet",
    "FleetSim": "repro_torch.serve.fleet.fleet",
    "run_engine_fleet": "repro_torch.serve.fleet.fleet",
    "PrefixCache": "repro_torch.serve.fleet.prefix",
    "PrefixMatch": "repro_torch.serve.fleet.prefix",
    "SimReplica": "repro_torch.serve.fleet.replica",
    "FleetRouter": "repro_torch.serve.fleet.router",
    "ReplicaView": "repro_torch.serve.fleet.router",
    "FleetTrace": "repro_torch.serve.fleet.scenarios",
    "diurnal_trace": "repro_torch.serve.fleet.scenarios",
    "flash_crowd_trace": "repro_torch.serve.fleet.scenarios",
    "session_reuse_trace": "repro_torch.serve.fleet.scenarios",
}

_SUBMODULES = ("engine", "fleet", "kvcache", "scheduler", "slack", "slo")

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is not None:
        value = getattr(importlib.import_module(target), name)
        globals()[name] = value               # cache: resolve once
        return value
    if name in _SUBMODULES:
        module = importlib.import_module(f"repro_torch.serve.{name}")
        globals()[name] = module
        return module
    raise AttributeError(f"module 'repro_torch.serve' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS) | set(_SUBMODULES))
