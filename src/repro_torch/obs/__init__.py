"""repro_torch.obs — unified telemetry: metrics registry, Perfetto span tracing,
exporters/dashboards, and the structured driver logger.

Submodules are imported lazily (PEP 562) so that pulling one cheap piece
(``repro_torch.obs.log`` in a driver, say) does not pay for the rest.
"""
from __future__ import annotations

_EXPORTS = {
    "MetricsRegistry": ("repro_torch.obs.metrics", "MetricsRegistry"),
    "BusMetrics": ("repro_torch.obs.metrics", "BusMetrics"),
    "GovernorCollector": ("repro_torch.obs.metrics", "GovernorCollector"),
    "DEFAULT_EDGES": ("repro_torch.obs.metrics", "DEFAULT_EDGES"),
    "SpanTracer": ("repro_torch.obs.tracer", "SpanTracer"),
    "GovernorTap": ("repro_torch.obs.tracer", "GovernorTap"),
    "RecorderFanout": ("repro_torch.obs.tracer", "RecorderFanout"),
    "validate_trace": ("repro_torch.obs.tracer", "validate_trace"),
    "MetricsJsonlWriter": ("repro_torch.obs.export", "MetricsJsonlWriter"),
    "validate_metrics_jsonl": ("repro_torch.obs.export", "validate_metrics_jsonl"),
    "prometheus_text": ("repro_torch.obs.export", "prometheus_text"),
    "ConsoleDashboard": ("repro_torch.obs.export", "ConsoleDashboard"),
    "get_logger": ("repro_torch.obs.log", "get_logger"),
    "configure": ("repro_torch.obs.log", "configure"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        mod_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod_name), attr)


def __dir__():
    return sorted(set(globals()) | set(__all__))
