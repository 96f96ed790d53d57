"""repro_torch.serve.fleet — multi-replica serving under one watt cap.

Prefix-cache-aware routing (:mod:`router`, :mod:`prefix`), SLO-driven
autoscaling (:mod:`autoscaler`), deterministic virtual-clock fleet
simulation plus a real-engine driver (:mod:`fleet`, :mod:`replica`), and
the arrival scenarios that exercise them (:mod:`scenarios`).
"""
from repro_torch.serve.fleet.autoscaler import Autoscaler, ScaleDecision
from repro_torch.serve.fleet.fleet import (
    FleetConfig,
    FleetResult,
    FleetSim,
    run_engine_fleet,
    session_view,
)
from repro_torch.serve.fleet.prefix import PrefixCache, PrefixMatch
from repro_torch.serve.fleet.replica import SimReplica
from repro_torch.serve.fleet.router import FleetRouter, ReplicaView, RouteDecision
from repro_torch.serve.fleet.scenarios import (
    FleetTrace,
    diurnal_trace,
    flash_crowd_trace,
    session_reuse_trace,
)

__all__ = [
    "Autoscaler",
    "ScaleDecision",
    "FleetConfig",
    "FleetResult",
    "FleetSim",
    "run_engine_fleet",
    "session_view",
    "PrefixCache",
    "PrefixMatch",
    "SimReplica",
    "FleetRouter",
    "ReplicaView",
    "RouteDecision",
    "FleetTrace",
    "diurnal_trace",
    "flash_crowd_trace",
    "session_reuse_trace",
]
