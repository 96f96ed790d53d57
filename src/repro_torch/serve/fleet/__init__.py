"""Copied from ``repro.serve.fleet``: so far only the per-replica prefix
cache (:mod:`prefix`: :class:`PrefixCache`, :class:`PrefixMatch`), which
:meth:`repro_torch.serve.engine.ContinuousEngine.enable_prefix_cache`
attaches to one engine's pool.  The rest of the fleet (the router, the
replicas, the autoscaler, the arrival scenarios and the fleet drivers) is
the next slice (ROADMAP.md, queue 1)."""
from repro_torch.serve.fleet.prefix import PrefixCache, PrefixMatch

__all__ = ["PrefixCache", "PrefixMatch"]
