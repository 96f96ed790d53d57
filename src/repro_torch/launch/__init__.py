"""``repro_torch.launch`` — runnable drivers (each is a ``python -m`` entry point).

``train``      training: the 2-D sharded step over the ranks' mesh,
               checkpoint/restart and recovery from injected rank failures
               over a rebuilt group and mesh.
``serve``      serving driver: legacy static batch or continuous batching
               with paged KV, Poisson arrivals, and governor-priced slack,
               tensor-parallel over torchrun's ranks.
``mesh``       production/host ``DeviceMesh`` constructors.
``dryrun``     every (arch x shape x mesh) cell counted on ``meta``
               tensors over a fake 256/512-rank world: per-rank memory,
               FLOPs, traffic and collectives.
``long_join``  one long prompt's join timed through the kernels and plain.

Submodules load lazily (PEP 562), as the reference's do, so that
``import repro_torch.launch`` stays cheap for tooling.
"""
import importlib

_SUBMODULES = ("dryrun", "long_join", "mesh", "serve", "train")

__all__ = list(_SUBMODULES)


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"repro_torch.launch.{name}")
    raise AttributeError(f"module 'repro_torch.launch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_SUBMODULES))
