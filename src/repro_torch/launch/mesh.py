"""Mesh factories, ported from ``repro.launch.mesh``.

Both are FUNCTIONS (not module-level constants): importing this module
touches no process group.  Each builds a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group's ranks, which must exist; the device type follows the group's
backend (``cuda`` under NCCL, ``cpu`` otherwise).
"""
from __future__ import annotations

import torch.distributed as dist


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production target: 16x16 (256 ranks) per pod
    ``("data", "model")``; with ``multi_pod`` 2 pods, ``("pod", "data",
    "model")`` (512 ranks).  Raises unless the world has that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks; "
                         f"the world has {world}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(model_parallel: int = 1, pods: int = 1):
    """A small mesh over the world's ranks: the largest model-parallel
    degree <= ``model_parallel`` that divides the world, and with ``pods``
    a leading pod axis when the rest divides."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    mp = max(g for g in range(1, model_parallel + 1) if n % g == 0)
    rest = n // mp
    if pods > 1 and rest % pods == 0:
        return init_device_mesh(_device_type(), (pods, rest // pods, mp),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(_device_type(), (rest, mp), mesh_dim_names=("data", "model"))
