"""Elastic rank set + deterministic failure injection, ported from
``repro.dist.elastic``.

The recovery model is the reference's *mesh epochs* (see launch/train.py):
training runs over one process group until a rank fails; the launcher then
drains in-flight work, marks the rank failed on the :class:`ElasticMesh`,
restores the latest checkpoint, rebuilds a (smaller) group from the
survivors and resumes.  Where the reference lays ``jax.devices()`` out as a
mesh, the port lays out the ranks of the default process group, one device
a rank, and builds the survivors' ``DeviceMesh`` over them, on which the
launcher shards the restored state (:mod:`repro_torch.dist.sharding`).

Rebuilding the group calls ``torch.distributed.new_group``, and building
the mesh makes its groups; every rank of the default group calls both, the
failed rank included (an exit before would leave the survivors waiting).
The failed rank's mesh holds no coordinate for it (``get_coordinate()`` is
None) and it takes no part in the mesh's collectives; after the rebuild it
takes no further step and may leave, since the survivors' collectives run
over their own group and mesh.  Every rank runs the same :class:`FailureInjector`,
so all agree on which rank fails and at which step.

:class:`FailureInjector` is a copy of the reference's, pinned to its text.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class RankMesh:
    """The survivors' process group, the (data, model) layout of their
    ranks (global ranks, row-major: a row is one model-parallel group) and
    the ``DeviceMesh`` over that layout."""

    group: Any
    layout: np.ndarray
    axis_names: Tuple[str, ...]
    device_mesh: Any = None

    @property
    def ranks(self) -> List[int]:
        return [int(r) for r in self.layout.ravel()]


def device_mesh(layout: np.ndarray, axis_names: Sequence[str]):
    """A ``DeviceMesh`` over the global ranks of ``layout``, on the card
    under NCCL and on the CPU otherwise (every rank of the default group
    calls it)."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cuda" if dist.get_backend() == "nccl" else "cpu",
                      torch.from_numpy(layout), mesh_dim_names=tuple(axis_names))


class ElasticMesh:
    """A rank-set factory that remembers failed ranks across rebuilds.

    ``build(model_parallel=k)`` lays the surviving ranks out as a
    (data, model) grid with the largest model-parallel degree <= k that
    divides the survivor count (model parallelism degrades gracefully as
    ranks die rather than refusing to build).  Needs the default process
    group.
    """

    def __init__(self, axis_names: Sequence[str] = ("data", "model")):
        if len(axis_names) != 2:
            raise ValueError("ElasticMesh lays devices out over exactly two axes")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self._failed: set = set()

    def healthy_devices(self) -> List[int]:
        """The surviving ranks of the default group, in order."""
        return [r for r in range(dist.get_world_size()) if r not in self._failed]

    def fail(self, device_id: int) -> None:
        """Mark a rank as failed; it is excluded from every later build."""
        self._failed.add(int(device_id))

    def failed_ids(self) -> List[int]:
        return sorted(self._failed)

    def build(self, model_parallel: int = 1) -> RankMesh:
        """The survivors' group (collective: every rank of the default group
        calls it, failed ones included; a failed rank gets a group it is
        not a member of) and their layout."""
        ranks = self.healthy_devices()
        n = len(ranks)
        if n == 0:
            raise RuntimeError("ElasticMesh: no healthy devices left to build from")
        mp = max(g for g in range(1, min(model_parallel, n) + 1) if n % g == 0)
        layout = np.asarray(ranks, dtype=np.int64).reshape(n // mp, mp)
        group = dist.group.WORLD if n == dist.get_world_size() else dist.new_group(ranks)
        return RankMesh(group, layout, self.axis_names, device_mesh(layout, self.axis_names))


class FailureInjector:
    """Deterministic one-shot device failures at configured steps.

    ``check(step)`` returns the failing device id the first time ``step``
    matches a configured failure, and ``None`` otherwise.  Each failure is
    consumed when it fires — after recovery rewinds the step counter to the
    last checkpoint, replaying the same step does not re-kill the device.
    """

    def __init__(self, fail_at_steps: Sequence[int], device_ids: Sequence[int]):
        if fail_at_steps and not device_ids:
            raise ValueError("fail_at_steps given but no device_ids to fail")
        self._pending = dict(zip(fail_at_steps, itertools.cycle(device_ids))) \
            if fail_at_steps else {}

    def check(self, step: int) -> Optional[int]:
        return self._pending.pop(step, None)

    def pending(self) -> dict:
        return dict(self._pending)
