"""Atomic, optionally-async checkpointing for trees of tensors, ported from
``repro.dist.checkpoint``.

The reference's guarantees, kept:

1. **Crash-atomic** — every save writes a ``*.tmp`` file and
   ``os.replace``s it into place; the next manager construction sweeps any
   tmp file a crash left behind.
2. **Skeleton-typed restore** — files store leaves positionally; the caller
   supplies a skeleton tree (the same structure, any leaf values) and gets
   back the *file's* data in the *skeleton's* structure, each leaf on its
   skeleton leaf's device.
3. **Bounded retention** — ``keep`` most-recent steps survive; older files
   are pruned after each successful save.
4. **Async option** — ``async_save=True`` snapshots the tree to host memory
   before ``save`` returns and does the file I/O on one background worker;
   ``wait()`` drains the queue.

**The file format is the reference's**, so either package restores the
other's files: ``step_%08d.npz``, leaves under ``l%06d`` in the order
``jax.tree.leaves`` gives them (dict keys sorted, lists and tuples in
order, ``None`` an empty subtree), and a ``dtypes`` JSON list stored as a
``uint8`` array.  bfloat16 and float8 leaves, which numpy cannot
serialize, are written as same-width unsigned bits with their dtype's name
in that list, and read back by viewing the bits as the skeleton leaf's
dtype (torch's ``bfloat16``/``float8_*``, or a numpy skeleton's own
``ml_dtypes`` dtype), so nothing here needs ``ml_dtypes``.

The sorted order is this module's own (:func:`flatten`): the port's
:func:`repro_torch.tree.leaves` keeps insertion order, which the training
step relies on.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import re
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import is_dtensor

_STEP_RE = re.compile(r"^step_(\d+)\.npz$")

# numpy-unserializable dtypes -> (the file's unsigned integer of the same
# width, the torch dtype, a torch integer of the same width to view it as)
_BITCAST = {"bfloat16": (np.uint16, torch.bfloat16, torch.int16),
            "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn, torch.uint8),
            "float8_e5m2": (np.uint8, torch.float8_e5m2, torch.uint8)}


def flatten(tree: Any) -> List[Any]:
    """The leaves in ``jax.tree.leaves``' order: dict keys sorted, lists and
    tuples in order, ``None`` holding no leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flatten(v)]
    if tree is None:
        return []
    return [tree]


def unflatten(tree: Any, new_leaves: List[Any]) -> Any:
    """``tree``'s structure with ``new_leaves`` in :func:`flatten`'s order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}              # the skeleton's key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        if t is None:
            return None
        return next(it)

    return build(tree)


def _first_rank(leaves: List[Any]) -> bool:
    """Whether this rank writes: the first rank of the DTensor leaves'
    mesh, or any caller of a tree with none."""
    mesh = next((x.device_mesh for x in leaves if is_dtensor(x)), None)
    if mesh is None:
        return True
    import torch.distributed as dist

    return int(mesh.mesh.flatten()[0]) == dist.get_rank()


def _snapshot(leaf, copy: bool) -> Tuple[np.ndarray, str]:
    """(host array to write, dtype name for the table).  With ``copy`` the
    array owns its memory, so the caller may update ``leaf`` in place at
    once: a CPU tensor's ``.numpy()`` and a numpy leaf would otherwise be
    the live buffer (``.cpu()`` of a card tensor copies anyway).  A
    DTensor is gathered to its whole tensor first."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if is_dtensor(t):
            t = t.full_tensor()
        name = str(t.dtype).removeprefix("torch.")
        if name in _BITCAST:
            t = t.view(_BITCAST[name][2])
        host = t.cpu()
        if copy and host.data_ptr() == t.data_ptr():
            host = host.clone()
        arr = host.numpy()
    else:
        arr = np.array(leaf) if copy else np.asarray(leaf)
        name = arr.dtype.name
    if name in _BITCAST:
        return arr.view(_BITCAST[name][0]), name
    return arr, ""


def _restore(arr: np.ndarray, dtype_name: str, skel, where: str):
    """The file's array as a leaf like ``skel``: same shape and dtype
    (checked), on its device."""
    if isinstance(skel, torch.Tensor):
        t = torch.from_numpy(arr)
        if dtype_name:
            if dtype_name not in _BITCAST:
                raise ValueError(f"{where}: unknown dtype {dtype_name!r} in the file")
            _, dtype, bits = _BITCAST[dtype_name]
            t = t.view(bits).view(dtype)
        if t.dtype != skel.dtype or tuple(t.shape) != tuple(skel.shape):
            raise ValueError(f"{where}: file has {t.dtype}{tuple(t.shape)}, skeleton "
                             f"{skel.dtype}{tuple(skel.shape)}")
        return t.to(skel.device)
    want = np.asarray(skel)
    name = dtype_name or arr.dtype.name
    if name != want.dtype.name or arr.shape != want.shape:
        raise ValueError(f"{where}: file has {name}{arr.shape}, skeleton "
                         f"{want.dtype.name}{want.shape}")
    return arr.view(want.dtype) if dtype_name else arr


class CheckpointManager:
    """Save/restore trees under ``directory`` with retention pruning."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        # sweep tmp litter from a previous crash (atomicity guarantee #1)
        for name in os.listdir(directory):
            if name.endswith(".tmp"):
                try:
                    os.remove(os.path.join(directory, name))
                except OSError:
                    pass
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = (
            concurrent.futures.ThreadPoolExecutor(max_workers=1)
            if async_save else None
        )
        self._futures: List[concurrent.futures.Future] = []

    # -- paths -------------------------------------------------------------
    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step):08d}.npz")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save --------------------------------------------------------------
    def save(self, step: int, tree: Any) -> None:
        """Checkpoint ``tree`` (leaves: torch tensors on any device, numpy
        arrays) at ``step`` (atomic; prunes beyond ``keep``).

        With ``async_save`` the host snapshot is complete when this returns
        (every leaf copied), so the caller may update the tree in place at
        once, as the port's training step does; the write is queued on the
        background worker.  DTensor leaves are gathered to whole tensors
        here, on the calling thread (a collective: every rank of their mesh
        calls ``save``), never on the writer's; the mesh's first rank
        writes, the others return.
        """
        async_ = self._pool is not None
        flat = flatten(tree)
        leaves = [_snapshot(x, copy=async_) for x in flat]
        if not _first_rank(flat):
            return
        if async_:
            self._futures.append(self._pool.submit(self._write, step, leaves))
        else:
            self._write(step, leaves)

    def _write(self, step: int, leaves: List[Tuple[np.ndarray, str]]) -> None:
        payload = {f"l{i:06d}": arr for i, (arr, _) in enumerate(leaves)}
        payload["dtypes"] = np.frombuffer(
            json.dumps([name for _, name in leaves]).encode(), dtype=np.uint8
        ).copy()
        final = self._path(step)
        tmp = final + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        self._prune()

    def _prune(self) -> None:
        steps = self.all_steps()
        for step in steps[: max(0, len(steps) - self.keep)]:
            try:
                os.remove(self._path(step))
            except OSError:
                pass

    def wait(self) -> None:
        """Block until all queued async saves hit the disk (re-raises errors)."""
        for fut in self._futures:
            fut.result()
        self._futures.clear()

    # -- restore -----------------------------------------------------------
    def load(self, step: int, skeleton: Any, shardings: Any = None) -> Any:
        """Restore the step's leaves into ``skeleton``'s structure.

        Each leaf comes back as its skeleton leaf's kind: a torch tensor on
        that tensor's device, or a numpy array.  The leaf count, each shape
        and each dtype must agree with the skeleton's, or this raises.  A
        missing step raises: silently returning the skeleton would hand
        callers whatever placeholder values it was built from.

        ``shardings`` (optional) is a tree of
        :class:`~repro_torch.dist.sharding.NamedSharding` in the skeleton's
        structure; each restored leaf (a torch skeleton's) is distributed
        onto its sharding, so an elastic restart restores straight onto the
        *new* mesh.  Every rank of that mesh reads the file and keeps its
        own slice (no collective).
        """
        path = self._path(step)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint for step {step} in {self.directory}")
        flat = flatten(skeleton)
        out = []
        with np.load(path) as z:
            dtypes = json.loads(bytes(z["dtypes"]).decode())
            if len(dtypes) != len(flat):
                raise ValueError(
                    f"checkpoint step {step} has {len(dtypes)} leaves, "
                    f"skeleton has {len(flat)}"
                )
            for i, skel in enumerate(flat):        # one leaf on the host at a time
                out.append(_restore(z[f"l{i:06d}"], dtypes[i], skel,
                                    f"checkpoint step {step} leaf {i}"))
        tree = unflatten(skeleton, out)
        if shardings is None:
            return tree
        from repro_torch.dist.sharding import distribute

        return distribute(tree, shardings)

    def restore_latest(self, skeleton: Any, shardings: Any = None):
        """-> (step, tree) for the newest checkpoint on disk."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return step, self.load(step, skeleton, shardings)
