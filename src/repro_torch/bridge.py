"""Weights and caches between the JAX package's layout and the port's.

The reference keeps every per-layer leaf stacked on a leading ``n_full``
axis: ``{"stack": {"0": {...}}, "rem": {...}}`` (``stack_layout``).  The
port walks its layers in a Python loop and keeps them **split**: a list
``"layers"`` of per-layer dicts.  Only the dense family (pattern
``("attn",)``, so ``n_full == n_layers`` and no ``rem``) is handled.

Everything crosses as numpy arrays: a caller holding JAX arrays passes
``jax.tree.map(np.asarray, tree)``, and nothing here imports JAX.  bf16
has no numpy dtype of its own; JAX's numpy view of it (``ml_dtypes``) is
read and written through its raw 16 bits, so the round trip is bit-exact.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.models.transformer import check_dense

Params = Dict[str, Any]


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)                   # a writable copy (JAX hands out read-only views)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_numpy(t: torch.Tensor, bf16_dtype=None) -> np.ndarray:
    """``bf16_dtype``: the numpy dtype to view bf16 bits as (JAX's
    ``jnp.bfloat16``); by default bf16 widens exactly to float32."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        if bf16_dtype is None:
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(bf16_dtype)
    return t.numpy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def layers_from_stack(stacked: Params, n_layers: int, device) -> List[Params]:
    """``{"0": block with leaves (n_full, ...)}`` -> list of per-layer blocks."""
    (block,) = stacked.values()
    return [_map(block, lambda a, i=i: tensor_from_numpy(np.asarray(a)[i], device))
            for i in range(n_layers)]


def stack_from_layers(layers: List[Params], bf16_dtype=None) -> Params:
    """Inverse of :func:`layers_from_stack`."""
    def walk(trees):
        if isinstance(trees[0], dict):
            return {k: walk([t[k] for t in trees]) for k in trees[0]}
        return np.stack([tensor_to_numpy(t, bf16_dtype) for t in trees])

    return {"0": walk(layers)}


def params_from_numpy(cfg, tree: Params, device) -> Params:
    """The reference's parameter tree (numpy leaves) -> the port's params."""
    check_dense(cfg)
    out: Params = {
        "embed": tensor_from_numpy(tree["embed"], device),
        "final_norm": _map(tree["final_norm"], lambda a: tensor_from_numpy(a, device)),
        "layers": layers_from_stack(tree["stack"], cfg.n_layers, device),
    }
    if "head" in tree:
        out["head"] = tensor_from_numpy(tree["head"], device)
    return out


def params_to_numpy(cfg, params: Params, bf16_dtype=None) -> Params:
    """The port's params -> the reference's stacked tree of numpy arrays."""
    check_dense(cfg)
    out: Params = {
        "embed": tensor_to_numpy(params["embed"], bf16_dtype),
        "final_norm": _map(params["final_norm"], lambda t: tensor_to_numpy(t, bf16_dtype)),
        "stack": stack_from_layers(params["layers"], bf16_dtype),
    }
    if "head" in params:
        out["head"] = tensor_to_numpy(params["head"], bf16_dtype)
    return out


def blocks_from_numpy(cfg, tree: Params, device) -> Params:
    """A reference cache or page-pool tree ``{"stack": ...}`` -> ``{"layers": [...]}``."""
    check_dense(cfg)
    return {"layers": layers_from_stack(tree["stack"], cfg.n_layers, device)}
