"""Weights and caches between the JAX package's layout and the port's.

The reference keeps every per-layer leaf stacked on a leading ``n_full``
axis: ``{"stack": {"0": {...}, ...}, "rem": {...}}`` (``stack_layout``).
The port walks its layers in a Python loop and keeps them **split**: a
list ``"layers"`` of per-layer dicts in layer order.  The dense, MoE, vlm
and audio families (pattern ``("attn",)``, so ``n_full == n_layers`` and
no ``rem``), the SSM family (mamba2: ``("ssm",)``, likewise homogeneous)
and the hybrid family (recurrentgemma: periods of ``("rglru", "rglru",
"attn")`` and, at 26 layers, a remainder ``("rglru", "rglru")`` under
``"rem"``) are handled.  Whatever a block holds crosses as it is: the MoE
FFN's ``router``, ``w1``, ``w3`` and ``w2``, LayerNorm's ``bias``, and the
nonparametric norm's empty dicts, which stay empty both ways.

Everything crosses as numpy arrays: a caller holding JAX arrays passes
``jax.tree.map(np.asarray, tree)``, and nothing here imports JAX.  bf16
has no numpy dtype of its own; JAX's numpy view of it (``ml_dtypes``) is
read and written through its raw 16 bits, so the round trip is bit-exact.
Training states cross too: the AdamW moments and masters take the
parameters' layout (:func:`state_from_numpy`, :func:`state_to_numpy`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import check_supported, stack_layout

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


def _layer_places(cfg) -> List[Tuple[str, str, Optional[int]]]:
    """Where each layer, in order, sits in the reference's tree: period i's
    block j at ``("stack", j, i)``, then remainder block j at ``("rem", j, None)``."""
    n_full, rem_kinds = stack_layout(cfg)
    plen = len(cfg.pattern)
    return ([("stack", str(j), i) for i in range(n_full) for j in range(plen)]
            + [("rem", str(j), None) for j in range(len(rem_kinds))])


def layers_from_tree(cfg, tree: Params, device) -> List[Params]:
    """``{"stack": {j: leaves (n_full, ...)}, "rem": {j: ...}}`` -> list of
    per-layer blocks in layer order."""
    def take(a, i):
        a = np.asarray(a)
        return tensor_from_numpy(a if i is None else a[i], device)

    return [_map(tree[group][j], lambda a, i=i: take(a, i))
            for group, j, i in _layer_places(cfg)]


def tree_from_layers(cfg, layers: List[Params], bf16_dtype=None) -> Params:
    """Inverse of :func:`layers_from_tree`."""
    def walk(trees):
        if isinstance(trees[0], dict):
            return {k: walk([t[k] for t in trees]) for k in trees[0]}
        return np.stack([tensor_to_numpy(t, bf16_dtype) for t in trees])

    n_full, rem_kinds = stack_layout(cfg)
    plen = len(cfg.pattern)
    out: Params = {"stack": {str(j): walk([layers[i * plen + j] for i in range(n_full)])
                             for j in range(plen)}}
    if rem_kinds:
        out["rem"] = {str(j): _map(layers[n_full * plen + j],
                                   lambda t: tensor_to_numpy(t, bf16_dtype))
                      for j in range(len(rem_kinds))}
    return out


def params_from_numpy(cfg, tree: Params, device) -> Params:
    """The reference's parameter tree (numpy leaves) -> the port's params."""
    check_supported(cfg)
    out: Params = {
        "embed": tensor_from_numpy(tree["embed"], device),
        "final_norm": _map(tree["final_norm"], lambda a: tensor_from_numpy(a, device)),
        "layers": layers_from_tree(cfg, tree, device),
    }
    if "head" in tree:
        out["head"] = tensor_from_numpy(tree["head"], device)
    return out


def params_to_numpy(cfg, params: Params, bf16_dtype=None) -> Params:
    """The port's params -> the reference's stacked tree of numpy arrays."""
    check_supported(cfg)
    out: Params = {
        "embed": tensor_to_numpy(params["embed"], bf16_dtype),
        "final_norm": _map(params["final_norm"], lambda t: tensor_to_numpy(t, bf16_dtype)),
        **tree_from_layers(cfg, params["layers"], bf16_dtype),
    }
    if "head" in params:
        out["head"] = tensor_to_numpy(params["head"], bf16_dtype)
    return out


def opt_state_from_numpy(cfg, tree: Params, device) -> Params:
    """The reference's AdamW state (``m``, ``v``, ``step`` and, for
    low-precision params, ``master``; numpy leaves) -> the port's, each
    moment tree in the port's parameter layout."""
    out: Params = {k: params_from_numpy(cfg, tree[k], device)
                   for k in ("m", "v", "master") if k in tree}
    out["step"] = tensor_from_numpy(tree["step"], device)
    return out


def opt_state_to_numpy(cfg, opt: Params, bf16_dtype=None) -> Params:
    """Inverse of :func:`opt_state_from_numpy`."""
    out: Params = {k: params_to_numpy(cfg, opt[k], bf16_dtype)
                   for k in ("m", "v", "master") if k in opt}
    out["step"] = tensor_to_numpy(opt["step"])
    return out


def state_from_numpy(cfg, tree: Params, device) -> Params:
    """A reference training state ``{"params", "opt"}`` -> the port's."""
    return {"params": params_from_numpy(cfg, tree["params"], device),
            "opt": opt_state_from_numpy(cfg, tree["opt"], device)}


def state_to_numpy(cfg, state: Params, bf16_dtype=None) -> Params:
    """Inverse of :func:`state_from_numpy`."""
    return {"params": params_to_numpy(cfg, state["params"], bf16_dtype),
            "opt": opt_state_to_numpy(cfg, state["opt"], bf16_dtype)}


def blocks_from_numpy(cfg, tree: Params, device) -> Params:
    """A reference cache or page-pool tree ``{"stack": ..., "rem": ...}`` ->
    ``{"layers": [...]}``."""
    check_supported(cfg)
    return {"layers": layers_from_tree(cfg, tree, device)}


def blocks_to_numpy(cfg, blocks: Params, bf16_dtype=None) -> Params:
    """Inverse of :func:`blocks_from_numpy`."""
    check_supported(cfg)
    return tree_from_layers(cfg, blocks["layers"], bf16_dtype)
