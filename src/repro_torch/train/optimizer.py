"""AdamW with fp32 state and optional fp32 master weights, ported from
``repro.train.optimizer``.

Plain functions over trees of tensors, with the reference's update math in
fp32: the schedule, the bias corrections (``b1 ** step`` as an fp32 power)
and the learning rate are 0-d fp32 tensors on the parameters' device, never
Python doubles.  ``master`` holds fp32 copies only where some parameter is
of lower precision, as in the reference.

**Weight decay goes by the reference's leaf rank.**  The reference decays
a leaf where ``p.ndim >= 2``, and it stacks every per-period leaf on a
leading axis, so a layer's 1-D leaves (norm scales, the SSM's ``A_log``,
``dt_bias`` and ``D``, the RG-LRU's ``lam``) are decayed there, while
``final_norm`` and the 1-D leaves of the remainder blocks (``params["rem"]``
in the reference) are not.  The port keeps its layers split, so
:func:`decay_mask` gives each leaf the decay its reference counterpart gets.

The update writes the parameters and the state in place, as the reference
donates its state to the jitted step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.transformer import stack_layout
from repro_torch.tree import leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    master_fp32: bool = True
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in fp32."""
    step = step.float()
    dev = step.device
    warm = torch.minimum(step / _f32(max(cfg.warmup_steps, 1), dev), _f32(1.0, dev))
    prog = torch.clamp((step - _f32(cfg.warmup_steps, dev))
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), dev), 0.0, 1.0)
    cos = _f32(0.5, dev) * (_f32(1.0, dev) + torch.cos(_f32(math.pi, dev) * prog))
    return (_f32(cfg.lr, dev) * warm
            * (_f32(cfg.min_lr_ratio, dev) + _f32(1 - cfg.min_lr_ratio, dev) * cos))


def decay_mask(model_cfg, params) -> Any:
    """A tree of bools beside ``params``: whether AdamW decays each leaf,
    which is whether its counterpart in the reference's tree has rank >= 2.
    A layer of a full period sits stacked there (one more axis); a
    remainder layer and the top-level leaves sit as they are."""
    n_full, _ = stack_layout(model_cfg)
    n_stacked = n_full * len(model_cfg.pattern)
    out = {k: tree_map(lambda p: p.dim() >= 2, v) for k, v in params.items() if k != "layers"}
    out["layers"] = [tree_map(lambda p, extra=int(i < n_stacked): p.dim() + extra >= 2, layer)
                     for i, layer in enumerate(params["layers"])]
    return out


def init_opt_state(params: Any, cfg: OptConfig) -> Dict[str, Any]:
    state = {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params),
        "step": torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device),
    }
    all_fp32 = all(p.dtype == torch.float32 for p in leaves(params))
    if cfg.master_fp32 and not all_fp32:
        # only low-precision params get a master copy; for fp32 params it
        # would be a second copy of the same numbers
        state["master"] = tree_map(lambda p: p.detach().float().clone(), params)
    return state


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves(tree)))


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: Dict[str, Any], cfg: OptConfig,
                 decay: Any) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping.  ``decay`` is
    :func:`decay_mask`'s tree.  Writes ``params`` and ``state`` in place and
    returns them with ``{"grad_norm", "lr"}``."""
    dev = state["step"].device
    step = state["step"] + 1
    gnorm = global_norm(grads)
    if cfg.grad_clip:
        scale = torch.minimum(_f32(1.0, dev), _f32(cfg.grad_clip, dev)
                              / torch.maximum(gnorm, _f32(1e-9, dev)))
    else:
        scale = _f32(1.0, dev)
    lr = schedule(cfg, step)
    stepf = step.float()
    b1, b2 = _f32(cfg.b1, dev), _f32(cfg.b2, dev)
    bc1 = _f32(1.0, dev) - torch.pow(b1, stepf)
    bc2 = _f32(1.0, dev) - torch.pow(b2, stepf)
    c1, c2 = _f32(1 - cfg.b1, dev), _f32(1 - cfg.b2, dev)
    eps = _f32(cfg.eps, dev)
    masters = state.get("master", params)
    for p, master, g, m, v, dec in zip(leaves(params), leaves(masters), leaves(grads),
                                       leaves(state["m"]), leaves(state["v"]),
                                       leaves(decay)):
        g = g.float() * scale
        m.copy_(b1 * m + c1 * g)
        v.copy_(b2 * v + c2 * torch.square(g))
        mhat = m / bc1
        vhat = v / bc2
        mf = master.float()
        upd = mhat / (torch.sqrt(vhat) + eps)
        if dec:
            upd = upd + _f32(cfg.weight_decay, dev) * mf
        new_master = mf - lr * upd
        if master is not p:
            master.copy_(new_master)
        p.copy_(new_master.to(p.dtype))
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
