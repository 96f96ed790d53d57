"""Training steps, ported from ``repro.train.loop``.

``make_train_step``      — the single-process step: loss and gradients
                           under autograd, optional microbatch accumulation,
                           AdamW.
``make_pod_train_step``  — the data-parallel step: each rank takes its
                           shard of the batch, and the gradients are
                           reduced over a process group through the
                           COUNTDOWN-instrumented ``cd_psum`` (artificial
                           barrier + timeout-governed slack, per the paper),
                           or int8-compressed through ``compressed_psum``.

The reference's mesh axis ``pod`` becomes a ``torch.distributed`` process
group (``None``: the world), as in :mod:`repro_torch.core.instrument`.
Sharding inside a pod (the reference's activation hooks) is not ported
yet: here a rank is one device holding the whole model.

Gradients come from ``torch.autograd.grad`` over detached views of the
parameter leaves, so the caller's tensors need not require grad.  The steps
update the state **in place** (parameters, moments, masters) and return
it, as the reference donates its state to the jitted step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch
import torch.distributed as dist

from repro_torch.core.instrument import cd_psum
from repro_torch.dist.compression import compressed_psum
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import init_params, loss_fn
from repro_torch.train.optimizer import OptConfig, adamw_update, decay_mask, init_opt_state
from repro_torch.tree import leaves, tree_map, unflatten


@dataclass(frozen=True)
class TrainConfig:
    microbatch: int = 0          # 0 = no accumulation; else per-step microbatch
    pod_reduce: str = "auto"     # auto | manual | compressed
    instrument_axis: str = "pod"
    grad_reduce_dtype: str = ""  # "" = grads keep their natural dtype;
                                 # "bfloat16" halves cross-device reduce wire


def _div(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t / n`` as a true division on every device (a CUDA tensor divided
    by a Python number is multiplied by its reciprocal)."""
    return t / torch.tensor(n, dtype=t.dtype, device=t.device)


def _grads(cfg, params, batch, reduce_dtype: str = ""):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``."""
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live)
    if reduce_dtype:
        # cast before the cross-device reduction: halves its wire bytes
        # (AdamW goes back to fp32)
        dt = dtype_of(reduce_dtype)
        grads = [g.to(dt) for g in grads]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, unflatten(params, grads)


def _accumulated_grads(cfg, params, batch, microbatch: int):
    """Microbatches in order, gradients and loss summed in fp32 and
    averaged: memory-bounded gradient accumulation."""
    b = batch["tokens"].shape[0]
    n = b // microbatch
    if n * microbatch != b:
        raise ValueError("global batch must be divisible by microbatch")
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves(params)]
    loss_sum = torch.zeros((), dtype=torch.float32, device=acc[0].device)
    for i in range(n):
        mb = {k: v[i * microbatch:(i + 1) * microbatch] for k, v in batch.items()}
        loss, _, g = _grads(cfg, params, mb)
        acc = [a + gi for a, gi in zip(acc, leaves(g))]
        loss_sum = loss_sum + loss
    return _div(loss_sum, n), {}, unflatten(params, [_div(a, n) for a in acc])


def _local_grads(cfg, params, batch, train_cfg: TrainConfig, reduce_dtype: str = ""):
    if train_cfg.microbatch:
        return _accumulated_grads(cfg, params, batch, train_cfg.microbatch)
    return _grads(cfg, params, batch, reduce_dtype)


def make_train_step(cfg, opt_cfg: OptConfig,
                    train_cfg: TrainConfig = TrainConfig()) -> Callable:
    """(state, batch) -> (state, metrics); state = {params, opt}, updated in
    place."""

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        params = state["params"]
        loss, metrics, grads = _local_grads(cfg, params, batch, train_cfg,
                                            train_cfg.grad_reduce_dtype)
        params, opt, opt_metrics = adamw_update(params, grads, state["opt"], opt_cfg,
                                                decay_mask(cfg, params))
        return {"params": params, "opt": opt}, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def shard_of(batch: Dict[str, torch.Tensor], group=None) -> Dict[str, torch.Tensor]:
    """This rank's contiguous share of the global batch's rows, as the
    reference's ``P("pod")`` splits it over the mesh axis."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"global batch {b} is not divisible by the group's {n} ranks")
    k = b // n
    return {key: v[r * k:(r + 1) * k] for key, v in batch.items()}


def _group_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The plain (uninstrumented) mean of ``x`` over the group's ranks: the
    reference's ``jax.lax.pmean``."""
    out = x.clone()
    dist.all_reduce(out, group=group)
    return _div(out, dist.get_world_size(group))


def make_pod_train_step(cfg, opt_cfg: OptConfig, group=None,
                        train_cfg: TrainConfig = TrainConfig()) -> Callable:
    """The data-parallel step over ``group`` (the reference's ``pod`` axis).

    Every rank calls ``(state, batch)`` with the same state and the global
    batch, computes the gradients of its shard (:func:`shard_of`) and
    reduces them through ``cd_psum(grads, group) / n`` (``pod_reduce``
    "auto" or "manual") or ``compressed_psum(mean=True)`` ("compressed"),
    so the governor books one instrumented call a step.  The loss is a
    plain mean over the group, as the reference's ``pmean``.  Every rank
    then takes the same AdamW step."""
    if train_cfg.pod_reduce not in ("auto", "manual", "compressed"):
        raise ValueError(f"unknown pod_reduce {train_cfg.pod_reduce!r}")
    n = dist.get_world_size(group)

    def reduce_grads(grads):
        if train_cfg.pod_reduce == "compressed":
            return compressed_psum(grads, group, mean=True)
        return tree_map(lambda g: _div(g, n), cd_psum(grads, group))

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        params = state["params"]
        loss, _, grads = _local_grads(cfg, params, shard_of(batch, group), train_cfg)
        grads = reduce_grads(grads)
        loss = _group_mean(loss, group)
        params, opt, opt_metrics = adamw_update(params, grads, state["opt"], opt_cfg,
                                                decay_mask(cfg, params))
        return {"params": params, "opt": opt}, {"loss": loss, **opt_metrics}

    return train_step


def init_state(cfg, opt_cfg: OptConfig, generator: torch.Generator, device) -> Dict[str, Any]:
    """Random parameters drawn from ``generator`` on ``device`` (different
    draws from JAX's: :mod:`repro_torch.bridge` carries the reference's
    state across) and a fresh optimizer state."""
    params = init_params(cfg, generator, device)
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}
