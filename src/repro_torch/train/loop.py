"""Training steps, ported from ``repro.train.loop``.

``make_train_step``      — the single-process step: loss and gradients
                           under autograd, optional microbatch accumulation,
                           AdamW.
``make_pod_train_step``  — the multi-pod step: the gradients are reduced
                           over the pods through the COUNTDOWN-instrumented
                           ``cd_psum`` (artificial barrier +
                           timeout-governed slack, per the paper), or
                           int8-compressed through ``compressed_psum``.

``make_pod_train_step`` takes the reference's mesh or a process group.
Given a ``DeviceMesh`` with a ``pod`` axis (the reference's form), the
parameters and moments are DTensors in ``param_shardings(mesh,
include_pod=False, gather_safe=True)`` (FSDP over ``data`` inside each pod,
whole over ``pod``) and the batch is split over ``(pod, data)``; each
pod's loss and gradients come from its ``(data, model)`` sub-mesh, with the
activation hooks of :func:`~repro_torch.dist.sharding.activation_constraint_fn`
excluding ``pod``, and the gradients' local shards are reduced over the
rank's pod group.  Given a process group (``None``: the world), as in
:mod:`repro_torch.core.instrument`, each rank is one device holding the
whole model and takes its shard of the batch.
Sharding inside a pod without pods is ``make_train_step`` run unchanged on
DTensor parameters, moments and batches (the launcher's ``build``: 2-D
specs from :mod:`repro_torch.dist.sharding`, the activation hooks
installed): loss and gradients come through autograd, AdamW updates each
rank's shards in place, and :func:`~repro_torch.train.optimizer.decay_mask`
reads the global rank.

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
from repro_torch.dist import sharding as SH
from repro_torch.dist.compression import compressed_psum
from repro_torch.models import hooks
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
    """The multi-pod step over ``group``: a ``DeviceMesh`` with a ``pod``
    axis (the reference's ``mesh``), or a process group whose ranks are the
    pods (``None``: the world).

    The gradients are reduced over the pods through ``cd_psum(grads) / n``
    (``pod_reduce`` "auto" or "manual") or ``compressed_psum(mean=True)``
    ("compressed"), so the governor books one instrumented call a step.
    The loss is a plain mean over the pods, as the reference's ``pmean``.
    Every pod then takes the same AdamW step.

    Over a process group every rank calls ``(state, batch)`` with the same
    plain state and the global batch and computes the gradients of its
    shard (:func:`shard_of`).  Over a mesh see :func:`_mesh_pod_step`."""
    if train_cfg.pod_reduce not in ("auto", "manual", "compressed"):
        raise ValueError(f"unknown pod_reduce {train_cfg.pod_reduce!r}")
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(group, DeviceMesh):
        return _mesh_pod_step(cfg, opt_cfg, group, train_cfg)
    n = dist.get_world_size(group)

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        params = state["params"]
        loss, _, grads = _local_grads(cfg, params, shard_of(batch, group), train_cfg)
        grads = _pod_reduce(grads, group, n, train_cfg)
        loss = _group_mean(loss, group)
        params, opt, opt_metrics = adamw_update(params, grads, state["opt"], opt_cfg,
                                                decay_mask(cfg, params))
        return {"params": params, "opt": opt}, {"loss": loss, **opt_metrics}

    return train_step


def _pod_reduce(grads, group, n: int, train_cfg: TrainConfig):
    """The mean of a tree of plain gradients over ``group``'s ``n`` ranks,
    through the instrumented collective ``train_cfg.pod_reduce`` names."""
    if train_cfg.pod_reduce == "compressed":
        return compressed_psum(grads, group, mean=True)
    return tree_map(lambda g: _div(g, n), cd_psum(grads, group))


def _mesh_pod_step(cfg, opt_cfg: OptConfig, mesh, train_cfg: TrainConfig) -> Callable:
    """The reference's pod-explicit step on a ``(pod, data, model)`` mesh.

    ``state`` holds DTensors on ``mesh``, whole over ``pod`` (the
    ``include_pod=False`` specs), and ``batch`` DTensors split over
    ``pod`` (``batch_shardings``).  Each rank views its local shards as
    DTensors on its pod's ``(data, model)`` sub-mesh (no copy), so a pod's
    forward and backward, and their collectives, stay inside the pod.  The
    gradients, in the parameters' placements, are reduced shard by shard
    over the rank's pod group (its peers at the same (data, model)
    coordinate hold the same shard of the other pods' gradients); a DTensor
    placed over the whole mesh would claim the pods agree before they do.
    AdamW then updates the state's shards in place on ``mesh``."""
    from torch.distributed.tensor import DTensor

    names = tuple(mesh.mesh_dim_names or ())
    if "pod" not in names:
        raise ValueError("make_pod_train_step needs a mesh with a 'pod' axis")
    pod_dim = names.index("pod")
    npod = mesh.size(pod_dim)
    pod_group = mesh.get_group("pod")
    inner = tuple(a for a in names if a != "pod")
    sub = mesh[inner]
    constraint = SH.activation_constraint_fn(sub, exclude={"pod"})

    def in_pod(t):
        """``t``'s local shard as a DTensor on the pod's sub-mesh."""
        placements = tuple(t.placements)
        return DTensor.from_local(t.to_local(), sub,
                                  placements[:pod_dim] + placements[pod_dim + 1:],
                                  run_check=False)

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        params = state["params"]
        flat = leaves(params)
        if any(p.placements[pod_dim].is_shard() for p in flat):
            raise ValueError("the pod step keeps parameters whole over 'pod' "
                             "(param_shardings(include_pod=False))")
        pod_params = [in_pod(p) for p in flat]
        old = hooks._CONSTRAIN
        hooks.install_constraint(constraint)
        try:
            with SH.replicating(sub):
                loss, _, grads = _local_grads(cfg, unflatten(params, pod_params),
                                              tree_map(in_pod, batch), train_cfg)
        finally:
            hooks.install_constraint(old)
        local = [g.redistribute(sub, p.placements).to_local()
                 for g, p in zip(leaves(grads), pod_params)]
        local = leaves(_pod_reduce(local, pod_group, npod, train_cfg))
        grads = unflatten(params, [DTensor.from_local(g, mesh, p.placements, run_check=False)
                                   for g, p in zip(local, flat)])
        loss = _group_mean(SH.whole(loss), pod_group)
        with SH.replicating(mesh):
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
