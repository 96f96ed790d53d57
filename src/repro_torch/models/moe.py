"""Top-k mixture-of-experts FFN with capacity-based scatter/gather dispatch,
ported from ``repro.models.moe``.

GShard-style semantics (top-k routing, capacity factor, load-balance aux
loss) with scatter/gather instead of one-hot einsums, so the dispatch
buffer stays ``(E, C, d)``.  Token routing skew is the "rank imbalance"
the paper's slack mechanism exploits (DESIGN.md §4).

The semantics are the reference's, step for step: router logits in fp32,
softmax, top-k, the gates renormalised with a 1e-9 floor; each assignment's
position in its expert is a running count over the ``T·k`` assignments in
token-major order; assignments at or past the capacity go to a trash row
``E`` of the buffer and are discarded; SwiGLU experts over the buffer; the
combine weighted by the kept gates.  Everything is index arithmetic on the
device: no boolean indexing and no ``nonzero``, which would sync the host.
Every kept ``(expert, position)`` has exactly one writer, so the scatter's
order does not matter.  On a sharded model the routing, the scatter and the
combine run on local tensors (DTensor has no rule for the scatter), and
the expert products on the experts' split weights (:func:`moe_forward`):
where the tokens are split over the data ranks each rank routes its own
and writes them at the slots the whole batch's running count gives them.

The expert products are plain batched matrix products, which the
reference also leaves to XLA outside any Pallas kernel; dtypes promote as
JAX promotes them (``layers.matmul``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import is_dtensor
from repro_torch.dist import sharding as SH
from repro_torch.models.layers import matmul

Params = Dict[str, Any]


def init_moe(cfg, gen: torch.Generator, dtype, device) -> Params:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(f)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    return {
        "router": (normal(d, e) * s_in).to(torch.float32),
        "w1": (normal(e, d, f) * s_in).to(dtype),
        "w3": (normal(e, d, f) * s_in).to(dtype),
        "w2": (normal(e, f, d) * s_out).to(dtype),
    }


def capacity(cfg, n_tokens: int) -> int:
    c = int(math.ceil(cfg.top_k * n_tokens / cfg.n_experts * cfg.capacity_factor))
    return max(c, cfg.top_k)


def route(cfg, p: Params, xf: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xf: (T, d) -> (probs (T, E) fp32, renormalised gates (T, k), expert
    ids (T, k)), the ids in ``jax.lax.top_k``'s order (largest first)."""
    logits = matmul(xf.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gate_vals, gate_idx


def positions(gate_idx: torch.Tensor, n_experts: int, cap: int,
              base: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each assignment's position in its expert, a running count over the
    flattened (T·k,) assignments, and whether it fits under ``cap``.
    ``base`` (E,) starts each expert's count there: the assignments that
    come before these ones in the whole batch."""
    flat_e = gate_idx.reshape(-1)
    pos_all = torch.cumsum(F.one_hot(flat_e, n_experts), dim=0) - 1   # (T·k, E)
    my_pos = torch.gather(pos_all, 1, flat_e[:, None])[:, 0]
    if base is not None:
        my_pos = my_pos + base[flat_e]
    return my_pos, my_pos < cap


def scatter(cfg, xf: torch.Tensor, gate_vals: torch.Tensor, gate_idx: torch.Tensor, cap: int,
            base: Optional[torch.Tensor] = None):
    """The routed (T, d) tokens into the expert buffer -> (buf (E, C, d),
    each assignment's expert (T·k,) and slot in it (T·k,), its combine
    weight (T·k,)).  A dropped assignment's slot is 0 of expert 0 with
    weight 0; ``base`` as :func:`positions` takes it."""
    e, k = cfg.n_experts, cfg.top_k
    t, d = xf.shape
    flat_e = gate_idx.reshape(-1)
    my_pos, keep = positions(gate_idx, e, cap, base)
    # dropped assignments go to a trash expert row e (the scatter stays static)
    dest_c = torch.where(keep, my_pos, 0)
    tok_of = torch.arange(t * k, device=xf.device) // k
    buf = torch.zeros((e + 1, cap, d), dtype=xf.dtype, device=xf.device)
    buf.index_put_((torch.where(keep, flat_e, e), dest_c), xf[tok_of], accumulate=True)
    w = (gate_vals.reshape(-1) * keep.float()).to(xf.dtype)
    return buf[:e], torch.where(keep, flat_e, 0), dest_c, w


def dispatch(cfg, router: torch.Tensor, xf: torch.Tensor, cap: int):
    """Route the (T, d) tokens and scatter them into the expert buffer ->
    (:func:`scatter`'s four, the aux load-balance loss)."""
    e = cfg.n_experts
    probs, gate_vals, gate_idx = route(cfg, {"router": router}, xf)

    # load-balance auxiliary loss (Switch/GShard)
    me = probs.mean(dim=0)                                          # (E,)
    ce = F.one_hot(gate_idx, e).float().sum(dim=1).mean(dim=0)
    aux = e * torch.sum(me * ce) * cfg.router_aux_coef
    return (*scatter(cfg, xf, gate_vals, gate_idx, cap), aux)


# --------------------------------------------------------------------------
# tokens split over the data ranks: each rank's part of the dispatch
# --------------------------------------------------------------------------

def _route_own(cfg, router: torch.Tensor, xf: torch.Tensor):
    """One rank's (T/D, d) tokens routed -> (its sum of the router
    probabilities (E,), its assignments' count in each expert (1, E), the
    gates and ids (T/D, k))."""
    probs, gate_vals, gate_idx = route(cfg, {"router": router}, xf)
    flat_e = gate_idx.reshape(-1)
    counts = torch.zeros(cfg.n_experts, dtype=flat_e.dtype, device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    return probs.sum(dim=0), counts[None], gate_vals, gate_idx


def _first_slots(counts: torch.Tensor):
    """Every rank's counts (D, E), in the order of its tokens in the batch
    -> (where each rank's assignments start in each expert: the exclusive
    scan of the counts (D, E); the whole batch's counts (E,))."""
    return torch.cumsum(counts, dim=0) - counts, counts.sum(dim=0)


def _split_dispatch(cfg, p: Params, xf, cap: int, group: Tuple[int, ...]):
    """:func:`dispatch` on a DTensor ``xf`` (T, d) whose tokens are split
    over the mesh dims ``group``, no rank holding more than its own T/D
    rows: each routes its tokens, one all-gather brings every rank's (E,)
    counts, and each writes its kept rows at their slots in the whole
    batch's running count.  That count runs token-major over the batch,
    whose dim 0 DTensor splits in the group's rank order, so the ranks
    below this one hold exactly the assignments that come before its own.
    A rank's own partial buffer, summed over the group, is the whole
    buffer (every kept slot has one writer): one reduce-scatter leaves each
    rank its C/D slots of every expert for the expert products.  Returns
    that buffer (E, C, d), the four (T·k,) tensors split as the tokens
    are, and the aux loss."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = xf.device_mesh
    t = xf.shape[0]
    tok = SH.local_placements(xf, keep=(0,))
    rep = (Replicate(),) * mesh.ndim
    part = tuple(Partial() if i in group else Replicate() for i in range(mesh.ndim))
    probs_sum, counts, gate_vals, gate_idx = SH.on_shards(
        functools.partial(_route_own, cfg), (p["router"], xf), (rep, tok),
        (part, tok, tok, tok), grad_placements=(part, tok))
    first, total = SH.on_shards(_first_slots, (counts,), (rep,), (rep, rep))
    # load-balance auxiliary loss over the whole batch
    me = probs_sum / t
    ce = total.float() / t
    aux = (cfg.n_experts * torch.sum(me * ce) * cfg.router_aux_coef).redistribute(mesh, rep)
    buf, src_e, src_c, w = SH.on_shards(
        lambda x, g, i, f: scatter(cfg, x, g, i, cap, base=f[0]),
        (xf, gate_vals, gate_idx, first), (tok, tok, tok, tok), (part, tok, tok, tok))
    slots = tuple(Shard(1) if i in group else Replicate() for i in range(mesh.ndim))
    return buf.redistribute(mesh, slots), src_e, src_c, w, aux


def _token_group(xf) -> Tuple[int, ...]:
    """The mesh dims of more than one rank that split a DTensor's tokens
    (dim 0); none for a plain tensor."""
    if not is_dtensor(xf):
        return ()
    sizes = xf.device_mesh.shape
    return tuple(i for i, pl in enumerate(xf.placements)
                 if pl.is_shard(0) and sizes[i] > 1)


def combine(out_buf: torch.Tensor, src_e: torch.Tensor, src_c: torch.Tensor,
            w: torch.Tensor, k: int) -> torch.Tensor:
    """Each token's k expert outputs (E, C, d) gathered and summed by their
    weights -> (T, d)."""
    gathered = out_buf[src_e, src_c]                                # (T·k, d)
    return (gathered * w[:, None]).reshape(-1, k, out_buf.shape[-1]).sum(dim=1)


def moe_forward(cfg, p: Params, x: torch.Tensor, cap_override: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (out (B,S,d), aux load-balance loss, a scalar).

    ``cap_override`` sets an explicit capacity; decode passes ``B·S`` for
    the dropless (exact top-k) path, the serving-correct behaviour.

    On DTensors (a sharded model) routing and dispatch run on local
    tensors (:func:`repro_torch.dist.sharding.on_shards`), where DTensor
    has no rule for the scatter.  Where the tokens are split over data
    ranks (:func:`_split_dispatch`) each rank routes, scatters and combines
    its own, at the whole batch's slots and capacity, and ``out`` comes
    back split as ``x`` is; otherwise every rank runs them over the whole
    tokens and the whole router, the same index arithmetic on the same
    values.  The expert products stay DTensor products on the experts'
    split weights; their partial sums are reduced once, before the
    combine."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    cap = cap_override or capacity(cfg, t)
    group = _token_group(xf)
    if group:
        buf, src_e, src_c, w, aux = _split_dispatch(cfg, p, xf, cap, group)
    elif is_dtensor(xf):
        rep = SH.local_placements(xf)                  # every mesh dim replicated
        buf, src_e, src_c, w, aux = SH.on_shards(
            functools.partial(dispatch, cfg, cap=cap), (p["router"], xf), (rep, rep),
            (rep,) * 5)
    else:
        buf, src_e, src_c, w, aux = dispatch(cfg, p["router"], xf, cap)

    # expert computation (SwiGLU)
    act = F.silu(matmul(buf, p["w1"])) * matmul(buf, p["w3"])
    out_buf = matmul(act, p["w2"])                                  # (E, C, d)

    if is_dtensor(xf):
        from torch.distributed.tensor import Partial, Replicate

        mesh = xf.device_mesh
        tok = SH.local_placements(xf, keep=(0,) if group else ())
        rep = (Replicate(),) * mesh.ndim
        # each rank gathers its own assignments' rows: the buffer's
        # gradient is its partial sum over the token group
        part = tuple(Partial() if i in group else Replicate() for i in range(mesh.ndim))
        out = SH.on_shards(functools.partial(combine, k=cfg.top_k), (out_buf, src_e, src_c, w),
                           (rep, tok, tok, tok), tok, grad_placements=(part, tok, tok, tok))
    else:
        out = combine(out_buf, src_e, src_c, w, cfg.top_k)
    return out.reshape(b, s, d), aux
