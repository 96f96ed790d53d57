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
order does not matter.

The expert products are plain batched matrix products, which the
reference also leaves to XLA outside any Pallas kernel; dtypes promote as
JAX promotes them (``layers.matmul``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

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


def positions(gate_idx: torch.Tensor, n_experts: int, cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each assignment's position in its expert, a running count over the
    flattened (T·k,) assignments, and whether it fits under ``cap``."""
    flat_e = gate_idx.reshape(-1)
    pos_all = torch.cumsum(F.one_hot(flat_e, n_experts), dim=0) - 1   # (T·k, E)
    my_pos = torch.gather(pos_all, 1, flat_e[:, None])[:, 0]
    return my_pos, my_pos < cap


def moe_forward(cfg, p: Params, x: torch.Tensor, cap_override: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (out (B,S,d), aux load-balance loss, a scalar).

    ``cap_override`` sets an explicit capacity; decode passes ``B·S`` for
    the dropless (exact top-k) path, the serving-correct behaviour."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xf = x.reshape(t, d)
    probs, gate_vals, gate_idx = route(cfg, p, xf)

    # load-balance auxiliary loss (Switch/GShard)
    me = probs.mean(dim=0)                                          # (E,)
    ce = F.one_hot(gate_idx, e).float().sum(dim=1).mean(dim=0)
    aux = e * torch.sum(me * ce) * cfg.router_aux_coef

    cap = cap_override or capacity(cfg, t)
    flat_e = gate_idx.reshape(-1)
    my_pos, keep = positions(gate_idx, e, cap)
    # dropped assignments go to a trash expert row e (the scatter stays static)
    dest_e = torch.where(keep, flat_e, e)
    dest_c = torch.where(keep, my_pos, 0)
    tok_of = torch.arange(t * k, device=x.device) // k
    xd = xf[tok_of]                                                 # (T·k, d)
    buf = torch.zeros((e + 1, cap, d), dtype=xf.dtype, device=x.device)
    buf.index_put_((dest_e, dest_c), xd, accumulate=True)
    buf = buf[:e]                                                   # (E, C, d)

    # expert computation (SwiGLU)
    act = F.silu(matmul(buf, p["w1"])) * matmul(buf, p["w3"])
    out_buf = matmul(act, p["w2"])                                  # (E, C, d)

    # combine
    gathered = out_buf[torch.where(keep, flat_e, 0), dest_c]        # (T·k, d)
    w = (gate_vals.reshape(-1) * keep.float()).to(xf.dtype)
    out = (gathered * w[:, None]).reshape(t, k, d).sum(dim=1)
    return out.reshape(b, s, d), aux
