"""RG-LRU recurrent block (RecurrentGemma / Griffin), ported from ``repro.models.rglru``.

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t ⊙ u_t)
a_t = exp(-c * softplus(Λ) * r_t),  r/i = input-dependent sigmoid gates.

Prefill scans the sequence: ``kernel="plain"`` runs
:func:`~repro_torch.kernels.rglru_scan.linear_scan` (log-depth, like the
reference's associative scan), ``kernel="cuda"`` the
hand-written scan of :mod:`repro_torch.kernels.rglru_scan`, which steps
time in order.  Decode is a single-step update.

Where JAX and PyTorch differ by default, the port follows JAX:
``jax.nn.gelu`` is the tanh approximation, and ``jax.nn.softplus`` is
``logaddexp(x, 0)`` everywhere (:func:`layers.softplus`).  Mixed dtypes
promote through :func:`layers.matmul` and :func:`layers.concat`, as JAX
promotes ``bf16 @ fp32`` and a mixed ``jnp.concatenate``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import rglru_scan as RS
from repro_torch.kernels.rglru_scan import linear_scan
from repro_torch.models import layers as L
from repro_torch.models.ssm import causal_depthwise_conv

Params = Dict[str, Any]


def init_rglru(cfg, gen: torch.Generator, dtype, device) -> Params:
    """The reference's initializers and layout (different draws)."""
    d, w = cfg.d_model, cfg.lru_width
    s_d = 1.0 / math.sqrt(d)
    s_w = 1.0 / math.sqrt(w)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    return {
        "w_gelu": normal((d, w), s_d),
        "w_in": normal((d, w), s_d),
        "conv_w": normal((cfg.ssm_conv, w), 0.1),
        "w_r": normal((w, w), s_w),
        "w_i": normal((w, w), s_w),
        # softplus(lam) ~ U[2.5, 4.3] -> a^c in a useful range (Griffin init)
        "lam": torch.rand((w,), generator=gen, device=device) * 1.8 + 2.5,
        "w_out": normal((w, d), s_w),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")          # jax.nn.gelu's default


def _gates(cfg, p, u):
    r = torch.sigmoid(L.matmul(u, p["w_r"]))
    i = torch.sigmoid(L.matmul(u, p["w_i"]))
    log_a = -cfg.rglru_c * L.softplus(p["lam"]) * r.float()
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = beta * (i.float() * u.float())
    return a, b


def rglru_forward(cfg, p: Params, x: torch.Tensor, state: Optional[Params] = None,
                  kernel: str = "plain"):
    """x: (B,S,d) -> (out, new_state | None).  With ``state`` (the prefill
    cache) the new conv state comes back in the promoted dtype, as in the
    reference; the serving join casts it to the pool's."""
    g = _gelu(L.matmul(x, p["w_gelu"]))
    u = L.matmul(x, p["w_in"])
    if state is not None:
        u_full = L.concat([state["conv"].to(u.dtype), u])
        u_conv = causal_depthwise_conv(u_full, p["conv_w"])[:, cfg.ssm_conv - 1:]
    else:
        u_conv = causal_depthwise_conv(u, p["conv_w"])
    a, b = _gates(cfg, p, u_conv)
    h0 = state["h"] if state is not None else None
    if kernel == "cuda":
        h = RS.rglru_scan(a.contiguous(), b.contiguous(),
                          None if h0 is None else h0.contiguous())
        h_last = h[:, -1]
    else:
        h, h_last = linear_scan(a, b, h0)
    out = L.matmul((g.float() * h).to(x.dtype), p["w_out"])
    if state is None:
        return out, None
    new_conv = L.concat([state["conv"], u])[:, -(cfg.ssm_conv - 1):]
    return out, {"conv": new_conv, "h": h_last}


def init_rglru_state(cfg, batch: int, dtype, device) -> Params:
    w = cfg.lru_width
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, w), dtype=dtype, device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }


def rglru_decode(cfg, p: Params, x: torch.Tensor, state: Params):
    """Single-token step.  x: (B,1,d) -> (out (B,1,d), new state)."""
    g = _gelu(L.matmul(x[:, 0], p["w_gelu"]))                 # (B,W)
    u = L.matmul(x[:, 0], p["w_in"])
    window = L.concat([state["conv"].to(u.dtype), u[:, None]])    # (B,K,W)
    dt = torch.promote_types(window.dtype, p["conv_w"].dtype)
    u_conv = torch.einsum("bkc,kc->bc", window.to(dt), p["conv_w"].to(dt))
    a, b = _gates(cfg, p, u_conv)
    h = a * state["h"] + b                                     # (B,W)
    out = L.matmul((g.float() * h).to(x.dtype), p["w_out"])[:, None]
    return out, {"conv": window[:, 1:].to(state["conv"].dtype), "h": h}
