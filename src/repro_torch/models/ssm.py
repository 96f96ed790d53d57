"""Mamba-2 (SSD, state-space duality) block, ported from ``repro.models.ssm``.

Prefill runs the chunked SSD scan: ``kernel="plain"`` runs
:func:`~repro_torch.kernels.ssd.ssd_chunked` (the reference's chunked
algorithm, re-exported here), ``kernel="cuda"`` the hand-written kernel of
:mod:`repro_torch.kernels.ssd`, which computes the same ``(y, state)``.
Decode is a single-step update of the (H, P, N) state.

Where JAX and PyTorch differ by default, the port follows JAX:
``jax.nn.softplus`` has no linear threshold (:func:`layers.softplus`), and
mixed dtypes promote as JAX promotes them (:func:`layers.matmul`,
:func:`layers.concat`).  With fp32 params and bf16 compute (full
mamba2-130m) ``x @ w_in`` is fp32, so the scan's inputs are fp32; the conv
state comes back fp32 from the prefill and is rounded into the bf16 pool
at the join, as the reference's ``.set`` rounds it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd as SSD
from repro_torch.kernels.ssd import ssd_chunked
from repro_torch.models import layers as L

Params = Dict[str, Any]


def init_ssm(cfg, gen: torch.Generator, dtype, device) -> Params:
    """The reference's initializers and layout (different draws); ``A_log``,
    ``dt_bias`` and ``D`` are fp32 whatever the param dtype."""
    d = cfg.d_model
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    d_in_proj = 2 * di + 2 * n + h          # z, x, B, C, dt
    conv_ch = di + 2 * n

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    def uniform(lo, hi):
        return torch.rand((h,), generator=gen, device=device) * (hi - lo) + lo

    return {
        "w_in": normal((d, d_in_proj), 1.0 / math.sqrt(d)),
        "conv_w": normal((cfg.ssm_conv, conv_ch), 0.1),
        "A_log": torch.log(uniform(1.0, 16.0)),
        "dt_bias": uniform(-4.0, -1.0),
        "D": torch.ones((h,), dtype=torch.float32, device=device),
        "norm_scale": torch.ones((di,), dtype=dtype, device=device),
        "w_out": normal((di, d), 1.0 / math.sqrt(di)),
    }


def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B,S,C); w: (K,C).  y_t = sum_i w_i * x_{t-K+1+i} (causal).

    The taps are summed in the reference's order, from zeros in x's dtype,
    so a bf16 x with fp32 taps promotes to fp32 as JAX promotes it."""
    k = w.shape[0]
    s = x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + s] * w[i]
    return out


def _split_proj(cfg, zxbcdt):
    di, n = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xin = zxbcdt[..., di:2 * di]
    b = zxbcdt[..., 2 * di:2 * di + n]
    c = zxbcdt[..., 2 * di + n:2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    return z, xin, b, c, dt


def _gated_norm_out(p, y, z, out_dtype):
    """Mamba-2's gated RMSNorm, norm(y * silu(z)), then the out projection."""
    y = y.float() * F.silu(z.float())
    y = y * torch.rsqrt(torch.mean(torch.square(y), dim=-1, keepdim=True) + 1e-6)
    y = (y * p["norm_scale"].float()).to(out_dtype)
    return L.matmul(y, p["w_out"])


def ssm_forward(cfg, p: Params, x: torch.Tensor, state: Optional[Params] = None,
                kernel: str = "plain"):
    """Full-sequence Mamba-2 block.  x: (B,S,d) -> (out, new_state | None).

    With ``state`` (the prefill cache: ``conv`` and ``h``) the scan starts
    from ``state["h"]`` and the new conv state comes back in the promoted
    dtype, as in the reference; the serving join casts it to the pool's."""
    bsz, s, _ = x.shape
    di, n, h, ph = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_d_head
    zxbcdt = L.matmul(x, p["w_in"])
    z, xin, b, c, dt = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xin, b, c], dim=-1)
    if state is not None:
        conv_in_full = L.concat([state["conv"].to(conv_in.dtype), conv_in])
        conv_out = causal_depthwise_conv(conv_in_full, p["conv_w"])[:, cfg.ssm_conv - 1:]
    else:
        conv_out = causal_depthwise_conv(conv_in, p["conv_w"])
    conv_out = F.silu(conv_out)
    xin, b, c = conv_out[..., :di], conv_out[..., di:di + n], conv_out[..., di + n:]
    xh = xin.reshape(bsz, s, h, ph)
    dtv = L.softplus(dt.float() + p["dt_bias"])
    a_log = -torch.exp(p["A_log"])
    h0 = state["h"] if state is not None else None
    if kernel == "cuda":
        y, final = SSD.ssd_scan(xh.contiguous(), dtv.contiguous(), a_log.contiguous(),
                                b.contiguous(), c.contiguous(), chunk=cfg.ssm_chunk,
                                init_state=None if h0 is None else h0.contiguous())
    else:
        y, final = ssd_chunked(xh, dtv, a_log, b, c, cfg.ssm_chunk, h0)
    y = y + p["D"][None, None, :, None] * xh.float()
    out = _gated_norm_out(p, y.reshape(bsz, s, di), z, x.dtype)
    if state is None:
        return out, None
    new_conv = L.concat([state["conv"], conv_in])[:, -(cfg.ssm_conv - 1):]
    return out, {"conv": new_conv, "h": final}


def init_ssm_state(cfg, batch: int, dtype, device) -> Params:
    """``conv`` in the compute dtype, ``h`` (B,H,P,N) fp32."""
    di, n, h, ph = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_d_head
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * n), dtype=dtype, device=device),
        "h": torch.zeros((batch, h, ph, n), dtype=torch.float32, device=device),
    }


def ssm_decode(cfg, p: Params, x: torch.Tensor, state: Params):
    """Single-token step.  x: (B,1,d) -> (out (B,1,d), new state)."""
    bsz = x.shape[0]
    di, n, h, ph = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_d_head
    zxbcdt = L.matmul(x[:, 0], p["w_in"])                          # (B, ...)
    z, xin, b, c, dt = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xin, b, c], dim=-1)                       # (B,C)
    window = L.concat([state["conv"].to(conv_in.dtype), conv_in[:, None]])
    wdt = torch.promote_types(window.dtype, p["conv_w"].dtype)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window.to(wdt), p["conv_w"].to(wdt)))
    xin, b, c = conv_out[..., :di], conv_out[..., di:di + n], conv_out[..., di + n:]
    xh = xin.reshape(bsz, h, ph).float()
    dtv = L.softplus(dt.float() + p["dt_bias"])                    # (B,H)
    a = torch.exp(dtv * (-torch.exp(p["A_log"])))                  # (B,H)
    hs = state["h"] * a[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dtv, xh, b.float())
    y = torch.einsum("bn,bhpn->bhp", c.float(), hs)
    y = y + p["D"][None, :, None] * xh
    out = _gated_norm_out(p, y.reshape(bsz, di), z, x.dtype)[:, None]
    return out, {"conv": window[:, 1:].to(state["conv"].dtype), "h": hs}
