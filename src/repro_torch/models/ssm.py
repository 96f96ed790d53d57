"""Mamba-2 block pieces, ported from ``repro.models.ssm``.

Only :func:`causal_depthwise_conv` is here so far: the RG-LRU block
(:mod:`repro_torch.models.rglru`) runs it.  The SSD scan, the block and its
decode step wait for the mamba2 family (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
