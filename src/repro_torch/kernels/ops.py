"""The kernels' call surface, ported from ``repro.kernels.ops``.

The same ten functions under the same names, each taking the reference's
data arguments and returning what the reference returns.  CUDA tensors go
to the hand-written kernels, CPU tensors to their plain versions: the
reference's interpret-mode switch has no counterpart, because the choice
follows the tensors' device.

What differs from the reference, and why:

* The TPU tiling arguments mean nothing to the port's kernels and are not
  taken: RMSNorm's ``row_block``, flash attention's ``block_q``/``block_k``,
  the RG-LRU scan's ``chunk``/``width_block``.  ``ssd_scan`` keeps
  ``chunk``, which defines the chunked computation.
* ``flash_attention(causal=False)`` masks keys by index up to S - 1, as
  ``ref.attention_ref`` does; the reference's Pallas kernel, when S is not
  a multiple of its key block, lets its zero padding keys take softmax
  weight in that mode, and the port does not copy that.
* ``ssd_scan`` returns ``y`` only, as the reference does; the model path
  calls :func:`repro_torch.kernels.ssd.ssd_scan` for ``(y, state)``.
* The paged functions update the pools **in place** and return them, where
  the reference's aliased outputs are new arrays.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import rglru_scan as RS
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssd as SSD

Pools = Tuple[torch.Tensor, ...]


def rmsnorm(x, scale, eps: float = 1e-6) -> torch.Tensor:
    return RN.rmsnorm(x, scale, eps)


def flash_attention(q, k, v, causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,Hq,S,D); k/v: (B,Hkv,S,D); causal or full, with an optional window."""
    return FA.flash_attention(q, k, v, window=window, causal=causal)


def ssd_scan(x, dt, a_log, b, c, chunk: int = 128) -> torch.Tensor:
    """x: (B,S,H,P); dt: (B,S,H); a_log: (H,); b, c: (B,S,N) -> y (B,S,H,P)."""
    return SSD.ssd_scan(x, dt, a_log, b, c, chunk=chunk)[0]


def rglru_scan(a, b, h0) -> torch.Tensor:
    """a, b: (B,S,W); h0: (B,W) -> h (B,S,W)."""
    return RS.rglru_scan(a, b, h0)


def paged_attention(q, k_pages, v_pages, table, pos, window: int = 0) -> torch.Tensor:
    """q: (B,Hkv,G,D); pages: (P,page,Hkv,D); table: (B,M); pos: (B,)."""
    return PA.paged_attention(q, k_pages, v_pages, table, pos, window=window)


def paged_attention_quant(q, k_pages, v_pages, k_scale_pages, v_scale_pages, table, pos,
                          window: int = 0) -> torch.Tensor:
    """int8 pages + (P,page,Hkv) float32 scale pages, dequant fused in."""
    return PA.paged_attention(q, k_pages, v_pages, table, pos, k_scale_pages=k_scale_pages,
                              v_scale_pages=v_scale_pages, window=window)


def paged_attention_scatter(q, k_new, v_new, k_pages, v_pages, table, pos, page_idx, off,
                            window: int = 0) -> Tuple[torch.Tensor, Pools]:
    """Fused decode step (scatter, then paged attention, one kernel call).
    Returns ``(out, (k_pages, v_pages))``."""
    out = PA.paged_attention_scatter(q, k_new, v_new, k_pages, v_pages, table, pos,
                                     page_idx, off, window=window)
    return out, (k_pages, v_pages)


def paged_attention_scatter_quant(q, k_new, v_new, k_scale_new, v_scale_new, k_pages,
                                  v_pages, k_scale_pages, v_scale_pages, table, pos,
                                  page_idx, off, window: int = 0
                                  ) -> Tuple[torch.Tensor, Pools]:
    """Fused decode step over int8 pages; the new rows' scales land too.
    Returns ``(out, (k_pages, v_pages, k_scale_pages, v_scale_pages))``."""
    out = PA.paged_attention_scatter(
        q, k_new, v_new, k_pages, v_pages, table, pos, page_idx, off,
        k_scale_new=k_scale_new, v_scale_new=v_scale_new, k_scale_pages=k_scale_pages,
        v_scale_pages=v_scale_pages, window=window)
    return out, (k_pages, v_pages, k_scale_pages, v_scale_pages)


def paged_scatter(k_pages, v_pages, k_new, v_new, page_idx, off) -> Pools:
    """Each slot's new K/V row into its page, in place; returns the pools."""
    return PA.paged_scatter((k_pages, v_pages), (k_new, v_new), page_idx, off)


def paged_scatter_quant(k_pages, v_pages, k_scale_pages, v_scale_pages, k_new, v_new,
                        k_scale_new, v_scale_new, page_idx, off) -> Pools:
    """One launch updates the int8 K/V pages and both scale pools."""
    return PA.paged_scatter((k_pages, v_pages, k_scale_pages, v_scale_pages),
                            (k_new, v_new, k_scale_new, v_scale_new), page_idx, off)
