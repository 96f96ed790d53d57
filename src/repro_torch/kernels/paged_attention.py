"""Paged-decode attention with the fused K/V scatter: CUDA kernel + plain version.

The port of ``repro.kernels.paged_attention.paged_attention_scatter_pallas``
(both its bf16/fp32 and its int8 variant).  One decode step: every slot's
new K/V row lands in its page, then each slot attends over the pages of its
page-table row.

* :func:`paged_attention_scatter` is the wrapper.  For CUDA tensors it
  launches the hand-written kernel in ``csrc/paged_attention.cu`` (built for
  ``sm_90a`` on first use) or raises; it takes the plain version only for
  tensors that lie on the CPU.  It counts its launches in :data:`launches`.
* :func:`paged_attention_scatter_plain` is the plain PyTorch version, a copy
  of the reference's XLA branch (``repro/serve/kvcache.py``: scatter, gather
  the whole table row, masked softmax).  The CPU tests run it, and
  ``chip_smoke.py`` holds the kernel against it on the card.

Both update the page pools **in place** and return the attention output.
They differ in one rounding, as the reference's two branches do: the plain
version casts the softmax probabilities to the page dtype before P.V (the
XLA branch), the kernel keeps them fp32 (the Pallas walk).  With bf16
pages they agree to bf16 tolerance; with fp32 or int8 pages and an fp32
query, to fp32 tolerance.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.models.layers import NEG_INF, _kv_dequantize

MAX_SHARED_BYTES = 48 * 1024

_PAGE_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_Q_KINDS = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the count was last set to 0 (the plain path never counts)
launches = 0


# --------------------------------------------------------------------------
# plain version (the reference's XLA branch)
# --------------------------------------------------------------------------

def paged_attention_scatter_plain(
    q, k_new, v_new, k_pages, v_pages, table, pos, page_idx, off, *,
    k_scale_new=None, v_scale_new=None, k_scale_pages=None, v_scale_pages=None,
    window: int = 0, dequant_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """q: (B,Hkv,G,D) post-RoPE queries; k_new/v_new: (B,Hkv,D) in the page
    dtype; pages: (P,page,Hkv,D), int8 with (P,page,Hkv) fp32 scale pages
    when quantised; table: (B,M); pos/page_idx/off: (B,) int32.  Updates
    the pools in place; returns (B,Hkv,G,D) in q's dtype.  ``dequant_dtype``
    is what int8 pages dequantise into (the XLA branch uses the layer
    input's dtype); q's dtype by default."""
    b, hkv, g, d = q.shape
    page = k_pages.shape[1]
    m = table.shape[1]
    pi, of = page_idx.long(), off.long()
    quant = k_scale_pages is not None
    if quant:
        k_scale_pages[pi, of] = k_scale_new
        v_scale_pages[pi, of] = v_scale_new
    # idle slots may write the same scratch row: no defined winner, never read
    k_pages[pi, of] = k_new
    v_pages[pi, of] = v_new

    t = m * page
    rows = table.long()
    ck = k_pages[rows].reshape(b, t, hkv, d)
    cv = v_pages[rows].reshape(b, t, hkv, d)
    if quant:
        dt = dequant_dtype or q.dtype
        ck = _kv_dequantize(ck, k_scale_pages[rows].reshape(b, t, hkv), dt)
        cv = _kv_dequantize(cv, v_scale_pages[rows].reshape(b, t, hkv), dt)
    s = torch.einsum("bkgd,btkd->bkgt", q.float(), ck.float()) * (1.0 / math.sqrt(d))
    k_pos = torch.arange(t, dtype=torch.int32, device=q.device)
    valid = k_pos[None, :] <= pos[:, None]                     # (B, T)
    if window:
        valid &= k_pos[None, :] > pos[:, None] - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", prob.to(cv.dtype).float(), cv.float())
    return out.to(q.dtype)


# --------------------------------------------------------------------------
# build
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Build ``csrc/paged_attention.cu`` on first use (see
    :mod:`repro_torch.kernels._build`) and declare its C interface."""
    lib = _build.load("paged_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_paged_attention_scatter.argtypes = (
        [i, i] + [p] * 14 + [i] * 8 + [ctypes.c_float, p])
    lib.repro_paged_attention_scatter.restype = i
    lib.repro_paged_attention_shared_bytes.argtypes = [i, i, i]
    lib.repro_paged_attention_shared_bytes.restype = ctypes.c_size_t
    return lib


# --------------------------------------------------------------------------
# wrapper
# --------------------------------------------------------------------------

def _fail(msg: str):
    raise ValueError(f"paged_attention_scatter: {msg}")


def _check_args(q, k_new, v_new, k_pages, v_pages, table, pos, page_idx, off,
                k_scale_new, v_scale_new, k_scale_pages, v_scale_pages) -> None:
    # every launch runs these, so messages are formatted only on failure
    quant = k_scale_pages is not None
    named = dict(q=q, k_new=k_new, v_new=v_new, k_pages=k_pages, v_pages=v_pages,
                 table=table, pos=pos, page_idx=page_idx, off=off)
    if quant:
        named.update(k_scale_new=k_scale_new, v_scale_new=v_scale_new,
                     k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages)
    for name, t in named.items():
        if t is None:
            _fail(f"{name} is missing")
        if t.device != q.device:
            _fail(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            _fail(f"{name} is not contiguous")
    if q.dim() != 4:
        _fail(f"q must be (B,Hkv,G,D), got {tuple(q.shape)}")
    b, hkv, g, d = q.shape
    if q.dtype not in _Q_KINDS:
        _fail(f"q dtype {q.dtype} not in {list(_Q_KINDS)}")
    if k_pages.dtype not in _PAGE_KINDS:
        _fail(f"page dtype {k_pages.dtype} not in {list(_PAGE_KINDS)}")
    if (k_pages.dtype == torch.int8) != quant:
        _fail("int8 pages need scale pages, and only they")
    if k_pages.dim() != 4 or k_pages.shape[2:] != (hkv, d):
        _fail(f"pages must be (P,page,{hkv},{d}), got {tuple(k_pages.shape)}")
    n_pages, page = k_pages.shape[:2]
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
        _fail("k_pages and v_pages differ")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.shape != (b, hkv, d) or t.dtype != k_pages.dtype:
            _fail(f"{name} must be ({b},{hkv},{d}) {k_pages.dtype}, "
                  f"got {tuple(t.shape)} {t.dtype}")
    if quant:
        for name, t in (("k_scale_pages", k_scale_pages), ("v_scale_pages", v_scale_pages)):
            if t.shape != (n_pages, page, hkv) or t.dtype != torch.float32:
                _fail(f"{name} must be ({n_pages},{page},{hkv}) float32")
        for name, t in (("k_scale_new", k_scale_new), ("v_scale_new", v_scale_new)):
            if t.shape != (b, hkv) or t.dtype != torch.float32:
                _fail(f"{name} must be ({b},{hkv}) float32")
    if table.dim() != 2 or table.shape[0] != b or table.shape[1] < 1:
        _fail(f"table must be ({b}, M>=1), got {tuple(table.shape)}")
    for name, t in (("table", table), ("pos", pos), ("page_idx", page_idx), ("off", off)):
        if t.dtype != torch.int32:
            _fail(f"{name} must be int32, got {t.dtype}")
    for name, t in (("pos", pos), ("page_idx", page_idx), ("off", off)):
        if t.shape != (b,):
            _fail(f"{name} must be ({b},), got {tuple(t.shape)}")
    if b < 1 or not 1 <= g <= 32:
        _fail(f"need B >= 1 and 1 <= G <= 32, got B={b} G={g}")
    if not 1 <= d <= 256:
        _fail(f"head dim {d} not in [1, 256]")


def paged_attention_scatter(
    q, k_new, v_new, k_pages, v_pages, table, pos, page_idx, off, *,
    k_scale_new=None, v_scale_new=None, k_scale_pages=None, v_scale_pages=None,
    window: int = 0,
) -> torch.Tensor:
    """Fused decode step: scatter each slot's new K/V row, then attend.

    Shapes as :func:`paged_attention_scatter_plain`.  The pools are updated
    **in place**; returns the (B,Hkv,G,D) output in q's dtype.  CUDA tensors
    go to the kernel (launched on the current stream, not synchronised),
    CPU tensors to the plain version; anything else raises.
    """
    if q.device.type == "cpu":
        return paged_attention_scatter_plain(
            q, k_new, v_new, k_pages, v_pages, table, pos, page_idx, off,
            k_scale_new=k_scale_new, v_scale_new=v_scale_new,
            k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages, window=window)
    if q.device.type != "cuda":
        _fail(f"no kernel for device {q.device}")
    _check_args(q, k_new, v_new, k_pages, v_pages, table, pos, page_idx, off,
                k_scale_new, v_scale_new, k_scale_pages, v_scale_pages)
    lib = build()
    b, hkv, g, d = q.shape
    n_pages, page = k_pages.shape[:2]
    m = table.shape[1]
    smem = lib.repro_paged_attention_shared_bytes(g, d, page)
    if smem > MAX_SHARED_BYTES:
        _fail(f"{smem} bytes of shared memory > {MAX_SHARED_BYTES}")
    out = torch.empty_like(q)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.repro_paged_attention_scatter(
        _PAGE_KINDS[k_pages.dtype], _Q_KINDS[q.dtype], ptr(q), ptr(k_new), ptr(v_new),
        ptr(k_scale_new), ptr(v_scale_new), ptr(k_pages), ptr(v_pages),
        ptr(k_scale_pages), ptr(v_scale_pages), ptr(table), ptr(pos), ptr(page_idx),
        ptr(off), ptr(out), b, n_pages, hkv, g, d, page, m, int(window), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "paged_attention_scatter")
    global launches
    launches += 1
    return out
