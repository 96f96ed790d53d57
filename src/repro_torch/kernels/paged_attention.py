"""Paged-decode attention, its K/V scatter, and the fused step: CUDA kernels + plain versions.

The port of the three TPU kernels of ``repro.kernels.paged_attention``:

* :func:`paged_attention_scatter` (``paged_attention_scatter_pallas``, its
  bf16/fp32 and its int8 variant): one decode step, every slot's new K/V
  row lands in its page, then each slot attends over the pages of its
  page-table row.  The serving engine runs it.
* :func:`paged_attention` (``paged_attention_pallas``): the same walk,
  without the write.
* :func:`paged_scatter` (``paged_scatter_pallas``): the write alone, into 2
  or 4 pools.  Of several rows with one destination the last wins, as on
  the TPU's sequential grid.

The reference reaches the last two through ``repro.kernels.ops`` (ported as
:mod:`repro_torch.kernels.ops`) and holds the fused step bit-equal to
scatter followed by attention.  The three kernels in
``csrc/paged_attention.cu`` share the row write and the walk, and the
plain fused step is the plain scatter followed by the plain attention, so
both hold that by construction.

The walk is split over each slot's live pages (flash-decoding): S blocks
per (slot, kv head), each over a run of C pages, then, when S > 1, a
second launch that merges the S partials in a fixed order.
:func:`split_plan` chooses S and C from the shapes and the card's SM
count alone, the same for the fused and the unfused call, so the two stay
bit-equal and two launches on the same inputs give the same bits.

Each wrapper launches its kernel for CUDA tensors (built for ``sm_90a`` on
first use) or raises, and takes its plain version only for tensors that lie
on the CPU; each counts its launches (:data:`launches` for the fused step,
:data:`attention_launches`, :data:`scatter_launches`), one per call: with
S > 1 an attention call is two CUDA launches on one stream, the walk and
the combine, and counts once.  The plain versions
are copies of the reference's XLA branch (``repro/serve/kvcache.py``:
scatter, gather the whole table row, masked softmax); the CPU tests run
them, and ``chip_smoke.py`` holds the kernels against them on the card.

Pools are updated **in place**.  The attention's two versions differ in
one rounding, as the reference's two branches do: the plain version casts
the softmax probabilities to the page dtype before P.V (the XLA branch),
the kernel keeps them fp32 (the Pallas walk).  With bf16 pages they agree
to bf16 tolerance; with fp32 or int8 pages and an fp32 query, to fp32
tolerance.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.models.layers import NEG_INF, _kv_dequantize

MAX_SHARED_BYTES = 232448     # a block's shared memory on an H100 (opted into above 48 KB)

_PAGE_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_Q_KINDS = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since each count was last set to 0 (the plain paths never count)
launches = 0                  # the fused step
attention_launches = 0
scatter_launches = 0


# --------------------------------------------------------------------------
# plain versions (the reference's XLA branch)
# --------------------------------------------------------------------------

def paged_scatter_plain(pages: Sequence[torch.Tensor], new_rows: Sequence[torch.Tensor],
                        page_idx: torch.Tensor, off: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """pages[i]: (P, page, ...) pools; new_rows[i]: (B, ...) rows;
    page_idx/off: (B,) int32 destinations.  Writes in place and returns the
    pools.  Every row aimed at one destination writes the last such row, so
    one indexed assignment gives the TPU's sequential grid's result, bit for
    bit, whatever order it meets duplicates in (and with no host sync)."""
    pi, of = page_idx.long(), off.long()
    dest = pi * pages[0].shape[1] + of
    rank = torch.arange(dest.shape[0], device=dest.device)
    last = torch.where(dest[:, None] == dest[None, :], rank[None, :], -1).amax(dim=1)
    for pool, rows in zip(pages, new_rows):
        pool[pi, of] = rows[last]
    return tuple(pages)


def paged_attention_plain(
    q, k_pages, v_pages, table, pos, *, k_scale_pages=None, v_scale_pages=None,
    window: int = 0, dequant_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """q: (B,Hkv,G,D) post-RoPE queries; pages: (P,page,Hkv,D), int8 with
    (P,page,Hkv) fp32 scale pages when quantised; table: (B,M); pos: (B,)
    int32.  Returns (B,Hkv,G,D) in q's dtype.  ``dequant_dtype`` is what
    int8 pages dequantise into (the XLA branch uses the layer input's
    dtype); q's dtype by default."""
    b, hkv, g, d = q.shape
    page = k_pages.shape[1]
    m = table.shape[1]
    t = m * page
    rows = table.long()
    ck = k_pages[rows].reshape(b, t, hkv, d)
    cv = v_pages[rows].reshape(b, t, hkv, d)
    if k_scale_pages is not None:
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


def _pools(k_pages, v_pages, k_scale_pages, v_scale_pages, k_new, v_new, k_scale_new,
           v_scale_new):
    """The (pools, rows) pairs a scatter writes: K and V, and their scale
    pools when quantised."""
    if k_scale_pages is None:
        return (k_pages, v_pages), (k_new, v_new)
    return ((k_pages, v_pages, k_scale_pages, v_scale_pages),
            (k_new, v_new, k_scale_new, v_scale_new))


def paged_attention_scatter_plain(
    q, k_new, v_new, k_pages, v_pages, table, pos, page_idx, off, *,
    k_scale_new=None, v_scale_new=None, k_scale_pages=None, v_scale_pages=None,
    window: int = 0, dequant_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The fused step's plain version: :func:`paged_scatter_plain` then
    :func:`paged_attention_plain`.  k_new/v_new: (B,Hkv,D) in the page dtype
    (with (B,Hkv) fp32 scales when quantised); page_idx/off: (B,) int32.
    Updates the pools in place; returns (B,Hkv,G,D) in q's dtype."""
    paged_scatter_plain(*_pools(k_pages, v_pages, k_scale_pages, v_scale_pages, k_new,
                                v_new, k_scale_new, v_scale_new), page_idx, off)
    return paged_attention_plain(q, k_pages, v_pages, table, pos,
                                 k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages,
                                 window=window, dequant_dtype=dequant_dtype)


# --------------------------------------------------------------------------
# the split plan
# --------------------------------------------------------------------------

def max_live_pages(m: int, page: int, window: int) -> int:
    """The most pages a slot's walk covers with a table of ``m`` pages: the
    kernel walks from page ``max(0, pos - window + 1) // page`` (0 without a
    window) to ``min(m - 1, pos // page)``, at most ``ceil((window - 1) /
    page) + 1`` pages under a window, whatever ``pos`` is."""
    if not window:
        return m
    return min(m, -(-(window - 1) // page) + 1)


def split_plan(b: int, hkv: int, m: int, page: int, window: int,
               n_sm: int) -> Tuple[int, int]:
    """(S, C): S blocks per (slot, kv head), block s walking live pages
    ``[j_lo + s*C, j_lo + (s+1)*C)``, so that S * C covers the longest live
    range.  S aims at two blocks per SM over the B * Hkv pairs, and C is the
    fewest pages per block that reaches it.  A function of the shapes alone:
    positions, data and timing never move it.

    The longest live range is taken from the table width ``m``, not from the
    positions.  The engine's decode step clamps the table to the pages of
    its longest live request, so there ``m`` tracks the live context; a
    caller that passes a table much wider than its live pages gets longer
    runs, and fewer blocks that find work, than the card could use."""
    blocks_per_sm = 2
    live = max_live_pages(m, page, window)
    want = max(1, -(-blocks_per_sm * n_sm // (b * hkv)))
    run = max(1, -(-live // want))
    return -(-live // run), run


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_plan(q, k_pages, table, window):
    """The split plan of one launch and its fp32 workspace: (S, C, work),
    work None when S is 1 (the blocks write the output themselves)."""
    b, hkv, g, d = q.shape
    splits, run = split_plan(b, hkv, table.shape[1], k_pages.shape[1], int(window),
                             sm_count(q.device))
    work = (torch.empty(b * hkv * splits * g * (d + 2), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    return splits, run, work


# --------------------------------------------------------------------------
# build
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Build ``csrc/paged_attention.cu`` on first use (see
    :mod:`repro_torch.kernels._build`) and declare its C interface."""
    lib = _build.load("paged_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_paged_attention_scatter.argtypes = [i, i] + [p] * 15 + [i] * 10 + [f, p]
    lib.repro_paged_attention.argtypes = [i, i] + [p] * 9 + [i] * 10 + [f, p]
    lib.repro_paged_scatter.argtypes = [i] + [p] * 10 + [i] * 5 + [p]
    for fn in (lib.repro_paged_attention_scatter, lib.repro_paged_attention,
               lib.repro_paged_scatter):
        fn.restype = i
    lib.repro_paged_attention_shared_bytes.argtypes = [i] * 5
    lib.repro_paged_attention_shared_bytes.restype = ctypes.c_size_t
    return lib


# --------------------------------------------------------------------------
# argument checks (every launch runs them: messages are formatted only on failure)
# --------------------------------------------------------------------------

def _fail(fn: str, msg: str):
    raise ValueError(f"{fn}: {msg}")


def _check_placed(fn: str, device: torch.device, **named) -> None:
    for name, t in named.items():
        if t is None:
            _fail(fn, f"{name} is missing")
        if t.device != device:
            _fail(fn, f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            _fail(fn, f"{name} is not contiguous")


def _check_pools(fn: str, k_pages, v_pages, k_scale_pages, v_scale_pages) -> None:
    """(P,page,Hkv,D) pools of one page dtype; (P,page,Hkv) fp32 scale
    pools exactly when the pages are int8."""
    quant = k_scale_pages is not None
    if k_pages.dtype not in _PAGE_KINDS:
        _fail(fn, f"page dtype {k_pages.dtype} not in {list(_PAGE_KINDS)}")
    if (k_pages.dtype == torch.int8) != quant or (v_scale_pages is None) == quant:
        _fail(fn, "int8 pages need scale pages, and only they")
    if k_pages.dim() != 4:
        _fail(fn, f"pages must be (P,page,Hkv,D), got {tuple(k_pages.shape)}")
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
        _fail(fn, "k_pages and v_pages differ")
    if quant:
        for name, t in (("k_scale_pages", k_scale_pages), ("v_scale_pages", v_scale_pages)):
            if t.shape != k_pages.shape[:3] or t.dtype != torch.float32:
                _fail(fn, f"{name} must be {tuple(k_pages.shape[:3])} float32")
    if not 1 <= k_pages.shape[3] <= 256:
        _fail(fn, f"head dim {k_pages.shape[3]} not in [1, 256]")


def _check_int32(fn: str, b: int, **named) -> None:
    for name, t in named.items():
        if t.dtype != torch.int32:
            _fail(fn, f"{name} must be int32, got {t.dtype}")
        if name != "table" and t.shape != (b,):
            _fail(fn, f"{name} must be ({b},), got {tuple(t.shape)}")


def _check_attention(fn, q, k_pages, v_pages, table, pos, k_scale_pages, v_scale_pages):
    _check_placed(fn, q.device, q=q, k_pages=k_pages, v_pages=v_pages, table=table, pos=pos,
                  **({} if k_scale_pages is None else dict(k_scale_pages=k_scale_pages,
                                                           v_scale_pages=v_scale_pages)))
    if q.dim() != 4:
        _fail(fn, f"q must be (B,Hkv,G,D), got {tuple(q.shape)}")
    b, hkv, g, d = q.shape
    if q.dtype not in _Q_KINDS:
        _fail(fn, f"q dtype {q.dtype} not in {list(_Q_KINDS)}")
    _check_pools(fn, k_pages, v_pages, k_scale_pages, v_scale_pages)
    if k_pages.shape[2:] != (hkv, d):
        _fail(fn, f"pages must be (P,page,{hkv},{d}), got {tuple(k_pages.shape)}")
    if table.dim() != 2 or table.shape[0] != b or table.shape[1] < 1:
        _fail(fn, f"table must be ({b}, M>=1), got {tuple(table.shape)}")
    _check_int32(fn, b, table=table, pos=pos)
    if b < 1 or not 1 <= g <= 32:
        _fail(fn, f"need B >= 1 and 1 <= G <= 32, got B={b} G={g}")


def _check_scatter(fn, k_pages, v_pages, k_scale_pages, v_scale_pages, k_new, v_new,
                   k_scale_new, v_scale_new, page_idx, off):
    quant = k_scale_pages is not None
    named = dict(k_pages=k_pages, v_pages=v_pages, k_new=k_new, v_new=v_new,
                 page_idx=page_idx, off=off)
    if quant:
        named.update(k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages,
                     k_scale_new=k_scale_new, v_scale_new=v_scale_new)
    _check_placed(fn, k_pages.device, **named)
    _check_pools(fn, k_pages, v_pages, k_scale_pages, v_scale_pages)
    b = k_new.shape[0] if k_new.dim() else 0
    hkv, d = k_pages.shape[2:]
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.shape != (b, hkv, d) or t.dtype != k_pages.dtype:
            _fail(fn, f"{name} must be ({b},{hkv},{d}) {k_pages.dtype}, "
                      f"got {tuple(t.shape)} {t.dtype}")
    if quant:
        for name, t in (("k_scale_new", k_scale_new), ("v_scale_new", v_scale_new)):
            if t.shape != (b, hkv) or t.dtype != torch.float32:
                _fail(fn, f"{name} must be ({b},{hkv}) float32")
    _check_int32(fn, b, page_idx=page_idx, off=off)
    if b < 1:
        _fail(fn, "need at least one row")


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def shared_bytes(page_dtype: torch.dtype, g: int, d: int, page: int, run: int) -> int:
    """An attention block's dynamic shared memory, in bytes, for runs of
    ``run`` pages (builds the library on first use)."""
    return build().repro_paged_attention_shared_bytes(_PAGE_KINDS[page_dtype], g, d, page, run)


def _lib_for_attention(fn: str, q, k_pages, run: int) -> ctypes.CDLL:
    smem = shared_bytes(k_pages.dtype, q.shape[2], q.shape[3], k_pages.shape[1], run)
    if smem > MAX_SHARED_BYTES:
        _fail(fn, f"{smem} bytes of shared memory > {MAX_SHARED_BYTES}")
    return build()


def _on_cuda(fn: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        _fail(fn, f"no kernel for device {t.device}")


def paged_attention_scatter(
    q, k_new, v_new, k_pages, v_pages, table, pos, page_idx, off, *,
    k_scale_new=None, v_scale_new=None, k_scale_pages=None, v_scale_pages=None,
    window: int = 0,
) -> torch.Tensor:
    """Fused decode step: scatter each slot's new K/V row, then attend.

    Shapes as :func:`paged_attention_scatter_plain`.  The pools are updated
    **in place**; returns the (B,Hkv,G,D) output in q's dtype.  CUDA tensors
    go to the kernel (launched on the current stream, not synchronised),
    CPU tensors to the plain version; anything else raises.  In the kernel
    each slot writes its row and then reads its own pages, so two slots
    with one destination (idle slots on the scratch page) leave no defined
    winner there; :func:`paged_scatter` defines one.
    """
    fn = "paged_attention_scatter"
    if q.device.type == "cpu":
        return paged_attention_scatter_plain(
            q, k_new, v_new, k_pages, v_pages, table, pos, page_idx, off,
            k_scale_new=k_scale_new, v_scale_new=v_scale_new,
            k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages, window=window)
    _build.refuse_autograd(fn, "paged_attention_scatter_plain", q, k_new, v_new, k_pages,
                           v_pages, k_scale_new, v_scale_new, k_scale_pages, v_scale_pages)
    _on_cuda(fn, q)
    _check_attention(fn, q, k_pages, v_pages, table, pos, k_scale_pages, v_scale_pages)
    _check_scatter(fn, k_pages, v_pages, k_scale_pages, v_scale_pages, k_new, v_new,
                   k_scale_new, v_scale_new, page_idx, off)
    if k_new.shape[0] != q.shape[0]:
        _fail(fn, f"{k_new.shape[0]} new rows for {q.shape[0]} slots")
    splits, run, work = _launch_plan(q, k_pages, table, window)
    lib = _lib_for_attention(fn, q, k_pages, run)
    b, hkv, g, d = q.shape
    n_pages, page = k_pages.shape[:2]
    out = torch.empty_like(q)
    rc = lib.repro_paged_attention_scatter(
        _PAGE_KINDS[k_pages.dtype], _Q_KINDS[q.dtype], _ptr(q), _ptr(k_new), _ptr(v_new),
        _ptr(k_scale_new), _ptr(v_scale_new), _ptr(k_pages), _ptr(v_pages),
        _ptr(k_scale_pages), _ptr(v_scale_pages), _ptr(table), _ptr(pos), _ptr(page_idx),
        _ptr(off), _ptr(out), _ptr(work), b, n_pages, hkv, g, d, page, table.shape[1],
        int(window), splits, run, 1.0 / math.sqrt(d), _stream(q))
    _build.check(lib, rc, fn)
    global launches
    launches += 1
    return out


def paged_attention(q, k_pages, v_pages, table, pos, *, k_scale_pages=None,
                    v_scale_pages=None, window: int = 0) -> torch.Tensor:
    """Decode attention over the pages as they are (read only).  Shapes as
    :func:`paged_attention_plain`; returns (B,Hkv,G,D) in q's dtype.  CUDA
    tensors go to the kernel (launched on the current stream, not
    synchronised), CPU tensors to the plain version; anything else raises."""
    fn = "paged_attention"
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, table, pos,
                                     k_scale_pages=k_scale_pages,
                                     v_scale_pages=v_scale_pages, window=window)
    _build.refuse_autograd(fn, "paged_attention_plain", q, k_pages, v_pages, k_scale_pages,
                           v_scale_pages)
    _on_cuda(fn, q)
    _check_attention(fn, q, k_pages, v_pages, table, pos, k_scale_pages, v_scale_pages)
    splits, run, work = _launch_plan(q, k_pages, table, window)
    lib = _lib_for_attention(fn, q, k_pages, run)
    b, hkv, g, d = q.shape
    n_pages, page = k_pages.shape[:2]
    out = torch.empty_like(q)
    rc = lib.repro_paged_attention(
        _PAGE_KINDS[k_pages.dtype], _Q_KINDS[q.dtype], _ptr(q), _ptr(k_pages), _ptr(v_pages),
        _ptr(k_scale_pages), _ptr(v_scale_pages), _ptr(table), _ptr(pos), _ptr(out),
        _ptr(work), b, n_pages, hkv, g, d, page, table.shape[1], int(window), splits, run,
        1.0 / math.sqrt(d), _stream(q))
    _build.check(lib, rc, fn)
    global attention_launches
    attention_launches += 1
    return out


def paged_scatter(pages: Sequence[torch.Tensor], new_rows: Sequence[torch.Tensor],
                  page_idx: torch.Tensor, off: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Write each slot's new row into its page, in place, and return the
    pools.  ``pages`` is (k_pages, v_pages) or, for int8 pages, (k_pages,
    v_pages, k_scale_pages, v_scale_pages); ``new_rows`` the matching (B,
    ...) rows; page_idx/off: (B,) int32 destinations.  Of several rows with
    one destination the last wins.  CUDA tensors go to the kernel (launched
    on the current stream, not synchronised), CPU tensors to the plain
    version; anything else raises."""
    fn = "paged_scatter"
    if len(pages) not in (2, 4) or len(new_rows) != len(pages):
        _fail(fn, f"need 2 or 4 pools and as many row sets, got {len(pages)} and "
                  f"{len(new_rows)}")
    if pages[0].device.type == "cpu":
        return paged_scatter_plain(pages, new_rows, page_idx, off)
    _build.refuse_autograd(fn, "paged_scatter_plain", *pages, *new_rows)
    _on_cuda(fn, pages[0])
    k_pages, v_pages, k_scale_pages, v_scale_pages = (*pages, None, None)[:4]
    k_new, v_new, k_scale_new, v_scale_new = (*new_rows, None, None)[:4]
    _check_scatter(fn, k_pages, v_pages, k_scale_pages, v_scale_pages, k_new, v_new,
                   k_scale_new, v_scale_new, page_idx, off)
    lib = build()
    n_pages, page, hkv, d = k_pages.shape
    rc = lib.repro_paged_scatter(
        _PAGE_KINDS[k_pages.dtype], _ptr(k_new), _ptr(v_new), _ptr(k_scale_new),
        _ptr(v_scale_new), _ptr(k_pages), _ptr(v_pages), _ptr(k_scale_pages),
        _ptr(v_scale_pages), _ptr(page_idx), _ptr(off), k_new.shape[0], n_pages, hkv, d,
        page, _stream(k_pages))
    _build.check(lib, rc, fn)
    global scatter_launches
    scatter_launches += 1
    return tuple(pages)
