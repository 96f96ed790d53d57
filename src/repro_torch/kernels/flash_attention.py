"""Prefill attention, causal or full, with an optional sliding window: CUDA
flash kernel + plain version.

The port of ``repro.kernels.flash_attention.flash_attention_pallas``, which
the reference holds to ``ref.attention_ref`` and
``layers.chunked_causal_attention`` / ``attention_forward``.  q: (B,Hq,S,D);
k, v: (B,Hkv,S,D) with Hq a multiple of Hkv (GQA: query head h reads kv head
``h // (Hq // Hkv)``).  Keys are masked by index, 0..S-1: key j is seen by
query i when j <= i (``causal``) and j > i - window (``window`` > 0), as
``ref.attention_ref`` masks them.  (Without the causal mask the TPU kernel
also lets the zero keys it pads S with take softmax weight when S is not a
multiple of its key block; the port follows the oracle, not that padding.)

* :func:`flash_attention` is the wrapper.  For CUDA tensors it launches the
  kernel in ``csrc/flash_attention.cu`` (built for ``sm_90a`` on first use)
  or raises; it takes the plain version only for tensors that lie on the
  CPU.  It counts its launches in :data:`launches`.  Given ``positions``,
  it checks that they are ``arange(S)`` (a host sync) and raises otherwise:
  the kernel has no positions argument, and there is no fallback.  With no
  ``positions`` the wrapper never syncs the host.
* :func:`flash_attention_plain` is the plain PyTorch version: materialised
  fp32 scores, the same index mask, softmax, P.V in fp32.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.device import is_dtensor
from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
_KINDS = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the count was last set to 0 (the plain path never counts)
launches = 0


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """Shapes as :func:`flash_attention`; returns (B,Hq,S,D) in q's dtype."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    qg = q.float().reshape(b, hkv, hq // hkv, s, d)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * (1.0 / math.sqrt(d))
    pos = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return out.reshape(b, hq, s, d).to(q.dtype)


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Build ``csrc/flash_attention.cu`` on first use and declare its C interface."""
    lib = _build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_flash_attention.argtypes = [i, p, p, p, p] + [i] * 7 + [ctypes.c_float, p]
    lib.repro_flash_attention.restype = i
    return lib


def _fail(msg: str):
    raise ValueError(f"flash_attention: {msg}")


def _check_positions(positions: torch.Tensor, s: int) -> None:
    want = torch.arange(s, dtype=positions.dtype, device=positions.device)
    if positions.shape != (s,) or not torch.equal(positions, want):
        _fail("the kernel masks keys by index: positions must be arange(S)")


def flash_attention(q, k, v, *, positions: Optional[torch.Tensor] = None,
                    window: int = 0, causal: bool = True) -> torch.Tensor:
    """Attention of q (B,Hq,S,D) over k, v (B,Hkv,S,D), causal unless
    ``causal`` is False and, with ``window`` > 0, sliding-window, by index.
    Returns (B,Hq,S,D) in q's dtype.  CUDA tensors go to the kernel
    (launched on the current stream, not synchronised), CPU tensors to the
    plain version; anything else raises.  DTensor q, k and v run on each
    rank's local heads when the mesh's ``'model'`` axis divides Hq and Hkv
    (GQA groups stay whole on a rank); with one KV head, on each rank's
    query heads against the whole K and V where the axis divides Hq; else
    on all heads.  A batch split over the other mesh axes is kept."""
    if is_dtensor(q):
        from repro_torch.dist.sharding import local_placements, model_size, on_shards

        mp = model_size(q.device_mesh)
        split_q = q.shape[1] % mp == 0 and (k.shape[1] % mp == 0 or k.shape[1] == 1)
        split_kv = split_q and k.shape[1] % mp == 0
        pq = local_placements(q, model_dim=1 if split_q else None, keep=(0,))
        pkv = local_placements(k, model_dim=1 if split_kv else None, keep=(0,))
        fn = functools.partial(flash_attention, positions=positions, window=window,
                               causal=causal)
        return on_shards(fn, (q, k, v), (pq, pkv, pkv), pq)
    if q.dim() != 4:
        _fail(f"q must be (B,Hq,S,D), got {tuple(q.shape)}")
    if positions is not None:
        _check_positions(positions, q.shape[2])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    _build.refuse_autograd("flash_attention", "flash_attention_plain", q, k, v)
    if q.device.type != "cuda":
        _fail(f"no kernel for device {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            _fail(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            _fail(f"{name} is {t.dtype}, q {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            _fail(f"{name} is not contiguous")
        if t.data_ptr() % 16:
            _fail(f"{name} is not 16-byte aligned (the kernel copies rows with cp.async)")
    if q.dtype not in _KINDS:
        _fail(f"dtype {q.dtype} not in {list(_KINDS)}")
    b, hq, s, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[2:] != (s, d) or v.shape != k.shape:
        _fail(f"k and v must be ({b},Hkv,{s},{d}), got {tuple(k.shape)} and {tuple(v.shape)}")
    hkv = k.shape[1]
    if hkv < 1 or hq % hkv:
        _fail(f"Hq {hq} is not a multiple of Hkv {hkv}")
    if d % 4 or not 4 <= d <= MAX_HEAD_DIM:
        _fail(f"head dim {d} must be a multiple of 4 in [4, {MAX_HEAD_DIM}]")
    if not 1 <= b <= 65535 or hq > 65535 or window < 0:
        _fail(f"need 1 <= B <= 65535, Hq <= 65535 and window >= 0, got {b}, {hq}, {window}")
    out = torch.empty_like(q)
    if s == 0:
        return out
    lib = build()
    rc = lib.repro_flash_attention(
        _KINDS[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, hq, hkv, s, d, int(window), int(bool(causal)), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "flash_attention")
    global launches
    launches += 1
    return out
