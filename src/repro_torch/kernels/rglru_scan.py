"""RG-LRU linear recurrence ``h_t = a_t * h_{t-1} + b_t``: CUDA kernel + plain version.

The port of ``repro.kernels.rglru_scan.rglru_scan_pallas``, which the
reference holds to ``rglru.linear_scan``, an associative, log-depth scan.
The kernel steps time in order, so the two agree to fp32 rounding, not bit
for bit.

* :func:`rglru_scan` is the wrapper.  For CUDA tensors it launches the
  kernel in ``csrc/rglru_scan.cu`` (built for ``sm_90a`` on first use) or
  raises; it takes the plain version only for tensors that lie on the CPU.
  It counts its launches in :data:`launches`.
* :func:`linear_scan` is the plain PyTorch version, the reference's
  log-depth scan; the plain model path runs it too.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

# kernel launches since the count was last set to 0 (the plain path never counts)
launches = 0


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + b_t along axis 1.  a, b: (B,S,W) fp32.

    Log-depth (Hillis-Steele) scan of the pairs (a, b) under the
    reference's combine ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``.
    Returns (h (B,S,W), final state (B,W))."""
    if h0 is not None:
        # fold the initial state into the first step
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return b, b[:, -1]


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Build ``csrc/rglru_scan.cu`` on first use and declare its C interface."""
    lib = _build.load("rglru_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_rglru_scan.argtypes = [p, p, p, p, i, i, i, p]
    lib.repro_rglru_scan.restype = i
    return lib


def _fail(msg: str):
    raise ValueError(f"rglru_scan: {msg}")


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The recurrence along axis 1 of a, b (B,S,W) from h0 (B,W) (zeros when
    None); returns h (B,S,W) fp32, whose last row is the final state.  CUDA
    tensors go to the kernel (launched on the current stream, not
    synchronised), CPU tensors to the plain version; anything else raises."""
    if a.device.type == "cpu":
        return linear_scan(a, b, h0)[0]
    if a.device.type != "cuda":
        _fail(f"no kernel for device {a.device}")
    named = dict(a=a, b=b) if h0 is None else dict(a=a, b=b, h0=h0)
    for name, t in named.items():
        if t.device != a.device:
            _fail(f"{name} is on {t.device}, a on {a.device}")
        if t.dtype != torch.float32:
            _fail(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            _fail(f"{name} is not contiguous")
    if a.dim() != 3 or b.shape != a.shape:
        _fail(f"a and b must be one (B,S,W) shape, got {tuple(a.shape)} and {tuple(b.shape)}")
    bsz, s, w = a.shape
    if h0 is not None and h0.shape != (bsz, w):
        _fail(f"h0 must be ({bsz},{w}), got {tuple(h0.shape)}")
    if not 1 <= bsz <= 65535:
        _fail(f"batch {bsz} not in [1, 65535]")
    out = torch.empty_like(a)
    if s == 0 or w == 0:
        return out
    lib = build()
    rc = lib.repro_rglru_scan(a.data_ptr(), b.data_ptr(),
                              None if h0 is None else h0.data_ptr(), out.data_ptr(),
                              bsz, s, w, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, rc, "rglru_scan")
    global launches
    launches += 1
    return out
