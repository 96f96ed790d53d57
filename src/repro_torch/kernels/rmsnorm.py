"""RMSNorm forward: CUDA kernel + plain version.

The port of ``repro.kernels.rmsnorm.rmsnorm_pallas``, which the reference
holds to ``layers.apply_norm`` (rmsnorm branch): the mean of squares in
fp32, times ``rsqrt(ms + eps)`` times the scale, cast back to x's dtype.

* :func:`rmsnorm` is the wrapper.  For CUDA tensors it launches the kernel
  in ``csrc/rmsnorm.cu`` (built for ``sm_90a`` on first use) or raises; it
  takes the plain version only for tensors that lie on the CPU.  It counts
  its launches in :data:`launches`.
* :func:`rmsnorm_plain` is the plain PyTorch version (the reference's XLA
  branch); ``layers.apply_norm`` runs it on the plain path, the CPU tests
  hold it to the reference, and ``chip_smoke.py`` holds the kernel to it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_KINDS = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the count was last set to 0 (the plain path never counts)
launches = 0


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); scale: (D,).  Returns x's shape and dtype."""
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * scale.float()
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Build ``csrc/rmsnorm.cu`` on first use and declare its C interface."""
    lib = _build.load("rmsnorm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_rmsnorm.argtypes = [i, i, p, p, p, i, i, ctypes.c_float, p]
    lib.repro_rmsnorm.restype = i
    return lib


def _fail(msg: str):
    raise ValueError(f"rmsnorm: {msg}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis of x (..., D) with scale (D,); returns a new
    tensor of x's shape and dtype.  CUDA tensors go to the kernel (launched
    on the current stream, not synchronised), CPU tensors to the plain
    version; anything else raises."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    if x.device.type != "cuda":
        _fail(f"no kernel for device {x.device}")
    if scale.device != x.device:
        _fail(f"scale is on {scale.device}, x on {x.device}")
    if x.dtype not in _KINDS or scale.dtype not in _KINDS:
        _fail(f"x and scale must be float32 or bfloat16, got {x.dtype} and {scale.dtype}")
    if x.dim() < 1 or scale.shape != x.shape[-1:]:
        _fail(f"scale must be ({x.shape[-1] if x.dim() else '?'},), got {tuple(scale.shape)}")
    if not x.is_contiguous() or not scale.is_contiguous():
        _fail("x and scale must be contiguous")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = build()
    rc = lib.repro_rmsnorm(_KINDS[x.dtype], _KINDS[scale.dtype], x.data_ptr(),
                           scale.data_ptr(), out.data_ptr(), rows, d, eps,
                           torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "rmsnorm")
    global launches
    launches += 1
    return out
