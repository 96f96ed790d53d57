"""RMSNorm forward: CUDA kernel + plain version.

The port of ``repro.kernels.rmsnorm.rmsnorm_pallas``, which the reference
holds to ``layers.apply_norm`` (rmsnorm branch): the mean of squares in
fp32, times ``rsqrt(ms + eps)`` times the scale, cast back to x's dtype.

* :func:`rmsnorm` is the wrapper.  For CUDA tensors it launches the kernel
  in ``csrc/rmsnorm.cu`` (built for ``sm_90a`` on first use) with the
  launch plan of :func:`plan`, or raises; it takes the plain version only
  for tensors that lie on the CPU.  It counts its launches in
  :data:`launches`.
* :func:`plan` picks the kernel's shape from the row width alone: a row a
  CTA, a row too wide for one CTA cut over a thread block cluster.
* :func:`rmsnorm_plain` is the plain PyTorch version (the reference's XLA
  branch); ``layers.apply_norm`` runs it on the plain path, the CPU tests
  hold it to the reference, and ``chip_smoke.py`` holds the kernel to it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_KINDS = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the count was last set to 0 (the plain path never counts)
launches = 0

VEC_BYTES = 16        # one vector load of x
MAX_THREADS = 512     # threads a CTA (the kernel's launch bound)
MAX_VPT = 8           # vectors a thread holds in registers
MAX_ELEMS = 32        # elements a thread holds: x and an fp32 scale fit without spills
MAX_CLUSTER = 8       # CTAs a cluster (the portable maximum)


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); scale: (D,).  Returns x's shape and dtype."""
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * scale.float()
    return y.to(x.dtype)


class Plan(NamedTuple):
    vec: int            # elements a load: 16 bytes of x, or 1 (scalars)
    vpt: int            # loads a thread holds: 1, 2, 4 or 8
    threads: int        # threads a CTA, a multiple of 32
    cluster: int        # CTAs a row: 1, 2, 4 or 8; the grid is rows * cluster


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(d: int, itemsize: int, aligned: bool = True) -> Plan:
    """The kernel's launch plan for rows of ``d`` elements of ``itemsize``
    bytes; ``aligned``: x, scale and out start on 16 bytes.

    A row is one CTA of the fewest warps that hold it at up to 8 vectors and
    32 elements a thread; a row wider than one CTA of 512 threads holds is
    cut over a cluster of 2-8 CTAs; a row wider than 8 such CTAs is
    refused."""
    width = VEC_BYTES // itemsize
    vec = width if aligned and d % width == 0 else 1
    nvec = d // vec
    most = min(MAX_VPT, MAX_ELEMS // vec)             # vectors a thread
    cluster = 1
    while _cdiv(nvec, cluster) > MAX_THREADS * most and cluster < MAX_CLUSTER:
        cluster *= 2
    span = _cdiv(nvec, cluster)
    if span > MAX_THREADS * most:
        raise ValueError(f"rmsnorm: rows of {d} elements exceed the kernel's "
                         f"{MAX_CLUSTER * MAX_THREADS * most * vec}")
    threads = 32 * _cdiv(span, 32 * most)
    return Plan(vec, _pow2(_cdiv(span, threads)), threads, cluster)


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Build ``csrc/rmsnorm.cu`` on first use and declare its C interface."""
    lib = _build.load("rmsnorm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_rmsnorm.argtypes = [i, i, p, p, p, i, i, ctypes.c_float, i, i, i, i, p]
    lib.repro_rmsnorm.restype = i
    lib.repro_empty.argtypes = [p]
    lib.repro_empty.restype = i
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
    _build.refuse_autograd("rmsnorm", "rmsnorm_plain", x, scale)
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
    aligned = all(t.data_ptr() % VEC_BYTES == 0 for t in (x, scale, out))
    pl = plan(d, x.element_size(), aligned)
    lib = build()
    rc = lib.repro_rmsnorm(_KINDS[x.dtype], _KINDS[scale.dtype], x.data_ptr(),
                           scale.data_ptr(), out.data_ptr(), rows, d, eps, pl.vec, pl.vpt,
                           pl.threads, pl.cluster, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "rmsnorm")
    global launches
    launches += 1
    return out


def empty(device) -> None:
    """Launch an empty kernel of one warp on ``device``'s current stream:
    the launch floor beside the launch-bound calls (not counted)."""
    lib = build()
    _build.check(lib, lib.repro_empty(torch.cuda.current_stream(device).cuda_stream), "empty")
