"""RG-LRU linear recurrence ``h_t = a_t * h_{t-1} + b_t``: CUDA kernel + plain version.

The port of ``repro.kernels.rglru_scan.rglru_scan_pallas``, which the
reference holds to ``rglru.linear_scan``, an associative, log-depth scan.
The kernel scans tiles of time in segments with a fixed-order carry, so the
two agree to fp32 rounding, not bit for bit.

* :func:`rglru_scan` is the wrapper.  For CUDA tensors it launches the
  kernel in ``csrc/rglru_scan.cu`` (built for ``sm_90a`` on first use) with
  the plan of :func:`scan_plan`, or raises; it takes the plain version only
  for tensors that lie on the CPU.  It counts its launches in
  :data:`launches`.
* :func:`scan_plan` gives the kernel's grid and tiles for the shapes; the
  cut of a block (:data:`LANES`, :data:`SEGS`, :data:`SEG`, :data:`TILE`)
  is one for every shape.  :func:`scan_model` is a numpy model of the
  kernel's order of floating-point operations.
* :func:`linear_scan` is the plain PyTorch version, the reference's
  log-depth scan; the plain model path runs it too.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import is_dtensor
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import sm_count

# kernel launches since the count was last set to 0 (the plain path never counts)
launches = 0

# the kernel's constants (csrc/rglru_scan.cu)
THREADS = 256         # threads a block: lanes x segments
LANES = 16            # L: width lanes a block (64-byte rows)
SEGS = THREADS // LANES   # G: segments a tile
SEG = 8               # Q: steps a segment, held in registers
TILE = SEGS * SEG     # T: steps a tile
STAGES = 2            # tiles of a and b a block holds in shared memory
# a block's shared memory: the ring (a segment padded by 16 floats), the
# segments' aggregates and the carry
SHARED_BYTES = 4 * (2 * STAGES * SEGS * (SEG * LANES + 16) + 2 * THREADS + LANES)
VEC_BYTES = 16        # one cp.async copy, where W and the pointers allow it
GRID_LIMIT = 2**31 - 1    # blocks a launch's grid.x may hold


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


class Plan(NamedTuple):
    blocks: int         # B * ceil(W / L): a block for each batch row's L lanes
    tiles: int          # ceil(S / T): tiles a block walks in order


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def scan_plan(b: int, s: int, w: int, n_sm: int) -> Plan:
    """The kernel's plan for a, b of (b, s, w) on a card of ``n_sm`` SMs.

    Every shape takes the one cut of a block: 16 lanes, tiles of 128 steps
    in 16 segments of 8, which gives one prompt at W 2560 160 blocks, more
    than an H100's 132 SMs, and makes a 128-token join one tile and a
    2032-token one 16.  (Tiles of 256 steps were measured slower on an H100
    at S 2032: the ring takes longer to fill and to drain.)  Rows past S and
    lanes past W are masked, so ``n_sm`` moves nothing.  A function of the
    shapes alone: data, positions and timing never move it, and the cut
    fixes the order of every floating-point operation (:func:`scan_model`)."""
    return Plan(b * _cdiv(w, LANES), _cdiv(s, TILE))


def scan_model(a: np.ndarray, b: np.ndarray, h0: Optional[np.ndarray]) -> np.ndarray:
    """The kernel's order of floating-point operations, in numpy: a, b
    (B,S,W) and h0 (B,W) (zeros when None) fp32; returns h (B,S,W) fp32.

    Per tile of T = G * Q steps: each segment's aggregate (A, the product of
    its a, rounded at each step; B, its scan from 0), the fixed-order carry
    (segment g's carry-in is the tile's carry-in folded through segments
    0 .. g-1, c <- A_j * c + B_j), the rescan of each segment from its
    carry-in; the last segment's end is the next tile's carry.  Each
    ``fmaf`` is computed in float64 and rounded once to fp32, so the model
    gives the kernel's bits but for rare double roundings."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    bsz, s, w = a.shape
    g_n, q_n, t_n = SEGS, SEG, TILE
    tiles = _cdiv(s, t_n)
    n = tiles * t_n
    # rows past S (the kernel never stores them) as identity steps
    ap = np.ones((bsz, n, w), np.float32)
    bp = np.zeros((bsz, n, w), np.float32)
    ap[:, :s], bp[:, :s] = a, b
    h = np.empty((bsz, n, w), np.float32)
    carry = np.zeros((bsz, w), np.float32) if h0 is None else np.asarray(h0, np.float32)

    def fma(x, y, z):
        return (x.astype(np.float64) * y + z).astype(np.float32)

    for k in range(tiles):
        rows = slice(k * t_n, (k + 1) * t_n)
        ta = ap[:, rows].reshape(bsz, g_n, q_n, w)
        tb = bp[:, rows].reshape(bsz, g_n, q_n, w)
        agg_a, agg_b = ta[:, :, 0], tb[:, :, 0]
        for q in range(1, q_n):
            agg_a = agg_a * ta[:, :, q]
            agg_b = fma(ta[:, :, q], agg_b, tb[:, :, q])
        c = np.empty((bsz, g_n, w), np.float32)
        c[:, 0] = carry
        for g in range(1, g_n):
            c[:, g] = fma(agg_a[:, g - 1], c[:, g - 1], agg_b[:, g - 1])
        out = np.empty((bsz, g_n, q_n, w), np.float32)
        for q in range(q_n):
            c = fma(ta[:, :, q], c, tb[:, :, q])
            out[:, :, q] = c
        carry = c[:, -1]
        h[:, rows] = out.reshape(bsz, t_n, w)
    return h[:, :s]


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Build ``csrc/rglru_scan.cu`` on first use and declare its C interface."""
    lib = _build.load("rglru_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_rglru_scan.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.repro_rglru_scan.restype = i
    lib.repro_rglru_scan_shared_bytes.argtypes = []
    lib.repro_rglru_scan_shared_bytes.restype = ctypes.c_size_t
    return lib


def _fail(msg: str):
    raise ValueError(f"rglru_scan: {msg}")


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The recurrence along axis 1 of a, b (B,S,W) from h0 (B,W) (zeros when
    None); returns h (B,S,W) fp32, whose last row is the final state.  CUDA
    tensors go to the kernel (launched on the current stream, not
    synchronised), CPU tensors to the plain version; anything else raises.
    DTensor a, b and h0 run on each rank's local lanes (W over the mesh's
    ``'model'`` axis, where it divides W; else all lanes on every rank), a
    batch split over the other mesh axes kept: the lanes are independent."""
    if is_dtensor(a):
        from repro_torch.dist.sharding import local_placements, model_size, on_shards

        lanes = a.shape[2] % model_size(a.device_mesh) == 0
        pl = local_placements(a, model_dim=2 if lanes else None, keep=(0,))
        ph = local_placements(h0, model_dim=1 if lanes else None, keep=(0,))
        return on_shards(_scan_local, (a, b, h0), (pl, pl, ph), pl)
    if a.device.type == "cpu":
        return linear_scan(a, b, h0)[0]
    _build.refuse_autograd("rglru_scan", "linear_scan", a, b, h0)
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
    if bsz < 1:
        _fail(f"batch {bsz} is empty")
    pl = scan_plan(bsz, s, w, sm_count(a.device))
    if pl.blocks > GRID_LIMIT:
        _fail(f"{pl.blocks} blocks (B * ceil(W / {LANES})) exceed the grid's {GRID_LIMIT}")
    out = torch.empty_like(a)
    if s == 0 or w == 0:
        return out
    vec = 4 if w % 4 == 0 and all(t.data_ptr() % VEC_BYTES == 0 for t in (a, b)) else 1
    lib = build()
    rc = lib.repro_rglru_scan(a.data_ptr(), b.data_ptr(),
                              None if h0 is None else h0.data_ptr(), out.data_ptr(),
                              bsz, s, w, vec,
                              torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, rc, "rglru_scan")
    global launches
    launches += 1
    return out


def _scan_local(a, b, h0):
    """:func:`rglru_scan` on one rank's local lanes (a split of the lanes is
    a strided view: the kernel takes contiguous rows)."""
    return rglru_scan(a.contiguous(), b.contiguous(), None if h0 is None else h0.contiguous())
