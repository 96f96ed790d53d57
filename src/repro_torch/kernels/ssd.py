"""Mamba-2 SSD chunked scan: CUDA kernel + plain version.

h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ b_t ;  y_t = h_t c_t

The port of ``repro.kernels.ssd.ssd_pallas``, which the reference holds to
``repro.models.ssm.ssd_chunked``.  The TPU kernel starts from a zero state
and returns only ``y``; serving needs the final state and, for a prefill
that continues a cache, an initial one.  Both are part of ``ssd_chunked``'s
contract, and the TPU kernel already carries the state across chunks, so
the port's kernel computes ``ssd_chunked``: ``(y, final_state)`` from an
optional ``init_state``.  With no state given its ``y`` is ``ssd_pallas``'s.

* :func:`ssd_scan` is the wrapper.  For CUDA tensors it launches the kernels
  in ``csrc/ssd.cu`` (built for ``sm_90a`` on first use) or raises; it takes
  the plain version only for tensors that lie on the CPU.  One call is four
  CUDA launches (C.B^T per chunk, the chunk-local states, the carry across
  chunks, the output; three when S fits one chunk, which needs no carry),
  into workspaces it allocates with ``torch.empty``; it counts one launch
  per call in :data:`launches` and never syncs the host.
* :func:`ssd_chunked` is the plain PyTorch version, a copy of the
  reference's; the plain model path (``models/ssm.py``) runs it too.

Layouts are the reference's: x (B,S,H,P); dt (B,S,H) fp32 (post-softplus);
a_log (H,) fp32 (the negative A); b, c (B,S,N), one group shared by every
head; y (B,S,H,P) in x's dtype; states (B,H,P,N) fp32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import is_dtensor
from repro_torch.kernels import _build
from repro_torch.models.layers import NEG_INF

MAX_SHARED_BYTES = 232_448         # what an H100 block may opt in to
MAX_CHUNK = 128                    # rows of a chunk the kernels hold at once

_KINDS = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the count was last set to 0 (the plain path never counts)
launches = 0


# --------------------------------------------------------------------------
# plain version (the reference's ssd_chunked)
# --------------------------------------------------------------------------

def ssd_chunked(x, dt, a_log, b, c, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan: a quadratic part inside each chunk, the (P,N) state
    carried from chunk to chunk.  Returns (y (B,S,H,P) in x's dtype,
    final state (B,H,P,N) fp32).  Positions past S are padded with dt = 0
    and x = b = c = 0, so the final state is the state at position S - 1."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    sp = s + pad
    nc = sp // q
    xq = x.reshape(bsz, nc, q, h, p)
    dtq = dt.reshape(bsz, nc, q, h).float()
    bq = b.reshape(bsz, nc, q, n).float()
    cq = c.reshape(bsz, nc, q, n).float()

    la = dtq * a_log[None, None, None, :]                      # (B,nc,Q,H) <= 0
    cs = torch.cumsum(la, dim=2)                               # inclusive

    # ---- intra-chunk (quadratic within a chunk) ----
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]          # (B,nc,Qi,Qj,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    seg = torch.where(mask[None, None, :, :, None], seg, NEG_INF)
    dec = torch.exp(seg)                                       # masked: exactly 0
    cb = torch.einsum("bcin,bcjn->bcij", cq, bq)               # (B,nc,Qi,Qj)
    xdt = xq.float() * dtq[..., None]                          # (B,nc,Q,H,P)
    y_intra = torch.einsum("bcij,bcijh,bcjhp->bcihp", cb, dec, xdt)

    # ---- per-chunk final states ----
    sdec = torch.exp(cs[:, :, -1:, :] - cs)                    # (B,nc,Q,H)
    s_chunk = torch.einsum("bcjn,bcjh,bcjhp->bchpn", bq, sdec, xdt)

    # ---- inter-chunk recurrence ----
    chunk_dec = torch.exp(cs[:, :, -1, :])                     # (B,nc,H)
    carry = (init_state.float() if init_state is not None
             else torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device))
    prevs = []
    for ci in range(nc):
        prevs.append(carry)                                    # the state *before* chunk ci
        carry = carry * chunk_dec[:, ci, :, None, None] + s_chunk[:, ci]
    prev = torch.stack(prevs, dim=1)                           # (B,nc,H,P,N)

    y_inter = torch.einsum("bcin,bcih,bchpn->bcihp", cq, torch.exp(cs), prev)
    y = (y_intra + y_inter).reshape(bsz, sp, h, p)[:, :s]
    return y.to(x.dtype), carry


# --------------------------------------------------------------------------
# build
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Build ``csrc/ssd.cu`` on first use and declare its C interface."""
    lib = _build.load("ssd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_ssd_scan.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.repro_ssd_scan.restype = i
    lib.repro_ssd_shared_bytes.argtypes = [i, i, i]
    lib.repro_ssd_shared_bytes.restype = ctypes.c_size_t
    return lib


# --------------------------------------------------------------------------
# wrapper
# --------------------------------------------------------------------------

def _fail(msg: str):
    raise ValueError(f"ssd_scan: {msg}")


def _check_args(x, dt, a_log, b, c, chunk, init_state) -> None:
    named = dict(x=x, dt=dt, a_log=a_log, b=b, c=c)
    if init_state is not None:
        named["init_state"] = init_state
    for name, t in named.items():
        if t.device != x.device:
            _fail(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            _fail(f"{name} is not contiguous")
        if name in ("x", "b", "c") and t.data_ptr() % 16:
            _fail(f"{name} is not 16-byte aligned (the kernels copy rows with cp.async)")
    if x.dim() != 4:
        _fail(f"x must be (B,S,H,P), got {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    if x.dtype not in _KINDS:
        _fail(f"x dtype {x.dtype} not in {list(_KINDS)}")
    if b.dim() != 3 or b.shape[:2] != (bsz, s) or c.shape != b.shape:
        _fail(f"b and c must be one ({bsz},{s},N) shape, got {tuple(b.shape)} and "
              f"{tuple(c.shape)}")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        _fail(f"b and c must be {x.dtype}, got {b.dtype} and {c.dtype}")
    n = b.shape[2]
    if dt.shape != (bsz, s, h) or dt.dtype != torch.float32:
        _fail(f"dt must be ({bsz},{s},{h}) float32, got {tuple(dt.shape)} {dt.dtype}")
    if a_log.shape != (h,) or a_log.dtype != torch.float32:
        _fail(f"a_log must be ({h},) float32, got {tuple(a_log.shape)} {a_log.dtype}")
    if init_state is not None and (init_state.shape != (bsz, h, p, n)
                                   or init_state.dtype != torch.float32):
        _fail(f"init_state must be ({bsz},{h},{p},{n}) float32, got "
              f"{tuple(init_state.shape)} {init_state.dtype}")
    if chunk < 1:
        _fail(f"chunk {chunk} < 1")
    if p < 1 or p > 128 or p & (p - 1):
        _fail(f"head dim P {p} must be a power of two <= 128")
    if n < 4 or n % 4:
        _fail(f"state N {n} must be a multiple of 4")
    if not 1 <= bsz <= 65535 or not 1 <= h * -(-p // 32) <= 65535:
        _fail(f"need 1 <= B <= 65535 and 1 <= H * ceil(P / 32) <= 65535 (grid limits), "
              f"got B {bsz}, H {h}, P {p}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, *, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan of :func:`ssd_chunked`: (y (B,S,H,P) in x's dtype, final
    state (B,H,P,N) fp32), from ``init_state`` (zeros when None).  CUDA
    tensors go to the kernel (launched on the current stream, not
    synchronised), CPU tensors to the plain version; anything else raises.
    DTensor arguments run on each rank's local heads (H over the mesh's
    ``'model'`` axis, where it divides H, with dt, a_log and the state;
    else all heads on every rank), b and c whole, a batch split over the
    other mesh axes kept: the heads are independent."""
    if is_dtensor(x):
        from repro_torch.dist.sharding import local_placements, model_size, on_shards

        heads = x.shape[2] % model_size(x.device_mesh) == 0
        px = local_placements(x, model_dim=2 if heads else None, keep=(0,))
        ps = local_placements(x, model_dim=1 if heads else None, keep=(0,))
        pl = (px, local_placements(dt, model_dim=2 if heads else None, keep=(0,)),
              local_placements(a_log, model_dim=0 if heads else None),
              local_placements(b, keep=(0,)), local_placements(c, keep=(0,)),
              None if init_state is None else ps)
        return on_shards(functools.partial(_scan_local, chunk=chunk),
                         (x, dt, a_log, b, c, init_state), pl, (px, ps))
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, a_log, b, c, chunk, init_state)
    _build.refuse_autograd("ssd_scan", "ssd_chunked", x, dt, a_log, b, c, init_state)
    if x.device.type != "cuda":
        _fail(f"no kernel for device {x.device}")
    _check_args(x, dt, a_log, b, c, chunk, init_state)
    bsz, s, h, p = x.shape
    n = b.shape[2]
    y = torch.empty_like(x)
    if s == 0:
        state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
        return y, state if init_state is None else init_state.clone()
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    q = min(chunk, s)
    if q > MAX_CHUNK:
        _fail(f"chunk {q} > {MAX_CHUNK}")
    lib = build()
    smem = lib.repro_ssd_shared_bytes(q, n, p)
    if smem > MAX_SHARED_BYTES:
        _fail(f"{smem} bytes of shared memory > {MAX_SHARED_BYTES}")
    nc = -(-s // q)
    cb = torch.empty((bsz, nc, q, q), dtype=torch.float32, device=x.device)
    chunk_states = torch.empty((bsz, nc, h, p, n), dtype=torch.float32, device=x.device)
    decay = torch.empty((bsz, nc, h), dtype=torch.float32, device=x.device)
    rc = lib.repro_ssd_scan(
        _KINDS[x.dtype], x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
        c.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), state.data_ptr(), cb.data_ptr(), chunk_states.data_ptr(),
        decay.data_ptr(), bsz, s, h, p, n, q, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "ssd_scan")
    global launches
    launches += 1
    return y, state


def _scan_local(x, dt, a_log, b, c, init_state, *, chunk):
    """:func:`ssd_scan` on one rank's local heads (a split of the heads is a
    strided view: the kernels take contiguous rows)."""
    def dense(t):
        return None if t is None else t.contiguous()

    return ssd_scan(dense(x), dense(dt), dense(a_log), dense(b), dense(c), chunk=chunk,
                    init_state=dense(init_state))
