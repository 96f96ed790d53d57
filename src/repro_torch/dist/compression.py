"""int8 gradient compression for cross-pod reductions, ported from
``repro.dist.compression``.

The cross-pod hop is the slowest wire in a multi-pod system — exactly where
the paper finds the longest slack.  ``compressed_psum`` cuts that wire 4x
by quantizing each gradient leaf to int8 with one per-leaf fp32 scale,
all-gathering the (int8, scale) pairs over the group, and
dequantize-summing locally.  The gather goes through the
COUNTDOWN-instrumented ``cd_all_gather``, so the artificial barrier and the
slack accounting apply to the compressed path too.

Quantization is symmetric round-to-nearest (half to even, as ``jnp.round``)
at ``scale = max|g| / 127``: the roundtrip error per element is at most
``scale / 2`` (1/2 LSB).  Gradient *sums* stay exact in fp32 after
dequantization; only the per-rank representation is lossy.  The
reference's mesh axis is a ``torch.distributed`` group here (``None``: the
world).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core.instrument import (
    AsyncCollective, Group, cd_all_gather, cd_all_gather_async, cd_wait,
)
from repro_torch.tree import leaves, unflatten


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """g -> (int8 codes, fp32 scale) with |codes * scale - g| <= scale/2."""
    g32 = g.float()
    # a 0-d tensor, not a Python number: a CUDA tensor divided by a Python
    # number is multiplied by its reciprocal, which rounds differently
    scale = torch.max(torch.abs(g32)) / torch.tensor(127.0, device=g32.device)
    scale = torch.clamp(scale, min=1e-30)
    q = torch.clamp(torch.round(g32 / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _dequantize_sum(flat, tree, gathered, mean: bool) -> Any:
    """Dequantize the gathered (codes, scales) pairs and reduce in fp32."""
    n_leaf = len(flat)
    codes, scales = gathered[:n_leaf], gathered[n_leaf:]
    out = []
    for g, q_all, s_all in zip(flat, codes, scales):
        n_shards = q_all.shape[0]
        w = s_all.reshape((n_shards,) + (1,) * g.dim())
        total = torch.sum(q_all.float() * w, dim=0)
        if mean:
            total = total / torch.tensor(n_shards, dtype=torch.float32, device=total.device)
        out.append(total.to(g.dtype))
    return unflatten(tree, out)


def compressed_psum(grads: Any, group: Group = None, mean: bool = False) -> Any:
    """Sum (or mean) a gradient tree over ``group`` on an int8 wire.

    Per leaf: quantize locally, all-gather codes+scales over the group (one
    instrumented collective for the whole tree — a single barrier, like the
    fused flat all-reduce it replaces), then dequantize and reduce in fp32.
    Leaves come back in their original dtype.
    """
    flat = leaves(grads)
    qs = [_quantize(g) for g in flat]
    gathered = cd_all_gather([q for q, _ in qs] + [s for _, s in qs], group, tiled=False)
    return _dequantize_sum(flat, grads, gathered, mean)


class CompressedPsumHandle(NamedTuple):
    """In-flight :func:`compressed_psum_start`; close with ``_wait``."""

    gather: AsyncCollective
    flat: Any
    tree: Any
    mean: bool


def compressed_psum_start(grads: Any, group: Group = None,
                          mean: bool = False) -> CompressedPsumHandle:
    """Nonblocking :func:`compressed_psum`: quantize and *dispatch* the
    int8 gather through the async 5-phase pair (``cd_all_gather_async``).

    The caller overlaps independent compute between start and
    :func:`compressed_psum_wait`; the instrumented events mark that window
    ``dispatch_enter -> wait_enter``, so every subscriber accounts it as
    busy overlap, not slack.
    """
    flat = leaves(grads)
    qs = [_quantize(g) for g in flat]
    gather = cd_all_gather_async([q for q, _ in qs] + [s for _, s in qs], group,
                                 tiled=False)
    return CompressedPsumHandle(gather, flat, grads, mean)


def compressed_psum_wait(handle: CompressedPsumHandle) -> Any:
    """Block on a :func:`compressed_psum_start` and finish the reduction."""
    gathered = cd_wait(handle.gather)
    return _dequantize_sum(handle.flat, handle.tree, gathered, handle.mean)


def compression_ratio(grads: Any) -> float:
    """Wire-bytes ratio of the int8 codec vs the raw dtype (for benchmarks)."""
    flat = leaves(grads)
    raw = sum(g.numel() * g.element_size() for g in flat)
    comp = sum(g.numel() * 1 + 4 for g in flat)          # int8 codes + fp32 scale
    return raw / max(comp, 1)
