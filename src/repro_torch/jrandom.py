"""The draws of ``jax.random`` (jax 0.9.0) on torch tensors, bit for bit.

The reference samples a served token as
``jax.random.categorical(fold_in(key, n), logits / T)``
(``repro.serve.engine``), with raw ``PRNGKey`` arrays.  This module
computes the same draws with torch ops on any device, so that the port
serves the reference's tokens:

* a key is a ``(2,)`` int64 tensor of two uint32 words, the layout of the
  raw ``jax.random.PRNGKey`` array; every 32-bit value is held in int64
  and masked to 32 bits (torch's ``uint32`` has too few ops);
* :func:`threefry2x32` is the Threefry-2x32 hash of ``jax/_src/prng.py``
  (20 rounds, key schedule and rotations as there);
* :func:`bits` uses the partitionable counters
  (``jax_threefry_partitionable``, on by default in jax 0.9.0): element i
  of the row-major flattened shape hashes the counter pair
  ``(i >> 32, i & 0xFFFFFFFF)`` and keeps ``out0 ^ out1``;
* :func:`uniform` follows ``jax.random._uniform`` with
  ``minval = finfo.tiny``: the top mantissa bits over an exponent of 1,
  minus one, then ``max(tiny, f * (1 - tiny) + tiny)`` in the float type,
  fp32 or bf16 (for bf16, as jax, from 8 random bits);
* :func:`gumbel` is mode "low", jax's default: ``-log(-log(u))``;
* :func:`categorical` is the Gumbel-max draw over the last axis, one key
  over the whole shape; :func:`categorical_rows` draws each row with its
  own key over counters ``0 .. V-1``, which equals one :func:`categorical`
  call per row.

Keys, :func:`fold_in`, :func:`bits` and :func:`uniform` equal jax's bit
for bit; ``log`` may differ from XLA's by an ulp, so a Gumbel draw agrees
to about 1e-7 and a token only up to near ties
(``tests/test_torch_jrandom.py``).
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# (bits, mantissa bits) of the logits' float types
_FLOATS = {torch.float32: (32, 23), torch.bfloat16: (16, 7)}
_SIGNED = {32: torch.int32, 16: torch.int16}

Word = Union[int, torch.Tensor]


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as the reference runs it, with 64-bit
    types off (jax's default): any seed that fits a signed 64-bit integer
    keeps its low 32 bits, so the words are ``(0, seed & M)``; outside that
    range jax raises ``OverflowError``, and so does this."""
    if not -(1 << 63) <= seed < 1 << 63:
        raise OverflowError(f"a key's seed is a signed 64-bit integer, got {seed}")
    return torch.tensor([0, seed & M], dtype=torch.int64, device=device)


def threefry2x32(k0: Word, k1: Word, x0: Word, x1: Word):
    """Threefry-2x32 of the counters ``(x0, x1)`` under the key ``(k0, k1)``:
    Python ints or int64 tensors (broadcast) holding values below 2**32."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M
    x1 = (x1 + ks[1]) & M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M
            x1 = (((x1 << r) & M) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M
    return x0, x1


def fold_in(keys: torch.Tensor, data: Word) -> torch.Tensor:
    """``jax.random.fold_in``: keys ``(..., 2)``, data an int or an int64
    tensor broadcast against ``keys[..., 0]``; returns keys ``(..., 2)``."""
    o0, o1 = threefry2x32(keys[..., 0], keys[..., 1], 0, data & M)
    return torch.stack([o0, o1], dim=-1)


def _hash(k0: Word, k1: Word, counters: torch.Tensor) -> torch.Tensor:
    """32 random bits per counter (int64 tensor of flat indices)."""
    o0, o1 = threefry2x32(k0, k1, counters >> 32, counters & M)
    return o0 ^ o1


def bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32), as int64 on the key's device."""
    n = 1
    for s in shape:
        n *= s
    counters = torch.arange(n, dtype=torch.int64, device=key.device)
    return _hash(key[0], key[1], counters).reshape(tuple(shape))


def _uniform_from(raw: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """jax's ``_uniform`` with ``minval = tiny``, ``maxval = 1`` from 32
    random bits per element."""
    nbits, nmant = _FLOATS[dtype]
    rng_bits = 8 if nmant < 8 else nbits           # jax draws 8-bit values for bf16
    one = torch.ones((), dtype=dtype).view(_SIGNED[nbits]).item()
    if rng_bits < 32:
        raw = raw & ((1 << rng_bits) - 1)
    f = ((raw >> (rng_bits - nmant)) | one).to(_SIGNED[nbits]).view(dtype) - 1
    tiny = torch.finfo(dtype).tiny
    lo = torch.full((), tiny, dtype=dtype, device=raw.device)
    span = torch.full((), 1.0, dtype=dtype, device=raw.device) - lo   # maxval - minval
    return torch.maximum(lo, f * span + lo)


def uniform(key: torch.Tensor, shape: Sequence[int],
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval=finfo(dtype).tiny)``,
    the draw under :func:`gumbel`."""
    return _uniform_from(bits(key, shape), dtype)


def _gumbel_from(raw: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return -torch.log(-torch.log(_uniform_from(raw, dtype)))


def gumbel(key: torch.Tensor, shape: Sequence[int],
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, dtype)`` in mode "low"."""
    return _gumbel_from(bits(key, shape), dtype)


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: one key
    draws the whole shape; the first index wins a tie, as ``jnp.argmax``."""
    g = gumbel(key.to(logits.device), logits.shape, logits.dtype)
    return torch.argmax(g + logits, dim=-1)


def categorical_rows(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Row r of ``logits (R, V)`` drawn with ``keys[r]`` (``keys (R, 2)``):
    equal to ``categorical(keys[r], logits[r])`` for every r, in one pass."""
    keys = keys.to(logits.device)
    counters = torch.arange(logits.shape[-1], dtype=torch.int64, device=logits.device)
    raw = _hash(keys[:, :1], keys[:, 1:], counters[None, :])
    return torch.argmax(_gumbel_from(raw, logits.dtype) + logits, dim=-1)
