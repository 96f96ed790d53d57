"""The 3xTF32 arithmetic of the port's tensor-core kernels, modelled on the CPU.

``csrc/flash_attention.cu`` and ``csrc/ssd.cu`` run their fp32 products on
the H100's TF32 tensor cores.  One TF32 product rounds each operand to 10
bits of mantissa; the kernels split every fp32 operand x into
hi = tf32(x) and lo = tf32(x - hi) and sum lo.hi + hi.lo + hi.hi
(``csrc/mma.cuh``).  These tests model that rounding in torch, by bit
arithmetic on the fp32 pattern (``cvt.rna``: to nearest, ties away from
zero), with the products then summed in float64, and show at reduced
shapes that the 3x scheme holds the reference's fp32 bars (flash atol 2e-5 /
rtol 2e-4, SSD 2e-4 / 2e-3, ``tests/test_kernels.py``) where one TF32
product does not.  This is the rounding the kernels rely on, checked where
there is no card; the kernels themselves are held to their plain versions
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ssd as SSD

FLASH_TOL = dict(atol=2e-5, rtol=2e-4)
SSD_TOL = dict(atol=2e-4, rtol=2e-3)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> tf32 (10 mantissa bits), to nearest with ties away from zero:
    add half of the 13 dropped bits to the magnitude, then clear them."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x.float() - hi)


def mm_1x(a, b):
    """One TF32 product: operands rounded, products summed exactly."""
    return (tf32(a).double() @ tf32(b).double()).float()


def mm_3x(a, b):
    """The kernels' 3xTF32 product: lo.hi + hi.lo + hi.hi."""
    ah, al = (t.double() for t in split(a))
    bh, bl = (t.double() for t in split(b))
    return (al @ bh + ah @ bl + ah @ bh).float()


def mm_exact(a, b):
    return (a.double() @ b.double()).float()


def test_tf32_rounding_matches_the_instruction():
    """Round to nearest on the 13 dropped bits, ties away from zero; the
    result keeps 10 mantissa bits and hi + lo keeps about 22."""
    one = torch.tensor([1.0])
    ulp = 2.0 ** -10
    cases = torch.tensor([1.0, 1.0 + ulp / 4, 1.0 + ulp / 2, 1.0 + 3 * ulp / 4, -1.0 - ulp / 2,
                          1.0 + ulp * (1 - 2.0 ** -13), 3.0e-3])
    want = torch.tensor([1.0, 1.0, 1.0 + ulp, 1.0 + ulp, -1.0 - ulp, 1.0 + ulp,
                         float(np.float32(3.0e-3))])
    got = tf32(cases)
    torch.testing.assert_close(got[:6], want[:6], atol=0, rtol=0)
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, 4096).astype(np.float32))
    hi, lo = split(x)
    assert float(((hi - x).abs() / x.abs()).max()) <= 2.0 ** -11 * (1 + 1e-6)
    assert float(((hi.double() + lo.double() - x.double()).abs() / x.abs()).max()) < 2.0 ** -21
    assert torch.equal(tf32(one), one)


def attention(q, k, v, mm, causal=True):
    """Attention with its two products through ``mm`` and the softmax in
    fp32: q (S, D), k and v (S, D)."""
    s, d = q.shape
    scores = mm(q, k.T) * (1.0 / math.sqrt(d))
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool).tril()
        scores = torch.where(mask, scores, FA.NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return mm(p, v)


@pytest.mark.parametrize("s,d,causal", [(128, 64, True), (256, 128, True), (128, 64, False)])
def test_three_tf32_products_hold_the_flash_bar_and_one_does_not(s, d, causal):
    rng = np.random.default_rng(60)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (s, d)).astype(np.float32)) for _ in range(3))
    exact = attention(q, k, v, mm_exact, causal)
    torch.testing.assert_close(
        exact, FA.flash_attention_plain(q[None, None], k[None, None], v[None, None],
                                        causal=causal)[0, 0], **FLASH_TOL)
    torch.testing.assert_close(attention(q, k, v, mm_3x, causal), exact, **FLASH_TOL)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(attention(q, k, v, mm_1x, causal), exact, **FLASH_TOL)


def ssd_decomposed(x, dt, a_log, b, c, q, init, mm):
    """The SSD kernels' decomposition (``csrc/ssd.cu``) for one batch row,
    every product through ``mm``: x (S,H,P), dt (S,H), b and c (S,N), init
    (H,P,N).  Returns (y, final state)."""
    s, h, p = x.shape
    nc = -(-s // q)
    pad = nc * q - s
    xp = torch.cat([x, x.new_zeros(pad, h, p)])
    dtp = torch.cat([dt, dt.new_zeros(pad, h)])
    bp = torch.cat([b, b.new_zeros(pad, b.shape[1])])
    cp = torch.cat([c, c.new_zeros(pad, c.shape[1])])
    carry = init.clone()
    ys = []
    causal = torch.ones((q, q), dtype=torch.bool).tril()
    for ci in range(nc):
        rows = slice(ci * q, (ci + 1) * q)
        xc, dc, bc, cc = xp[rows], dtp[rows], bp[rows], cp[rows]
        cb = mm(cc, bc.T)                                     # once for every head
        y = torch.empty(q, h, p)
        for hh in range(h):
            cs = torch.cumsum(dc[:, hh] * a_log[hh], 0)
            xdt = xc[:, hh] * dc[:, hh, None]
            w = torch.where(causal, cb * torch.exp(cs[:, None] - cs[None, :]), 0.0)
            inter = mm(cc, carry[hh].T)
            y[:, hh] = mm(w, xdt) + torch.exp(cs)[:, None] * inter
            local = mm((xdt * torch.exp(cs[-1] - cs)[:, None]).T, bc)
            carry[hh] = carry[hh] * torch.exp(cs[-1]) + local
        ys.append(y)
    return torch.cat(ys)[:s], carry


@pytest.mark.parametrize("s,q,h,p,n", [(200, 64, 2, 32, 64), (128, 128, 2, 64, 128)])
def test_three_tf32_products_hold_the_ssd_bar_and_one_does_not(s, q, h, p, n):
    rng = np.random.default_rng(61)

    def f32(*shape, lo=None, hi=None):
        a = rng.normal(0, 1, shape) if lo is None else rng.uniform(lo, hi, shape)
        return torch.from_numpy(a.astype(np.float32))

    x, b, c = f32(s, h, p), f32(s, n), f32(s, n)
    dt, a_log = f32(s, h, lo=0.001, hi=0.2), -f32(h, lo=1.0, hi=16.0)
    init = 0.1 * f32(h, p, n)
    y, state = ssd_decomposed(x, dt, a_log, b, c, q, init, mm_exact)
    want_y, want_state = SSD.ssd_chunked(x[None], dt[None], a_log, b[None], c[None], q,
                                         init[None])
    torch.testing.assert_close(y, want_y[0], **SSD_TOL)
    torch.testing.assert_close(state, want_state[0], **SSD_TOL)
    y3, state3 = ssd_decomposed(x, dt, a_log, b, c, q, init, mm_3x)
    torch.testing.assert_close(y3, y, **SSD_TOL)
    torch.testing.assert_close(state3, state, **SSD_TOL)
    y1, _ = ssd_decomposed(x, dt, a_log, b, c, q, init, mm_1x)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(y1, y, **SSD_TOL)
