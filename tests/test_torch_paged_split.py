"""The paged-decode kernel's split plan and its split-then-combine arithmetic, on the CPU.

The CUDA walk runs S blocks per (slot, kv head), block s over live pages
``[j_lo + s*C, min(j_lo + (s+1)*C, j_hi + 1))``, and merges their partial
(m, l, acc) in the order s = 0 .. S-1.  The kernel has no CPU mode, so
these tests hold what surrounds it:

* :func:`repro_torch.kernels.paged_attention.split_plan` at both serving
  paths' shapes: for every position, with and without a window, the S runs
  of C pages cover each live page exactly once; the plan is a function of
  the shapes alone, the same for the fused and the unfused call.
* the arithmetic, through a plain mirror kept in this file (the package
  keeps one plain version per function): the plain attention restricted to
  each split's pages, merged in order with the log-sum-exp rescale, equals
  the unsplit :func:`paged_attention_plain` and the reference's
  ``paged_attention_ref`` on the same numpy inputs, at fp32 atol 2e-5 /
  rtol 2e-4 (summation order).  Cases hold empty splits, a window edge
  inside a split, positions on a page's first and last rows, and an idle
  slot on scratch page 0.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch import bridge
from repro_torch.kernels import paged_attention as PA

F32 = dict(atol=2e-5, rtol=2e-4)
H100_SMS = 132
NEG = -1e30

# (B, Hkv, table width M, page, window): the serving paths' decode shapes
LLAMA = (8, 8, 11, 16, 0)
RGEMMA = (8, 1, 144, 16, 2048)


def live_range(pos: int, m: int, page: int, window: int):
    """The pages the kernel walks for a slot at ``pos``: (j_lo, j_hi)."""
    j_hi = min(m - 1, pos // page)
    j_lo = max(0, pos - window + 1) // page if window else 0
    return j_lo, j_hi


def split_runs(pos: int, m: int, page: int, window: int, splits: int, run: int):
    """Each split block's pages, as the kernel computes them from pos."""
    j_lo, j_hi = live_range(pos, m, page, window)
    return [list(range(j_lo + s * run, min(j_lo + (s + 1) * run, j_hi + 1)))
            for s in range(splits)]


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [
    LLAMA, (8, 8, 9, 16, 0), (8, 8, 11, 16, 64), RGEMMA, (8, 1, 129, 16, 2048),
    (8, 1, 144, 16, 0), (4, 2, 6, 16, 24), (3, 2, 4, 8, 12), (1, 1, 300, 8, 0),
    (64, 8, 11, 16, 0)])
def test_split_runs_cover_every_live_page_once(shape):
    b, hkv, m, page, window = shape
    splits, run = PA.split_plan(b, hkv, m, page, window, H100_SMS)
    assert splits >= 1 and run >= 1
    assert (splits - 1) * run < PA.max_live_pages(m, page, window) <= splits * run
    longest = 0
    for pos in range(0, m * page + 3 * page):
        j_lo, j_hi = live_range(pos, m, page, window)
        walked = [j for r in split_runs(pos, m, page, window, splits, run) for j in r]
        assert walked == list(range(j_lo, j_hi + 1)), pos       # each once, in order
        assert all(len(r) <= run for r in split_runs(pos, m, page, window, splits, run))
        if j_hi >= j_lo:
            # the walked pages hold every unmasked key and no page beyond
            keys = np.arange(pos + 1)
            if window:
                keys = keys[keys > pos - window]
            assert set(np.unique(keys // page)) & set(range(m)) == set(walked), pos
        longest = max(longest, len(walked))
    assert longest == PA.max_live_pages(m, page, window)        # the bound is reached


@pytest.mark.parametrize("shape,want", [
    (RGEMMA, (33, 4)), ((8, 1, 129, 16, 2048), (33, 4)), (LLAMA, (4, 3)),
    ((64, 8, 11, 16, 0), (1, 11)), ((8, 8, 1, 16, 0), (1, 1))])
def test_split_plan_aims_at_two_blocks_per_sm(shape, want):
    """recurrentgemma's longest live range (129 pages) in 33 runs of 4, 264
    blocks; a single split where the slots alone fill the card."""
    b, hkv, m, page, window = shape
    assert PA.split_plan(b, hkv, m, page, window, H100_SMS) == want
    splits, _ = want
    if splits > 1:
        assert b * hkv * splits <= 2 * H100_SMS + b * hkv


def test_split_plan_is_a_function_of_the_shapes_alone(monkeypatch):
    """The fused and the unfused call reach one plan, ``_launch_plan``, from
    the shapes of q, the pages and the table: positions, table entries and
    values never move it."""
    monkeypatch.setattr(PA, "sm_count", lambda device: H100_SMS)
    b, hkv, g, d, page, m = 8, 1, 10, 32, 16, 144
    plans = set()
    for seed in range(3):
        rng = np.random.default_rng(seed)
        q = torch.from_numpy(rng.normal(0, 1, (b, hkv, g, d)).astype(np.float32))
        pages = torch.from_numpy(rng.normal(0, 1, (b * m + 1, page, hkv, d)).astype(np.float32))
        table = torch.from_numpy(rng.integers(0, b * m + 1, (b, m)).astype(np.int32))
        splits, run, work = PA._launch_plan(q, pages, table, 2048)
        plans.add((splits, run, work.numel()))
    assert plans == {(33, 4, b * hkv * 33 * g * (d + 2))}
    q1 = torch.zeros(64, 8, 4, 64)
    assert PA._launch_plan(q1, torch.zeros(9, 16, 8, 64), torch.zeros(64, 11, dtype=torch.int32),
                           0)[2] is None                         # S = 1: no workspace


# --------------------------------------------------------------------------
# split, then combine
# --------------------------------------------------------------------------

def split_then_combine(q, k_pages, v_pages, table, pos, window, splits, run,
                       k_scale_pages=None, v_scale_pages=None):
    """The plain attention over each split's pages, as partial (m, l, acc)
    in fp32, merged in the order s = 0 .. S-1 as the kernel's combine does."""
    b, hkv, g, d = q.shape
    page = k_pages.shape[1]
    m = table.shape[1]
    out = torch.empty(b, hkv, g, d)
    for bi in range(b):
        p0 = int(pos[bi])
        parts = []
        for pages in split_runs(p0, m, page, window, splits, run):
            if not pages:                                       # an empty split
                parts.append(None)
                continue
            rows = table[bi, pages].long()
            k = k_pages[rows].reshape(-1, hkv, d).float()
            v = v_pages[rows].reshape(-1, hkv, d).float()
            if k_scale_pages is not None:
                k = k * k_scale_pages[rows].reshape(-1, hkv)[..., None]
                v = v * v_scale_pages[rows].reshape(-1, hkv)[..., None]
            k_pos = torch.arange(pages[0] * page, (pages[-1] + 1) * page)
            valid = k_pos <= p0
            if window:
                valid &= k_pos > p0 - window
            s = torch.einsum("kgd,tkd->kgt", q[bi].float(), k) / math.sqrt(d)
            s = torch.where(valid, s, torch.tensor(NEG))
            m_s = s.amax(-1)
            p = torch.exp(s - m_s[..., None])
            parts.append((m_s, p.sum(-1), torch.einsum("kgt,tkd->kgd", p, v)))
        full = [x for x in parts if x is not None]
        m_all = torch.stack([x[0] for x in full]).amax(0) if full else torch.full((hkv, g), NEG)
        l_sum = torch.zeros(hkv, g)
        acc = torch.zeros(hkv, g, d)
        for part in parts:                                      # in order, empty ones skipped
            if part is None:
                continue
            m_s, l_s, acc_s = part
            wgt = torch.exp(m_s - m_all)
            l_sum = l_sum + l_s * wgt
            acc = acc + acc_s * wgt[..., None]
        out[bi] = acc / torch.clamp(l_sum, min=1e-20)[..., None]
    return out


def split_case(rng, b, hkv, g, d, page, m, window, quant):
    """Pages from 1, an idle last slot on scratch page 0 at position 0, and
    positions on a page's first and last rows, a short slot with fewer live
    pages than splits, and (with a window) edges that cut a page."""
    n_pages = b * m + 1
    table = rng.permutation(np.arange(1, n_pages)).reshape(b, m).astype(np.int32)
    top = m * page - 1
    pos = rng.integers(0, m * page, b)
    pos[:5] = [page * (m // 2), page * (m // 2) - 1, 3, top, top - page // 2]
    if window:
        pos[5] = min(top, window + page + page // 3)           # j_lo's page partly masked
    table[-1], pos[-1] = 0, 0
    case = dict(q=rng.normal(0, 1, (b, hkv, g, d)).astype(np.float32),
                table=table, pos=pos.astype(np.int32))
    if quant:
        case.update(
            k_pages=rng.integers(-127, 128, (n_pages, page, hkv, d)).astype(np.int8),
            v_pages=rng.integers(-127, 128, (n_pages, page, hkv, d)).astype(np.int8),
            k_scale_pages=rng.uniform(0.005, 0.025, (n_pages, page, hkv)).astype(np.float32),
            v_scale_pages=rng.uniform(0.005, 0.025, (n_pages, page, hkv)).astype(np.float32))
    else:
        case.update(k_pages=rng.normal(0, 1, (n_pages, page, hkv, d)).astype(np.float32),
                    v_pages=rng.normal(0, 1, (n_pages, page, hkv, d)).astype(np.float32))
    return case


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("shape,plan", [
    # (B, Hkv, G, D, page, M, window), and (S, C) or None for split_plan's
    ((8, 8, 4, 16, 16, 11, 0), None),             # llama's decode plan: 4 runs of 3
    ((8, 8, 4, 16, 16, 11, 64), None),
    ((8, 1, 10, 16, 16, 144, 2048), None),        # recurrentgemma's: 33 runs of 4
    ((8, 1, 2, 16, 16, 144, 2048), (3, 43)),      # few long runs
    ((6, 2, 2, 8, 8, 12, 20), (12, 1)),           # one page a run, window cuts pages
    ((6, 2, 2, 8, 8, 12, 0), (1, 12)),            # S = 1: the unsplit walk
])
def test_split_then_combine_equals_the_unsplit_walk_and_the_reference(shape, plan, quant):
    b, hkv, g, d, page, m, window = shape
    splits, run = plan or PA.split_plan(b, hkv, m, page, window, H100_SMS)
    assert splits * run >= PA.max_live_pages(m, page, window)
    np_case = split_case(np.random.default_rng(17), b, hkv, g, d, page, m, window, quant)
    tc = {k: bridge.tensor_from_numpy(v, "cpu") for k, v in np_case.items()}
    scales = {k: tc[k] for k in ("k_scale_pages", "v_scale_pages") if k in tc}
    got = split_then_combine(tc["q"], tc["k_pages"], tc["v_pages"], tc["table"], tc["pos"],
                             window, splits, run, **scales)
    n_empty = sum(not r for p in np_case["pos"]
                  for r in split_runs(int(p), m, page, window, splits, run))
    assert n_empty > 0 or splits == 1
    plain = PA.paged_attention_plain(tc["q"], tc["k_pages"], tc["v_pages"], tc["table"],
                                     tc["pos"], window=window, **scales)
    want = jref.paged_attention_ref(
        jnp.asarray(np_case["q"]), jnp.asarray(np_case["k_pages"]),
        jnp.asarray(np_case["v_pages"]), jnp.asarray(np_case["table"]),
        jnp.asarray(np_case["pos"]), window=window,
        **{k: jnp.asarray(np_case[k]) for k in scales})
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
