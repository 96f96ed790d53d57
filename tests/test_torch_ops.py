"""``repro_torch.kernels.ops`` against ``repro.kernels.ops``, function by function, on the CPU.

The ten functions of the reference's kernel surface, each fed the same
numpy-seeded inputs in both packages.  The reference runs its Pallas
kernels in interpret mode, as ``tests/test_kernels.py`` runs them; the
port's wrappers take their plain versions for CPU tensors (the kernels are
held to those on the card by ``chip_smoke.py`` and ``test_torch_cuda.py``).
Tolerances are the reference's own bars in ``tests/test_kernels.py``:
fp32 2e-5 / 2e-4 (RMSNorm 2e-5 / 2e-5), bf16 3e-2 (RMSNorm 2e-2), SSD fp32
2e-4 / 2e-3 and bf16 3e-1 / 5e-2.  Scatters are bit-equal, a
duplicate-destination case included (the last row wins, as on the TPU's
sequential grid), and the fused step is bit-equal to scatter followed by
attention, as the reference holds its kernels.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import bridge
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as PA

F32 = dict(atol=2e-5, rtol=2e-4)


def t(a):
    return bridge.tensor_from_numpy(np.asarray(a), "cpu")


def f32(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else a, np.float32)


def both(a, dtype=jnp.float32):
    """One numpy array as a JAX array and a CPU tensor of the same bits."""
    j = jnp.asarray(a, dtype)
    return j, t(j)


def launch_counts():
    return (PA.launches, PA.attention_launches, PA.scatter_launches)


# --------------------------------------------------------------------------
# RMSNorm, flash attention, SSD, RG-LRU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 128), (3, 17, 256)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rmsnorm(shape, dtype):
    rng = np.random.default_rng(50)
    jx, tx = both(rng.normal(0, 2, shape), dtype)
    js, ts = both(rng.normal(1, 0.2, shape[-1:]), dtype)
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == jnp.bfloat16 else dict(atol=2e-5, rtol=2e-5)
    got = tops.rmsnorm(tx, ts)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(f32(got), f32(jops.rmsnorm(jx, js, row_block=8)), **tol)


@pytest.mark.parametrize("b,hq,hkv,s,d,window", [
    (1, 4, 4, 64, 32, 0), (2, 8, 2, 96, 64, 0), (1, 4, 1, 128, 32, 0), (1, 4, 2, 128, 32, 48),
])
def test_flash_attention(b, hq, hkv, s, d, window):
    rng = np.random.default_rng(51)
    jq, tq = both(rng.normal(0, 1, (b, hq, s, d)))
    jk, tk = both(rng.normal(0, 1, (b, hkv, s, d)))
    jv, tv = both(rng.normal(0, 1, (b, hkv, s, d)))
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window, block_q=32, block_k=32)
    np.testing.assert_allclose(f32(tops.flash_attention(tq, tk, tv, window=window)),
                               f32(want), **F32)


def test_flash_attention_bf16_and_causal_only():
    """bf16, causal and (since the port's kernel gained the mode) non-causal,
    against the reference's kernel at S a multiple of its key block."""
    rng = np.random.default_rng(52)
    jq, tq = both(rng.normal(0, 1, (1, 4, 64, 32)), jnp.bfloat16)
    jk, tk = both(rng.normal(0, 1, (1, 2, 64, 32)), jnp.bfloat16)
    jv, tv = both(rng.normal(0, 1, (1, 2, 64, 32)), jnp.bfloat16)
    for causal in (True, False):
        want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=32, block_k=32)
        got = tops.flash_attention(tq, tk, tv, causal=causal)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(f32(got), f32(want), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("b,hq,hkv,s,d,window", [
    (1, 4, 4, 64, 32, 0), (2, 8, 2, 96, 64, 0), (1, 4, 2, 128, 32, 48), (1, 10, 1, 64, 32, 16),
])
def test_flash_attention_non_causal(b, hq, hkv, s, d, window):
    """``causal=False`` with and without a window, against the reference's
    Pallas kernel in interpret mode at S a multiple of its 32-key block."""
    rng = np.random.default_rng(55)
    jq, tq = both(rng.normal(0, 1, (b, hq, s, d)))
    jk, tk = both(rng.normal(0, 1, (b, hkv, s, d)))
    jv, tv = both(rng.normal(0, 1, (b, hkv, s, d)))
    want = jops.flash_attention(jq, jk, jv, causal=False, window=window, block_q=32,
                                block_k=32)
    got = tops.flash_attention(tq, tk, tv, causal=False, window=window)
    np.testing.assert_allclose(f32(got), f32(want), **F32)
    causal = tops.flash_attention(tq, tk, tv, window=window)
    assert not np.allclose(f32(causal), f32(want), **F32)


@pytest.mark.parametrize("s,window", [(45, 0), (45, 16), (77, 0), (77, 40)])
def test_flash_attention_non_causal_ragged_matches_oracle(s, window):
    """At an S that is not a multiple of the key block the port is held to
    the oracle, ``ref.attention_ref(causal=False)``, and not to the
    reference's Pallas kernel: that kernel pads K/V with zero keys and masks
    them only through its causal mask (``flash_attention.py:87-93``), so in
    non-causal mode the padded keys take softmax weight and its output moves
    away from the oracle (by 0.19 at S 45 with blocks of 32 on these inputs,
    0.62 with a window of 16).  The port masks keys by index up to S - 1 in
    both modes."""
    rng = np.random.default_rng(56)
    jq, tq = both(rng.normal(0, 1, (2, 4, s, 32)))
    jk, tk = both(rng.normal(0, 1, (2, 2, s, 32)))
    jv, tv = both(rng.normal(0, 1, (2, 2, s, 32)))
    want = jref.attention_ref(jq, jk, jv, causal=False, window=window)
    got = tops.flash_attention(tq, tk, tv, causal=False, window=window)
    np.testing.assert_allclose(f32(got), f32(want), **F32)


@pytest.mark.parametrize("s,chunk", [(64, 16), (100, 32), (32, 32)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ssd_scan(s, chunk, dtype):
    rng = np.random.default_rng(53)
    b, h, p, n = 2, 3, 16, 8
    jx, tx = both(rng.normal(0, 1, (b, s, h, p)), dtype)
    jdt, tdt = both(rng.uniform(0.01, 0.5, (b, s, h)))
    ja, ta = both(-rng.uniform(0.5, 2.0, (h,)))
    jb, tb = both(rng.normal(0, 1, (b, s, n)), dtype)
    jc, tc = both(rng.normal(0, 1, (b, s, n)), dtype)
    want = jops.ssd_scan(jx, jdt, ja, jb, jc, chunk=chunk)
    got = tops.ssd_scan(tx, tdt, ta, tb, tc, chunk=chunk)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = dict(atol=3e-1, rtol=5e-2) if dtype == jnp.bfloat16 else dict(atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(f32(got), f32(want), **tol)


@pytest.mark.parametrize("s,w", [(64, 96), (50, 64)])
def test_rglru_scan(s, w):
    rng = np.random.default_rng(54)
    ja, ta = both(rng.uniform(0.3, 0.999, (2, s, w)))
    jb, tb = both(rng.normal(0, 0.3, (2, s, w)))
    jh, th = both(rng.normal(0, 1, (2, w)))
    want = jops.rglru_scan(ja, jb, jh, chunk=16, width_block=32)
    np.testing.assert_allclose(f32(tops.rglru_scan(ta, tb, th)), f32(want), **F32)


# --------------------------------------------------------------------------
# paged decode attention, scatter, and the fused step
# --------------------------------------------------------------------------

def paged_case(rng, b, hkv, g, d, page, m, n_pages, quant):
    """The reference's ``_paged_case`` draws, as numpy arrays."""
    q = rng.normal(0, 1, (b, hkv, g, d)).astype(np.float32)
    if b * m <= n_pages:
        table = rng.choice(n_pages, size=(b, m), replace=False).reshape(b, m)
    else:
        table = rng.integers(0, n_pages, (b, m))
    pos = rng.integers(0, m * page, (b,))
    case = dict(q=q, table=table.astype(np.int32), pos=pos.astype(np.int32))
    if quant:
        case.update(
            k_pages=rng.integers(-127, 128, (n_pages, page, hkv, d)).astype(np.int8),
            v_pages=rng.integers(-127, 128, (n_pages, page, hkv, d)).astype(np.int8),
            k_scale_pages=rng.uniform(1e-3, 0.1, (n_pages, page, hkv)).astype(np.float32),
            v_scale_pages=rng.uniform(1e-3, 0.1, (n_pages, page, hkv)).astype(np.float32))
    else:
        case.update(k_pages=rng.normal(0, 1, (n_pages, page, hkv, d)).astype(np.float32),
                    v_pages=rng.normal(0, 1, (n_pages, page, hkv, d)).astype(np.float32))
    return case


def new_rows(rng, b, hkv, d, quant):
    if quant:
        return dict(k_new=rng.integers(-127, 128, (b, hkv, d)).astype(np.int8),
                    v_new=rng.integers(-127, 128, (b, hkv, d)).astype(np.int8),
                    k_scale_new=rng.uniform(1e-3, 0.1, (b, hkv)).astype(np.float32),
                    v_scale_new=rng.uniform(1e-3, 0.1, (b, hkv)).astype(np.float32))
    return dict(k_new=rng.normal(0, 1, (b, hkv, d)).astype(np.float32),
                v_new=rng.normal(0, 1, (b, hkv, d)).astype(np.float32))


def tensors(case):
    return {k: t(v) for k, v in case.items()}


@pytest.mark.parametrize("b,hkv,g,d,page,m,window,quant", [
    (2, 2, 4, 32, 8, 4, 0, False),     # GQA
    (3, 1, 4, 32, 8, 5, 0, False),     # MQA, non-pow2 table width
    (2, 4, 1, 32, 16, 3, 0, False),    # MHA
    (2, 2, 2, 32, 8, 4, 12, False),    # sliding window
    (2, 2, 4, 32, 8, 5, 0, True),      # int8 pages, fused dequant
    (2, 2, 2, 32, 8, 4, 12, True),     # int8 + window
])
def test_paged_attention(b, hkv, g, d, page, m, window, quant):
    c = paged_case(np.random.default_rng(55), b, hkv, g, d, page, m, 32, quant)
    tc = tensors(c)
    before = launch_counts()
    if quant:
        want = jops.paged_attention_quant(
            *(jnp.asarray(c[k]) for k in ("q", "k_pages", "v_pages", "k_scale_pages",
                                          "v_scale_pages", "table", "pos")), window=window)
        got = tops.paged_attention_quant(
            *(tc[k] for k in ("q", "k_pages", "v_pages", "k_scale_pages", "v_scale_pages",
                              "table", "pos")), window=window)
    else:
        want = jops.paged_attention(*(jnp.asarray(c[k]) for k in
                                      ("q", "k_pages", "v_pages", "table", "pos")),
                                    window=window)
        got = tops.paged_attention(*(tc[k] for k in ("q", "k_pages", "v_pages", "table", "pos")),
                                   window=window)
    assert launch_counts() == before                  # CPU: never a kernel
    np.testing.assert_allclose(f32(got), f32(want), **F32)
    for k in ("k_pages", "v_pages"):                  # read only
        assert np.array_equal(tc[k].numpy(), c[k])


@pytest.mark.parametrize("page_idx,off", [
    ([3, 7, 1, 10], [0, 5, 7, 2]),     # distinct destinations
    ([0, 7, 0, 0], [0, 5, 0, 0]),      # three rows on the scratch row: the last wins
    ([4, 4, 9, 4], [6, 6, 1, 6]),
])
def test_paged_scatter_bit_equal(page_idx, off):
    rng = np.random.default_rng(56)
    n_pages, page, hkv, d, b = 12, 8, 2, 16, 4
    kp = rng.normal(0, 1, (n_pages, page, hkv, d)).astype(np.float32)
    vp = rng.normal(0, 1, (n_pages, page, hkv, d)).astype(np.float32)
    rows = new_rows(rng, b, hkv, d, False)
    pi, of = np.asarray(page_idx, np.int32), np.asarray(off, np.int32)
    want = jops.paged_scatter(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(rows["k_new"]),
                              jnp.asarray(rows["v_new"]), jnp.asarray(pi), jnp.asarray(of))
    tk, tv = t(kp), t(vp)
    got = tops.paged_scatter(tk, tv, t(rows["k_new"]), t(rows["v_new"]), t(pi), t(of))
    assert got[0] is tk and got[1] is tv              # in place
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    last = {}
    for i, dest in enumerate(zip(page_idx, off)):
        last[dest] = i
    for (p_, o_), i in last.items():                   # the last row of each destination
        np.testing.assert_array_equal(tk[p_, o_].numpy(), rows["k_new"][i])


@pytest.mark.parametrize("page_idx,off", [([2, 9, 5], [7, 0, 3]), ([2, 2, 5], [7, 7, 3])])
def test_paged_scatter_quant_bit_equal(page_idx, off):
    rng = np.random.default_rng(57)
    n_pages, page, hkv, d, b = 10, 8, 2, 16, 3
    pools = dict(k_pages=rng.integers(-127, 128, (n_pages, page, hkv, d)).astype(np.int8),
                 v_pages=rng.integers(-127, 128, (n_pages, page, hkv, d)).astype(np.int8),
                 k_scale_pages=rng.uniform(0, 1, (n_pages, page, hkv)).astype(np.float32),
                 v_scale_pages=rng.uniform(0, 1, (n_pages, page, hkv)).astype(np.float32))
    rows = new_rows(rng, b, hkv, d, True)
    pi, of = np.asarray(page_idx, np.int32), np.asarray(off, np.int32)
    order = ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages")
    rorder = ("k_new", "v_new", "k_scale_new", "v_scale_new")
    want = jops.paged_scatter_quant(*(jnp.asarray(pools[k]) for k in order),
                                    *(jnp.asarray(rows[k]) for k in rorder),
                                    jnp.asarray(pi), jnp.asarray(of))
    got = tops.paged_scatter_quant(*(t(pools[k]) for k in order), *(t(rows[k]) for k in rorder),
                                   t(pi), t(of))
    for g_, w_ in zip(got, want):
        assert g_.dtype == bridge.tensor_from_numpy(np.asarray(w_), "cpu").dtype
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


@pytest.mark.parametrize("quant,window", [(False, 0), (False, 12), (True, 0), (True, 12)])
def test_paged_attention_scatter_matches_reference_and_fuses_bit_equal(quant, window):
    """The fused step against the reference's (fp32 bar; pools bit-equal),
    and bit-equal to the port's own scatter followed by its attention:
    outputs and every page, as ``test_kernels.py`` holds the TPU kernels."""
    rng = np.random.default_rng(58)
    b, hkv, g, d, page, m = 3, 2, 2, 32, 8, 4
    c = paged_case(rng, b, hkv, g, d, page, m, b * m + 2, quant)
    c["page_idx"] = c["table"][np.arange(b), c["pos"] // page].astype(np.int32)
    c["off"] = (c["pos"] % page).astype(np.int32)
    c.update(new_rows(rng, b, hkv, d, quant))
    pool_names = ("k_pages", "v_pages") + (("k_scale_pages", "v_scale_pages") if quant else ())
    j = {k: jnp.asarray(v) for k, v in c.items()}
    fused, unfused = tensors(c), tensors(c)
    if quant:
        want_out, want_pools = jops.paged_attention_scatter_quant(
            j["q"], j["k_new"], j["v_new"], j["k_scale_new"], j["v_scale_new"], j["k_pages"],
            j["v_pages"], j["k_scale_pages"], j["v_scale_pages"], j["table"], j["pos"],
            j["page_idx"], j["off"], window=window)
        f = fused
        got_out, got_pools = tops.paged_attention_scatter_quant(
            f["q"], f["k_new"], f["v_new"], f["k_scale_new"], f["v_scale_new"], f["k_pages"],
            f["v_pages"], f["k_scale_pages"], f["v_scale_pages"], f["table"], f["pos"],
            f["page_idx"], f["off"], window=window)
        u = unfused
        pools = tops.paged_scatter_quant(
            u["k_pages"], u["v_pages"], u["k_scale_pages"], u["v_scale_pages"], u["k_new"],
            u["v_new"], u["k_scale_new"], u["v_scale_new"], u["page_idx"], u["off"])
        split_out = tops.paged_attention_quant(u["q"], *pools, u["table"], u["pos"],
                                               window=window)
    else:
        want_out, want_pools = jops.paged_attention_scatter(
            j["q"], j["k_new"], j["v_new"], j["k_pages"], j["v_pages"], j["table"], j["pos"],
            j["page_idx"], j["off"], window=window)
        f = fused
        got_out, got_pools = tops.paged_attention_scatter(
            f["q"], f["k_new"], f["v_new"], f["k_pages"], f["v_pages"], f["table"], f["pos"],
            f["page_idx"], f["off"], window=window)
        u = unfused
        pools = tops.paged_scatter(u["k_pages"], u["v_pages"], u["k_new"], u["v_new"],
                                   u["page_idx"], u["off"])
        split_out = tops.paged_attention(u["q"], *pools, u["table"], u["pos"], window=window)
    np.testing.assert_allclose(f32(got_out), f32(want_out), **F32)
    for name, g_, w_ in zip(pool_names, got_pools, want_pools):
        assert g_ is fused[name]                      # in place
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    assert torch.equal(got_out, split_out)
    for name in pool_names:
        assert torch.equal(fused[name], unfused[name]), name


def test_paged_wrappers_refuse_other_devices_and_pool_counts():
    rng = np.random.default_rng(59)
    c = tensors(paged_case(rng, 2, 2, 2, 32, 8, 4, 12, False))
    meta = {k: v.to("meta") for k, v in c.items()}
    with pytest.raises(ValueError, match="paged_attention: no kernel for device meta"):
        PA.paged_attention(meta["q"], meta["k_pages"], meta["v_pages"], meta["table"],
                           meta["pos"])
    rows = {k: t(v) for k, v in new_rows(rng, 2, 2, 32, False).items()}
    with pytest.raises(ValueError, match="2 or 4 pools"):
        PA.paged_scatter((c["k_pages"],), (rows["k_new"],), c["pos"], c["pos"])
    with pytest.raises(ValueError, match="paged_scatter: no kernel for device meta"):
        PA.paged_scatter((meta["k_pages"], meta["v_pages"]),
                         (rows["k_new"].to("meta"), rows["v_new"].to("meta")),
                         meta["pos"], meta["pos"])
