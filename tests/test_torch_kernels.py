"""The port's RMSNorm, flash-attention and RG-LRU-scan kernels' plain versions
against the JAX package, on the CPU.

Each plain version (and its wrapper, which takes the plain version for CPU
tensors and so never counts a launch) is held to the reference's Pallas
kernel, run in interpret mode as ``tests/test_kernels.py`` runs it, and to
the XLA function the reference holds that kernel to (``layers.apply_norm``,
``chunked_causal_attention`` / ``naive_causal_attention``,
``rglru.linear_scan``).  Inputs come from numpy seeds.  Tolerances: fp32
atol 2e-5 / rtol 2e-4 (summation order), bf16 3e-2 (one bf16 rounding).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import rglru as JR
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rglru_scan as RS
from repro_torch.kernels import rmsnorm as RN
from repro_torch.models import layers as TL
from repro_torch.models import rglru as TR
from torch_kernel_calls import wrapper_calls

F32 = dict(atol=2e-5, rtol=2e-4)
BF16 = dict(atol=3e-2, rtol=3e-2)


def t(a):
    return bridge.tensor_from_numpy(np.asarray(a), "cpu")


def f32(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else a, np.float32)


def launch_counts():
    return (RN.launches, FA.launches, RS.launches)


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 128), (3, 17, 256), (2, 5, 320)])
@pytest.mark.parametrize("dtype,scale_dtype", [
    (jnp.float32, jnp.float32), (jnp.bfloat16, jnp.bfloat16), (jnp.bfloat16, jnp.float32)])
def test_rmsnorm_plain_matches_pallas_and_apply_norm(shape, dtype, scale_dtype):
    rng = np.random.default_rng(11)
    x = np.asarray(jnp.asarray(rng.normal(0, 2, shape), dtype))
    scale = np.asarray(jnp.asarray(rng.normal(1, 0.2, shape[-1:]), scale_dtype))
    cfg = reduced(get_config("llama3.2-1b"))
    wants = [jops.rmsnorm(jnp.asarray(x), jnp.asarray(scale), row_block=8),
             jref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(scale)),
             JL.apply_norm(cfg, {"scale": jnp.asarray(scale)}, jnp.asarray(x))]
    before = launch_counts()
    gots = [RN.rmsnorm_plain(t(x), t(scale)), RN.rmsnorm(t(x), t(scale)),
            TL.apply_norm(cfg, {"scale": t(scale)}, t(x), "plain"),
            TL.apply_norm(cfg, {"scale": t(scale)}, t(x), "cuda")]
    assert launch_counts() == before                  # CPU: never the kernel
    tol = F32 if dtype == jnp.float32 else BF16
    for got in gots:
        assert got.dtype == bridge.tensor_from_numpy(x, "cpu").dtype
        for want in wants:
            np.testing.assert_allclose(f32(got), f32(want), **tol)


def held_vectors(pl: RN.Plan, d: int) -> np.ndarray:
    """The vectors of one row that the kernel's threads hold under ``pl``
    (CTA rank c of the cluster, thread t, load k: vector c * span + t +
    k * threads, below the end of the rank's slice), as
    ``csrc/rmsnorm.cu`` indexes them."""
    nvec = d // pl.vec
    span = -(-nvec // pl.cluster)
    c, t, k = np.meshgrid(np.arange(pl.cluster), np.arange(pl.threads), np.arange(pl.vpt),
                          indexing="ij")
    v = c * span + t + k * pl.threads
    return v[v < np.minimum((c + 1) * span, nvec)]


@pytest.mark.parametrize("d", [2560, 2048, 768, 2558, 320, 16384, 8190, 24000, 30001])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_rmsnorm_plan_holds_every_element_once(d, itemsize):
    """Every vector of a row is held by exactly one thread, within the
    kernel's limits; 16-byte vectors unless d is not a multiple of them."""
    pl = RN.plan(d, itemsize)
    held = np.sort(held_vectors(pl, d))
    np.testing.assert_array_equal(held, np.arange(d // pl.vec))
    assert pl.vec == (16 // itemsize if d % (16 // itemsize) == 0 else 1)
    assert pl.vpt in (1, 2, 4, 8) and pl.vpt * pl.vec <= RN.MAX_ELEMS
    assert pl.threads % 32 == 0 and pl.threads <= RN.MAX_THREADS
    assert pl.cluster in (1, 2, 4, 8)
    assert RN.plan(d, itemsize, aligned=False).vec == 1


@pytest.mark.parametrize("d,itemsize,threads,vpt", [
    (2560, 4, 96, 8), (2048, 4, 64, 8), (768, 4, 32, 8),
    (2560, 2, 96, 4), (2048, 2, 64, 4), (768, 2, 32, 4)])
def test_rmsnorm_plan_at_the_paths_widths(d, itemsize, threads, vpt):
    """The serving paths' rows: no cluster; the fewest warps that hold a row
    at 32 elements a thread (1-3)."""
    assert RN.plan(d, itemsize) == RN.Plan(16 // itemsize, vpt, threads, 1)


@pytest.mark.parametrize("d,itemsize,cluster", [(8190, 4, 2), (8190, 2, 2), (40000, 4, 4),
                                                (40000, 2, 4), (131072, 4, 8)])
def test_rmsnorm_plan_cuts_only_rows_wider_than_a_cta_over_a_cluster(d, itemsize, cluster):
    assert RN.plan(d, itemsize).cluster == cluster


def test_rmsnorm_plan_refuses_rows_past_the_kernel():
    widest = RN.MAX_CLUSTER * RN.MAX_THREADS * RN.MAX_ELEMS
    for itemsize in (4, 2):
        assert RN.plan(widest, itemsize).cluster == RN.MAX_CLUSTER
        with pytest.raises(ValueError, match="exceed"):
            RN.plan(widest + 16, itemsize)
    scalar = RN.MAX_CLUSTER * RN.MAX_THREADS * RN.MAX_VPT      # one element a load
    assert RN.plan(scalar - 1, 4).cluster == RN.MAX_CLUSTER
    with pytest.raises(ValueError, match="exceed"):
        RN.plan(scalar + 1, 4)


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------

FLASH_CASES = [
    # b, hq, hkv, s, d, window
    (1, 4, 4, 40, 32, 0),        # MHA causal, a ragged tile
    (2, 8, 2, 48, 16, 0),        # GQA
    (1, 10, 1, 40, 32, 0),       # MQA with recurrentgemma's 10 query heads
    (1, 4, 2, 64, 32, 24),       # sliding window shorter than S
]


@pytest.mark.parametrize("b,hq,hkv,s,d,window", FLASH_CASES)
def test_flash_plain_matches_pallas_and_model_attention(b, hq, hkv, s, d, window):
    rng = np.random.default_rng(12)
    q = rng.normal(0, 1, (b, hq, s, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, hkv, s, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, s, d)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    pallas = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  window=window, block_q=16, block_k=16)
    oracle = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window)
    # the model's XLA attention in its own (B,S,Hkv,G,D) layout
    qm = jnp.asarray(q.reshape(b, hkv, hq // hkv, s, d).transpose(0, 3, 1, 2, 4))
    km, vm = jnp.asarray(k.transpose(0, 2, 1, 3)), jnp.asarray(v.transpose(0, 2, 1, 3))
    if window:
        model = JL.naive_causal_attention(qm, km, vm, jnp.asarray(pos), jnp.asarray(pos),
                                          window=window)
    else:
        model = JL.chunked_causal_attention(qm, km, vm, jnp.asarray(pos), jnp.asarray(pos),
                                            kv_chunk=16)
    model = np.asarray(model).transpose(0, 2, 3, 1, 4).reshape(b, hq, s, d)
    before = launch_counts()
    gots = [FA.flash_attention_plain(t(q), t(k), t(v), window=window),
            FA.flash_attention(t(q), t(k), t(v), positions=t(pos), window=window)]
    assert launch_counts() == before
    for got in gots:
        for want in (pallas, oracle, model):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_flash_plain_bf16_matches_pallas():
    rng = np.random.default_rng(13)
    q, k, v = (np.asarray(jnp.asarray(rng.normal(0, 1, (1, h, 48, 32)), jnp.bfloat16))
               for h in (4, 2, 2))
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                block_q=16, block_k=16)
    got = FA.flash_attention(t(q), t(k), t(v))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), **BF16)


def test_flash_refuses_positions_other_than_arange():
    q = torch.zeros(1, 2, 8, 16)
    k = torch.zeros(1, 1, 8, 16)
    FA.flash_attention(q, k, k, positions=torch.arange(8, dtype=torch.int32))
    for bad in (torch.arange(8) + 3, torch.arange(7), torch.arange(8).flip(0)):
        with pytest.raises(ValueError, match="arange"):
            FA.flash_attention(q, k, k, positions=bad)


@pytest.mark.parametrize("mods,s", [({}, 24), ({"attention": "local", "window": 16}, 40)])
def test_attention_forward_kernel_path_matches_plain_path(mods, s):
    """``attention_forward(kernel="cuda")`` (the flash wrapper, its plain
    version on the CPU) against the plain path (naive or banded) and the
    reference's ``attention_forward``."""
    jcfg = dataclasses.replace(jreduced(jget_config("llama3.2-1b")), **mods)
    tcfg = dataclasses.replace(reduced(get_config("llama3.2-1b")), **mods)
    rng = np.random.default_rng(14)
    d, hd = tcfg.d_model, tcfg.head_dim
    p = {name: rng.normal(0, 0.1, shape).astype(np.float32) for name, shape in (
        ("wq", (d, tcfg.n_heads * hd)), ("wk", (d, tcfg.n_kv_heads * hd)),
        ("wv", (d, tcfg.n_kv_heads * hd)), ("wo", (tcfg.n_heads * hd, d)))}
    x = rng.normal(0, 1, (2, s, d)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    want = JL.attention_forward(jcfg, {k: jnp.asarray(a) for k, a in p.items()},
                                jnp.asarray(x), jnp.asarray(pos))
    tp = {k: t(a) for k, a in p.items()}
    for kernel in ("plain", "cuda"):
        got = TL.attention_forward(tcfg, tp, t(x), t(pos), kernel=kernel)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# RG-LRU scan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s,w,with_h0", [(40, 64, True), (50, 96, False), (1, 32, True)])
def test_rglru_scan_plain_matches_pallas_and_linear_scan(s, w, with_h0):
    rng = np.random.default_rng(15)
    a = rng.uniform(0.3, 0.999, (2, s, w)).astype(np.float32)
    b = rng.normal(0, 0.3, (2, s, w)).astype(np.float32)
    h0 = rng.normal(0, 1, (2, w)).astype(np.float32)
    jh0 = jnp.asarray(h0 if with_h0 else np.zeros_like(h0))
    pallas = jops.rglru_scan(jnp.asarray(a), jnp.asarray(b), jh0, chunk=8, width_block=32)
    assoc, assoc_last = JR.linear_scan(jnp.asarray(a), jnp.asarray(b),
                                       jh0 if with_h0 else None)
    th0 = t(h0) if with_h0 else None
    before = launch_counts()
    port_assoc, port_last = TR.linear_scan(t(a), t(b), th0)
    gots = [RS.rglru_scan(t(a), t(b), th0), port_assoc]
    assert launch_counts() == before
    for got in gots:
        for want in (pallas, assoc):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(port_last.numpy(), np.asarray(assoc_last), **F32)


def test_wrappers_check_device():
    meta = torch.zeros(2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        RN.rmsnorm(meta, torch.zeros(8, device="meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        RS.rglru_scan(meta, meta)
    q = torch.zeros(1, 2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        FA.flash_attention(q, q, q)


@pytest.mark.parametrize("name", list(wrapper_calls("cpu", False)))
def test_wrappers_refuse_a_launch_autograd_would_record(name):
    """Off the CPU a wrapper launches its kernel, whose output has no
    ``grad_fn``: with grad enabled and an input that requires grad it
    raises and names the plain version, before looking at the device; under
    ``torch.no_grad`` it gets past that check."""
    with pytest.raises(RuntimeError, match="the kernel has no backward.*_plain|"
                                           "the kernel has no backward.*(linear_scan|"
                                           "ssd_chunked)"):
        wrapper_calls("meta", True)[name]()
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel for device meta"):
        wrapper_calls("meta", True)[name]()


@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention", "rglru_scan", "ssd_scan"])
def test_wrappers_on_cpu_tensors_keep_the_graph(name):
    """On CPU tensors a wrapper takes its plain version, which autograd
    differentiates."""
    out = wrapper_calls("cpu", True)[name]()
    out = out[0] if isinstance(out, tuple) else out
    assert out.grad_fn is not None
    out.sum().backward()
