"""The port's CUDA kernels on the card: skipped where there is no NVIDIA GPU.

Each kernel is held to its plain version on the same inputs (fp32 atol
2e-5 / rtol 2e-4, bf16 3e-2; the SSD scan at the reference's SSD bar,
2e-4 / 2e-3) and must refuse what it does not take.  The paged scatter is
bit-equal to its plain version, and the fused paged step to the scatter
kernel followed by the attention kernel.

Run them on a machine with one (an H100 for the ``sm_90a`` build):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which this file does
not need.)
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import jrandom
from repro_torch.configs import get_config, reduced
from repro_torch.core import instrument as TI
from repro_torch.core.governor import Governor
from repro_torch.core.policies import COUNTDOWN_SLACK
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import rglru_scan as RS
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssd as SSD
from repro_torch.models.transformer import init_params
from repro_torch.serve import engine as TE
from repro_torch.serve.engine import ContinuousEngine
from torch_kernel_calls import wrapper_calls

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False     # plain versions in full fp32
    return torch.device("cuda")


def case(card, page_dtype, b=4, hkv=2, g=4, d=64, page=16, m=6, seed=0):
    rng = np.random.default_rng(seed)
    n_pages = b * m + 1
    quant = page_dtype == torch.int8

    def rows(*shape):
        if quant:
            return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(card)
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(card, page_dtype)

    def scales(*shape):
        return torch.from_numpy(rng.uniform(0.005, 0.025, shape).astype(np.float32)).to(card)

    table = rng.permutation(np.arange(1, n_pages, dtype=np.int32)).reshape(b, m)
    pos = rng.integers(0, m * page, b).astype(np.int32)
    ins = dict(q=torch.from_numpy(rng.normal(0, 1, (b, hkv, g, d)).astype(np.float32)).to(card),
               k_new=rows(b, hkv, d), v_new=rows(b, hkv, d),
               k_pages=rows(n_pages, page, hkv, d), v_pages=rows(n_pages, page, hkv, d),
               table=torch.from_numpy(table).to(card), pos=torch.from_numpy(pos).to(card),
               page_idx=torch.from_numpy(table[np.arange(b), pos // page]).to(card),
               off=torch.from_numpy(pos % page).to(card))
    if quant:
        ins.update(k_scale_new=scales(b, hkv), v_scale_new=scales(b, hkv),
                   k_scale_pages=scales(n_pages, page, hkv),
                   v_scale_pages=scales(n_pages, page, hkv))
    return ins


@pytest.mark.parametrize("page_dtype,window,tol", [
    (torch.float32, 0, 2e-5), (torch.int8, 24, 2e-5), (torch.bfloat16, 0, 3e-2),
])
def test_kernel_matches_plain_on_card(card, page_dtype, window, tol):
    """fp32 query: fp32 and int8 pages at 2e-5 (rtol 10x), bf16 pages at 3e-2."""
    ins = case(card, page_dtype)
    plain = {k: v.clone() for k, v in ins.items()}
    before = PA.launches
    got = PA.paged_attention_scatter(**ins, window=window)
    want = PA.paged_attention_scatter_plain(**plain, window=window)
    torch.cuda.synchronize()
    assert PA.launches == before + 1
    torch.testing.assert_close(got, want, atol=tol, rtol=tol if tol > 1e-3 else 10 * tol)
    for name in ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages"):
        if name in ins:
            assert torch.equal(ins[name][1:], plain[name][1:]), name


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    ins = case(card, torch.float32)
    with pytest.raises(ValueError, match="int32"):
        PA.paged_attention_scatter(**dict(ins, pos=ins["pos"].long()))
    with pytest.raises(ValueError, match="contiguous"):
        PA.paged_attention_scatter(**dict(ins, q=ins["q"].transpose(0, 1)))


def test_out_of_range_page_id_traps_on_card(card):
    """A table entry past the pool stops the kernel with a device-side
    fault instead of reading outside the pools.  Run in a subprocess: the
    fault leaves that process's CUDA context unusable."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = (
        "import torch\n"
        "from test_torch_cuda import case\n"
        "from repro_torch.kernels import paged_attention as PA\n"
        "ins = case(torch.device('cuda'), torch.float32)\n"
        "ins['table'][0, 0] = ins['k_pages'].shape[0]\n"
        "PA.paged_attention_scatter(**ins)\n"
        "torch.cuda.synchronize()\n"
        "print('no fault')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(here, "..", "src"), here]))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode != 0 and "no fault" not in out.stdout
    assert "CUDA error" in out.stderr, out.stderr[-2000:]


def test_engine_launches_the_kernel_every_layer_every_step(card):
    cfg = reduced(get_config("llama3.2-1b"))
    params = init_params(cfg, torch.Generator(device=card).manual_seed(0), card)
    eng = ContinuousEngine(cfg, params, n_slots=2, max_len=32, page=8,
                           attn_kernel="cuda", device=card)
    PA.launches = 0
    eng.generate({"tokens": np.arange(16, dtype=np.int32).reshape(2, 8)}, n_steps=5)
    assert PA.launches == eng.n_decode_steps * cfg.n_layers > 0


def test_paged_kernel_at_recurrentgemma_shapes(card):
    """B 8, Hkv 1, G 10, D 256, page 16 (160 threads), bf16 pages and an fp32
    query, with a window that cuts pages.  On the decode path (a 129-page
    table under the 2048 window) a block takes a run of 4 pages as one tile:
    70,208 bytes of shared memory (page ids, the probabilities, one stage of
    bf16 K and V rows)."""
    ins = case(card, torch.bfloat16, b=8, hkv=1, g=10, d=256, page=16, m=12, seed=3)
    assert PA.split_plan(8, 1, 129, 16, 2048, 132) == (33, 4)
    assert PA.build().repro_paged_attention_shared_bytes(1, 10, 256, 16, 4) == 70208
    plain = {k: v.clone() for k, v in ins.items()}
    got = PA.paged_attention_scatter(**ins, window=40)
    want = PA.paged_attention_scatter_plain(**plain, window=40)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2)
    assert torch.equal(ins["k_pages"][1:], plain["k_pages"][1:])


def randn(card, *shape, dtype=torch.float32, seed=0, mean=0.0, std=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(mean, std, shape).astype(np.float32)).to(card, dtype)


# the serving paths' calls (decode steps and joins), and one 3-D input
NORM_SHAPES = [(8, 2560), (128, 2560), (2032, 2560), (8, 2048), (128, 2048), (8, 768),
               (128, 768), (2000, 768)]


@pytest.mark.parametrize("shape", NORM_SHAPES + [(3, 5, 320), (4, 40000)])
@pytest.mark.parametrize("dtype,scale_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_rmsnorm_kernel_matches_plain_on_card(card, shape, dtype, scale_dtype):
    x = randn(card, *shape, dtype=dtype, std=2.0)
    scale = randn(card, shape[-1], dtype=scale_dtype, seed=1, mean=1.0, std=0.2)
    before = RN.launches
    got = RN.rmsnorm(x, scale)
    want = RN.rmsnorm_plain(x, scale)
    torch.cuda.synchronize()
    assert RN.launches == before + 1 and got.dtype == dtype
    tol = dict(atol=2e-5, rtol=2e-4) if dtype == torch.float32 else dict(atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("shape", [(8, 2560), (2032, 2560), (8, 768), (2000, 768), (4, 40000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_second_launch_gives_the_same_bits(card, shape, dtype):
    """A row's warps are added in warp order and a cluster's partial sums in
    rank order (4 x 40000: a cluster of 4): a second launch on the
    same input gives the same bits."""
    x = randn(card, *shape, dtype=dtype, std=2.0)
    scale = randn(card, shape[-1], seed=1, mean=1.0, std=0.2)
    assert torch.equal(RN.rmsnorm(x, scale), RN.rmsnorm(x, scale))


@pytest.mark.parametrize("rows,d", [(8, 2558), (8, 769), (3, 10), (128, 2558), (8, 8190),
                                    (2, 30001)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_scalar_tail_matches_plain_on_card(card, rows, d, dtype):
    """d not a multiple of the vector width (scalar loads; at 8190 and 30001
    a row cut over a cluster of 2 and 8 CTAs, its last slice ragged), and x
    starting off a 16-byte boundary."""
    pl = RN.plan(d, torch.empty((), dtype=dtype).element_size())
    assert pl.vec == 1 and pl.cluster == {8190: 2, 30001: 8}.get(d, 1)
    x = randn(card, rows, d, dtype=dtype, std=2.0)
    scale = randn(card, d, seed=1, mean=1.0, std=0.2)
    tol = dict(atol=2e-5, rtol=2e-4) if dtype == torch.float32 else dict(atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(RN.rmsnorm(x, scale), RN.rmsnorm_plain(x, scale), **tol)
    flat = randn(card, rows * 2560 + 1, dtype=dtype, std=2.0)
    off = flat[1:].view(rows, 2560)                   # aligned width, misaligned start
    w = randn(card, 2560, seed=2, mean=1.0, std=0.2)
    torch.testing.assert_close(RN.rmsnorm(off, w), RN.rmsnorm_plain(off, w), **tol)


def test_rmsnorm_refuses_what_the_kernel_does_not_take(card):
    x = randn(card, 4, 64)
    scale = randn(card, 64, seed=1)
    with pytest.raises(ValueError, match="contiguous"):
        RN.rmsnorm(x.T, randn(card, 4))
    with pytest.raises(ValueError, match="scale must be"):
        RN.rmsnorm(x, scale[:32])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        RN.rmsnorm(x.half(), scale)
    with pytest.raises(ValueError, match="exceed"):           # wider than 8 CTAs hold
        RN.rmsnorm(randn(card, 1, 131080), randn(card, 131080, seed=1))


def scan_inputs(card, b, s, w, with_h0, lo=0.3, offset=0):
    """a in [lo, 0.999), b and h0 normal; ``offset`` elements into a buffer,
    so that a and b are not 16-byte aligned (the kernel's 4-byte copies)."""
    rng = np.random.default_rng(2)

    def placed(x):
        flat = torch.empty(x.size + offset, dtype=torch.float32, device=card)
        flat[offset:] = torch.from_numpy(x.ravel()).to(card)
        return flat[offset:].view(x.shape)

    a = placed(rng.uniform(lo, 0.999, (b, s, w)).astype(np.float32))
    bb = placed(rng.normal(0, 0.3, (b, s, w)).astype(np.float32))
    h0 = randn(card, b, w, seed=4) if with_h0 else None
    return a, bb, h0


# S from one step to 64 tiles of 128; W ragged (not a multiple of 16 or 4),
# B 2 and 4, a and b off 16-byte alignment
SCAN_CASES = [(1, 1, 2560, True, 0), (1, 128, 2560, True, 0), (1, 2032, 2560, True, 0),
              (1, 8192, 2560, False, 0), (2, 37, 100, False, 0), (2, 300, 2563, True, 0),
              (2, 2032, 100, True, 0), (4, 300, 2560, True, 0), (1, 2032, 2560, True, 1)]


@pytest.mark.parametrize("b,s,w,with_h0,offset", SCAN_CASES)
def test_rglru_scan_kernel_matches_plain_on_card(card, b, s, w, with_h0, offset):
    a, bb, h0 = scan_inputs(card, b, s, w, with_h0, offset=offset)
    before = RS.launches
    got = RS.rglru_scan(a, bb, h0)
    want = RS.linear_scan(a, bb, h0)[0]
    torch.cuda.synchronize()
    assert RS.launches == before + 1
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("b,s,w", [(1, 2032, 2560), (1, 128, 2560), (4, 300, 2560)])
def test_rglru_scan_two_launches_give_the_same_bits(card, b, s, w):
    a, bb, h0 = scan_inputs(card, b, s, w, True)
    first = RS.rglru_scan(a, bb, h0)
    again = RS.rglru_scan(a, bb, h0)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert RS.build().repro_rglru_scan_shared_bytes() == RS.SHARED_BYTES


@pytest.mark.parametrize("b,s,w,with_h0,offset,lo", [
    (1, 2032, 2560, True, 0, 0.3), (1, 128, 2560, True, 0, 0.3), (2, 300, 2563, False, 0, 0.3),
    (4, 300, 2560, True, 0, 0.3), (1, 37, 100, True, 1, 0.3), (1, 8192, 100, True, 0, 0.99)])
def test_rglru_scan_kernel_runs_the_order_of_the_cpu_model(card, b, s, w, with_h0, offset, lo):
    """The kernel equals ``scan_model`` (the order of operations the CPU
    tests hold to the reference) within one ulp of max(|h|, 1): the model
    rounds each fmaf from float64, which can differ from the card's single
    rounding by an ulp, rarely."""
    a, bb, h0 = scan_inputs(card, b, s, w, with_h0, lo=lo, offset=offset)
    got = RS.rglru_scan(a, bb, h0).cpu().numpy()
    want = RS.scan_model(a.cpu().numpy(), bb.cpu().numpy(),
                         None if h0 is None else h0.cpu().numpy())
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(1)))
    assert np.all(np.abs(got - want) <= ulp), float((np.abs(got - want) / ulp).max())


def test_rglru_scan_refuses_what_the_kernel_does_not_take(card):
    a = randn(card, 1, 8, 32)
    with pytest.raises(ValueError, match="float32"):
        RS.rglru_scan(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        RS.rglru_scan(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError, match="h0 must be"):
        RS.rglru_scan(a, a, randn(card, 1, 16))
    with pytest.raises(ValueError, match="empty"):
        RS.rglru_scan(a[:0], a[:0])
    # one block a batch row at W 1: 2**31 rows are one block past the grid
    rows = torch.empty((RS.GRID_LIMIT + 1, 1, 1), dtype=torch.float32, device=card)
    with pytest.raises(ValueError, match="exceed the grid"):
        RS.rglru_scan(rows, rows)
    del rows
    torch.cuda.empty_cache()


@pytest.mark.parametrize("b,hq,hkv,s,d,window,dtype", [
    (1, 10, 1, 2032, 256, 2048, torch.float32),    # recurrentgemma-2b prefill
    (1, 10, 1, 2304, 256, 2048, torch.float32),    # longer than the window
    (1, 32, 8, 128, 64, 0, torch.float32),         # llama3.2-1b prefill
    (2, 4, 2, 45, 32, 16, torch.float32),          # ragged tiles, window < tile
    (1, 8, 2, 100, 64, 0, torch.bfloat16),
    (1, 24, 8, 128, 64, 0, torch.float32),         # granite-moe-3b-a800m, G 3
    (1, 14, 2, 384, 64, 0, torch.float32),         # internvl2-1b with its prefix, G 7
    (1, 32, 2, 128, 128, 0, torch.float32),        # glm4-9b, G 16, D 128
    (1, 16, 16, 128, 128, 0, torch.float32),       # olmo-1b, MHA, D 128
    (1, 48, 8, 128, 128, 4096, torch.float32),     # mixtral-8x22b, G 6, window 4096
])
def test_flash_kernel_matches_plain_on_card(card, b, hq, hkv, s, d, window, dtype):
    q = randn(card, b, hq, s, d, dtype=dtype, seed=5)
    k = randn(card, b, hkv, s, d, dtype=dtype, seed=6)
    v = randn(card, b, hkv, s, d, dtype=dtype, seed=7)
    before = FA.launches
    got = FA.flash_attention(q, k, v, positions=torch.arange(s, device=card), window=window)
    want = FA.flash_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    assert FA.launches == before + 1 and got.dtype == dtype
    tol = dict(atol=2e-5, rtol=2e-4) if dtype == torch.float32 else dict(atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("b,hq,hkv,s,d,window,dtype", [
    (2, 4, 2, 45, 32, 0, torch.float32),           # ragged S: no key past S - 1 is seen
    (2, 4, 2, 45, 32, 16, torch.float32),          # ragged, window < tile
    (1, 10, 1, 200, 256, 64, torch.float32),       # recurrentgemma's heads, a window
    (1, 32, 8, 128, 64, 0, torch.float32),         # llama's heads
    (1, 8, 2, 100, 64, 0, torch.bfloat16),
    (2, 4, 2, 77, 128, 24, torch.bfloat16),
])
def test_flash_non_causal_kernel_matches_plain_on_card(card, b, hq, hkv, s, d, window, dtype):
    """``causal=False``: every key 0..S-1 (within the window) is seen, as
    ``ref.attention_ref(causal=False)`` masks them."""
    q = randn(card, b, hq, s, d, dtype=dtype, seed=15)
    k = randn(card, b, hkv, s, d, dtype=dtype, seed=16)
    v = randn(card, b, hkv, s, d, dtype=dtype, seed=17)
    before = FA.launches
    got = FA.flash_attention(q, k, v, window=window, causal=False)
    want = FA.flash_attention_plain(q, k, v, window=window, causal=False)
    torch.cuda.synchronize()
    assert FA.launches == before + 1 and got.dtype == dtype
    tol = dict(atol=2e-5, rtol=2e-4) if dtype == torch.float32 else dict(atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(got, want, **tol)
    assert not torch.allclose(got.float(), FA.flash_attention_plain(q, k, v, window=window).float(),
                              **tol)      # the mode is not the causal one


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_second_launch_gives_the_same_bits(card, causal, dtype):
    q = randn(card, 1, 10, 300, 256, dtype=dtype, seed=18)
    k = randn(card, 1, 1, 300, 256, dtype=dtype, seed=19)
    first = FA.flash_attention(q, k, k, window=128, causal=causal)
    again = FA.flash_attention(q, k, k, window=128, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def test_flash_refuses_what_the_kernel_does_not_take(card):
    q = randn(card, 1, 4, 16, 32)
    k = randn(card, 1, 2, 16, 32, seed=1)
    with pytest.raises(ValueError, match="arange"):
        FA.flash_attention(q, k, k, positions=torch.arange(16, device=card) + 1)
    with pytest.raises(ValueError, match="multiple of 4"):
        FA.flash_attention(q[..., :30].contiguous(), k[..., :30].contiguous(),
                           k[..., :30].contiguous())
    with pytest.raises(ValueError, match="multiple of Hkv"):
        FA.flash_attention(q, randn(card, 1, 3, 16, 32), randn(card, 1, 3, 16, 32))
    with pytest.raises(ValueError, match="bfloat16"):
        FA.flash_attention(q, k.bfloat16(), k.bfloat16())
    big = randn(card, 1, 1, 4, 260)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(big, big, big)
    off = torch.zeros(1 + q.numel(), device=card)[1:].view(q.shape)   # 4 bytes past 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.flash_attention(off, off[:, :2].contiguous(), off[:, :2].contiguous())


def test_hybrid_engine_launches_every_kernel_by_default(card):
    """Reduced recurrentgemma-2b on the card with no kernel named: RMSNorm
    2 * layers + 1 times a join and a step, flash and the scan once per
    attention / RG-LRU layer a join, the paged kernel once per attention
    layer a step."""
    cfg = reduced(get_config("recurrentgemma-2b"), n_layers=8)
    params = init_params(cfg, torch.Generator(device=card).manual_seed(0), card)
    eng = ContinuousEngine(cfg, params, n_slots=2, max_len=32, page=8, device=card)
    assert eng.attn_kernel == "cuda"
    for mod in (RN, FA, RS, PA):
        mod.launches = 0
    eng.generate({"tokens": np.arange(16, dtype=np.int32).reshape(2, 8)}, n_steps=5)
    kinds = cfg.layer_kinds()
    joins, steps = eng.n_joins, eng.n_decode_steps
    assert (joins, steps) == (2, 4)
    assert RN.launches == (joins + steps) * (2 * len(kinds) + 1)
    assert FA.launches == joins * kinds.count("attn")
    assert RS.launches == joins * kinds.count("rglru")
    assert PA.launches == steps * kinds.count("attn")


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_state,dtype", [
    (1, 2000, 24, 64, 128, 128, True, torch.float32),    # mamba2-130m prefill, ragged
    (1, 2048, 24, 64, 128, 128, False, torch.float32),
    (2, 45, 3, 16, 8, 16, True, torch.float32),          # the reference's test shapes
    (2, 7, 3, 32, 16, 16, False, torch.float32),         # one chunk shorter than chunk
    (2, 100, 3, 16, 8, 32, False, torch.bfloat16),
    (1, 128, 24, 64, 128, 128, True, torch.float32),    # a 128-token join: one chunk
    (1, 128, 24, 64, 128, 128, False, torch.float32),
    (2, 300, 4, 32, 64, 64, True, torch.float32),       # several chunks, the last ragged
    (1, 389, 24, 64, 128, 128, True, torch.float32),
    (1, 384, 24, 64, 128, 128, True, torch.bfloat16),
    (1, 50, 2, 128, 12, 16, True, torch.float32),       # P 128, N not a multiple of 16
])
def test_ssd_kernel_matches_plain_on_card(card, b, s, h, p, n, chunk, with_state, dtype):
    """y and the final state against ``ssd_chunked``: fp32 at the reference's
    SSD bar, atol 2e-4 / rtol 2e-3; bf16 y at 3e-1 / 5e-2."""
    rng = np.random.default_rng(8)
    x = randn(card, b, s, h, p, dtype=dtype, seed=9)
    dt = torch.from_numpy(rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32)).to(card)
    a_log = torch.from_numpy(-rng.uniform(0.5, 2.0, (h,)).astype(np.float32)).to(card)
    bb = randn(card, b, s, n, dtype=dtype, seed=10)
    cc = randn(card, b, s, n, dtype=dtype, seed=11)
    h0 = randn(card, b, h, p, n, seed=12) if with_state else None
    before = SSD.launches
    y, state = SSD.ssd_scan(x, dt, a_log, bb, cc, chunk=chunk, init_state=h0)
    want_y, want_state = SSD.ssd_chunked(x, dt, a_log, bb, cc, chunk, h0)
    torch.cuda.synchronize()
    assert SSD.launches == before + 1 and y.dtype == dtype
    tol = dict(atol=2e-4, rtol=2e-3)
    torch.testing.assert_close(state, want_state, **tol)
    torch.testing.assert_close(y.float(), want_y.float(),
                               **(tol if dtype == torch.float32 else dict(atol=3e-1, rtol=5e-2)))


@pytest.mark.parametrize("s,dtype", [(128, torch.float32), (2000, torch.float32),
                                     (300, torch.bfloat16)])
def test_ssd_second_launch_gives_the_same_bits(card, s, dtype):
    """The carry runs the chunks in a fixed order and nothing sums with
    atomics: two launches on the same inputs give the same y and state."""
    rng = np.random.default_rng(13)
    x = randn(card, 1, s, 24, 64, dtype=dtype, seed=14)
    dt = torch.from_numpy(rng.uniform(0.001, 0.2, (1, s, 24)).astype(np.float32)).to(card)
    a_log = torch.from_numpy(-rng.uniform(1.0, 16.0, 24).astype(np.float32)).to(card)
    bb, cc = randn(card, 1, s, 128, dtype=dtype, seed=15), randn(card, 1, s, 128, dtype=dtype,
                                                                  seed=16)
    h0 = randn(card, 1, 24, 64, 128, seed=17, std=0.1)
    y1, s1 = SSD.ssd_scan(x, dt, a_log, bb, cc, chunk=128, init_state=h0)
    y2, s2 = SSD.ssd_scan(x, dt, a_log, bb, cc, chunk=128, init_state=h0)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def test_ssd_refuses_what_the_kernel_does_not_take(card):
    x = randn(card, 1, 8, 2, 16)
    dt = randn(card, 1, 8, 2).abs()
    a_log = -randn(card, 2).abs()
    bc = randn(card, 1, 8, 8)
    with pytest.raises(ValueError, match="power of two"):
        SSD.ssd_scan(randn(card, 1, 8, 2, 24), dt, a_log, bc, bc, chunk=4)
    with pytest.raises(ValueError, match="b and c must be"):
        SSD.ssd_scan(x, dt, a_log, bc.bfloat16(), bc.bfloat16(), chunk=4)
    with pytest.raises(ValueError, match="init_state"):
        SSD.ssd_scan(x, dt, a_log, bc, bc, chunk=4, init_state=randn(card, 1, 2, 8, 16))
    with pytest.raises(ValueError, match="chunk 256"):
        SSD.ssd_scan(randn(card, 1, 300, 2, 16), randn(card, 1, 300, 2).abs(), a_log,
                     randn(card, 1, 300, 8), randn(card, 1, 300, 8), chunk=256)


def scatter_args(ins):
    quant = "k_scale_pages" in ins
    names = ("k_pages", "v_pages") + (("k_scale_pages", "v_scale_pages") if quant else ())
    rows = ("k_new", "v_new") + (("k_scale_new", "v_scale_new") if quant else ())
    return [ins[k] for k in names], [ins[k] for k in rows]


@pytest.mark.parametrize("page_dtype,window,tol", [
    (torch.float32, 0, 2e-5), (torch.int8, 24, 2e-5), (torch.bfloat16, 0, 3e-2),
])
@pytest.mark.parametrize("dup", [False, True])
def test_unfused_kernels_match_plain_on_card(card, page_dtype, window, tol, dup):
    """Attention over the pages as they are against its plain version (fp32
    query: fp32 and int8 pages at 2e-5, bf16 pages at 3e-2); the scatter
    bit-equal to its plain version, with three rows on one destination
    when ``dup`` (the last wins)."""
    ins = case(card, page_dtype)
    if dup:
        ins["page_idx"][:3] = 0
        ins["off"][:3] = 5
    kern = {k: v.clone() for k, v in ins.items()}
    plain = {k: v.clone() for k, v in ins.items()}
    before = (PA.attention_launches, PA.scatter_launches)
    PA.paged_scatter(*scatter_args(kern), kern["page_idx"], kern["off"])
    PA.paged_scatter_plain(*scatter_args(plain), plain["page_idx"], plain["off"])
    torch.cuda.synchronize()
    for got, want in zip(scatter_args(kern)[0], scatter_args(plain)[0]):
        assert torch.equal(got, want)
    if dup:
        assert torch.equal(kern["k_pages"][0, 5], ins["k_new"][2])
    pool = {k: kern[k] for k in ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages")
            if k in kern}
    got = PA.paged_attention(kern["q"], **pool, table=kern["table"], pos=kern["pos"],
                             window=window)
    want = PA.paged_attention_plain(kern["q"], **pool, table=kern["table"], pos=kern["pos"],
                                    window=window)
    torch.cuda.synchronize()
    assert (PA.attention_launches, PA.scatter_launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, want, atol=tol, rtol=tol if tol > 1e-3 else 10 * tol)


@pytest.mark.parametrize("quant,window", [(False, 0), (False, 12), (True, 0), (True, 12)])
@pytest.mark.parametrize("shape", [dict(b=3, hkv=2, g=2, d=32, page=8, m=4),
                                   dict(b=8, hkv=1, g=10, d=256, page=16, m=6)])
def test_fused_kernel_is_scatter_then_attention_bit_for_bit(card, quant, window, shape):
    """The reference's ``test_paged_attention_scatter_fuses_bit_equal`` on the
    card: the fused kernel's output and every page equal the scatter
    kernel's followed by the attention kernel's, bit for bit."""
    ins = case(card, torch.int8 if quant else torch.float32, seed=13, **shape)
    fused = {k: v.clone() for k, v in ins.items()}
    split = {k: v.clone() for k, v in ins.items()}
    out = PA.paged_attention_scatter(**fused, window=window)
    PA.paged_scatter(*scatter_args(split), split["page_idx"], split["off"])
    pool = {k: split[k] for k in ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages")
            if k in split}
    want = PA.paged_attention(split["q"], **pool, table=split["table"], pos=split["pos"],
                              window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    for name in pool:
        assert torch.equal(fused[name], split[name]), name


def test_mamba2_engine_launches_ssd_and_rmsnorm_by_default(card):
    """Reduced mamba2 on the card with no kernel named: the SSD kernel once
    per layer a join, RMSNorm layers + 1 times a join and a step, no paged
    kernel; greedy tokens equal the CPU plain path's."""
    cfg = reduced(get_config("mamba2-130m"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_card(v) for v in tree]
        return tree.to(card)

    on_card = to_card(params)
    tokens = np.random.default_rng(14).integers(0, cfg.vocab, (2, 21)).astype(np.int32)
    eng = ContinuousEngine(cfg, on_card, n_slots=2, max_len=48, page=8, device=card)
    assert eng.attn_kernel == "cuda"
    for mod in (RN, SSD, PA):
        mod.launches = 0
    got = eng.generate({"tokens": tokens}, n_steps=6)
    joins, steps = eng.n_joins, eng.n_decode_steps
    assert (joins, steps) == (2, 5)
    assert SSD.launches == joins * cfg.n_layers
    assert RN.launches == (joins + steps) * (cfg.n_layers + 1)
    assert PA.launches == 0
    want = ContinuousEngine(cfg, params, n_slots=2, max_len=48, page=8, device="cpu").generate(
        {"tokens": tokens}, n_steps=6)
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# the other families: MoE on the card, the engines' launches and tokens
# --------------------------------------------------------------------------

@pytest.mark.parametrize("routing", ["capacity", "dropless"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mixtral-8x22b"])
def test_moe_layer_on_card_matches_cpu(card, arch, routing):
    """The MoE layer at granite's full width (d 1536, 40 experts top-8, 512
    wide) and at reduced mixtral, fp32: 128 tokens skewed toward one
    direction (capacity routing drops assignments) or 8 (dropless, as at
    decode).  Routing equal to the CPU's, out and aux at the fp32 bar, and
    no host synchronisation on the way."""
    from repro_torch.models import moe as TM
    from repro_torch.models.layers import dtype_of

    cfg = get_config(arch) if arch.startswith("granite") else reduced(get_config(arch))
    params = TM.init_moe(cfg, torch.Generator().manual_seed(0), dtype_of("float32"), "cpu")
    rng = np.random.default_rng(1)
    t = 8 if routing == "dropless" else 128
    x = (rng.normal(0, 1, (1, t, cfg.d_model)) + 1.5 * rng.normal(0, 1, cfg.d_model))
    x = torch.from_numpy(x.astype(np.float32))
    cap = t if routing == "dropless" else 0
    want, want_aux = TM.moe_forward(cfg, params, x, cap_override=cap)
    on_card = {k: v.to(card) for k, v in params.items()}
    x_card = x.to(card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, aux = TM.moe_forward(cfg, on_card, x_card, cap_override=cap)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _, _, idx = TM.route(cfg, on_card, x_card.reshape(t, -1))
    _, _, want_idx = TM.route(cfg, params, x.reshape(t, -1))
    assert torch.equal(idx.cpu(), want_idx)
    _, keep = TM.positions(want_idx, cfg.n_experts, cap or TM.capacity(cfg, t))
    assert bool(keep.all()) == (routing == "dropless")
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=2e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mixtral-8x22b", "internvl2-1b",
                                  "musicgen-large", "olmo-1b"])
def test_family_engine_on_card_matches_cpu(card, arch):
    """A reduced model of each other family on the card with no kernel
    named: the paged kernel once per layer a step, flash once per layer a
    join, RMSNorm 2 * layers + 1 times a join and a step where the norm is
    RMSNorm and never otherwise; greedy tokens equal the CPU plain path's
    (the prefix archs with their prefix embeddings)."""
    cfg = reduced(get_config(arch))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(15)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)}
    if cfg.n_prefix:
        batch["prefix_embeds"] = rng.normal(0, 0.02, (2, cfg.n_prefix, cfg.d_model)).astype(
            np.float32)
    eng = ContinuousEngine(cfg, _to(params, card), n_slots=2, max_len=40, page=8, device=card)
    for mod in (RN, FA, PA):
        mod.launches = 0
    got = eng.generate(batch, n_steps=6)
    joins, steps = eng.n_joins, eng.n_decode_steps
    assert (joins, steps) == (2, 5)
    norms = 2 * cfg.n_layers + 1 if cfg.norm == "rmsnorm" else 0
    assert RN.launches == (joins + steps) * norms
    assert FA.launches == joins * cfg.n_layers
    assert PA.launches == steps * cfg.n_layers
    want = ContinuousEngine(cfg, params, n_slots=2, max_len=40, page=8, device="cpu").generate(
        batch, n_steps=6)
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# the split walk (S blocks per (slot, kv head), then the combine)
# --------------------------------------------------------------------------

SPLIT_SHAPES = {
    "llama3.2-1b": dict(b=8, hkv=8, g=4, d=64, page=16, m=11),
    "recurrentgemma-2b": dict(b=8, hkv=1, g=10, d=256, page=16, m=144),
    # the slots fill the card: S = 1, a run of 40 pages in five tiles of 8
    "one split": dict(b=64, hkv=8, g=4, d=64, page=16, m=40),
    # odd G (a warp's second head idle), rows not whole 16-byte chunks
    "odd shapes": dict(b=6, hkv=2, g=3, d=20, page=8, m=6),
    # the other families' decode shapes
    "granite-moe-3b-a800m": dict(b=8, hkv=8, g=3, d=64, page=16, m=11),
    "internvl2-1b": dict(b=8, hkv=2, g=7, d=64, page=16, m=11),
    "glm4-9b": dict(b=8, hkv=2, g=16, d=128, page=16, m=11),
    "internlm2-1.8b": dict(b=8, hkv=8, g=2, d=128, page=16, m=11),
    "olmo-1b": dict(b=8, hkv=16, g=1, d=128, page=16, m=11),
    "mixtral-8x22b": dict(b=8, hkv=8, g=6, d=128, page=16, m=272),
    "musicgen-large": dict(b=8, hkv=32, g=1, d=64, page=16, m=11),
}


def split_case(card, page_dtype, shape, window, seed=21):
    """``case`` with positions that probe the split walk: a slot with fewer
    live pages than splits, a position on a page's last row and one on its
    first, a window edge that cuts a page, and an idle last slot on scratch
    page 0."""
    ins = case(card, page_dtype, seed=seed, **shape)
    page, m = shape["page"], shape["m"]
    pos = ins["pos"].cpu().numpy()
    pos[:4] = [2, page * (m // 2) - 1, page * (m // 2), m * page - 1]
    if window:
        pos[4] = min(m * page - 1, window + page + page // 3)
    table = ins["table"].cpu().numpy()
    table[-1], pos[-1] = 0, 0
    b = shape["b"]
    ins.update(table=torch.from_numpy(table).to(card), pos=torch.from_numpy(pos).to(card),
               page_idx=torch.from_numpy(table[np.arange(b), pos // page]).to(card),
               off=torch.from_numpy(pos % page).to(card))
    return ins


def splits_of(card, shape, window):
    return PA.split_plan(shape["b"], shape["hkv"], shape["m"], shape["page"], window,
                         PA.sm_count(card))[0]


SPLIT_CASES = [("llama3.2-1b", 0), ("llama3.2-1b", 40), ("recurrentgemma-2b", 2048),
               ("one split", 0), ("odd shapes", 12), ("granite-moe-3b-a800m", 0),
               ("internvl2-1b", 0), ("glm4-9b", 0), ("internlm2-1.8b", 0), ("olmo-1b", 0),
               ("mixtral-8x22b", 4096), ("musicgen-large", 0)]
SPLIT_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-4), torch.int8: dict(atol=2e-5, rtol=2e-4),
             torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}
SLOT_REL_TOL = 2e-2      # bf16 pages: a slot's max error over that slot's output RMS


def worst_slot_ratio(got, want):
    """The worst slot's max error over that slot's output RMS: 3e-2 is of
    the order of the outputs at recurrentgemma's shapes, so bf16 pages are
    held to each slot's own scale too."""
    err = (got.float() - want.float()).abs().flatten(1).amax(1)
    rms = want.float().pow(2).flatten(1).mean(1).sqrt()
    return float((err / rms).max())


@pytest.mark.parametrize("page_dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("name,window", SPLIT_CASES)
def test_split_walk_matches_plain_on_card(card, name, window, page_dtype):
    """The fused and the unfused kernel against their plain versions (fp32
    query: fp32 and int8 pages at 2e-5 / 2e-4, bf16 pages at 3e-2 and each
    slot within 2e-2 of its RMS) with S > 1 at both paths' shapes and at odd
    ones, and S = 1 where the slots fill the card."""
    shape = SPLIT_SHAPES[name]
    assert (splits_of(card, shape, window) > 1) == (name != "one split")
    ins = split_case(card, page_dtype, shape, window)
    if window:
        assert int(ins["pos"].max()) >= window + shape["page"]
    plain = {k: v.clone() for k, v in ins.items()}
    got = PA.paged_attention_scatter(**ins, window=window)
    want = PA.paged_attention_scatter_plain(**plain, window=window)
    pool = {k: ins[k] for k in ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages")
            if k in ins}
    got_u = PA.paged_attention(ins["q"], **pool, table=ins["table"], pos=ins["pos"],
                               window=window)
    want_u = PA.paged_attention_plain(ins["q"], **pool, table=ins["table"], pos=ins["pos"],
                                      window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **SPLIT_TOL[page_dtype])
    torch.testing.assert_close(got_u, want_u, **SPLIT_TOL[page_dtype])
    if page_dtype == torch.bfloat16:
        assert worst_slot_ratio(got, want) <= SLOT_REL_TOL
        assert worst_slot_ratio(got_u, want_u) <= SLOT_REL_TOL
    for k in pool:
        assert torch.equal(ins[k][1:], plain[k][1:]), k


@pytest.mark.parametrize("page_dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("name,window", SPLIT_CASES)
def test_split_fused_is_scatter_then_attention_and_repeats_bit_for_bit(card, name, window,
                                                                       page_dtype):
    """With S > 1 the fused kernel's output and every page equal the scatter
    kernel's followed by the attention kernel's, bit for bit; and a second
    launch of each on the same inputs gives the same bits (the combine's
    order is fixed)."""
    ins = split_case(card, page_dtype, SPLIT_SHAPES[name], window, seed=22)
    runs = []
    for _ in range(2):
        fused = {k: v.clone() for k, v in ins.items()}
        split = {k: v.clone() for k, v in ins.items()}
        out = PA.paged_attention_scatter(**fused, window=window)
        PA.paged_scatter(*scatter_args(split), split["page_idx"], split["off"])
        pool = {k: split[k] for k in ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages")
                if k in split}
        want = PA.paged_attention(split["q"], **pool, table=split["table"], pos=split["pos"],
                                  window=window)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        for k in pool:
            assert torch.equal(fused[k], split[k]), k
        runs.append(out)
    assert torch.equal(runs[0], runs[1])


# --------------------------------------------------------------------------
# the sampler (repro_torch.jrandom) on the card against the same call on CPU
# --------------------------------------------------------------------------

def assert_near_tie(scores) -> None:
    """The near-tie rule of ``tests/test_torch_jrandom.py``: where two draws
    differ, the two highest perturbed scores lie within 1e-5 relative."""
    second, top = np.sort(scores.double().cpu().numpy())[-2:]
    assert top - second <= 1e-5 * abs(top), (top, second)


@pytest.mark.parametrize("vocab", [128256, 256000, 50280])
def test_sampler_on_card_matches_cpu(card, vocab):
    """Bits and uniforms bit-equal on the card and on the CPU; tokens equal
    under the near-tie rule, for the static and the per-row draw."""
    key = jrandom.fold_in(jrandom.key(5), vocab)
    for shape in ((8, vocab), (3, 700)):
        assert torch.equal(jrandom.bits(key.to(card), shape).cpu(), jrandom.bits(key, shape))
        assert torch.equal(jrandom.uniform(key.to(card), shape).cpu(),
                           jrandom.uniform(key, shape))
    raw = torch.from_numpy(np.random.default_rng(vocab).normal(0, 3, (8, vocab)).astype(np.float32))
    logits = TE._tempered(raw, 0.8)
    # a true division on the card too, not a product with the reciprocal
    assert torch.equal(TE._tempered(raw.to(card), 0.8).cpu(), logits)
    keys = jrandom.fold_in(jrandom.fold_in(key, torch.arange(8)), 3)
    rows_cpu = jrandom.categorical_rows(keys, logits)
    rows_card = jrandom.categorical_rows(keys, logits.to(card)).cpu()
    counters = torch.arange(vocab)
    for r in torch.nonzero(rows_cpu != rows_card).flatten().tolist():
        hashed = jrandom._hash(keys[r, 0], keys[r, 1], counters)
        assert_near_tie(jrandom._gumbel_from(hashed, torch.float32) + logits[r])
    static_cpu = jrandom.categorical(key, logits)
    static_card = jrandom.categorical(key, logits.to(card)).cpu()
    scores = jrandom.gumbel(key, logits.shape) + logits
    for r in torch.nonzero(static_cpu != static_card).flatten().tolist():
        assert_near_tie(scores[r])


# --------------------------------------------------------------------------
# the instrumented collectives stamp a rank's arrival when its device arrives
# --------------------------------------------------------------------------

SPIN_CYCLES = 50_000_000          # torch.cuda._sleep: tens of ms at the H100's clocks


@pytest.fixture
def nccl_world_of_one(card):
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    TI.reset_instrumentation()
    try:
        yield torch.ones(1024, device=card)
    finally:
        TI.reset_instrumentation()
        dist.destroy_process_group()


@pytest.mark.parametrize("pair", ["blocking", "async"])
def test_compute_queued_on_the_card_is_not_slack(nccl_world_of_one, pair):
    """A rank arrives at a collective when its device does.  In a world of
    1, where no rank waits, a kernel still running when the host reaches
    ``cd_psum`` delays the enter stamp and leaves the booked slack about 0;
    one queued between ``cd_psum_async`` and ``cd_wait`` is overlap."""
    x = nccl_world_of_one
    TI.set_mode("barrier")
    TI.cd_psum(x)                       # the communicators, the barrier group's too, warm
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SPIN_CYCLES)
    end.record()
    torch.cuda.synchronize()
    spin = start.elapsed_time(end) / 1e3
    assert spin > 0.01, spin
    gov, events = Governor(policy=COUNTDOWN_SLACK), {}
    TI.get_event_bus().subscribe(gov)
    TI.set_event_sink(lambda r, p, c, t: events.setdefault(p, t))
    TI.set_mode("profile")
    TI.enable_events(True)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    if pair == "blocking":
        torch.cuda._sleep(SPIN_CYCLES)
        out = TI.cd_psum(x)
    else:
        h = TI.cd_psum_async(x)
        torch.cuda._sleep(SPIN_CYCLES)
        out = TI.cd_wait(h)
    rep = gov.finalize()
    enter = events["barrier_enter" if pair == "blocking" else "wait_enter"]
    assert torch.equal(out, x) and rep.n_calls == 1
    assert enter - t0 >= 0.9 * spin, (events, t0, spin)
    assert rep.total_slack < 0.1 * spin, (rep.total_slack, spin)
    if pair == "async":
        assert rep.total_overlap >= 0.9 * spin, (rep.total_overlap, spin)


# --------------------------------------------------------------------------
# training: the wrappers refuse autograd; a step on the card equals the CPU's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(wrapper_calls("cpu", False)))
def test_wrapper_refuses_a_launch_autograd_would_record(card, name):
    """A kernel's output has no ``grad_fn``: with grad enabled and an input
    that requires grad, the wrapper raises and names the plain version
    instead of cutting the graph; under ``torch.no_grad`` it launches."""
    with pytest.raises(RuntimeError, match="the kernel has no backward"):
        wrapper_calls(card, True)[name]()
    with torch.no_grad():
        wrapper_calls(card, True)[name]()
    torch.cuda.synchronize()


def test_train_step_on_card_equals_cpu(card):
    """Two steps of a tiny fp32 model from one state on the same batches:
    the card's (plain PyTorch under autograd, no kernel) against the CPU's,
    losses rtol 1e-5, parameters atol 1e-5."""
    from repro_torch.train import loop as TLoop
    from repro_torch.train.data import DataLoader
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.tree import leaves

    cfg = reduced(get_config("countdown-100m"), n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, d_ff=128, vocab=256)
    opt_cfg = OptConfig(warmup_steps=1, total_steps=10)
    cpu = TLoop.init_state(cfg, opt_cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = TLoop.init_state(cfg, opt_cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = {"params": _to(on_card["params"], card), "opt": _to(on_card["opt"], card)}
    step = TLoop.make_train_step(cfg, opt_cfg)
    loader = DataLoader(cfg, batch=4, seq_len=33, seed=0)
    counts = [m.launches for m in (RN, FA, RS, SSD)]
    try:
        for _ in range(2):
            batch = next(loader)
            cpu, mc = step(cpu, batch)
            on_card, mg = step(on_card, _to(batch, card))
            np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]), rtol=1e-5)
    finally:
        loader.close()
    assert [m.launches for m in (RN, FA, RS, SSD)] == counts      # no kernel on the path
    for a, b in zip(leaves(on_card["params"]), leaves(cpu["params"])):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-5, rtol=0)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)
