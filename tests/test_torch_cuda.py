"""The port's CUDA kernel on the card: skipped where there is no NVIDIA GPU.

Run them on a machine with one (an H100 for the ``sm_90a`` build):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which this file does
not need.)
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import paged_attention as PA
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import ContinuousEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
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
