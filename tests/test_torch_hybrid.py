"""The port's hybrid family (recurrentgemma-2b) against the JAX package, on the CPU.

The model is ``reduced(recurrentgemma-2b, n_layers=8, window=16)``: two
periods of ``("rglru", "rglru", "attn")`` plus the remainder
``("rglru", "rglru")``, so the bridge maps ``"rem"`` too, and a 16-token
attention window that decoding crosses.  Weights come from
``repro.models.init_params`` through ``repro_torch.bridge``; inputs from
numpy seeds.  Every check runs the port both on its plain path and with
``kernel="cuda"``, whose wrappers take their plain versions for CPU tensors
(the same arithmetic as the kernels, as ``chip_smoke.py`` holds them).
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import init_params as jinit_params
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import engine as JE
from repro.serve import kvcache as JK
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device, resolve_kernel
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import rglru_scan as RS
from repro_torch.kernels import rmsnorm as RN
from repro_torch.launch import serve as tserve
from repro_torch.models import rglru as TR
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as TE
from repro_torch.serve import kvcache as TK
from repro_torch.serve.engine import ContinuousEngine

KERNELS = ("plain", "cuda")


def cfgs(**mods):
    base = dict(n_layers=8, window=16)
    base.update(mods)
    return (jreduced(jget_config("recurrentgemma-2b"), **base),
            reduced(get_config("recurrentgemma-2b"), **base))


def weights(jcfg, tcfg, seed=0):
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    return jp, bridge.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")


def t(a):
    return bridge.tensor_from_numpy(np.asarray(a), "cpu")


def launch_counts():
    return (RN.launches, FA.launches, RS.launches, PA.launches)


def test_reduced_hybrid_has_a_remainder():
    _, tcfg = cfgs()
    assert TT.stack_layout(tcfg) == (2, ("rglru", "rglru"))
    assert tcfg.layer_kinds() == ("rglru", "rglru", "attn") * 2 + ("rglru", "rglru")
    full = get_config("recurrentgemma-2b")
    assert TT.stack_layout(full) == (8, ("rglru", "rglru"))
    assert full.layer_kinds().count("attn") == 8 and full.layer_kinds().count("rglru") == 18
    for name in ("internvl2-1b", "granite-moe-3b-a800m"):     # ported since
        TT.check_supported(jget_config(name))
    with pytest.raises(NotImplementedError, match="reference builds"):
        TT.check_supported(dataclasses.replace(full, family="ssm"))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_hybrid_bridge_round_trip_is_bit_exact(param_dtype):
    jcfg, tcfg = cfgs(param_dtype=param_dtype)
    jp, tp = weights(jcfg, tcfg)
    assert len(tp["layers"]) == 8 and "rem" in jp
    assert [("rglru" in p, "attn" in p) for p in tp["layers"]] == \
        [(k == "rglru", k == "attn") for k in tcfg.layer_kinds()]
    back = bridge.params_to_numpy(tcfg, tp, bf16_dtype=jnp.bfloat16)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    # a page pool with per-slot recurrent state crosses the same way
    pool = jax.tree.map(np.asarray, JK.init_pool_blocks(jcfg, 5, 8, 3))
    blocks = bridge.blocks_from_numpy(tcfg, pool, "cpu")
    assert set(blocks["layers"][0]) == {"conv", "h"} and blocks["layers"][0]["h"].shape == (3, 64)
    back = bridge.blocks_to_numpy(tcfg, blocks, bf16_dtype=jnp.bfloat16)
    assert jax.tree.structure(back) == jax.tree.structure(pool)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pool)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_port_init_params_has_the_reference_layout():
    jcfg, tcfg = cfgs()
    jp = jax.tree.map(np.asarray, jinit_params(jcfg, jax.random.PRNGKey(0)))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    mine = bridge.params_to_numpy(tcfg, tp)
    assert jax.tree.structure(mine) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(jp)):
        assert a.shape == b.shape and a.dtype == b.dtype
    lam = tp["layers"][0]["rglru"]["lam"]
    assert lam.dtype == torch.float32 and 2.5 <= float(lam.min()) <= float(lam.max()) <= 4.3


# --------------------------------------------------------------------------
# the RG-LRU block
# --------------------------------------------------------------------------

def rglru_params(jcfg, tcfg, seed=1):
    jp = JR.init_rglru(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    return jp, {k: t(v) for k, v in jp.items()}


def test_causal_depthwise_conv_matches():
    rng = np.random.default_rng(20)
    x = rng.normal(0, 1, (2, 9, 16)).astype(np.float32)
    w = rng.normal(0, 1, (4, 16)).astype(np.float32)
    want = JS.causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(TS.causal_depthwise_conv(t(x), t(w)).numpy(), np.asarray(want),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_forward_matches(with_state):
    """fp32 at 2e-5 / 2e-4: tanh-GELU, exact softplus, the scan (log-depth on
    the plain path, in time order through the kernel wrapper)."""
    jcfg, tcfg = cfgs()
    jp, tp = rglru_params(jcfg, tcfg)
    rng = np.random.default_rng(21)
    x = rng.normal(0, 1, (2, 11, tcfg.d_model)).astype(np.float32)
    state = {"conv": rng.normal(0, 1, (2, 3, 64)).astype(np.float32),
             "h": rng.normal(0, 1, (2, 64)).astype(np.float32)} if with_state else None
    want, want_state = JR.rglru_forward(
        jcfg, jp, jnp.asarray(x), None if state is None else jax.tree.map(jnp.asarray, state))
    for kernel in KERNELS:
        got, got_state = TR.rglru_forward(
            tcfg, tp, t(x), None if state is None else {k: t(v) for k, v in state.items()},
            kernel)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-4)
        if with_state:
            for name in ("conv", "h"):
                np.testing.assert_allclose(got_state[name].numpy(),
                                           np.asarray(want_state[name]), atol=2e-5, rtol=2e-4)
        else:
            assert got_state is None and want_state is None


def test_rglru_decode_matches():
    jcfg, tcfg = cfgs()
    jp, tp = rglru_params(jcfg, tcfg)
    rng = np.random.default_rng(22)
    state = {"conv": rng.normal(0, 1, (3, 3, 64)).astype(np.float32),
             "h": rng.normal(0, 1, (3, 64)).astype(np.float32)}
    jstate = jax.tree.map(jnp.asarray, state)
    tstate = {k: t(v) for k, v in state.items()}
    for _ in range(3):
        x = rng.normal(0, 1, (3, 1, tcfg.d_model)).astype(np.float32)
        want, jstate = JR.rglru_decode(jcfg, jp, jnp.asarray(x), jstate)
        got, tstate = TR.rglru_decode(tcfg, tp, t(x), tstate)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-4)
        for name in ("conv", "h"):
            np.testing.assert_allclose(tstate[name].numpy(), np.asarray(jstate[name]),
                                       atol=2e-5, rtol=2e-4)


# --------------------------------------------------------------------------
# the hybrid model
# --------------------------------------------------------------------------

def assert_caches_close(tcfg, jc, tc, atol=1e-5):
    want = bridge.blocks_from_numpy(tcfg, jax.tree.map(np.asarray, jc), "cpu")
    for kind, wl, gl in zip(tcfg.layer_kinds(), want["layers"], tc["layers"]):
        assert set(wl) == set(gl), kind
        for name in wl:
            if wl[name].dtype.is_floating_point:
                torch.testing.assert_close(gl[name], wl[name], atol=atol, rtol=atol)
            else:
                assert torch.equal(gl[name], wl[name]), name


@pytest.mark.parametrize("kernel", KERNELS)
def test_hybrid_prefill_and_decode_logits_and_caches_match(kernel):
    """fp32 logits at 1e-4 over prefill and 6 decode steps that cross the
    16-token window of the ring cache; recurrent state and K/V caches to 1e-5."""
    jcfg, tcfg = cfgs()
    jp, tp = weights(jcfg, tcfg)
    toks = np.random.default_rng(23).integers(0, tcfg.vocab, (2, 12)).astype(np.int32)
    jc = JT.init_cache(jcfg, 2, 32)
    jl, jc = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, jc)
    tc = TT.init_cache(tcfg, 2, 32, "cpu")
    before = launch_counts()
    tl, tc = TT.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, tc, kernel=kernel)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    assert_caches_close(tcfg, jc, tc)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for i in range(6):
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(tok), jnp.int32(12 + i), jc)
        tl, tc = TT.decode_step(tcfg, tp, torch.from_numpy(tok), 12 + i, tc, kernel=kernel)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    assert launch_counts() == before                  # CPU: never a kernel
    assert_caches_close(tcfg, jc, tc)


@pytest.mark.parametrize("kernel", KERNELS)
def test_continuous_engine_matches_reference_token_for_token(kernel):
    """Two prompts of 12 tokens, 10 greedy steps through 3 slots, page 8:
    decoding runs to position 21, past the 16-token window, so the paged
    read drops the first page."""
    jcfg, tcfg = cfgs()
    jp, tp = weights(jcfg, tcfg)
    toks = np.random.default_rng(24).integers(0, tcfg.vocab, (2, 12)).astype(np.int32)
    want = np.asarray(JContinuousEngine(jcfg, jp, n_slots=3, max_len=32, page=8)
                      .generate({"tokens": jnp.asarray(toks)}, n_steps=10))
    eng = ContinuousEngine(tcfg, tp, n_slots=3, max_len=32, page=8, attn_kernel=kernel,
                           device="cpu")
    got = eng.generate({"tokens": toks}, n_steps=10).numpy()
    np.testing.assert_array_equal(got, want)
    assert eng.n_joins == 2 and eng.n_decode_steps == 9
    assert eng.pool.blocks["layers"][0]["h"].shape == (3, 64)
    # a prompt that does not fit the window is refused, as in the reference
    with pytest.raises(ValueError, match="window"):
        eng.serve([TE.Request(prompt=np.zeros(17, np.int32), max_new=2)])


def test_bf16_compute_logits_under_teacher_forcing():
    """``compute_dtype="bfloat16"`` with fp32 params, as full recurrentgemma-2b:
    the residual turns fp32 in block 0, the RG-LRU's conv state is rounded
    into the bf16 pool at join and every step, fp32 K/V rows into bf16
    pages.  Prefill and 6 paged decode steps past the window, fed the same
    tokens; logits agree to 3e-2.  The reference runs unrolled
    (``scan_layers=False``), as in ``test_torch_engine``."""
    jcfg, tcfg = cfgs(compute_dtype="bfloat16", scan_layers=False)
    jp, tp = weights(jcfg, tcfg)
    page, n_steps = 8, 6
    toks = np.random.default_rng(25).integers(0, tcfg.vocab, (2, 12)).astype(np.int32)
    forced = np.random.default_rng(26).integers(0, tcfg.vocab, (2, n_steps)).astype(np.int32)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    jpool = JK.PagedKVPool(jcfg, 2, 32, page).blocks
    jjoin, jstep = jax.jit(JE.make_join_step(jcfg)), jax.jit(JE.make_paged_decode_step(jcfg))
    tpool = TK.PagedKVPool(tcfg, 2, 32, page, device="cpu").blocks
    tjoin, tstep = TE.make_join_step(tcfg), TE.make_paged_decode_step(tcfg)
    assert tpool["layers"][0]["conv"].dtype == torch.bfloat16
    assert tpool["layers"][2]["k_pages"].dtype == torch.bfloat16
    for slot in range(2):
        jc = JT.init_cache(jcfg, 1, 16)
        jl, jc = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[slot:slot + 1])}, jc)
        jpool = jjoin(jpool, jc, jnp.asarray(table[slot, :2]), jnp.int32(slot))
        tc = TT.init_cache(tcfg, 1, 16, "cpu")
        tl, tc = TT.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[slot:slot + 1])}, tc)
        tpool = tjoin(tpool, tc, torch.from_numpy(table[slot, :2]), slot)
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=3e-2, rtol=3e-2)
    lengths = np.array([12, 12], np.int32)
    for i in range(n_steps):
        m_live = int(lengths.max()) // page + 1
        jl, jpool = jstep(jp, jnp.asarray(forced[:, i]), jnp.asarray(lengths),
                          jnp.asarray(table[:, :m_live]), jpool)
        with torch.no_grad():
            tl, tpool = tstep(tp, torch.from_numpy(forced[:, i]), torch.from_numpy(lengths),
                              torch.from_numpy(np.ascontiguousarray(table[:, :m_live])), tpool)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=3e-2, rtol=3e-2)
        lengths += 1


# --------------------------------------------------------------------------
# the kernel choice follows the device
# --------------------------------------------------------------------------

def test_kernel_choice_follows_the_device(monkeypatch):
    """``None`` (the default of the engine, the step factory and the
    launcher) means plain PyTorch on the CPU and the kernels on a CUDA
    device; an explicit choice stands; an unknown one is refused."""
    assert inspect.signature(ContinuousEngine).parameters["attn_kernel"].default is None
    assert inspect.signature(TE.make_paged_decode_step).parameters["attn_kernel"].default \
        is None
    assert tserve.parser().parse_args([]).attn_kernel is None
    assert resolve_kernel(None, "cpu") == "plain"
    assert resolve_kernel(None, torch.device("cuda", 0)) == "cuda"
    assert resolve_kernel("plain", torch.device("cuda", 0)) == "plain"
    with pytest.raises(ValueError, match="attn_kernel"):
        resolve_kernel("pallas", "cpu")
    with pytest.raises(ValueError, match="attn_kernel"):
        TE.make_paged_decode_step(cfgs()[1], "xla")
    _, tcfg = cfgs()
    params = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert ContinuousEngine(tcfg, params, max_len=32, page=8, device="cpu").attn_kernel \
        == "plain"
    # a CUDA device, as the entry points see it when none is named
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_kernel(None, resolve_device(None)) == "cuda"


def test_serve_cli_hybrid_with_a_long_prompt_on_cpu():
    """The launcher serves the hybrid family; ``--long-prompt`` adds one
    request whose decode crosses the window; the kernel choice defaults to
    plain on the CPU."""
    res = tserve.main(["--arch", "recurrentgemma-2b", "--reduced", "--continuous",
                       "--device", "cpu", "--n-requests", "3", "--steps", "6",
                       "--prompt-len", "8", "--long-prompt", "60", "--page-size", "4"])
    assert res["attn_kernel"] == "plain" and res["completed"] == 4
    long = [r for r in res["objects"]["requests"] if len(r.prompt) == 60]
    assert len(long) == 1 and len(long[0].out) == 6            # decodes to position 65 > 64
    assert res["joins"] == 4 and res["priced_slack_ms"] > 0
