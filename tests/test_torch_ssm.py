"""The port's SSM family (mamba2-130m) against the JAX package, on the CPU.

The model is ``reduced(mamba2-130m)``: 2 layers of ``("ssm",)``, d 128,
d_inner 256, 16 heads of P 16, state N 16, chunk 16.  Weights come from
``repro.models.init_params`` through ``repro_torch.bridge``; inputs from
numpy seeds.  Every model check runs the port both on its plain path and
with ``kernel="cuda"``, whose wrappers take their plain versions for CPU
tensors (the same arithmetic the kernels are held to on the card by
``chip_smoke.py``).  The reference's SSD kernel runs in interpret mode, as
``tests/test_kernels.py`` runs it.  Tolerances: fp32 SSD at the
reference's own bar, atol 2e-4 / rtol 2e-3 (``test_kernels.py::test_ssd``);
blocks at 2e-5 / 2e-4 and logits at 1e-4 (fp32 summation order); bf16
compute at 3e-2 (one bf16 rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.kernels import ops as jops
from repro.models import init_params as jinit_params
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import engine as JE
from repro.serve import kvcache as JK
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssd as SSD
from repro_torch.launch import serve as tserve
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as TE
from repro_torch.serve import kvcache as TK
from repro_torch.serve.engine import ContinuousEngine

KERNELS = ("plain", "cuda")
SSD_TOL = dict(atol=2e-4, rtol=2e-3)
F32 = dict(atol=2e-5, rtol=2e-4)


def cfgs(**mods):
    return (jreduced(jget_config("mamba2-130m"), **mods),
            reduced(get_config("mamba2-130m"), **mods))


def weights(jcfg, tcfg, seed=0):
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    return jp, bridge.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")


def t(a):
    return bridge.tensor_from_numpy(np.asarray(a), "cpu")


def launch_counts():
    return (RN.launches, SSD.launches, PA.launches)


def ssd_inputs(rng, b, s, h, p, n, dtype=np.float32):
    return (rng.normal(0, 1, (b, s, h, p)).astype(dtype),
            rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (h,)).astype(np.float32),
            rng.normal(0, 1, (b, s, n)).astype(dtype),
            rng.normal(0, 1, (b, s, n)).astype(dtype))


# --------------------------------------------------------------------------
# the SSD scan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(64, 16), (100, 32), (7, 16), (32, 32)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference_and_pallas(s, chunk, with_state):
    """y and the final state against ``repro.models.ssm.ssd_chunked``, y
    against the Pallas kernel (interpret mode), and the wrapper's CPU
    branch is the same function: fp32 at 2e-4 / 2e-3."""
    rng = np.random.default_rng(30 + s)
    b, h, p, n = 2, 3, 16, 8
    x, dt, a_log, bb, cc = ssd_inputs(rng, b, s, h, p, n)
    h0 = rng.normal(0, 1, (b, h, p, n)).astype(np.float32) if with_state else None
    jy, jstate = JS.ssd_chunked(*map(jnp.asarray, (x, dt, a_log, bb, cc)), chunk,
                                None if h0 is None else jnp.asarray(h0))
    ty, tstate = TS.ssd_chunked(*map(t, (x, dt, a_log, bb, cc)), chunk,
                                None if h0 is None else t(h0))
    assert ty.dtype == torch.float32 and tstate.shape == (b, h, p, n)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SSD_TOL)
    np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate), **SSD_TOL)
    before = launch_counts()
    wy, wstate = SSD.ssd_scan(*map(t, (x, dt, a_log, bb, cc)), chunk=chunk,
                              init_state=None if h0 is None else t(h0))
    assert launch_counts() == before                   # CPU: never a kernel
    assert torch.equal(wy, ty) and torch.equal(wstate, tstate)
    if not with_state:
        pallas = jops.ssd_scan(*map(jnp.asarray, (x, dt, a_log, bb, cc)), chunk=chunk)
        np.testing.assert_allclose(ty.numpy(), np.asarray(pallas), **SSD_TOL)


def test_ssd_final_state_is_the_state_at_the_last_position():
    """A ragged last chunk is padded with dt = 0, so scanning S positions and
    then the rest from the returned state gives the whole scan's outputs."""
    rng = np.random.default_rng(31)
    x, dt, a_log, bb, cc = map(t, ssd_inputs(rng, 1, 45, 2, 16, 8))
    y_all, s_all = TS.ssd_chunked(x, dt, a_log, bb, cc, 16)
    y1, s1 = TS.ssd_chunked(x[:, :21], dt[:, :21], a_log, bb[:, :21], cc[:, :21], 16)
    y2, s2 = TS.ssd_chunked(x[:, 21:], dt[:, 21:], a_log, bb[:, 21:], cc[:, 21:], 16, s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_all, **SSD_TOL)
    torch.testing.assert_close(s2, s_all, **SSD_TOL)


def test_ssd_wrapper_refuses_other_devices():
    rng = np.random.default_rng(32)
    x, dt, a_log, bb, cc = map(t, ssd_inputs(rng, 1, 8, 2, 16, 8))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        SSD.ssd_scan(x.to("meta"), dt.to("meta"), a_log.to("meta"), bb.to("meta"),
                     cc.to("meta"), chunk=16)


# --------------------------------------------------------------------------
# the Mamba-2 block
# --------------------------------------------------------------------------

def ssm_params(jcfg, seed=1):
    jp = JS.init_ssm(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    return jp, {k: t(v) for k, v in jp.items()}


@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_forward_matches(with_state):
    """fp32 at 2e-5 / 2e-4 over a prompt of 21 (two chunks, the second
    ragged), from zeros or a given (conv, h) state."""
    jcfg, tcfg = cfgs()
    jp, tp = ssm_params(jcfg)
    rng = np.random.default_rng(33)
    conv_ch = tcfg.d_inner + 2 * tcfg.ssm_state
    x = rng.normal(0, 1, (2, 21, tcfg.d_model)).astype(np.float32)
    state = {"conv": rng.normal(0, 1, (2, 3, conv_ch)).astype(np.float32),
             "h": rng.normal(0, 1, (2, tcfg.ssm_heads, 16, 16)).astype(np.float32)
             } if with_state else None
    want, want_state = JS.ssm_forward(
        jcfg, jp, jnp.asarray(x), None if state is None else jax.tree.map(jnp.asarray, state))
    for kernel in KERNELS:
        got, got_state = TS.ssm_forward(
            tcfg, tp, t(x), None if state is None else {k: t(v) for k, v in state.items()},
            kernel)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        if with_state:
            for name in ("conv", "h"):
                np.testing.assert_allclose(got_state[name].numpy(),
                                           np.asarray(want_state[name]), **F32)
        else:
            assert got_state is None and want_state is None


def test_ssm_decode_matches():
    jcfg, tcfg = cfgs()
    jp, tp = ssm_params(jcfg)
    rng = np.random.default_rng(34)
    conv_ch = tcfg.d_inner + 2 * tcfg.ssm_state
    state = {"conv": rng.normal(0, 1, (3, 3, conv_ch)).astype(np.float32),
             "h": rng.normal(0, 1, (3, tcfg.ssm_heads, 16, 16)).astype(np.float32)}
    jstate = jax.tree.map(jnp.asarray, state)
    tstate = {k: t(v) for k, v in state.items()}
    for _ in range(3):
        x = rng.normal(0, 1, (3, 1, tcfg.d_model)).astype(np.float32)
        want, jstate = JS.ssm_decode(jcfg, jp, jnp.asarray(x), jstate)
        got, tstate = TS.ssm_decode(tcfg, tp, t(x), tstate)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        for name in ("conv", "h"):
            np.testing.assert_allclose(tstate[name].numpy(), np.asarray(jstate[name]), **F32)


def test_init_ssm_has_the_reference_layout():
    jcfg, tcfg = cfgs(param_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, JS.init_ssm(jcfg, jax.random.PRNGKey(0), jnp.bfloat16))
    tp = TS.init_ssm(tcfg, torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    assert set(tp) == set(jp)
    for k in jp:
        want = torch.float32 if jp[k].dtype == np.float32 else torch.bfloat16
        assert tuple(tp[k].shape) == jp[k].shape and tp[k].dtype == want, k
    for k in ("A_log", "dt_bias", "D"):
        assert tp[k].dtype == torch.float32
    assert 0.0 <= float(tp["A_log"].min()) <= float(tp["A_log"].max()) <= np.log(16.0)
    state = TS.init_ssm_state(tcfg, 2, torch.bfloat16, "cpu")
    jstate = JS.init_ssm_state(jcfg, 2, jnp.bfloat16)
    assert state["conv"].dtype == torch.bfloat16 and state["h"].dtype == torch.float32
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: v.shape for k, v in jstate.items()}


# --------------------------------------------------------------------------
# the SSM model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_ssm_bridge_round_trip_is_bit_exact(param_dtype):
    jcfg, tcfg = cfgs(param_dtype=param_dtype)
    jp, tp = weights(jcfg, tcfg)
    assert TT.stack_layout(tcfg) == (2, ()) and "rem" not in jp
    assert [set(p) for p in tp["layers"]] == [{"ln1", "ssm"}] * 2
    back = bridge.params_to_numpy(tcfg, tp, bf16_dtype=jnp.bfloat16)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    # the per-slot state of a page pool crosses the same way (and has no pages)
    pool = jax.tree.map(np.asarray, JK.init_pool_blocks(jcfg, 5, 8, 3))
    pool = jax.tree.map(lambda a: np.asarray(
        np.random.default_rng(35).normal(0, 1, a.shape)).astype(a.dtype), pool)
    blocks = bridge.blocks_from_numpy(tcfg, pool, "cpu")
    assert set(blocks["layers"][0]) == {"conv", "h"}
    assert blocks["layers"][0]["h"].shape == (3, tcfg.ssm_heads, 16, 16)
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
    full = get_config("mamba2-130m")
    assert full.layer_kinds() == ("ssm",) * 24 and TT.stack_layout(full) == (24, ())


def assert_caches_close(tcfg, jc, tc, atol=1e-5):
    want = bridge.blocks_from_numpy(tcfg, jax.tree.map(np.asarray, jc), "cpu")
    for wl, gl in zip(want["layers"], tc["layers"]):
        assert set(wl) == set(gl)
        for name in wl:
            torch.testing.assert_close(gl[name], wl[name], atol=atol, rtol=atol)


@pytest.mark.parametrize("kernel", KERNELS)
def test_ssm_prefill_and_decode_logits_and_caches_match(kernel):
    """fp32 logits at 1e-4 over a 21-token prefill (two chunks of 16, the
    second ragged) and 6 decode steps; the recurrent state to 1e-5."""
    jcfg, tcfg = cfgs()
    jp, tp = weights(jcfg, tcfg)
    toks = np.random.default_rng(36).integers(0, tcfg.vocab, (2, 21)).astype(np.int32)
    jc = JT.init_cache(jcfg, 2, 32)
    jl, jc = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, jc)
    tc = TT.init_cache(tcfg, 2, 32, "cpu")
    before = launch_counts()
    tl, tc = TT.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, tc, kernel=kernel)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    assert_caches_close(tcfg, jc, tc)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for i in range(6):
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(tok), jnp.int32(21 + i), jc)
        tl, tc = TT.decode_step(tcfg, tp, torch.from_numpy(tok), 21 + i, tc, kernel=kernel)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    assert launch_counts() == before                  # CPU: never a kernel
    assert_caches_close(tcfg, jc, tc)


@pytest.mark.parametrize("kernel", KERNELS)
def test_continuous_engine_matches_reference_token_for_token(kernel):
    """Reduced mamba2 through both packages' ContinuousEngine (the pattern
    of ``test_serve_paged.py``): two prompts of 16 tokens, 8 greedy steps,
    3 slots, page 8; the pool holds per-slot state and no pages."""
    jcfg, tcfg = cfgs()
    jp, tp = weights(jcfg, tcfg)
    toks = np.random.default_rng(37).integers(0, tcfg.vocab, (2, 16)).astype(np.int32)
    want = np.asarray(JContinuousEngine(jcfg, jp, n_slots=3, max_len=64, page=8)
                      .generate({"tokens": jnp.asarray(toks)}, n_steps=8))
    eng = ContinuousEngine(tcfg, tp, n_slots=3, max_len=64, page=8, attn_kernel=kernel,
                           device="cpu")
    got = eng.generate({"tokens": toks}, n_steps=8).numpy()
    np.testing.assert_array_equal(got, want)
    assert eng.n_joins == 2 and eng.n_decode_steps == 7
    layer = eng.pool.blocks["layers"][0]
    assert set(layer) == {"conv", "h"} and layer["h"].shape == (3, tcfg.ssm_heads, 16, 16)


def test_bf16_compute_logits_under_teacher_forcing():
    """``compute_dtype="bfloat16"`` with fp32 params, as full mamba2-130m:
    ``x @ w_in`` promotes to fp32, so the scan runs in fp32 and the residual
    turns fp32 in block 0; the prefill's fp32 conv state is rounded into
    the bf16 pool at the join and at every step.  Prefill of 21 tokens and 6
    paged decode steps fed the same tokens; logits agree to 3e-2.  The
    reference runs unrolled (``scan_layers=False``)."""
    jcfg, tcfg = cfgs(compute_dtype="bfloat16", scan_layers=False)
    jp, tp = weights(jcfg, tcfg)
    page, n_steps = 8, 6
    toks = np.random.default_rng(38).integers(0, tcfg.vocab, (2, 21)).astype(np.int32)
    forced = np.random.default_rng(39).integers(0, tcfg.vocab, (2, n_steps)).astype(np.int32)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    jpool = JK.PagedKVPool(jcfg, 2, 32, page).blocks
    jjoin, jstep = jax.jit(JE.make_join_step(jcfg)), jax.jit(JE.make_paged_decode_step(jcfg))
    tpool = TK.PagedKVPool(tcfg, 2, 32, page, device="cpu").blocks
    tjoin, tstep = TE.make_join_step(tcfg), TE.make_paged_decode_step(tcfg)
    assert tpool["layers"][0]["conv"].dtype == torch.bfloat16
    assert tpool["layers"][0]["h"].dtype == torch.float32
    for slot in range(2):
        jc = JT.init_cache(jcfg, 1, 24)
        jl, jc = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[slot:slot + 1])}, jc)
        jpool = jjoin(jpool, jc, jnp.asarray(table[slot, :3]), jnp.int32(slot))
        tc = TT.init_cache(tcfg, 1, 24, "cpu")
        tl, tc = TT.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[slot:slot + 1])}, tc)
        assert tc["layers"][0]["conv"].dtype == torch.float32       # promoted, as in JAX
        assert np.asarray(jc["stack"]["0"]["conv"]).dtype == np.float32
        tpool = tjoin(tpool, tc, torch.from_numpy(table[slot, :3]), slot)
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=3e-2, rtol=3e-2)
    lengths = np.array([21, 21], np.int32)
    for i in range(n_steps):
        m_live = int(lengths.max()) // page + 1
        jl, jpool = jstep(jp, jnp.asarray(forced[:, i]), jnp.asarray(lengths),
                          jnp.asarray(table[:, :m_live]), jpool)
        with torch.no_grad():
            tl, tpool = tstep(tp, torch.from_numpy(forced[:, i]), torch.from_numpy(lengths),
                              torch.from_numpy(np.ascontiguousarray(table[:, :m_live])), tpool)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=3e-2, rtol=3e-2)
        lengths += 1
    assert tpool["layers"][0]["conv"].dtype == torch.bfloat16


def test_serve_cli_mamba2_with_a_long_prompt_on_cpu():
    """The launcher serves the SSM family; ``--long-prompt`` adds one request
    whose prompt spans several chunks, the last one ragged."""
    res = tserve.main(["--arch", "mamba2-130m", "--reduced", "--continuous",
                       "--device", "cpu", "--n-requests", "3", "--steps", "6",
                       "--prompt-len", "8", "--long-prompt", "45", "--page-size", "4"])
    assert res["attn_kernel"] == "plain" and res["completed"] == 4
    assert res["arch"] == "mamba2-130m-smoke" and res["joins"] == 4
    long = [r for r in res["objects"]["requests"] if len(r.prompt) == 45]
    assert len(long) == 1 and len(long[0].out) == 6
    assert res["priced_slack_ms"] > 0
