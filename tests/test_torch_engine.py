"""The port's serving engines against the JAX package's, on the CPU.

Greedy tokens must match token for token (the dense rows of the
reference's own Pallas parity matrix, ``test_serve_paged.py``); the
bf16-compute configuration is held per step on logits under teacher
forcing.  Sampling with a temperature draws from ``torch.Generator``s,
which cannot reproduce ``jax.random``; it is checked for determinism only.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import init_params as jinit_params
from repro.models import transformer as JT
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import ServeEngine as JServeEngine
from repro.serve import engine as JE
from repro.serve import kvcache as JK
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.core.governor import Governor
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as TE
from repro_torch.serve import kvcache as TK
from repro_torch.serve.engine import ContinuousEngine, ServeEngine
from repro_torch.serve.scheduler import Request


def setup(seed=0, **mods):
    jcfg = dataclasses.replace(jreduced(jget_config("llama3.2-1b")), **mods)
    tcfg = dataclasses.replace(reduced(get_config("llama3.2-1b")), **mods)
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    tp = bridge.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def prompts(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


# --------------------------------------------------------------------------
# (e) greedy tokens, token for token
# --------------------------------------------------------------------------

ENGINE_MATRIX = [
    # (config overrides, prompt_len, max_len): page 8, 8 steps, so decode
    # crosses a page boundary and the table is 5 pages wide
    ({}, 12, 40),
    ({"kv_quant": True}, 12, 40),
    ({"attention": "swa", "window": 16}, 12, 40),
]


@pytest.mark.parametrize("mods,prompt_len,max_len", ENGINE_MATRIX)
def test_continuous_engine_matches_reference_token_for_token(mods, prompt_len, max_len):
    jcfg, tcfg, jp, tp = setup(**mods)
    toks = prompts(2, prompt_len, tcfg.vocab)
    want = np.asarray(JContinuousEngine(jcfg, jp, n_slots=3, max_len=max_len, page=8)
                      .generate({"tokens": jnp.asarray(toks)}, n_steps=8))
    for kernel in ("plain", "cuda"):          # cuda on CPU tensors: the plain version
        eng = ContinuousEngine(tcfg, tp, n_slots=3, max_len=max_len, page=8,
                               attn_kernel=kernel, device="cpu")
        got = eng.generate({"tokens": toks}, n_steps=8).numpy()
        np.testing.assert_array_equal(got, want)
        if tcfg.kv_quant:
            assert eng.pool.blocks["layers"][0]["k_pages"].dtype == torch.int8


def test_serve_engines_three_way():
    """Dense ServeEngine (reference and port) and the port's paged engine."""
    jcfg, tcfg, jp, tp = setup()
    toks = prompts(3, 14, tcfg.vocab, seed=1)
    want = np.asarray(JServeEngine(jcfg, jp, max_len=64)
                      .generate({"tokens": jnp.asarray(toks)}, n_steps=10))
    dense = ServeEngine(tcfg, tp, max_len=64, device="cpu").generate(
        {"tokens": toks}, n_steps=10).numpy()
    paged = ContinuousEngine(tcfg, tp, n_slots=3, max_len=40, page=8,
                             device="cpu").generate({"tokens": toks}, n_steps=10).numpy()
    np.testing.assert_array_equal(dense, want)
    np.testing.assert_array_equal(paged, want)


def test_join_on_prefill_evict_on_eos_reuses_slots():
    _, tcfg, _, tp = setup()
    eng = ContinuousEngine(tcfg, tp, n_slots=2, max_len=32, page=8, device="cpu")
    prompt = prompts(1, 8, tcfg.vocab)[0]
    done = eng.serve([Request(prompt=prompt, max_new=m, arrival=0.0) for m in (2, 9, 3, 7)])
    assert sorted(len(r.out) for r in done) == [2, 3, 7, 9]
    # slots were reused: 4 requests through 2 slots, pool fully reclaimed
    assert eng.pool.free_pages == eng.pool.capacity_pages
    assert eng._last_meter is None                   # no governor attached
    for r in done:
        assert r.slot == -1 and not r.pages


def test_eos_stops_generation_early():
    _, tcfg, _, tp = setup()
    eng = ContinuousEngine(tcfg, tp, n_slots=1, max_len=32, page=8, device="cpu")
    prompt = np.arange(8, dtype=np.int32)
    free_run = eng.serve([Request(prompt=prompt, max_new=10)])[0]
    eos = free_run.out[2]                            # force EOS at the 3rd token
    capped = eng.serve([Request(prompt=prompt, max_new=10, eos_id=int(eos))])[0]
    assert len(capped.out) <= 3 and capped.out[-1] == eos


def test_sampling_is_seeded_and_differs_from_greedy():
    _, tcfg, _, tp = setup()
    toks = prompts(2, 12, tcfg.vocab, seed=2)
    greedy = ContinuousEngine(tcfg, tp, n_slots=2, max_len=40, page=8, device="cpu")
    sampled = ContinuousEngine(tcfg, tp, n_slots=2, max_len=40, page=8, device="cpu",
                               temperature=1.0)
    assert greedy._fused_sample and not sampled._fused_sample
    g = greedy.generate({"tokens": toks}, n_steps=6)
    s1 = sampled.generate({"tokens": toks}, n_steps=6, seed=3)
    s2 = sampled.generate({"tokens": toks}, n_steps=6, seed=3)
    assert torch.equal(s1, s2) and not torch.equal(s1, g)
    assert torch.equal(sampled.generate({"tokens": toks}, n_steps=6), g)   # no seed: greedy
    with pytest.raises(ValueError, match="attn_kernel"):
        ContinuousEngine(tcfg, tp, attn_kernel="pallas", device="cpu")


# --------------------------------------------------------------------------
# (f) bf16 compute with fp32 params: per-step logits under teacher forcing
# --------------------------------------------------------------------------

def test_bf16_compute_logits_under_teacher_forcing():
    """``compute_dtype="bfloat16"`` with fp32 params, as full llama3.2-1b:
    JAX promotes ``bf16 @ fp32`` to fp32, so q reaches attention in fp32
    and fp32 K/V rows are rounded into bf16 pages.  Prefill and 6 paged
    decode steps fed the same tokens; logits agree to 3e-2.

    The reference runs unrolled (``scan_layers=False``): its scanned layer
    stack rejects this configuration, because block 0 turns the bf16 carry
    into fp32 (ROADMAP.md, queue 3).  The port has no scan."""
    jcfg, tcfg, jp, tp = setup(compute_dtype="bfloat16", scan_layers=False)
    page, n_steps = 8, 6
    toks = prompts(2, 12, tcfg.vocab, seed=4)
    forced = prompts(2, n_steps, tcfg.vocab, seed=5)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)

    jpool = JK.PagedKVPool(jcfg, 2, 32, page).blocks
    jjoin, jstep = jax.jit(JE.make_join_step(jcfg)), jax.jit(JE.make_paged_decode_step(jcfg))
    tpool = TK.PagedKVPool(tcfg, 2, 32, page, device="cpu").blocks
    tjoin, tstep = TE.make_join_step(tcfg), TE.make_paged_decode_step(tcfg)
    assert tpool["layers"][0]["k_pages"].dtype == torch.bfloat16
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
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=3e-2, rtol=3e-2)
        lengths += 1


# --------------------------------------------------------------------------
# the serve CLI and its governor
# --------------------------------------------------------------------------

def test_decode_slack_priced_with_actuation_pairs():
    _, tcfg, _, tp = setup()
    eng = ContinuousEngine(tcfg, tp, n_slots=4, max_len=32, page=8, device="cpu")
    prompt = np.arange(8, dtype=np.int32)
    gov = Governor()
    # a request at once, then one 100 ms into a second serve call (its clock
    # starts at the call, so the idle gap does not depend on how long the
    # first request took): both underfill (1 of 4 slots) and an idle
    # interval far above theta_eff
    eng.serve([Request(prompt=prompt, max_new=6, arrival=0.0)], governor=gov)
    eng.serve([Request(prompt=prompt, max_new=6, arrival=0.1)], governor=gov)
    rep = gov.finalize()
    assert rep.total_slack > 0 and rep.energy_baseline > rep.energy_policy
    downs = [a for a in gov.actuation_log if a[2] == "set_pstate_min"]
    restores = [a for a in gov.actuation_log if a[2] == "restore_pstate_max"]
    assert len(downs) >= 1 and len(downs) == len(restores)
    meter = eng._last_meter
    assert meter.n_idle >= 1 and meter.fill_fraction < 1.0
    assert meter.n_steps == len(eng._last_session.step_seconds) == 5


def test_serve_cli_continuous_on_cpu(capsys):
    res = tserve.main(["--reduced", "--continuous", "--device", "cpu", "--attn-kernel",
                       "cuda", "--n-requests", "4", "--steps", "6", "--prompt-len", "8"])
    assert res["completed"] == 4 and res["tokens"] > 0 and res["priced_slack_ms"] > 0
    assert '"tok_per_s"' in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="predictor"):
        tserve.main(["--reduced", "--continuous", "--device", "cpu", "--theta", "predictive"])
    with pytest.raises(SystemExit):
        tserve.main(["--reduced", "--device", "cpu"])
