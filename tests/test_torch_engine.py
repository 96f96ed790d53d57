"""The port's serving engines against the JAX package's, on the CPU.

Greedy tokens must match token for token (the dense rows of the
reference's own Pallas parity matrix, ``test_serve_paged.py``); the
bf16-compute configuration is held per step on logits under teacher
forcing.  Sampled tokens (``repro_torch.jrandom``, the draws of
``jax.random``) must match token for token too, under the near-tie rule
of ``test_torch_jrandom.py``: where the port and the reference draw
different tokens, the reference's two highest perturbed scores at that
draw lie within 1e-5 relative of each other, and the comparison of that
request stops there.  Any other difference fails.
"""
import argparse
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
from repro.launch import serve as jserve
from repro.serve import kvcache as JK
from repro_torch import bridge
from repro_torch import jrandom
from repro_torch.configs import get_config, reduced
from repro_torch.core.governor import Governor
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as TE
from repro_torch.serve import kvcache as TK
from repro_torch.serve.engine import ContinuousEngine, ServeEngine
from repro_torch.serve.scheduler import Request
from test_torch_jrandom import assert_near_tie, perturbed

# reduced configs of the served archs (as test_torch_hybrid / _ssm);
# countdown-100m, the training launcher's default, serves as a dense arch
ARCHS = {"llama3.2-1b": {}, "recurrentgemma-2b": dict(n_layers=8, window=16),
         "mamba2-130m": {}, "countdown-100m": {}}


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
    """At a temperature the port draws the reference's tokens from the same
    key, which differ from greedy; no key is greedy, as in the reference."""
    jcfg, tcfg, jp, tp = setup()
    toks = prompts(2, 12, tcfg.vocab, seed=2)
    greedy = ContinuousEngine(tcfg, tp, n_slots=2, max_len=40, page=8, device="cpu")
    sampled = ContinuousEngine(tcfg, tp, n_slots=2, max_len=40, page=8, device="cpu",
                               temperature=1.0)
    assert greedy._fused_sample and not sampled._fused_sample
    ref = RecordingContinuous(jcfg, jp, n_slots=2, max_len=40, page=8, temperature=1.0)
    want = np.asarray(ref.generate({"tokens": jnp.asarray(toks)}, n_steps=6,
                                   key=jax.random.PRNGKey(3)))
    g = greedy.generate({"tokens": toks}, n_steps=6)
    s1 = sampled.generate({"tokens": toks}, n_steps=6, key=jrandom.key(3))
    s2 = sampled.generate({"tokens": toks}, n_steps=6, key=jrandom.key(3))
    assert torch.equal(s1, s2) and not torch.equal(s1, g)
    assert_same_draws(s1.numpy(), want, ref.row_scores(jax.random.PRNGKey(3)))
    assert torch.equal(sampled.generate({"tokens": toks}, n_steps=6), g)   # no key: greedy
    with pytest.raises(ValueError, match="attn_kernel"):
        ContinuousEngine(tcfg, tp, attn_kernel="pallas", device="cpu")


# --------------------------------------------------------------------------
# sampled tokens against the reference's jax.random draws, three archs
# --------------------------------------------------------------------------

class RecordingContinuous(JContinuousEngine):
    """The reference's engine, keeping each draw's perturbed scores by the
    request's key words and the token's index."""

    def __post_init__(self):
        super().__post_init__()
        self.scores = {}

    def _select_one(self, logits, req):
        if self.temperature > 0.0 and req.key is not None:
            sub = jax.random.fold_in(req.key, req.n_generated)
            words = tuple(np.asarray(req.key).tolist())
            self.scores[words, req.n_generated] = perturbed(sub, logits, self.temperature)
        return super()._select_one(logits, req)

    def row_scores(self, key):
        """scores(row, n) for ``generate(..., key)``: row i's key is fold_in(key, i)."""
        return lambda r, n: self.scores[
            tuple(np.asarray(jax.random.fold_in(key, r)).tolist()), n]


class RecordingServe(JServeEngine):
    """The reference's static engine, keeping each step's perturbed scores."""

    def __post_init__(self):
        super().__post_init__()
        self.scores = {}

    def _select(self, logits, key, i):
        if self.temperature > 0.0 and key is not None:
            self.scores[i] = perturbed(jax.random.fold_in(key, i), logits, self.temperature)
        return super()._select(logits, key, i)


def assert_same_draws(got, want, scores_at) -> None:
    """Token for token, under the near-tie rule: ``scores_at(row, n)`` gives
    the reference's perturbed scores at the draw of row's n-th token."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for r in range(len(want)):
        diff = np.flatnonzero(got[r] != want[r])
        if len(diff):
            assert_near_tie(scores_at(r, int(diff[0])), f"row {r}, token {int(diff[0])}")


def arch_setup(arch, seed=0):
    jcfg = jreduced(jget_config(arch), **ARCHS[arch])
    tcfg = reduced(get_config(arch), **ARCHS[arch])
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, bridge.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_continuous_engine_samples_the_reference_tokens(arch):
    """``ContinuousEngine(temperature=0.8).generate(batch, n, key)``: row i
    draws with ``fold_in(key, i)``, its n-th token with
    ``fold_in(fold_in(key, i), n)``, as the reference's."""
    jcfg, tcfg, jp, tp = arch_setup(arch)
    toks = prompts(3, 8, tcfg.vocab, seed=5)
    kw = dict(n_slots=3, max_len=32, page=8, temperature=0.8)
    ref = RecordingContinuous(jcfg, jp, **kw)
    want = np.asarray(ref.generate({"tokens": jnp.asarray(toks)}, n_steps=8,
                                   key=jax.random.PRNGKey(21)))
    got = ContinuousEngine(tcfg, tp, device="cpu", **kw).generate(
        {"tokens": toks}, n_steps=8, key=jrandom.key(21)).numpy()
    assert_same_draws(got, want, ref.row_scores(jax.random.PRNGKey(21)))
    assert len(ref.scores) == 3 * 8


@pytest.mark.parametrize("arch", list(ARCHS))
def test_serve_engine_samples_the_reference_tokens(arch):
    """The static engine: one key a step, ``fold_in(key, i)``, over the
    whole (B, V) logits, as the reference's ``_select``."""
    jcfg, tcfg, jp, tp = arch_setup(arch)
    toks = prompts(3, 8, tcfg.vocab, seed=6)
    ref = RecordingServe(jcfg, jp, max_len=32, temperature=0.8)
    want = np.asarray(ref.generate({"tokens": jnp.asarray(toks)}, n_steps=6,
                                   key=jax.random.PRNGKey(22)))
    got = ServeEngine(tcfg, tp, max_len=32, temperature=0.8, device="cpu").generate(
        {"tokens": toks}, n_steps=6, key=jrandom.key(22)).numpy()
    assert_same_draws(got, want, lambda r, n: ref.scores[n][r])
    assert sorted(ref.scores) == list(range(6))


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
    res = tserve.main(["--reduced", "--continuous", "--device", "cpu", "--theta", "predictive"])
    assert res["policy"] == "cntd_predictive" and res["completed"] == 8
    assert res["priced_slack_ms"] > 0 and res["objects"]["governor"].n_predictor_decisions > 0
    # a world of 1: the largest degree that divides it is 1, nothing is wrapped
    res = tserve.main(["--reduced", "--device", "cpu", "--model-parallel", "2", "--steps", "2"])
    assert res["mesh"] is None and res["shape"] == [4, 2]


def test_serve_cli_samples_the_reference_tokens_at_its_default_temperature():
    """The launcher's default temperature is the reference's 0.8; request i
    gets the reference's key ``fold_in(PRNGKey(seed), i)`` and prompt, and
    the reference's engine, given the run's weights and the reference's
    requests, draws the tokens the launcher served."""
    argv = ["--reduced", "--continuous", "--device", "cpu", "--n-requests", "4",
            "--steps", "6", "--prompt-len", "8", "--seed", "3"]
    args = tserve.parser().parse_args(argv)
    assert args.temperature == 0.8
    res = tserve.run_continuous(args)
    assert res["temperature"] == 0.8 and res["completed"] == 4
    eng = res["objects"]["engine"]
    jcfg = jreduced(jget_config("llama3.2-1b"))
    jargs = argparse.Namespace(seed=3, n_requests=4, arrival_rate=args.arrival_rate,
                               slots=args.slots, temperature=0.8, prompt_len=8, steps=6)
    jreqs = jserve._make_requests(jargs, jcfg)
    treqs = tserve._make_requests(args, eng.cfg)
    for jr, tr in zip(jreqs, treqs, strict=True):
        np.testing.assert_array_equal(tr.prompt, jr.prompt)
        assert (tr.max_new, tr.arrival) == (jr.max_new, jr.arrival)
        np.testing.assert_array_equal(tr.key.numpy(), np.asarray(jr.key).astype(np.int64))
    jp = jax.tree.map(jnp.asarray, bridge.params_to_numpy(eng.cfg, eng.params))
    ref = RecordingContinuous(jcfg, jp, n_slots=args.slots, max_len=eng.max_len,
                              page=args.page_size, temperature=0.8)
    want = {r.prompt.tobytes(): r for r in ref.serve(jreqs)}
    for r in res["objects"]["requests"]:
        w = want[r.prompt.tobytes()]
        words = tuple(np.asarray(w.key).tolist())
        assert_same_draws([r.out], [w.out], lambda _, n: ref.scores[words, n])
