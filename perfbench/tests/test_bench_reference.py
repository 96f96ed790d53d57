"""The plain reference against the served program at small sizes on the
CPU, and the check that decides ``correct`` seeing a planted fault."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness, reference, weights

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 96, "vocab": 256,
         "moe_d_ff": 32, "n_experts": 4, "top_k": 2}


def _model(name):
    m = json.loads((ROOT / f"perfbench/configs/{name}.json").read_text())["model"]
    return dict(m, **{k: v for k, v in SMALL.items() if k in m or "n_experts" in m})


def _port_logits(m, params, prompt, served):
    """The program's logits for each served token: its prefill, then its
    decode step through the cache, fed the served tokens."""
    from repro_torch.models import transformer as T

    cfg = harness.model_config(m)
    n = len(served)
    cache = T.init_cache(cfg, 1, len(prompt) + n, "cpu")
    with torch.no_grad():
        logits, cache = T.prefill(cfg, params, {"tokens": torch.tensor([prompt])}, cache,
                                  kernel="plain")
        out = [logits[0]]
        for i, tok in enumerate(served[:-1]):
            logits, cache = T.decode_step(cfg, params, torch.tensor([tok]), len(prompt) + i,
                                          cache, kernel="plain")
            out.append(logits[0])
    return torch.stack(out)


def _both(m, seed=2**31 + 3):
    params = weights.draw(m, seed, "cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, m["vocab"], 40).tolist()
    served = rng.integers(0, m["vocab"], 9).tolist()
    return reference.logits(m, params, prompt, served), _port_logits(m, params, prompt, served)


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "glm4-9b"])
def test_reference_matches_the_program_in_fp32(name):
    """Every position, prefill and decode, with nothing rounded to bf16:
    fp32's bars for the port's kernels (atol 2e-5, rtol 2e-4)."""
    got, want = _both(dict(_model(name), compute_dtype="float32"))
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "glm4-9b"])
def test_reference_matches_the_program_with_bf16_roundings(name):
    """The configuration as served (bf16 embedding, first norm, K/V and
    unembedding): the prefill's logits at fp32's bars.  At decode the
    program's plain path rounds the probabilities to the pages' bf16 before
    P.V, where its CUDA kernel, which serves on the card, and the reference
    keep them fp32: there the two differ by that rounding alone, under 2e-2
    here; on the card the served tokens are held to the reference."""
    got, want = _both(_model(name))
    torch.testing.assert_close(got[0], want[0], atol=2e-5, rtol=2e-4)
    torch.testing.assert_close(got[1:], want[1:], atol=2e-2, rtol=0)
    assert not torch.allclose(got[1:], want[1:], atol=2e-5, rtol=2e-4)


def test_prefill_drops_past_capacity_as_the_program_does():
    m = dict(_model("granite-moe-3b-a800m"), capacity_factor=0.5)
    params = weights.draw(m, 5, "cpu")
    prompt = np.random.default_rng(1).integers(0, m["vocab"], 64).tolist()
    want = _port_logits(m, params, prompt, [0])
    torch.testing.assert_close(reference.logits(m, params, prompt, [0]), want,
                               atol=2e-5, rtol=2e-4)
    dropless = dict(m, capacity_factor=100.0)
    assert not torch.allclose(reference.logits(dropless, params, prompt, [0]), want, atol=1e-3)


def test_gaps_read_how_far_a_token_lies_below_the_best():
    ref = torch.tensor([[1.0, 3.0, 2.0], [0.5, 0.0, -1.0]])
    assert reference.gaps(ref, [1, 2]).tolist() == [0.0, 1.5]


def test_compare_reads_both_numbers_and_the_control():
    m = _model("glm4-9b")
    params = weights.draw(m, 1, "cpu")
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, m["vocab"], 20).tolist()
    ref = reference.logits(m, params, prompt, [0] * 5)
    served = [int(ref[0].argmax())]
    ref = reference.logits(m, params, prompt, served)
    got = reference.compare(m, params, [(prompt, served, [float(ref[0].max()) + 0.25])],
                            control=True)
    assert got["tokens"] == 1 and got["widest_gap"] == 0.0
    assert got["logit_err"] == pytest.approx(0.25, abs=1e-5)
    assert got["control_logit_err"] > 0 and got["per_request"][0]["logit_err"] == got["logit_err"]


# fp32 activations: on the CPU the program's plain decode rounds the
# probabilities to the bf16 pages, which its kernel on the card does not
SMALL_RUN = dict(SMALL, compute_dtype="float32")
SMALL_CELLS = {
    "granite-chat": {
        "model": SMALL_RUN,
        "mix": {"rate_per_s": 20, "greedy_share": 0.5,
                "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.5, "min": 8, "max": 48},
                "output": {"dist": "lognormal", "median": 8, "sigma": 0.5, "min": 2, "max": 24}},
        "serve": {"slots": 4}, "window": {"start_after_s": 0.3, "tail_s": 5},
        "check": {"served_tokens": 40, "min_tokens": 2, "limits": {"logit_err_median": 1e-4}}},
    "glm4-9b-batch": {
        "model": {k: v for k, v in SMALL_RUN.items()
                  if "expert" not in k and k not in ("top_k", "moe_d_ff")},
        "mix": {"fill": 4, "backlog": 400,
                "prompt": {"dist": "lognormal", "median": 16, "sigma": 0.5, "min": 8, "max": 32},
                "output": {"dist": "uniform", "min": 4, "max": 12}, "greedy_share": 0.5},
        "serve": {"slots": 4}, "window": {"start_after_joins": 4},
        "check": {"served_tokens": 40, "min_tokens": 2,
                  "limits": {"logit_err": 1e-3, "widest_gap": 1e-3}}},
}


@pytest.mark.parametrize("cell", sorted(SMALL_CELLS))
def test_a_small_run_is_correct(cell):
    res = harness.run(cell, 2**31 + 9, 2.0, False, device="cpu", overrides=SMALL_CELLS[cell])
    assert res["correct"], res["check"]
    assert list(res)[-1] == "check"
    for name, c in res["check"].items():
        assert c["value"] >= c["limit"] if name == "served_tokens" else c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", sorted(SMALL_CELLS))
def test_a_token_altered_where_it_is_produced_fails_the_check(cell, monkeypatch):
    """The timed path broken underneath: every token the engine draws is
    moved to the next id, greedy ones included."""
    from repro_torch.serve import engine

    real = engine.sample_rows

    def altered(logits, rows, keys, temperature):
        return (real(logits, rows, keys, temperature) + 1) % logits.shape[-1]

    monkeypatch.setattr(engine, "sample_rows", altered)
    res = harness.run(cell, 11, 2.0, False, device="cpu", overrides=SMALL_CELLS[cell])
    assert not res["correct"] and res["failed"] >= 1
    assert any(c["value"] > c["limit"] for k, c in res["check"].items() if k != "served_tokens")
