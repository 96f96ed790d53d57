"""The port's host model (``repro_torch.core``: simulator, predictor,
workloads, profiler, the predictive tuner and the lazy export table)
against the JAX package's originals.

These modules are copies with their imports pointed at ``repro_torch``.
Their text is pinned to the originals; the simulator is held bit-equal to
the reference for every calibrated application under every policy (at a
few tasks each, so the file runs in seconds); the predictive pair's
reports are held to ``tests/goldens/predictive.json`` and the live
reference; and a served reduced llama3.2-1b under ``--theta predictive``
books the same report and predictor decisions through the port's governor
as through the reference's on the recorded phase stream.
"""
import dataclasses
import functools
import json
import os
import re

import numpy as np
import pytest

import repro.core as JC
import repro_torch.core as TC
from golden_common import CANNED, PREDICTIVE_POLICY_NAMES, feed, predictive_entry
from repro.core import policies as JP
from repro.core import predictor as JPR
from repro.core import simulator as JS
from repro.core import workloads as JW
from repro.core.governor import Governor as JGovernor
from repro_torch.core import policies as TP
from repro_torch.core import predictor as TPR
from repro_torch.core import profiler as TPF
from repro_torch.core import simulator as TS
from repro_torch.core import workloads as TW
from repro_torch.core.governor import Governor
from repro_torch.core.policies import policy_for_theta
from test_torch_governor import assert_close

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
COPIES = ("simulator", "predictor", "workloads", "profiler", "timeout")
N_TASKS = 24                  # tasks per application in the simulator parity


def normalized(path: str) -> str:
    """A module's text with the import prefix folded to the reference's,
    and the one docstring phrase the port words differently in timeout.py
    ("the paper's headline condition")."""
    text = open(path).read().replace("repro_torch", "repro")
    return re.sub(r"the \w+'s headline condition", "the headline condition", text)


@pytest.mark.parametrize("name", COPIES)
def test_copied_module_text_equals_the_original(name):
    mine = normalized(os.path.join(ROOT, "src", "repro_torch", "core", f"{name}.py"))
    theirs = normalized(os.path.join(ROOT, "src", "repro", "core", f"{name}.py"))
    assert mine == theirs


def test_core_exports_resolve_to_the_same_names():
    assert TC.__all__ == JC.__all__
    for name in JC._EXPORTS:
        assert TC._EXPORTS[name] == JC._EXPORTS[name].replace("repro.", "repro_torch.", 1)
        if JC._EXPORTS[name] == "repro.core.instrument":
            continue                                  # the reference's imports jax
        mine, theirs = getattr(TC, name), getattr(JC, name)
        assert type(mine).__name__ == type(theirs).__name__, name
        assert getattr(mine, "__name__", name) == getattr(theirs, "__name__", name)
        assert getattr(mine, "__module__", "").replace("repro_torch.", "repro.") == \
            getattr(theirs, "__module__", ""), name
    for name in TC._SUBMODULES:
        assert getattr(TC, name).__name__ == f"repro_torch.core.{name}"
    instrument = [n for n, m in TC._EXPORTS.items() if m.endswith(".instrument")]
    assert len(instrument) == 15 and all(callable(getattr(TC, n)) for n in instrument)


# --------------------------------------------------------------------------
# simulator and workloads
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def workloads(app: str):
    """The app cut to ``N_TASKS`` tasks, generated (and calibrated) by both."""
    jspec = dataclasses.replace(JW.APPS[app], n_tasks=min(JW.APPS[app].n_tasks, N_TASKS))
    tspec = dataclasses.replace(TW.APPS[app], n_tasks=jspec.n_tasks)
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    return JW.generate(jspec, seed=3), TW.generate(tspec, seed=3)


def assert_same(mine, theirs, path=""):
    """Dataclasses, arrays and numbers, bit for bit."""
    if dataclasses.is_dataclass(theirs):
        assert type(mine).__name__ == type(theirs).__name__, path
        for f in dataclasses.fields(theirs):
            assert_same(getattr(mine, f.name), getattr(theirs, f.name), f"{path}.{f.name}")
    elif isinstance(theirs, np.ndarray):
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape, path
        np.testing.assert_array_equal(mine, theirs, err_msg=path)
    elif isinstance(theirs, dict):
        assert set(mine) == set(theirs), path
        for k in theirs:
            assert_same(mine[k], theirs[k], f"{path}.{k}")
    else:
        assert mine == theirs or (mine != mine and theirs != theirs), path


@pytest.mark.parametrize("policy", list(JP.ALL_POLICIES))
@pytest.mark.parametrize("app", list(JW.APPS))
def test_simulate_is_bit_equal_to_the_reference(app, policy):
    jwl, twl = workloads(app)
    assert_same(twl, jwl, app)
    jres, jtrace = JS.simulate(jwl, JP.ALL_POLICIES[policy], collect_trace=True,
                               power_dt=0.05)
    tres, ttrace = TS.simulate(twl, TP.ALL_POLICIES[policy], collect_trace=True,
                               power_dt=0.05)
    assert_same(tres, jres, f"{app}/{policy}")
    assert_same(ttrace, jtrace, f"{app}/{policy}/trace")


@pytest.mark.parametrize("app", ["nas_is.D.128", "omen_60p"])
def test_evaluate_predictability_equals_the_reference(app):
    jwl, twl = workloads(app)
    _, jtrace = JS.simulate(jwl, JP.BASELINE, collect_trace=True)
    _, ttrace = TS.simulate(twl, TP.BASELINE, collect_trace=True)
    for with_prev in (False, True):
        want = JPR.evaluate_predictability(app, jtrace, with_prev, n_trees=4, importance=True)
        got = TPR.evaluate_predictability(app, ttrace, with_prev, n_trees=4, importance=True)
        assert_same(got, want, f"{app}/{with_prev}")
        assert all(np.isfinite(v) for v in got.smape.values())


def test_event_profiler_report_equals_the_reference():
    from repro.core import profiler as JPF

    jwl, twl = workloads("nas_ft.E.1024")
    reports = []
    for S, PF, wl, base in ((JS, JPF, jwl, JP.BASELINE), (TS, TPF, twl, TP.BASELINE)):
        _, trace = S.simulate(wl, base, collect_trace=True)
        prof = PF.EventProfiler()
        prof.ingest_trace(trace)
        reports.append(PF.hierarchical_report(prof, n_ranks=wl.n_ranks, ranks_per_node=8))
    assert reports[1] == reports[0]
    assert reports[1]["summary"]["total_calls"] == N_TASKS * twl.n_ranks


# --------------------------------------------------------------------------
# the predictive tuner through the governor
# --------------------------------------------------------------------------

def port_predictive_entry(policy, kind: str) -> dict:
    gov = Governor(policy=policy)
    feed(gov, kind)
    return {"report": gov.finalize().to_dict(),
            "n_predictor_decisions": int(gov.n_predictor_decisions)}


@pytest.mark.parametrize("policy_name", PREDICTIVE_POLICY_NAMES)
@pytest.mark.parametrize("kind", CANNED)
def test_predictive_report_matches_golden_and_reference(kind, policy_name):
    mine = json.loads(json.dumps(port_predictive_entry(TP.ALL_POLICIES[policy_name], kind)))
    with open(os.path.join(GOLDEN_DIR, "predictive.json")) as f:
        assert_close(mine, json.load(f)["policies"][policy_name][kind],
                     f"predictive/{kind}/{policy_name}")
    live = json.loads(json.dumps(predictive_entry(JP.ALL_POLICIES[policy_name], kind)))
    assert mine == live


def test_theta_predictive_builds_the_hybrid():
    gov = Governor(policy=policy_for_theta("predictive"))
    assert gov.policy.name == "cntd_predictive"
    assert type(gov.tuner.predictor).__module__ == "repro_torch.core.predictor"
    assert gov.n_predictor_decisions == 0


class PhaseTape:
    """Records the serve loop's phase stream, in bus order."""

    def __init__(self):
        self.records = []

    def on_phase(self, record):
        self.records.append(record)


def test_served_predictive_stream_books_the_same_in_both_governors():
    """Reduced llama3.2-1b served on the CPU under ``--theta predictive``:
    the live report, and the recorded phases replayed through a fresh port
    governor and through the reference's, agree to the bit, predictor
    decisions included."""
    from repro.core.events import PhaseRecord as JRecord
    from repro_torch.core.profiler import EventProfiler, hierarchical_report
    from repro_torch.launch import serve

    tape, prof = PhaseTape(), EventProfiler()
    args = serve.parser().parse_args([
        "--reduced", "--continuous", "--device", "cpu", "--theta", "predictive",
        "--n-requests", "6", "--prompt-len", "8", "--steps", "24", "--slots", "2",
        "--page-size", "8", "--seed", "0"])
    res = serve.run_continuous(args, subscribers=(tape, prof))
    live = res["objects"]["governor"]
    assert live.policy.name == "cntd_predictive" and res["priced_slack_ms"] > 0
    assert res["completed"] == 6 and len(tape.records) == res["phases"] > 50
    port = Governor(policy=policy_for_theta("predictive"))
    ref = JGovernor(policy=JP.CNTD_PREDICTIVE)
    for rec in tape.records:
        port.on_phase(rec)
        ref.on_phase(JRecord(*rec))
    want = json.loads(json.dumps(ref.finalize().to_dict()))
    assert json.loads(json.dumps(port.finalize().to_dict())) == want
    assert json.loads(json.dumps(res["objects"]["report"].to_dict())) == want
    decisions = [tuple(d) for d in ref.predictor_log]
    assert [tuple(d) for d in port.predictor_log] == decisions
    assert [tuple(d) for d in live.predictor_log] == decisions
    assert port.n_predictor_decisions == ref.n_predictor_decisions == len(decisions) > 0
    summary = hierarchical_report(prof)["summary"]
    assert summary["total_calls"] == len(tape.records)
    assert summary["total_tslack_s"] == pytest.approx(
        sum(max(r.t_slack_end - r.t_enter, 0.0) for r in tape.records))
