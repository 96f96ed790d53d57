"""The port's copied host layer against the JAX package's originals.

The governor, policies, timeout tuners, straggler detector, slack meter,
SLO tracker and scheduler are copies with their imports pointed at
``repro_torch``.  They are held to the golden reports and to the live
reference on the same event streams, through the per-event ``sink`` path
(the reference's batched path is not an oracle: ROADMAP.md, queue 3).
"""
import json
import os

import numpy as np
import pytest

from golden_common import CANNED, GOLDEN_POLICY_NAMES, feed, report_dict
from repro.core.policies import ALL_POLICIES as J_POLICIES
from repro.serve.scheduler import poisson_arrivals as j_poisson
from repro.serve.slack import DecodeSlackMeter as JMeter
from repro.serve.slo import SLOTracker as JSLO
from repro_torch.core.governor import Governor
from repro_torch.core.policies import ALL_POLICIES, policy_for_theta
from repro_torch.serve.scheduler import Request, poisson_arrivals
from repro_torch.serve.slack import DecodeSlackMeter
from repro_torch.serve.slo import SLOTracker

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def port_report(name: str, kind: str) -> dict:
    gov = Governor(policy=ALL_POLICIES[name])
    feed(gov, kind)
    return json.loads(json.dumps(gov.finalize().to_dict()))


def assert_close(got, want, path=""):
    """Integers and strings exactly, floats to 1e-9 (test_golden's bar)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) or isinstance(got, float):
        assert got == pytest.approx(want, rel=1e-9, abs=1e-12), path
    else:
        assert got == want, path


@pytest.mark.parametrize("policy_name", GOLDEN_POLICY_NAMES)
@pytest.mark.parametrize("kind", CANNED)
def test_port_governor_matches_golden_and_reference(kind, policy_name):
    mine = port_report(policy_name, kind)
    with open(os.path.join(GOLDEN_DIR, f"{kind}.json")) as f:
        assert_close(mine, json.load(f)["policies"][policy_name], f"{kind}/{policy_name}")
    live = json.loads(json.dumps(report_dict(J_POLICIES[policy_name], kind)))
    assert mine == live                               # same code, same floats


@pytest.mark.parametrize("kind", CANNED)
def test_port_adaptive_governor_matches_reference(kind):
    mine = port_report("cntd_adaptive", kind)
    live = json.loads(json.dumps(report_dict(J_POLICIES["cntd_adaptive"], kind)))
    assert mine == live


def test_predictive_policy_matches_reference():
    """``--theta predictive`` builds the guarded hybrid, whose report and
    predictor decisions on the bursty stream equal the reference's."""
    from repro.core.governor import Governor as JGovernor

    gov = Governor(policy=policy_for_theta("predictive"))
    ref = JGovernor(policy=J_POLICIES["cntd_predictive"])
    assert gov.policy == policy_for_theta("predictive")
    assert gov.policy.name == ref.policy.name == "cntd_predictive"
    for g in (gov, ref):
        feed(g, "bursty")
    assert gov.finalize().to_dict() == ref.finalize().to_dict()
    assert [tuple(d) for d in gov.predictor_log] == [tuple(d) for d in ref.predictor_log]
    assert gov.n_predictor_decisions == ref.n_predictor_decisions > 0


def test_slack_meter_emits_the_reference_phase_records():
    seq = [(1.0, 1.010, 1, 4), (1.011, 1.019, 4, 4), (1.020, 1.031, 0, 4),
           (2.5, 2.507, 3, 8)]
    idles = [(1.031, 1.2), (2.0, 2.5)]
    out = {}
    for name, cls in (("ref", JMeter), ("port", DecodeSlackMeter)):
        recs = []

        class Sink:
            def on_phase(self, rec):
                recs.append(tuple(rec))

        meter = cls(Sink(), rank=2)
        for (t0, t1, f, c), (i0, i1) in zip(seq, idles + [(None, None)] * 2):
            meter.step(t0, t1, f, c)
            if i0 is not None:
                meter.idle(i0, i1)
        out[name] = (recs, meter.fill_fraction, meter.n_steps, meter.n_idle)
    assert out["port"] == out["ref"]
    assert len(out["port"][0]) == 6


def test_slo_tracker_and_arrivals_match_reference():
    a = poisson_arrivals(16, rate=40.0, seed=3, burst_every=8, burst_gap=0.05)
    np.testing.assert_array_equal(a, j_poisson(16, rate=40.0, seed=3, burst_every=8,
                                               burst_gap=0.05))
    summaries = []
    for cls in (JSLO, SLOTracker):
        slo = cls(tpot_target=0.01, window=8, adjust_every=4)
        req = Request(prompt=np.zeros(4, np.int32), max_new=16, arrival=0.0)
        slo.on_first_token(req, 0.05)
        now, caps = 0.05, []
        for i in range(30):
            now += 0.02 if i < 12 else 0.001
            slo.on_token(req, now)
            caps.append(slo.max_concurrency(4))
        summaries.append((slo.summary(), caps))
    assert summaries[0] == summaries[1]
