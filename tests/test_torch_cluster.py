"""The port's power-budget layer (``repro_torch.cluster``) against the JAX
package's ``repro.cluster``, on the CPU.

Every module of ``cluster/`` is a copy pinned to the original's text, and
the package exports the reference's names.  From the same inputs the two
packages' cap actuators commit the same caps, their arbiters split the
same watts, a mix co-scheduled under both disciplines gives the same
result, a recorded governor stream saves the same trace, and each
package's trace replays in the other's ``replay`` to the live report;
``what_if`` and ``to_workload`` agree.  ``ServeJob`` reads the port's
engine: its decode fill and prefix-cache counters.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

import repro.cluster as JCL
import repro_torch.cluster as TCL
from golden_common import feed
from repro.cluster import coschedule as jco
from repro.cluster import power as jpower
from repro.cluster import trace as jtrace
from repro.core.governor import Governor as JGovernor
from repro.core.policies import COUNTDOWN as JCOUNTDOWN
from repro.core.policies import COUNTDOWN_SLACK as JCOUNTDOWN_SLACK
from repro.core.policies import policy_for_theta as jpolicy_for_theta
from repro.core.simulator import simulate as jsimulate
from repro_torch.cluster import coschedule as tco
from repro_torch.cluster import power as tpower
from repro_torch.cluster import trace as ttrace
from repro_torch.cluster.arbiter import JobSample, PowerBudgetArbiter, StaticEqualSplit
from repro_torch.cluster.job import GovernorJob, ServeJob
from repro_torch.core.governor import Governor
from repro_torch.core.policies import COUNTDOWN, COUNTDOWN_SLACK, policy_for_theta
from repro_torch.core.pstate import DEFAULT_HW
from repro_torch.core.simulator import simulate

ROOT = os.path.join(os.path.dirname(__file__), "..")
MODULES = ("power", "arbiter", "job", "trace", "coschedule", "__init__")


@pytest.mark.parametrize("name", MODULES)
def test_copied_module_text_equals_the_original(name):
    mine = open(os.path.join(ROOT, "src", "repro_torch", "cluster", f"{name}.py")).read()
    theirs = open(os.path.join(ROOT, "src", "repro", "cluster", f"{name}.py")).read()
    assert mine.replace("repro_torch", "repro") == theirs


def test_cluster_exports_the_same_names():
    assert TCL.__all__ == JCL.__all__
    for name in JCL.__all__:
        mine, theirs = getattr(TCL, name), getattr(JCL, name)
        assert getattr(mine, "__module__", "").replace("repro_torch.", "repro.") == \
            getattr(theirs, "__module__", ""), name
    assert TCL.TRACE_VERSION == JCL.TRACE_VERSION
    assert {k: dataclasses.asdict(v) for k, v in TCL.MIX_SPECS.items()} == \
        {k: dataclasses.asdict(v) for k, v in JCL.MIX_SPECS.items()}


def test_cap_actuator_and_power_rollups_match():
    """The reference's latency/hysteresis sequence on both actuators: the
    same accepted requests, commits and caps in force; the roll-ups of one
    simulated power series equal."""
    def drive(mod):
        act = mod.PowerCapActuator(cap_w=100.0, latency=500e-6, theta=500e-6,
                                   deadband_w=1.0, floor_w=10.0)
        taken = [act.request(t, w) for t, w in ((0.0, 80.0), (100e-6, 50.0), (1.0, 80.5),
                                                (2.0, 0.0), (2.2, 60.0), (2.2003, 61.0))]
        caps = [act.cap_at(t) for t in (0.0, 5e-4, 1.5, 2.0004, 3.0)]
        return taken, caps, [dataclasses.asdict(c) for c in act.commits], act.n_suppressed, \
            act.f_cap_at(3.0, 4)

    assert drive(tpower) == drive(jpower)
    assert drive(tpower)[0] == [True, False, False, True, True, False]
    wl = tco.make_job("comm_bound", seed=3, n_tasks=40).workload
    res, _ = simulate(wl, COUNTDOWN_SLACK, power_dt=5e-3)
    jres, _ = jsimulate(wl, COUNTDOWN_SLACK, power_dt=5e-3)
    for mine, theirs in ((tpower.node_power_series(res, 3), jpower.node_power_series(jres, 3)),
                         (tpower.aggregate_power(res.power_series, 5),
                          jpower.aggregate_power(jres.power_series, 5))):
        np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_array_equal(tpower.rack_power_series(tpower.node_power_series(res, 2), 3),
                                  jpower.rack_power_series(jpower.node_power_series(jres, 2), 3))


def test_arbiters_split_the_same_watts():
    rng = np.random.default_rng(4)
    mine = [PowerBudgetArbiter(cap_w=300.0, floor_w=20.0, alpha_w=30.0, beta=0.5),
            StaticEqualSplit(cap_w=300.0, floor_w=20.0)]
    theirs = [JCL.PowerBudgetArbiter(cap_w=300.0, floor_w=20.0, alpha_w=30.0, beta=0.5),
              JCL.StaticEqualSplit(cap_w=300.0, floor_w=20.0)]
    for _ in range(10):
        draws = [(f"job{i}", float(rng.uniform(0, 150)), float(rng.uniform(0, 1)),
                  bool(rng.random() < 0.1)) for i in range(4)]
        for a, b in zip(mine, theirs):
            got = a.step([JobSample(j, p, e, done=d) for j, p, e, d in draws])
            assert got == b.step([JCL.JobSample(j, p, e, done=d) for j, p, e, d in draws])
            assert sum(got.values()) <= 300.0 + 1e-6
    assert mine[0].history == theirs[0].history


def test_coschedule_and_compare_disciplines_match():
    """One heterogeneous mix (compute-bound beside bursty serving, 120 tasks
    each) under one cap: ``run_coschedule`` and ``compare_disciplines`` give
    the reference's makespan, energy, per-job numbers, allocations and
    epoch reports exactly."""
    def mix(mod):
        return lambda: [mod.make_job("compute_bound", seed=1, n_tasks=120, floor_w=15.0),
                        mod.make_job("bursty_serve", seed=2, n_tasks=120, floor_w=15.0)]

    def flat(res):
        return dict(res.summary(), allocations=res.allocations,
                    reports={k: [dataclasses.asdict(r) for r in v]
                             for k, v in res.reports.items()})

    mine = tco.compare_disciplines(mix(tco), 100.0, floor_w=15.0)
    theirs = jco.compare_disciplines(mix(jco), 100.0, floor_w=15.0)
    assert set(mine) == {"static", "arbiter"}
    for key in mine:
        assert flat(mine[key]) == flat(theirs[key]), key
    assert flat(tco.run_coschedule(mix(tco)(), 100.0)) == flat(jco.run_coschedule(mix(jco)(), 100.0))


# --------------------------------------------------------------------------
# traces: record, replay, what_if, in both directions
# --------------------------------------------------------------------------

def recorded(mod, governor_cls, policy, stream, tmp_path):
    """A governor with a trace recorder fed a canned stream; returns the
    saved file's lines, the live report and the path."""
    rec = mod.TraceRecorder(meta={"stream": stream})
    gov = governor_cls(policy=policy, recorder=rec)
    feed(gov, stream)
    live = gov.finalize()
    path = rec.save(str(tmp_path / f"{mod.__name__}-{stream}.jsonl"))
    with open(path) as f:
        return [json.loads(line) for line in f], live.to_dict(), path


@pytest.mark.parametrize("stream,theta", [("straggler", ""), ("bursty", ""), ("bursty", "auto")])
def test_traces_record_alike_and_replay_across_packages(stream, theta, tmp_path):
    """The same stream recorded by both packages gives the same file; the
    port's trace replays in the reference's ``replay`` and the reference's
    in the port's, each to the live report, under the recorded policy and
    under another; ``to_workload`` and ``what_if`` agree."""
    policy, jpolicy = policy_for_theta(theta), jpolicy_for_theta(theta)
    mine, live, tpath = recorded(ttrace, Governor, policy, stream, tmp_path)
    theirs, jlive, jpath = recorded(jtrace, JGovernor, jpolicy, stream, tmp_path)
    assert mine == theirs and live == jlive
    _, rep = jtrace.replay(jtrace.load(tpath)[1], policy=jpolicy)
    assert rep.to_dict() == live
    _, rep = ttrace.replay(ttrace.load(jpath)[1], policy=policy)
    assert rep.to_dict() == jlive
    _, a = ttrace.replay(ttrace.load(jpath)[1], policy=COUNTDOWN)
    _, b = jtrace.replay(jtrace.load(tpath)[1], policy=JCOUNTDOWN)
    assert a.to_dict() == b.to_dict() and a.energy_policy != live["energy_policy"]
    records = ttrace.load(tpath)[1]
    got, want = ttrace.to_workload(records), jtrace.to_workload(records)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name), f.name)
    cap = 0.6 * 4 * DEFAULT_HW.watts_at_fmax
    for power_cap in (None, cap):
        got = ttrace.what_if(records, COUNTDOWN_SLACK, power_cap=power_cap)
        want = jtrace.what_if(records, JCOUNTDOWN_SLACK, power_cap=power_cap)
        assert (got.time, got.energy, got.tslack, got.calls) == \
            (want.time, want.energy, want.tslack, want.calls)


# --------------------------------------------------------------------------
# live tenants
# --------------------------------------------------------------------------

def test_governor_job_books_what_the_reference_books():
    """Both packages' ``GovernorJob`` over a governor fed the same phases,
    handed the same interval poll: the same exploited ratio, call count
    and committed cap (the watts are the CPU-node model's)."""
    out = []
    for job_cls, gov_cls in ((GovernorJob, Governor), (JCL.GovernorJob, JGovernor)):
        gov = gov_cls()
        job = job_cls("live", gov, n_ranks=4, cap_w=40.0)
        gov.ingest_phase(0, 1, 0.0, 5e-3, 6e-3)
        gov.ingest_phase(1, 2, 1.0, 1.003, 1.004)
        rep = job.run_epoch(35.0, stats=gov.interval_snapshot())
        out.append((rep.n_calls, rep.cap_w, len(job.actuator.commits), job.last_sample().job_id))
        assert 0.0 <= rep.exploited_ratio <= 1.0 and rep.power_w > 0.0
    assert out[0] == out[1] == (2, 35.0, 1, "live")


def test_serve_job_reads_the_port_engine():
    """``ServeJob`` over the port's engine: the fill of its last session's
    meter, and its prefix cache's counters in the arbiter's sample."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ContinuousEngine
    from repro_torch.serve.scheduler import Request
    from repro_torch.serve.slo import SLOTracker

    cfg = reduced(get_config("llama3.2-1b"))
    eng = ContinuousEngine(cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                           n_slots=2, max_len=32, page=8, device="cpu")
    cache = eng.enable_prefix_cache()
    gov, slo = Governor(), SLOTracker()
    job = ServeJob("serve", eng, gov, cap_w=300.0, slo=slo)
    assert job.fill_fraction == 1.0                    # no session yet
    prompt = np.arange(1, 13, dtype=np.int32)
    eng.serve([Request(prompt=prompt, max_new=4)], governor=gov, slo=slo)
    eng.serve([Request(prompt=prompt, max_new=4)], governor=gov, slo=slo)
    assert job.fill_fraction == eng._last_meter.fill_fraction == 0.5
    job.run_epoch(300.0)
    s = job.last_sample()
    assert (s.prefix_hits, s.prefix_lookups, s.prefix_hit_rate) == \
        (cache.n_hits, cache.n_lookups, cache.hit_rate) == (1, 2, 8 / 24)
    assert s.ttft_p50 > 0.0 and s.tpot_p50 > 0.0
