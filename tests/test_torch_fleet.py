"""The port's serving fleet against the JAX package's, on the CPU.

``repro_torch.serve.fleet.{router,scenarios,autoscaler,replica,fleet}``
and the package's ``__init__`` are copies pinned to the originals' text
(one docstring line of ``run_engine_fleet`` names the port's decode paths
and is folded back).  The reference's fleet cases (``tests/test_fleet.py``)
run on the port; ``FleetSim`` gives ``==``-equal dispatch logs, epoch logs
and results, governor reports included, in both packages on the three
arrival scenarios with autoscaling on and off.  ``run_engine_fleet`` over
two reduced port engines with their prefix caches serves a session-reuse
trace to every request's end, with prefix routing and hits, and each
request's tokens equal the reference's engine's and the port's single
engine's.  No assignment, step count or time of that wall-clock run is
asserted: which replica serves a request depends on load.  The serve
launcher runs ``--fleet`` and ``--fleet --autoscale``; its fleet traces
draw tokens below ``min(1000, vocab)``, equal to the reference's for every
full-size arch and inside the vocabulary of a reduced one.
"""
import argparse
import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as JS
import repro.serve.fleet as JF
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import init_params as jinit_params
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Request as JRequest
from repro_torch import bridge
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.launch import serve as tserve
from repro_torch.serve import PagedKVPool
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.serve.fleet import (
    Autoscaler,
    FleetConfig,
    FleetRouter,
    FleetSim,
    PrefixCache,
    ReplicaView,
    SimReplica,
    diurnal_trace,
    flash_crowd_trace,
    run_engine_fleet,
    session_reuse_trace,
)
from repro_torch.serve.scheduler import Request

ROOT = os.path.join(os.path.dirname(__file__), "..")
COPIES = ("router", "scenarios", "autoscaler", "replica", "fleet", "__init__")
# run_engine_fleet's docstring names the port's decode paths, which round
# once differently; the reference's names its two, which do not
DOCSTRING_PORT = '''    decode path (``attn_kernel="plain"``/``"cuda"``) — the two round
    once differently, so give every replica the same one where a request's
    tokens must not depend on which replica serves it.  Returns'''
DOCSTRING_REFERENCE = '''    decode kernel (``attn_kernel="xla"``/``"pallas"``) — both are
    token-for-token identical, so routing/prefix decisions never depend
    on which replica serves a request.  Returns'''
# run_engine_fleet routes and reprices on the first session's clock: on a
# mesh that is the first rank's, so that every rank of the fleet decides alike
CLOCK_PORT = (("        now = sessions[0].now()\n",
               "        now = _time.monotonic() - t_start\n"),
              ("        if sessions[0].now() >= next_epoch:\n",
               "        if _time.monotonic() - t_start >= next_epoch:\n"))
TRACES = ("diurnal", "flash-crowd", "session-reuse")


def _cfg():
    return reduced(get_config("llama3.2-1b"))


@pytest.fixture
def one_thread():
    """Torch on one thread for a wall-clock fleet: a reduced model's ops are
    too small to share, and on a host loaded by other test workers a pool of
    spinning threads a process makes each step take hundreds of ms."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg():
    return jreduced(jget_config("llama3.2-1b"))


# --------------------------------------------------------------------------
# the copies
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", COPIES)
def test_fleet_module_text_equals_the_original(name):
    mine = open(os.path.join(ROOT, "src", "repro_torch", "serve", "fleet", f"{name}.py")).read()
    theirs = open(os.path.join(ROOT, "src", "repro", "serve", "fleet", f"{name}.py")).read()
    if name == "fleet":
        assert mine.count(DOCSTRING_PORT) == 1
        mine = mine.replace(DOCSTRING_PORT, DOCSTRING_REFERENCE)
        for port, reference in CLOCK_PORT:
            assert mine.count(port) == 1
            mine = mine.replace(port, reference)
    assert mine.replace("repro_torch", "repro") == theirs


def test_fleet_exports_equal_the_references():
    import repro_torch.serve.fleet as TF

    assert TF.__all__ == JF.__all__
    for name in TF.__all__:
        mine, theirs = getattr(TF, name), getattr(JF, name)
        assert mine.__module__ == theirs.__module__.replace("repro.", "repro_torch.", 1)
        assert mine.__qualname__ == theirs.__qualname__


def test_serve_lazy_exports_and_dir():
    """The reference's lazy-export case (``tests/test_fleet.py``) on the port."""
    import repro_torch.serve as serve

    serve = importlib.reload(serve)
    listing = dir(serve)
    for name in ("ContinuousEngine", "FleetSim", "PrefixCache", "FleetRouter",
                 "Autoscaler", "diurnal_trace", "run_engine_fleet", "fleet",
                 "kvcache", "scheduler"):
        assert name in listing, name
    # lazy resolution works and is cached
    assert serve.FleetRouter is FleetRouter
    assert serve.fleet.FleetSim is FleetSim
    with pytest.raises(AttributeError):
        serve.not_a_symbol
    fleet_names = {n for n, m in JS._EXPORTS.items() if m.startswith("repro.serve.fleet.")}
    assert {n: serve._EXPORTS[n] for n in fleet_names} == {
        n: JS._EXPORTS[n].replace("repro.", "repro_torch.", 1) for n in fleet_names}


# --------------------------------------------------------------------------
# the reference's fleet cases on the port
# --------------------------------------------------------------------------

def test_router_prefers_prefix_then_free_pages_ties_to_lowest_id():
    pool = PagedKVPool(_cfg(), n_slots=2, max_len=32, page=8, num_pages=9,
                       materialize=False)
    cache = PrefixCache(pool)
    assert pool.reserve_pages("w", 2)
    cache.insert(np.arange(1, 17), pool.alloc("w", 2))
    pool.release("w")

    def view(rid, c, n_active=0):
        return ReplicaView(replica_id=rid, n_slots=4, n_active=n_active,
                           n_queued=0, free_pages=8, capacity_pages=8,
                           prefix_cache=c)

    empty = PrefixCache(PagedKVPool(_cfg(), 2, 32, 8, 9, materialize=False))
    router = FleetRouter()
    req = Request(prompt=np.arange(1, 25, dtype=np.int32), max_new=4, arrival=0.0)
    dec = router.route(req, [view(0, empty), view(1, cache)])
    assert dec.replica_id == 1 and dec.matched_tokens == 16
    assert router.n_prefix_routed == 1
    # no prefix signal anywhere: load breaks the tie...
    req2 = Request(prompt=np.full(24, 999, np.int32), max_new=4, arrival=0.0)
    dec = router.route(req2, [view(0, empty, n_active=4), view(1, cache)])
    assert dec.replica_id == 1
    # ...and a dead tie goes to the lowest replica id (determinism)
    dec = router.route(req2, [view(1, empty), view(0, empty)])
    assert dec.replica_id == 0
    with pytest.raises(ValueError, match="no routable replicas"):
        router.route(req2, [])


def test_fleet_determinism_dispatch_and_bit_identical_reports():
    trace = flash_crowd_trace(duration_s=10, seed=3)
    runs = []
    for _ in range(2):
        fc = FleetConfig(cfg=_cfg(), n_replicas=2, autoscale=True,
                         min_replicas=1, cap_w=40.0, floor_w=4.0,
                         step_s=0.01, ttft_target=1.5)
        sim = FleetSim(fc)
        res = sim.run(trace)
        runs.append(([d.replica_id for d in sim.router.decisions], res.reports, res.energy_j))
    assert runs[0][0] == runs[1][0]          # identical dispatch sequence
    assert runs[0][1] == runs[1][1]          # bit-identical GovernorReports
    assert runs[0][2] == runs[1][2]


def test_autoscaler_max_replicas_clamped_to_watt_floor():
    a = Autoscaler(max_replicas=10, cap_w=40.0, floor_w=6.0)
    assert a.max_replicas == 6               # floor(40/6): arbiter would raise
    assert Autoscaler(min_replicas=9, max_replicas=10, cap_w=40.0,
                      floor_w=6.0).min_replicas == 6


def test_autoscaler_hysteresis_and_cooldown():
    a = Autoscaler(max_replicas=4, ttft_target=0.5, cooldown_epochs=2,
                   down_consecutive=3)
    assert a.decide(0, 1, ttft_p95=0.9, fill_mean=0.9, n_queued=0) == +1
    # cooldown holds the next epoch even under pressure
    assert a.decide(1, 2, ttft_p95=0.9, fill_mean=0.9, n_queued=0) == 0
    # quiet epochs must accumulate before a down fires
    for e in (2, 3):
        assert a.decide(e, 2, ttft_p95=0.0, fill_mean=0.1, n_queued=0) == 0
    assert a.decide(4, 2, ttft_p95=0.0, fill_mean=0.1, n_queued=0) == -1
    assert (a.n_scale_ups, a.n_scale_downs) == (1, 1)
    assert [d.reason for d in a.decisions] == ["ttft_p95=0.900s", "cooldown", "hold",
                                               "hold", "fill=0.10"]


def test_fleet_config_rejects_zero_min_replicas():
    """min_replicas == 0 would start an autoscaled fleet with no routable
    replica: the router raises on the very first arrival."""
    with pytest.raises(ValueError, match="min_replicas"):
        FleetConfig(cfg=_cfg(), n_replicas=2, autoscale=True, min_replicas=0)
    with pytest.raises(ValueError, match="min_replicas"):
        FleetConfig(cfg=_cfg(), n_replicas=1, min_replicas=2)


def test_autoscaled_fleet_caps_and_dynamics():
    """Ups AND downs fire on the diurnal trace, the granted watts never
    exceed the cluster cap across membership changes, and every request
    completes."""
    trace = diurnal_trace(duration_s=60, base_rate=2.0, peak_ratio=8, seed=0)
    fc = FleetConfig(cfg=_cfg(), n_replicas=3, autoscale=True, min_replicas=1,
                     cap_w=40.0, floor_w=4.0, step_s=0.01, ttft_target=1.5)
    res = FleetSim(fc).run(trace)
    assert res.n_completed == res.n_requests
    assert res.n_scale_ups > 0 and res.n_scale_downs > 0
    assert res.max_alloc_sum_w <= res.cap_w + 1e-9
    assert res.n_replicas_peak == 3
    assert all(e["alloc_sum_w"] <= res.cap_w + 1e-9 for e in res.epochs)


def test_session_reuse_hits_prefix_cache():
    fc = FleetConfig(cfg=_cfg(), n_replicas=2, autoscale=False,
                     cap_w=40.0, floor_w=4.0, step_s=0.01, ttft_target=1.5)
    res = FleetSim(fc).run(session_reuse_trace(seed=1))
    assert res.n_completed == res.n_requests
    assert res.prefix_hit_rate > 0.3         # dialogue resends are the point
    assert res.prefix_hits > 0


def test_sim_replica_prefix_join_replays_suffix_and_reinserts():
    rep = SimReplica(0, _cfg(), n_slots=2, max_len=64, page=8, step_s=1e-3)
    prompt = np.arange(1, 25, dtype=np.int32)
    script = np.arange(100, 108, dtype=np.int32)
    rep.submit(Request(prompt=prompt, max_new=8, arrival=0.0, out_script=script))
    rep.advance_to(1.0)
    assert rep.prefix_cache.n_insertions == 1
    # a second identical prompt matches, replays the suffix forced, and
    # produces the same scripted output
    rep.submit(Request(prompt=prompt, max_new=8, arrival=1.0, out_script=script))
    rep.advance_to(2.0)
    assert rep.prefix_cache.n_hits == 1
    assert [list(r.out) for r in rep.finished] == [list(script)] * 2
    assert rep.pool.blocks is None           # a simulated replica allocates no tensor


def test_job_sample_surfaces_slo_and_prefix_counters():
    rep = SimReplica(0, _cfg(), n_slots=2, max_len=64, page=8, step_s=1e-3)
    prompt = np.arange(1, 25, dtype=np.int32)
    for t in (0.0, 0.5):
        rep.submit(Request(prompt=prompt, max_new=4, arrival=t))
    rep.advance_to(1.0)
    s = rep.job_sample(0.25)
    assert s.ttft_p50 > 0.0 and s.tpot_p50 > 0.0
    assert s.prefix_lookups == 2 and s.prefix_hits == 1
    assert 0.0 < s.prefix_hit_rate <= 1.0
    for name in ("ttft_p99", "tpot_p99", "prefix_hit_rate"):
        assert hasattr(s, name)


# --------------------------------------------------------------------------
# across the two packages, bit for bit
# --------------------------------------------------------------------------

def _traces(pkg, kind, vocab=1000):
    """One scenario of ``pkg`` (``JF`` or the port's fleet) at a size that
    keeps this file fast, away from the defaults where a default would
    hide an argument."""
    if kind == "diurnal":
        return pkg.diurnal_trace(duration_s=20, base_rate=2.0, peak_ratio=8, vocab=vocab, seed=2)
    if kind == "flash-crowd":
        return pkg.flash_crowd_trace(duration_s=12, vocab=vocab, seed=3)
    return pkg.session_reuse_trace(n_sessions=6, turns=4, vocab=vocab, seed=1)


def _requests(trace):
    return [(r.prompt.tolist(), r.max_new, r.arrival, r.eos_id, r.session,
             None if r.out_script is None else r.out_script.tolist()) for r in trace.requests]


@pytest.mark.parametrize("kind", TRACES)
def test_traces_equal_the_references(kind):
    import repro_torch.serve.fleet as TF

    mine, theirs = _traces(TF, kind), _traces(JF, kind)
    assert (mine.name, mine.duration_s, mine.seed) == (theirs.name, theirs.duration_s, theirs.seed)
    assert _requests(mine) == _requests(theirs) and len(mine.requests) > 5
    fresh = mine.fresh_requests()
    assert [r.rid for r in fresh] != [r.rid for r in mine.requests]
    assert all(r.out == [] and r.key is None for r in fresh)


def _sim(pkg, cfg, trace, autoscale):
    fc = pkg.FleetConfig(cfg=cfg, n_replicas=3, autoscale=autoscale, min_replicas=1,
                         cap_w=40.0, floor_w=4.0, step_s=0.01, ttft_target=1.5)
    sim = pkg.FleetSim(fc)
    res = sim.run(trace)
    rid0 = min(d.rid for d in sim.router.decisions)
    log = [(d.rid - rid0, d.replica_id, d.score, d.matched_tokens, d.scores)
           for d in sim.router.decisions]
    scaling = ([dataclasses.astuple(d) for d in sim.autoscaler.decisions]
               if sim.autoscaler else None)
    return log, sim.epoch_log, dataclasses.asdict(res), res.to_dict(), scaling


@pytest.mark.parametrize("autoscale", [False, True])
@pytest.mark.parametrize("kind", TRACES)
def test_fleet_sim_equals_the_references_bit_for_bit(kind, autoscale):
    """Dispatch log (scores included), epoch log, autoscaler decisions and
    the whole ``FleetResult``, each replica's ``GovernorReport.to_dict()``
    included, compare ``==`` with the reference's."""
    import repro_torch.serve.fleet as TF

    mine = _sim(TF, _cfg(), _traces(TF, kind), autoscale)
    theirs = _sim(JF, _jcfg(), _traces(JF, kind), autoscale)
    assert mine[0] == theirs[0] and len(mine[0]) > 5
    assert mine[1] == theirs[1]
    assert mine[2] == theirs[2]
    assert mine[3] == theirs[3]
    assert mine[4] == theirs[4]
    assert mine[2]["n_completed"] == mine[2]["n_requests"]
    assert len(mine[2]["reports"]) >= (1 if autoscale else 3)


# --------------------------------------------------------------------------
# the real fleet on the CPU
# --------------------------------------------------------------------------

def _storages(eng):
    return {t.untyped_storage().data_ptr() for layer in eng.pool.blocks["layers"]
            for t in layer.values()}


def test_engine_fleet_serves_the_reference_tokens(one_thread):
    """Two reduced llama3.2-1b port engines with their prefix caches serve
    a session-reuse trace (arrivals scaled into 1 s) through
    ``run_engine_fleet``: every request finishes, at least one is routed to
    a resident prefix and hits, and each request's greedy tokens equal the
    port's single engine's and the reference's ``ContinuousEngine.serve``'s
    on the same weights.  Each engine's warm-up generate serves the
    trace's system prompt, so its pages are resident before the first
    arrival whatever the host's load (an earlier turn may or may not have
    retired when the next is routed).  The replicas read the same weights
    and share no pool storage."""
    jcfg, tcfg = _jcfg(), _cfg()
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    trace = session_reuse_trace(n_sessions=4, turns=2, vocab=tcfg.vocab, seed=2)
    last = max(r.arrival for r in trace.requests)
    for r in trace.requests:
        r.arrival *= 1.0 / last
    prompts = [(r.prompt, r.max_new) for r in trace.requests]
    page = 8
    max_len = max(len(p) + n for p, n in prompts) + page
    max_len += (-max_len) % page

    def engine():
        return ContinuousEngine(tcfg, tp, n_slots=4, max_len=max_len, page=page, device="cpu")

    system = trace.requests[0].prompt[:24]            # session_reuse_trace's system_len
    assert all((r.prompt[:24] == system).all() for r in trace.requests)
    engines = [engine(), engine()]
    for eng in engines:
        eng.enable_prefix_cache()
        eng.generate({"tokens": system[None]}, n_steps=2)
    reqs = trace.fresh_requests()
    finished, router, arbiter, sessions = run_engine_fleet(
        engines, reqs, cap_w=40.0, floor_w=4.0)
    assert sorted(r.rid for r in finished) == sorted(r.rid for r in reqs)
    assert all(len(r.out) == r.max_new for r in reqs)
    assert len(router.decisions) == len(reqs)
    assert router.n_prefix_routed > 0
    assert sum(e.prefix_cache.n_hits for e in engines) > 0
    assert sum(len(s.finished) for s in sessions) == len(reqs)
    assert engines[0].params is engines[1].params
    assert not _storages(engines[0]) & _storages(engines[1])
    fleet = [list(r.out) for r in reqs]

    single = engine()
    alone = [Request(prompt=p, max_new=n, arrival=0.0) for p, n in prompts]
    single.serve(alone)
    assert [list(r.out) for r in alone] == fleet

    ref = JContinuousEngine(jcfg, jp, n_slots=4, max_len=max_len, page=page)
    theirs = [JRequest(prompt=p, max_new=n, arrival=0.0) for p, n in prompts]
    ref.serve(theirs)
    assert [list(r.out) for r in theirs] == fleet


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def test_launcher_fleet_on_cpu_writes_valid_metrics(tmp_path, capsys, one_thread):
    """``--fleet 2`` on the CPU finishes every request of a short flash
    crowd, with the dashboard and batched ingestion on; the reference's
    validator accepts its metrics file; the watts are labelled as
    modelled; ``--model-parallel 2`` in a world of 1 wraps nothing (the
    largest degree that divides one rank is 1), so the fleet runs on plain
    tensors."""
    from repro.obs.export import validate_metrics_jsonl
    from repro_torch.core import instrument

    path = str(tmp_path / "fleet.jsonl")
    res = tserve.main(["--reduced", "--device", "cpu", "--fleet", "2", "--fleet-trace",
                       "flash-crowd", "--fleet-duration", "2", "--metrics-out", path,
                       "--dashboard", "--ingest", "batched"])
    assert res["dashboard_frames"] == 1 and instrument.get_ingest_mode() == "event"
    assert res["mode"] == "fleet" and res["replicas"] == 2
    assert res["requests"] == res["n_requests"] == res["routed"] > 0
    assert all(len(r.out) == r.max_new for r in res["objects"]["requests"])
    assert res["watts"].startswith("modelled") and res["cap_w"] == 40.0
    assert [r["attn_kernel"] for r in res["per_replica"]] == ["plain", "plain"]
    assert sum(r["requests"] for r in res["per_replica"]) == res["requests"]
    assert res["metrics_out"] == path and res["metrics_lines"] == 1
    assert validate_metrics_jsonl(path) == []
    assert '"mode": "fleet"' in capsys.readouterr().out.splitlines()[-1]
    args = tserve.parser().parse_args(["--reduced", "--device", "cpu", "--fleet", "2",
                                       "--model-parallel", "2"])
    assert tserve.serve_mesh(args) is None


@pytest.mark.parametrize("kind", TRACES)
def test_launcher_autoscale_gives_the_references_numbers(kind):
    """``--fleet 2 --autoscale`` builds no weights and gives the numbers
    the reference's ``FleetSim`` gives for the launcher's ``FleetConfig``
    and the same trace."""
    argv = ["--reduced", "--device", "cpu", "--fleet", "2", "--autoscale", "--fleet-trace",
            kind, "--fleet-duration", "15", "--seed", "4"]
    res = tserve.main(argv)
    jcfg = _jcfg()
    args = argparse.Namespace(fleet_trace=kind, fleet_duration=15.0, seed=4)
    trace = {"diurnal": JF.diurnal_trace, "flash-crowd": JF.flash_crowd_trace}.get(kind)
    trace = (JF.session_reuse_trace(vocab=jcfg.vocab, seed=args.seed) if trace is None
             else trace(duration_s=args.fleet_duration, vocab=jcfg.vocab, seed=args.seed))
    fc = JF.FleetConfig(cfg=jcfg, n_replicas=2, autoscale=True, min_replicas=1, n_slots=4,
                        cap_w=40.0, floor_w=4.0, step_s=0.01, ttft_target=1.5)
    sim = JF.FleetSim(fc)
    want = sim.run(trace)
    got = res["objects"]["result"]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [d.replica_id for d in res["objects"]["sim"].router.decisions] == \
        [d.replica_id for d in sim.router.decisions]
    assert (res["requests"], res["tokens"], res["joules_per_token"], res["peak_replicas"],
            res["scale_ups"], res["scale_downs"], res["max_alloc_sum_w"]) == (
        want.n_completed, want.tokens_out, want.joules_per_token, want.n_replicas_peak,
        want.n_scale_ups, want.n_scale_downs, want.max_alloc_sum_w)
    assert res["requests"] == res["n_requests"] > 0 and res["watts"].startswith("modelled")


# --------------------------------------------------------------------------
# the trace vocabulary, kept apart from the reference's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_fleet_trace_is_the_references_on_every_full_size_arch(arch):
    """A full-size arch's vocabulary is at least 2048, so the port's
    ``min(1000, vocab)`` is the reference's 1000: the same trace."""
    from repro.launch.serve import _fleet_trace

    cfg = get_config(arch)
    assert cfg.vocab >= 2048
    for kind in TRACES:
        args = tserve.parser().parse_args(["--arch", arch, "--fleet", "2", "--fleet-trace",
                                           kind, "--fleet-duration", "6"])
        assert _requests(tserve.fleet_trace(args, cfg)) == _requests(_fleet_trace(args))


@pytest.mark.parametrize("kind", TRACES)
def test_fleet_trace_stays_inside_a_reduced_vocabulary(kind):
    """On a reduced config (vocabulary 512) every token of the port's trace
    is below the vocabulary; the reference's trace draws up to 999."""
    from repro.launch.serve import _fleet_trace

    cfg = _cfg()
    args = tserve.parser().parse_args(["--reduced", "--fleet", "2", "--fleet-trace", kind,
                                       "--fleet-duration", "10"])
    mine = tserve.fleet_trace(args, cfg)
    tokens = np.concatenate([np.concatenate([r.prompt, r.out_script]) for r in mine.requests])
    assert cfg.vocab == 512 and 0 < tokens.min() and tokens.max() < cfg.vocab
    theirs = np.concatenate([r.prompt for r in _fleet_trace(args).requests])
    assert theirs.max() >= cfg.vocab


def test_reference_embeds_out_of_range_tokens_as_nan():
    """Why the traces are kept apart: the reference embeds with
    ``jnp.take``, whose default mode fills an out-of-range row with NaN, so
    its ``--fleet --reduced`` serves NaN logits; the port's indexing raises."""
    rows = np.asarray(jnp.take(jnp.ones((512, 4)), jnp.asarray([5, 600, 999]), axis=0))
    assert (rows[0] == 1).all() and np.isnan(rows[1:]).all()
    with pytest.raises(IndexError):
        torch.ones(512, 4)[torch.tensor([5, 600, 999])]
