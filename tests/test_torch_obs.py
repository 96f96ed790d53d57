"""The port's observability stack (``repro_torch.obs``) and the launchers'
telemetry flags against the JAX package's, on the CPU.

``obs/metrics.py`` and ``obs/export.py`` are copies pinned to the
originals' text; ``obs/tracer.py`` is one with a ``span`` hook added for
the port's serving loop.  ``repro_torch.obs`` exports the reference's
names lazily.  The same canned governor streams
(``tests/golden_common.py``) through both packages' governor, tap, bus
metrics, span tracer and collector give the same metrics snapshots,
JSONL lines, Prometheus text, dashboard frame and Perfetto JSON (the
wall-clock ``t`` of a snapshot line aside); the port's tracer builds the
committed golden Perfetto trace byte for byte.  The port's serve and
train launchers, with every telemetry flag, write files that the
**reference's** validators accept, and their ``--trace-out`` replays
through the reference's ``repro.cluster.trace`` to the run's report.
"""
import json
import os

import pytest

import repro.obs as JO
import repro_torch.obs as TO
from golden_common import CANNED, feed
from repro.cluster import trace as jtrace
from repro.core import events as JE
from repro.core import governor as JG
from repro.core import policies as JP
from repro.core import timeout as JT
from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro.obs import tracer as jtracer
from repro_torch.cluster import trace as ttrace
from repro_torch.core import events as TE
from repro_torch.core import governor as TG
from repro_torch.core import policies as TP
from repro_torch.core import timeout as TT
from repro_torch.launch import serve as lserve
from repro_torch.launch import train as ltrain
from repro_torch.obs import export as texport
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import tracer as ttracer

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
JAX_SIDE = dict(events=JE, governor=JG, policies=JP, timeout=JT, metrics=jmetrics,
                tracer=jtracer, export=jexport)
PORT_SIDE = dict(events=TE, governor=TG, policies=TP, timeout=TT, metrics=tmetrics,
                 tracer=ttracer, export=texport)


# ``tracer`` is no longer a copy: the port's serving loop writes spans the
# reference's does not; its behaviour on the reference's streams stays
# pinned by the golden bytes and the canned streams below
@pytest.mark.parametrize("name", ["metrics", "export", "__init__"])
def test_copied_module_text_equals_the_original(name):
    mine = open(os.path.join(ROOT, "src", "repro_torch", "obs", f"{name}.py")).read()
    theirs = open(os.path.join(ROOT, "src", "repro", "obs", f"{name}.py")).read()
    assert mine.replace("repro_torch", "repro") == theirs


def test_obs_exports_resolve_to_the_same_names():
    assert TO.__all__ == JO.__all__ and "get_logger" in TO.__all__
    for name, (mod, attr) in JO._EXPORTS.items():
        assert TO._EXPORTS[name] == (mod.replace("repro.", "repro_torch.", 1), attr)
        mine, theirs = getattr(TO, name), getattr(JO, name)
        assert getattr(mine, "__module__", "repro_torch.").replace("repro_torch.", "repro.") \
            == getattr(theirs, "__module__", "repro."), name
    with pytest.raises(AttributeError):
        TO.nothing_here


def golden_tracer(side):
    """``tests/test_obs.py``'s golden capture, built from one package."""
    tr = side["tracer"].SpanTracer(meta={"driver": "golden"})
    for r, t in ((0, 1.000), (1, 1.0002)):
        tr.on_event(r, "barrier_enter", 0, t)
    for r in (0, 1):
        tr.on_event(r, "barrier_exit", 0, 1.001)
        tr.on_event(r, "copy_exit", 0, 1.0015 + r * 1e-4)
    tr.on_event(0, "dispatch_enter", 1, 1.002)
    tr.on_event(0, "wait_enter", 1, 1.0028)
    tr.on_event(0, "barrier_exit", 1, 1.0031)
    tr.on_phase(side["events"].PhaseRecord(rank=1, call_id=7, t_enter=1.004,
                                           t_slack_end=1.0052, t_copy_end=1.0055, site=3))
    Actuation = side["governor"].Actuation
    tr.on_actuation(Actuation(t=1.0012, rank=1, action="set_pstate_min", call_id=0,
                              slack=8e-4))
    tr.on_actuation(Actuation(t=1.0019, rank=1, action="restore_pstate_max", call_id=0,
                              slack=8e-4))
    tr.on_theta(side["timeout"].ThetaDecision(t=1.003, site=2, rank=0, theta_before=5e-4,
                                              theta_after=3e-4, reason="decay", slack=1e-4))
    tr.serve_event("join", 1.0005, rid=4, slot=1)
    tr.serve_event("evict", 1.0056, rid=4, slot=1)
    tr.sample("governor", "slack_ratio_pct", 1.006, 12.5)
    tr.sample("arbiter", "cap_w[train]", 1.006, 1500.0)
    tr.sample("slo", "ttft_p95_ms", 1.006, 41.0)
    return tr


def test_port_tracer_builds_the_golden_perfetto_bytes():
    with open(os.path.join(GOLDEN_DIR, "perfetto.json")) as f:
        want = f.read()
    assert json.dumps(golden_tracer(PORT_SIDE).build(), sort_keys=True) == want
    assert ttracer.validate_trace(json.loads(want),
                                  require_tracks=tuple(ttracer.TRACK_PIDS)) == []


def telemetry(side, stream, theta, tmp_path):
    """A governor under ``policy_for_theta(theta)`` fed the canned stream,
    its recorder slot carrying a tap of bus metrics and a span tracer, a
    collector and a JSONL writer polled midway and at the end: returns
    every output, the snapshot lines' wall-clock ``t`` set to 0."""
    m, tr_mod, ex = side["metrics"], side["tracer"], side["export"]
    registry = m.MetricsRegistry()
    tracer = tr_mod.SpanTracer(meta={"driver": "canned", "stream": stream})
    gov = side["governor"].Governor(policy=side["policies"].policy_for_theta(theta),
                                    recorder=tr_mod.GovernorTap(tracer,
                                                                metrics=m.BusMetrics(registry)))
    collector = m.GovernorCollector(registry, gov)
    path = str(tmp_path / f"{side['metrics'].__name__}.jsonl")
    writer = ex.MetricsJsonlWriter(path, registry, collector)
    feed(gov, stream)
    writer.write(step=1, t=0.0)
    stats = collector.collect()
    tracer.sample("governor", "slack_ratio_pct", 9.0, 100.0 * stats.slack / max(stats.busy, 1e-30))
    writer.write(step=2, t=0.0)
    writer.close()
    tracer.ingest_governor(gov)
    report = gov.finalize().to_dict()
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    return dict(report=report, lines=lines, snapshot=registry.snapshot(),
                prometheus=ex.prometheus_text(registry),
                dashboard=ex.ConsoleDashboard(registry, title="canned").render(step=2),
                perfetto=json.dumps(tracer.build(), sort_keys=True),
                problems=jexport.validate_metrics_jsonl(path)), tracer


@pytest.mark.parametrize("stream,theta", [(s, "") for s in CANNED] + [("bursty", "auto")])
def test_canned_stream_gives_the_references_telemetry(stream, theta, tmp_path):
    mine, tracer = telemetry(PORT_SIDE, stream, theta, tmp_path)
    theirs, _ = telemetry(JAX_SIDE, stream, theta, tmp_path)
    assert mine["problems"] == [] and len(mine["lines"]) == 2
    assert mine["lines"][-1]["report"] == json.loads(json.dumps(mine["report"]))
    assert jtracer.validate_trace(json.loads(mine["perfetto"]),
                                  require_tracks=("governor",)) == []
    assert tracer.n_seen > 0 and tracer.n_dropped == 0
    for key in mine:
        assert mine[key] == theirs[key], key


# --------------------------------------------------------------------------
# the launchers' telemetry flags
# --------------------------------------------------------------------------

def serve_args(tmp_path, *extra):
    return ["--reduced", "--continuous", "--device", "cpu", "--n-requests", "6",
            "--steps", "6", "--prompt-len", "8", "--trace-out", str(tmp_path / "serve.jsonl"),
            "--perfetto-out", str(tmp_path / "serve.json"),
            "--metrics-out", str(tmp_path / "metrics.jsonl"), "--dashboard",
            "--power-cap", "300", *extra]


def test_serve_cli_telemetry_passes_the_references_validators(tmp_path, capsys):
    """``--trace-out --perfetto-out --metrics-out --dashboard --power-cap``
    on a served reduced llama: the reference's validators accept the
    Perfetto JSON (with the serve track) and the metrics JSONL, whose last
    report is the run's; the trace replays through the reference's
    ``replay`` to the run's report; the serve instants lie on the decode
    phases' clock; the power figures say they are modelled."""
    res = lserve.main(serve_args(tmp_path))
    rep = res["objects"]["report"].to_dict()
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[-1])["trace_out"] == res["trace_out"]
    assert any("(power: modelled" in line for line in out)
    assert res["power"]["watts"].startswith("modelled") and res["power"]["cap_w"] == 300.0
    assert res["power"]["n_calls"] == rep["n_calls"] == res["phases"] > 0

    assert jexport.validate_metrics_jsonl(res["metrics_out"]) == []
    with open(res["metrics_out"]) as f:
        lines = [json.loads(line) for line in f]
    assert res["metrics_lines"] == len(lines) == 1
    assert lines[-1]["report"] == json.loads(json.dumps(rep))
    assert lines[-1]["metrics"]["serve_completed_total"]["values"][0]["value"] == 6

    trace = json.load(open(res["perfetto_out"]))
    assert jtracer.validate_trace(trace, require_tracks=("ranks", "serve")) == []
    assert res["perfetto_dropped"] == 0 and res["dashboard_frames"] == 1
    events = trace["traceEvents"]
    spans = [e for e in events if e["ph"] == "X" and e["pid"] == ttracer.PID_RANKS]
    serve = [e for e in events if e["ph"] == "i" and e["name"] in ("join", "evict")]
    assert sum(e["name"] == "join" for e in serve) == sum(
        e["name"] == "evict" for e in serve) == 6 + 1 - 1    # the warm-up ran untraced
    # one clock: the instants sit among the phases, not hours before them
    first, last = min(e["ts"] for e in spans), max(e["ts"] + e["dur"] for e in spans)
    assert min(e["ts"] for e in serve) <= first < max(e["ts"] for e in serve)
    assert min(e["ts"] for e in serve) < last

    header, records = jtrace.load(res["trace_out"])
    assert header["meta"]["report"] == rep and res["trace_records"] == len(records)
    _, jrep = jtrace.replay(records)
    assert jrep.to_dict() == rep
    _, trep = ttrace.replay(ttrace.load(res["trace_out"])[1])
    assert trep.to_dict() == rep


def test_serve_cli_perfetto_out_writes_the_loops_spans(tmp_path):
    """``--continuous --perfetto-out``: the serve track holds the loop's
    spans, each decode ``step`` with its ``dispatch`` on the loop's thread
    and a ``queue`` wait a request, on named lanes where no two overlap."""
    res = lserve.main(["--reduced", "--continuous", "--device", "cpu", "--n-requests", "3",
                       "--steps", "3", "--prompt-len", "8",
                       "--perfetto-out", str(tmp_path / "serve.json")])
    trace = json.load(open(res["perfetto_out"]))
    assert ttracer.validate_trace(trace, require_tracks=("serve",)) == []
    spans = [e for e in trace["traceEvents"]
             if e["ph"] == "X" and e["pid"] == ttracer.PID_SERVE]
    names = {e["name"] for e in spans}
    assert {"step", "dispatch", "queue"} <= names, names
    steps = [e for e in spans if e["name"] == "step"]
    assert len(steps) == res["decode_steps"] and all(e["tid"] == 0 for e in steps)
    queues = sorted((e for e in spans if e["name"] == "queue"), key=lambda e: e["ts"])
    assert len(queues) == 3 and all(e["tid"] >= 1 for e in queues)
    for a, b in zip(queues, queues[1:]):
        assert a["tid"] != b["tid"] or a["ts"] + a["dur"] <= b["ts"]
    names = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M" and e["pid"] == ttracer.PID_SERVE and e["name"] == "thread_name"}
    assert names[0] == "loop" and all(names[e["tid"]].startswith("queue ") for e in queues)


def test_serve_cli_batched_ingest_and_tpot_target(tmp_path):
    """``--ingest batched`` exports the ingest-health families and leaves
    the report the event-mode run would book (the same phase stream);
    ``--tpot-target`` reaches the SLO tracker."""
    res = lserve.main(serve_args(tmp_path, "--ingest", "batched", "--tpot-target", "0.05"))
    assert jexport.validate_metrics_jsonl(res["metrics_out"]) == []
    with open(res["metrics_out"]) as f:
        metrics = json.loads(f.readlines()[-1])["metrics"]
    assert any(name.startswith("ingest_") for name in metrics), sorted(metrics)
    assert metrics["serve_tpot_target_seconds"]["values"][0]["value"] == 0.05
    assert res["completed"] == 6 and res["phases"] > 0
    _, jrep = jtrace.replay(jtrace.load(res["trace_out"])[1])
    assert jrep.to_dict() == res["objects"]["report"].to_dict()


def test_static_mode_serves_the_reference_engines_tokens():
    """The static batch (``--batch``, no ``--continuous``): the tokens of
    ``ServeEngine.generate`` on ``make_batch(kind="prefill")`` with
    ``key(1)``, as the reference's ``_run_static`` draws them; governor
    flags are ignored with the reference's warning."""
    import jax
    import numpy as np

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models.inputs import make_batch as jmake_batch
    from repro_torch import bridge

    from test_torch_engine import RecordingServe, assert_same_draws

    argv = ["--reduced", "--device", "cpu", "--batch", "3", "--prompt-len", "10",
            "--steps", "6", "--seed", "2"]
    res = lserve.run_static(lserve.parser().parse_args(argv))
    assert res["mode"] == "static" and res["shape"] == [3, 6] and res["temperature"] == 0.8
    jcfg = jreduced(jget_config("llama3.2-1b"))
    _, tcfg, tp = lserve._model(lserve.parser().parse_args(argv))
    jp = jax.tree.map(jax.numpy.asarray, bridge.params_to_numpy(tcfg, tp))
    ref = RecordingServe(jcfg, jp, max_len=10 + 6 + 8, temperature=0.8)
    want = np.asarray(ref.generate(jmake_batch(jcfg, 3, 10, kind="prefill"), n_steps=6,
                                   key=jax.random.PRNGKey(1)))
    assert_same_draws(res["tokens"], want, lambda r, n: ref.scores[n][r])


def test_static_mode_warns_that_governor_flags_do_nothing(capsys):
    lserve.main(["--reduced", "--device", "cpu", "--batch", "1", "--prompt-len", "4",
                 "--steps", "2", "--dashboard"])
    out = capsys.readouterr().out.splitlines()
    assert any(line.startswith("[serve] WARNING flags_ignored") for line in out), out
    assert json.loads(out[-1])["mode"] == "static"


def test_train_cli_telemetry_writes_valid_files(tmp_path):
    """Two live-event steps with every telemetry flag: the reference's
    validators accept the files, the last metrics line carries the run's
    report, the trace replays to it, and a power epoch is booked at each
    logged step with its watts labelled modelled."""
    res = ltrain.main(["--reduced", "--steps", "2", "--device", "cpu", "--live-events",
                       "--trace-out", str(tmp_path / "train.jsonl"),
                       "--perfetto-out", str(tmp_path / "train.json"),
                       "--metrics-out", str(tmp_path / "metrics.jsonl"), "--dashboard",
                       "--power-cap", "300"])
    rep = res["governor"]
    assert rep["n_calls"] == 4
    assert jexport.validate_metrics_jsonl(res["metrics_out"]) == []
    with open(res["metrics_out"]) as f:
        lines = [json.loads(line) for line in f]
    assert res["metrics_lines"] == len(lines) == 3 and lines[-1]["report"] == rep
    assert jtracer.validate_trace(res["perfetto_out"], require_tracks=("governor",)) == []
    header, records = jtrace.load(res["trace_out"])
    assert header["meta"]["report"] == rep
    assert jtrace.replay(records)[1].to_dict() == rep
    assert len(res["power"]["epochs"]) == 2 and res["power"]["watts"].startswith("modelled")
    assert res["dashboard_frames"] == 3
