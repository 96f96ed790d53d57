"""The port's serving loop's spans (``EngineSession`` through a tracer's
``span`` hook) and their rendering by ``SpanTracer``, on the CPU.

Each decode ``step`` is tiled, in order, by ``prepare``, ``dispatch``,
``device_wait``, ``publish`` (with a governor on the bus), ``sample`` and
``bookkeep``; ``dispatch`` + ``device_wait`` is the step's synchronised
time in ``step_seconds``.  A request's ``queue`` wait runs from when it was
due to its ``join``, which ends on the engine's ``join`` instant; a
join's ``join_dispatch`` ends when the prefill has been enqueued, before
the pages' copy; the joins of one admission lie in its ``admit``.  Spans
nest by time.  Every stamp is ``time.monotonic``.  The spans change no
token.
"""
import time

import numpy as np
import pytest
import torch

import repro_torch.serve.engine as engine_mod
from repro_torch.configs import get_config, reduced
from repro_torch.core.events import EventBus
from repro_torch.core.governor import Governor
from repro_torch.models.transformer import init_params
from repro_torch.obs.tracer import PID_SERVE, SpanTracer, validate_trace
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.serve.scheduler import Request

STEP_CHILDREN = ("prepare", "dispatch", "device_wait", "publish", "sample", "bookkeep")


class Capture:
    """A tracer that keeps what the engine hands it."""

    def __init__(self):
        self.spans = []
        self.instants = []

    def serve_event(self, kind, t, rid, slot):
        self.instants.append((kind, t, rid, slot))

    def span(self, name, t0, t1, rid, n):
        self.spans.append(dict(name=name, t0=t0, t1=t1, rid=rid, n=n))


class NoSpan:
    """A tracer that carries the attribute and disowns the hook."""

    span = None

    def __init__(self):
        self.instants = []

    def serve_event(self, kind, t, rid, slot):
        self.instants.append((kind, t, rid, slot))


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("llama3.2-1b"))
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def requests(cfg, arrivals, max_new=3, temperature_keys=False):
    from repro_torch import jrandom

    rng = np.random.default_rng(1)
    return [Request(prompt=rng.integers(0, cfg.vocab, 5 + i).astype(np.int32),
                    max_new=max_new, arrival=a,
                    key=jrandom.key(i) if temperature_keys else None)
            for i, a in enumerate(arrivals)]


def serve(model, tracer, arrivals=(0.0, 0.0, 0.0), governor=True, temperature=0.0):
    cfg, params = model
    eng = ContinuousEngine(cfg, params, n_slots=2, max_len=32, page=8, device="cpu",
                           temperature=temperature, tracer=tracer)
    gov = None
    if governor:
        gov = EventBus()
        gov.subscribe(Governor())
    done = eng.serve(requests(cfg, arrivals, temperature_keys=temperature > 0),
                     governor=gov)
    return eng, sorted(done, key=lambda r: r.rid)


def by_name(spans, name):
    return [s for s in spans if s["name"] == name]


def children(spans, parent, names):
    """The spans of ``names`` written right after ``parent``, in order."""
    i = next(k for k, s in enumerate(spans) if s is parent) + 1
    kids = []
    while i < len(spans) and spans[i]["name"] in names:
        kids.append(spans[i])
        i += 1
    return kids


def inside(kid, parent):
    return parent["t0"] <= kid["t0"] <= kid["t1"] <= parent["t1"]


def test_each_step_is_tiled_by_its_six_children_in_order(model):
    cap = Capture()
    eng, _ = serve(model, cap)
    sess = eng._last_session
    steps = by_name(cap.spans, "step")
    assert len(steps) == sess.steps == len(sess.step_seconds) > 0
    for step, seconds in zip(steps, sess.step_seconds):
        kids = children(cap.spans, step, STEP_CHILDREN)
        assert tuple(k["name"] for k in kids) == STEP_CHILDREN
        assert all(inside(k, step) for k in kids)
        assert kids[0]["t0"] == step["t0"] and kids[-1]["t1"] == step["t1"]
        for a, b in zip(kids, kids[1:]):
            assert a["t1"] == pytest.approx(b["t0"], abs=1e-9) and a["t0"] <= a["t1"]
        assert all(k["n"] == step["n"] for k in kids) and 1 <= step["n"] <= 2
        dispatch, wait = kids[1], kids[2]
        assert (dispatch["t1"] - dispatch["t0"]) + (wait["t1"] - wait["t0"]) == \
            pytest.approx(seconds, abs=1e-9)
    assert all(s["rid"] is None for s in steps)
    assert all(not (a["t0"] < b["t1"] and b["t0"] < a["t1"]) for a, b in zip(steps, steps[1:]))


def test_queue_ends_where_its_join_starts_and_the_join_on_its_instant(model):
    cap = Capture()
    eng, done = serve(model, cap)
    t_start = eng._last_session.t_start
    joins = {s["rid"]: s for s in by_name(cap.spans, "join")}
    queues = {s["rid"]: s for s in by_name(cap.spans, "queue")}
    instants = {rid: t for kind, t, rid, _ in cap.instants if kind == "join"}
    assert set(joins) == set(queues) == set(instants) == {r.rid for r in done}
    for req in done:
        q, j = queues[req.rid], joins[req.rid]
        assert q["t0"] == t_start + req.arrival and q["t1"] == j["t0"]
        assert q["n"] == j["n"] == len(req.prompt)
        # the join ends on the engine's join instant: one clock
        assert j["t1"] == instants[req.rid]
        # so queue + join is the request's TTFT on the session's clock
        assert (q["t1"] - q["t0"]) + (j["t1"] - j["t0"]) == \
            pytest.approx(req.t_first - req.arrival, abs=1e-6)
        kids = children(cap.spans, j, ("join_dispatch", "join_wait"))
        assert [k["name"] for k in kids] == ["join_dispatch", "join_wait"]
        assert all(inside(k, j) for k in kids)
        assert kids[0]["t0"] == j["t0"] and kids[0]["t1"] == kids[1]["t0"]
        assert kids[1]["t1"] == j["t1"]


def test_an_admission_holds_the_joins_it_makes(model):
    cap = Capture()
    serve(model, cap, arrivals=(0.0, 0.0, 0.0))
    admits = by_name(cap.spans, "admit")
    joins = by_name(cap.spans, "join")
    assert sum(a["n"] for a in admits) == len(joins) == 3
    for a in admits:
        mine = [j for j in joins if inside(j, a)]
        assert len(mine) == a["n"] and a["rid"] is None
        assert a["t0"] <= mine[0]["t0"] and mine[-1]["t1"] == a["t1"]
    # two slots: the first admission joins two requests, the third waits
    assert admits[0]["n"] == 2


def test_join_dispatch_ends_when_the_prefill_is_enqueued(model, monkeypatch):
    """The enqueue instant is taken as the prefill returns, before the
    pages' copy to the device (a copy that waits for the prefill on a
    card), so the copy, the pool scatter and the draw fall in
    ``join_wait``."""
    cfg, params = model
    cap = Capture()
    eng = ContinuousEngine(cfg, params, n_slots=2, max_len=32, page=8, device="cpu",
                           tracer=cap)
    returned, copies, scatters = [], [], []
    prefill, to_device, join = engine_mod._prefill, eng._to_device, eng._join

    def timed_prefill(*a, **k):
        out = prefill(*a, **k)
        returned.append(time.monotonic())
        return out

    def timed_copy(a):
        copies.append(time.monotonic())
        return to_device(a)

    def timed_scatter(*a):
        scatters.append(time.monotonic())
        return join(*a)

    monkeypatch.setattr(engine_mod, "_prefill", timed_prefill)
    monkeypatch.setattr(eng, "_to_device", timed_copy)
    monkeypatch.setattr(eng, "_join", timed_scatter)
    eng.serve(requests(cfg, (0.0, 0.0, 0.0)), governor=None)
    ends = [s["t1"] for s in by_name(cap.spans, "join_dispatch")]
    waits = by_name(cap.spans, "join_wait")
    assert len(ends) == len(returned) == len(scatters) == len(waits) == 3
    for end, t_ret, t_scatter, wait in zip(ends, returned, scatters, waits):
        pages_copy = min(t for t in copies if t >= t_ret)      # the pages, for the scatter
        assert t_ret <= end <= pages_copy <= t_scatter
        assert wait["t0"] == end and pages_copy <= wait["t1"]


def test_without_a_governor_a_step_has_no_publish(model):
    cap = Capture()
    serve(model, cap, governor=False)
    step = by_name(cap.spans, "step")[0]
    kids = [s["name"] for s in children(cap.spans, step, STEP_CHILDREN)]
    assert tuple(kids) == tuple(k for k in STEP_CHILDREN if k != "publish")


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_spans_change_no_token(model, temperature):
    """The same tokens with the span hook, with a tracer that disowns it,
    and with no tracer; the instants alike with and without the hook."""
    runs = {}
    tracers = {"spans": Capture(), "no_span": NoSpan(), "none": None}
    for name, tracer in tracers.items():
        _, done = serve(model, tracer, temperature=temperature)
        runs[name] = [r.out for r in done]
    assert runs["spans"] == runs["no_span"] == runs["none"]
    assert tracers["spans"].spans and len(tracers["no_span"].instants) == \
        len(tracers["spans"].instants)


def test_build_renders_the_spans_that_validate_trace_accepts():
    tr = SpanTracer(meta={"run": "spans"})
    tr.serve_event("join", 1.0004, rid=7, slot=0)
    tr.span("queue", 1.0, 1.0001, 7, 40)
    tr.span("join", 1.0001, 1.0004, 7, 40)
    tr.span("admit", 1.00005, 1.0004, None, 1)
    tr.span("step", 1.0005, 1.0010, None, 1)
    tr.span("prepare", 1.0005, 1.0006, None, 1)
    tr.span("queue", 1.00002, 1.0008, 8, 12)
    trace = tr.build()
    assert validate_trace(trace, require_tracks=("serve",)) == []
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert all(e["pid"] == PID_SERVE and e["cat"] == "serve" for e in xs)
    tids = {e["name"] + str(e["args"]["rid"]): e["tid"] for e in xs}
    assert tids["queue7"] == 1 and tids["queue8"] == 2
    assert tids["join7"] == tids["admitNone"] == tids["stepNone"] == 0
    first = xs[0]
    assert first["name"] == "queue" and first["ts"] == 0.0 and first["dur"] == 100.0
    assert first["args"] == {"rid": 7, "n": 40}
    # a span that starts with the one holding it follows it
    names = [e["name"] for e in xs]
    assert names.index("step") + 1 == names.index("prepare")
    assert tr.n_seen == 7 and trace["otherData"]["n_dropped"] == 0
    threads = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
               if e["ph"] == "M" and e["pid"] == PID_SERVE and e["name"] == "thread_name"}
    assert threads == {0: "loop", 1: "queue 0", 2: "queue 1"}


def test_queue_waits_reuse_a_lane_once_it_is_free():
    """Many requests, few overlapping at a time: the waits take as many
    lanes as overlap at once, and no lane holds two at one instant."""
    tr = SpanTracer()
    rng = np.random.default_rng(0)
    waits = []
    for rid in range(200):
        t0 = rid * 0.01 + float(rng.uniform(0, 0.005))
        waits.append((t0, t0 + float(rng.uniform(0.001, 0.03))))
        tr.span("queue", *waits[-1], rid, 1)
    trace = tr.build()
    assert validate_trace(trace, require_tracks=("serve",)) == []
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    most = max(sum(a <= t < b for a, b in waits) for t, _ in waits)
    lanes = {}
    for e in xs:
        lanes.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"]))
    assert len(lanes) == most < 10 and min(lanes) == 1
    for spans in lanes.values():
        spans.sort()
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    names = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"] if e["ph"] == "M"
             and e["pid"] == PID_SERVE and e["name"] == "thread_name"}
    assert names == {0: "loop", **{1 + k: f"queue {k}" for k in range(most)}}
