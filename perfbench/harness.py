"""One run of one cell of the benchmark of ``repro_torch``.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<config>.json``: its sizes as run, under ``model``) and has a
file of its own, ``workloads/<cell>.json``: the traffic generator
(``traffic/<generator>.py``) and its parameters, the engine's slots, page
and temperature, when the window starts, how the traced run samples the
window, and the check's sample and limit.  A per-layer metric
``<quantity>[.<tag>]`` is read by ``metrics/<quantity>.py``.  Nothing here
names a cell, a configuration or a metric.

The run, on the card:

1. set-up: weights drawn on the card from ``--seed``
   (:mod:`perfbench.weights`), the program's ``ContinuousEngine`` with the
   hand-written kernels (``attn_kernel="cuda"``), one warm-up generate at
   the traffic's shortest and longest prompt, and the requests;
2. the window: ``ContinuousEngine.serve`` drives the whole traffic, wired
   as ``repro_torch.launch.serve.run_continuous`` wires it: a ``Governor``
   on an ``EventBus`` that the engine's ``DecodeSlackMeter`` publishes to,
   an ``SLOTracker``, per-request sampling keys.  The harness only listens:
   probes on the bus around the governor, the tracker's hooks and the
   engine's ``tracer`` slot.  It opens the window after ``start_after_s``
   seconds of traffic or ``start_after_joins`` joins, and closes it from
   the first probe past ``--seconds`` by raising :class:`WindowClosed`
   through the serving loop;
3. after the window: the peak memory, then the program's state freed and
   the check (:mod:`perfbench.reference`) on a sample of the finished
   greedy requests, drawn from the seed.

``--trace 1`` profiles slices of the window (``trace.every`` decode steps
apart, ``trace.active`` long) with ``torch.profiler`` (device activity
only) and reports the per-layer metrics; ``--trace 0`` the end-to-end
ones.  Timestamps are ``time.monotonic`` seconds; the device's records are
put on that clock by a sentinel kernel launched at each slice's start.
"""
from __future__ import annotations

import bisect
import dataclasses
import gc
import importlib
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SENTINEL = "spin_kernel"            # torch.cuda._sleep's kernel
# the sentinels' lengths in clock cycles: a short one opens a slice, a long
# one closes it, so that either one alone still pins the clock
SENTINEL_CYCLES = (20_000, 400_000)
SENTINEL_SPLIT_NS = 80_000


class WindowClosed(Exception):
    """Raised through the serving loop when the window's time is up."""


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def spec() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(name: str, bench: Optional[Dict] = None) -> Tuple[Dict, Dict, Dict]:
    """(BENCHMARK.json's entry, the workload file, the configuration file)."""
    bench = bench or spec()
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return entry, load_json(BENCH / "workloads" / f"{name}.json"), load_json(ROOT / conf["file"])


def metrics_of(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones without
    the trace, the per-layer ones with it."""
    out = [m for m in bench["per_layer" if trace else "end_to_end"]
           if cell in m.get("workloads", [cell])]
    moves = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    if trace:
        out = [m for m in out if m["moves"] in moves]
    return out


def reader(metric: str):
    """``metrics/<quantity>.py`` for ``<quantity>[.<tag>]``."""
    quantity = metric.split(".")[0]
    return importlib.import_module(f"perfbench.metrics.{quantity}")


def generator(name: str):
    return importlib.import_module(f"perfbench.traffic.{name}")


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


# --------------------------------------------------------------------------
# what the host did, on time.monotonic
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Step:
    t0: float                 # the meter's phase: inputs to the device ...
    t1: float                 # ... until the device is done
    n_active: int
    live: int                 # keys the active slots attend: sum of (position + 1)
    gov_s: float = 0.0        # the governor's entry point on this phase
    end: float = 0.0          # the last token hook of the step (sampling done)
    kernels: Optional[List[Tuple[str, float, float]]] = None


@dataclasses.dataclass
class Join:
    t0: float
    t1: float
    prompt_len: int
    kernels: Optional[List[Tuple[str, float, float]]] = None


class Recorder:
    """Listens to the serving loop: the bus probes, the tracker's hooks and
    the engine's tracer slot all land here."""

    def __init__(self, window_s: float, start_after_s: Optional[float],
                 start_after_joins: Optional[int], energy, tracer=None):
        self.window_s = window_s
        self.start_after_s = start_after_s
        self.start_after_joins = start_after_joins
        self.energy = energy
        self.tracer = tracer
        self.t_serve = 0.0
        self.ws = self.we = self.t_close = None
        self.e_start = self.e_close = None
        self.steps: List[Step] = []
        self.joins: List[Join] = []
        self.idles: List[Tuple[float, float]] = []
        self.gov_total = 0.0
        self.n_joins = 0
        self.mark = 0.0               # the host's latest known instant
        self.active: Dict[int, Any] = {}
        self.requests: Dict[int, Any] = {}
        self.first: Dict[int, float] = {}
        self.token_times: Dict[int, List[float]] = {}
        self.finished: List[Any] = []
        self.close_tokens = 0
        self.tap: Optional[LogitTap] = None
        self._pre = 0.0
        from repro_torch.serve.slack import SITE_DECODE_STEP

        self._step_site = SITE_DECODE_STEP

    # the window --------------------------------------------------------
    def _open(self, t: float) -> None:
        self.ws = t
        self.we = t + self.window_s
        self.e_start = self.energy.read() if self.energy else None

    def _maybe_close(self, t: float, tokens_due: int) -> None:
        if self.ws is not None and t >= self.we:
            self.t_close = t
            self.close_tokens = tokens_due
            self.e_close = self.energy.read() if self.energy else None
            raise WindowClosed()

    # bus probes around the governor ----------------------------------------
    def pre(self, rec) -> None:
        self._pre = time.monotonic()

    def post(self, rec) -> None:
        t = time.monotonic()
        gov = t - self._pre
        inside = self.ws is not None
        if inside:
            self.gov_total += gov
        if rec.site == self._step_site:
            live = sum(len(r.prompt) + len(r.out) for r in self.active.values())
            self.steps.append(Step(rec.t_enter, rec.t_copy_end, len(self.active), live, gov,
                                   t))
            if self.tracer is not None and inside:
                self.tracer.on_step(self, t)
        else:
            self.idles.append((rec.t_enter, rec.t_copy_end))
        self.mark = t
        if self.ws is None and self.start_after_s is not None \
                and t - self.t_serve >= self.start_after_s:
            self._open(t)
        if rec.site == self._step_site:
            self._maybe_close(t, len(self.active))
        else:
            self._maybe_close(t, 0)

    # the engine's tracer slot ------------------------------------------------
    def serve_event(self, kind: str, t: float, rid: int, slot: int) -> None:
        if kind == "join":
            req = self.requests[rid]
            self.active[rid] = req
            if self.tap is not None:
                self.tap.joined(req)
            self.joins.append(Join(self.mark, t, len(req.prompt)))
            self.n_joins += 1
            if self.ws is None and self.start_after_joins is not None \
                    and self.n_joins >= self.start_after_joins:
                self._open(t)
        else:
            self.active.pop(rid, None)
        self.mark = t

    # the SLO tracker's hooks (session seconds) ---------------------------------
    def token(self, req, now: float, first: bool) -> None:
        t = self.t_serve + now
        if first:
            self.first[req.rid] = t
        self.token_times.setdefault(req.rid, []).append(t)
        if not first and self.steps:
            self.steps[-1].end = max(self.steps[-1].end, t)
        self.mark = t

    def finish(self, req, now: float) -> None:
        self.finished.append(req)
        self.mark = self.t_serve + now


class LogitTap:
    """Keeps the largest logit of every row that the engine's draw sees
    (``serve.engine.sample_rows``, wrapped while the traffic runs): for a
    greedy request, its served token's logit at each position.  One
    reduction a call stays on the card; the host notes whose rows they are."""

    def __init__(self, rec: Recorder):
        self.rec = rec
        self.rows: List[Tuple[torch.Tensor, List[Tuple[int, int, int]]]] = []
        self._pending = None
        self._real = None

    def __call__(self, logits, rows, keys, temperature):
        tok = self._real(logits, rows, keys, temperature)
        top = logits.max(dim=-1).values
        if logits.shape[0] == 1:                       # a join's first token
            self._pending = top
        else:
            mine = [(r.rid, r.slot, len(r.out)) for r in self.rec.active.values()
                    if r.key is None]
            if mine:
                self.rows.append((top, mine))
        return tok

    def joined(self, req) -> None:
        if self._pending is not None and req.key is None:
            self.rows.append((self._pending, [(req.rid, 0, 0)]))
        self._pending = None

    def install(self):
        from repro_torch.serve import engine

        self._real = engine.sample_rows
        engine.sample_rows = self

    def remove(self):
        from repro_torch.serve import engine

        engine.sample_rows = self._real

    def served_max(self) -> Dict[int, Dict[int, float]]:
        """request -> {position: the program's largest logit there}."""
        out: Dict[int, Dict[int, float]] = {}
        for top, mine in self.rows:
            vals = top.float().cpu().tolist()
            for rid, row, n in mine:
                out.setdefault(rid, {})[n] = vals[row]
        return out


def tracker(rec: Recorder):
    """An ``SLOTracker`` whose hooks also tell the recorder."""
    from repro_torch.serve.slo import SLOTracker

    class Tracker(SLOTracker):
        def on_first_token(self, req, now):
            super().on_first_token(req, now)
            rec.token(req, now, True)

        def on_token(self, req, now):
            super().on_token(req, now)
            rec.token(req, now, False)

        def on_finish(self, req, now):
            super().on_finish(req, now)
            rec.finish(req, now)

    return Tracker(tpot_target=None)


class Probe:
    """A bus subscriber that calls ``fn`` with each phase."""

    def __init__(self, fn):
        self.on_phase = fn


# --------------------------------------------------------------------------
# tracing: slices of the window under torch.profiler
# --------------------------------------------------------------------------

class Tracer:
    """Profiles ``active`` decode steps every ``every`` steps of the window."""

    def __init__(self, every: int, active: int, energy):
        self.every, self.active, self.energy = every, active, energy
        self.n = 0
        self.prof = None
        self.slices: List[Tuple[float, float]] = []
        self.energy_slices: List[Tuple[float, float]] = []
        self.kernels: List[Tuple[str, float, float]] = []
        self.aligned = 0              # slices put on the host's clock by their sentinel
        self._start = None

    def warm(self) -> None:
        """Pay the profiler's first start in set-up."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()

    def on_step(self, rec: Recorder, t: float) -> None:
        self.n += 1
        phase = self.n % self.every
        if phase == 0 and self.prof is None:
            self._begin()
        elif phase == self.active and self.prof is not None:
            self.end()

    def _begin(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self._start = (self._sentinel(SENTINEL_CYCLES[0]),
                       self.energy.read() if self.energy else None)

    @staticmethod
    def _sentinel(cycles: int) -> float:
        """The host's clock just before a sentinel kernel starts on an idle card."""
        torch.cuda.synchronize()
        t = time.monotonic()
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
        return t

    def end(self) -> None:
        if self.prof is None:
            return
        t_end = self._sentinel(SENTINEL_CYCLES[1])
        e_end = self.energy.read() if self.energy else None
        wall = time.time() - time.monotonic()
        self.prof.stop()
        t_host, e_start = self._start
        events = self.prof.profiler.kineto_results.events()
        self.prof = None
        dev = []
        for e in events:
            if str(e.device_type()).endswith("CUDA"):
                start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
                dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
                dev.append((e.name(), start, dur))
        # the profiler's clock is the wall clock; a sentinel pins the offset
        # to the host's monotonic one (the profiler may drop a slice's first
        # device record), else the two clocks' offset does
        opening = [st for n, st, d in dev if SENTINEL in n and d < SENTINEL_SPLIT_NS]
        closing = [st for n, st, d in dev if SENTINEL in n and d >= SENTINEL_SPLIT_NS]
        if opening:
            offset = min(opening) / 1e9 - t_host
            self.aligned += 1
        elif closing:
            offset = max(closing) / 1e9 - t_end
            self.aligned += 1
        else:
            offset = wall
        self.slices.append((t_host, t_end))
        if e_start is not None:
            self.energy_slices.append((e_end[1] - e_start[1], e_end[0] - e_start[0]))
        for name, start, dur in dev:
            s = start / 1e9 - offset
            self.kernels.append((name, s, s + dur / 1e9))


def union_busy(kernels: List[Tuple[str, float, float]], lo: float, hi: float
               ) -> Tuple[float, List[Tuple[float, float]]]:
    """(busy seconds, idle gaps) of the kernels' intervals inside [lo, hi]."""
    iv = sorted((max(s, lo), min(e, hi)) for _, s, e in kernels if e > lo and s < hi)
    busy, gaps, cur = 0.0, [], lo
    run_s = run_e = None
    for s, e in iv:
        if run_e is None or s > run_e:
            if run_e is not None:
                busy += run_e - run_s
            if s > cur:
                gaps.append((cur, s))
            run_s, run_e = s, e
        else:
            run_e = max(run_e, e)
        cur = max(cur, run_e)
    if run_e is not None:
        busy += run_e - run_s
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


def host_label(rec: Recorder, t: float) -> str:
    """What the host was doing at ``t``."""
    for s in rec.steps:
        if s.t0 <= t <= s.t1:
            return "decode_step"
        if s.t1 < t <= s.end:
            return "governor" if t <= s.t1 + s.gov_s else "sampling"
    for j in rec.joins:
        if j.t0 <= t <= j.t1:
            return "join"
    for a, b in rec.idles:
        if a <= t <= b:
            return "waiting_for_arrivals"
    return "host_other"


def attach_kernels(rec: Recorder, tr: Tracer) -> None:
    """Give each step and join that lies wholly inside a slice its kernels."""
    ks = sorted((k for k in tr.kernels if SENTINEL not in k[0]), key=lambda k: k[1])
    starts = [k[1] for k in ks]

    def within(lo, hi):
        return ks[bisect.bisect_left(starts, lo):bisect.bisect_right(starts, hi)]

    for lo, hi in tr.slices:
        for s in rec.steps:
            if lo <= s.t0 and max(s.end, s.t1) <= hi:
                s.kernels = within(s.t0, max(s.end, s.t1))
        for j in rec.joins:
            if lo <= j.t0 and j.t1 <= hi:
                j.kernels = within(j.t0, j.t1)


# --------------------------------------------------------------------------
# the end-to-end metrics
# --------------------------------------------------------------------------

def p90(values: List[float]) -> Optional[float]:
    return float(np.percentile(np.asarray(values, float), 90)) if values else None


def ttft_samples(arrivals: Dict[int, float], first: Dict[int, float], ws: float,
                 we: float) -> List[float]:
    """Every request due in [ws, we], from when it was due to its first
    token; one still waiting at ``we`` counts with its wait so far."""
    out = []
    for rid, a in arrivals.items():
        if ws <= a <= we:
            f = first.get(rid)
            out.append((f if f is not None and f <= we else we) - a)
    return out


def tpot_samples(token_times: Dict[int, List[float]], running: set, ws: float,
                 we: float) -> List[float]:
    """Every gap between consecutive tokens of a request that ends in
    (ws, we]; a gap still open at ``we`` (the next token later, or a
    request still running) counts with its length so far."""
    out = []
    for rid, ts in token_times.items():
        for a, b in zip(ts, ts[1:]):
            if ws < b <= we:
                out.append(b - a)
            elif a <= we < b:
                out.append(we - a)
        if ts and ts[-1] <= we and rid in running:
            out.append(we - ts[-1])
    return out


def tokens_in(token_times: Dict[int, List[float]], lo: float, hi: float) -> int:
    return sum(1 for ts in token_times.values() for t in ts if lo < t <= hi)


# --------------------------------------------------------------------------
# the run
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RunRecord:
    """What a per-layer metric reader gets."""
    model: Dict
    workload: Dict
    rec: Recorder
    tracer: Optional[Tracer]
    peaks: Dict
    counts: Any
    kind: str                 # the card's name, for its row of peaks.json

    union_busy = staticmethod(union_busy)

    @property
    def window_steps(self) -> List[Step]:
        r = self.rec
        return [s for s in r.steps if s.t0 >= r.ws and s.t1 <= r.t_close]

    @property
    def window_joins(self) -> List[Join]:
        r = self.rec
        return [j for j in r.joins if j.t0 >= r.ws and j.t1 <= r.t_close]


def model_config(model: Dict):
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(**model)


def make_requests(specs: List[Dict], vocab: int, seed: int, temperature: float):
    """The program's ``Request`` objects: prompt ids drawn from the seed,
    sampling keys ``fold_in(key(seed), i)`` as ``run_continuous`` gives
    them, none for the greedy ones."""
    from repro_torch import jrandom
    from repro_torch.serve.scheduler import Request

    rng = np.random.default_rng([seed, 1])
    base = jrandom.key(seed) if temperature > 0 else None
    out = []
    for i, s in enumerate(specs):
        prompt = rng.integers(0, vocab, size=s["prompt_len"]).astype(np.int32)
        key = None if (base is None or s["greedy"]) else jrandom.fold_in(base, i)
        out.append(Request(prompt=prompt, max_new=s["max_new"], arrival=s["arrival"], key=key))
    return out


def check_sample(finished: List, want_tokens: int, seed: int, seen: Dict) -> List:
    """Finished greedy requests to compare: the longest, then others drawn
    from the seed until ``want_tokens`` served tokens are in; only those
    whose every served position the tap saw (``seen``)."""
    greedy = [r for r in finished if r.key is None and r.out
              and len(seen.get(r.rid, ())) == len(r.out)]
    if not greedy:
        return []
    longest = max(greedy, key=lambda r: (len(r.out), len(r.prompt)))
    rest = [r for r in greedy if r is not longest]
    rng = np.random.default_rng([seed, 2])
    picked, n = [longest], len(longest.out)
    for i in rng.permutation(len(rest)):
        if n >= want_tokens:
            break
        picked.append(rest[i])
        n += len(rest[i].out)
    return picked


def run(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_process: Optional[float] = None, control: bool = False,
        rate: Optional[float] = None, bench: Optional[Dict] = None,
        overrides: Optional[Dict] = None) -> Dict:
    """One run; returns the result line's object (``"check"`` last).
    ``control`` also reads the control's numbers (the reference with bf16
    products in the program's place) and a witness's (fp64 products),
    into ``info["readings"]``; ``rate`` replaces an
    open-loop mix's rate (the knee's sweep); ``overrides`` updates the
    configuration's ``model`` and the workload file's blocks (``mix``,
    ``serve``, ``window``, ``check``) key by key: the CPU tests' small
    cells."""
    from repro_torch.core.events import EventBus
    from repro_torch.core.governor import Governor
    from repro_torch.core.policies import policy_for_theta
    from repro_torch.serve.engine import ContinuousEngine

    from perfbench import counts, reference, weights

    t_process = time.monotonic() if t_process is None else t_process
    bench = bench or spec()
    _, wl, conf = cell_files(cell, bench)
    overrides = overrides or {}
    model = dict(conf["model"], **overrides.get("model", {}))
    wl = {k: dict(v, **overrides.get(k, {})) if isinstance(v, dict) else v
          for k, v in wl.items()}
    cfg = model_config(model)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    serve = wl["serve"]
    params_t = dict(wl["mix"])
    if rate is not None:
        params_t["rate_per_s"] = rate
    horizon = wl["window"].get("start_after_s", 0) + seconds + wl["window"].get("tail_s", 0)
    specs = generator(wl["generator"]).requests(params_t, seed, horizon)

    t_setup = {"process_to_run": time.monotonic() - t_process}
    t = time.monotonic()
    params = weights.draw(model, seed, dev)
    if on_card:
        torch.cuda.synchronize(dev)
    t_setup["weights"] = time.monotonic() - t
    t = time.monotonic()
    max_len = max(s["prompt_len"] + s["max_new"] for s in specs) + serve["page"]
    max_len += (-max_len) % serve["page"]
    eng = ContinuousEngine(cfg, params, n_slots=serve["slots"], max_len=max_len,
                           page=serve["page"], temperature=serve["temperature"],
                           attn_kernel="cuda" if on_card else "plain", device=dev)
    # warm-up: the traffic's shortest and longest prompt, sampled and greedy
    from repro_torch import jrandom

    lens = sorted({min(s["prompt_len"] for s in specs), max(s["prompt_len"] for s in specs)})
    warm_rng = np.random.default_rng([seed, 3])
    for n in lens:
        toks = warm_rng.integers(0, cfg.vocab, size=(2, n)).astype(np.int32)
        eng.generate({"tokens": toks}, n_steps=3, key=jrandom.key(seed + 1))
    if on_card:
        torch.cuda.synchronize(dev)
    t_setup["engine_and_warm_up"] = time.monotonic() - t
    energy = None
    if on_card:
        from perfbench.energy import Energy

        energy = Energy(dev.index or 0)
    tr = None
    if trace and on_card:
        tr = Tracer(wl["trace"]["every"], wl["trace"]["active"], energy)
        tr.warm()
    reqs = make_requests(specs, cfg.vocab, seed, serve["temperature"])
    rec = Recorder(seconds, wl["window"].get("start_after_s"),
                   wl["window"].get("start_after_joins"), energy, tr)
    rec.requests = {r.rid: r for r in reqs}
    gov = Governor(policy=policy_for_theta(""))
    bus = EventBus()
    bus.subscribe(Probe(rec.pre))
    bus.subscribe(gov)
    bus.subscribe(Probe(rec.post))
    slo = tracker(rec)
    eng.tracer = rec
    rec.tap = LogitTap(rec)
    rec.tap.install()
    if on_card:
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    rec.t_serve = time.monotonic()
    try:
        eng.serve(reqs, governor=bus, slo=slo)
        raise RuntimeError("the traffic ran out before the window closed")
    except WindowClosed:
        pass
    finally:
        rec.tap.remove()
        if tr is not None:
            tr.end()
        gc.unfreeze()
    if on_card:
        torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    report = gov.finalize()
    ws, we = rec.ws, rec.we
    arrivals = {r.rid: rec.t_serve + r.arrival for r in reqs}
    open_rids = set(rec.active)
    tpots = tpot_samples(rec.token_times, open_rids, ws, we)
    metrics: Dict[str, Dict] = {}
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    run_rec = RunRecord(model, wl, rec, tr, load_json(BENCH / "peaks.json"), counts, kind)
    if tr is not None:
        attach_kernels(rec, tr)
    for m in metrics_of(bench, cell, trace):
        name = m["name"]
        if trace:
            v = reader(name).read(run_rec)
        elif name == "setup_s":
            v = ws - t_process
        elif name == "ttft_p90_ms":
            v = p90(ttft_samples(arrivals, rec.first, ws, we))
            v = None if v is None else v * 1e3
        elif name == "tpot_p50_ms":
            v = np.percentile(tpots, 50) * 1e3 if tpots else None
        elif name == "tok_per_s":
            v = tokens_in(rec.token_times, ws, we) / (we - ws)
        elif name == "joules_per_token":
            n = tokens_in(rec.token_times, ws, rec.t_close) + rec.close_tokens
            v = (rec.e_close[1] - rec.e_start[1]) / n if rec.e_start and n else None
        else:
            raise KeyError(f"no end-to-end metric {name!r}")
        if v is not None:
            metrics[name] = {"value": float(v), "unit": m["unit"]}

    due = [rid for rid, a in arrivals.items() if ws <= a <= we]
    t_setup["traffic_before_window"] = ws - rec.t_serve
    third = (we - ws) / 3
    waits = {k: [(rec.first.get(rid, we) if rec.first.get(rid, we) <= we else we) - a
                 for rid, a in arrivals.items() if lo <= a <= lo + third]
             for k, lo in (("first", ws), ("last", we - third))}
    attempted = set(due) | {rid for rid, ts in rec.token_times.items()
                            if any(ws < t <= we for t in ts)}
    info = {
        "window_s": we - ws, "requests_due": len(due), "joins": len(run_rec.window_joins),
        "decode_steps": len(run_rec.window_steps),
        "tokens": tokens_in(rec.token_times, ws, we),
        "fill": (statistics.mean(s.n_active for s in run_rec.window_steps) / serve["slots"]
                 if run_rec.window_steps else 0.0),
        "setup_parts_s": t_setup,
        "ttft_p50_ms": float(np.percentile(ttft_samples(arrivals, rec.first, ws, we), 50)) * 1e3
        if due else None,
        "tpot_p50_ms": float(np.percentile(tpots, 50)) * 1e3 if tpots else None,
        "tpot_p95_ms": float(np.percentile(tpots, 95)) * 1e3 if tpots else None,
        **{f"ttft_mean_ms_{k}_third": statistics.mean(v) * 1e3 if v else None
           for k, v in waits.items()},
        "waiting_at_close": sum(1 for rid in due if rec.first.get(rid, we + 1) > we),
        "active_at_close": len(open_rids),
        "modelled_energy_saving_pct": report.energy_saving_pct,
        "modelled_priced_slack_ms": report.total_slack * 1e3,
    }
    breakdown = None
    device_info: Dict[str, Any] = {"platform": "gpu" if on_card else "cpu",
                                   "kind": kind,
                                   "count": 1, "memory_peak_bytes": int(peak)}
    if tr is not None:
        busy = win = 0.0
        gaps: List[Tuple[float, float]] = []
        for lo, hi in tr.slices:
            b, g = union_busy(tr.kernels, lo, hi)
            busy += b
            win += hi - lo
            gaps += g
        device_info.update(busy_s=busy, window_s=win)
        by_name: Dict[str, float] = {}
        for name, s, e in tr.kernels:
            if SENTINEL not in name:
                by_name[name] = by_name.get(name, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        breakdown = {"device_ops": [[n[:120], v] for n, v in top],
                     "idle_gaps": [[host_label(rec, (a + b) / 2), b - a] for a, b in longest]}
        info["traced_share"] = win / (rec.t_close - ws)
        info["traced_slices"] = len(tr.slices)
        info["slices_aligned_by_sentinel"] = tr.aligned
        info["traced_steps"] = sum(s.kernels is not None for s in run_rec.window_steps)
        info["traced_joins"] = sum(j.kernels is not None for j in run_rec.window_joins)

    # the check: after the program's state is freed
    seen = rec.tap.served_max()
    sample = check_sample(rec.finished, wl["check"]["served_tokens"], seed, seen)
    del eng, bus, gov, slo, reqs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    got = reference.compare(model, params, [
        (r.prompt.tolist(), r.out, [seen[r.rid][i] for i in range(len(r.out))]) for r in sample],
        control=control)
    limits, floor = wl["check"]["limits"], wl["check"]["min_tokens"]
    correct = all(got[k] <= v for k, v in limits.items()) and got["tokens"] >= floor
    info["check_s"] = time.monotonic() - t_check
    info["check_requests"] = len(sample)
    info["readings"] = {k: got[k] for k in got if k not in ("per_request", "tokens")}
    if energy is not None:
        info["energy_source"] = energy.source
        info["power_limit_w"] = energy.power_limit_w()
        energy.close()
    result = {
        "correct": bool(correct),
        "attempted": len(attempted),
        "failed": sum(any(p[k] > v for k, v in limits.items()) for p in got["per_request"])
        + (got["tokens"] < floor),
        "metrics": metrics,
        "device": device_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["info"] = info
    # the numbers compared, each beside its limit (served_tokens: at least)
    result["check"] = {k: {"value": got[k], "limit": v} for k, v in limits.items()}
    result["check"]["served_tokens"] = {"value": got["tokens"], "limit": floor}
    return result
