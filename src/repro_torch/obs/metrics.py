"""Low-overhead labeled metrics registry fed by the event bus and governor.

Three instrument kinds, Prometheus-shaped so the exposition layer in
:mod:`repro_torch.obs.export` is a direct rendering:

* :class:`Counter` — monotone float per label set (``*_total`` names).
* :class:`Gauge` — last-write float per label set.
* :class:`Histogram` — fixed log-binned buckets over the same
  ``geomspace(1e-6, 30, 97)`` edges the :class:`~repro_torch.core.timeout.
  ThetaTuner` uses for its slack CDFs, so a registry histogram and a tuner
  site histogram over the same stream are bucket-compatible.

Two bus-facing consumers sit on top:

* :class:`BusMetrics` — an :class:`~repro_torch.core.events.EventBus` subscriber.
  The streamed-event path is the runtime's hottest loop, so ``on_event``
  is one dict increment (per-phase event counts); fully-formed
  :class:`~repro_torch.core.events.PhaseRecord` phases additionally land their
  slack/copy durations in histograms using *the same clamp and addition
  order as the governor's accumulators* — ``sum(slack histogram)`` equals
  ``GovernorReport.total_slack`` bit-for-bit over any phase-record stream
  (property-tested in ``tests/test_obs.py``).
* :class:`GovernorCollector` — polls ``Governor.interval_snapshot()`` into
  counters/gauges (slack/copy/overlap/energy/downshifts per interval,
  cumulative totals), publishes the straggler detector and theta tuner
  state, and exposes the exact end-of-run ``GovernorReport`` for the JSONL
  snapshot writer.

The registry itself stays numpy-light (``bisect`` on the hot path) and
jax-free, like :mod:`repro_torch.core.events`, so host-side tooling can import
it for pennies.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.events import PhaseRecord

# the ThetaTuner's slack binning (timeout.py): log-spaced 1 us .. 30 s
DEFAULT_EDGES: Tuple[float, ...] = tuple(
    math.exp(math.log(1e-6) + i * (math.log(30.0) - math.log(1e-6)) / 96)
    for i in range(97)
)


class _Child:
    """One (instrument, label values) cell; the hot-path handle."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def set(self, v: float) -> None:
        self.value = float(v)


class _HistChild:
    """Histogram cell: fixed buckets + streaming sum/count.

    ``observe`` clamps negatives to zero exactly as the governor's
    accumulator does (``slack < 0 -> 0.0``) and accumulates ``sum`` by
    plain float addition in observation order — the two properties that
    make registry totals comparable ``==`` against governor totals.
    """

    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: Sequence[float]):
        self.edges = tuple(edges)
        self.counts = [0] * (len(self.edges) - 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        if v < 0.0:
            v = 0.0
        i = bisect.bisect_right(self.edges, v) - 1
        if i < 0:
            i = 0
        elif i >= len(self.counts):
            i = len(self.counts) - 1
        self.counts[i] += 1
        self.sum += v
        self.count += 1


class _Family:
    """One named instrument with 0+ labeled children."""

    __slots__ = ("name", "kind", "help", "label_names", "_children", "_edges")

    def __init__(self, name: str, kind: str, help: str,
                 label_names: Tuple[str, ...],
                 edges: Optional[Sequence[float]] = None):
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = label_names
        self._children: Dict[Tuple[str, ...], Any] = {}
        self._edges = tuple(edges) if edges is not None else None

    def labels(self, *values: Any) -> Any:
        """The child for one label-value tuple (created on first access;
        values are stringified so ``labels(3)`` and ``labels("3")`` are one
        cell).  Hot paths resolve the child once and keep the handle."""
        key = tuple(str(v) for v in values)
        if len(key) != len(self.label_names):
            raise ValueError(
                f"{self.name}: got {len(key)} label values for "
                f"label names {self.label_names}"
            )
        child = self._children.get(key)
        if child is None:
            child = (_HistChild(self._edges or DEFAULT_EDGES)
                     if self.kind == "histogram" else _Child())
            self._children[key] = child
        return child

    # unlabeled conveniences -------------------------------------------------
    def inc(self, v: float = 1.0) -> None:
        self.labels().inc(v)

    def set(self, v: float) -> None:
        self.labels().set(v)

    def observe(self, v: float) -> None:
        self.labels().observe(v)

    def children(self) -> List[Tuple[Tuple[str, ...], Any]]:
        return sorted(self._children.items())


class MetricsRegistry:
    """Named instruments + pre-snapshot collector hooks.

    ``counter``/``gauge``/``histogram`` are get-or-create and type-checked:
    re-registering a name with a different kind or label set is a bug, not
    a silent second family.  ``add_collector`` registers a zero-arg hook
    run at the top of :meth:`snapshot` — pull-model sources (governor
    polls, SLO trackers) sync themselves there instead of paying per-event.
    """

    def __init__(self) -> None:
        self._families: Dict[str, _Family] = {}
        self._collectors: List[Callable[[], None]] = []
        self._lock = threading.Lock()

    def _get(self, name: str, kind: str, help: str,
             label_names: Sequence[str],
             edges: Optional[Sequence[float]] = None) -> _Family:
        label_names = tuple(label_names)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help, label_names, edges)
                self._families[name] = fam
            elif fam.kind != kind or fam.label_names != label_names:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind} with "
                    f"labels {fam.label_names}; got {kind} / {label_names}"
                )
            return fam

    def counter(self, name: str, help: str = "",
                label_names: Sequence[str] = ()) -> _Family:
        return self._get(name, "counter", help, label_names)

    def gauge(self, name: str, help: str = "",
              label_names: Sequence[str] = ()) -> _Family:
        return self._get(name, "gauge", help, label_names)

    def histogram(self, name: str, help: str = "",
                  label_names: Sequence[str] = (),
                  edges: Optional[Sequence[float]] = None) -> _Family:
        return self._get(name, "histogram", help, label_names, edges)

    def add_collector(self, fn: Callable[[], None]) -> Callable[[], None]:
        self._collectors.append(fn)
        return fn

    def families(self) -> List[_Family]:
        return [self._families[k] for k in sorted(self._families)]

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready view of every family (collector hooks run first)."""
        for fn in self._collectors:
            fn()
        out: Dict[str, Any] = {}
        for fam in self.families():
            values = []
            for key, child in fam.children():
                labels = dict(zip(fam.label_names, key))
                if fam.kind == "histogram":
                    values.append({"labels": labels, "sum": child.sum,
                                   "count": child.count,
                                   "buckets": list(child.counts)})
                else:
                    values.append({"labels": labels, "value": child.value})
            out[fam.name] = {"kind": fam.kind, "help": fam.help,
                             "values": values}
        return out

    def get_value(self, name: str, *label_values: Any) -> Optional[float]:
        """Convenience read (dashboards): the scalar value of one cell, or
        ``None`` if the family/cell does not exist."""
        fam = self._families.get(name)
        if fam is None:
            return None
        key = tuple(str(v) for v in label_values)
        child = fam._children.get(key)
        if child is None:
            return None
        return child.sum if fam.kind == "histogram" else child.value


class BusMetrics:
    """Per-phase event counts + phase-duration histograms.

    Two attachment modes — pick exactly one per instance or events double-
    count:

    * **Governor tap** (production drivers): hang it off the governor via
      :class:`~repro_torch.obs.tracer.GovernorTap` — ``on_retired`` reconstructs
      exact event counts from each retired occurrence (one call per
      occurrence, not per event: this is the wiring the 10% bench budget
      is measured on) and ``on_phase`` books ingested phases.
    * **Bus subscriber** (probes, tests, phase-record streams):
      ``on_event`` is one dict increment per streamed event — cheap, but a
      Python call per event, which the telemetry budget does not cover.

    Registry sync happens in the collector hook either way."""

    def __init__(self, registry: MetricsRegistry, rank_label: bool = False):
        self.registry = registry
        self._ev_counts: Dict[str, int] = {}
        self._ev_family = registry.counter(
            "bus_events_total", "streamed phase events seen on the bus",
            ("phase",))
        self._phases = registry.counter(
            "bus_phase_records_total", "fully-formed phase records seen")
        self._slack_hist = registry.histogram(
            "phase_slack_seconds", "slack durations of fully-formed phases")
        self._copy_hist = registry.histogram(
            "phase_copy_seconds", "copy durations of fully-formed phases")
        # pre-resolved unlabeled children: the on_phase path is per-record,
        # not per-event, but still should not pay dict lookups
        self._phases_c = self._phases.labels()
        self._slack_c = self._slack_hist.labels()
        self._copy_c = self._copy_hist.labels()
        registry.add_collector(self._sync)

    # hot path -------------------------------------------------------------
    def on_event(self, rank: int, phase: str, call_id: int, t: float) -> None:
        c = self._ev_counts
        c[phase] = c.get(phase, 0) + 1

    def on_phase(self, record: PhaseRecord) -> None:
        self._phases_c.inc()
        # identical clamp + addition order to Governor._accumulate, so the
        # histogram sums compare == against the governor's accumulators
        self._slack_c.observe(record.t_slack_end - record.t_enter)
        self._copy_c.observe(record.t_copy_end - record.t_slack_end)

    def on_retired(self, rec) -> None:
        """Event counts from one retired :class:`~repro_torch.core.governor.
        CallRecord` (the :class:`~repro_torch.obs.tracer.GovernorTap` wiring):
        each rank's raw events are reconstructed exactly from the record —
        a rank present in both ``dispatch`` and ``enter`` arrived via
        ``dispatch_enter``+``wait_enter``, not ``barrier_enter``.  Costs
        one call per *occurrence* instead of one per event, which is how
        the attached stack stays inside the 10% budget; counts for
        still-in-flight occurrences book at their retirement."""
        c = self._ev_counts
        n_enter = len(rec.enter)
        n_disp = len(rec.dispatch)
        if n_disp:
            enter = rec.enter
            n_wait = sum(1 for r in rec.dispatch if r in enter)
            c["dispatch_enter"] = c.get("dispatch_enter", 0) + n_disp
            if n_wait:
                c["wait_enter"] = c.get("wait_enter", 0) + n_wait
            n_enter -= n_wait
        if n_enter:
            c["barrier_enter"] = c.get("barrier_enter", 0) + n_enter
        if rec.slack_end:
            c["barrier_exit"] = c.get("barrier_exit", 0) + len(rec.slack_end)
        if rec.copy_end:
            c["copy_exit"] = c.get("copy_exit", 0) + len(rec.copy_end)

    def on_retired_batch(self, block) -> None:
        """Event counts from one :class:`~repro_torch.core.governor.RetiredBlock`
        — the batched-ingest analogue of :meth:`on_retired`, identical
        totals (the equivalence suite compares them), one call per *chunk*
        of retirements instead of one per occurrence.  Pure column math:
        the block's enter rows carry a NaN-free dispatch join time exactly
        when the rank arrived via ``dispatch_enter``+``wait_enter``."""
        c = self._ev_counts
        n_enter = int(block.row_rid.shape[0])
        # row_td == row_td is the no-numpy-import NaN test
        n_wait = int((block.row_td == block.row_td).sum()) if n_enter else 0
        n_disp = int(block.class_counts("dispatch").sum())
        n_slack = int(block.class_counts("slack").sum())
        n_copy = int(block.class_counts("copy").sum())
        if n_disp:
            c["dispatch_enter"] = c.get("dispatch_enter", 0) + n_disp
        if n_wait:
            c["wait_enter"] = c.get("wait_enter", 0) + n_wait
        n_enter -= n_wait
        if n_enter:
            c["barrier_enter"] = c.get("barrier_enter", 0) + n_enter
        if n_slack:
            c["barrier_exit"] = c.get("barrier_exit", 0) + n_slack
        if n_copy:
            c["copy_exit"] = c.get("copy_exit", 0) + n_copy

    # cold path ------------------------------------------------------------
    def _sync(self) -> None:
        """Move the cheap per-phase tallies into registry counters (counters
        are monotone: we add the delta since the last sync)."""
        for phase, n in self._ev_counts.items():
            child = self._ev_family.labels(phase)
            delta = n - child.value
            if delta:
                child.inc(delta)


class IngestMetrics:
    """Batched-ingest health: the :class:`~repro_torch.core.events.EventBus`
    ingest counters rendered as registry instruments, plus an events/sec
    rate gauge over the sync-to-sync window — the dashboard's "is the
    telemetry spine keeping up" panel (events/s, mean batch occupancy,
    drain-queue depth).

    Pull-model like :class:`GovernorCollector`: one ``ingest_stats()``
    read per registry snapshot, zero cost on the publish path."""

    def __init__(self, registry: MetricsRegistry, bus,
                 time_fn: Optional[Callable[[], float]] = None):
        import time as _time

        self.registry = registry
        self.bus = bus
        self._now = time_fn or _time.monotonic
        self._events = registry.counter(
            "ingest_events_total", "events published through the bus")
        self._batches = registry.counter(
            "ingest_batches_total", "columnar chunks published")
        self._fallback = registry.counter(
            "ingest_fallback_events_total",
            "events delivered via the per-event legacy-subscriber loop")
        self._occupancy = registry.gauge(
            "ingest_batch_occupancy", "mean fill fraction of published chunks")
        self._rate = registry.gauge(
            "ingest_events_per_second", "bus event throughput, last window")
        self._queue = registry.gauge(
            "ingest_queue_depth", "chunks waiting for a drain()")
        self._queued_ev = registry.gauge(
            "ingest_queued_events", "events inside queued chunks")
        self._last_t: Optional[float] = None
        self._last_events = 0
        registry.add_collector(self.collect)

    def collect(self) -> dict:
        st = self.bus.ingest_stats()
        now = self._now()
        ev = st["events_total"]
        if self._last_t is not None:
            dt = now - self._last_t
            if dt > 0:
                self._rate.set((ev - self._last_events) / dt)
        self._last_t = now
        self._last_events = ev
        # counters are monotone: book the delta since the last sync
        for fam, key in ((self._events, "events_total"),
                         (self._batches, "batches_total"),
                         (self._fallback, "fallback_events_total")):
            child = fam.labels()
            delta = st[key] - child.value
            if delta:
                child.inc(delta)
        self._occupancy.set(st["mean_occupancy"])
        self._queue.set(st["queue_depth"])
        self._queued_ev.set(st["queued_events"])
        return st


class GovernorCollector:
    """Pull-model governor telemetry: snapshot polls into the registry,
    straggler/tuner state as gauges, and the exact cumulative report.

    ``collect()`` is the per-interval poll (driver report cadence, or the
    registry's own snapshot hook); ``report()`` is the end-of-run /
    per-snapshot exact ``GovernorReport`` — ``finalize()`` is O(in-flight)
    and non-destructive, so calling it per JSONL snapshot is free and
    guarantees the written cumulative slack/copy/overlap/energy match
    ``GovernorReport.to_dict()`` bit-for-bit.
    """

    def __init__(self, registry: MetricsRegistry, governor,
                 auto_collect: bool = True):
        self.registry = registry
        self.governor = governor
        g = registry
        self._slack = g.counter("governor_slack_seconds_total",
                                "slack booked by the governor")
        self._copy = g.counter("governor_copy_seconds_total",
                               "copy booked by the governor")
        self._overlap = g.counter("governor_overlap_seconds_total",
                                  "dispatch->wait overlap booked non-slack")
        self._exploited = g.counter("governor_exploited_seconds_total",
                                    "slack spent at f_min")
        self._e_base = g.counter("governor_energy_baseline_joules_total",
                                 "baseline energy during instrumented phases")
        self._e_pol = g.counter("governor_energy_policy_joules_total",
                                "energy under the policy's P-state trajectory")
        self._calls = g.counter("governor_calls_total", "phases retired")
        self._downs = g.counter("governor_downshifts_total",
                                "timeout-armed downshifts")
        self._acts = g.gauge("governor_actuations", "P-state commands booked")
        self._slack_ratio = g.gauge("governor_interval_slack_ratio",
                                    "slack / busy over the last interval")
        self._overlap_ratio = g.gauge("governor_interval_overlap_ratio",
                                      "overlap / busy over the last interval")
        self._expl_ratio = g.gauge("governor_interval_exploited_ratio",
                                   "exploited / busy over the last interval")
        self._saving = g.gauge("governor_energy_saving_pct",
                               "cumulative energy saving vs baseline")
        self._theta = g.gauge("governor_theta_seconds",
                              "tuner theta per site", ("site",))
        self._late = g.gauge("straggler_mean_lateness_seconds",
                             "per-rank mean barrier lateness", ("rank",))
        self._strag = g.gauge("straggler_z_score",
                              "z-score of flagged straggler ranks", ("rank",))
        if auto_collect:
            registry.add_collector(self.collect)

    def collect(self):
        """Poll one interval; returns the :class:`~repro_torch.core.governor.
        IntervalStats` so drivers can reuse the poll they already make."""
        gov = self.governor
        stats = gov.interval_snapshot()
        self._slack.inc(stats.slack)
        self._copy.inc(stats.copy)
        self._overlap.inc(stats.overlap)
        self._exploited.inc(stats.exploited)
        self._e_base.inc(stats.energy_baseline)
        self._e_pol.inc(stats.energy_policy)
        self._calls.inc(stats.n_calls)
        self._downs.inc(stats.n_downshifts)
        self._acts.set(gov.n_actuations)
        busy = stats.busy
        self._slack_ratio.set(stats.slack / busy if busy > 0 else 0.0)
        self._overlap_ratio.set(stats.overlap_ratio)
        self._expl_ratio.set(stats.exploited_ratio)
        base = self._e_base.labels().value
        pol = self._e_pol.labels().value
        self._saving.set(100.0 * (1.0 - max(pol, 0.0) / base) if base > 0 else 0.0)
        if gov.tuner is not None:
            for site, theta in gov.tuner.summary().items():
                self._theta.labels(site).set(theta)
        detector = getattr(gov, "detector", None)
        if detector is not None:
            detector.export_metrics(self.registry)
        return stats

    def report(self):
        """The exact cumulative :class:`~repro_torch.core.governor.GovernorReport`."""
        return self.governor.finalize()
