"""Periodic sinks for the metrics registry: JSONL snapshots, Prometheus
text exposition, and the ``--dashboard`` console renderer.

All three are *pull* consumers of :class:`~repro_torch.obs.metrics.
MetricsRegistry` — they cost nothing until a driver's report cadence asks
for a snapshot, keeping the telemetry overhead budget (bench-guarded at
10%) entirely on the event-bus side.

* :class:`MetricsJsonlWriter` — one JSON object per line, each embedding
  the full registry snapshot and (when a
  :class:`~repro_torch.obs.metrics.GovernorCollector` is attached) the *exact*
  cumulative ``GovernorReport.to_dict()`` — the acceptance contract is
  that the last line's report equals the driver's end-of-run report
  bit-for-bit.
* :func:`prometheus_text` — the standard text exposition format, so a
  scrape endpoint (or a file_sd textfile collector) is one call away.
* :class:`ConsoleDashboard` — a compact fixed-layout block re-rendered at
  the driver's report cadence: slack/overlap/exploited ratios, energy
  saved, theta per site, serve TTFT/TPOT percentiles, fleet membership /
  routing / arbiter grants, watts vs cap.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, List, Optional, TextIO, Tuple

from repro_torch.obs.metrics import MetricsRegistry


# --------------------------------------------------------------------------
# JSONL snapshots
# --------------------------------------------------------------------------
class MetricsJsonlWriter:
    """Append one registry snapshot per :meth:`write` to a JSONL file.

    Each line: ``{"t", "step", "metrics", "report"?}`` where ``metrics`` is
    ``registry.snapshot()`` and ``report`` (when a governor collector is
    wired) is the exact cumulative ``GovernorReport.to_dict()``.
    """

    def __init__(self, path: str, registry: MetricsRegistry, collector=None):
        self.path = path
        self.registry = registry
        self.collector = collector
        self._f = open(path, "w")
        self.n_lines = 0

    def write(self, step: Optional[int] = None,
              t: Optional[float] = None) -> Dict[str, Any]:
        rec: Dict[str, Any] = {"t": time.time() if t is None else t,
                               "step": step,
                               "metrics": self.registry.snapshot()}
        if self.collector is not None:
            rec["report"] = self.collector.report().to_dict()
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        self.n_lines += 1
        return rec

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "MetricsJsonlWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def validate_metrics_jsonl(path: str) -> List[str]:
    """Schema-check a snapshot file (CI smoke): every line parses, carries
    the snapshot envelope, and any embedded report has the GovernorReport
    keys.  Returns the list of problems (empty = valid)."""
    problems: List[str] = []
    report_keys = {"n_calls", "total_slack", "total_copy", "total_overlap",
                   "energy_baseline", "energy_policy", "energy_saving_pct"}
    n = 0
    with open(path) as f:
        for i, line in enumerate(f):
            if not line.strip():
                continue
            n += 1
            try:
                rec = json.loads(line)
            except ValueError as e:
                problems.append(f"line {i}: not JSON ({e})")
                continue
            if "t" not in rec or "metrics" not in rec:
                problems.append(f"line {i}: missing t/metrics envelope")
                continue
            if not isinstance(rec["metrics"], dict):
                problems.append(f"line {i}: metrics is not an object")
            for fam, body in rec.get("metrics", {}).items():
                if not isinstance(body, dict) or "kind" not in body \
                        or "values" not in body:
                    problems.append(f"line {i}: family {fam!r} malformed")
            if "report" in rec:
                missing = report_keys - set(rec["report"])
                if missing:
                    problems.append(f"line {i}: report missing {sorted(missing)}")
    if n == 0:
        problems.append("no snapshot lines")
    return problems


# --------------------------------------------------------------------------
# Prometheus text exposition
# --------------------------------------------------------------------------
def _label_str(labels: Dict[str, str], extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    items = list(labels.items()) + list(extra)
    if not items:
        return ""
    body = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in items)
    return "{%s}" % body


def prometheus_text(registry: MetricsRegistry) -> str:
    """Render the registry in the Prometheus text exposition format
    (counters/gauges as-is; histograms as cumulative ``_bucket`` series
    plus ``_sum``/``_count``).  Deterministic: families and children are
    emitted sorted."""
    snap = registry.snapshot()
    lines: List[str] = []
    for name in sorted(snap):
        body = snap[name]
        kind = body["kind"]
        if body["help"]:
            lines.append(f"# HELP {name} {body['help']}")
        lines.append(f"# TYPE {name} {kind}")
        for cell in body["values"]:
            labels = cell["labels"]
            if kind == "histogram":
                fam = registry._families[name]
                edges = None
                for key, child in fam.children():
                    if dict(zip(fam.label_names, key)) == labels:
                        edges = child.edges
                        break
                cum = 0
                if edges is not None:
                    for j, c in enumerate(cell["buckets"]):
                        cum += c
                        le = "%g" % edges[j + 1]
                        lines.append(f"{name}_bucket"
                                     f"{_label_str(labels, (('le', le),))} {cum}")
                lines.append(f"{name}_bucket"
                             f"{_label_str(labels, (('le', '+Inf'),))} "
                             f"{cell['count']}")
                lines.append(f"{name}_sum{_label_str(labels)} {cell['sum']!r}")
                lines.append(f"{name}_count{_label_str(labels)} {cell['count']}")
            else:
                lines.append(f"{name}{_label_str(labels)} {cell['value']!r}")
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------
# console dashboard
# --------------------------------------------------------------------------
def _labeled(registry: MetricsRegistry, name: str) -> List[Tuple[Dict[str, str], float]]:
    fam = registry._families.get(name)
    if fam is None:
        return []
    out = []
    for key, child in fam.children():
        value = child.sum if fam.kind == "histogram" else child.value
        out.append((dict(zip(fam.label_names, key)), value))
    return out


class ConsoleDashboard:
    """Fixed-layout run dashboard re-rendered at the report cadence.

    Reads only the registry (plus whatever collectors sync into it), so the
    same renderer serves train (governor ratios, theta, watts vs cap) and
    serve (TTFT/TPOT percentiles) — rows for absent metrics are dropped.
    """

    def __init__(self, registry: MetricsRegistry, title: str = "run",
                 stream: Optional[TextIO] = None):
        self.registry = registry
        self.title = title
        self.stream = stream
        self.n_renders = 0

    # -- row builders ------------------------------------------------------
    def _governor_rows(self) -> List[str]:
        g = self.registry.get_value
        slack = g("governor_interval_slack_ratio")
        if slack is None:
            return []
        overlap = g("governor_interval_overlap_ratio") or 0.0
        expl = g("governor_interval_exploited_ratio") or 0.0
        saving = g("governor_energy_saving_pct") or 0.0
        calls = g("governor_calls_total") or 0.0
        downs = g("governor_downshifts_total") or 0.0
        rows = [
            f"  slack {100.0 * slack:5.1f}%   overlap {100.0 * overlap:5.1f}%"
            f"   exploited {100.0 * expl:5.1f}%",
            f"  energy saved {saving:5.2f}%   calls {int(calls)}"
            f"   downshifts {int(downs)}",
        ]
        thetas = _labeled(self.registry, "governor_theta_seconds")
        if thetas:
            cells = "  ".join(
                f"{lab.get('site', '?')}:{1e6 * v:.0f}us"
                for lab, v in thetas[:6])
            more = f" (+{len(thetas) - 6})" if len(thetas) > 6 else ""
            rows.append(f"  theta {cells}{more}")
        return rows

    def _serve_rows(self) -> List[str]:
        rows = []
        for metric, label in (("serve_ttft_seconds", "ttft"),
                              ("serve_tpot_seconds", "tpot")):
            cells = {lab.get("q"): v for lab, v in
                     _labeled(self.registry, metric)}
            if cells:
                rows.append(
                    f"  {label} p50 {1e3 * cells.get('p50', 0.0):7.1f}ms"
                    f"   p99 {1e3 * cells.get('p99', 0.0):7.1f}ms")
        done = self.registry.get_value("serve_completed_total")
        if done is not None:
            rows.append(f"  completed {int(done)}")
        return rows

    def _ingest_rows(self) -> List[str]:
        g = self.registry.get_value
        total = g("ingest_events_total")
        if total is None:
            return []
        rate = g("ingest_events_per_second") or 0.0
        occ = g("ingest_batch_occupancy") or 0.0
        depth = g("ingest_queue_depth") or 0.0
        fallback = g("ingest_fallback_events_total") or 0.0
        row = (f"  ingest {rate / 1e6:6.2f}M ev/s   occupancy "
               f"{100.0 * occ:5.1f}%   queue {int(depth)}")
        if fallback:
            row += f"   fallback {int(fallback)}"
        return [row]

    def _fleet_rows(self) -> List[str]:
        g = self.registry.get_value
        replicas = g("fleet_replicas")
        if replicas is None:
            return []
        rows = [f"  fleet {int(replicas)} replicas"]
        hit = g("fleet_prefix_hit_rate")
        routed = g("fleet_router_decisions")
        pref = g("fleet_router_prefix_routed")
        if routed is not None:
            frac = (pref or 0.0) / max(routed, 1.0)
            rows[0] += (f"   routed {int(routed)}"
                        f" ({100.0 * frac:.0f}% by prefix)")
        if hit is not None:
            rows[0] += f"   prefix hit {100.0 * hit:5.1f}%"
        ups, downs = g("fleet_scale_ups"), g("fleet_scale_downs")
        energy = g("fleet_energy_joules")
        if ups is not None or energy is not None:
            row = "  "
            if ups is not None:
                row += f"scale +{int(ups)}/-{int(downs or 0)}"
            if energy is not None:
                row += f"   energy {energy:8.1f}J"
            rows.append(row)
        cap = g("arbiter_cap_watts")
        if cap is not None:
            pool = g("arbiter_pool_watts") or 0.0
            rows.append(f"  arbiter cap {cap:.0f}W   granted "
                        f"{cap - pool:.1f}W   pool {pool:.1f}W")
        return rows

    def _power_rows(self) -> List[str]:
        caps = {lab.get("job"): v for lab, v in
                _labeled(self.registry, "job_cap_watts")}
        watts = {lab.get("job"): v for lab, v in
                 _labeled(self.registry, "job_power_watts")}
        rows = []
        for job in sorted(set(caps) | set(watts)):
            w, c = watts.get(job, 0.0), caps.get(job)
            cap_s = f"/{c:.0f}W cap" if c is not None else ""
            rows.append(f"  power[{job}] {w:7.1f}W{cap_s}")
        return rows

    def render(self, step: Optional[int] = None) -> str:
        head = f"== {self.title}"
        if step is not None:
            head += f" · step {step}"
        head += " =="
        rows = ([head] + self._governor_rows() + self._ingest_rows()
                + self._serve_rows() + self._fleet_rows()
                + self._power_rows())
        return "\n".join(rows)

    def tick(self, step: Optional[int] = None) -> str:
        """Render and print one dashboard frame; returns the frame."""
        frame = self.render(step)
        stream = self.stream or sys.stdout
        stream.write(frame + "\n")
        stream.flush()
        self.n_renders += 1
        return frame
