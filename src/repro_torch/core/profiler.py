"""Profiler module (paper §4.4): event profiler + time-based profiler +
hierarchical report.

* ``EventProfiler`` — per-MPI-call records (site, rank, durations, bytes),
  the analogue of the RDPMC fixed-counter path.  Sources: the simulator's
  ``TraceRecord``, or a live run via ``on_phase`` — the profiler is an
  :class:`~repro_torch.core.events.EventBus` subscriber, so
  ``bus.subscribe(profiler)`` folds every fully-formed
  :class:`~repro_torch.core.events.PhaseRecord` the governor reconstructs into
  the same per-site statistics.
* ``TimeProfiler``  — a sampling thread (default 1 s) that snapshots
  host-wide counters (process CPU time, wall time, rss), the analogue of the
  MSR_SAFE batch-mode node sampler.
* ``hierarchical_report`` — summary / per-MPI / per-node / per-socket /
  per-core JSON, mirroring the paper's report layout.
"""
from __future__ import annotations

import json
import os
import resource
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.events import PhaseRecord
from repro_torch.core.simulator import TraceRecord

UNSITED = -1        # site bucket for phase records with no call-site tag


class EventProfiler:
    """Accumulates per-call events into per-site statistics."""

    def __init__(self):
        self.sites: Dict[int, Dict[str, float]] = defaultdict(
            lambda: {"calls": 0, "tslack": 0.0, "tcopy": 0.0, "bytes": 0.0}
        )
        self.per_rank_slack: Dict[int, float] = defaultdict(float)

    def record_call(self, site: int, rank: int, slack: float, copy: float, nbytes: float):
        s = self.sites[site]
        s["calls"] += 1
        s["tslack"] += slack
        s["tcopy"] += copy
        s["bytes"] += nbytes
        self.per_rank_slack[rank] += slack

    def on_phase(self, record: PhaseRecord) -> None:
        """EventBus subscription: fold one reconstructed phase.  Byte counts
        are not observable from the event stream (the instrument never sees
        payload sizes), so ``bytes`` stays 0 for live-sourced sites."""
        self.record_call(
            UNSITED if record.site is None else int(record.site),
            record.rank,
            max(record.t_slack_end - record.t_enter, 0.0),
            max(record.t_copy_end - record.t_slack_end, 0.0),
            0.0,
        )

    def ingest_trace(self, trace: TraceRecord) -> None:
        t_tasks, n = trace.slack.shape
        for k in range(t_tasks):
            site = int(trace.site[k])
            for r in range(n):
                self.record_call(
                    site, r, float(trace.slack[k, r]), float(trace.copy[k, r]),
                    float(trace.nbytes[k]),
                )

    def mpi_report(self) -> Dict[str, Any]:
        return {
            str(site): {k: round(v, 9) for k, v in stats.items()}
            for site, stats in sorted(self.sites.items())
        }


class TimeProfiler:
    """Per-interval host sampling on a daemon thread (default 1 s)."""

    def __init__(self, interval: float = 1.0):
        self.interval = interval
        self.samples: List[Dict[str, float]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            ru = resource.getrusage(resource.RUSAGE_SELF)
            self.samples.append(
                {
                    "t": time.monotonic(),
                    "cpu_user_s": ru.ru_utime,
                    "cpu_sys_s": ru.ru_stime,
                    "maxrss_kb": ru.ru_maxrss,
                }
            )
            self._stop.wait(self.interval)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


def hierarchical_report(
    event: EventProfiler,
    timep: Optional[TimeProfiler] = None,
    n_ranks: Optional[int] = None,
    ranks_per_node: int = 36,
    sockets_per_node: int = 2,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The paper's summary/MPI/node/socket/core hierarchy as one dict.

    ``n_ranks=None`` infers the fleet size from the ranks actually seen —
    the natural mode for a live-governor-fed profiler, where the caller
    has no simulator config to quote.
    """
    if n_ranks is None:
        n_ranks = (max(event.per_rank_slack) + 1) if event.per_rank_slack else 1
    total_slack = sum(event.per_rank_slack.values())
    total_copy = sum(s["tcopy"] for s in event.sites.values())
    summary = {
        "n_ranks": n_ranks,
        "n_sites": len(event.sites),
        "total_calls": int(sum(s["calls"] for s in event.sites.values())),
        "total_tslack_s": total_slack,
        "total_tcopy_s": total_copy,
    }
    if extra:
        summary.update(extra)
    nodes: Dict[str, Any] = {}
    for rank in range(n_ranks):
        node = rank // ranks_per_node
        in_node = rank % ranks_per_node
        socket = in_node // max(1, ranks_per_node // sockets_per_node)
        nd = nodes.setdefault(f"node{node}", {"tslack_s": 0.0, "sockets": {}})
        sk = nd["sockets"].setdefault(f"socket{socket}", {"tslack_s": 0.0, "cores": {}})
        slack = event.per_rank_slack.get(rank, 0.0)
        nd["tslack_s"] += slack
        sk["tslack_s"] += slack
        sk["cores"][f"core{in_node}"] = {"rank": rank, "tslack_s": slack}
    report = {"summary": summary, "mpi": event.mpi_report(), "nodes": nodes}
    if timep is not None:
        report["time_series"] = timep.samples
    return report


def write_report(report: Dict[str, Any], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
