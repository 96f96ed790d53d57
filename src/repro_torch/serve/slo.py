"""Per-request SLO tracking: TTFT / TPOT percentiles + admission feedback.

TTFT (time to first token) measures queueing + prefill; TPOT (time per
output token) measures decode-step latency as seen by one request.  The
tracker keeps raw samples, reports percentile summaries, and drives one
admission decision: when recent TPOT blows its target — the batch is too
wide for the hardware — :meth:`max_concurrency` caps how many requests
the scheduler may keep active (additive decrease), and recovers one slot
at a time once latency clears (additive increase).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def _pct(samples: List[float]) -> Dict[str, float]:
    if not samples:
        return {"n": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
    a = np.asarray(samples, dtype=np.float64)
    return {
        "n": int(a.size),
        "mean": float(a.mean()),
        "p50": float(np.percentile(a, 50)),
        "p95": float(np.percentile(a, 95)),
        "p99": float(np.percentile(a, 99)),
    }


class SLOTracker:
    """Collects TTFT/TPOT samples and throttles admission when TPOT slips."""

    def __init__(self, ttft_target: Optional[float] = None,
                 tpot_target: Optional[float] = None, window: int = 32,
                 adjust_every: int = 8):
        self.ttft_target = ttft_target
        self.tpot_target = tpot_target
        self.window = window
        self.adjust_every = adjust_every
        self.ttft: List[float] = []
        self.tpot: List[float] = []
        self.n_completed = 0
        self._limit: Optional[int] = None
        self._since_adjust = 0

    # ---- engine hooks ----------------------------------------------------
    def on_first_token(self, req, now: float) -> None:
        self.ttft.append(now - req.arrival)
        req.t_first = req.t_prev = now

    def on_token(self, req, now: float) -> None:
        if req.t_prev >= 0:
            self.tpot.append(now - req.t_prev)
            self._since_adjust += 1
        req.t_prev = now

    def on_finish(self, req, now: float) -> None:
        req.t_done = now
        self.n_completed += 1

    # ---- reporting -------------------------------------------------------
    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {"ttft": _pct(self.ttft), "tpot": _pct(self.tpot),
               "completed": self.n_completed}
        if self.ttft_target is not None:
            out["ttft"]["target"] = self.ttft_target
            out["ttft"]["violations"] = sum(t > self.ttft_target for t in self.ttft)
        if self.tpot_target is not None:
            out["tpot"]["target"] = self.tpot_target
            out["tpot"]["violations"] = sum(t > self.tpot_target for t in self.tpot)
        return out

    def export_metrics(self, registry) -> None:
        """Publish the percentile summary into a :class:`repro_torch.obs.metrics.
        MetricsRegistry` (``serve_ttft_seconds{q=...}`` and friends) — the
        dashboard and JSONL snapshot view of this tracker."""
        s = self.summary()
        for metric, name in (("ttft", "serve_ttft_seconds"),
                             ("tpot", "serve_tpot_seconds")):
            fam = registry.gauge(name, f"{metric} summary over the run", ("q",))
            for q in ("mean", "p50", "p95", "p99"):
                fam.labels(q).set(s[metric][q])
            target = s[metric].get("target")
            if target is not None:
                registry.gauge(f"serve_{metric}_target_seconds",
                               f"{metric} SLO target").set(target)
                registry.gauge(f"serve_{metric}_violations",
                               f"samples over the {metric} target").set(
                                   s[metric]["violations"])
        done = registry.counter("serve_completed_total",
                                "requests completed").labels()
        delta = s["completed"] - done.value
        if delta > 0:
            done.inc(delta)

    # ---- admission feedback ---------------------------------------------
    def max_concurrency(self, n_slots: int) -> int:
        """AIMD-style cap: shrink when recent p95 TPOT > target, regrow
        one slot at a time when it clears 70% of the target."""
        if self._limit is None:
            self._limit = n_slots
        self._limit = min(self._limit, n_slots)
        if self.tpot_target is None or self._since_adjust < self.adjust_every:
            return self._limit
        self._since_adjust = 0
        recent = self.tpot[-self.window:]
        p95 = float(np.percentile(np.asarray(recent), 95)) if recent else 0.0
        if p95 > self.tpot_target:
            self._limit = max(1, self._limit - 1)
        elif p95 < 0.7 * self.tpot_target:
            self._limit = min(n_slots, self._limit + 1)
        return self._limit
