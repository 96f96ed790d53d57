"""Online straggler detection from barrier-arrival events.

The paper's post-hoc critical-rank analysis (§5) observes that in slack-rich
applications the *same* ranks keep arriving last — the application has a
persistent critical path.  This module makes that analysis online: the
governor feeds every reconstructed barrier's per-rank enter times into
:class:`StragglerDetector`, which accumulates each rank's mean arrival
lateness and flags ranks whose lateness is a statistical outlier across the
fleet.  On a real cluster the flagged ranks are the ones a scheduler should
migrate (or the only ranks that must *not* be downshifted — they carry the
critical path, see DESIGN.md §2).

Lateness is measured relative to the per-barrier mean arrival time, so the
detector is invariant to the absolute epoch of each barrier and to drift in
the global step rate.  The outlier test is a z-score over per-rank mean
lateness; with one extreme laggard among ``n`` ranks the laggard's z-score
approaches ``sqrt(n - 1)``, so the default threshold of 2.0 resolves a
single straggler for fleets of 6+ ranks while staying quiet on balanced
arrival noise.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


class StragglerDetector:
    """Accumulates per-rank barrier lateness; flags statistical laggards.

    Args:
      min_samples: a rank needs at least this many observed barriers before
        it can be flagged (guards against cold-start noise).
      z_threshold: per-rank mean-lateness z-score above which a rank is
        reported by :meth:`stragglers`.
    """

    def __init__(self, min_samples: int = 5, z_threshold: float = 2.0):
        self.min_samples = min_samples
        self.z_threshold = z_threshold
        self._late_sum: Dict[int, float] = {}
        self._count: Dict[int, int] = {}
        self.n_barriers = 0

    def observe_barrier(self, arrivals: Dict[int, float]) -> None:
        """Record one barrier: ``arrivals`` maps rank -> arrival time (s).

        The last arriver (largest t) is the barrier's critical rank; every
        rank's lateness is its arrival relative to the barrier mean.
        """
        n = len(arrivals)
        if n < 2:
            return
        mean_t = sum(arrivals.values()) / n
        late_sum, count = self._late_sum, self._count
        for rank, t in arrivals.items():
            late_sum[rank] = late_sum.get(rank, 0.0) + (t - mean_t)
            count[rank] = count.get(rank, 0) + 1
        self.n_barriers += 1

    def observe_barriers_cols(self, ranks: np.ndarray, ts: np.ndarray,
                              offsets: np.ndarray) -> None:
        """Record many barriers at once from columnar arrival rows (the
        governor's batched ingest path).

        ``ranks``/``ts`` hold the arrival rows of ``len(offsets) - 1``
        barriers back to back — barrier ``i`` is ``offsets[i]:offsets[i+1]``,
        rows in the per-barrier insertion order the per-event dict walk
        would have used.  Detector state afterwards is bit-for-bit what the
        equivalent :meth:`observe_barrier` sequence leaves: per-barrier
        means and per-rank lateness sums are folded as strictly sequential
        left-to-right chains (same-length chains fold column by column —
        elementwise float64 adds are the scalar adds), never pairwise
        reductions.  Every barrier must have >= 2 arrivals; the caller
        filters (:meth:`observe_barrier` drops them silently, so passing
        one here would desynchronize ``n_barriers``).
        """
        nb = int(offsets.shape[0]) - 1
        if nb <= 0:
            return
        sizes = np.diff(offsets)
        if int(sizes.min()) < 2:
            raise ValueError("observe_barriers_cols: every barrier needs "
                             ">= 2 arrivals (caller must filter)")
        starts = offsets[:-1]
        means = np.empty(nb)
        for k in np.unique(sizes).tolist():
            gm = sizes == k
            idx = starts[gm][:, None] + np.arange(k)
            # ufunc.accumulate is a strictly sequential left fold, so one
            # accumulate per row == the 0.0-seeded scalar add chain
            rows = np.empty((int(np.count_nonzero(gm)), k + 1))
            rows[:, 0] = 0.0
            rows[:, 1:] = ts[idx]
            means[gm] = np.add.accumulate(rows, axis=1)[:, -1] / k
        dev = ts - np.repeat(means, sizes)
        # per-rank lateness chains, in global row order (the stable sort
        # keeps each rank's rows in barrier-processing order); rank ids
        # are small, so narrowing the sort key cuts radix passes
        rmax = int(ranks.max())
        if 0 <= int(ranks.min()) and rmax < 256:
            o = ranks.astype(np.uint8).argsort(kind="stable")
        elif rmax < 2 ** 15 and int(ranks.min()) >= 0:
            o = ranks.astype(np.int16).argsort(kind="stable")
        else:
            o = np.argsort(ranks, kind="stable")
        r_s = ranks[o]
        d_s = dev[o]
        n_rows = r_s.shape[0]
        run_start = np.empty(n_rows, dtype=bool)
        run_start[0] = True
        np.not_equal(r_s[1:], r_s[:-1], out=run_start[1:])
        run_lo = np.nonzero(run_start)[0]
        run_hi = np.append(run_lo[1:], n_rows)
        ur_l = r_s[run_lo].tolist()
        late_sum, count = self._late_sum, self._count
        seeds = np.empty(len(ur_l))
        # dict insertion order is observable (summary(), straggler
        # tie-breaks): pin new ranks in global first-appearance order
        counts_l = (run_hi - run_lo).tolist()
        for oi in np.argsort(o[run_lo], kind="stable").tolist():
            r = ur_l[oi]
            seeds[oi] = late_sum.get(r, 0.0)
            count[r] = count.get(r, 0) + counts_l[oi]
            late_sum.setdefault(r, 0.0)
        counts_r = run_hi - run_lo
        vals = np.empty(len(ur_l))
        for k in np.unique(counts_r).tolist():
            gm = counts_r == k
            idx = run_lo[gm][:, None] + np.arange(k)
            rows = np.empty((int(np.count_nonzero(gm)), k + 1))
            rows[:, 0] = seeds[gm]
            rows[:, 1:] = d_s[idx]
            vals[gm] = np.add.accumulate(rows, axis=1)[:, -1]
        for r, v in zip(ur_l, vals.tolist()):
            late_sum[r] = v
        self.n_barriers += nb

    def summary(self) -> Dict[int, float]:
        """rank -> mean lateness (s; positive = habitually late)."""
        return {
            r: self._late_sum[r] / c for r, c in self._count.items() if c > 0
        }

    def stragglers(self) -> List[Tuple[int, float]]:
        """Ranks whose mean lateness is a z-score outlier, worst first.

        Returns ``[(rank, z_score), ...]`` for ranks with at least
        ``min_samples`` observations and ``z >= z_threshold``.
        """
        eligible = {
            r: s for r, s in self.summary().items()
            if self._count[r] >= self.min_samples
        }
        if len(eligible) < 3:
            return []          # z-scores are meaningless on <3 ranks
        vals = np.asarray(list(eligible.values()), dtype=np.float64)
        mu, sd = float(vals.mean()), float(vals.std())
        if sd <= 0.0:
            return []
        out = [
            (r, (s - mu) / sd)
            for r, s in eligible.items()
            if (s - mu) / sd >= self.z_threshold
        ]
        out.sort(key=lambda rz: -rz[1])
        return out

    def export_metrics(self, registry) -> None:
        """Publish detector state into a :class:`repro_torch.obs.metrics.
        MetricsRegistry`: mean lateness per rank, plus the z-score of every
        currently-flagged straggler (ranks no longer flagged drop to 0 so a
        dashboard shows recovery, not a stale alarm)."""
        late = registry.gauge("straggler_mean_lateness_seconds",
                              "per-rank mean barrier lateness", ("rank",))
        zscore = registry.gauge("straggler_z_score",
                                "z-score of flagged straggler ranks", ("rank",))
        for rank, mean in self.summary().items():
            late.labels(rank).set(mean)
        flagged = dict(self.stragglers())
        for rank in self._count:
            zscore.labels(rank).set(flagged.get(rank, 0.0))

    def reset(self) -> None:
        self._late_sum.clear()
        self._count.clear()
        self.n_barriers = 0
