"""Region-duration prediction: the Table 1 / Fig. 3 study + the online model.

A from-scratch numpy random-forest regressor (no sklearn in this
environment): CART trees with variance-reduction splits over quantile
candidate thresholds, bootstrap bagging, feature subsampling.  Targets are
trained in log-space (the paper found this flattens duration peaks) and
evaluated with SMAPE on the raw scale.  Feature importance uses the
permutation method (the paper explicitly prefers it over impurity
importance).

Features (paper §6.2): rank id, MPI call type, bytes received, bytes sent,
group size, locality, task id (call-site hash) — plus, in the
"with previous info" variant, the last (Tcomp, Tslack, Tcopy) of the same
(site, rank).

:class:`OnlinePredictor` is the live counterpart: the same forest,
incrementally refit on the governor's retired phase stream, with a cheap
per-(site, rank) EMA/last-value fallback while the forest is cold.  It is
what the ``cntd_predictive`` policy (repro_torch.core.timeout.PredictiveTuner)
consults to pre-arm the P-state downshift before theta expires — and, per
the paper's central claim, what the misprediction guard polices.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.simulator import TraceRecord

FEATURES_BASE = [
    "rank", "call_type", "bytes_recv", "bytes_sent", "group_size",
    "locality", "task_id",
]
FEATURES_PREV = ["prev_tcomp", "prev_tslack", "prev_tcopy"]
TARGETS = ["tcomp", "tslack", "tcopy"]


# --------------------------------------------------------------------------
# dataset construction from a simulator trace
# --------------------------------------------------------------------------

def build_dataset(
    trace: TraceRecord,
    with_prev: bool,
    ranks_per_node: int = 18,
    max_rows: int = 60_000,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Returns (X, Y[,3], feature_names).  Rows ordered rank-major then time."""
    t_tasks, n = trace.comp.shape
    rows: List[List[float]] = []
    targets: List[List[float]] = []
    last: Dict[Tuple[int, int], Tuple[float, float, float]] = {}
    coll_locality = min(1.0, ranks_per_node / n)
    for r in range(n):
        node_r = r // ranks_per_node
        for k in range(t_tasks):
            site = int(trace.site[k])
            p2p = bool(trace.is_p2p[k])
            group = 2 if p2p else n
            # locality: fraction of the group resident on this rank's node.
            # For p2p that is whether the *pair* shares a node — derived
            # from the partner's node index (the group size is constant 2,
            # so deriving it from the group would collapse the feature to a
            # constant and zero out its permutation importance)
            if p2p:
                if trace.partner is not None:
                    mate = int(trace.partner[k, r])
                    locality = 1.0 if mate // ranks_per_node == node_r else 0.5
                else:                       # legacy trace without partners
                    locality = 1.0 if n <= ranks_per_node else 0.5
            else:
                locality = coll_locality
            nbytes = float(trace.nbytes[k])
            feat = [
                float(r), 1.0 if p2p else 0.0, nbytes, nbytes,
                float(group), locality, float(site),
            ]
            tgt = [
                float(trace.comp[k, r]),
                float(trace.slack[k, r]),
                float(trace.copy[k, r]),
            ]
            if with_prev:
                prev = last.get((site, r))
                if prev is None:
                    last[(site, r)] = tuple(tgt)
                    continue                      # paper: needs history
                feat = feat + list(prev)
                last[(site, r)] = tuple(tgt)
            rows.append(feat)
            targets.append(tgt)
    x = np.asarray(rows, dtype=np.float64)
    y = np.asarray(targets, dtype=np.float64)
    if len(x) > max_rows:
        idx = np.random.default_rng(seed).choice(len(x), max_rows, replace=False)
        x, y = x[idx], y[idx]
    names = FEATURES_BASE + (FEATURES_PREV if with_prev else [])
    return x, y, names


# --------------------------------------------------------------------------
# CART regression tree + random forest (numpy)
# --------------------------------------------------------------------------

@dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0


class DecisionTree:
    def __init__(self, max_depth=12, min_leaf=5, n_thresholds=16, rng=None):
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.n_thresholds = n_thresholds
        self.rng = rng or np.random.default_rng()
        self.nodes: List[_Node] = []

    def fit(self, x: np.ndarray, y: np.ndarray) -> "DecisionTree":
        self.n_features = x.shape[1]
        self.k = max(1, int(np.sqrt(self.n_features)))
        self._grow(x, y, 0)
        self._pack()
        return self

    def _grow(self, x, y, depth) -> int:
        idx = len(self.nodes)
        self.nodes.append(_Node(value=float(y.mean())))
        if depth >= self.max_depth or len(y) < 2 * self.min_leaf or np.ptp(y) == 0:
            return idx
        feats = self.rng.choice(self.n_features, self.k, replace=False)
        best = (0.0, -1, 0.0)                     # (gain, feature, threshold)
        base_sse = float(np.var(y)) * len(y)
        for f in feats:
            col = x[:, f]
            qs = np.quantile(col, np.linspace(0.05, 0.95, self.n_thresholds))
            for thr in np.unique(qs):
                mask = col <= thr
                nl = int(mask.sum())
                if nl < self.min_leaf or len(y) - nl < self.min_leaf:
                    continue
                sse = float(np.var(y[mask])) * nl + float(np.var(y[~mask])) * (len(y) - nl)
                gain = base_sse - sse
                if gain > best[0]:
                    best = (gain, f, float(thr))
        if best[1] < 0:
            return idx
        _, f, thr = best
        mask = x[:, f] <= thr
        node = self.nodes[idx]
        node.feature, node.threshold = f, thr
        node.left = self._grow(x[mask], y[mask], depth + 1)
        node.right = self._grow(x[~mask], y[~mask], depth + 1)
        return idx

    def _pack(self) -> None:
        """Flatten the node list into parallel arrays so predict() can run
        a level-order masked descent instead of a per-row Python walk."""
        nd = self.nodes
        m = len(nd)
        self._feat = np.fromiter((n.feature for n in nd), np.int64, m)
        self._thr = np.fromiter((n.threshold for n in nd), np.float64, m)
        self._left = np.fromiter((n.left for n in nd), np.int64, m)
        self._right = np.fromiter((n.right for n in nd), np.int64, m)
        self._value = np.fromiter((n.value for n in nd), np.float64, m)

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Vectorized traversal: all rows descend one level per pass, rows
        that reached a leaf drop out of the active set.  At most
        ``max_depth`` numpy passes replace one Python ``while`` per row —
        bitwise-identical routing to the scalar walk (same ``<=`` splits)."""
        x = np.asarray(x, dtype=np.float64)
        pos = np.zeros(len(x), dtype=np.int64)
        if len(x) == 0 or self._feat[0] < 0:
            return self._value[pos] if len(x) else np.empty(0)
        active = np.arange(len(x))
        while active.size:
            node = pos[active]
            f = self._feat[node]
            go_left = x[active, f] <= self._thr[node]
            pos[active] = np.where(go_left, self._left[node], self._right[node])
            active = active[self._feat[pos[active]] >= 0]
        return self._value[pos]


class RandomForest:
    def __init__(self, n_trees=20, max_depth=12, min_leaf=5, seed=0):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.seed = seed
        self.trees: List[DecisionTree] = []

    def fit(self, x: np.ndarray, y: np.ndarray) -> "RandomForest":
        rng = np.random.default_rng(self.seed)
        self.trees = []
        for _ in range(self.n_trees):
            idx = rng.choice(len(x), len(x), replace=True)
            t = DecisionTree(self.max_depth, self.min_leaf, rng=rng).fit(x[idx], y[idx])
            self.trees.append(t)
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        return np.mean([t.predict(x) for t in self.trees], axis=0)


# --------------------------------------------------------------------------
# online predictor (the cntd_predictive policy's model)
# --------------------------------------------------------------------------

@dataclass
class OnlinePredictor:
    """Per-(site, rank) online slack predictor over the retired phase stream.

    Two regimes, switched automatically:

    * **cold** — until ``min_fit`` rows accrue, predictions fall back to a
      per-(site, rank) EMA of observed slack (last-value smoothed by
      ``ema_alpha``); a pair with no history at all predicts nothing
      (NaN), so the consumer never arms on a guess.
    * **warm** — a small :class:`RandomForest` refit every ``refit_every``
      observations on a bounded window of the most recent rows.  Features
      are exactly what the runtime can know *before* a call completes:
      (site, rank) plus the pair's previous (slack, comp, copy) and its
      slack EMA.  Targets are **linear-space** slack (unlike the offline
      Table-1 study's log targets): mean-leaf trees on linear targets
      estimate the arithmetic conditional mean, which is the quantity the
      arm decision prices — log targets yield the geometric mean, and on
      streams with frequent zero-slack occurrences (the critical rank of
      every task) that collapses toward zero and never clears the bar.

    Deterministic: refits are seeded from ``(seed, refit_index)`` and
    triggered purely by the observation counter, so the predictor — like
    the tuner it feeds — is a pure function of the observation order
    (trace replay stays bit-for-bit).
    """

    n_trees: int = 4
    max_depth: int = 6
    min_fit: int = 64                # rows before the first forest fit
    refit_every: int = 256          # observations between refits
    window: int = 4096              # training window of most recent rows
    ema_alpha: float = 0.3          # cold-path slack EMA weight
    seed: int = 0

    def __post_init__(self) -> None:
        # (site, rank) -> [last_slack, last_comp, last_copy, ema_slack]
        self._last: Dict[Tuple[int, int], List[float]] = {}
        self._rows: collections.deque = collections.deque(maxlen=self.window)
        self._tgts: collections.deque = collections.deque(maxlen=self.window)
        self._forest: Optional[RandomForest] = None
        self._n_obs = 0
        self._n_fits = 0
        self._next_fit = self.min_fit

    # ---- queries ---------------------------------------------------------
    @property
    def warm(self) -> bool:
        return self._forest is not None

    @property
    def n_observations(self) -> int:
        return self._n_obs

    @property
    def n_refits(self) -> int:
        return self._n_fits

    def _features(self, site: int, rank: int, st: Sequence[float]) -> List[float]:
        return [float(site), float(rank), st[0], st[1], st[2], st[3]]

    def predict(self, site: int, rank: int) -> Tuple[float, str]:
        """Predicted next slack (seconds) for this (site, rank), with the
        regime that produced it: ``(nan, "cold")`` when the pair has no
        history, ``(ema, "ema")`` before the first fit, ``(forest value,
        "forest")`` after."""
        st = self._last.get((site, rank))
        if st is None:
            return float("nan"), "cold"
        if self._forest is not None:
            x = np.asarray([self._features(site, rank, st)])
            return max(float(self._forest.predict(x)[0]), 0.0), "forest"
        return st[3], "ema"

    def predict_ranks(self, site: int, n: int) -> Tuple[np.ndarray, str]:
        """Vectorized :meth:`predict` over ranks ``0..n-1`` (the simulator
        path): one forest traversal for the whole rank vector.  Cold ranks
        stay NaN."""
        preds = np.full(n, np.nan)
        states = [self._last.get((site, r)) for r in range(n)]
        warm = [r for r, st in enumerate(states) if st is not None]
        if not warm:
            return preds, "cold"
        if self._forest is not None:
            x = np.asarray([self._features(site, r, states[r]) for r in warm])
            preds[warm] = np.maximum(self._forest.predict(x), 0.0)
            return preds, "forest"
        preds[warm] = [states[r][3] for r in warm]
        return preds, "ema"

    # ---- observations ----------------------------------------------------
    def observe(self, site: int, rank: int, slack: float,
                comp: float = 0.0) -> None:
        """Account one retired occurrence: the pair's *previous* state
        becomes a training row targeting this slack, then the state rolls
        forward.  Copy durations arrive later (:meth:`note_copy`) and only
        update the feature state — the target is always slack."""
        key = (site, rank)
        slack = max(float(slack), 0.0)
        comp = max(float(comp), 0.0)
        st = self._last.get(key)
        if st is None:
            self._last[key] = [slack, comp, 0.0, slack]
            return
        self._rows.append(tuple(self._features(site, rank, st)))
        self._tgts.append(slack)
        self._n_obs += 1
        st[0], st[1] = slack, comp
        st[3] = (1.0 - self.ema_alpha) * st[3] + self.ema_alpha * slack
        if self._n_obs >= self._next_fit:
            self._refit()

    def note_copy(self, site: int, rank: int, copy: float) -> None:
        st = self._last.get((site, rank))
        if st is not None:
            st[2] = max(float(copy), 0.0)

    def note_copy_ranks(self, site: int, copies: np.ndarray) -> None:
        for r, c in enumerate(np.asarray(copies, np.float64).tolist()):
            self.note_copy(site, r, c)

    def observe_ranks(self, site: int, slacks: np.ndarray,
                      comps: Optional[np.ndarray] = None) -> None:
        slacks = np.asarray(slacks, np.float64)
        comps = (np.asarray(comps, np.float64) if comps is not None
                 else np.zeros_like(slacks))
        for r in range(slacks.shape[0]):
            self.observe(site, r, float(slacks[r]), float(comps[r]))

    def _refit(self) -> None:
        x = np.asarray(self._rows, dtype=np.float64)
        y = np.asarray(self._tgts, dtype=np.float64)
        self._forest = RandomForest(
            n_trees=self.n_trees, max_depth=self.max_depth,
            seed=self.seed + self._n_fits,
        ).fit(x, y)
        self._n_fits += 1
        self._next_fit = self._n_obs + self.refit_every

    def reset(self) -> None:
        self._last.clear()
        self._rows.clear()
        self._tgts.clear()
        self._forest = None
        self._n_obs = 0
        self._n_fits = 0
        self._next_fit = self.min_fit


# --------------------------------------------------------------------------
# evaluation
# --------------------------------------------------------------------------

def smape(pred: np.ndarray, actual: np.ndarray) -> float:
    """Paper footnote 3: 100 * |pred-actual| / (pred+actual).

    Zero-denominator rows — a zero prediction of a zero-duration phase —
    are *exact hits* and count as 0% error.  (Dropping them, the old
    behavior, silently biased Table-1 SMAPE upward for apps with many
    zero-slack phases predicted correctly.)"""
    pred = np.asarray(pred, dtype=np.float64)
    actual = np.asarray(actual, dtype=np.float64)
    denom = np.abs(pred) + np.abs(actual)
    safe = np.where(denom > 0, denom, 1.0)
    err = np.where(denom > 0, 100.0 * np.abs(pred - actual) / safe, 0.0)
    return float(err.mean()) if err.size else 0.0


def zero_denominator_fraction(pred: np.ndarray, actual: np.ndarray) -> float:
    """Fraction of rows whose SMAPE denominator is zero (counted as exact
    hits by :func:`smape`) — surfaced so Table 1 readers can see how much
    of the score is zero-phase mass."""
    pred = np.asarray(pred, dtype=np.float64)
    actual = np.asarray(actual, dtype=np.float64)
    if pred.size == 0:
        return 0.0
    return float(np.mean((np.abs(pred) + np.abs(actual)) == 0))


@dataclass
class PredictabilityResult:
    app: str
    with_prev: bool
    smape: Dict[str, float]                       # target -> %
    importance: Dict[str, Dict[str, float]]       # target -> feature -> [0,1]
    zero_frac: Dict[str, float] = field(default_factory=dict)
    # target -> fraction of test rows counted as exact zero hits


def evaluate_predictability(
    app: str,
    trace: TraceRecord,
    with_prev: bool,
    n_trees: int = 12,
    seed: int = 0,
    importance: bool = False,
) -> PredictabilityResult:
    x, y, names = build_dataset(trace, with_prev, seed=seed)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(x))
    n_train = int(0.7 * len(x))
    tr, te = perm[:n_train], perm[n_train:]
    out_smape: Dict[str, float] = {}
    out_imp: Dict[str, Dict[str, float]] = {}
    out_zero: Dict[str, float] = {}
    eps = 1e-9
    for j, tgt in enumerate(TARGETS):
        ylog = np.log(np.maximum(y[:, j], eps))
        rf = RandomForest(n_trees=n_trees, seed=seed).fit(x[tr], ylog[tr])
        pred = np.exp(rf.predict(x[te]))
        out_smape[tgt] = smape(pred, y[te, j])
        out_zero[tgt] = zero_denominator_fraction(pred, y[te, j])
        if importance:
            base = smape(pred, y[te, j])
            imps = {}
            for f, name in enumerate(names):
                xs = x[te].copy()
                xs[:, f] = rng.permutation(xs[:, f])
                imps[name] = max(smape(np.exp(rf.predict(xs)), y[te, j]) - base, 0.0)
            mx = max(imps.values()) or 1.0
            out_imp[tgt] = {k: v / mx for k, v in imps.items()}
    return PredictabilityResult(app, with_prev, out_smape, out_imp, out_zero)
