"""Length and gap distributions of the traffic generators, as a fixed set
of stratified quantiles: ``n`` draws of a distribution are its quantiles at
``(i + 0.5) / n``, and ``--seed`` only permutes them.  So every seed gives
a run the same lengths and the same gaps, in another order.

A distribution is a JSON object: ``{"dist": "log_halves", "median": m,
"min": a, "max": b}`` (half the values log-uniform on [a, m], half on
[m, b]: the most even spread of log-length, the largest entropy, that
a median and a range alone allow, with nothing piled on either end),
``{"dist": "lognormal", "median": m, "sigma": s, "min": a, "max": b}``
(for a mix whose source gives the spread), ``{"dist": "uniform", "min":
a, "max": b}`` or ``{"dist": "exponential", "mean": m}``; ``"residual": true`` takes
instead the remaining length of a request found in progress, whose density
is ``P(L >= r) / E[L]`` (a slot refilled as soon as it frees holds its
requests in proportion to their length).
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict

import numpy as np


def _quantile(spec: Dict, u: np.ndarray) -> np.ndarray:
    dist = spec["dist"]
    if dist == "log_halves":
        lo, m, hi = spec["min"], spec["median"], spec["max"]
        return np.where(u < 0.5, lo * (m / lo) ** (2 * u), m * (hi / m) ** (2 * u - 1))
    if dist == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
        return spec["median"] * np.exp(spec["sigma"] * z)
    if dist == "uniform":
        return spec["min"] + u * (spec["max"] + 1 - spec["min"])
    if dist == "exponential":
        return -spec["mean"] * np.log1p(-u)
    raise ValueError(f"unknown distribution {dist!r}")


def _residual(spec: Dict, u: np.ndarray) -> np.ndarray:
    """Quantiles of the residual length of ``spec``'s integer lengths."""
    base = {k: v for k, v in spec.items() if k != "residual"}
    lengths = np.floor(_clip(base, _quantile(base, (np.arange(4096) + 0.5) / 4096)))
    top = int(lengths.max())
    r = np.arange(1, top + 1)
    survive = (lengths[None, :] >= r[:, None]).mean(axis=1)      # P(L >= r)
    cdf = np.cumsum(survive) / survive.sum()
    return r[np.minimum(np.searchsorted(cdf, u), len(r) - 1)].astype(float)


def _clip(spec: Dict, x: np.ndarray) -> np.ndarray:
    lo, hi = spec.get("min", -math.inf), spec.get("max", math.inf)
    return np.clip(x, lo, hi)


def order_rng(params: Dict, seed: int) -> np.random.Generator:
    """What orders the sizes and gaps: the mix's own ``order_seed`` where it
    has one (one schedule for every ``--seed``: the seed then draws only
    the token ids, the sampling keys, the greedy requests and the
    weights), else ``--seed``."""
    return np.random.default_rng(params.get("order_seed", seed))


def stratified(spec: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` values of ``spec`` (floats; lengths are floored by the caller),
    the same set for every ``rng``, in the order ``rng`` permutes them."""
    u = (np.arange(n) + 0.5) / n
    vals = _residual(spec, u) if spec.get("residual") else _clip(spec, _quantile(spec, u))
    return vals[rng.permutation(n)]
