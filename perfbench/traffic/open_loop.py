"""Open-loop traffic: independent users sending requests at a fixed rate,
whatever the server does.  Arrivals are a Poisson process at
``rate_per_s`` (exponential gaps, the first at 0), as the program's own
``serve.scheduler.poisson_arrivals`` draws them, without its bursts; the
gaps, prompt lengths and output lengths are each a fixed stratified set,
permuted by the seed or by the mix's ``order_seed``
(:mod:`perfbench.traffic.sizes`).  ``greedy_share``
of the requests, chosen by the seed, decode greedily; the rest sample.

Parameters (the workload file's ``mix``): ``rate_per_s``, ``prompt``,
``output`` (distributions), ``greedy_share``, optionally ``order_seed``.  The requests cover
``horizon_s`` seconds of arrivals.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from perfbench.traffic.sizes import order_rng, stratified


def requests(params: Dict, seed: int, horizon_s: float) -> List[Dict]:
    rate = params["rate_per_s"]
    n = max(2, math.ceil(rate * horizon_s))
    rng = order_rng(params, seed)
    gaps = stratified({"dist": "exponential", "mean": 1.0 / rate}, n - 1, rng)
    arrivals = np.concatenate([[0.0], np.cumsum(gaps)])
    prompts = np.floor(stratified(params["prompt"], n, rng)).astype(int)
    outputs = np.floor(stratified(params["output"], n, rng)).astype(int)
    greedy = np.zeros(n, bool)
    greedy[np.random.default_rng(seed).permutation(n)[:round(n * params.get("greedy_share", 0.0))]] = True
    return [{"arrival": float(arrivals[i]), "prompt_len": int(prompts[i]),
             "max_new": int(outputs[i]), "greedy": bool(greedy[i])} for i in range(n)]
