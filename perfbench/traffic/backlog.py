"""An offline batch: a backlog of requests present from the start, which
the server works through as fast as its slots allow.  The first
``fill`` requests find the slots empty; they take output lengths drawn
from the residual of the output distribution, the length still to go of a
request found in progress, so that completions and joins run at their
steady rate from the first step.  ``backlog`` more requests wait behind
them.  Lengths are fixed stratified sets permuted by the seed or by the
mix's ``order_seed`` (:mod:`perfbench.traffic.sizes`); ``greedy_share`` of the requests, chosen
by the seed, decode greedily.

Parameters (the workload file's ``mix``): ``fill``, ``backlog``,
``prompt``, ``output`` (distributions), ``greedy_share``, optionally
``order_seed``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from perfbench.traffic.sizes import order_rng, stratified


def requests(params: Dict, seed: int, horizon_s: float) -> List[Dict]:
    fill, rest = params["fill"], params["backlog"]
    n = fill + rest
    rng = order_rng(params, seed)
    prompts = np.floor(stratified(params["prompt"], n, rng)).astype(int)
    outputs = np.concatenate([
        np.floor(stratified({**params["output"], "residual": True}, fill, rng)),
        np.floor(stratified(params["output"], rest, rng))]).astype(int)
    greedy = np.zeros(n, bool)
    greedy[np.random.default_rng(seed).permutation(n)[:round(n * params.get("greedy_share", 0.0))]] = True
    return [{"arrival": 0.0, "prompt_len": int(prompts[i]), "max_new": max(1, int(outputs[i])),
             "greedy": bool(greedy[i])} for i in range(n)]
