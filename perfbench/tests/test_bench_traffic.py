"""The traffic generators: the same seed gives the same requests, and every
seed the same sizes and gaps in another order."""
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _reqs(cell, seed, horizon=60.0):
    _, wl, _ = harness.cell_files(cell)
    return harness.generator(wl["generator"]).requests(wl["mix"], seed, horizon)


@pytest.mark.parametrize("cell", CELLS)
def test_deterministic_from_the_seed(cell):
    assert _reqs(cell, 2**31 + 7) == _reqs(cell, 2**31 + 7)
    assert _reqs(cell, 2**31 + 7) != _reqs(cell, 3)


@pytest.mark.parametrize("cell", CELLS)
def test_every_seed_the_same_sizes(cell):
    a, b = _reqs(cell, 1), _reqs(cell, 99)
    for key in ("prompt_len", "max_new", "greedy"):
        assert sorted(r[key] for r in a) == sorted(r[key] for r in b)
    gaps = [np.sort(np.diff([r["arrival"] for r in x])) for x in (a, b)]
    np.testing.assert_allclose(*gaps)


@pytest.mark.parametrize("cell", CELLS)
def test_sizes_within_the_mix(cell):
    _, wl, _ = harness.cell_files(cell)
    mix = wl["mix"]
    reqs = _reqs(cell, 5)
    lo, hi = mix["prompt"]["min"], mix["prompt"]["max"]
    assert all(lo <= r["prompt_len"] <= hi for r in reqs)
    assert all(1 <= r["max_new"] <= mix["output"]["max"] for r in reqs)
    assert abs(sum(r["greedy"] for r in reqs) - len(reqs) * mix["greedy_share"]) <= 1


def test_open_loop_rate_and_medians():
    from perfbench.traffic import open_loop

    mix = {"rate_per_s": 4.0, "greedy_share": 0.0,
           "prompt": {"dist": "lognormal", "median": 1024, "sigma": 0.7, "min": 128, "max": 2048},
           "output": {"dist": "lognormal", "median": 128, "sigma": 0.8, "min": 16, "max": 512}}
    reqs = open_loop.requests(mix, 3, 500.0)
    assert len(reqs) == 2000
    assert reqs[0]["arrival"] == 0.0
    assert abs(reqs[-1]["arrival"] / (len(reqs) - 1) - 0.25) < 0.01
    assert abs(np.median([r["prompt_len"] for r in reqs]) - 1024) <= 2
    assert abs(np.median([r["max_new"] for r in reqs]) - 128) <= 1


def test_log_halves_holds_its_median_and_range_and_piles_nothing_on_either_end():
    from perfbench.traffic.sizes import stratified

    spec = {"dist": "log_halves", "median": 1024, "min": 128, "max": 2048}
    v = stratified(spec, 4000, np.random.default_rng(0))
    assert v.min() >= 128 and v.max() < 2048
    assert abs(np.median(v) - 1024) < 1
    # log-uniform on each side: an octave below the median holds a third of
    # the lower half (three octaves), the octave above all of the upper half
    assert abs((v < 512).mean() - 0.5 * 2 / 3) < 1e-3
    assert abs((v < 1448.15).mean() - 0.75) < 1e-3
    # the last length at either end holds its density's share, about 0.2 %
    assert (v >= 2047).mean() < 5e-3 and (v < 129).mean() < 5e-3


def test_backlog_fill_takes_the_residual_lengths():
    from perfbench.traffic import backlog

    mix = {"fill": 1000, "backlog": 1000, "greedy_share": 0.0,
           "prompt": {"dist": "uniform", "min": 64, "max": 64},
           "output": {"dist": "uniform", "min": 256, "max": 768}}
    reqs = backlog.requests(mix, 1, 0.0)
    fill = [r["max_new"] for r in reqs[:1000]]
    rest = [r["max_new"] for r in reqs[1000:]]
    # a uniform [a, b] length's residual has mean E[L^2] / (2 E[L])
    lengths = np.arange(256, 769)
    assert abs(np.mean(fill) - (lengths ** 2).mean() / (2 * lengths.mean())) < 3
    assert abs(np.mean(rest) - 512) < 1
    assert all(r["arrival"] == 0.0 for r in reqs)
