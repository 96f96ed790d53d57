"""The arithmetic of the end-to-end and per-layer metrics on made-up
timelines: tails over every request, waits cut at the window's end, rates
as all tokens over all the time."""
import json
from pathlib import Path

import pytest

from perfbench import counts, harness

ROOT = Path(__file__).resolve().parents[2]
PEAKS = json.loads((ROOT / "perfbench" / "peaks.json").read_text())


def test_ttft_counts_every_due_request_and_cuts_waits_at_the_end():
    arrivals = {1: 0.5, 2: 1.0, 3: 2.0, 4: 9.5, 5: 11.0}
    first = {1: 0.9, 2: 1.5, 3: 12.0}           # 3 answers after the window, 4 never
    got = sorted(harness.ttft_samples(arrivals, first, 1.0, 10.0))
    # 1 arrived before the window, 5 after it: neither is due
    assert got == pytest.approx([0.5, 0.5, 8.0])


def test_tpot_counts_every_gap_of_every_request_and_cuts_open_gaps_at_the_end():
    times = {1: [0.5, 1.5, 2.0, 2.5],       # gaps ending at 1.5, 2.0, 2.5
             2: [2.0, 4.0, 11.0],           # 4.0 -> 11.0 still open at 10.0
             3: [8.0],                      # running, no token since 8.0
             4: [7.0, 7.5],                 # finished at 7.5
             5: [0.1, 0.2]}                 # both tokens before the window
    got = sorted(harness.tpot_samples(times, {2, 3}, 1.0, 10.0))
    assert got == pytest.approx(sorted([1.0, 0.5, 0.5, 2.0, 6.0, 2.0, 0.5]))


def test_tokens_in_is_all_tokens_of_the_window():
    times = {1: [0.5, 1.5, 2.5], 2: [1.0, 3.5]}
    assert harness.tokens_in(times, 1.0, 3.0) == 2        # (1.0, 3.0]: 1.5, 2.5
    assert harness.p90([1.0] * 9 + [100.0]) == pytest.approx(10.9)


def test_union_busy_merges_overlaps_and_lists_the_gaps():
    ks = [("a", 1.0, 2.0), ("b", 1.5, 3.0), ("c", 5.0, 6.0), ("d", 9.0, 12.0)]
    busy, gaps = harness.union_busy(ks, 0.0, 10.0)
    assert busy == pytest.approx(2.0 + 1.0 + 1.0)
    assert gaps == [(0.0, 1.0), (3.0, 5.0), (6.0, 9.0)]


def _record(steps, joins, kernels=None, slices=None):
    rec = harness.Recorder(10.0, None, None, None)
    rec.ws, rec.we, rec.t_close = 0.0, 10.0, 10.0
    rec.steps, rec.joins = steps, joins
    rec.gov_total = 4e-4
    tr = None
    if slices is not None:
        tr = harness.Tracer(10, 2, None)
        tr.slices, tr.kernels = slices, kernels
    model = json.loads((ROOT / "perfbench/configs/granite-moe-3b-a800m.json").read_text())["model"]
    return harness.RunRecord(model, {}, rec, tr, PEAKS, counts, "NVIDIA H100 80GB HBM3")


def test_step_join_and_governor_readers():
    steps = [harness.Step(1.0, 1.05, 64, 64 * 1000, end=1.06),
             harness.Step(2.0, 2.07, 64, 64 * 1001, end=2.08)]
    joins = [harness.Join(3.0, 3.2, 1000), harness.Join(4.0, 4.1, 500)]
    run = _record(steps, joins)
    assert harness.reader("decode_step_ms.x").read(run) == pytest.approx(60.0)
    assert harness.reader("join_ms_per_ktok.x").read(run) == pytest.approx(300 / 1.5)
    assert harness.reader("governor_us_per_step.x").read(run) == pytest.approx(200.0)
    mfu = harness.reader("decode_mfu_pct.x").read(run)
    want = 100 * sum(counts.decode_flops(run.model, 64, s.live) for s in steps) / (0.12 * 989e12)
    assert mfu == pytest.approx(want) and 0 < mfu < 100


def test_tpot_reader_is_the_median_of_every_gap_of_the_window():
    run = _record([], [])
    run.rec.token_times = {1: [1.0, 1.1, 1.3, 1.6], 2: [9.0, 9.7], 3: [9.5]}
    run.rec.active = {2: None, 3: None}        # 2's gap from 9.7 and 3's from 9.5 still open
    # gaps 0.1, 0.2, 0.3, 0.7, and 0.3, 0.5 cut at the close
    assert harness.reader("tpot_p50_ms.x").read(run) == pytest.approx(300.0)


def test_trace_readers():
    k = [("paged_attention_kernel<float>", 1.00, 1.01), ("paged_attention_combine_kernel", 1.01, 1.02),
         ("sgemm", 1.02, 1.04), ("flash_attention_kernel<float, 64>", 3.0, 3.1)]
    steps = [harness.Step(1.0, 1.05, 64, 64 * 1000, end=1.06, kernels=k[:3])]
    joins = [harness.Join(2.9, 3.2, 1000, kernels=k[3:])]
    run = _record(steps, joins, kernels=k, slices=[(0.5, 4.5)])
    m = run.model
    assert harness.reader("launches_per_step.x").read(run) == 3
    paged = m["n_layers"] * counts.paged_bytes(m, 64, 64000) / 3.35e12 / 0.02 * 100
    assert harness.reader("paged_attn_roofline.x").read(run) == pytest.approx(paged)
    one = max(counts.flash_flops(m, 1000) / 989e12, counts.flash_bytes(m, 1000) / 3.35e12)
    assert harness.reader("flash_roofline.x").read(run) == pytest.approx(
        100 * m["n_layers"] * one / 0.1)
    assert harness.reader("device_idle_pct.x").read(run) == pytest.approx(100 * (1 - 0.14 / 4.0))
    run.tracer.energy_slices = [(300.0, 1.0), (500.0, 1.0)]
    assert harness.reader("card_power_w").read(run) == pytest.approx(400.0)


def test_readers_return_nothing_without_anything_to_read():
    run = _record([], [])
    for name in ("decode_step_ms", "join_ms_per_ktok", "launches_per_step", "decode_mfu_pct",
                 "paged_attn_roofline", "flash_roofline", "device_idle_pct", "card_power_w",
                 "governor_us_per_step", "tpot_p50_ms"):
        assert harness.reader(name).read(run) is None


def test_counts_of_a_dense_and_an_moe_token():
    glm = json.loads((ROOT / "perfbench/configs/glm4-9b.json").read_text())["model"]
    # glm4-9b: about 9.4 B parameters, 8.8 B of them multiplied per token
    assert 8.7e9 < counts.active_params_per_token(glm) < 8.9e9
    granite = json.loads((ROOT / "perfbench/configs/granite-moe-3b-a800m.json").read_text())["model"]
    assert 0.85e9 < counts.active_params_per_token(granite) < 0.9e9
    assert counts.flash_flops(granite, 1) == 4 * 24 * 64
    assert counts.peak(PEAKS, "NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
