"""BENCHMARK.json against the contract it is written to, and every name in
it against the files that the harness finds by that name."""
import json
import re
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def test_budget_fits_the_full_check_at_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_exist_and_agree(cell):
    entry, wl, conf = harness.cell_files(cell, BENCH)
    assert wl["name"] == cell and wl["config"] == entry["config"] and wl["traffic"] == entry["traffic"]
    assert conf["name"] == entry["config"]
    assert (ROOT / "perfbench" / "traffic" / f"{wl['generator']}.py").exists()
    harness.model_config(conf["model"])                    # the program takes it
    assert {"served_tokens", "min_tokens", "limits"} <= set(wl["check"])
    assert wl["check"]["limits"] and all(v > 0 for v in wl["check"]["limits"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_and_a_layer(cell):
    e2e = [m["name"] for m in harness.metrics_of(BENCH, cell, trace=False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(BENCH, cell, trace=True)


def test_every_per_layer_metric_has_a_reader_and_moves_one_of_its_cells_metrics():
    for m in BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]).read)
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in CELLS and cell in moved.get("workloads", CELLS)


def test_configs_state_their_source_and_reductions():
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
        assert conf["deployment"] and conf["departures"]
