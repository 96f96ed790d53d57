"""The check's control on the card: the reference computed with bf16
products (below the configuration's fp32 products) in the program's place
has to fail one of the numbers that the program passes, at the cell's own
size and window.  Needs the card (about five minutes a cell); ``-s``
shows each seed's readings:

    python -m pytest -m cuda -s perfbench/tests/test_bench_control.py
"""
import json
from pathlib import Path

import pytest
import torch

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        res = harness.run(cell, seed, BENCH["run_seconds"], False, control=True)
        readings = res["info"]["readings"]
        print(json.dumps({"cell": cell, "seed": seed, "correct": res["correct"],
                          "readings": readings}))
        assert res["correct"], res["check"]
        failed = [k for k, c in res["check"].items()
                  if k != "served_tokens" and readings[f"control_{k}"] > c["limit"]]
        assert failed, (seed, readings)
