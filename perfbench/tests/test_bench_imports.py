"""Nothing the benchmark runs loads JAX or the JAX package, or reads the
JAX package's benchmark folder; the reference loads nothing of the program.
Module names are compared by their whole top-level name: ``repro_torch`` is
the program, ``repro`` the JAX package."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
JAX_BENCH = "benchmarks" + "/"

# a whole small run on the CPU through every module a run on the card loads,
# then every module the process holds, with its file
PROBE = r"""
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
sys.argv = ["run.py"]
import runpy
runpy.run_path({run!r}, run_name="perfbench_run")   # the entry's imports, not its main
from perfbench import counts, energy, harness, reference, weights
for name in {readers!r}:
    harness.reader(name)
sys.path.insert(0, {tests!r})
from test_bench_reference import SMALL_CELLS
for cell, over in SMALL_CELLS.items():
    harness.run(cell, 3, 0.5, False, device="cpu", overrides=over)
print(json.dumps({{m: getattr(mod, "__file__", None) for m, mod in list(sys.modules.items())}}))
"""


def _modules(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_reads_no_jax_benchmark():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mods = _modules(PROBE.format(root=str(ROOT), src=str(ROOT / "src"),
                                 run=str(ROOT / "perfbench" / "run.py"),
                                 tests=str(ROOT / "perfbench" / "tests"),
                                 readers=[m["name"] for m in bench["per_layer"]]))
    assert "repro_torch.serve.engine" in mods and "perfbench.harness" in mods
    bad = sorted(m for m in mods if m.split(".")[0] in FORBIDDEN)
    assert not bad, bad
    jax_bench = str(ROOT / "benchmarks")
    read = sorted(m for m, f in mods.items() if f and str(Path(f).resolve()).startswith(jax_bench))
    assert not read, read


@pytest.mark.parametrize("module", ["perfbench.reference", "perfbench.counts",
                                    "perfbench.weights"])
def test_the_yardstick_loads_nothing_of_the_program(module):
    mods = _modules(f"import sys, json; sys.path[:0] = [{str(ROOT)!r}]; import {module}; "
                    "print(json.dumps({m: None for m in sys.modules}))")
    bad = sorted(m for m in mods if m.split(".")[0] in FORBIDDEN | {"repro_torch"})
    assert not bad, bad


def test_no_source_of_the_benchmark_names_the_jax_package():
    for path in (ROOT / "perfbench").rglob("*.py"):
        text = path.read_text()
        for line in text.splitlines():
            words = line.replace("(", " ").replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                top = words[1].split(".")[0]
                assert top not in FORBIDDEN, f"{path}: {line}"
        assert JAX_BENCH not in text.replace("perfbench/", ""), path
