"""The benchmark of ``repro_torch`` on one card: one run of one cell.

    python3 perfbench/run.py --workload granite-chat --seed 7 --seconds 40 --trace 0

prints, as the last line of its standard output, one JSON object: whether
the served tokens agree with the plain reference (``correct``), the
requests attempted and failed, the cell's end-to-end metrics (``--trace
0``) or its per-layer metrics (``--trace 1``, with ``busy_s``, ``window_s``
and ``breakdown``), the card, and last the numbers compared beside their
limits (``check``), which also end its standard error.  It runs from the
root of a checkout that holds ``src/repro_torch``; builds and caches stay
under ``build/`` there.  It exits non-zero, printing no result, without a
CUDA card, when the check cannot run, or when the process has loaded
``jax``, ``jaxlib``, ``flax`` or ``repro``.

Not used by the benchmark's own runs: ``--control`` also reads the check's
numbers of its control, the reference computed with bf16 products in the
program's place, and of a witness, the reference with fp64 products
(``readings`` on the ``run`` line); ``--seeds a,b,..``
runs several seeds in one process, a result line each; ``--rates a,b,..``
runs an open-loop cell at each of these arrival rates (the sweep that
finds the knee).
"""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = str(Path(__file__).resolve().parent)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ.setdefault("OMP_NUM_THREADS", "2")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int)
    p.add_argument("--seeds", help="comma-separated seeds, one run each, in one process")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--rates", help="comma-separated arrival rates, one run each (with --seed)")
    return p


def say(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    seeds = [args.seed] if args.seeds is None else [int(s) for s in args.seeds.split(",")]
    if seeds == [None]:
        say("give --seed")
        return 2
    rates = [None] if args.rates is None else [float(r) for r in args.rates.split(",")]
    runs = [(seed, rate) for seed in seeds for rate in rates]
    import torch

    from perfbench import harness

    bench = harness.spec()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        say(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        say(f"needs {entry['chips']} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(2)
    t_start = T_PROCESS
    for seed, rate in runs:
        res = harness.run(args.workload, seed, args.seconds, bool(args.trace),
                          t_process=t_start, control=args.control, rate=rate, bench=bench)
        info = res["info"]
        say(f"card {res['device']['kind']}, power limit {info.get('power_limit_w')} W; "
            f"energy from {info.get('energy_source')}")
        say(f"modelled (core.pstate.DEFAULT_HW, not the card's): energy saving "
            f"{info['modelled_energy_saving_pct']:.3f} %, priced slack "
            f"{info['modelled_priced_slack_ms']:.1f} ms")
        say("run " + json.dumps({k: v for k, v in info.items()
                                 if not k.startswith("modelled")}))
        found = harness.forbidden_modules()
        if found:
            say("refused: the process loaded " + ", ".join(found))
            return 3
        for name, c in res["check"].items():
            say(f"check {name} {c['value']!r} limit {c['limit']!r}"
                + (" (at least)" if name == "served_tokens" else " (at most)"))
        print(json.dumps(res), flush=True)
        t_start = time.monotonic()
    return 0


if __name__ == "__main__":
    sys.exit(main())
