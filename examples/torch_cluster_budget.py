"""Cluster power budget on the PyTorch port: a train job + a bursty serve
job under one cap, as ``examples/cluster_budget.py`` does on the JAX
package.

  PYTHONPATH=src python examples/torch_cluster_budget.py
  PYTHONPATH=src python examples/torch_cluster_budget.py --device cpu

Two simulated tenants share a 100 W cluster cap: a compute-bound training
job (EP-like — every watt converts to progress) and a bursty-serve job
(decode-shaped — most of its rank-time is slack).  The
``PowerBudgetArbiter`` polls each job's exploited-slack ratio every epoch
and re-splits the cap with AIMD steps; this prints the per-epoch watt
reallocation, then compares the outcome against static equal-split.  The
tenants are simulated on the host (``core.pstate.DEFAULT_HW``'s watts, a
CPU node of the paper); ``--device`` is taken as every port entry point
takes it, and no work runs there.
"""
import argparse

from repro_torch.cluster import (
    PowerBudgetArbiter,
    StaticEqualSplit,
    make_job,
    run_coschedule,
)
from repro_torch.device import resolve_device

CAP_W = 100.0
FLOOR_W = 15.0


def mix():
    return [
        make_job("compute_bound", job_id="train", seed=1, floor_w=FLOOR_W),
        make_job("bursty_serve", job_id="serve", seed=2, floor_w=FLOOR_W),
    ]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    print(f"cluster cap {CAP_W:.0f} W, per-job floor {FLOOR_W:.0f} W\n")
    print("epoch   train W   serve W   (exploited-slack ratio train / serve)")

    jobs = mix()
    by_id = {j.job_id: j for j in jobs}

    def show(epoch, alloc):
        ratios = []
        for jid in ("train", "serve"):
            job = by_id[jid]
            ratios.append(job.reports[-1].exploited_ratio if job.reports else 0.0)
        print(f"  {epoch:3d}  {alloc.get('train', 0.0):7.1f}  "
              f"{alloc.get('serve', 0.0):7.1f}    ({ratios[0]:.3f} / {ratios[1]:.3f})")

    arbited = run_coschedule(
        jobs, CAP_W,
        arbiter=PowerBudgetArbiter(cap_w=CAP_W, floor_w=FLOOR_W),
        on_epoch=show,
    )
    static = run_coschedule(
        mix(), CAP_W, arbiter=StaticEqualSplit(cap_w=CAP_W, floor_w=FLOOR_W)
    )

    print("\ndiscipline        makespan      energy")
    for r in (static, arbited):
        print(f"  {r.discipline:22s} {r.makespan_s:6.2f} s  {r.energy_j:7.0f} J")
    saving = 100.0 * (1.0 - arbited.energy_j / static.energy_j)
    overhead = 100.0 * (arbited.makespan_s / static.makespan_s - 1.0)
    print(f"\narbiter vs static: {saving:+.1f}% energy at {overhead:+.1f}% makespan")
    if not (saving > 0.0 and overhead <= 1.0):
        raise RuntimeError("the arbiter should win this mix")
    return {"saving_pct": saving, "overhead_pct": overhead}


if __name__ == "__main__":
    main()
