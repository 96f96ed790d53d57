"""Quickstart on the PyTorch port: a trained (tiny) LM + COUNTDOWN Slack
analysis, as ``examples/quickstart.py`` does on the JAX package.

  PYTHONPATH=src python examples/torch_quickstart.py               # on the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.policies import ALL_POLICIES, BASELINE
from repro_torch.core.simulator import simulate
from repro_torch.core.workloads import APPS, generate
from repro_torch.device import resolve_device
from repro_torch.train.data import DataLoader
from repro_torch.train.loop import init_state, make_train_step
from repro_torch.train.optimizer import OptConfig


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ---- 1. train a tiny LM with the framework's substrate ----
    cfg = reduced(get_config("countdown-100m"), n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)
    opt_cfg = OptConfig(lr=3e-3, warmup_steps=5, total_steps=args.steps)
    state = init_state(cfg, opt_cfg, torch.Generator(device=device).manual_seed(0), device)
    step = make_train_step(cfg, opt_cfg)
    loader = DataLoader(cfg, batch=8, seq_len=33, device=device)
    losses = []
    print(f"training a tiny LM on {device}:")
    try:
        for i, batch in zip(range(args.steps), loader):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            if i % 10 == 0 or i == args.steps - 1:
                print(f"  step {i:3d}  loss {losses[-1]:.3f}")
    finally:
        loader.close()

    # ---- 2. the paper: COUNTDOWN Slack on a calibrated HPC workload ----
    print("\nCOUNTDOWN Slack on the omen_1056p workload (paper §6.4):")
    wl = generate(APPS["omen_1056p"], seed=0)
    base, _ = simulate(wl, BASELINE)
    for pol in ("minfreq", "countdown", "cntd_slack"):
        res, _ = simulate(wl, ALL_POLICIES[pol])
        print(
            f"  {pol:12s} overhead {res.overhead_vs(base):6.2f}%   "
            f"energy saving {res.energy_saving_vs(base):6.2f}%"
        )
    print("\n-> COUNTDOWN Slack: energy saving at (near-)zero overhead.")
    return losses


if __name__ == "__main__":
    main()
