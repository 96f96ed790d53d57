"""COUNTDOWN Slack LIVE on the PyTorch port: data-parallel training with
instrumented collectives, as ``examples/energy_aware_training.py`` does on
the JAX package.

The paper's runtime working end to end on real execution (not the
simulator): every rank of the process group takes its shard of the global
batch; every gradient all-reduce goes through ``cd_psum``, which (i)
inserts the artificial barrier and (ii) emits host phase events; the
Governor reconstructs per-rank slack, applies the 500 us timeout policy,
logs the P-state actuations it would issue, estimates the energy saving,
and feeds the straggler detector.

  # 4 ranks on the CPU (gloo), or one card a rank (NCCL)
  PYTHONPATH=src torchrun --nproc-per-node 4 examples/torch_energy_aware_training.py --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 examples/torch_energy_aware_training.py

  # a world of 1 on the card
  PYTHONPATH=src python examples/torch_energy_aware_training.py

The original emulates 8 devices in one process (XLA's host platform) and
runs the step under ``shard_map``.  Here the ranks are ``torchrun``'s
processes: gloo on the CPU, NCCL on the card.  Without ``torchrun``'s
environment the example runs in a world of 1, as the training launcher
does.  The global batch (8 rows) must divide over the ranks.
"""
import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced
from repro_torch.core import instrument
from repro_torch.core.governor import Governor
from repro_torch.core.instrument import cd_psum
from repro_torch.core.policies import COUNTDOWN_SLACK
from repro_torch.device import join_group, resolve_device
from repro_torch.models import init_params, loss_fn
from repro_torch.models.inputs import make_batch
from repro_torch.train.loop import shard_of
from repro_torch.train.optimizer import OptConfig, adamw_update, decay_mask, init_opt_state
from repro_torch.tree import leaves, tree_map, unflatten


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; under torchrun cuda:LOCAL_RANK)")
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)
    if args.device is None and "LOCAL_RANK" in os.environ:
        args.device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    device = resolve_device(args.device)
    made_group = join_group(device)
    governor = Governor(policy=COUNTDOWN_SLACK)
    try:
        n_dev = dist.get_world_size()
        cfg = reduced(get_config("countdown-100m"), n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)
        opt_cfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=args.steps)
        params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
        opt = init_opt_state(params, opt_cfg)
        decay = decay_mask(cfg, params)

        instrument.warm_up(device)              # communicator setup is not slack
        instrument.set_mode("profile")
        instrument.enable_events(True)
        instrument.get_event_bus().subscribe(governor)

        def per_rank_step(params, opt, batch):
            # Tcomp: local forward/backward -- then the instrumented collective:
            # artificial barrier (isolates slack) + the real grad all-reduce.
            live = [p.detach().requires_grad_(True) for p in leaves(params)]
            with torch.enable_grad():
                loss, _ = loss_fn(cfg, unflatten(params, live), shard_of(batch))
                grads = unflatten(params, list(torch.autograd.grad(loss, live)))
            grads = tree_map(lambda g: g / n_dev, cd_psum(grads))
            loss = cd_psum(loss.detach()) / n_dev
            params, opt, _ = adamw_update(params, grads, opt, opt_cfg, decay)
            return params, opt, loss

        losses = []
        if dist.get_rank() == 0:
            print(f"data-parallel training on {n_dev} ranks ({device.type}), "
                  "COUNTDOWN Slack live:")
        for i in range(args.steps):
            batch = make_batch(cfg, batch=8, seq_len=33, seed=i, kind="train", device=device)
            params, opt, loss = per_rank_step(params, opt, batch)
            losses.append(float(loss))
            if dist.get_rank() == 0 and (i % 10 == 0 or i == args.steps - 1):
                print(f"  step {i:3d}  loss {losses[-1]:.3f}")

        rep = governor.finalize()
        if dist.get_rank() == 0:
            print("\nGovernor report (reconstructed from live phase events):")
            print(f"  instrumented collectives : {rep.n_calls}")
            print(f"  total slack observed     : {rep.total_slack*1e3:.2f} ms")
            print(f"  timeout downshifts       : {rep.n_downshifts}")
            print(f"  exploitable slack        : {rep.exploited_slack*1e3:.2f} ms")
            print(f"  est. energy saving (comm): {rep.energy_saving_pct:.2f}%")
            print(f"  P-state actuations logged: {len(governor.actuation_log)}")
            if rep.stragglers:
                print(f"  stragglers flagged       : {rep.stragglers}")
            else:
                print("  stragglers flagged       : none (balanced ranks)")
        return {"world": n_dev, "losses": losses, "report": rep}
    finally:
        instrument.set_mode("off")
        instrument.enable_events(False)
        instrument.get_event_bus().unsubscribe(governor)
        if made_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
