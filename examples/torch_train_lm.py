"""End-to-end driver on the PyTorch port: train the ~100M-parameter LM on
the synthetic corpus, as ``examples/train_lm.py`` does on the JAX package.

  PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300   # on the card
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 40

The data pipeline with host prefetch, AdamW with warmup and cosine decay,
an async checkpoint (the newest 2 kept) every 100 steps, in the JAX
package's layout and file format (:mod:`repro_torch.bridge`), and a live
loss curve.  ``--preset small`` (the default, as the original's) runs the same
code path on a 4-layer model for a fast local run.  The port's step updates
the state in place; the async save has copied it to the host before it
returns, so the next step cannot change what is written.
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.dist.checkpoint import CheckpointManager
from repro_torch.models.transformer import param_count
from repro_torch.train.data import DataLoader
from repro_torch.train.loop import init_state, make_train_step
from repro_torch.train.optimizer import OptConfig


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--preset", choices=["100m", "small"], default="small")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("countdown-100m")
    if args.preset == "small":
        cfg = reduced(cfg, n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
                      d_ff=1024, vocab=4096)
        args.seq = min(args.seq, 128)
    opt_cfg = OptConfig(lr=6e-4, warmup_steps=max(10, args.steps // 20),
                        total_steps=args.steps)
    state = init_state(cfg, opt_cfg, torch.Generator(device=device).manual_seed(0), device)
    n_params = param_count(state["params"])
    print(f"model: {cfg.name} ({n_params/1e6:.1f}M params), "
          f"batch {args.batch} x seq {args.seq}, on {device}")

    step = make_train_step(cfg, opt_cfg)
    loader = DataLoader(cfg, batch=args.batch, seq_len=args.seq, device=device)
    mgr = CheckpointManager(args.checkpoint_dir, keep=2, async_save=True)
    losses = []
    try:
        for i, batch in zip(range(args.steps), loader):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            if (i + 1) % max(1, args.steps // 25) == 0:
                print(f"step {i+1:4d}  loss {losses[-1]:.4f}  "
                      f"(avg10 {np.mean(losses[-10:]):.4f})  lr {float(m['lr']):.2e}",
                      flush=True)
            if (i + 1) % 100 == 0:
                mgr.save(i + 1, bridge.state_to_numpy(cfg, state))
        mgr.wait()
    finally:
        loader.close()
    print(f"\nloss: {np.mean(losses[:10]):.3f} -> {np.mean(losses[-10:]):.3f} "
          f"over {args.steps} steps")
    return losses


if __name__ == "__main__":
    main()
