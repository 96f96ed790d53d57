"""Training entry point of the port: synthetic data, AdamW, the governor's
report.

  # full-width llama3.2-1b on the card, 8 steps of batch 8 x 128 tokens
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --steps 8

  # the data-parallel step whose gradients and loss reduce through the
  # instrumented cd_psum, its phases priced by the governor, on 4 cards
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch countdown-100m --steps 20 --live-events --theta auto

  # a small model on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 20 --device cpu

The defaults are the reference's (``repro.launch.train``): countdown-100m,
batch 8, sequence 128, remat on, and AdamW warming up over
``min(100, steps // 10 + 1)`` steps and decaying to ``steps``.  Weights are
random, drawn from ``--seed``; the batches are the reference's synthetic
corpus for the same seed.  Without ``--live-events`` a world of 1 runs
``make_train_step`` and a larger world ``make_pod_train_step`` (gradients
through ``cd_psum``, silent unless instrumented); ``--live-events`` runs
:func:`build_live`, whose gradients *and* loss reduce through ``cd_psum``
(two instrumented calls a step) with host phase events on, so the governor
prices them.  The process group comes from ``torchrun``'s environment
when it is set, else it is a world of 1 (NCCL on the card, gloo on the
CPU).  The checkpoint, failure, trace, power-cap and telemetry flags are
parsed with the reference's defaults and refused when set: they wait for
later slices (ROADMAP.md, queue 1).  Logs the reference's ``step`` and
``governor`` lines; the last line of output is the run's result as one
JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced
from repro_torch.core import instrument
from repro_torch.core.governor import Governor
from repro_torch.core.policies import policy_for_theta
from repro_torch.device import resolve_device
from repro_torch.obs import log as obslog
from repro_torch.train.data import DataLoader
from repro_torch.train.loop import (
    TrainConfig, _div, _grads, init_state, make_pod_train_step, make_train_step, shard_of,
)
from repro_torch.train.optimizer import OptConfig, adamw_update, decay_mask
from repro_torch.tree import leaves, tree_map

log = obslog.get_logger("train")

# flags parsed with the reference's defaults and refused when set: the
# ROADMAP item each waits for
WAITING = {
    "checkpoint_dir": ("", "queue 1, item 5 (checkpoints)"),
    "save_every": (50, "queue 1, item 5 (checkpoints)"),
    "resume": (False, "queue 1, item 5 (checkpoints)"),
    "fail_at": (0, "queue 1, item 5 (elastic restart)"),
    "model_parallel": (1, "queue 1, item 5 (sharding inside a pod)"),
    "trace_out": ("", "queue 1, item 7 (cluster traces)"),
    "power_cap": (0.0, "queue 1, item 7 (the cluster's power cap)"),
    "perfetto_out": ("", "queue 1, item 8 (observability)"),
    "metrics_out": ("", "queue 1, item 8 (observability)"),
    "dashboard": (False, "queue 1, item 8 (observability)"),
}


def build_live(cfg, opt_cfg: OptConfig, group=None):
    """The data-parallel step with instrumented collectives (the
    reference's ``build_live``): each rank takes its shard of the global
    batch, and the gradients and the loss are reduced through ``cd_psum``
    and divided by the group's size, two instrumented calls a step, so in
    profile mode with events on the governor prices both."""
    n = dist.get_world_size(group)

    def step(state: Dict[str, Any], batch: Dict[str, Any]):
        params = state["params"]
        loss, _, grads = _grads(cfg, params, shard_of(batch, group))
        grads = tree_map(lambda g: _div(g, n), instrument.cd_psum(grads, group))
        loss = _div(instrument.cd_psum(loss, group), n)
        params, opt, m = adamw_update(params, grads, state["opt"], opt_cfg,
                                      decay_mask(cfg, params))
        return {"params": params, "opt": opt}, {**m, "loss": loss}

    return step


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="countdown-100m",
                    help="countdown-100m, llama3.2-1b, recurrentgemma-2b or mamba2-130m")
    ap.add_argument("--reduced", action="store_true", help="smoke-size config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=0,
                    help="simulate a node failure at this step (fault-tolerance demo)")
    ap.add_argument("--instrument", choices=["off", "barrier", "profile"], default="off")
    ap.add_argument("--live-events", action="store_true",
                    help="run the data-parallel step whose gradients and loss reduce "
                         "through cd_psum with host phase events on; implies "
                         "--instrument profile")
    ap.add_argument("--theta", default="",
                    help="governor timeout: seconds (e.g. 500e-6), 'auto' for "
                         "the online ThetaTuner (cntd_adaptive policy), or "
                         "'predictive' for the guarded predictor+timeout "
                         "hybrid (cntd_predictive); empty = the policy default "
                         "(500 us fixed)")
    ap.add_argument("--trace-out", default="")
    ap.add_argument("--power-cap", type=float, default=0.0)
    ap.add_argument("--perfetto-out", default="")
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--dashboard", action="store_true")
    ap.add_argument("--ingest", choices=["event", "batched"], default="event",
                    help="event-bus ingestion: 'event' publishes each phase "
                         "event as it fires; 'batched' accumulates fixed-dtype "
                         "EventBatch columns and delivers them chunk-at-a-time "
                         "(same stream order, bit-identical governor report)")
    obslog.add_flags(ap)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; under torchrun cuda:LOCAL_RANK)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _refuse_waiting(args) -> None:
    for name, (default, item) in WAITING.items():
        if getattr(args, name) != default:
            flag = "--" + name.replace("_", "-")
            raise SystemExit(f"{flag} is not ported to repro_torch yet (ROADMAP.md, {item})")


def _device(args) -> torch.device:
    if args.device is None and "LOCAL_RANK" in os.environ:
        return resolve_device(f"cuda:{int(os.environ['LOCAL_RANK'])}")
    return resolve_device(args.device)


def _join_group(device: torch.device) -> bool:
    """Join ``torchrun``'s world when its environment is set, else make a
    world of 1, unless a default group exists already.  Returns whether
    this call made the group (and so must destroy it)."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return True


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> Dict[str, Any]:
    """Train ``args.steps`` steps; returns the run's numbers (losses, grad
    norms, learning rates, synchronised step clocks, tokens/s, peak device
    memory and the governor's report)."""
    _refuse_waiting(args)
    device = _device(args)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, remat=True)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
                        total_steps=args.steps)
    if (args.theta or args.live_events) and args.instrument != "profile":
        # the governor prices phase events, and only profile mode stamps them
        log.info("instrument_upgrade", requested=args.instrument, using="profile",
                 why="--theta/--live-events need phase events")
        args.instrument = "profile"

    made_group = _join_group(device)
    governor = Governor(policy=policy_for_theta(args.theta))
    bus = instrument.get_event_bus()
    loader = None
    try:
        world = dist.get_world_size()
        if args.instrument != "off":
            instrument.set_mode(args.instrument)
            if args.live_events:
                instrument.enable_events(True)
            if args.instrument == "profile":
                bus.subscribe(governor)
            if args.ingest == "batched":
                instrument.set_ingest_mode("batched")
        if args.live_events or world > 1:
            instrument.warm_up(device)     # communicator setup is not a step's slack
        state = init_state(cfg, opt_cfg, torch.Generator(device=device).manual_seed(args.seed),
                           device)
        n_params = sum(p.numel() for p in leaves(state["params"]))
        if args.live_events:
            step_fn, kind = build_live(cfg, opt_cfg), "build_live"
        elif world > 1:
            step_fn, kind = make_pod_train_step(cfg, opt_cfg, None, TrainConfig()), "pod"
        else:
            step_fn, kind = make_train_step(cfg, opt_cfg), "build"
        log.info("start", arch=cfg.name, params=n_params, device=str(device), world=world,
                 step=kind, batch=args.batch, seq=args.seq, instrument=args.instrument)
        loader = DataLoader(cfg, batch=args.batch, seq_len=args.seq, seed=args.seed,
                            device=device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        losses: List[float] = []
        grad_norms: List[float] = []
        lrs: List[float] = []
        step_s: List[float] = []
        t_start = time.time()
        for step in range(1, args.steps + 1):
            batch = next(loader)
            _sync(device)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            _sync(device)
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            grad_norms.append(float(metrics["grad_norm"]))
            lrs.append(float(metrics["lr"]))
            if step % max(1, args.steps // 20) == 0 or step == args.steps:
                log.info("step", step=step, loss=losses[-1], grad_norm=grad_norms[-1],
                         lr=lrs[-1], s_per_step=(time.time() - t_start) / step)
        if args.ingest == "batched":
            # drain the partial accumulator while the governor is subscribed
            instrument.flush_events()
            instrument.set_ingest_mode("event")
        report = None
        if args.instrument == "profile":
            rep = governor.finalize()
            report = rep.to_dict()
            log.info("governor", calls=rep.n_calls, downshifts=rep.n_downshifts,
                     slack_s=rep.total_slack, exploited_s=rep.exploited_slack,
                     overlap_s=rep.total_overlap, energy_saving_pct=rep.energy_saving_pct,
                     stragglers=rep.stragglers)
            if governor.tuner is not None:
                thetas = sorted(governor.tuner.summary().values())
                if thetas:
                    log.info("theta_auto", decisions=rep.n_theta_decisions,
                             sites=len(thetas), theta_lo_us=thetas[0] * 1e6,
                             theta_hi_us=thetas[-1] * 1e6)
                else:
                    log.info("theta_auto", sites=0)
        after_first = step_s[1:] or step_s
        step_median = float(np.median(after_first))
        return {
            "arch": cfg.name, "device": str(device), "world": world, "step": kind,
            "params": n_params, "param_leaves": len(leaves(state["params"])),
            "batch": args.batch, "seq": args.seq, "steps": args.steps,
            "losses": losses, "grad_norms": grad_norms, "lrs": lrs, "step_s": step_s,
            "step_s_median": step_median,
            "tokens_per_s": args.batch * args.seq / step_median,
            "peak_mem_bytes": (torch.cuda.max_memory_allocated(device)
                               if device.type == "cuda" else None),
            "governor": report,
        }
    finally:
        if loader is not None:
            loader.close()
        instrument.set_mode("off")
        instrument.enable_events(False)
        bus.unsubscribe(governor)
        if made_group:
            dist.destroy_process_group()


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = parser().parse_args(argv)
    obslog.configure_from_args(args)
    res = run(args)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
