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

  # telemetry: a replayable governor trace, a Perfetto trace, metrics
  # snapshots, the dashboard and a power-capped tenant, over the live step
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 4 \\
      --device cpu --live-events --trace-out trace.jsonl \\
      --perfetto-out train.json --metrics-out metrics.jsonl --dashboard \\
      --power-cap 300

  # restart after failure: saves every 5 steps, rank 3 fails at step 12,
  # the 3 survivors restore step 10 and finish (4 gloo ranks on the CPU)
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --reduced --steps 20 --batch 12 --seq 32 --device cpu \\
      --checkpoint-dir ckpt --save-every 5 --fail-at 12

  # resume from the newest checkpoint in a directory
  PYTHONPATH=src python -m repro_torch.launch.train --steps 16 \\
      --checkpoint-dir ckpt --save-every 4 --resume

The defaults are the reference's (``repro.launch.train``): countdown-100m,
batch 8, sequence 128, remat on, and AdamW warming up over
``min(100, steps // 10 + 1)`` steps and decaying to ``steps``.  Weights are
random, drawn from ``--seed``; the batches are the reference's synthetic
corpus for the same seed.  Without ``--live-events`` a world of 1 runs
``make_train_step`` on plain tensors, and a larger world the reference's
:func:`build`: parameters and optimizer state 2-D sharded as DTensors over
the ranks' ``(data, model)`` mesh (FSDP over ``data``, tensor parallelism
over ``model``, ``--model-parallel`` the largest degree that divides the
world), batches split over ``data``, the activation hooks installed, and
``make_train_step`` run on them, its collectives DTensor's;
``--live-events`` runs :func:`build_live`, whose gradients *and* loss
reduce through ``cd_psum`` (two instrumented calls a step) with host phase
events on, so the governor prices them; it is data-parallel only, so it
takes ``--model-parallel 1`` (the reference's warning when another is
given).  The process group comes from ``torchrun``'s environment
when it is set, else it is a world of 1 (NCCL on the card, gloo on the
CPU).  ``--trace-out``, ``--perfetto-out``, ``--metrics-out``,
``--dashboard`` and ``--power-cap`` wire as the reference's (each turns on
profile mode; the tenant's watts are ``core.pstate.DEFAULT_HW``'s model,
not the card's draw).

Restart after failure is the reference's mesh-epoch loop.
``--checkpoint-dir`` keeps the newest 3 checkpoints (the first rank of the
group writes them, in the reference's layout and file format:
:mod:`repro_torch.bridge`, :mod:`repro_torch.dist.checkpoint`), one after
each multiple of ``--save-every`` steps; ``--resume`` starts from the
newest.  ``--fail-at N`` fails the last rank before step N + 1: every rank
drains, marks it failed, restores the newest checkpoint (or initialises
from ``--seed`` when there is none), rebuilds the group and the mesh from
the survivors (:class:`repro_torch.dist.elastic.ElasticMesh`) and the step
over them, re-sharding the restored state onto the new mesh, and
rewinds; the failed rank takes no further step and leaves once the group
is rebuilt (the injector fails the last rank, never the first, which
holds the store of a world started without ``torchrun``).  A
failure without ``--checkpoint-dir`` raises, and so does one in a world of
1 (no survivor to rebuild from), as the reference's do.  Kept for parity
with the reference: after a failure the loader runs on, so the rewound
steps take the stream's next batches; ``--resume`` starts a fresh loader
from ``--seed``.  A batch the survivors' count does not divide is
replicated over ``data`` on the sharded path, as the reference's
sanitized specs allow; ``--live-events`` splits it with
:func:`repro_torch.train.loop.shard_of` and refuses it at the rebuild.
Logs the reference's ``step``, ``device_failed``, ``resumed``,
``governor`` and ``power`` lines; the last line of output is the run's
result as one JSON object.
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

from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.core import instrument
from repro_torch.core.governor import Governor
from repro_torch.core.policies import policy_for_theta
from repro_torch.device import join_group, resolve_device
from repro_torch.dist import sharding as SH
from repro_torch.dist.checkpoint import CheckpointManager
from repro_torch.dist.elastic import ElasticMesh, FailureInjector
from repro_torch.models.hooks import install_constraint
from repro_torch.obs import log as obslog
from repro_torch.train.data import DataLoader
from repro_torch.train.loop import _div, _grads, init_state, make_train_step, shard_of
from repro_torch.train.optimizer import OptConfig, adamw_update, decay_mask
from repro_torch.tree import leaves, tree_map

log = obslog.get_logger("train")


def build(mesh, cfg, opt_cfg: OptConfig, state: Dict[str, Any]):
    """The reference's ``build``: the activation hooks installed for
    ``mesh`` (a ``DeviceMesh``), the state distributed onto
    ``param_shardings`` and ``opt_state_shardings`` (2-D: FSDP over
    ``data``, tensor parallelism over ``model``), and ``make_train_step``
    over DTensors, plain tensors meeting them taken as replicated, the
    metrics whole on every rank.  Returns (state, step)."""
    install_constraint(SH.activation_constraint_fn(mesh))
    ps = SH.param_shardings(mesh, state["params"])
    sh = {"params": ps, "opt": SH.opt_state_shardings(mesh, ps, state["opt"])}
    state = SH.distribute(state, sh)
    train_step = make_train_step(cfg, opt_cfg)

    def step(state: Dict[str, Any], batch: Dict[str, Any]):
        with SH.replicating(mesh):
            state, metrics = train_step(state, batch)
        return state, {k: SH.whole(v) for k, v in metrics.items()}

    return state, step


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
    ap.add_argument("--trace-out", default="",
                    help="record the governor's event stream to this JSONL file "
                         "(replayable via repro_torch.cluster.trace)")
    ap.add_argument("--power-cap", type=float, default=0.0,
                    help="job power cap in watts: a cluster.GovernorJob tenant "
                         "books each logged step's modelled draw against it "
                         "(core.pstate.DEFAULT_HW's watts, not the card's)")
    ap.add_argument("--perfetto-out", default="",
                    help="write a Chrome-trace/Perfetto JSON of the run")
    ap.add_argument("--metrics-out", default="",
                    help="write metrics-registry snapshots (with the exact "
                         "cumulative GovernorReport) to this JSONL file")
    ap.add_argument("--dashboard", action="store_true",
                    help="render the telemetry dashboard at each logged step")
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


def _device(args) -> torch.device:
    if args.device is None and "LOCAL_RANK" in os.environ:
        return resolve_device(f"cuda:{int(os.environ['LOCAL_RANK'])}")
    return resolve_device(args.device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> Dict[str, Any]:
    """Train ``args.steps`` steps; returns the run's numbers (losses, grad
    norms, learning rates, synchronised step clocks, tokens/s, peak device
    memory and the governor's report)."""
    device = _device(args)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, remat=True)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
                        total_steps=args.steps)
    obs_on = bool(args.perfetto_out or args.metrics_out or args.dashboard)
    if args.live_events and args.model_parallel != 1:
        log.warning("live_events_dp_only", model_parallel=args.model_parallel, using=1)
        args.model_parallel = 1
    if (args.trace_out or args.power_cap > 0 or args.theta or obs_on
            or args.live_events) and args.instrument != "profile":
        # the recorder records events, the tenant polls interval snapshots,
        # the telemetry consumes both, and the governor prices them: all
        # empty without profile mode's phase events
        log.info("instrument_upgrade", requested=args.instrument, using="profile",
                 why="--trace-out/--power-cap/--theta/--live-events/telemetry "
                     "need phase events")
        args.instrument = "profile"

    recorder = trace_rec = None
    if args.trace_out:
        from repro_torch.cluster.trace import TraceRecorder

        recorder = trace_rec = TraceRecorder(meta={"driver": "train", "arch": args.arch,
                                                   "steps": args.steps,
                                                   "theta": args.theta or "default"})
    registry = tracer = collector = writer = dash = None
    if obs_on:
        from repro_torch.obs.export import ConsoleDashboard, MetricsJsonlWriter
        from repro_torch.obs.metrics import BusMetrics, GovernorCollector, MetricsRegistry
        from repro_torch.obs.tracer import GovernorTap, RecorderFanout, SpanTracer

        registry = MetricsRegistry()
        busmetrics = BusMetrics(registry)
        if args.perfetto_out:
            tracer = SpanTracer(meta={"driver": "train", "arch": args.arch,
                                      "steps": args.steps})
        # the telemetry rides the governor's recorder slot (retired
        # occurrences and theta decisions), never the per-event bus
        tap = GovernorTap(tracer, metrics=busmetrics)
        recorder = RecorderFanout([recorder, tap]) if recorder is not None else tap
    made_group = join_group(device)
    governor = Governor(policy=policy_for_theta(args.theta), recorder=recorder)
    bus = instrument.get_event_bus()
    loader = None
    try:
        world = dist.get_world_size()
        if registry is not None:
            collector = GovernorCollector(registry, governor)
            if args.ingest == "batched":
                from repro_torch.obs.metrics import IngestMetrics

                IngestMetrics(registry, bus)
            if args.metrics_out:
                writer = MetricsJsonlWriter(args.metrics_out, registry, collector)
            if args.dashboard:
                # the power rows show the tenant's modelled watts, not the card's
                title = f"train {args.arch}" + (
                    " (power: modelled, core.pstate.DEFAULT_HW)" if args.power_cap > 0
                    else "")
                dash = ConsoleDashboard(registry, title=title)
        tenant = None
        if args.power_cap > 0:
            from repro_torch.cluster.job import GovernorJob

            tenant = GovernorJob("train", governor, n_ranks=world, cap_w=args.power_cap)
            if registry is not None:
                tenant.attach_obs(registry, tracer, clock=time.monotonic)
        if args.instrument != "off":
            instrument.set_mode(args.instrument)
            if args.live_events:
                instrument.enable_events(True)
            if args.instrument == "profile":
                bus.subscribe(governor)
            if args.ingest == "batched":
                instrument.set_ingest_mode("batched")
        rank = dist.get_rank()
        em = ElasticMesh(axis_names=("data", "model"))
        mesh = em.build(model_parallel=args.model_parallel)
        injector = FailureInjector(fail_at_steps=[args.fail_at] if args.fail_at else [],
                                   device_ids=[world - 1])
        mgr = CheckpointManager(args.checkpoint_dir, keep=3) if args.checkpoint_dir else None

        def fresh_state():
            return init_state(cfg, opt_cfg,
                              torch.Generator(device=device).manual_seed(args.seed), device)

        def restore(step: int, like: Dict[str, Any]) -> Dict[str, Any]:
            # the file holds the reference's stacked layout: read it into a
            # skeleton of whole tensors, back to the split layout, and the
            # caller's step distributes it onto the current mesh
            whole = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), like)
            tree = mgr.load(step, bridge.state_to_numpy(cfg, whole))
            return bridge.state_from_numpy(cfg, tree, device)

        def make_step(rm, state):
            """(step, its kind, the state as the step takes it: plain
            tensors in, DTensors out on the sharded path) on the rank mesh
            ``rm``."""
            if args.live_events or world > 1:
                # communicator setup is not a step's slack
                instrument.warm_up(device, rm.group)
            if args.live_events:
                return build_live(cfg, opt_cfg, rm.group), "build_live", state
            if world > 1:
                state, step_fn = build(rm.device_mesh, cfg, opt_cfg, state)
                loader.sharding = SH.batch_shardings(rm.device_mesh, loader.like())
                return step_fn, "build", state
            return make_train_step(cfg, opt_cfg), "build", state

        state = fresh_state()
        start_step = 0
        if mgr and args.resume:
            latest = mgr.latest_step()
            if latest is not None:
                start_step, state = latest, restore(latest, state)
                log.info("resumed", step=latest)
        n_params = sum(p.numel() for p in leaves(state["params"]))
        loader = DataLoader(cfg, batch=args.batch, seq_len=args.seq, seed=args.seed,
                            device=device)
        step_fn, kind, state = make_step(mesh, state)
        log.info("start", arch=cfg.name, params=n_params, device=str(device), world=world,
                 step=kind, batch=args.batch, seq=args.seq, instrument=args.instrument,
                 start_step=start_step, mesh=list(mesh.layout.shape))
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        losses: List[float] = []
        grad_norms: List[float] = []
        lrs: List[float] = []
        step_s: List[float] = []
        power: List[Dict[str, Any]] = []
        restarts: List[Dict[str, int]] = []
        checkpoint_steps: List[int] = []
        t_start = time.time()
        step = start_step
        # mesh-epoch loop: each epoch runs over one group; a failure breaks
        # out, restores the latest checkpoint and rebuilds the group from the
        # surviving ranks
        while step < args.steps and rank not in em.failed_ids():
            failed = None
            while step < args.steps:
                failed = injector.check(step)
                if failed is not None:
                    break
                batch = next(loader)
                _sync(device)
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                _sync(device)
                step_s.append(time.perf_counter() - t0)
                step += 1
                losses.append(float(metrics["loss"]))
                grad_norms.append(float(metrics["grad_norm"]))
                lrs.append(float(metrics["lr"]))
                if mgr and step % args.save_every == 0:
                    # whole tensors on this thread (a collective over the
                    # mesh when the state is sharded); the first rank writes
                    whole = SH.gather(state)
                    if rank == mesh.ranks[0]:
                        mgr.save(step, bridge.state_to_numpy(cfg, whole))
                    del whole
                    checkpoint_steps.append(step)
                if step % max(1, args.steps // 20) != 0 and step != args.steps:
                    continue
                log.info("step", step=step, loss=losses[-1], grad_norm=grad_norms[-1],
                         lr=lrs[-1], s_per_step=(time.time() - t_start) / len(step_s))
                stats = collector.collect() if collector is not None else None
                if tenant is not None:
                    # the collector's poll is handed over: the governor keeps
                    # one snapshot mark, so tenant and collector share one
                    # interval stream
                    er = tenant.run_epoch(args.power_cap, stats=stats)
                    power.append(dataclasses.asdict(er))
                    log.info("power", cap_w=er.cap_w, modelled_draw_w=er.power_w,
                             exploited_pct=100 * er.exploited_ratio, phases=er.n_calls)
                if tracer is not None and stats is not None:
                    tnow = time.monotonic()
                    busy = max(stats.busy, 1e-30)
                    tracer.sample("governor", "slack_ratio_pct", tnow,
                                  100.0 * stats.slack / busy)
                    tracer.sample("governor", "overlap_ratio_pct", tnow,
                                  100.0 * stats.overlap / busy)
                    saving = registry.get_value("governor_energy_saving_pct")
                    tracer.sample("governor", "energy_saving_pct", tnow, saving or 0.0)
                if writer is not None:
                    writer.write(step=step)
                if dash is not None:
                    dash.tick(step=step)
            if failed is None:
                break
            log.warning("device_failed", step=step, device=failed, action="re-meshing")
            _sync(device)                           # drain in-flight work
            em.fail(failed)
            if mgr is None:
                raise RuntimeError("node failure without checkpointing enabled")
            if world > 1:
                dist.barrier(group=mesh.group)      # the writer's last save is on disk
            latest = mgr.latest_step()
            if latest is None:
                # failed before the first checkpoint: cold restart from init
                latest, state = 0, fresh_state()
            else:
                state = restore(latest, state)
            mesh = em.build(model_parallel=args.model_parallel)
            if args.live_events and args.batch % len(mesh.ranks):
                # every rank stops here together (shard_of would stop only the survivors)
                raise ValueError(f"--batch {args.batch} does not divide over the "
                                 f"{len(mesh.ranks)} surviving ranks")
            restarts.append({"step": step, "failed_rank": failed, "restored_step": latest,
                             "survivors": len(mesh.ranks)})
            if rank in em.failed_ids():
                # the rebuild was the last call every rank makes together
                log.info("failed", rank=rank, step=step, action="leaving")
                break
            step_fn, kind, state = make_step(mesh, state)
            step = latest
            log.info("resumed", devices=len(em.healthy_devices()), step=latest)
        if world > 1 and rank in mesh.ranks:
            dist.barrier(group=mesh.group)      # the writer's last save is on disk
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
        outputs: Dict[str, Any] = {}
        if tenant is not None:
            log.info("power_total", modelled_energy_j=tenant.total_energy_j,
                     wall_s=tenant.total_wall_s, cap_commits=len(tenant.actuator.commits),
                     suppressed=tenant.actuator.n_suppressed)
            # core.pstate.DEFAULT_HW's CPU-node model, not the card's draw
            outputs["power"] = {"watts": "modelled (core.pstate.DEFAULT_HW), not the card's",
                                "epochs": power, "energy_j": tenant.total_energy_j,
                                "wall_s": tenant.total_wall_s}
        if writer is not None:
            # one terminal snapshot: its embedded report is the run's final one
            writer.write(step=args.steps)
            writer.close()
            log.info("metrics_out", path=args.metrics_out, lines=writer.n_lines)
            outputs.update(metrics_out=args.metrics_out, metrics_lines=writer.n_lines)
        if dash is not None:
            dash.tick(step=args.steps)
            outputs["dashboard_frames"] = dash.n_renders
        if tracer is not None:
            tracer.ingest_governor(governor)    # spine-log actuations, once
            path = tracer.save(args.perfetto_out)
            log.info("perfetto_out", path=path, events=tracer.n_seen,
                     dropped=tracer.n_dropped)
            outputs.update(perfetto_out=path, perfetto_events=tracer.n_seen,
                           perfetto_dropped=tracer.n_dropped)
        if trace_rec is not None:
            trace_rec.meta["report"] = report
            path = trace_rec.save(args.trace_out)
            log.info("trace_out", records=trace_rec.n_seen, dropped=trace_rec.n_dropped,
                     path=path)
            outputs.update(trace_out=path, trace_records=trace_rec.n_seen,
                           trace_dropped=trace_rec.n_dropped)
        after_first = step_s[1:] or step_s
        step_median = float(np.median(after_first)) if after_first else float("nan")
        return {
            "arch": cfg.name, "device": str(device), "world": world, "rank": rank,
            "step": kind, "mesh": list(mesh.layout.shape), "params": n_params,
            "param_leaves": len(leaves(state["params"])),
            "batch": args.batch, "seq": args.seq, "steps": args.steps,
            "start_step": start_step, "restarts": restarts,
            "checkpoint_steps": checkpoint_steps,
            "losses": losses, "grad_norms": grad_norms, "lrs": lrs, "step_s": step_s,
            "step_s_median": step_median,
            "tokens_per_s": args.batch * args.seq / step_median,
            "peak_mem_bytes": (torch.cuda.max_memory_allocated(device)
                               if device.type == "cuda" else None),
            "governor": report, **outputs,
        }
    finally:
        if loader is not None:
            loader.close()
        install_constraint(None)
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
