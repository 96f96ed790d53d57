"""Serving entry point of the port: static batch, continuous batching or a
replica fleet, with the governor's report and the reference's telemetry
outputs.

  # on the card, through the hand-written kernels (the default there)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --continuous --n-requests 16 --prompt-len 128 --steps 32 --slots 8 \\
      --page-size 16

  # the hybrid family, with one more request whose 2032-token prompt
  # decodes past the 2048-token attention window
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
      --continuous --n-requests 12 --prompt-len 128 --steps 32 --slots 8 \\
      --page-size 16 --long-prompt 2032

  # the SSM family (attention-free mamba2-130m), with one 2000-token
  # prompt that the SSD scan takes in 16 chunks, the last one ragged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
      --continuous --n-requests 12 --prompt-len 128 --steps 32 --slots 8 \\
      --page-size 16 --long-prompt 2000

  # greedy decoding instead of the reference's default temperature of 0.8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --continuous --temperature 0

  # MoE at full width and depth: capacity routing at each join, dropless
  # decode over all 40 experts
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite-moe-3b-a800m --continuous --n-requests 16 \\
      --prompt-len 128 --steps 32 --slots 8 --page-size 16

  # a frontend arch: each request carries its 256 prefix embeddings
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-1b \\
      --continuous --n-requests 4 --prompt-len 128 --steps 16 --slots 8 \\
      --page-size 16

  # mixtral-8x22b at full width, cut to 2 of its 56 layers to fit one card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \\
      --continuous --n-layers 2 --n-requests 4 --prompt-len 128 --steps 16

  # a small model on the CPU, plain PyTorch (the default there)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --reduced --continuous --device cpu

  # telemetry: a replayable governor trace, a Perfetto trace, metrics
  # snapshots, the dashboard, and a power-capped tenant
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --reduced --continuous --device cpu --trace-out trace.jsonl \\
      --perfetto-out serve.json --metrics-out metrics.jsonl --dashboard \\
      --power-cap 300

  # the legacy static batch: one prefill, --steps decode steps for all
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --reduced --batch 4 --prompt-len 32 --steps 16 --device cpu

  # replica fleet on the card: N real engines sharing one copy of the
  # weights behind the prefix-aware router, watt arbitration per epoch
  # (wall clock); add --autoscale for the deterministic virtual-clock
  # fleet with SLO-driven membership (no model, host only)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --fleet 2 --fleet-trace flash-crowd --fleet-duration 3 \\
      [--autoscale] [--metrics-out fleet.jsonl]

  # the same on the CPU, at a reduced size
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --reduced --device cpu --fleet 2 --fleet-trace flash-crowd \\
      --fleet-duration 3 [--autoscale] [--metrics-out fleet.jsonl]

  # tensor-parallel serving over torchrun's ranks: a (data, model) mesh of
  # (N // k, k), weights and pool split over 'model' (gloo on the CPU)
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
      --reduced --continuous --device cpu --model-parallel 2 --temperature 0

  # data-parallel serving: a (2, 1) mesh, each rank decoding 2 of the 4 slots
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
      --reduced --continuous --device cpu --slots 4 --temperature 0

  # a replica fleet over the same mesh: every replica on the sharded weights
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
      --reduced --device cpu --model-parallel 2 --fleet 2 --fleet-duration 3

The static, continuous and fleet modes of ``repro.launch.serve`` are
ported, with the continuous mode's ``--trace-out``, ``--perfetto-out``,
``--metrics-out``, ``--dashboard``, ``--power-cap``, ``--tpot-target`` and
``--ingest``, and the reference's mesh block: under ``torchrun`` the world
of N ranks is a ``(N // mp, mp)`` ``DeviceMesh`` of ``("data", "model")``,
``mp`` the largest divisor of N at most ``--model-parallel``; when ``mp >
1`` or N > 1 the weights are DTensors on ``serve_param_shardings`` and the
continuous engine's pool on ``page_pool_shardings``, both on the rank's
row of the ``model`` axis, the activation hooks are installed, and the
static and continuous modes run sharded: each rank runs the kernels on its
local shards, and each data rank decodes its own span of the slots (of the
static ``--batch``), as the reference's batch constraint splits them,
where N // mp divides them (otherwise every rank decodes the whole batch);
every rank takes the first rank's clock.  ``--fleet`` runs on the mesh as
the reference's does: every replica an engine on the one copy of the
sharded weights, its slots split over the data ranks alike, every rank the
same fleet on the first rank's clock; ``--fleet --autoscale`` (no model)
runs the same simulation on every rank.  One rank with
``--model-parallel 1`` wraps nothing, and only the first rank prints the
result.
``--power-cap`` and the fleet's watts are those of
``core.pstate.DEFAULT_HW``'s CPU-node model, not the card's draw; the
result says so.  The fleet's traces draw tokens below ``min(1000,
vocab)``: the reference's draw below 1000 whatever the vocabulary
(``fleet_trace``).  ``--n-layers`` is the port's own: it cuts the
depth and keeps every width.  Weights are random, drawn from ``--seed``.  Tokens
are drawn at ``--temperature`` (0.8 by default, as the reference's) with
the reference's ``jax.random`` keys and draws (``repro_torch.jrandom``); the
static batch samples with the key ``key(1)``, as the reference's
``PRNGKey(1)``.  One warm-up generate runs before the clock starts (it
also builds the CUDA kernel on first use); its time is reported as
``warmup_s``.  The last line of output is the run's result as one JSON
object.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import jrandom
from repro_torch.configs import get_config, reduced
from repro_torch.core.events import EventBus
from repro_torch.core.governor import Governor
from repro_torch.core.policies import policy_for_theta
from repro_torch.device import join_group, resolve_device
from repro_torch.dist import sharding as SH
from repro_torch.models.hooks import install_constraint
from repro_torch.models.inputs import make_batch
from repro_torch.models.transformer import init_params
from repro_torch.obs import log as obslog
from repro_torch.serve.engine import ContinuousEngine, ServeEngine
from repro_torch.serve.scheduler import Request, poisson_arrivals
from repro_torch.serve.slo import SLOTracker

log = obslog.get_logger("serve")
# the label of every watt figure in a result: the cluster layer's watts come
# from core.pstate.DEFAULT_HW, a CPU-node model from the paper
MODELLED = "modelled (core.pstate.DEFAULT_HW), not the card's"


def _make_requests(args, cfg) -> List[Request]:
    """``--n-requests`` Poisson arrivals with ``--prompt-len`` prompts and
    ``--steps // 2 .. --steps`` new tokens; with ``--long-prompt N``, one
    more request of an N-token prompt and ``--steps`` new tokens, arriving
    with the first.  With a temperature, request ``i`` samples with the key
    ``fold_in(key(--seed), i)``, as the reference's, and the long one with
    ``fold_in(key(--seed), --n-requests)``.  A frontend arch's request gets
    ``prefix_embeds``, normal(0, 0.02) of shape (n_prefix, d), drawn right
    after its new-token count as the reference draws them, so the streams
    stay equal."""
    rng = np.random.default_rng(args.seed)
    arrivals = poisson_arrivals(args.n_requests, args.arrival_rate, seed=args.seed,
                                burst_every=max(args.slots, 2), burst_gap=0.05)
    base = jrandom.key(args.seed) if args.temperature > 0 else None

    def key(i):
        return None if base is None else jrandom.fold_in(base, i)

    reqs = []
    for i in range(args.n_requests):
        prompt = rng.integers(0, cfg.vocab, size=args.prompt_len).astype(np.int32)
        max_new = int(rng.integers(max(2, args.steps // 2), args.steps + 1))
        reqs.append(Request(prompt=prompt, max_new=max_new, arrival=float(arrivals[i]),
                            key=key(i), prefix_embeds=prefix_embeds(rng, cfg)))
    if args.long_prompt:
        prompt = rng.integers(0, cfg.vocab, size=args.long_prompt).astype(np.int32)
        reqs.append(Request(prompt=prompt, max_new=args.steps, arrival=float(arrivals[0]),
                            key=key(args.n_requests), prefix_embeds=prefix_embeds(rng, cfg)))
    return reqs


def prefix_embeds(rng: np.random.Generator, cfg) -> Optional[np.ndarray]:
    """A frontend arch's stub prefix, (n_prefix, d) fp32; None without one."""
    if not cfg.n_prefix:
        return None
    return rng.normal(0, 0.02, size=(cfg.n_prefix, cfg.d_model)).astype(np.float32)


def _config(args):
    """The run's arch config, cut and quantised as the flags say."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    if args.kv_int8:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    return cfg


def _device(args) -> torch.device:
    """``--device``, or under ``torchrun`` on the card this rank's card."""
    if args.device is None and "LOCAL_RANK" in os.environ:
        return resolve_device(f"cuda:{int(os.environ['LOCAL_RANK'])}")
    return resolve_device(args.device)


def serve_mesh(args):
    """The reference's mesh block: N ranks (the process group's, else 1),
    the model degree ``mp`` the largest divisor of N at most
    ``--model-parallel``, a ``(N // mp, mp)`` ``("data", "model")`` mesh
    with the activation hooks installed for the DTensors of this rank's row
    (its model axis, :func:`~repro_torch.dist.sharding.replica_mesh`); the
    engines split their slots over the data axis themselves.  None when N
    and ``mp`` are both 1: nothing is wrapped."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    mp = max(g for g in range(1, args.model_parallel + 1) if n % g == 0)
    if n == 1 and mp == 1:
        return None
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(_device(args).type, (n // mp, mp),
                            mesh_dim_names=("data", "model"))
    install_constraint(SH.activation_constraint_fn(SH.replica_mesh(mesh)))
    return mesh


def _model(args, mesh=None):
    """(device, config, random weights from ``--seed``) for the run; on a
    mesh the weights are DTensors on ``serve_param_shardings`` over this
    rank's row of the model axis (every rank draws the same weights and
    keeps its slice)."""
    device = _device(args)
    cfg = _config(args)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    if mesh is not None:
        replica = SH.replica_mesh(mesh)
        params = SH.distribute(params, SH.serve_param_shardings(replica, params))
    return device, cfg, params


def run_static(args) -> Dict[str, Any]:
    """The reference's static batch: ``make_batch(kind="prefill")`` of
    ``--batch`` prompts of ``--prompt-len`` positions, ``--steps`` tokens
    each through :class:`ServeEngine`, sampled with ``key(1)``; one
    warm-up generate, then the timed one.  On a mesh each data rank runs
    its rows of the batch.  Returns the run's numbers and its tokens, with
    the engine and the weights under ``"objects"``."""
    device, cfg, params = _model(args, args.mesh)
    eng = ServeEngine(cfg, params, max_len=args.prompt_len + args.steps + 8,
                      temperature=args.temperature, device=device, serve_mesh=args.mesh)
    batch = make_batch(cfg, batch=args.batch, seq_len=args.prompt_len, kind="prefill")
    t0 = time.time()
    eng.generate(batch, n_steps=args.steps, key=jrandom.key(1)).cpu()
    t_warm = time.time() - t0
    t0 = time.time()
    out = eng.generate(batch, n_steps=args.steps, key=jrandom.key(1)).cpu()
    dt = time.time() - t0
    return {
        "mode": "static", "arch": cfg.name, "n_layers": cfg.n_layers, "device": str(device),
        "temperature": args.temperature, "shape": list(out.shape), "wall_s": dt,
        "tok_per_s": args.batch * args.steps / dt, "warmup_s": t_warm,
        "kv_int8": args.kv_int8, "tokens": out.tolist(),
        "data_ranks": SH.slot_split(args.mesh, args.batch).size,
        "objects": {"engine": eng, "params": params},
    }


def run_continuous(args, subscribers: Sequence[Any] = ()) -> Dict[str, Any]:
    """Serve ``args.n_requests`` Poisson requests; returns the run's numbers
    together with the engine, governor and report under ``"objects"``.
    ``subscribers`` join the governor on the serve loop's event bus (a
    phase recorder, an :class:`~repro_torch.core.profiler.EventProfiler`).
    The telemetry flags wire as the reference's: the trace recorder, the
    span tracer and the bus metrics ride the governor's recorder slot.  On
    a mesh the pool is put on ``page_pool_shardings`` and the slots are
    split over the data ranks."""
    device, cfg, params = _model(args, args.mesh)
    max_len = (max(args.prompt_len, args.long_prompt) + cfg.n_prefix + args.steps
               + args.page_size)
    max_len += (-max_len) % args.page_size
    eng = ContinuousEngine(cfg, params, n_slots=args.slots, max_len=max_len,
                           page=args.page_size, temperature=args.temperature,
                           attn_kernel=args.attn_kernel, device=device, serve_mesh=args.mesh)
    if args.mesh is not None:
        eng.pool.blocks = SH.distribute(
            eng.pool.blocks, SH.page_pool_shardings(eng.mesh, eng.pool.blocks))
    warm_rng = np.random.default_rng(args.seed + 1)
    warm = {"tokens": warm_rng.integers(0, cfg.vocab, size=(1, args.prompt_len)).astype(np.int32)}
    if cfg.n_prefix:
        warm["prefix_embeds"] = prefix_embeds(warm_rng, cfg)[None]
    t0 = time.time()
    eng.generate(warm, n_steps=2)
    t_warm = time.time() - t0

    recorder = trace_rec = None
    if args.trace_out:
        from repro_torch.cluster.trace import TraceRecorder

        recorder = trace_rec = TraceRecorder(
            meta={"driver": "serve", "arch": args.arch,
                  "n_requests": args.n_requests,
                  "theta": args.theta or "default"})

    registry = tracer = collector = writer = dash = None
    if args.perfetto_out or args.metrics_out or args.dashboard:
        from repro_torch.obs.export import ConsoleDashboard, MetricsJsonlWriter
        from repro_torch.obs.metrics import BusMetrics, GovernorCollector, MetricsRegistry
        from repro_torch.obs.tracer import GovernorTap, RecorderFanout, SpanTracer

        registry = MetricsRegistry()
        busmetrics = BusMetrics(registry)
        if args.perfetto_out:
            tracer = SpanTracer(meta={"driver": "serve", "arch": args.arch,
                                      "n_requests": args.n_requests})
            eng.tracer = tracer
        # metrics and tracer ride the governor's recorder slot (ingested
        # phases, retired occurrences, theta decisions): exactly one phase
        # source each, never a second bus subscription, or every phase
        # would count twice
        tap = GovernorTap(tracer, metrics=busmetrics)
        recorder = RecorderFanout([recorder, tap]) if recorder is not None else tap

    gov = Governor(policy=policy_for_theta(args.theta), recorder=recorder)
    # the engine publishes decode phases onto a bus, not into a governor:
    # the governor is just the first subscriber
    bus = EventBus()
    bus.subscribe(gov)
    for sub in subscribers:
        bus.subscribe(sub)
    if args.ingest == "batched":
        from repro_torch.core import instrument

        instrument.set_ingest_mode("batched")
    if registry is not None:
        collector = GovernorCollector(registry, gov)
        if args.ingest == "batched":
            from repro_torch.obs.metrics import IngestMetrics

            IngestMetrics(registry, bus)
        if args.metrics_out:
            writer = MetricsJsonlWriter(args.metrics_out, registry, collector)
        if args.dashboard:
            # the power rows show the tenant's modelled watts, not the card's
            title = f"serve {args.arch}" + (
                " (power: modelled, core.pstate.DEFAULT_HW)" if args.power_cap > 0 else "")
            dash = ConsoleDashboard(registry, title=title)
    tenant = None
    if args.power_cap > 0:
        from repro_torch.cluster.job import ServeJob

        tenant = ServeJob("serve", eng, gov, cap_w=args.power_cap, n_ranks=1)
        if registry is not None:
            tenant.attach_obs(registry, tracer, clock=time.monotonic)
    slo = SLOTracker(tpot_target=args.tpot_target or None)
    if registry is not None:
        registry.add_collector(lambda: slo.export_metrics(registry))
    reqs = _make_requests(args, cfg)
    steps_before, joins_before = eng.n_decode_steps, eng.n_joins
    t0 = time.time()
    done = eng.serve(reqs, governor=bus, slo=slo)
    dt = time.time() - t0
    if args.ingest == "batched":
        from repro_torch.core import instrument

        instrument.flush_events()
        instrument.set_ingest_mode("event")
    rep = gov.finalize()
    sess = eng._last_session
    s = slo.summary()
    n_tok = sum(len(r.out) for r in done)
    outputs: Dict[str, Any] = {}
    if tracer is not None:
        tnow = time.monotonic()
        tracer.sample("slo", "ttft_p95_ms", tnow, s["ttft"]["p95"] * 1e3)
        tracer.sample("slo", "tpot_p95_ms", tnow, s["tpot"]["p95"] * 1e3)
    if tenant is not None:
        stats = collector.collect() if collector is not None else None
        er = tenant.run_epoch(args.power_cap, stats=stats)
        # the tenant's watts come from core.pstate.DEFAULT_HW, a CPU-node
        # model from the paper, and are not the card's draw
        outputs["power"] = {"watts": MODELLED,
                            **dataclasses.asdict(er), "fill": tenant.fill_fraction}
    if writer is not None:
        writer.write()
        writer.close()
        outputs.update(metrics_out=args.metrics_out, metrics_lines=writer.n_lines)
    if dash is not None:
        dash.tick()
        outputs["dashboard_frames"] = dash.n_renders
    if tracer is not None:
        tracer.ingest_governor(gov)         # spine-log actuations, once
        outputs.update(perfetto_out=tracer.save(args.perfetto_out),
                       perfetto_events=tracer.n_seen, perfetto_dropped=tracer.n_dropped)
    if trace_rec is not None:
        trace_rec.meta["report"] = rep.to_dict()
        outputs.update(trace_out=trace_rec.save(args.trace_out),
                       trace_records=trace_rec.n_seen, trace_dropped=trace_rec.n_dropped)
    return {
        "arch": cfg.name, "n_layers": cfg.n_layers, "device": str(device),
        "attn_kernel": eng.attn_kernel, "data_ranks": eng.split.size,
        "temperature": args.temperature, "policy": gov.policy.name,
        "requests": len(done), "tokens": n_tok, "wall_s": dt,
        "tok_per_s": n_tok / dt, "warmup_s": t_warm,
        "decode_steps": eng.n_decode_steps - steps_before,
        "joins": eng.n_joins - joins_before,
        "step_ms_p50": float(np.percentile(sess.step_seconds, 50)) * 1e3,
        "step_ms_max": float(np.max(sess.step_seconds)) * 1e3,
        "fill": eng._last_meter.fill_fraction,
        "priced_slack_ms": rep.total_slack * 1e3, "phases": rep.n_calls,
        "downshifts": rep.n_downshifts, "actuations": len(gov.actuation_log),
        "energy_saving_pct": rep.energy_saving_pct,
        "ttft_p95_ms": s["ttft"]["p95"] * 1e3, "tpot_p95_ms": s["tpot"]["p95"] * 1e3,
        "completed": s["completed"], **outputs,
        "objects": {"engine": eng, "governor": gov, "report": rep, "requests": done},
    }


def fleet_trace(args, cfg):
    """The reference's ``_fleet_trace`` with the arch's vocabulary passed:
    tokens are drawn below ``min(1000, cfg.vocab)``.  The reference's draw
    below 1000 whatever the vocabulary, so on a reduced config (512) its
    prompts index past the embedding table; for a full-size arch (2048 and
    more) the trace is the reference's."""
    from repro_torch.serve.fleet import diurnal_trace, flash_crowd_trace, session_reuse_trace

    vocab = min(1000, cfg.vocab)
    if args.fleet_trace == "diurnal":
        return diurnal_trace(duration_s=args.fleet_duration, vocab=vocab, seed=args.seed)
    if args.fleet_trace == "session-reuse":
        return session_reuse_trace(vocab=vocab, seed=args.seed)
    return flash_crowd_trace(duration_s=args.fleet_duration, vocab=vocab, seed=args.seed)


def _fleet_metrics_out(args, fill_registry) -> Dict[str, Any]:
    """Export fleet metrics (and validate-able snapshots) if asked; returns
    the output paths and counts for the result."""
    if not (args.metrics_out or args.dashboard):
        return {}
    from repro_torch.obs.export import ConsoleDashboard, MetricsJsonlWriter
    from repro_torch.obs.metrics import MetricsRegistry

    registry = MetricsRegistry()
    fill_registry(registry)
    outputs: Dict[str, Any] = {}
    if args.metrics_out:
        with MetricsJsonlWriter(args.metrics_out, registry) as writer:
            writer.write()
        outputs.update(metrics_out=args.metrics_out, metrics_lines=writer.n_lines)
    if args.dashboard:
        # the watt rows are the arbiter's modelled grants, not the card's
        dash = ConsoleDashboard(registry, title=f"fleet {args.arch} (power: {MODELLED})")
        dash.tick()
        outputs["dashboard_frames"] = dash.n_renders
    return outputs


def run_fleet_sim(args) -> Dict[str, Any]:
    """Deterministic virtual-clock fleet: membership changes allowed, so
    this is the ``--autoscale`` path (spawning a real engine mid-run would
    rebuild it; the sim replica warms up in ``warmup_s`` of virtual time).
    Runs no model and builds no weights: host only.  Returns the
    reference's ``fleet_done`` numbers, with the sim, its result and the
    trace under ``"objects"``."""
    from repro_torch.serve.fleet import FleetConfig, FleetSim

    cfg = _config(args)
    cap_w = args.power_cap if args.power_cap > 0 else 40.0
    fc = FleetConfig(cfg=cfg, n_replicas=args.fleet, autoscale=args.autoscale,
                     min_replicas=1, n_slots=args.slots, cap_w=cap_w, floor_w=4.0,
                     step_s=0.01, ttft_target=1.5)
    sim = FleetSim(fc)
    trace = fleet_trace(args, cfg)
    res = sim.run(trace)
    outputs = _fleet_metrics_out(args, sim.export_metrics)
    return {
        "mode": "fleet_sim", "arch": cfg.name, "n_layers": cfg.n_layers,
        "device": "none (virtual clock, no model)", "trace": trace.name,
        "autoscaled": args.autoscale, "requests": res.n_completed,
        "n_requests": res.n_requests, "tokens": res.tokens_out,
        "watts": MODELLED, "joules_per_token": res.joules_per_token,
        "ttft_attainment": res.ttft_attainment, "prefix_hit_rate": res.prefix_hit_rate,
        "peak_replicas": res.n_replicas_peak, "scale_ups": res.n_scale_ups,
        "scale_downs": res.n_scale_downs, "cap_w": res.cap_w,
        "max_alloc_sum_w": res.max_alloc_sum_w, **outputs,
        "objects": {"sim": sim, "result": res, "trace": trace},
    }


def run_fleet_real(args) -> Dict[str, Any]:
    """N real engines behind the router on the wall clock: fixed
    membership, per-epoch watt arbitration from each replica's governor.
    Every engine reads the same weight tensors (one copy on the device)
    and has its own pool, prefix cache, governor and SLO tracker; each
    gets the reference's warm-up generate (which also builds the kernels
    on first use).  Returns the reference's ``fleet_done`` numbers, each
    replica's decode-step p50 and decode path, with the engines, sessions,
    router, arbiter, the requests in trace order and in the order they
    finished, the trace and the weights under ``"objects"``.  On a mesh,
    as the reference's, every replica is an engine on the whole mesh's
    one copy of the weights (this rank's row of ``serve_param_shardings``),
    its pool on ``page_pool_shardings`` and its slots split over the data
    ranks; every rank runs the same fleet, its host decisions on the
    mesh's first rank's clock, and books the same tokens."""
    from repro_torch.serve.fleet import run_engine_fleet

    device, cfg, params = _model(args, args.mesh)
    trace = fleet_trace(args, cfg)
    reqs = trace.fresh_requests()
    longest = max(len(r.prompt) + r.max_new for r in reqs)
    max_len = longest + args.page_size
    max_len += (-max_len) % args.page_size
    cap_w = args.power_cap if args.power_cap > 0 else 40.0

    if args.ingest == "batched":
        from repro_torch.core import instrument

        instrument.set_ingest_mode("batched")
    engines, governors, slos = [], [], []
    t0 = time.time()
    for _ in range(args.fleet):
        eng = ContinuousEngine(cfg, params, n_slots=args.slots, max_len=max_len,
                               page=args.page_size, temperature=args.temperature,
                               attn_kernel=args.attn_kernel, device=device,
                               serve_mesh=args.mesh)
        if args.mesh is not None:
            eng.pool.blocks = SH.distribute(
                eng.pool.blocks, SH.page_pool_shardings(eng.mesh, eng.pool.blocks))
        eng.enable_prefix_cache()
        warm = make_batch(cfg, batch=1, seq_len=len(reqs[0].prompt), kind="prefill")
        eng.generate(warm, n_steps=2)
        engines.append(eng)
        governors.append(Governor(policy=policy_for_theta(args.theta)))
        slos.append(SLOTracker())
    t_warm = time.time() - t0

    t0 = time.time()
    finished, router, arbiter, sessions = run_engine_fleet(
        engines, reqs, cap_w=cap_w, floor_w=4.0, governors=governors, slos=slos)
    dt = time.time() - t0
    if args.ingest == "batched":
        from repro_torch.core import instrument

        instrument.flush_events()
        instrument.set_ingest_mode("event")
    n_tok = sum(len(r.out) for r in finished)

    def fill(registry):
        router.export_metrics(registry)
        arbiter.export_metrics(registry)
        # one replica's SLO percentiles as the fleet sample; the registry
        # families are unlabelled per-run singletons
        slos[0].export_metrics(registry)
        registry.gauge("fleet_replicas", "live replicas").set(float(args.fleet))
        registry.gauge("fleet_prefix_hit_rate",
                       "prompt tokens served from resident pages").set(
                           sum(e.prefix_cache.tokens_matched for e in engines)
                           / max(sum(e.prefix_cache.tokens_looked_up for e in engines), 1))

    outputs = _fleet_metrics_out(args, fill)
    replicas = [{
        "attn_kernel": e.attn_kernel, "requests": len(s.finished),
        "decode_steps": len(s.step_seconds),
        "step_ms_p50": (float(np.percentile(s.step_seconds, 50)) * 1e3
                        if s.step_seconds else None),
        "prefix_hits": e.prefix_cache.n_hits, "prefix_lookups": e.prefix_cache.n_lookups,
    } for e, s in zip(engines, sessions)]
    return {
        "mode": "fleet", "arch": cfg.name, "n_layers": cfg.n_layers, "device": str(device),
        "temperature": args.temperature, "trace": trace.name, "replicas": args.fleet,
        "data_ranks": engines[0].split.size,
        "requests": len(finished), "n_requests": len(reqs), "tokens": n_tok,
        "wall_s": dt, "tok_per_s": n_tok / dt, "warmup_s": t_warm,
        "routed": len(router.decisions), "prefix_routed": router.n_prefix_routed,
        "prefix_hits": sum(e.prefix_cache.n_hits for e in engines),
        "prefix_lookups": sum(e.prefix_cache.n_lookups for e in engines),
        "watts": MODELLED, "cap_w": cap_w, "grants_w": arbiter.allocations(),
        "arbiter_epochs": len(arbiter.history), "per_replica": replicas, **outputs,
        "objects": {"engines": engines, "sessions": sessions, "router": router,
                    "arbiter": arbiter, "requests": reqs,
                    "finished": finished, "trace": trace, "params": params},
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="llama3.2-1b",
                    help="any arch of repro_torch.configs.ARCHS")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the model to its first N layers, widths kept (0: the "
                         "config's depth); for a model whose every layer would not fit "
                         "one card")
    ap.add_argument("--batch", type=int, default=4, help="static mode: the batch")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over the paged KV pool")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--fleet", type=int, default=0,
                    help="run N serving replicas behind the prefix-aware "
                         "router with per-epoch watt arbitration (real "
                         "engines on the wall clock; N is the static size, "
                         "or the autoscale maximum with --autoscale)")
    ap.add_argument("--autoscale", action="store_true",
                    help="fleet mode: SLO-driven membership on the "
                         "deterministic virtual-clock fleet simulator "
                         "(scale-ups/-downs reprice every replica's watts)")
    ap.add_argument("--fleet-trace", choices=["flash-crowd", "diurnal", "session-reuse"],
                    default="flash-crowd", help="fleet mode arrival scenario")
    ap.add_argument("--fleet-duration", type=float, default=10.0,
                    help="fleet trace duration in seconds (wall-clock for "
                         "--fleet, virtual for --autoscale)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--long-prompt", type=int, default=0,
                    help="add one request with a prompt this long (0: none); it "
                         "samples with the key fold_in(key(seed), n_requests)")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8,
                    help="sampling temperature, as the reference's default; request i "
                         "draws with fold_in(key(seed), i) as jax.random does; 0: greedy")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--arrival-rate", type=float, default=40.0,
                    help="Poisson arrival rate (req/s)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--attn-kernel", choices=["plain", "cuda"], default=None,
                    help="plain PyTorch or the hand-written kernels (default: the "
                         "kernels on a CUDA device, plain PyTorch on the CPU; CPU "
                         "tensors always take the plain versions)")
    ap.add_argument("--tpot-target", type=float, default=0.0,
                    help="TPOT SLO target (s); 0 disables throttling")
    ap.add_argument("--theta", default="",
                    help="governor timeout (continuous mode only): seconds, "
                         "'auto' for the online ThetaTuner (decode underfill/"
                         "idle feed its per-site histograms), or 'predictive' "
                         "for the guarded predictor+timeout hybrid "
                         "(cntd_predictive); empty = the policy default")
    ap.add_argument("--trace-out", default="",
                    help="record the governor's event stream to this JSONL file "
                         "(continuous mode; replayable via repro_torch.cluster.trace)")
    ap.add_argument("--power-cap", type=float, default=0.0,
                    help="job power cap in watts: attach a cluster.ServeJob tenant "
                         "+ RAPL-style cap actuator and report its modelled draw vs "
                         "the cap (core.pstate.DEFAULT_HW's watts, not the card's)")
    ap.add_argument("--perfetto-out", default="",
                    help="write a Chrome-trace/Perfetto JSON of the run "
                         "(continuous mode: decode phase track, governor "
                         "counters, serve join/evict instants)")
    ap.add_argument("--metrics-out", default="",
                    help="write metrics-registry snapshots (with the exact "
                         "cumulative GovernorReport) to this JSONL file "
                         "(continuous mode)")
    ap.add_argument("--dashboard", action="store_true",
                    help="render the telemetry dashboard after the run "
                         "(continuous mode)")
    ap.add_argument("--ingest", choices=["event", "batched"], default="event",
                    help="instrument-layer event ingestion: 'batched' "
                         "accumulates raw 5-phase events into fixed-dtype "
                         "EventBatch chunks and exports ingest-health metrics "
                         "(events/s, occupancy, queue depth); the continuous "
                         "engine's own phase stream is occurrence-granular "
                         "and unaffected")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; under torchrun cuda:LOCAL_RANK)")
    ap.add_argument("--seed", type=int, default=0)
    ap.set_defaults(mesh=None)          # serve_mesh's, set by main
    return ap


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = parser().parse_args(argv)
    made_group = False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        made_group = join_group(_device(args))     # torchrun's world
    try:
        args.mesh = serve_mesh(args)
        if args.fleet:
            res = run_fleet_sim(args) if args.autoscale else run_fleet_real(args)
        elif args.continuous:
            res = run_continuous(args)
        else:
            if (args.theta or args.trace_out or args.power_cap > 0 or args.perfetto_out
                    or args.metrics_out or args.dashboard):
                # static mode builds no governor: these flags would be silent no-ops
                log.warning("flags_ignored",
                            why="--theta/--trace-out/--power-cap/telemetry need the "
                                "continuous engine's governor (add --continuous)")
            res = run_static(args)
        res["mesh"] = None if args.mesh is None else list(args.mesh.shape)
        if args.mesh is not None:
            # each rank's kernel path, in rank order
            kernel = "none" if res.get("mode") == "fleet_sim" else (
                "plain" if res["device"] == "cpu" else "cuda")
            path = {"device": res["device"], "attn_kernel": res.get("attn_kernel", kernel)}
            paths = [None] * dist.get_world_size()
            dist.all_gather_object(paths, path)
            res["ranks"] = paths
        if args.mesh is None or dist.get_rank() == 0:
            print(json.dumps({k: v for k, v in res.items() if k != "objects"}))
        return res
    finally:
        install_constraint(None)
        if made_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
