"""Serving entry point of the port: continuous batching, governor report.

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

Only the ``--continuous`` path of ``repro.launch.serve`` is ported: the
static batch, the fleet, the trace/telemetry outputs and the power cap
come in later slices.  ``--n-layers`` is the port's own: it cuts the
depth and keeps every width.  Weights are random, drawn from ``--seed``.  Tokens
are drawn at ``--temperature`` (0.8 by default, as the reference's) with
the reference's ``jax.random`` keys and draws (``repro_torch.jrandom``).  One
warm-up generate runs before the clock starts (it also builds the CUDA
kernel on first use); its time is reported as ``warmup_s``.  Each result
line is one JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import jrandom
from repro_torch.configs import get_config, reduced
from repro_torch.core.events import EventBus
from repro_torch.core.governor import Governor
from repro_torch.core.policies import policy_for_theta
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.serve.scheduler import Request, poisson_arrivals
from repro_torch.serve.slo import SLOTracker


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


def run_continuous(args, subscribers: Sequence[Any] = ()) -> Dict[str, Any]:
    """Serve ``args.n_requests`` Poisson requests; returns the run's numbers
    together with the engine, governor and report under ``"objects"``.
    ``subscribers`` join the governor on the serve loop's event bus (a
    phase recorder, an :class:`~repro_torch.core.profiler.EventProfiler`)."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    if args.kv_int8:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    max_len = (max(args.prompt_len, args.long_prompt) + cfg.n_prefix + args.steps
               + args.page_size)
    max_len += (-max_len) % args.page_size
    eng = ContinuousEngine(cfg, params, n_slots=args.slots, max_len=max_len,
                           page=args.page_size, temperature=args.temperature,
                           attn_kernel=args.attn_kernel, device=device)
    warm_rng = np.random.default_rng(args.seed + 1)
    warm = {"tokens": warm_rng.integers(0, cfg.vocab, size=(1, args.prompt_len)).astype(np.int32)}
    if cfg.n_prefix:
        warm["prefix_embeds"] = prefix_embeds(warm_rng, cfg)[None]
    t0 = time.time()
    eng.generate(warm, n_steps=2)
    t_warm = time.time() - t0

    gov = Governor(policy=policy_for_theta(args.theta))
    # the engine publishes decode phases onto a bus, not into a governor:
    # the governor is just the first subscriber
    bus = EventBus()
    bus.subscribe(gov)
    for sub in subscribers:
        bus.subscribe(sub)
    slo = SLOTracker()
    reqs = _make_requests(args, cfg)
    steps_before, joins_before = eng.n_decode_steps, eng.n_joins
    t0 = time.time()
    done = eng.serve(reqs, governor=bus, slo=slo)
    dt = time.time() - t0
    rep = gov.finalize()
    sess = eng._last_session
    s = slo.summary()
    n_tok = sum(len(r.out) for r in done)
    return {
        "arch": cfg.name, "n_layers": cfg.n_layers, "device": str(device),
        "attn_kernel": eng.attn_kernel,
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
        "completed": s["completed"],
        "objects": {"engine": eng, "governor": gov, "report": rep, "requests": done},
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
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over the paged KV pool (the only "
                         "mode ported so far)")
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
    ap.add_argument("--theta", default="",
                    help="governor timeout: seconds, "
                         "'auto' for the online ThetaTuner (decode underfill/"
                         "idle feed its per-site histograms), or 'predictive' "
                         "for the guarded predictor+timeout hybrid "
                         "(cntd_predictive); empty = the policy default")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = parser().parse_args(argv)
    if not args.continuous:
        raise SystemExit("only --continuous serving is ported to repro_torch so far")
    res = run_continuous(args)
    print(json.dumps({k: v for k, v in res.items() if k != "objects"}))
    return res


if __name__ == "__main__":
    main()
