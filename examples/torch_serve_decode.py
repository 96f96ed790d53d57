"""Batched serving on the PyTorch port: prefill a prompt batch, decode
continuations with the KV/recurrent caches, compare a windowed-attention
arch vs an SSM — then run the same model under continuous batching with a
paged KV pool and a governor pricing decode underfill like MPI slack, as
``examples/serve_decode.py`` does on the JAX package.

  PYTHONPATH=src python examples/torch_serve_decode.py               # on the card
  PYTHONPATH=src python examples/torch_serve_decode.py --device cpu

On the card the continuous engine runs the hand-written kernels (the fused
paged decode attention, RMSNorm, flash prefill attention); on the CPU
their plain versions.  Sampling at temperature 0.8 draws ``jax.random``'s
numbers (:mod:`repro_torch.jrandom`).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import jrandom
from repro_torch.configs import get_config, reduced
from repro_torch.core.governor import Governor
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.models.inputs import make_batch
from repro_torch.serve import (
    ContinuousEngine,
    Request,
    ServeEngine,
    SLOTracker,
    poisson_arrivals,
)


def demo(arch: str, device, n_steps: int = 16) -> torch.Tensor:
    cfg = reduced(get_config(arch))
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    eng = ServeEngine(cfg, params, max_len=128, temperature=0.8, device=device)
    batch = make_batch(cfg, batch=4, seq_len=32, kind="prefill")
    t0 = time.time()
    out = eng.generate(batch, n_steps=n_steps, key=jrandom.key(7, device))
    dt = time.time() - t0
    print(f"{arch:20s} generated {tuple(out.shape)} tokens in {dt:.2f}s "
          f"({4 * n_steps / dt:.1f} tok/s incl. warm-up)")
    print(f"  sample: {out[0].tolist()}")
    return out


def demo_continuous(device, arch: str = "llama3.2-1b", n_requests: int = 8) -> dict:
    """Poisson arrivals through the paged continuous engine + governor."""
    cfg = reduced(get_config(arch))
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    eng = ContinuousEngine(cfg, params, n_slots=4, max_len=64, page=8, device=device)
    eng.generate(make_batch(cfg, batch=1, seq_len=16, kind="prefill"),
                 n_steps=4)                        # warm-up
    rng = np.random.default_rng(0)
    arrivals = poisson_arrivals(n_requests, rate=40.0, seed=0,
                                burst_every=4, burst_gap=0.05)
    reqs = [
        Request(prompt=rng.integers(0, cfg.vocab, size=16).astype(np.int32),
                max_new=int(rng.integers(3, 13)), arrival=float(arrivals[i]))
        for i in range(n_requests)
    ]
    gov, slo = Governor(), SLOTracker()
    t0 = time.time()
    done = eng.serve(reqs, governor=gov, slo=slo)
    dt = time.time() - t0
    rep = gov.finalize()
    n_tok = sum(len(r.out) for r in done)
    print(f"{arch:20s} continuous: {n_tok} tokens / {len(done)} requests in "
          f"{dt:.2f}s ({n_tok / dt:.1f} tok/s, fill "
          f"{eng._last_meter.fill_fraction:.2f})")
    print(f"  decode slack priced: {rep.total_slack * 1e3:.1f} ms, "
          f"{rep.n_downshifts} downshifts, saving {rep.energy_saving_pct:.1f}%; "
          f"TTFT p95 {slo.summary()['ttft']['p95'] * 1e3:.1f} ms")
    return {"tokens": n_tok, "requests": len(done), "report": rep}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--steps", type=int, default=16, help="tokens each batched demo decodes")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"batched generation across architecture families, on {device}:")
    out = {arch: demo(arch, device, args.steps) for arch in (
        "llama3.2-1b",          # dense GQA, linear KV cache
        "mixtral-8x22b",        # MoE + sliding-window ring cache
        "mamba2-130m",          # attention-free: O(1) recurrent state
        "recurrentgemma-2b",    # hybrid RG-LRU + local attention
    )}
    print("\ncontinuous batching with paged KV + governor-priced slack:")
    return {"batched": out, "continuous": demo_continuous(device)}


if __name__ == "__main__":
    main()
