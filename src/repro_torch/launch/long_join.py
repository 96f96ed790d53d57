#!/usr/bin/env python3
"""Time one long join of the PyTorch/CUDA port on the card.

    PYTHONPATH=src python -m repro_torch.launch.long_join [--tag LABEL]
    python3 src/repro_torch/launch/long_join.py --src OTHER/src [--tag LABEL]

A join is the prefill of one prompt into a fresh slot of the continuous
engine (``EngineSession.admit``): the whole model over the prompt, the
K/V or recurrent state into the slot, the first token.  For each arch, at
full width with random weights from seed 0, the script joins one long
prompt (recurrentgemma-2b 2032 tokens, mamba2-130m 2000, the long requests
of ``chip_smoke.py``) through the kernels and through the plain path, in
turns, and prints one JSON line each: the host clock around a synchronised
join (median of 3 after a warm-up), the device time some kernel
runs during one join (``torch.profiler``, overlapping kernels counted
once), and the device time of the prefill kernels by name (flash
attention, the SSD scan, the RG-LRU scan).  ``--src`` picks the
``repro_torch`` to import (this checkout's ``src`` by default): run as a
file, the module can time another tree's package, such as a parent commit
unpacked beside it, so one call can time two trees in turns.  Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

SRC = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LONG_PROMPT = {"recurrentgemma-2b": 2032, "mamba2-130m": 2000}
# substrings of the prefill kernels' names, as the profiler reports them
PREFILL_KERNELS = ("flash_attention_kernel", "ssd_", "rglru_scan")
REPS = 3                      # timed joins after the warm-up one
PAGE = 16


def covered_ms(ranges) -> float:
    """The time covered by (start, end) intervals in microseconds, in ms:
    overlapping kernels count once."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(ranges):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def time_join(torch, cfg, params, prompt, attn_kernel) -> dict:
    """One join of ``prompt`` into a fresh 8-slot engine on ``params``,
    through ``attn_kernel`` ("cuda" or "plain"): the host clock of REPS
    synchronised joins after a warm-up one, then one under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import ContinuousEngine, EngineSession
    from repro_torch.serve.scheduler import Request

    max_len = len(prompt) + 2 * PAGE
    max_len += (-max_len) % PAGE

    def session():
        eng = ContinuousEngine(cfg, params, n_slots=8, max_len=max_len, page=PAGE,
                               attn_kernel=attn_kernel, device="cuda")
        sess = EngineSession(eng)
        sess.submit(Request(prompt=prompt, max_new=8, arrival=0.0))
        torch.cuda.synchronize()
        return sess

    host = []
    with torch.no_grad():
        for _ in range(REPS + 1):
            sess = session()
            t0 = time.perf_counter()
            joined = sess.admit(now=0.0)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            if len(joined) != 1:
                raise RuntimeError(f"join: {len(joined)} requests joined, want 1")
            del sess
        sess = session()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sess.admit(now=0.0)
            torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for name in PREFILL_KERNELS:
                if name in e.key:
                    kernels[name] = kernels.get(name, 0.0) + e.self_device_time_total / 1e3
    return dict(attn_kernel=attn_kernel, tokens=len(prompt), host_ms=float(np.median(host[1:])),
                host_ms_runs=host[1:], device_busy_ms=covered_ms(s[:2] for s in spans),
                device_launches=len(spans), prefill_kernel_ms=kernels)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", default=SRC,
                    help="the directory holding the repro_torch to time")
    ap.add_argument("--tag", default="", help="a label copied into every line")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    if not torch.cuda.is_available():
        print("long_join: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    for arch, n_tokens in LONG_PROMPT.items():
        cfg = get_config(arch)
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        prompt = np.random.default_rng(0).integers(0, cfg.vocab, n_tokens).astype(np.int32)
        for kernel in ("cuda", "plain"):
            rec = time_join(torch, cfg, params, prompt, kernel)
            print(json.dumps(dict(tag=args.tag, arch=arch, src=args.src, **rec)), flush=True)
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
