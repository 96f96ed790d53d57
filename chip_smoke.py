#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one NVIDIA H100; exits 0 only if all phases pass

Builds the hand-written kernels from the sources in this checkout and runs:

1. **kernels against their plain versions**, at the serving path's shapes
   (B=8 slots, Hkv=8, G=4, D=64, page 16, 11 pages a slot): bf16, fp32 and
   int8 pages, fp32 and bf16 queries, window 0 and 64.  Outputs must agree
   (3e-2 with bf16 pages or queries, else 2e-5 / 2e-4) and the updated
   pools must be bit-equal outside the scratch page 0.  Times the kernel,
   the plain version and ``scaled_dot_product_attention`` over the gathered
   pages (a yardstick only: the port never calls it).
2. **serving**: ``repro_torch.launch.serve.run_continuous`` drives
   full-width llama3.2-1b (random weights from a seed) over 16 Poisson
   requests (prompt 128, 16-32 new tokens, 8 slots, page 16) through the
   CUDA kernel, its decode phases priced by the governor.  The kernel must
   have launched once per layer per decode step, and slack must be priced.
3. **one decode step, kernel against plain**, from the same pool state at
   full width: logits agree to bf16 tolerance (3e-2).
4. **a small model against the CPU**: reduced llama3.2-1b (fp32) served on
   the card through the kernel gives the same greedy tokens as the plain
   path on the CPU, with the same weights.

Prints the card's name and power limit, then one JSON line of kernel
numbers, and last ``{"ok": true, "device": {...}}``.  Needs CUDA and this
repository's ``src/``; without either it fails before printing a result.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
B, HKV, G, D, PAGE, M = 8, 8, 4, 64, 16, 11   # serving path: 8 slots, prompt 128 + 32, page 16


def require(ok, what) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 50) -> float:
    """Median device time of one call.  The L2 is flushed before each call
    (the serving path reaches a layer's pages after other layers' weights),
    and a sleep kernel keeps the card busy while the host enqueues the call,
    so the events bracket device work only, not the host's Python."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    times = []
    for _ in range(reps + 5):
        flush.zero_()
        torch.cuda._sleep(10_000_000)            # ~5 ms at the H100's clock
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        times.append((e0, e1))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in times[5:]]))


def host_ms(torch, fn, reps: int = 200) -> float:
    """Mean host time to issue one call (Python, checks and launch)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


# --------------------------------------------------------------------------
# phase 1: kernel against plain
# --------------------------------------------------------------------------

def paged_case(torch, rng, page_dtype, q_dtype, window):
    n_pages = B * M + 1
    dev = "cuda"
    quant = page_dtype == torch.int8

    def rows(*shape):
        if quant:
            return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dev, page_dtype)

    def scales(*shape):
        # absmax/127 of unit-normal rows of 64: about 0.02
        return torch.from_numpy(rng.uniform(0.005, 0.025, shape).astype(np.float32)).to(dev)

    table = rng.permutation(np.arange(1, n_pages, dtype=np.int32)).reshape(B, M)
    pos = rng.integers(128, M * PAGE, B).astype(np.int32)
    table[-1], pos[-1] = 0, 0                       # an idle slot on the scratch page
    page_idx = table[np.arange(B), pos // PAGE]
    case = dict(
        q=torch.from_numpy(rng.normal(0, 1, (B, HKV, G, D)).astype(np.float32)).to(dev, q_dtype),
        k_new=rows(B, HKV, D), v_new=rows(B, HKV, D),
        k_pages=rows(n_pages, PAGE, HKV, D), v_pages=rows(n_pages, PAGE, HKV, D),
        table=torch.from_numpy(table).to(dev), pos=torch.from_numpy(pos).to(dev),
        page_idx=torch.from_numpy(page_idx.astype(np.int32)).to(dev),
        off=torch.from_numpy((pos % PAGE).astype(np.int32)).to(dev),
    )
    if quant:
        case.update(k_scale_new=scales(B, HKV), v_scale_new=scales(B, HKV),
                    k_scale_pages=scales(n_pages, PAGE, HKV),
                    v_scale_pages=scales(n_pages, PAGE, HKV))
    return case, pos


def live_keys(pos, window) -> int:
    return int(sum(min(p + 1, window) if window else p + 1 for p in pos))


def bound_ms(torch, case, pos, window):
    """Least time for the same work: each needed K/V row (and scale) read
    once, q and the new rows read once, out and the new rows written once."""
    elem = case["k_pages"].element_size()
    keys = live_keys(pos, window)
    row = HKV * (D * elem + (4 if "k_scale_pages" in case else 0))
    nbytes = (2 * keys * row                               # K and V rows (+ scales)
              + 2 * case["q"].numel() * case["q"].element_size()   # q in, out
              + 2 * 2 * B * HKV * D * elem                 # new rows in, written
              + 4 * (case["table"].numel() + 3 * B))
    flops = 4 * keys * HKV * G * D                          # Q.K and P.V
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, PA):
    rng = np.random.default_rng(0)
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    cases = [  # (page dtype, q dtype, window); the first is the serving path's
        (bf16, f32, 0), (bf16, f32, 64), (i8, f32, 0), (i8, f32, 64),
        (f32, f32, 0), (bf16, bf16, 0), (f32, bf16, 0), (i8, bf16, 64),
    ]
    record = None
    for page_dtype, q_dtype, window in cases:
        case, pos = paged_case(torch, rng, page_dtype, q_dtype, window)
        plain_in = {k: v.clone() for k, v in case.items()}
        kern_in = {k: v.clone() for k, v in case.items()}
        want = PA.paged_attention_scatter_plain(**plain_in, window=window)
        got = PA.paged_attention_scatter(**kern_in, window=window)
        torch.cuda.synchronize()
        loose = bf16 in (page_dtype, q_dtype)
        atol, rtol = (3e-2, 3e-2) if loose else (2e-5, 2e-4)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
        err = float((got.float() - want.float()).abs().max())
        for name in ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages"):
            if name in case:
                require(torch.equal(kern_in[name][1:], plain_in[name][1:]), name)
        torch.cuda.synchronize()
        log(f"kernel ok: pages {page_dtype} q {q_dtype} window {window}: "
            f"max_abs_err {err:.3g} (atol {atol}, rtol {rtol}), pools bit-equal")
        if record is None:                       # time the serving path's case
            ms = time_ms(torch, lambda: PA.paged_attention_scatter(**kern_in, window=window))
            plain_ms = time_ms(torch, lambda: PA.paged_attention_scatter_plain(
                **plain_in, window=window))
            lib_ms = time_sdpa(torch, case, pos, window)
            b_ms, b_by = bound_ms(torch, case, pos, window)
            issue_ms = host_ms(torch, lambda: PA.paged_attention_scatter(**kern_in, window=window))
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
            log(f"timing at B={B} Hkv={HKV} G={G} D={D} page={PAGE} M={M} bf16 pages: "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
                f"bound {b_ms:.5f} ms ({b_by}); host issue of one wrapper call "
                f"{issue_ms:.4f} ms")
    return record


def time_sdpa(torch, case, pos, window):
    """``scaled_dot_product_attention`` over the slots' pages gathered into a
    contiguous (B,Hkv,T,D) view, bf16, GQA, masked by position."""
    import torch.nn.functional as F

    t = M * PAGE
    rows = case["table"].long()
    k = case["k_pages"][rows].reshape(B, t, HKV, D).transpose(1, 2).contiguous()
    v = case["v_pages"][rows].reshape(B, t, HKV, D).transpose(1, 2).contiguous()
    q = case["q"].to(k.dtype).reshape(B, HKV * G, 1, D)
    k_pos = torch.arange(t, device="cuda")
    p = case["pos"][:, None]
    mask = k_pos[None, :] <= p
    if window:
        mask &= k_pos[None, :] > p - window
    mask = mask[:, None, None, :]
    return time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True))


# --------------------------------------------------------------------------
# phases 2-4
# --------------------------------------------------------------------------

def phase_serving(torch, PA):
    from repro_torch.launch import serve

    args = serve.parser().parse_args([
        "--arch", "llama3.2-1b", "--continuous", "--attn-kernel", "cuda",
        "--n-requests", "16", "--prompt-len", "128", "--steps", "32",
        "--slots", "8", "--page-size", "16", "--arrival-rate", "40", "--seed", "0"])
    PA.launches = 0
    res = serve.run_continuous(args)
    launches = PA.launches
    objs = res.pop("objects")
    eng = objs["engine"]
    cfg = eng.cfg
    require((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.vocab)
            == (16, 2048, 32, 8, 128256), cfg)
    want = eng.n_decode_steps * cfg.n_layers
    require(launches == want, f"kernel launched {launches} times, want {want}")
    require(res["priced_slack_ms"] > 0, res)
    require(res["completed"] == 16, res)
    for r in objs["requests"]:
        require(len(r.out) == r.max_new and all(0 <= t < cfg.vocab for t in r.out), r.rid)
    log("serving: " + json.dumps(res))
    return launches, eng


def phase_step_check(torch, eng):
    from repro_torch.serve.engine import (ContinuousEngine, EngineSession,
                                          make_paged_decode_step)
    from repro_torch.serve.scheduler import Request

    cfg = eng.cfg
    fresh = ContinuousEngine(cfg, eng.params, n_slots=8, max_len=eng.max_len, page=16,
                             attn_kernel="cuda", device="cuda")
    sess = EngineSession(fresh)
    rng = np.random.default_rng(7)
    for _ in range(8):
        sess.submit(Request(prompt=rng.integers(0, cfg.vocab, 128).astype(np.int32),
                            max_new=8, arrival=0.0))
    with torch.no_grad():
        sess.admit(now=0.0)
        for req in sess.sched.active.values():
            fresh._grow_pages(req)             # the page the next row lands in
        m_live = int(fresh._lengths.max()) // 16 + 1
        args = (fresh.params, fresh._to_device(fresh._tokens), fresh._to_device(fresh._lengths),
                fresh._to_device(fresh._table[:, :m_live]))
        blocks_plain = copy.deepcopy(fresh.pool.blocks)
        plain, _ = make_paged_decode_step(cfg, "plain")(*args, blocks_plain)
        kern, _ = make_paged_decode_step(cfg, "cuda")(*args, fresh.pool.blocks)
        torch.cuda.synchronize()
    require(bool(torch.isfinite(kern).all()) and kern.shape == (8, cfg.vocab), "logits")
    torch.testing.assert_close(kern, plain, atol=3e-2, rtol=3e-2)
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    err = float((kern - plain).abs().max())
    log(f"step check: logits max_abs_err {err:.3g} (atol 3e-2), "
        f"greedy agreement {agree:.3f}")
    with torch.no_grad():
        profile_step(torch, make_paged_decode_step(cfg, "cuda", fused_sample=True),
                     args, fresh.pool.blocks)
    return err, agree


def profile_step(torch, step, args, blocks, n: int = 5):
    """Where one full-width decode step's time goes: the host clock around
    synchronised steps, and the device time of every kernel from
    ``torch.profiler`` (reruns the same step; the pools are rewritten with
    the same rows)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(*args, blocks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step(*args, blocks)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(*args, blocks)
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total / n / 1e3, e.count // n, e.key)
                      for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     reverse=True)
    busy = sum(k[0] for k in kernels)
    attn = sum(k[0] for k in kernels if "paged_attention_scatter_kernel" in k[2])
    log(f"decode step (8 slots, full width): wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f} %), paged kernel {attn:.4f} ms")
    for ms, count, key in kernels[:8]:
        log(f"  {ms:.4f} ms in {count} launches: {key[:110]}")


def phase_small_model(torch):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ContinuousEngine

    cfg = reduced(get_config("llama3.2-1b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = _to(params, torch, "cuda")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (3, 14)).astype(np.int32)
    kw = dict(n_slots=3, max_len=40, page=8)
    ref = ContinuousEngine(cfg, params, attn_kernel="plain", device="cpu", **kw)
    got = ContinuousEngine(cfg, on_card, attn_kernel="cuda", device="cuda", **kw)
    want = ref.generate({"tokens": tokens}, n_steps=10)
    out = got.generate({"tokens": tokens}, n_steps=10)
    require(torch.equal(out, want), (out, want))
    log(f"small model: card tokens == CPU tokens over {tuple(out.shape)}")


def _to(tree, torch, device):
    if isinstance(tree, dict):
        return {k: _to(v, torch, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, torch, device) for v in tree]
    return tree.to(device)


def main() -> int:
    argparse.ArgumentParser(description=__doc__,
                            formatter_class=argparse.RawDescriptionHelpFormatter).parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import paged_attention as PA

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {card}")
    t0 = time.time()
    PA.build()
    build_s = time.time() - t0
    log(f"built the kernels in {build_s:.1f} s")

    rec = phase_kernels(torch, PA)
    launches, eng = phase_serving(torch, PA)
    phase_step_check(torch, eng)
    del eng
    phase_small_model(torch)

    print(card)
    print(json.dumps({"kernels": [dict(
        name="paged_attention_scatter", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:232",
        launches=launches, **rec)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
