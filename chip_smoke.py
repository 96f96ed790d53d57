#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one NVIDIA H100; exits 0 only if all phases pass

Builds the hand-written kernels from the five sources in this checkout (one
``nvcc`` per source, all at once) and runs:

1. **kernels against their plain versions** on the same inputs, at the
   serving paths' shapes, fp32 to atol 2e-5 / rtol 2e-4 and bf16 to 3e-2
   (and, for bf16 pages under an fp32 query, each slot to 2e-2 of its
   output's RMS):
   - paged decode attention: llama3.2-1b's (B 8, Hkv 8, G 4, D 64, page
     16; bf16/fp32/int8 pages, fp32/bf16 queries, window 0 and 64; pools
     bit-equal outside the scratch page) and recurrentgemma-2b's (B 8,
     Hkv 1, G 10, D 256, page 16, a 2048 window that cuts pages); the walk
     is split over S blocks per (slot, kv head) and merged by a second
     launch (the plan, S, C and shared bytes, is logged beside each
     timing), and a second call on the same inputs gives the same bits;
   - RMSNorm at every path shape (8, 128 and 2032 rows of 2560; 8 and 128
     of 2048; 8, 128 and 2000 of 768) in bf16 and fp32, a second launch
     bit-equal, and rows of 2558 and 8190 (scalar loads; 8190 cut over a
     cluster); fp32 timed at every shape, an empty kernel timed the same
     way (the launch floor), and the decode calls timed under a cluster
     split beside the wrapper's plan;
   - RG-LRU scan: B 1, W 2560, with h0, at S 2032 and S 128, also held to
     ``scan_model`` (its order of operations) within an ulp, its plan
     logged, timed beside an elementwise product with the same bytes;
   - flash prefill attention (tensor cores, 3xTF32 for fp32):
     recurrentgemma-2b's (Hq 10, Hkv 1, D 256, window 2048) at S 2032, at
     S 2304 > window and at S 128, llama3.2-1b's (Hq 32, Hkv 8, D 64) at S
     128; the non-causal mode at both head shapes and at a ragged S with a
     window;
   - SSD chunked scan (four launches a call: C.B^T, chunk states, carry,
     output; no carry when S fits one chunk): mamba2-130m's prefill (B 1,
     H 24, P 64, N 128, chunk 128, fp32) at S 2000 (the last chunk
     ragged) and 2048, from a zero and from a random state, and at S 128;
     y and the final state to the reference's SSD bar, atol 2e-4 / rtol
     2e-3.
   - the other families' shapes: the fused paged step at granite's (Hkv
     8, G 3, D 64), internvl2's (2, 7, 64), glm4's (2, 16, 128),
     internlm2's (8, 2, 128), olmo's (16, 1, 128), musicgen's (32, 1, 64)
     and mixtral's (8, 6, 128) under its 4096 window with the slots past
     it (bf16 pages under an fp32 query; granite also fp32 and int8
     pages); flash at their prefills (S 128; 384 and 192 with internvl2's
     and musicgen's prefixes; G 3, 7, 16, 1 and 6, D 64 and 128); RMSNorm
     at 8 and 128 rows of 1536, 896, 4096 and 6144 (and internvl2's 384
     rows of 896).
   Each kernel is timed beside its plain version, its bound and, where one
   PyTorch call computes the same function, that call (``F.rms_norm``,
   ``scaled_dot_product_attention``, ``index_put_`` for the paged scatter;
   yardsticks only, the port never calls them); flash and the SSD scan also beside their 3xTF32 tensor-core
   bound, and a second launch of each on the same inputs must give the
   same bits.
1b. **the ``kernels.ops`` surface**: the unfused paged attention and the
   paged scatter driven through ``repro_torch.kernels.ops`` at llama's
   and recurrentgemma's decode shapes (bf16, fp32 and int8 pages), the
   fused step bit-equal to scatter then attention (outputs and every page,
   quant off/on, window 0/12, as the reference's
   ``test_paged_attention_scatter_fuses_bit_equal``); then each unfused
   kernel against its plain version (attention at the fused kernel's bars,
   scatter bit-equal, a case of duplicate destinations included).
1c. **the sampler** (``repro_torch.jrandom``, ``jax.random``'s draws) on
   the card against the CPU over (8, V) logits at V 128256, 256000 and
   50280: bits and uniforms bit-equal, tokens equal but for near ties (the
   two highest perturbed scores within 1e-5 relative); the decode step's
   draw timed and its launches counted.
2. **llama3.2-1b serving**: ``repro_torch.launch.serve.run_continuous``
   drives full-width llama3.2-1b at the reference's default temperature
   (0.8: tokens sampled; random weights from a seed) over 16
   Poisson requests (prompt 128, 16-32 new tokens, 8 slots, page 16)
   through the kernels, its decode phases priced by the governor.
3. **one llama decode step, kernels against plain**, from one pool state.
4. **reduced llama against the CPU**: greedy tokens on the card equal the
   plain path's on the CPU, with the same weights.
5. **recurrentgemma-2b serving**: full width (26 layers, d 2560, random
   weights from a seed, fp32 params and bf16 compute), sampled at the
   default temperature, with no kernel
   named (the default on the card is the kernels), over 12 Poisson
   requests (prompt 128, 16-32 new tokens) plus one of a 2032-token prompt
   and 32 new tokens, whose decode passes position 2048 so that the
   window drops pages.  Then one long join (the 2032-token prompt) timed
   through the kernels and through the plain path (``launch/long_join.py``:
   host clock and device time; logged).
6. **one recurrentgemma decode step, kernels against plain**, from one pool
   state whose long request is past the window: logits to 3e-2, greedy
   tokens equal.
7. **reduced recurrentgemma (fp32, 8 layers) against the CPU**: greedy
   tokens through the kernels on the card equal the plain path's on the CPU.
8. **mamba2-130m serving**: full width (24 SSM layers, d 768, state 128,
   random weights from a seed, fp32 params and bf16 compute), greedy
   (``--temperature 0``: the step's fused argmax), no kernel
   named, 12 Poisson requests (prompt 128, 16-32 new tokens) plus one of a
   2000-token prompt (16 chunks, the last ragged) and 32 new tokens; then
   its long join timed as in phase 5.
9. **one mamba2 join and decode step, kernels against plain**: the long
   slot's state after the join at the SSD bar in every layer, then one
   decode step from one pool state: logits to 3e-2, greedy tokens equal.
10. **reduced mamba2 (fp32, 4 layers, chunk 16, a 37-token prompt) against
   the CPU**: greedy tokens equal.
11. **llama3.2-1b under ``--theta predictive``** (run after phase 4; the
   guarded predictor+timeout hybrid, ``cntd_predictive``): phase 2's
   arguments with 32 requests, enough phases for the predictor's first
   forest refit (it waits for 64 observations), served four times through
   the kernels in turns: default policy, ``--theta predictive`` twice,
   default policy, each with phase 2's launch and completion checks.  Each
   predictive run's policy and priced slack; its recorded phase stream
   replayed through a fresh governor of the same policy gives the same
   report and predictor decisions and locates each refit, of which there
   must be at least one; an event profiler on the same bus logs its
   summary.  Logged: the decode step's host clock (p50, max) of every run,
   and the host time the governor held each phase (from the phase's end
   to the subscriber after it on the bus), at the refits and elsewhere.
12. **the instrumented collectives** (``repro_torch.core.instrument``) on
   NCCL in a world of 1 on cuda:0: every wrapper in the modes off, barrier
   and profile on fp32 tensors of 4 B and 16 MiB equals the plain
   collective and leaves its input untouched; profile mode emits the
   reference's phase sequence, in order in time; a kernel of tens of ms
   queued before ``cd_psum``, or between ``cd_psum_async`` and
   ``cd_wait``, is booked as the rank's own time (overlap for the async
   pair) and not as slack; then the median host clock of a completed
   ``cd_psum`` in each mode, in turns, and the barrier's added cost a call.

13. **training parity**: llama3.2-1b at full width (d 2048, vocab 128256)
   cut to 2 layers, fp32 compute, batch 2 x 64, on the card and on the CPU
   from the same parameters and batches: the first step's loss and
   gradients at the fp32 bar; AdamW on the card against the CPU's fed the
   same gradients, atol 1e-6; three ``make_train_step`` steps, each step's
   gradients leaf by leaf at the fp32 bar before it is taken, losses rtol
   1e-4, grad norms rtol 1e-3, and the parameters: at most one element in
   a million past 1e-5, none past 2 lr a step.
14. **llama3.2-1b training**: full width (fp32 params, bf16 compute as
   configured), 8 steps of batch 8 x 128 through
   ``repro_torch.launch.train``: losses and grad norms finite, the first
   loss within 1.0 of 12.2 (ln 128256 plus half the logits' variance), the
   mean of the last 3 below the first; logged: the synchronised step clock
   (median after step 1), tokens/s, peak memory against 16 bytes a
   parameter, and model FLOP/s (6 N T) against the fp32 peak.
15. **the live data-parallel step**: ``--live-events`` on NCCL in a world
   of 1, 4 steps of full-width llama3.2-1b: the gradients and the loss
   through ``cd_psum``, 8 calls booked by the governor, the host clock of
   each ``cd_psum`` over the gradient tree logged; then one
   ``"compressed"`` pod step on the 2-layer model: ``compressed_psum``'s
   mean of the exact gradients equal to the CPU's codec element by element
   and within ½ LSB of them, and the step's loss equal to the manual one's
   and its gradient norm that of the compressed gradients.

16. **granite-moe-3b-a800m serving** (run after phase 10): full width and
   depth (32 layers, d 1536, 24/8 heads, 40 experts top-8, vocab 49155,
   random weights from a seed, 13.2 GB of fp32), 16 Poisson requests of
   128-token prompts, sampled at T 0.8, through the kernels: capacity
   routing at each join (32 a expert at 128 tokens), dropless decode.
   Then one decode step of 8 slots, kernels against plain: a slot is held
   to the bar where both steps chose the same experts in every layer; one
   whose experts differ somewhere must differ at a near tie (its router
   probabilities in the two steps within 1e-3 of each other at every layer
   up to the first that differs), and at least half the slots must route
   alike.  The step's host clock and device time beside its byte bound
   (every weight read once, 3.9 ms) are logged.
17. **reduced granite-moe-3b-a800m, mixtral-8x22b, internvl2-1b,
   musicgen-large and olmo-1b (fp32, 2 layers) against the CPU**: greedy
   tokens equal, the prefix archs with the same prefix embeddings.
18. **a short serve of each other new arch** at full width (4 requests of
   128-token prompts, up to 16 new tokens): internvl2-1b (with its
   256-position prefix), olmo-1b, internlm2-1.8b, musicgen-large (48
   layers) at full depth; glm4-9b cut to 8 of 40 layers and mixtral-8x22b
   to 2 of 56, each cut logged with its reason.

In phases 1b, 2, 5, 8, 11, 13-16 and 18 every kernel count is set to 0 just
before the run and read just after; each must equal the launches the path
needs (RMSNorm once per norm a join and a step where the norm is RMSNorm,
none for LayerNorm and the nonparametric norm: 2 a layer with an MLP, 1
an SSM layer, plus the final norm; flash, the RG-LRU scan and the SSD scan
once per attention / RG-LRU / SSM layer a join; the fused paged kernel
once per attention layer a step; the unfused paged kernels only on the ops
path; none on the training path, which runs plain PyTorch under autograd).
Each step check profiles the step: device time by kernel, the paged
kernels' walk and combine together and apart.
Prints the card's name and power limit, then one JSON line of kernel
numbers (each kernel's launches from its own path: the ops surface for the
unfused paged kernels, mamba2's for RMSNorm and the SSD scan,
recurrentgemma's for the rest), and last ``{"ok": true, "device": {...}}``.
Needs CUDA and this repository's ``src/``; without either it fails before
printing a result.
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
TF32_FLOPS_PER_S = 494.7e12   # H100 SXM dense TF32 tensor cores
KERNEL_SOURCES = ("paged_attention", "rmsnorm", "rglru_scan", "flash_attention", "ssd")
SSD_TOL = dict(atol=2e-4, rtol=2e-3)   # the reference's fp32 SSD bar (test_kernels.py)
# each kernel: (its wrapper's module, the count's name, its source, the TPU kernel it replaces)
KERNELS = {
    "paged_attention_scatter": ("PA", "launches", "paged_attention",
                                "src/repro/kernels/paged_attention.py:232"),
    "paged_attention": ("PA", "attention_launches", "paged_attention",
                        "src/repro/kernels/paged_attention.py:143"),
    "paged_scatter": ("PA", "scatter_launches", "paged_attention",
                      "src/repro/kernels/paged_attention.py:307"),
    "flash_attention": ("FA", "launches", "flash_attention",
                        "src/repro/kernels/flash_attention.py:68"),
    "rmsnorm": ("RN", "launches", "rmsnorm", "src/repro/kernels/rmsnorm.py:24"),
    "ssd_scan": ("SSD", "launches", "ssd", "src/repro/kernels/ssd.py:61"),
    "rglru_scan": ("RS", "launches", "rglru_scan", "src/repro/kernels/rglru_scan.py:39"),
}
F32_TOL = dict(atol=2e-5, rtol=2e-4)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)
SLOT_REL_TOL = 2e-2           # paged, bf16 pages: a slot's max error over its output RMS


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
    (the serving path reaches a layer's inputs after other layers' weights),
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


def bound(nbytes: float, flops: float, flops_per_s: float = FP32_FLOPS_PER_S):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, got, want, tol, what) -> float:
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite output")
    torch.testing.assert_close(got.float(), want.float(), **tol)
    err = float((got.float() - want.float()).abs().max())
    log(f"kernel ok: {what}: max_abs_err {err:.3g} ({tol})")
    return err


def randn(torch, rng, *shape, dtype=None, mean=0.0, std=1.0):
    t = torch.from_numpy(rng.normal(mean, std, shape).astype(np.float32)).to("cuda")
    return t if dtype is None else t.to(dtype)


# --------------------------------------------------------------------------
# phase 1: kernels against plain
# --------------------------------------------------------------------------

def paged_case(torch, rng, page_dtype, q_dtype, b, hkv, g, d, page, m, pos_lo):
    n_pages = b * m + 1
    dev = "cuda"
    quant = page_dtype == torch.int8

    def rows(*shape):
        if quant:
            return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dev, page_dtype)

    def scales(*shape):
        # absmax/127 of unit-normal rows of 64: about 0.02
        return torch.from_numpy(rng.uniform(0.005, 0.025, shape).astype(np.float32)).to(dev)

    table = rng.permutation(np.arange(1, n_pages, dtype=np.int32)).reshape(b, m)
    pos = rng.integers(pos_lo, m * page, b).astype(np.int32)
    table[-1], pos[-1] = 0, 0                       # an idle slot on the scratch page
    page_idx = table[np.arange(b), pos // page]
    case = dict(
        q=torch.from_numpy(rng.normal(0, 1, (b, hkv, g, d)).astype(np.float32)).to(dev, q_dtype),
        k_new=rows(b, hkv, d), v_new=rows(b, hkv, d),
        k_pages=rows(n_pages, page, hkv, d), v_pages=rows(n_pages, page, hkv, d),
        table=torch.from_numpy(table).to(dev), pos=torch.from_numpy(pos).to(dev),
        page_idx=torch.from_numpy(page_idx.astype(np.int32)).to(dev),
        off=torch.from_numpy((pos % page).astype(np.int32)).to(dev),
    )
    if quant:
        case.update(k_scale_new=scales(b, hkv), v_scale_new=scales(b, hkv),
                    k_scale_pages=scales(n_pages, page, hkv),
                    v_scale_pages=scales(n_pages, page, hkv))
    return case, pos


def paged_bound(case, pos, window, scatter=True):
    """Each needed K/V row (and scale) read once, q read once, out written
    once; with ``scatter``, the new rows read once and written once too."""
    b, hkv, g, d = case["q"].shape
    elem = case["k_pages"].element_size()
    keys = int(sum(min(p + 1, window) if window else p + 1 for p in pos))
    row = hkv * (d * elem + (4 if "k_scale_pages" in case else 0))
    nbytes = (2 * keys * row                                # K and V rows (+ scales)
              + 2 * case["q"].numel() * case["q"].element_size()   # q in, out
              + 4 * (case["table"].numel() + b))
    if scatter:
        nbytes += 2 * 2 * b * row + 4 * 2 * b               # new rows in, written; dests
    return bound(nbytes, 4 * keys * hkv * g * d)            # Q.K and P.V, fp32


def paged_plan(PA, case, window) -> dict:
    """The split plan the wrappers launch with at this case's shapes (S
    blocks per (slot, kv head), each over C live pages) and a block's
    shared memory."""
    b, hkv, g, d = case["q"].shape
    page = case["k_pages"].shape[1]
    splits, run = PA.split_plan(b, hkv, case["table"].shape[1], page, window,
                                PA.sm_count(case["q"].device))
    return dict(splits=splits, run=run,
                shared_bytes=PA.shared_bytes(case["k_pages"].dtype, g, d, page, run))


def slot_ratio(got, want) -> float:
    """The worst slot's max error over that slot's output RMS."""
    slot_err = (got.float() - want.float()).abs().flatten(1).amax(1)
    slot_rms = want.float().pow(2).flatten(1).mean(1).sqrt()
    return float((slot_err / slot_rms).max())


def paged_sdpa_ms(torch, case, window):
    """``scaled_dot_product_attention`` over the slots' pages gathered into a
    contiguous (B,Hkv,T,D) view in the page dtype, GQA, masked by position."""
    import torch.nn.functional as F

    b, hkv, g, d = case["q"].shape
    page = case["k_pages"].shape[1]
    t = case["table"].shape[1] * page
    rows = case["table"].long()
    k = case["k_pages"][rows].reshape(b, t, hkv, d).transpose(1, 2).contiguous()
    v = case["v_pages"][rows].reshape(b, t, hkv, d).transpose(1, 2).contiguous()
    q = case["q"].to(k.dtype).reshape(b, hkv * g, 1, d)
    k_pos = torch.arange(t, device="cuda")
    p = case["pos"][:, None]
    mask = k_pos[None, :] <= p
    if window:
        mask &= k_pos[None, :] > p - window
    mask = mask[:, None, None, :]
    return time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True))


# the other families' decode shapes (B 8, page 16, 8 slots between positions
# 128 and 175): name -> (Hkv, G, D, window); mixtral's slots lie past its
# 4096 window, so that it cuts pages
FAMILY_PAGED = {
    "granite-moe-3b-a800m": (8, 3, 64, 0),
    "internvl2-1b": (2, 7, 64, 0),
    "glm4-9b": (2, 16, 128, 0),
    "internlm2-1.8b": (8, 2, 128, 0),
    "olmo-1b": (16, 1, 128, 0),
    "mixtral-8x22b": (8, 6, 128, 4096),
    "musicgen-large": (32, 1, 64, 0),
}


def phase_paged(torch, PA):
    """The fused paged step against its plain version at every path's
    decode shapes, pools bit-equal outside the scratch page; each path's
    serving case (bf16 pages, fp32 query) also slot by slot, timed beside
    the plain version, SDPA and the bound, and launched twice for the same
    bits.  Returns those records by path name."""
    rng = np.random.default_rng(0)
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    shapes = {"llama3.2-1b": dict(b=8, hkv=8, g=4, d=64, page=16, m=11, pos_lo=128),
              "recurrentgemma-2b": dict(b=8, hkv=1, g=10, d=256, page=16, m=144, pos_lo=2000)}
    cases = [  # (path, page dtype, q dtype, window)
        ("llama3.2-1b", bf16, f32, 0), ("llama3.2-1b", bf16, f32, 64),
        ("llama3.2-1b", i8, f32, 0), ("llama3.2-1b", i8, f32, 64),
        ("llama3.2-1b", f32, f32, 0), ("llama3.2-1b", bf16, bf16, 0),
        ("llama3.2-1b", f32, bf16, 0), ("llama3.2-1b", i8, bf16, 64),
        ("recurrentgemma-2b", f32, f32, 2048), ("recurrentgemma-2b", bf16, f32, 2048),
        ("granite-moe-3b-a800m", f32, f32, 0), ("granite-moe-3b-a800m", i8, f32, 0),
    ]
    for name, (hkv, g, d, window) in FAMILY_PAGED.items():
        shapes[name] = dict(b=8, hkv=hkv, g=g, d=d, page=16, m=11, pos_lo=128)
        if window:
            shapes[name].update(m=272, pos_lo=window + 104)
        cases.append((name, bf16, f32, window))
    records = {}
    for name, page_dtype, q_dtype, window in cases:
        shape = shapes[name]
        case, pos = paged_case(torch, rng, page_dtype, q_dtype, **shape)
        require(not window or pos.max() >= window + shape["page"],
                f"window {window} drops no page at positions {pos.tolist()}")
        plain_in = {k: v.clone() for k, v in case.items()}
        kern_in = {k: v.clone() for k, v in case.items()}
        want = PA.paged_attention_scatter_plain(**plain_in, window=window)
        got = PA.paged_attention_scatter(**kern_in, window=window)
        loose = bf16 in (page_dtype, q_dtype)
        err = compare(torch, got, want, BF16_TOL if loose else F32_TOL,
                      f"paged {name} pages {page_dtype} q {q_dtype} window {window}")
        if (page_dtype, q_dtype) == (bf16, f32):
            # the serving paths' case.  Kernel and plain version read the same
            # bf16 rows; they part only where the plain version rounds the
            # probabilities to bf16, as the reference does, which moves each
            # slot's outputs by under 1 % of their RMS.  The 3e-2 above is of
            # the order of those outputs, so hold each slot to its own scale.
            ratio = slot_ratio(got, want)
            require(ratio <= SLOT_REL_TOL, f"paged {name} bf16 pages: a slot's error is "
                    f"{ratio:.3g} of its RMS, over {SLOT_REL_TOL}")
            log(f"paged {name} bf16 pages: worst slot error / slot RMS {ratio:.3g} "
                f"(limit {SLOT_REL_TOL})")
        for pool in ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages"):
            if pool in case:
                require(torch.equal(kern_in[pool][1:], plain_in[pool][1:]), pool)
        if (page_dtype, q_dtype) == (bf16, f32) and name not in records:
            # the serving paths' case: bf16 pages, fp32 query
            kern = lambda: PA.paged_attention_scatter(**kern_in, window=window)  # noqa: E731
            ms = time_ms(torch, kern)
            plain_ms = time_ms(torch, lambda: PA.paged_attention_scatter_plain(
                **plain_in, window=window))
            b_ms, b_by = paged_bound(case, pos, window)
            records[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=paged_sdpa_ms(torch, case, window))
            rec = records[name]
            log(f"paged timing, {name} shapes {shape} window {window}: " + json.dumps(rec)
                + f"; plan {json.dumps(paged_plan(PA, case, window))}; "
                f"{rec['ms'] / rec['library_ms']:.3f} x SDPA, "
                f"{100 * rec['bound_ms'] / rec['ms']:.1f} % of the bound; "
                f"host issue {host_ms(torch, kern):.4f} ms")
            # the split walk's combine runs in a fixed order: a second launch
            # on the same inputs gives the same bits
            again = {k: v.clone() for k, v in case.items()}
            first = {k: v.clone() for k, v in case.items()}
            require(torch.equal(PA.paged_attention_scatter(**first, window=window),
                                PA.paged_attention_scatter(**again, window=window)),
                    f"paged {name}: two launches on the same inputs differ")
    phase_paged_wide_table(torch, PA, rng)
    return records


def phase_paged_wide_table(torch, PA, rng):
    """The split plan is sized from the table width, not from the positions.
    llama3.2-1b's shapes (bf16 pages, fp32 query, no window) with 7 slots
    near position 2000 (and the idle one), timed beside SDPA over the same
    pages with the table as wide as the live pages (what the engine's
    decode step passes) and four times wider (a caller that passes the
    whole table of an engine built for 8192 tokens).  Logged only."""
    shape = dict(b=8, hkv=8, g=4, d=64, page=16)
    pos = rng.integers(1968, 2000, shape["b"]).astype(np.int32)
    pos[-1] = 0
    for m in (int(pos.max()) // shape["page"] + 1, 512):
        case, _ = paged_case(torch, rng, torch.bfloat16, torch.float32, m=m, pos_lo=0, **shape)
        table = case["table"].cpu().numpy()
        case.update(pos=torch.from_numpy(pos).cuda(),
                    page_idx=torch.from_numpy(table[np.arange(shape["b"]),
                                                    pos // shape["page"]]).cuda(),
                    off=torch.from_numpy(pos % shape["page"]).cuda())
        plain_in = {k: v.clone() for k, v in case.items()}
        want = PA.paged_attention_scatter_plain(**plain_in, window=0)
        got = PA.paged_attention_scatter(**{k: v.clone() for k, v in case.items()}, window=0)
        err = compare(torch, got, want, BF16_TOL, f"paged llama3.2-1b table width {m}")
        ratio = slot_ratio(got, want)
        require(ratio <= SLOT_REL_TOL, f"paged llama3.2-1b table width {m}: a slot's error "
                f"is {ratio:.3g} of its RMS, over {SLOT_REL_TOL}")
        ms = time_ms(torch, lambda: PA.paged_attention_scatter(**case, window=0))
        sdpa = paged_sdpa_ms(torch, case, 0)
        b_ms, _ = paged_bound(case, pos.tolist(), 0)
        log(f"paged timing, llama3.2-1b shapes at positions {pos.tolist()}, table width {m}: "
            + json.dumps(dict(max_abs_err=err, ms=ms, library_ms=sdpa, bound_ms=b_ms))
            + f"; plan {json.dumps(paged_plan(PA, case, 0))}; {ms / sdpa:.3f} x SDPA, "
            f"{100 * b_ms / ms:.1f} % of the bound")


# the serving paths' RMSNorm calls: (rows, d) of decode steps (8 rows) and joins;
# from (8, 1536) on, the other families' (granite 1536, internvl2 896 with its
# 256-row prefix, glm4 and internlm2 4096 and 2048, mixtral 6144)
NORM_SHAPES = ((8, 2560), (128, 2560), (2032, 2560), (8, 2048), (128, 2048), (8, 768),
               (128, 768), (2000, 768), (8, 1536), (128, 1536), (8, 896), (128, 896),
               (384, 896), (8, 4096), (128, 4096), (8, 6144), (128, 6144))


def phase_rmsnorm(torch, RN):
    """RMSNorm at every path shape, fp32 and bf16 x (fp32 params), held to
    its plain version; a second launch must give the same bits; rows whose
    width is no multiple of the vector width (scalar loads; at 8190 a row
    cut over a cluster of 2 CTAs) too.  fp32, as the paths run it, is timed
    at every shape beside the plain version, ``F.rms_norm`` and the bound,
    and an empty kernel is timed with the same harness: the launch floor.
    Returns the records by (rows, d)."""
    import torch.nn.functional as F

    rng = np.random.default_rng(1)
    records = {}
    for rows, d in NORM_SHAPES + ((8, 2558), (8, 8190)):
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(torch, rng, rows, d, dtype=dtype, std=2.0)
            scale = randn(torch, rng, d, mean=1.0, std=0.2)      # fp32 params
            got = RN.rmsnorm(x, scale)
            want = RN.rmsnorm_plain(x, scale)
            err = compare(torch, got, want, F32_TOL if dtype == torch.float32 else BF16_TOL,
                          f"rmsnorm {rows} x {d} {dtype}")
            require(torch.equal(RN.rmsnorm(x, scale), got),
                    f"rmsnorm {rows} x {d} {dtype}: two launches differ")
            if dtype == torch.float32 and (rows, d) in NORM_SHAPES:
                w = scale.to(dtype)
                nbytes = 2 * x.numel() * x.element_size() + scale.numel() * 4
                b_ms, b_by = bound(nbytes, 4 * x.numel())
                rec = dict(max_abs_err=err, ms=time_ms(torch, lambda: RN.rmsnorm(x, scale)),
                           plain_ms=time_ms(torch, lambda: RN.rmsnorm_plain(x, scale)),
                           bound_ms=b_ms, bound_by=b_by,
                           library_ms=time_ms(torch, lambda: F.rms_norm(x, (d,), w, 1e-6)))
                log(f"rmsnorm timing, {rows} x {d} fp32: " + json.dumps(rec)
                    + f"; plan {RN.plan(d, 4)._asdict()}; "
                    f"{rec['ms'] / rec['library_ms']:.3f} x F.rms_norm")
                records[rows, d] = rec
    floor = time_ms(torch, lambda: RN.empty(torch.device("cuda")))
    log(f"launch floor (an empty kernel of one warp, same harness): {floor:.5f} ms")
    rmsnorm_cluster_split(torch, RN, rng)
    return records


def rmsnorm_cluster_split(torch, RN, rng):
    """The decode calls (8 rows, fp32) under the wrapper's plan (a CTA a
    row) and split over a thread block cluster of C CTAs of about 128
    vectors each, one vector a thread (C 8, 4, 2 at d 2560, 2048, 768):
    both held to the plain version and timed, in turns.  Logged only."""
    lib = RN.build()

    def launch(x, scale, out, pl):
        rc = lib.repro_rmsnorm(0, 0, x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                               x.shape[0], x.shape[1], 1e-6, pl.vec, pl.vpt, pl.threads,
                               pl.cluster, torch.cuda.current_stream().cuda_stream)
        require(rc == 0, f"rmsnorm launch with plan {pl}: {rc}")

    for d, cluster in ((2560, 8), (2048, 4), (768, 2)):
        x = randn(torch, rng, 8, d, std=2.0)
        scale = randn(torch, rng, d, mean=1.0, std=0.2)
        want = RN.rmsnorm_plain(x, scale)
        span = d // 4 // cluster
        plans = dict(cta=RN.plan(d, 4), cluster=RN.Plan(4, 1, 32 * -(-span // 32), cluster))
        out = {k: torch.empty_like(x) for k in plans}
        for k, pl in plans.items():
            launch(x, scale, out[k], pl)
            compare(torch, out[k], want, F32_TOL, f"rmsnorm 8 x {d} fp32, plan {k}")
        ms = {k: [] for k in plans}
        for k in ("cta", "cluster", "cluster", "cta"):
            ms[k].append(time_ms(torch, lambda: launch(x, scale, out[k], plans[k])))
        log(f"rmsnorm 8 x {d} fp32: a CTA a row {plans['cta']._asdict()}: "
            f"{ms['cta'][0]:.5f} / {ms['cta'][1]:.5f} ms; a cluster of {cluster} "
            f"{plans['cluster']._asdict()}: {ms['cluster'][0]:.5f} / {ms['cluster'][1]:.5f} ms")


def phase_sampling(torch):
    """The sampler (``repro_torch.jrandom``, the draws of ``jax.random``) on
    the card against the same draws on the CPU, over (8, V) logits at the
    three paths' vocabularies: bits and uniforms bit-equal, tokens equal
    but for near ties (the two highest perturbed scores within 1e-5
    relative).  The decode step's draw (``serve.engine.sample_rows``, 8
    keyed slots at T 0.8) is timed on the card (events, and the kernels'
    summed time under the profiler, which the host's issue cannot stretch)
    and its launches counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import jrandom
    from repro_torch.serve.engine import _tempered, sample_rows

    for vocab in (128256, 256000, 50280):
        key = jrandom.fold_in(jrandom.key(0), vocab)
        card_key = key.to("cuda")
        require(torch.equal(jrandom.bits(card_key, (8, vocab)).cpu(),
                            jrandom.bits(key, (8, vocab))),
                f"sampler bits differ on the card, V {vocab}")
        require(torch.equal(jrandom.uniform(card_key, (8, vocab)).cpu(),
                            jrandom.uniform(key, (8, vocab))),
                f"sampler uniforms differ on the card, V {vocab}")
        logits = torch.from_numpy(
            np.random.default_rng(vocab).normal(0, 3, (8, vocab)).astype(np.float32))
        keys = jrandom.fold_in(jrandom.fold_in(key, torch.arange(8)), 5)
        rows = list(range(8))
        want = sample_rows(logits, rows, keys, 0.8)
        on_card = logits.to("cuda")
        got = sample_rows(on_card, rows, keys, 0.8).cpu()
        scaled = _tempered(logits, 0.8)
        ties = 0
        for r in torch.nonzero(got != want).flatten().tolist():
            g = jrandom.gumbel(keys[r], (vocab,)) + scaled[r]
            second, top = g.double().topk(2).values.tolist()[::-1]
            require(top - second <= 1e-5 * abs(top),
                    f"sampler V {vocab} row {r}: card {got[r]} CPU {want[r]} off a near tie")
            ties += 1
        draw = lambda: sample_rows(on_card, rows, keys, 0.8)      # noqa: E731
        draw()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            draw()
            torch.cuda.synchronize()
        on_device = [e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        n_kernels = sum(e.count for e in on_device)
        kernel_ms = sum(e.self_device_time_total for e in on_device) / 1e3
        log(f"sampling V {vocab}: card == CPU bits and uniforms over (8, {vocab}); tokens "
            f"equal in {8 - ties}/8 rows, {ties} near ties; one step's draw (8 keyed slots, "
            f"T 0.8): device {time_ms(torch, draw):.4f} ms between events, kernels summed "
            f"{kernel_ms:.4f} ms, host issue {host_ms(torch, draw, reps=20):.4f} ms, "
            f"{n_kernels} device launches")


def phase_scan(torch, RS):
    """The RG-LRU scan at recurrentgemma's long prefill (the record) and at
    a 128-token join, B 1, W 2560, with h0: held to its plain version and
    to ``scan_model`` (the kernel's order of operations, within an ulp of
    max(|h|, 1)), a second launch bit-equal, its plan logged, timed beside
    its plain version and its bound.  ``library_ms`` is None: no single
    PyTorch call computes a first-order linear recurrence (``cumsum`` and
    ``cumprod`` are its special cases a = 1 and b = 0)."""
    rng = np.random.default_rng(2)
    record = None
    for b, s, w in ((1, 2032, 2560), (1, 128, 2560)):
        a = torch.from_numpy(rng.uniform(0.3, 0.999, (b, s, w)).astype(np.float32)).to("cuda")
        bb = randn(torch, rng, b, s, w, std=0.3)
        h0 = randn(torch, rng, b, w)
        got = RS.rglru_scan(a, bb, h0)
        err = compare(torch, got, RS.linear_scan(a, bb, h0)[0], F32_TOL,
                      f"rglru_scan B {b} S {s} W {w} with h0")
        same = torch.equal(RS.rglru_scan(a, bb, h0), got)
        require(same, f"rglru_scan S {s}: two launches on the same inputs differ")
        plan = RS.scan_plan(b, s, w, RS.sm_count(a.device))
        require(RS.build().repro_rglru_scan_shared_bytes() == RS.SHARED_BYTES,
                f"rglru_scan: the kernel's shared bytes differ from {RS.SHARED_BYTES}")
        model = RS.scan_model(a.cpu().numpy(), bb.cpu().numpy(), h0.cpu().numpy())
        ulps = np.abs(got.cpu().numpy() - model) / np.spacing(
            np.maximum(np.abs(model), np.float32(1)))
        require(float(ulps.max()) <= 1, f"rglru_scan S {s}: {ulps.max()} ulp from scan_model")
        b_ms, b_by = bound(3 * a.numel() * 4 + h0.numel() * 4, 2 * a.numel())
        rec = dict(max_abs_err=err, ms=time_ms(torch, lambda: RS.rglru_scan(a, bb, h0)),
                   plain_ms=time_ms(torch, lambda: RS.linear_scan(a, bb, h0)),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
        # the same bytes without the recurrence: what a streaming elementwise
        # op reaches on this card (a yardstick of the rate, not of the function)
        out = torch.empty_like(a)
        mul_ms = time_ms(torch, lambda: torch.mul(a, bb, out=out))
        cut = dict(plan._asdict(), lanes=RS.LANES, segs=RS.SEGS, seg=RS.SEG)
        log(f"rglru_scan timing, B {b} S {s} W {w}: " + json.dumps(rec)
            + f"; plan {json.dumps(cut)}; {100 * b_ms / rec['ms']:.1f} % of the "
            f"bound; a second launch bit-equal: {same}; off scan_model by at most "
            f"{float(ulps.max()):.0f} ulp; torch.mul(a, b) into h, the same bytes: "
            f"{mul_ms:.5f} ms ({rec['ms'] / mul_ms:.3f} x)")
        record = record or rec
    return record


def flash_pairs(s, window, causal):
    """The unmasked (query, key) pairs of one head."""
    if causal:
        return sum(min(i + 1, window) if window else i + 1 for i in range(s))
    return sum(min(s, s - i + window - 1) if window else s for i in range(s))


def flash_mask(torch, s, window, causal):
    idx = torch.arange(s, device="cuda")
    mask = torch.ones((s, s), dtype=torch.bool, device="cuda")
    if causal:
        mask &= idx[None, :] <= idx[:, None]
    if window:
        mask &= idx[None, :] > idx[:, None] - window
    return mask


def phase_flash(torch, FA):
    """Flash against its plain version at the serving paths' shapes (causal,
    fp32 as the paths promote), then the non-causal mode; each serving
    shape timed beside SDPA with the same mask and beside its bound (fp32
    CUDA cores, the table's column) and its 3xTF32 tensor-core bound
    (logged).  Returns the records by case name."""
    import torch.nn.functional as F

    rng = np.random.default_rng(3)
    records = {}
    cases = (("recurrentgemma-2b", 10, 1, 2032, 256, 2048, True, True),
             ("recurrentgemma-2b", 10, 1, 2304, 256, 2048, True, False),
             ("recurrentgemma-2b", 10, 1, 128, 256, 2048, True, True),
             ("llama3.2-1b", 32, 8, 128, 64, 0, True, True),
             ("granite-moe-3b-a800m", 24, 8, 128, 64, 0, True, True),
             ("internvl2-1b, prefix 256", 14, 2, 384, 64, 0, True, True),
             ("glm4-9b", 32, 2, 128, 128, 0, True, True),
             ("olmo-1b", 16, 16, 128, 128, 0, True, True),
             ("mixtral-8x22b", 48, 8, 128, 128, 4096, True, True),
             ("musicgen-large, prefix 64", 32, 32, 192, 64, 0, True, True),
             ("non-causal", 10, 1, 2032, 256, 0, False, True),
             ("non-causal", 32, 8, 128, 64, 0, False, True),
             ("non-causal, ragged", 4, 2, 45, 32, 16, False, False))
    for name, hq, hkv, s, d, window, causal, timed in cases:
        q = randn(torch, rng, 1, hq, s, d)                      # fp32, as the path promotes
        k = randn(torch, rng, 1, hkv, s, d)
        v = randn(torch, rng, 1, hkv, s, d)
        pos = torch.arange(s, device="cuda", dtype=torch.int32)

        def kern():
            return FA.flash_attention(q, k, v, window=window, causal=causal)

        got = (FA.flash_attention(q, k, v, positions=pos, window=window) if causal else kern())
        what = f"flash {name} Hq {hq} Hkv {hkv} S {s} D {d} window {window} causal {causal}"
        err = compare(torch, got, FA.flash_attention_plain(q, k, v, window=window, causal=causal),
                      F32_TOL, what)
        require(torch.equal(got, kern()), f"{what}: two launches on the same inputs differ")
        if not timed:
            continue
        flops = 4 * d * hq * flash_pairs(s, window, causal)
        nbytes = 4 * (2 * q.numel() + 2 * k.numel())
        b_ms, b_by = bound(nbytes, flops)
        reps = 20 if s > 1000 else 50
        mask = flash_mask(torch, s, window, causal)
        rec = dict(
            max_abs_err=err, ms=time_ms(torch, kern, reps=reps),
            plain_ms=time_ms(torch, lambda: FA.flash_attention_plain(
                q, k, v, window=window, causal=causal), reps=min(reps, 10)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), reps=reps))
        tc_ms = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)[0]
        log(f"flash timing, {what}: " + json.dumps(rec)
            + f"; 3xTF32 tensor-core bound {tc_ms:.5f} ms; {rec['ms'] / rec['library_ms']:.3f} x "
            f"SDPA, {rec['ms'] / rec['plain_ms']:.3f} x plain, "
            f"{100 * tc_ms / rec['ms']:.1f} % of the tensor-core bound")
        records.setdefault(name, rec)          # recurrentgemma's: its 2032-token prefill
    return records


def ssd_bound(b, s, h, p, n, chunk, with_init, products=1, flops_per_s=FP32_FLOPS_PER_S):
    """x read and y written once, b, c, dt, a_log and the states once; the
    operations the function needs at the least: C.B^T once per batch and
    chunk (shared by the heads) over its causal half, then per head the
    causal (C.B^T . decay) x.dt, the carried state's C.S and its update."""
    q = min(chunk, s)
    rows = [min(q, s - c0) for c0 in range(0, s, q)]
    pairs = sum(r * (r + 1) // 2 for r in rows)
    flops = b * (2 * n * pairs + h * (2 * p * pairs + 4 * s * n * p))
    nbytes = 4 * (b * (2 * s * h * p + 2 * s * n + s * h + (2 if with_init else 1) * h * p * n)
                  + h)
    return bound(nbytes, products * flops, flops_per_s)


def phase_ssd(torch, SSD):
    """mamba2-130m's prefill scan: y and the final state against
    ``ssd_chunked``, S ragged and even, from zeros and from a state."""
    rng = np.random.default_rng(4)
    b, h, p, n, chunk = 1, 24, 64, 128, 128
    record = None
    for s in (2000, 2048):
        x = randn(torch, rng, b, s, h, p)
        # softplus(dt + dt_bias) with dt_bias in [-4, -1]; A = -exp(A_log), A_log in [0, log 16]
        dt = torch.from_numpy(rng.uniform(0.001, 0.2, (b, s, h)).astype(np.float32)).to("cuda")
        a_log = torch.from_numpy(-rng.uniform(1.0, 16.0, h).astype(np.float32)).to("cuda")
        bb = randn(torch, rng, b, s, n)
        cc = randn(torch, rng, b, s, n)
        for h0 in (None, randn(torch, rng, b, h, p, n, std=0.1)):
            y, state = SSD.ssd_scan(x, dt, a_log, bb, cc, chunk=chunk, init_state=h0)
            want_y, want_state = SSD.ssd_chunked(x, dt, a_log, bb, cc, chunk, h0)
            what = f"ssd B {b} S {s} H {h} P {p} N {n} chunk {chunk} " + (
                "zero state" if h0 is None else "random state")
            err = max(compare(torch, y, want_y, SSD_TOL, what + ": y"),
                      compare(torch, state, want_state, SSD_TOL, what + ": final state"))
        if s == 2048:      # the serving prefill passes its cache's (zero) state: time with one
            record = ssd_timing(torch, SSD, err, x, dt, a_log, bb, cc, chunk, h0, reps=20)
    # the common join, a 128-token prompt: one chunk a head
    s = 128
    x = randn(torch, rng, b, s, h, p)
    bb, cc = randn(torch, rng, b, s, n), randn(torch, rng, b, s, n)
    dt = torch.from_numpy(rng.uniform(0.001, 0.2, (b, s, h)).astype(np.float32)).to("cuda")
    h0 = randn(torch, rng, b, h, p, n, std=0.1)
    y, state = SSD.ssd_scan(x, dt, a_log, bb, cc, chunk=chunk, init_state=h0)
    want_y, want_state = SSD.ssd_chunked(x, dt, a_log, bb, cc, chunk, h0)
    err = max(compare(torch, y, want_y, SSD_TOL, f"ssd S {s}: y"),
              compare(torch, state, want_state, SSD_TOL, f"ssd S {s}: final state"))
    ssd_timing(torch, SSD, err, x, dt, a_log, bb, cc, chunk, h0, reps=50)
    return record


def ssd_timing(torch, SSD, err, x, dt, a_log, bb, cc, chunk, h0, reps):
    """Time the SSD scan beside ``ssd_chunked`` and its bounds (fp32 CUDA
    cores, the table's column; 3xTF32 tensor cores, logged); check that a
    second launch gives the same bits."""
    b, s, h, p = x.shape
    n = bb.shape[-1]

    def kern():
        return SSD.ssd_scan(x, dt, a_log, bb, cc, chunk=chunk, init_state=h0)

    first, again = kern(), kern()
    require(all(torch.equal(u, w) for u, w in zip(first, again)),
            f"ssd S {s}: two launches on the same inputs differ")
    b_ms, b_by = ssd_bound(b, s, h, p, n, chunk, True)
    tc_ms = ssd_bound(b, s, h, p, n, chunk, True, 3, TF32_FLOPS_PER_S)[0]
    rec = dict(max_abs_err=err, ms=time_ms(torch, kern, reps=reps),
               plain_ms=time_ms(torch, lambda: SSD.ssd_chunked(x, dt, a_log, bb, cc, chunk, h0),
                                reps=min(reps, 20)),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"ssd timing, B {b} S {s} H {h} P {p} N {n} chunk {chunk}: " + json.dumps(rec)
        + f"; 3xTF32 tensor-core bound {tc_ms:.5f} ms; {rec['ms'] / rec['plain_ms']:.3f} x "
        f"ssd_chunked; {100 * tc_ms / rec['ms']:.1f} % of the tensor-core bound")
    return rec


def phase_ops(torch, mods):
    """The ``kernels.ops`` surface: scatter then attention through the
    unfused kernels, held bit-equal to the fused step, with every count set
    to 0 before and read after; then each unfused kernel against its plain
    version.  Returns (counts, records)."""
    from repro_torch.kernels import ops

    PA = mods["PA"]
    rng = np.random.default_rng(5)
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    small = dict(b=3, hkv=2, g=2, d=32, page=8, m=4, pos_lo=0)       # the reference's test
    llama = dict(b=8, hkv=8, g=4, d=64, page=16, m=11, pos_lo=128)
    rgemma = dict(b=8, hkv=1, g=10, d=256, page=16, m=144, pos_lo=2000)
    pools_of = ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages")
    rows_of = ("k_new", "v_new", "k_scale_new", "v_scale_new")
    cases = [(small, f32, 0), (small, f32, 12), (small, i8, 0), (small, i8, 12),
             (llama, bf16, 0), (llama, f32, 12), (llama, i8, 12),
             (rgemma, bf16, 2048), (rgemma, f32, 2048)]
    made = [paged_case(torch, rng, page_dtype, f32, **shape)[0]
            for shape, page_dtype, _ in cases]
    torch.cuda.synchronize()
    reset(mods)
    for (shape, page_dtype, window), case in zip(cases, made):
        fused = {k: v.clone() for k, v in case.items()}
        split = {k: v.clone() for k, v in case.items()}
        quant = page_dtype == i8
        names = pools_of if quant else pools_of[:2]
        rows = rows_of if quant else rows_of[:2]
        sched = [split[k] for k in ("table", "pos")]
        if quant:
            out, _ = ops.paged_attention_scatter_quant(
                fused["q"], *(fused[k] for k in rows), *(fused[k] for k in names),
                fused["table"], fused["pos"], fused["page_idx"], fused["off"], window=window)
            pools = ops.paged_scatter_quant(*(split[k] for k in names),
                                            *(split[k] for k in rows),
                                            split["page_idx"], split["off"])
            want = ops.paged_attention_quant(split["q"], *pools, *sched, window=window)
        else:
            out, _ = ops.paged_attention_scatter(
                fused["q"], *(fused[k] for k in rows), *(fused[k] for k in names),
                fused["table"], fused["pos"], fused["page_idx"], fused["off"], window=window)
            pools = ops.paged_scatter(*(split[k] for k in names), *(split[k] for k in rows),
                                      split["page_idx"], split["off"])
            want = ops.paged_attention(split["q"], *pools, *sched, window=window)
        torch.cuda.synchronize()
        require(torch.equal(out, want), f"fused != scatter then attention: {shape} "
                f"{page_dtype} window {window}")
        for k in names:
            require(torch.equal(fused[k], split[k]), f"fused pools != scattered: {k}")
    counts = counts_of(mods)
    n = len(cases)
    want = dict({k: 0 for k in KERNELS}, paged_attention_scatter=n, paged_attention=n,
                paged_scatter=n)
    require(counts == want, f"ops path: launches {counts}, want {want}")
    log(f"ops path: fused == scatter then attention, bit for bit, outputs and pools, "
        f"in {n} cases (quant off/on, window 0/12 at the reference's shapes; llama and "
        f"recurrentgemma decode shapes); launches {counts}")

    records = {}
    for shape, page_dtype, window in ((llama, bf16, 0), (llama, f32, 0), (llama, i8, 64),
                                      (rgemma, f32, 2048), (rgemma, bf16, 2048)):
        case, pos = paged_case(torch, rng, page_dtype, f32, **shape)
        pool = {k: case[k] for k in pools_of if k in case}
        name = "llama3.2-1b" if shape is llama else "recurrentgemma-2b"

        def kern():
            return PA.paged_attention(case["q"], **pool, table=case["table"], pos=case["pos"],
                                      window=window)

        def plain():
            return PA.paged_attention_plain(case["q"], **pool, table=case["table"],
                                            pos=case["pos"], window=window)

        got, want = kern(), plain()
        what = f"paged_attention {name} pages {page_dtype} window {window}"
        err = compare(torch, got, want, BF16_TOL if page_dtype == bf16 else F32_TOL, what)
        if page_dtype == bf16:
            ratio = slot_ratio(got, want)
            require(ratio <= SLOT_REL_TOL, f"{what}: a slot's error is {ratio:.3g} of its RMS")
            log(f"{what}: worst slot error / slot RMS {ratio:.3g} (limit {SLOT_REL_TOL})")
        if (shape, page_dtype) == (rgemma, bf16):
            b_ms, b_by = paged_bound(case, pos, window, scatter=False)
            records["paged_attention"] = dict(
                max_abs_err=err, ms=time_ms(torch, kern), plain_ms=time_ms(torch, plain),
                bound_ms=b_ms, bound_by=b_by, library_ms=paged_sdpa_ms(torch, case, window))
            log(f"paged_attention timing, {name}: " + json.dumps(records["paged_attention"])
                + f"; plan {json.dumps(paged_plan(PA, case, window))}")

    for shape, page_dtype, dup in ((llama, bf16, False), (llama, i8, False), (llama, f32, True),
                                   (rgemma, bf16, False)):
        case, _ = paged_case(torch, rng, page_dtype, f32, **shape)
        if dup:                           # three slots on one destination: the last wins
            case["page_idx"][:3] = case["page_idx"][0]
            case["off"][:3] = case["off"][0]
        names = [k for k in pools_of if k in case]
        rows = [k for k in rows_of if k in case]
        kern_in = {k: v.clone() for k, v in case.items()}
        plain_in = {k: v.clone() for k, v in case.items()}

        def kern():
            return PA.paged_scatter([kern_in[k] for k in names], [kern_in[k] for k in rows],
                                    kern_in["page_idx"], kern_in["off"])

        def plain():
            return PA.paged_scatter_plain([plain_in[k] for k in names],
                                          [plain_in[k] for k in rows],
                                          plain_in["page_idx"], plain_in["off"])

        kern()
        plain()
        torch.cuda.synchronize()
        for k in names:
            require(torch.equal(kern_in[k], plain_in[k]), f"paged_scatter {k} != plain")
        if dup:
            pi, of = int(case["page_idx"][0]), int(case["off"][0])
            require(torch.equal(kern_in["k_pages"][pi, of], case["k_new"][2]), "last row wins")
        log(f"kernel ok: paged_scatter {shape['b']} rows of ({shape['hkv']}, {shape['d']}) "
            f"{page_dtype}{' with duplicate destinations' if dup else ''}: bit-equal to plain")
        if (shape, page_dtype) == (rgemma, bf16):
            b_rows = 2 * case["k_new"].numel() * case["k_new"].element_size()
            b_ms, b_by = bound(2 * b_rows + 4 * 2 * shape["b"], 0)
            records["paged_scatter"] = dict(
                max_abs_err=0.0, ms=time_ms(torch, kern), plain_ms=time_ms(torch, plain),
                bound_ms=b_ms, bound_by=b_by, library_ms=scatter_index_put_ms(torch, case))
            log("paged_scatter timing, recurrentgemma-2b: " + json.dumps(records["paged_scatter"]))
    return counts, records


def scatter_index_put_ms(torch, case):
    """One ``index_put_`` that writes the same rows (the slots' K and V rows)
    to the same destinations (page, offset), into the K and V pools stacked
    as one (2, pages, page, Hkv, D) tensor, so that one PyTorch call does the
    kernel's work; the copy of the pools is made once, before the timing."""
    pools = torch.stack([case["k_pages"], case["v_pages"]])
    rows = torch.cat([case["k_new"], case["v_new"]])
    b = case["k_new"].shape[0]
    which = torch.arange(2, device="cuda").repeat_interleave(b)
    index = (which, case["page_idx"].long().repeat(2), case["off"].long().repeat(2))
    pools.index_put_(index, rows)
    torch.cuda.synchronize()
    require(torch.equal(pools[0][index[1][:b], index[2][:b]], case["k_new"]), "index_put_")
    return time_ms(torch, lambda: pools.index_put_(index, rows))


# --------------------------------------------------------------------------
# serving, step checks, reduced models
# --------------------------------------------------------------------------

def reset(mods) -> None:
    for mod, count, _, _ in KERNELS.values():
        setattr(mods[mod], count, 0)


def counts_of(mods):
    return {name: getattr(mods[mod], count) for name, (mod, count, _, _) in KERNELS.items()}


def phase_serving(torch, mods, argv, want_dims, subscribers=()):
    """Serve through ``run_continuous`` (``subscribers`` join the governor
    on its event bus); check every kernel's launch count against what the
    path needs.  Returns (counts, engine, result, objects)."""
    from repro_torch.launch import serve

    args = serve.parser().parse_args(argv)
    reset(mods)
    res = serve.run_continuous(args, subscribers=subscribers)
    counts = counts_of(mods)
    objs = res.pop("objects")
    eng = objs["engine"]
    cfg = eng.cfg
    require((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.vocab) == want_dims,
            cfg)
    require(eng.attn_kernel == "cuda", eng.attn_kernel)
    require(eng._fused_sample == (args.temperature <= 0), "greedy steps fuse the argmax")
    kinds = cfg.layer_kinds()
    joins, steps = eng.n_joins, eng.n_decode_steps      # the warm-up's included
    # the RMSNorm kernel runs every norm of an RMSNorm arch; LayerNorm and the
    # nonparametric norm (musicgen, olmo) are plain PyTorch, as the reference's XLA
    norms = (sum(1 if k == "ssm" else 2 for k in kinds) + 1) if cfg.norm == "rmsnorm" else 0
    want = dict(paged_attention_scatter=steps * kinds.count("attn"),
                paged_attention=0, paged_scatter=0,
                flash_attention=joins * kinds.count("attn"),
                rmsnorm=(joins + steps) * norms,
                ssd_scan=joins * kinds.count("ssm"),
                rglru_scan=joins * kinds.count("rglru"))
    require(counts == want, f"{cfg.name}: launches {counts}, want {want}")
    require(res["priced_slack_ms"] > 0, res)
    require(res["completed"] == len(objs["requests"]), res)
    for r in objs["requests"]:
        require(len(r.out) == r.max_new and all(0 <= t < cfg.vocab for t in r.out), r.rid)
    log(f"serving {cfg.name}: " + json.dumps(res))
    log(f"serving {cfg.name}: {joins} joins, {steps} decode steps, launches {counts}")
    return counts, eng, res, objs


def serve_argv(arch, n_requests, steps, n_layers=0):
    """The serve CLI's arguments for a seeded stream of 128-token prompts:
    8 slots, page 16, Poisson arrivals at 40 req/s, seed 0; ``n_layers``
    cuts the depth."""
    return (["--arch", arch, "--continuous", "--n-requests", str(n_requests),
             "--prompt-len", "128", "--steps", str(steps), "--slots", "8", "--page-size", "16",
             "--arrival-rate", "40", "--seed", "0"]
            + (["--n-layers", str(n_layers)] if n_layers else []))


GRANITE_DIMS = (32, 1536, 24, 8, 49155)
# the other families, at full width, 4 requests of up to 16 new tokens:
# arch -> (depth served, (layers, d, heads, kv heads, vocab), why the depth is cut)
FAMILY_SERVES = {
    "internvl2-1b": (0, (24, 896, 14, 2, 151655), ""),
    "olmo-1b": (0, (16, 2048, 16, 16, 50304), ""),
    "internlm2-1.8b": (0, (24, 2048, 16, 8, 92544), ""),
    "glm4-9b": (8, (8, 4096, 32, 2, 151552),
                "8 of 40 layers (about 2.9 B parameters): all 40 would fit (9.4 B, "
                "37.6 GB in fp32), the cut keeps the script within its time limit"),
    "musicgen-large": (0, (48, 2048, 32, 32, 2048), ""),
    "mixtral-8x22b": (2, (2, 6144, 48, 8, 32768),
                      "2 of 56 layers (5.41 B parameters, 21.6 GB in fp32): all 56 are "
                      "140.6 B parameters, 562 GB in fp32, more than one card holds"),
}


def phase_granite(torch, mods):
    """Full-width, full-depth granite-moe-3b-a800m (32 layers, d 1536, 24/8
    heads, 40 experts top-8, vocab 49155; random weights from seed 0) over
    16 Poisson requests of 128-token prompts at the default temperature:
    exact launch counts (the fused paged kernel 32 a step, flash 32 a join,
    RMSNorm 65 a join and a step), then one decode step of 8 slots, kernels
    against plain, timed beside the byte bound of reading every weight once
    (the dropless decode multiplies all 40 experts of every layer).
    Returns the launch counts."""
    from repro_torch.tree import leaves

    counts, eng, res, objs = phase_serving(torch, mods, serve_argv(
        "granite-moe-3b-a800m", 16, 32), GRANITE_DIMS)
    require(all(counts[k] > 0 for k in ("paged_attention_scatter", "flash_attention",
                                        "rmsnorm")), counts)
    cfg = eng.cfg
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves(eng.params))
    n_params = sum(t.numel() for t in leaves(eng.params))
    rng = np.random.default_rng(11)
    step = phase_step_check(torch, eng, [rng.integers(0, cfg.vocab, 128).astype(np.int32)
                                         for _ in range(8)])
    b_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    log(f"granite decode step, 8 slots at position 128: host clock {step['wall_ms']:.3f} ms, "
        f"device busy {step['busy_ms']:.3f} ms; byte bound {b_ms:.4f} ms ({n_params} "
        f"parameters, {weight_bytes} bytes, each read once at 3.35 TB/s): device "
        f"{step['busy_ms'] / b_ms:.2f} x the bound, host clock {step['wall_ms'] / b_ms:.2f} x")
    del eng, objs
    torch.cuda.empty_cache()
    return counts


def phase_families(torch, mods):
    """A short serve of each other new arch at full width (``FAMILY_SERVES``;
    each cut of depth logged with its reason), launch counts checked.
    Returns the counts by arch."""
    out = {}
    for arch, (n_layers, dims, why) in FAMILY_SERVES.items():
        if n_layers:
            log(f"serving {arch} at depth {n_layers}: {why}")
        counts, eng, _, objs = phase_serving(torch, mods, serve_argv(arch, 4, 16, n_layers),
                                             dims)
        require(counts["paged_attention_scatter"] > 0 and counts["flash_attention"] > 0,
                counts)
        require((counts["rmsnorm"] > 0) == (eng.cfg.norm == "rmsnorm"), counts)
        out[arch] = counts
        del eng, objs
        torch.cuda.empty_cache()
    return out


LLAMA_DIMS = (16, 2048, 32, 8, 128256)
LLAMA_SERVE = ["--arch", "llama3.2-1b", "--continuous", "--attn-kernel", "cuda",
               "--n-requests", "16", "--prompt-len", "128", "--steps", "32",
               "--slots", "8", "--page-size", "16", "--arrival-rate", "40", "--seed", "0"]
PREDICTIVE_REQUESTS = 32      # about 100 decode phases on an H100: the first refit comes at 64


class PhaseClock:
    """Records the serve loop's phase stream in bus order and, subscribed
    right after the governor, how long the governor held each phase: the
    host time from the phase's end, when the meter publishes it, to here."""

    def __init__(self):
        self.records, self.held = [], []

    def on_phase(self, record):
        self.held.append(time.monotonic() - record.t_copy_end)
        self.records.append(record)


def check_predictive(res, objs, clock):
    """The predictive run's policy; its recorded phase stream replayed
    through a fresh governor of the same policy gives the same report and
    predictor decisions and locates each forest refit (at least one).
    Returns the indices of the phases that refit."""
    from repro_torch.core.governor import Governor
    from repro_torch.core.policies import policy_for_theta

    gov = objs["governor"]
    require(res["policy"] == gov.policy.name == "cntd_predictive", res)
    require(len(clock.records) == res["phases"] > 0, (len(clock.records), res["phases"]))
    replay = Governor(policy=policy_for_theta("predictive"))
    refits = []
    for i, rec in enumerate(clock.records):
        before = replay.tuner.predictor.n_refits
        replay.on_phase(rec)
        if replay.tuner.predictor.n_refits > before:
            refits.append(i)
    require(replay.finalize().to_dict() == objs["report"].to_dict(), "replayed report")
    require(replay.n_predictor_decisions == gov.n_predictor_decisions, "predictor decisions")
    require([tuple(d) for d in replay.predictor_log] == [tuple(d) for d in gov.predictor_log],
            "predictor log")
    n_refits = gov.tuner.predictor.n_refits
    require(n_refits >= 1 and len(refits) == n_refits == replay.tuner.predictor.n_refits,
            f"forest refits: {n_refits} live, {refits} in the replay")
    return refits


def phase_predictive(torch, mods):
    """Full-width llama3.2-1b at phase 2's load with more requests, served
    in turns under the default policy and ``--theta predictive`` (the
    guarded predictor+timeout hybrid): default, predictive, predictive,
    default.  Each run passes the serving checks and each predictive one
    ``check_predictive``; an event profiler on the bus logs its summary.
    Logged: every run's decode-step host clock, and the governor's host
    time a phase, at the refits and elsewhere."""
    from repro_torch.core.profiler import EventProfiler, hierarchical_report
    from repro_torch.serve.slack import SITE_DECODE_STEP

    argv = list(LLAMA_SERVE)
    argv[argv.index("--n-requests") + 1] = str(PREDICTIVE_REQUESTS)
    clocks = {"default": [], "predictive": []}
    for turn in ("default", "predictive", "predictive", "default"):
        clock, prof = PhaseClock(), EventProfiler()
        predictive = turn == "predictive"
        counts, eng, res, objs = phase_serving(
            torch, mods, argv + ["--theta", "predictive"] if predictive else argv, LLAMA_DIMS,
            subscribers=(clock, prof) if predictive else ())
        clocks[turn].append((res["step_ms_p50"], res["step_ms_max"], res["decode_steps"]))
        if predictive:
            refits = check_predictive(res, objs, clock)
            gov = objs["governor"]
            kinds = {}
            for d in gov.predictor_log:
                kinds[d.kind] = kinds.get(d.kind, 0) + 1
            held = np.asarray(clock.held) * 1e3
            rest = np.delete(held, refits)
            site = {SITE_DECODE_STEP: "decode step"}
            at = ", ".join(f"phase {i} ({site.get(clock.records[i].site, 'idle gap')}) "
                           f"{held[i]:.3f} ms" for i in refits)
            log(f"predictive llama3.2-1b: {len(clock.records)} phases replayed to the same "
                f"report; {gov.n_predictor_decisions} predictor decisions {json.dumps(kinds)}, "
                f"{len(refits)} forest refits over {gov.tuner.predictor.n_observations} "
                f"observations; the governor held a phase {np.median(rest):.4f} ms p50, "
                f"{rest.max():.4f} ms max without a refit; with a refit: {at}")
            log("predictive llama3.2-1b: event profiler summary "
                + json.dumps(hierarchical_report(prof)["summary"]))
            predictive_counts = counts
        del eng, objs
        torch.cuda.empty_cache()
    log(f"decode step host clock, llama3.2-1b, {PREDICTIVE_REQUESTS} requests, phase 2's "
        f"arguments otherwise, runs in turns default, predictive, predictive, default "
        f"(p50 ms, max ms, steps): {json.dumps(clocks)}; the step clock ends at the step's "
        f"synchronise, before the governor's turn")
    return predictive_counts


COLLECTIVE_MODES = ("off", "barrier", "profile")
BLOCKING_PHASES = ["barrier_enter", "barrier_exit", "copy_exit"]
ASYNC_PHASES = ["dispatch_enter", "wait_enter", "barrier_exit", "copy_exit"]


def collective_calls(torch, dist, I, x):
    """Every wrapper once on ``x`` beside its plain collective: a list of
    (name, wrapped, plain, phases of one call in profile mode)."""
    def plain_sum():
        y = x.clone()
        dist.all_reduce(y)
        return y

    def plain_gather(tiled, axis=0):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x)
        return (torch.cat if tiled else torch.stack)(parts, dim=axis)

    n = dist.get_world_size()
    calls = [("cd_psum", I.cd_psum(x), plain_sum(), BLOCKING_PHASES),
             ("cd_pmean", I.cd_pmean(x), plain_sum() / n, BLOCKING_PHASES),
             ("cd_all_gather", I.cd_all_gather(x), plain_gather(True), BLOCKING_PHASES),
             ("cd_all_gather untiled", I.cd_all_gather(x, tiled=False), plain_gather(False),
              BLOCKING_PHASES),
             ("cd_ppermute", I.cd_ppermute(x, [(0, 0)]), x.clone(), BLOCKING_PHASES)]
    h = I.cd_psum_async(x)
    calls.append(("cd_psum_async", I.cd_wait(h), plain_sum(), ASYNC_PHASES))
    h = I.cd_all_gather_async(x, tiled=False)
    calls.append(("cd_all_gather_async", I.cd_wait(h), plain_gather(False), ASYNC_PHASES))
    return calls


def median_call_ms(torch, fn, reps):
    """Median host clock of one completed call (synchronised after each)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


SPIN_CYCLES = 50_000_000          # torch.cuda._sleep: tens of ms at the H100's clocks


def arrival_check(torch, I, Governor, policy, x):
    """In a world of 1 no rank waits, so a kernel still queued when the host
    reaches a collective must not be booked as slack: the enter stamps wait
    for the device.  Before ``cd_psum`` it is the rank's own time; between
    ``cd_psum_async`` and ``cd_wait`` it is overlap."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SPIN_CYCLES)
    end.record()
    torch.cuda.synchronize()
    spin = start.elapsed_time(end) / 1e3
    require(spin > 0.01, f"spin kernel {spin} s")
    got = {}
    for pair in ("blocking", "async"):
        I.reset_instrumentation()
        gov, events = Governor(policy=policy), {}
        I.get_event_bus().subscribe(gov)
        I.set_event_sink(lambda r, p, c, t: events.setdefault(p, t))
        I.set_mode("profile")
        I.enable_events(True)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        if pair == "blocking":
            torch.cuda._sleep(SPIN_CYCLES)
            I.cd_psum(x)
        else:
            h = I.cd_psum_async(x)
            torch.cuda._sleep(SPIN_CYCLES)
            I.cd_wait(h)
        rep = gov.finalize()
        enter = "barrier_enter" if pair == "blocking" else "wait_enter"
        got[pair] = dict(slack_ms=rep.total_slack * 1e3, overlap_ms=rep.total_overlap * 1e3,
                         enter_after_ms=(events[enter] - t0) * 1e3)
        require(rep.n_calls == 1 and rep.total_slack < 0.1 * spin, (pair, got[pair], spin))
        require(events[enter] - t0 >= 0.9 * spin, (pair, got[pair], spin))
        if pair == "async":
            require(rep.total_overlap >= 0.9 * spin, (pair, got[pair], spin))
    I.reset_instrumentation()
    log(f"collectives: a {spin * 1e3:.3f} ms kernel queued before the call is not slack: "
        + json.dumps(got))


def phase_collectives(torch, card):
    """The instrumented collectives on NCCL in a world of 1 on cuda:0: every
    wrapper in every mode on fp32 tensors of 4 B and 16 MiB equal to the
    plain collective, inputs untouched, the reference's phase sequence (3
    phases blocking, 4 events of the 5-phase taxonomy async) with
    ``barrier_enter <= barrier_exit <= copy_exit`` in time; then the median
    host clock of a wrapped ``cd_psum`` in each mode, in turns."""
    import torch.distributed as dist

    from repro_torch.core import instrument as I
    from repro_torch.core.governor import Governor
    from repro_torch.core.policies import COUNTDOWN_SLACK

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        gen = torch.Generator(device="cuda").manual_seed(11)
        for nbytes in (4, 16 << 20):
            x = torch.randn(nbytes // 4, device="cuda", generator=gen)
            keep = x.clone()
            for mode in COLLECTIVE_MODES:
                events = []
                I.reset_instrumentation()
                I.set_mode(mode)
                I.enable_events(mode == "profile")
                I.set_event_sink(lambda r, p, c, t: events.append((r, p, c, t)))
                calls = collective_calls(torch, dist, I, x)
                torch.cuda.synchronize()
                for name, got, want, _ in calls:
                    require(got.shape == want.shape and torch.equal(got, want),
                            f"{name} ({mode}, {nbytes} B) differs from the plain collective")
                require(torch.equal(x, keep), f"{mode}: an input was written")
                want_ev = []
                if mode == "profile":
                    for cid, (_, _, _, phases) in enumerate(calls, start=1):
                        want_ev += [(0, p, cid) for p in phases]
                require([e[:3] for e in events] == want_ev,
                        f"{mode}, {nbytes} B: events {[e[:3] for e in events]}")
                for cid in range(1, len(calls) + 1):
                    ts = [e[3] for e in events if e[2] == cid]
                    require(ts == sorted(ts), f"call {cid}: phases out of order in time")
            log(f"collectives, {nbytes} B fp32 on NCCL (world of 1): {len(calls)} wrappers x "
                f"{len(COLLECTIVE_MODES)} modes equal to the plain collectives, "
                f"inputs untouched, phase sequences and times in order")
        arrival_check(torch, I, Governor, COUNTDOWN_SLACK, x)

        I.reset_instrumentation()
        timings = {}
        for nbytes, reps in ((4, 400), (16 << 20, 100)):
            x = torch.randn(nbytes // 4, device="cuda", generator=gen)
            ms = {m: [] for m in COLLECTIVE_MODES}
            for turn in range(4):                 # off, barrier, profile, then reversed
                for mode in (COLLECTIVE_MODES if turn % 2 == 0 else COLLECTIVE_MODES[::-1]):
                    I.reset_instrumentation()
                    I.set_mode(mode)
                    I.enable_events(mode == "profile")
                    gov = Governor(policy=COUNTDOWN_SLACK)
                    I.get_event_bus().subscribe(gov)
                    ms[mode].append(median_call_ms(torch, lambda: I.cd_psum(x), reps))
                    if mode == "profile":
                        require(gov.finalize().n_calls == reps, "governor calls")
            timings[nbytes] = {m: float(np.median(v)) for m, v in ms.items()}
            t = timings[nbytes]
            log(f"cd_psum {nbytes} B fp32, NCCL world of 1, {card}: median host clock of a "
                f"completed call (median of 4 turns of {reps}): off {t['off']:.4f} ms, barrier "
                f"{t['barrier']:.4f} ms, profile {t['profile']:.4f} ms; the barrier adds "
                f"{t['barrier'] - t['off']:.4f} ms a call, barrier and events "
                f"{t['profile'] - t['off']:.4f} ms (turns: {json.dumps(ms)})")
        I.reset_instrumentation()
        return timings
    finally:
        dist.destroy_process_group()


def step_args(eng, prompts, n_steps: int, attn_kernel=None):
    """Join ``prompts`` into a fresh engine on ``eng``'s weights, run
    ``n_steps`` decode steps through the kernels (or ``attn_kernel``), and
    return the next step's inputs (params, tokens, positions, live table)
    and the engine."""
    from repro_torch.serve.engine import ContinuousEngine, EngineSession
    from repro_torch.serve.scheduler import Request

    fresh = ContinuousEngine(eng.cfg, eng.params, n_slots=8, max_len=eng.max_len, page=16,
                             attn_kernel=attn_kernel, device="cuda")
    sess = EngineSession(fresh)
    for p in prompts:
        sess.submit(Request(prompt=p, max_new=n_steps + 8, arrival=0.0))
    sess.admit(now=0.0)
    for _ in range(n_steps):
        sess.decode_step()
    for req in sess.sched.active.values():
        fresh._grow_pages(req)             # the page the next row lands in
    m_live = int(fresh._lengths.max()) // 16 + 1
    args = (fresh.params, fresh._to_device(fresh._tokens), fresh._to_device(fresh._lengths),
            fresh._to_device(fresh._table[:, :m_live]))
    return args, fresh


def phase_join_check(torch, eng, prompts, fresh):
    """The joins of ``prompts`` through the kernels (``fresh``) against the
    plain path's: the longest slot's SSM state at the SSD bar, every layer."""
    cfg = eng.cfg
    with torch.no_grad():
        _, plain = step_args(eng, prompts, 0, attn_kernel="plain")
    torch.cuda.synchronize()
    slot = int(np.argmax(fresh._lengths))
    errs = []
    for kind, lk, lp in zip(cfg.layer_kinds(), fresh.pool.blocks["layers"],
                            plain.pool.blocks["layers"]):
        if kind == "ssm":
            torch.testing.assert_close(lk["h"][slot], lp["h"][slot], **SSD_TOL)
            errs.append(float((lk["h"][slot] - lp["h"][slot]).abs().max()))
    require(len(errs) == cfg.layer_kinds().count("ssm") > 0, "no SSM layer")
    log(f"join check {cfg.name}: the {int(fresh._lengths[slot])}-token slot's state in "
        f"{len(errs)} layers, kernels against plain: max_abs_err {max(errs):.3g} ({SSD_TOL})")


class RouteLog:
    """While active, records every MoE router call's (probs, expert ids)
    in call order: a decode step's calls are its layers in order, row r of
    each the slot r."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.calls = moe, []

    def __enter__(self):
        self.route = route = self.moe.route

        def logged(cfg, p, xf):
            out = route(cfg, p, xf)
            self.calls.append((out[0], out[2]))
            return out

        self.moe.route = logged
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


ROUTE_PROB_TOL = 1e-3     # a routing flip's near tie: the two routers' probabilities


def routing_flips(plain, kern):
    """Slots whose chosen experts differ between two decode steps' routes
    (``RouteLog.calls``), each with its first such layer.  A flip is legal
    only at a near tie: at every layer up to and including the first that
    differs, the slot's router probabilities in the two steps lie within
    ``ROUTE_PROB_TOL`` of each other, so both steps fed the router the same
    hidden state but for rounding, and the two experts that traded places
    were within 2 ROUTE_PROB_TOL.  Returns {slot: (layer, max probability
    difference up to it)}."""
    require(len(plain) == len(kern) > 0, "one router call a layer in each step")
    flips = {}
    for layer, ((_, pi), (_, ki)) in enumerate(zip(plain, kern)):
        same = (pi.sort(-1).values == ki.sort(-1).values).all(-1)       # (slots,)
        for slot in range(pi.shape[0]):
            if slot in flips or bool(same[slot]):
                continue
            drift = max(float((a[slot] - b[slot]).abs().max())
                        for (a, _), (b, _) in zip(plain[:layer + 1], kern[:layer + 1]))
            require(drift <= ROUTE_PROB_TOL,
                    f"slot {slot} routes differently at layer {layer} with router "
                    f"probabilities {drift:.3g} apart, past {ROUTE_PROB_TOL}")
            flips[slot] = (layer, drift)
    return flips


def phase_step_check(torch, eng, prompts, n_steps: int = 0, want_greedy: bool = False,
                     join_check: bool = False):
    """One full-width decode step, kernels against plain, from one pool
    state; with ``join_check``, the joins that made it against plain too.
    An MoE arch's slots are held to the bar where both steps routed them
    alike in every layer; a slot whose experts differ at some layer must do
    so at a near tie (``routing_flips``), and half the slots at least must
    route alike.  Returns the error and the step's clocks."""
    from repro_torch.serve.engine import make_paged_decode_step

    cfg = eng.cfg
    with torch.no_grad():
        args, fresh = step_args(eng, prompts, n_steps)
    if join_check:
        phase_join_check(torch, eng, prompts, fresh)
    with torch.no_grad():
        blocks_plain = copy.deepcopy(fresh.pool.blocks)
        with RouteLog() as plain_routes:
            plain, _ = make_paged_decode_step(cfg, "plain")(*args, blocks_plain)
        with RouteLog() as kern_routes:
            kern, _ = make_paged_decode_step(cfg, "cuda")(*args, fresh.pool.blocks)
        torch.cuda.synchronize()
    require(bool(torch.isfinite(kern).all()) and kern.shape == (8, cfg.vocab), "logits")
    flips = routing_flips(plain_routes.calls, kern_routes.calls) if cfg.is_moe else {}
    alike = [r for r in range(8) if r not in flips]
    require(2 * len(alike) >= 8, f"{len(flips)} of 8 slots route differently: {flips}")
    torch.testing.assert_close(kern[alike], plain[alike], **BF16_TOL)
    agree = (kern.argmax(-1) == plain.argmax(-1))
    err = float((kern[alike] - plain[alike]).abs().max())
    top2 = plain.topk(2, dim=-1).values
    gap = float((top2[:, 0] - top2[:, 1]).min())
    moe = ""
    if cfg.is_moe:
        moe = (f"; MoE routing alike in every layer for {len(alike)}/8 slots, flips at near "
               f"ties (slot: first layer, router probabilities apart up to it) "
               + json.dumps({s: [lay, d] for s, (lay, d) in flips.items()})
               + (f", their logits max_abs_err "
                  f"{float((kern - plain).abs().max()):.3g}" if flips else ""))
    log(f"step check {cfg.name} at positions {args[2].tolist()}: logits max_abs_err "
        f"{err:.3g} (atol 3e-2), greedy agreement {int(agree.sum())}/8, "
        f"smallest top-2 gap of the plain logits {gap:.4g}" + moe)
    if want_greedy:
        require(bool(agree.all()), f"greedy tokens differ: {kern.argmax(-1)} {plain.argmax(-1)}")
    with torch.no_grad():
        wall, busy = profile_step(torch, cfg, make_paged_decode_step(cfg, "cuda",
                                                                     fused_sample=True),
                                  args, fresh.pool.blocks)
    return dict(err=err, wall_ms=wall, busy_ms=busy)


def profile_step(torch, cfg, step, args, blocks, n: int = 5):
    """Where one full-width decode step's time goes: the host clock around
    synchronised steps, and the device time of every kernel from
    ``torch.profiler`` (reruns the same step; the pools are rewritten with
    the same rows, the recurrent state steps on).  Device busy is the time
    some kernel runs; per kernel, the sum of its launches' times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models.layers import _window
    from repro_torch.launch.long_join import covered_ms

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
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    busy = covered_ms(r[:2] for r in spans) / n
    paged_span = covered_ms(r[:2] for r in spans if "paged_attention" in r[2]) / n

    def by_name(name):
        return (sum(k[0] for k in kernels if name in k[2]),
                sum(k[1] for k in kernels if name in k[2]))

    # the paged step is the walk and, when it is split, the combine:
    # both kernel names start with paged_attention
    paged, walk, combine, norm = (by_name(k) for k in (
        "paged_attention", "paged_attention_kernel", "paged_attention_combine_kernel",
        "rmsnorm_kernel"))
    plan = ""
    table = args[3]
    pools = [blk for blk in blocks["layers"] if "k_pages" in blk]
    if pools:
        # the plan the wrapper launched with: slots and table width from the
        # step's table, the page size from the pools
        b, m = table.shape
        splits, run = PA.split_plan(b, cfg.n_kv_heads, m, pools[0]["k_pages"].shape[1],
                                    _window(cfg), PA.sm_count(table.device))
        plan = f" (table width {m}: {splits} splits of {run} pages)"
    log(f"decode step {cfg.name} (8 slots, full width): wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f} %; kernel times summed "
        f"{sum(k[0] for k in kernels):.3f} ms), paged kernels {paged_span:.4f} ms covered in "
        f"{paged[1]} launches{plan}, summed {paged[0]:.4f} ms: walk {walk[0]:.4f} ms ({walk[1]}), combine "
        f"{combine[0]:.4f} ms ({combine[1]}; its blocks start during the walk and wait for "
        f"it); rmsnorm kernel {norm[0]:.4f} ms, {sum(k[1] for k in kernels)} launches")
    for ms, count, key in kernels[:10]:
        log(f"  {ms:.4f} ms in {count} launches: {key[:110]}")
    return wall, busy


def phase_long_join(torch, eng, prompt):
    """One long join on ``eng``'s weights through the kernels and through the
    plain path, in turns: the host clock around a synchronised join and the
    device time of one (``repro_torch.launch.long_join``).  Logged only."""
    from repro_torch.launch.long_join import time_join

    for kernel in ("cuda", "plain"):
        rec = time_join(torch, eng.cfg, eng.params, prompt, kernel)
        log(f"long join {eng.cfg.name}, {len(prompt)} tokens, {kernel}: " + json.dumps(rec))
        if kernel == "cuda" and "rglru" in eng.cfg.layer_kinds():
            log(f"long join {eng.cfg.name}: the RG-LRU scan's device time summed over its "
                f"{eng.cfg.layer_kinds().count('rglru')} launches (one per RG-LRU layer): "
                f"{rec['prefill_kernel_ms'].get('rglru_scan', 0.0):.4f} ms")


def phase_small_model(torch, arch, n_layers, prompt_len, n_steps, max_len):
    """A reduced fp32 model: greedy tokens through the kernels on the card
    (no kernel named) equal the plain path's on the CPU, same weights (and,
    for a frontend arch, the same prefix embeddings)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ContinuousEngine

    cfg = reduced(get_config(arch), n_layers=n_layers)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = _to(params, torch, "cuda")
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (3, prompt_len)).astype(np.int32)}
    if cfg.n_prefix:
        batch["prefix_embeds"] = rng.normal(0, 0.02, (3, cfg.n_prefix, cfg.d_model)).astype(
            np.float32)
    kw = dict(n_slots=3, max_len=max_len, page=8)
    ref = ContinuousEngine(cfg, params, device="cpu", **kw)
    got = ContinuousEngine(cfg, on_card, device="cuda", **kw)
    require((ref.attn_kernel, got.attn_kernel) == ("plain", "cuda"), "default kernels")
    want = ref.generate(batch, n_steps=n_steps)
    out = got.generate(batch, n_steps=n_steps)
    require(torch.equal(out, want), (out, want))
    log(f"small model {cfg.name} ({cfg.n_layers} layers, window {cfg.window}, prefix "
        f"{cfg.n_prefix}): card tokens == CPU tokens over {tuple(out.shape)}, positions up "
        f"to {cfg.n_prefix + prompt_len + n_steps - 1}")


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

FIRST_LOSS = 12.2             # ln 128256 plus half the variance of the logits (std ~0.9)
BYTES_PER_PARAM = 16          # a parameter, its gradient and AdamW's two moments, fp32


def llama_two_layers():
    """llama3.2-1b at full width (d 2048, 32/8 heads, d_ff 8192, vocab
    128256) cut to 2 layers, computing in fp32."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("llama3.2-1b"), n_layers=2, compute_dtype="float32")


def phase_train_parity(torch, mods):
    """A 2-layer full-width llama3.2-1b (batch 2, seq 64, fp32 compute) on
    the card and on the CPU from the same parameters and batches: the
    first step's loss and gradients at the fp32 bar (loss rtol 1e-5,
    gradients atol 2e-5 / rtol 2e-4); AdamW on the card against AdamW on
    the CPU fed the card's gradients (parameters and moments atol 1e-6);
    then three ``make_train_step`` steps each side, each step's gradients
    (each side at its own parameters) compared leaf by leaf at the fp32 bar
    before it is taken: losses rtol 1e-4, grad norms rtol 1e-3.  No kernel
    is launched on the card (the training path runs plain PyTorch).
    AdamW divides each gradient by its own running RMS, so a gradient
    element within its rounding noise of zero (the embedding holds 262 M,
    most of their rows with tiny gradients) moves by up to lr whatever its
    size: the parameters after 3 steps are held to at most one element in
    a million past 1e-5 (a wrong update to any leaf, the smallest of 2048
    elements, puts all of it past), and every element within 2 lr a step
    (Adam's bias-corrected step is at most lr per element on each side;
    1 % for the decay)."""
    from repro_torch.models.inputs import make_batch
    from repro_torch.train import loop as TL
    from repro_torch.train.optimizer import OptConfig, adamw_update, decay_mask
    from repro_torch.tree import leaves

    cfg = llama_two_layers()
    opt_cfg = OptConfig(warmup_steps=1, total_steps=3)
    cpu = TL.init_state(cfg, opt_cfg, torch.Generator().manual_seed(0), "cpu")
    card = _to(cpu, torch, "cuda")
    batches = [make_batch(cfg, 2, 64, seed=20 + i) for i in range(3)]
    reset(mods)

    loss_g, _, grads_g = TL._grads(cfg, card["params"], _to(batches[0], torch, "cuda"))
    loss_c, _, grads_c = TL._grads(cfg, cpu["params"], batches[0])
    np.testing.assert_allclose(float(loss_g), float(loss_c), rtol=1e-5)
    grad_err = 0.0
    for a, b in zip(leaves(grads_g), leaves(grads_c)):
        torch.testing.assert_close(a.cpu(), b, **F32_TOL)
        grad_err = max(grad_err, float((a.cpu() - b).abs().max()))
    one_g, one_c = _to(card, torch, "cuda", copy=True), _to(card, torch, "cpu")
    decay = decay_mask(cfg, card["params"])
    adamw_update(one_g["params"], grads_g, one_g["opt"], opt_cfg, decay)
    adamw_update(one_c["params"], _to(grads_g, torch, "cpu"), one_c["opt"], opt_cfg, decay)
    opt_err = max(float((a.cpu() - b).abs().max())
                  for a, b in zip(leaves(one_g), leaves(one_c)) if a.dtype.is_floating_point)
    require(opt_err <= 1e-6, f"AdamW on the card against the CPU's, same gradients: {opt_err}")
    del grads_g, grads_c, one_g, one_c

    step = TL.make_train_step(cfg, opt_cfg)
    got, want, lrs = [], [], []
    for i, batch in enumerate(batches):
        if i:
            _, _, grads_g = TL._grads(cfg, card["params"], _to(batch, torch, "cuda"))
            _, _, grads_c = TL._grads(cfg, cpu["params"], batch)
            for a, b in zip(leaves(grads_g), leaves(grads_c)):
                torch.testing.assert_close(a.cpu(), b, **F32_TOL)
                grad_err = max(grad_err, float((a.cpu() - b).abs().max()))
            del grads_g, grads_c
        card, mg = step(card, _to(batch, torch, "cuda"))
        cpu, mc = step(cpu, batch)
        got.append((float(mg["loss"]), float(mg["grad_norm"])))
        want.append((float(mc["loss"]), float(mc["grad_norm"])))
        lrs.append(float(mc["lr"]))
    counts = counts_of(mods)
    require(not any(counts.values()), f"kernels launched on the training path: {counts}")
    got, want = np.array(got), np.array(want)
    require(np.isfinite(got).all(), got)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-3)
    diffs = [(a.cpu() - b).abs() for a, b in zip(leaves(card["params"]), leaves(cpu["params"]))]
    err = max(float(d.max()) for d in diffs)
    over = sum(int((d > 1e-5).sum()) for d in diffs)
    n = sum(d.numel() for d in diffs)
    bound = 2.02 * sum(lrs)
    require(over <= n * 1e-6, f"{over} of {n} parameters past 1e-5 after 3 steps")
    require(err <= bound, f"parameters max_abs_err {err} after 3 steps, bound {bound}")
    log(f"train parity, llama3.2-1b at full width cut to 2 layers, fp32, batch 2 x 64: "
        f"steps 1-3 gradients max_abs_err {grad_err:.3g} ({F32_TOL}); AdamW on the card against "
        f"the CPU's on the same gradients max_abs_err {opt_err:.3g} (atol 1e-6); 3 steps: "
        f"losses card {got[:, 0].tolist()} cpu {want[:, 0].tolist()}, grad norms card "
        f"{got[:, 1].tolist()} cpu {want[:, 1].tolist()}, parameters max_abs_err {err:.3g} "
        f"(<= {bound:.3g}), {over} of {n} elements past 1e-5 (<= {n * 1e-6:.0f})")


def phase_train(torch, mods, card):
    """Full-width llama3.2-1b (fp32 params, bf16 compute as configured),
    8 steps of batch 8 x 128 through ``repro_torch.launch.train``: every
    loss and grad norm finite, the first loss within 1.0 of 12.2, the mean
    of the last 3 below the first, no kernel launched.  Logs the median
    synchronised step clock after step 1, tokens/s, peak memory against 16
    bytes a parameter, and model FLOP/s (6 N T) against the fp32 peak."""
    from repro_torch.launch import train

    reset(mods)
    res = train.run(train.parser().parse_args(["--arch", "llama3.2-1b", "--steps", "8"]))
    counts = counts_of(mods)
    require(not any(counts.values()), f"kernels launched on the training path: {counts}")
    losses, gnorms = res["losses"], res["grad_norms"]
    require(len(losses) == 8 and np.isfinite(losses + gnorms).all(), res)
    require(abs(losses[0] - FIRST_LOSS) <= 1.0, f"first loss {losses[0]}")
    require(np.mean(losses[-3:]) < losses[0], f"losses {losses}")
    n, t = res["params"], res["batch"] * res["seq"]
    step_s = res["step_s_median"]
    flops = 6 * n * t / step_s
    log(f"train llama3.2-1b, {card}: {n} params, batch {res['batch']} x {res['seq']}, "
        f"losses {losses}, grad norms {gnorms}; step clock (synchronised) median after "
        f"step 1 {step_s * 1e3:.3f} ms (all: {[round(x * 1e3, 3) for x in res['step_s']]}), "
        f"{res['tokens_per_s']:.1f} tokens/s, peak memory {res['peak_mem_bytes'] / 2**30:.3f} "
        f"GiB against {BYTES_PER_PARAM * n / 2**30:.3f} GiB at {BYTES_PER_PARAM} B a "
        f"parameter, model FLOP/s (6 N T) {flops / 1e12:.2f} T, "
        f"{100 * flops / FP32_FLOPS_PER_S:.1f} % of the {FP32_FLOPS_PER_S / 1e12:.0f} TFLOP/s "
        f"fp32 peak")
    torch.cuda.empty_cache()
    profile_train_step(torch, "llama3.2-1b", res["batch"], res["seq"])
    return res


def profile_train_step(torch, arch, batch, seq, n: int = 2):
    """Where one full-width training step's time goes: the host clock of
    synchronised ``make_train_step`` steps, then the same steps under
    ``torch.profiler``: device busy (the time some kernel runs) and each
    kernel's summed device time, the matrix products (cuBLAS/CUTLASS
    ``gemm`` kernels) apart."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.long_join import covered_ms
    from repro_torch.train import loop as TL
    from repro_torch.train.data import DataLoader
    from repro_torch.train.optimizer import OptConfig

    cfg = get_config(arch)
    opt_cfg = OptConfig(warmup_steps=1, total_steps=2 * n + 1)
    state = TL.init_state(cfg, opt_cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    step = TL.make_train_step(cfg, opt_cfg)
    loader = DataLoader(cfg, batch=batch, seq_len=seq, seed=0, device="cuda")
    try:
        state, _ = step(state, next(loader))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step(state, next(loader))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                state, _ = step(state, next(loader))
            torch.cuda.synchronize()
    finally:
        loader.close()
    kernels = sorted(((e.self_device_time_total / n / 1e3, e.count // n, e.key)
                      for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     reverse=True)
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    busy = covered_ms(spans) / n
    gemm = [k for k in kernels if "gemm" in k[2].lower()]
    log(f"train step {arch} (batch {batch} x {seq}, full width, make_train_step): wall "
        f"{wall:.3f} ms, device busy {busy:.3f} ms ({100 * busy / wall:.1f} %; kernel times "
        f"summed {sum(k[0] for k in kernels):.3f} ms in {sum(k[1] for k in kernels)} "
        f"launches), matrix products {sum(k[0] for k in gemm):.3f} ms in "
        f"{sum(k[1] for k in gemm)} launches")
    for ms, count, key in kernels[:12]:
        log(f"  {ms:.4f} ms in {count} launches: {key[:110]}")


def phase_train_live(torch, mods, card):
    """``--live-events`` on NCCL in a world of 1 for 4 steps of full-width
    llama3.2-1b: the gradients and the loss reduce through ``cd_psum``, so
    the governor books 8 calls; logs the host clock of each ``cd_psum``
    over the gradient tree, from its ``barrier_enter`` (the card has
    arrived) to its ``copy_exit``.  Then, on the 2-layer full-width llama,
    ``compressed_psum``'s mean of the exact gradients equals the CPU's
    codec on them element by element and lies within ½ LSB of them (plus
    one fp32 ulp of the leaf's largest element for the roundings), and one
    ``"compressed"`` pod step has the manual step's loss and the gradient
    norm of those compressed gradients (rtol 1e-5)."""
    import torch.distributed as dist

    from repro_torch.core import instrument as I
    from repro_torch.dist.compression import _dequantize, _quantize, compressed_psum
    from repro_torch.launch import train
    from repro_torch.models.inputs import make_batch
    from repro_torch.train import loop as TL
    from repro_torch.train.optimizer import OptConfig, global_norm
    from repro_torch.tree import leaves

    events = []
    I.reset_instrumentation()
    I.set_event_sink(lambda r, p, c, t: events.append((p, c, t)))
    reset(mods)
    res = train.run(train.parser().parse_args(
        ["--arch", "llama3.2-1b", "--steps", "4", "--live-events"]))
    I.reset_instrumentation()
    require(not any(counts_of(mods).values()), "kernels launched on the training path")
    require(res["governor"]["n_calls"] == 8, res["governor"])
    require(np.isfinite(res["losses"] + res["grad_norms"]).all(), res)
    at = {(p, c): t for p, c, t in events}
    grad_ms = [(at["copy_exit", c] - at["barrier_enter", c]) * 1e3 for c in (1, 3, 5, 7)]
    loss_ms = [(at["copy_exit", c] - at["barrier_enter", c]) * 1e3 for c in (2, 4, 6, 8)]
    log(f"train --live-events llama3.2-1b, NCCL world of 1, {card}: governor "
        f"{json.dumps(res['governor'])}; step clock median after step 1 "
        f"{res['step_s_median'] * 1e3:.3f} ms; cd_psum over the gradient tree "
        f"({res['param_leaves']} leaves) host clock barrier_enter -> "
        f"copy_exit per step {[round(x, 4) for x in grad_ms]} ms, over the loss "
        f"{[round(x, 4) for x in loss_ms]} ms")

    cfg = llama_two_layers()
    opt_cfg = OptConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        init = TL.init_state(cfg, opt_cfg, torch.Generator().manual_seed(1), "cpu")
        batch = _to(make_batch(cfg, 2, 64, seed=30), torch, "cuda")
        _, _, grads = TL._grads(cfg, _to(init["params"], torch, "cuda"), batch)
        mean = compressed_psum(grads, None, mean=True)
        lsb = 0.0
        for g, c in zip(leaves(grads), leaves(mean)):
            scale = float(_quantize(g)[1])
            worst = float((c - g).abs().max())
            require(worst <= scale / 2 + 127 * scale * 2.0 ** -23,
                    f"compressed gradient off by {worst}, scale {scale}")
            lsb = max(lsb, worst / scale)
            want = _dequantize(*_quantize(g.cpu()))
            require(torch.equal(c.cpu(), want), "the card's codec differs from the CPU's")
        norm = float(global_norm(mean))
        del grads, mean
        out = {}
        for how in ("manual", "compressed"):
            step = TL.make_pod_train_step(cfg, opt_cfg, None, TL.TrainConfig(pod_reduce=how))
            out[how] = step(_to(init, torch, "cuda"), batch)
        (_, mm), (_, mc) = out["manual"], out["compressed"]
        require(torch.equal(mm["loss"], mc["loss"]), (mm["loss"], mc["loss"]))
        np.testing.assert_allclose(float(mc["grad_norm"]), norm, rtol=1e-5)
        log(f"compressed pod step, 2-layer full-width llama3.2-1b, NCCL world of 1: "
            f"compressed_psum equal to the CPU's codec on every element, largest error "
            f"{lsb:.6g} of a leaf's step (½ plus the fp32 roundings); loss equal to the manual step's, grad norm "
            f"{float(mc['grad_norm']):.6g} against the compressed gradients' {norm:.6g} and "
            f"the exact {float(mm['grad_norm']):.6g}")
    finally:
        dist.destroy_process_group()
    return grad_ms


def _to(tree, torch, device, copy=False):
    """``tree``'s tensors on ``device`` (copies, with ``copy``, even where
    they are there already)."""
    if isinstance(tree, dict):
        return {k: _to(v, torch, device, copy) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, torch, device, copy) for v in tree]
    return tree.to(device, copy=copy)


def main() -> int:
    argparse.ArgumentParser(description=__doc__,
                            formatter_class=argparse.RawDescriptionHelpFormatter).parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import rglru_scan as RS
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd as SSD

    mods = dict(PA=PA, RN=RN, RS=RS, FA=FA, SSD=SSD)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {card}")
    t0 = time.time()
    built = _build.build_all(KERNEL_SOURCES)
    log(f"built the kernels in {time.time() - t0:.1f} s (one nvcc each, in parallel): "
        + json.dumps({k: round(v, 1) for k, v in built.items()}))

    # each kernel's JSON record at its first path's shapes: recurrentgemma's
    # long prefill and decode for paged and flash, the 8 x 2560 decode norm
    timing = dict(paged_attention_scatter=phase_paged(torch, PA)["recurrentgemma-2b"],
                  rmsnorm=phase_rmsnorm(torch, RN)[8, 2560], rglru_scan=phase_scan(torch, RS),
                  flash_attention=phase_flash(torch, FA)["recurrentgemma-2b"],
                  ssd_scan=phase_ssd(torch, SSD))
    ops_counts, ops_records = phase_ops(torch, mods)
    timing.update(ops_records)
    phase_sampling(torch)

    rng = np.random.default_rng(7)
    # llama3.2-1b and recurrentgemma-2b serve at the reference's default
    # temperature (0.8, sampled); mamba2-130m greedy, the fused-argmax step
    llama_counts, eng, _, _ = phase_serving(torch, mods, LLAMA_SERVE, LLAMA_DIMS)
    phase_step_check(torch, eng, [rng.integers(0, eng.cfg.vocab, 128).astype(np.int32)
                                  for _ in range(8)])
    del eng
    torch.cuda.empty_cache()
    phase_small_model(torch, "llama3.2-1b", 2, 14, 10, 40)
    predictive_counts = phase_predictive(torch, mods)
    torch.cuda.empty_cache()

    rg_counts, eng, _, _ = phase_serving(torch, mods, [
        "--arch", "recurrentgemma-2b", "--continuous",
        "--n-requests", "12", "--prompt-len", "128", "--steps", "32", "--long-prompt", "2032",
        "--slots", "8", "--page-size", "16", "--arrival-rate", "40", "--seed", "0"],
        (26, 2560, 10, 1, 256000))
    require(all(rg_counts[k] > 0 for k in ("paged_attention_scatter", "rmsnorm",
                                           "flash_attention", "rglru_scan")), rg_counts)
    # the long request decodes to position 2063: its first page is past the window
    long_prompt = rng.integers(0, eng.cfg.vocab, 2032).astype(np.int32)
    phase_long_join(torch, eng, long_prompt)
    phase_step_check(torch, eng, [long_prompt] + [
        rng.integers(0, eng.cfg.vocab, 128).astype(np.int32) for _ in range(7)],
        n_steps=31, want_greedy=True)
    del eng
    torch.cuda.empty_cache()
    phase_small_model(torch, "recurrentgemma-2b", 8, 40, 30, 80)

    mamba_counts, eng, _, _ = phase_serving(torch, mods, [
        "--arch", "mamba2-130m", "--continuous", "--temperature", "0",
        "--n-requests", "12", "--prompt-len", "128", "--steps", "32", "--long-prompt", "2000",
        "--slots", "8", "--page-size", "16", "--arrival-rate", "40", "--seed", "0"],
        (24, 768, 0, 0, 50280))
    require(mamba_counts["ssd_scan"] > 0 and mamba_counts["rmsnorm"] > 0, mamba_counts)
    # one 2000-token prompt (16 chunks, the last ragged) beside 7 of 128
    long_prompt = rng.integers(0, eng.cfg.vocab, 2000).astype(np.int32)
    phase_long_join(torch, eng, long_prompt)
    phase_step_check(torch, eng, [long_prompt] + [
        rng.integers(0, eng.cfg.vocab, 128).astype(np.int32) for _ in range(7)],
        want_greedy=True, join_check=True)
    del eng
    torch.cuda.empty_cache()
    phase_small_model(torch, "mamba2-130m", 4, 37, 12, 64)

    # the other families: MoE at full width and depth, then the rest
    granite_counts = phase_granite(torch, mods)
    for arch in ("granite-moe-3b-a800m", "mixtral-8x22b", "internvl2-1b", "musicgen-large",
                 "olmo-1b"):
        phase_small_model(torch, arch, 2, 14, 10, 40)
    family_counts = phase_families(torch, mods)

    # each kernel's launches on its own path: the ops surface for the unfused
    # paged kernels, mamba2's for RMSNorm and the SSD scan, recurrentgemma's
    # for the rest
    paths = dict(paged_attention_scatter=rg_counts, paged_attention=ops_counts,
                 paged_scatter=ops_counts, flash_attention=rg_counts, rmsnorm=mamba_counts,
                 ssd_scan=mamba_counts, rglru_scan=rg_counts)
    require(all(paths[k][k] > 0 for k in KERNELS), paths)
    phase_collectives(torch, card)
    torch.cuda.empty_cache()
    phase_train_parity(torch, mods)
    torch.cuda.empty_cache()
    phase_train(torch, mods, card)
    torch.cuda.empty_cache()
    phase_train_live(torch, mods, card)
    log("launches on the llama3.2-1b path " + json.dumps(llama_counts)
        + "; under --theta predictive " + json.dumps(predictive_counts)
        + "; on the recurrentgemma-2b path " + json.dumps(rg_counts)
        + "; on the mamba2-130m path " + json.dumps(mamba_counts)
        + "; on the granite-moe-3b-a800m path " + json.dumps(granite_counts)
        + "; on the kernels.ops path " + json.dumps(ops_counts))
    log("launches on the other families' paths " + json.dumps(family_counts))
    print(card)
    print(json.dumps({"kernels": [dict(
        name=k, route="cuda", source=f"src/repro_torch/kernels/csrc/{src}.cu",
        replaces=replaces, launches=paths[k][k], **timing[k])
        for k, (_, _, src, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
