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
1d. **the data-split step's scatter** (``paged_scatter_step``, row 3's
   redesign): every attention layer's new rows of 8 slots, gathered from
   D = 2 fake data ranks of 4 slots as one byte buffer, written into
   full-width pools (8 slots of 11 pages of 16): llama3.2-1b (16 layers,
   Hkv 8, D 64) in bf16 and int8, granite-moe-3b-a800m (32 layers) in
   bf16, two idle slots on the scratch row and two slots of the two ranks
   on one place.  ``kvcache.share_new_rows`` with a stand-in for the
   all-gather, three calls a case, launches the kernel once a call and
   nothing else; the per-layer loop through the per-call scatter kernel
   and the plain version on copies of the pools leave them bit-equal; a
   call's device operations (the nodes of a CUDA graph that captures it)
   are the kernel's 1 against the loop's 3 L (5 L with int8 pages); the
   send side's pack's device operations, the device times of the kernel,
   the loop, the plain version (three runs) and one ``index_put_`` a
   leaf, beside the byte bound, and the host wall time of one call of
   each are logged.
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

19. **the prefix cache** (run after phase 11): full-width llama3.2-1b
   with ``ContinuousEngine.enable_prefix_cache``, 8 slots, page 16: 4
   groups sharing a 120-token prefix (7 pages and a partial page of 8),
   each a priming request of the bare prefix (one new token) and 4 members
   with suffixes of 8-20 tokens and 16-28 new tokens, all at t 0, so later
   members join on resident pages: shared full pages, a copy-on-write
   clone of the partial one, the suffix replayed as forced decode steps.
   Cold (no cache) and warm, greedy and at T 0.8: hits and clones, exact
   launch counts (flash once a layer a cold join only, the paged kernel
   once a layer a step, forced steps included), no page held at the end
   but the resident ones; warm tokens against cold request by request
   (where they part, the step and both runs' top-2 logit margins logged),
   and both runs teacher-forced with the cold tokens, every draw's logits
   held at the bf16 bar (3e-2).  Logged: matched tokens, hits, clones,
   step p50 and the joins' host time, warm beside cold.
20. **telemetry**: phase 2's serve with and without
   ``--trace-out --perfetto-out --metrics-out --power-cap 300 --dashboard``
   in turns (off, on, on, off), each with phase 2's checks: the port's
   validators accept the files, one slack span a booked phase, a join and
   an evict instant a request, the metrics' last report and the trace's
   replay equal the run's report; the tenant's watts are logged as
   modelled (``core.pstate.DEFAULT_HW``), beside the card's name and power
   limit.  Then two ``launch.train`` steps of full-width llama3.2-1b with
   ``--live-events`` and the same flags: no kernel, the files valid, the
   trace replayed to the run's report.
21. **restart after failure** (files under the gitignored
   ``build/``, removed at the end): full-width llama3.2-1b's training
   state (fp32 params and both AdamW moments, 14.8 GB) after two steps,
   saved synchronously and loaded into a skeleton on the card, every leaf
   bit-equal; saved asynchronously with a step taken at once, the file
   bit-equal to the state before that step; the state's bytes, the time
   ``save`` blocks, the whole write, the load and GB/s logged.  The train
   launcher on full-width countdown-100m: 12 steps with ``--save-every
   4`` (files 4, 8, 12), then ``--resume --steps 16`` starting at 12, its
   learning rates the schedule's from the restored step counter and its
   first loss the step-12 file's on a fresh loader's first batch (rtol
   1e-6); ``--fail-at 6`` in the card's world of 1 raises the reference's
   two ``RuntimeError``s, with and without ``--checkpoint-dir``.  Then
   ``examples/torch_train_lm.py --preset 100m --steps 100``: the mean of
   the last ten losses at least 0.25 below the first ten's.
22. **the other four examples** with no arguments (the card, their
   default sizes): ``torch_quickstart.py`` (the loss falls, no kernel),
   ``torch_serve_decode.py`` (four families' batched demos through
   flash, RMSNorm and both scans; the continuous engine through the fused
   paged kernel, flash and RMSNorm), ``torch_cluster_budget.py`` (the
   arbiter wins; host only) and ``torch_energy_aware_training.py`` (an
   NCCL world of 1, two instrumented collectives a step, no kernel).
23. **the serving fleet**: the serve launcher's ``main`` with ``--fleet
   2`` on full-width llama3.2-1b (fp32 params, bf16 compute, random
   weights from seed 0), 8 slots, page 16, through the kernels: two
   engines on one copy of the weights, each with its own pool and prefix
   cache, stepped in turn behind the prefix-aware router on the wall
   clock, on the flash-crowd trace (3 s) and the session-reuse trace (8
   sessions of 4 turns).  Exact launches, no plain attention, every
   request finished, no pool storage shared, prefix routing and hits on
   session reuse; each request's tokens against one engine alone (the
   first parting step and both top-2 margins logged where they part),
   and the fleet teacher-forced with the single engine's tokens, every
   draw's logits at the bf16 bar (3e-2).  Then ``--fleet 2 --autoscale``
   twice (the virtual-clock ``FleetSim``): equal results, no kernel, no
   weight.  The arbiter's watts are logged as modelled
   (``core.pstate.DEFAULT_HW``), beside the card's name and power limit.
24. **sharding inside a pod, on one card**: the three kernels of
   tensor-parallel llama3.2-1b serving at the per-rank shapes of model
   degree 2, 4 and 8 (the paged step at B 8, Hkv 4/2/1, G 4, D 64, bf16
   pages under an fp32 query; flash at S 128 with Hq 16/8/4 and Hkv
   4/2/1; RMSNorm at 8 and 128 rows of 2048, whole on every rank), each
   held to its plain version and timed beside it, its bound and its
   library call; then full-width llama3.2-1b (fp32 params, bf16 compute,
   random weights from seed 0) served greedy, 8 requests of 128-token
   prompts and 16 new tokens, 8 slots, page 16, by the plain-tensor
   engine and by the sharded code path on a (1, 1) NCCL ``DeviceMesh``
   (weights on ``serve_param_shardings``, pool on
   ``page_pool_shardings``, the activation hooks installed: every leaf a
   DTensor, the kernels run on local shards; the engine's slots split
   over the mesh's data axis, at one data rank the whole batch, and its
   data degree logged): exact launches, equal to the plain engine's,
   tokens equal per request, both decode-step p50s logged.  Two ranks
   sharing the one card are not run: NCCL refuses two ranks on one
   device, and under gloo DTensor's all-gather of CUDA tensors crashed its
   process (PERF.md, section 7); so the split's gather of the step's new
   K/V rows, and their scatter into the pages, which happen only at two
   data ranks and more, do not run here.  Their write is held at
   llama's and granite's full width, two ranks' rows gathered, in phase
   1d.
25. **the dry run against the card**: ``python -m
   repro_torch.launch.dryrun`` in subprocesses (each its own fake world of
   256 or 512 ranks, records in a temporary directory) on llama3.2-1b
   ``decode_32k --mesh pod`` and ``train_4k --mesh multipod --instrument
   barrier``, both ``ok``, each cell's per-rank peak, FLOPs and collective
   counts logged; meanwhile flash (B 8, Hq 32, Hkv 8, S 2048, D 64) and
   RMSNorm (16384 and 8 rows of 2048) in bf16, the cells' calls, held to
   their plain versions (BF16_TOL, and the error's RMS within 0.1 % of the
   output's); then three one-card cells of full-width llama3.2-1b in
   the production config (bf16, vocab padded to 256): train 8 x 128,
   prefill 8 x 2048, decode 8 over a 2048-position cache, each counted by
   ``build_cell`` on ``meta`` over a one-rank fake world (a subprocess)
   and run on the card with the same arguments materialised (random
   weights from seed 0): the argument bytes equal the count's exactly
   (the prefill cache, written whole before it is read, is output only);
   the plain step's peak (``max_memory_allocated`` less what earlier
   phases still hold) within 10 % or 256 MiB of the predicted peak; its
   ``FlopCounterMode`` FLOPs equal the count's; the plain step's median
   time (5 runs after a warm-up) at least the roofline from the counts,
   ``max(flops / 989.4e12, traffic_bytes / 3.35e12)`` (share at most
   1.05: the counts are the plain path's); the step through the kernels
   timed the same way, exact launches, its logits and cache held to the
   plain step's on copies of the same arguments (each float leaf's error
   RMS within 5 % of its own, the positions equal; the same check must
   catch flash patched to attend to half the keys and RMSNorm patched to
   leave half its rows zero), its share of that roofline logged
   (flash never writes the score chunks the plain traffic counts) and its
   time at least what any implementation must move (arguments and
   outputs at 3.35 TB/s).
26. **the other families sharded, on one card**: ``python -m
   repro_torch.launch.dryrun`` on granite-moe-3b-a800m ``decode_32k
   --mesh pod`` in a subprocess, ``ok``; meanwhile the kernels at each
   rank's shapes under model degree 2, 4 and 8, each held to its plain
   version and timed beside it, its bound and its library call: the
   RG-LRU scan on recurrentgemma-2b's W/mp lanes (W 1280/640/320, B 1, S
   2032 and 128, with h0; every W a whole number of the kernel's 16-lane
   blocks), the SSD scan on mamba2-130m's H/mp heads (H 12/6/3, B 1, P 64,
   N 128, chunk 128, S 2048 and 128, with a state), granite's paged step
   (B 8, Hkv 4/2/1, G 3, D 64) and flash (S 128, Hq 12/6/3, Hkv 4/2/1),
   and recurrentgemma's degree-2 paged step (its 10 query heads split 5
   and 5 over the one KV head, whose pages every rank holds: Hkv 1, G 5,
   D 256, window 2048).  Then full-width granite-moe-3b-a800m,
   recurrentgemma-2b and mamba2-130m (fp32 params, random weights from
   seed 0) served greedy as in phase 24 by the plain-tensor engine and by
   the sharded code path on a (1, 1) NCCL mesh, the slots split over its
   one data rank: exact launches, equal
   between the two runs; tokens equal per request (an MoE request is
   excused only where the two runs' routers first part at a near tie,
   probabilities within 1e-3); both decode-step p50s logged.

27. **the serving fleet on a mesh**: phase 23's flash-crowd fleet through
   the serve launcher's ``run_fleet_real`` on a (1, 1) NCCL mesh, as
   ``--fleet`` runs under ``torchrun``: both replicas on the one copy of
   the weights as DTensors on ``serve_param_shardings``, each pool on
   ``page_pool_shardings``, each replica's slots split over the mesh's
   one data rank, the sessions on the mesh's first rank's clock.
   Phase 23's checks (exact launches, no plain attention, every request
   finished, no pool storage shared; tokens against one plain engine alone
   on the gathered weights and the fleet teacher-forced with them at the
   bf16 bar); the sharded and the plain fleet's decode-step p50s logged
   beside the card's name and power limit.

28. **the data-split MoE exchange**: ``models/moe.py``'s all-to-all of the
   kept rows (``plan_exchange``, ``send_rows``, the experts on the rank's
   slots, ``return_rows``) at granite-moe-3b-a800m's full width (d 1536,
   E 40, top-8, moe_d_ff 512; T = 8 × 128 bf16 tokens, skewed routing)
   over a one-rank NCCL group, called directly (a one-rank mesh has no
   token group): its output and the gradients of x, the router and the
   expert weights against the plain ``dispatch`` and ``combine`` at the
   bf16 bar, no kernel launched; both paths' forward and backward times
   and peak bytes logged.

In phases 1b, 1d, 2, 5, 8, 11, 13-16 and 18-28 every kernel count is set to 0 just
before the run and read just after; each must equal the launches the path
needs (RMSNorm once per norm a join and a step where the norm is RMSNorm,
none for LayerNorm and the nonparametric norm: 2 a layer with an MLP, 1
an SSM layer, plus the final norm; flash, the RG-LRU scan and the SSD scan
once per attention / RG-LRU / SSM layer a join; the fused paged kernel
once per attention layer a step; the unfused paged kernels only on the ops
path; the data-split step's scatter once a ``share_new_rows`` call, only
in phase 1d; none on the training path, which runs plain PyTorch under
autograd).
Each step check profiles the step: device time by kernel, the paged
kernels' walk and combine together and apart.
Prints the card's name and power limit, then one JSON line of kernel
numbers (each kernel's launches from its own path: the ops surface for the
unfused paged kernels, phase 1d's ``share_new_rows`` calls for the step
scatter, mamba2's for RMSNorm and the SSD scan, recurrentgemma's for the
rest), and last ``{"ok": true, "device": {...}}``.
Needs CUDA and this repository's ``src/``; without either it fails before
printing a result.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
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
    "paged_scatter_step": ("PA", "scatter_step_launches", "paged_attention",
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


def time_ms(torch, fn, reps: int = 50, sleep_ms: float = 5.0) -> float:
    """Median device time of one call.  The L2 is flushed before each call
    (the serving path reaches a layer's inputs after other layers' weights),
    and a sleep kernel (``sleep_ms``, at the H100's 2 GHz clock) keeps the
    card busy while the host enqueues the call, so the events bracket
    device work only, not the host's Python, as long as the sleep outlasts
    the enqueue."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    times = []
    for _ in range(reps + 5):
        flush.zero_()
        torch.cuda._sleep(int(sleep_ms * 2_000_000))
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


def host_call_ms(torch, fn, reps: int = 200) -> float:
    """Median host wall time of one call (Python, checks and launches), each
    call timed alone on an idle card and not synchronised, after 5 calls
    untimed."""
    times = []
    for _ in range(reps + 5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times[5:])) * 1e3


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
# phase 1d: the data-split step's scatter
# --------------------------------------------------------------------------

SCATTER_STEP_CASES = (("llama3.2-1b", False), ("llama3.2-1b", True),
                      ("granite-moe-3b-a800m", False))
SCATTER_STEP_CALLS = 3          # share_new_rows calls a case on the counted path
SCATTER_STEP_PAGES = 11         # pages a slot (176 positions), besides the scratch page


class GatherOfRanks:
    """The data group's all-gather of two ranks seen from the first: this
    rank's packed rows, then the other rank's (``others``), in rank order,
    as ``SlotSplit.gather`` returns them."""

    split = True

    def __init__(self, torch, others):
        self.torch, self.others = torch, others

    def gather(self, t):
        return self.torch.cat([t, self.others])


def scatter_step_case(torch, arch, quant):
    """Full-width ``arch`` (bf16 pages, or int8 with fp32 scales): every
    attention layer's pools for 8 slots of 11 pages of 16 (and the scratch
    page), filled with random bits; two fake data ranks' new rows of 4
    slots each, as the decode step hands them to ``share_new_rows``; the
    whole batch's positions and tables: slots 2, 3 and 7 idle on the
    scratch page (3 and 7 on one row), slot 6 (the second rank) at slot
    1's place."""
    from repro_torch.configs import get_config
    from repro_torch.serve import kvcache as KV

    cfg = dataclasses.replace(get_config(arch), kv_quant=quant)
    slots, page, m = 8, 16, SCATTER_STEP_PAGES
    blocks = KV.init_pool_blocks(cfg, slots * m + 1, page, slots, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)

    def fill(t, name):
        if t.dtype == torch.int8:
            return t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device="cuda"))
        if "scale" in name:
            return t.copy_(torch.rand(t.shape, generator=gen, device="cuda") * 0.02 + 0.005)
        return t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))

    layers = [b for k, b in zip(cfg.layer_kinds(), blocks["layers"]) if k == "attn"]
    for b in layers:
        for name, t in b.items():
            fill(t, name)
    ranks = [[tuple(fill(b[name][0, :slots // 2].clone(), name) for name in KV.PAGE_LEAVES
                    if name in b) for b in layers] for _ in range(2)]
    table = torch.arange(1, slots * m + 1, dtype=torch.int32, device="cuda").reshape(slots, m)
    pos = torch.tensor([130, 150, 0, 0, 141, 170, 150, 0], dtype=torch.int32, device="cuda")
    table[6] = table[1]
    table[[2, 3, 7]] = 0
    pos[2] = 5                     # an idle slot's own table row: its row lands on page 0
    return cfg, blocks, layers, ranks, pos, table


def step_leaves(layers):
    from repro_torch.serve.kvcache import PAGE_LEAVES

    return [[b[n] for n in PAGE_LEAVES if n in b] for b in layers]


def device_ops(torch, fn):
    """The device operations of one call of ``fn`` (after one call
    uncaptured): the nodes of a CUDA graph that captures it, by type
    (kernel, memcpy, memset, ...), from libcuda's graph calls.  A
    capture sees every operation the call enqueues, where
    ``torch.profiler``'s trace of a call this short has come back empty on
    the card."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    cu = ctypes.CDLL("libcuda.so.1")
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    require(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0, "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    require(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0, "cuGraphGetNodes")
    kinds = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty"}
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        require(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
                "cuGraphNodeGetType")
        names.append(kinds.get(kind.value, f"type {kind.value}"))
    del graph
    return names


def per_layer_loop(PA, whole, leaves, page_idx, off):
    """The data-split step's write as the port made it before the one-launch
    kernel: each layer's rows copied out of the gathered bytes, then one
    launch of the per-call scatter kernel a layer."""
    for pools, rows in zip(leaves, PA.step_rows(whole, leaves)):
        PA.paged_scatter(pools, rows, page_idx, off)


def step_index_put(torch, whole, leaves, page_idx, off):
    """The library yardstick: one ``index_put_`` a pool leaf, each writing its
    layer's rows, viewed in place in the gathered bytes, to the same
    (page, offset)s; of duplicate destinations it keeps no defined one."""
    from repro_torch.kernels.paged_attention import step_row_bytes

    index = (page_idx.long(), off.long())
    calls, at = [], 0
    for pools in leaves:
        for pool, width in zip(pools, step_row_bytes(pools)):
            rows = whole[:, at:at + width].view(pool.dtype).view((whole.shape[0],)
                                                                 + tuple(pool.shape[2:]))
            calls.append((pool, rows))
            at += width

    def run():
        for pool, rows in calls:
            pool.index_put_(index, rows)
    return run


def phase_scatter_step(torch, mods, card):
    """The data-split decode step's write at full width, D = 2 fake data
    ranks of 4 slots: llama3.2-1b (16 layers, Hkv 8, D 64) in bf16 and int8,
    granite-moe-3b-a800m (32 layers) in bf16.  ``kvcache.share_new_rows``
    with a stand-in for the all-gather (the second rank's packed rows after
    the first's) is the counted path: one launch of the step scatter a call
    and nothing else.  Then, on copies of the same pools, the per-layer loop
    through the per-call scatter kernel (3 L device operations, 5 L int8)
    and the plain version: every pool bit-equal; the device operations of a
    call of each (a CUDA graph's nodes) and of the send side's pack; device
    times (L2 flushed, median, the sleep before each call four times its
    enqueue) of the kernel, the loop, the plain version (three runs) and
    one ``index_put_`` a leaf, beside the byte bound; the host wall time of
    a call of each.  Returns (counts over the counted calls, llama bf16's
    record)."""
    from repro_torch.serve import kvcache as KV

    PA = mods["PA"]
    total = dict.fromkeys(KERNELS, 0)
    record = None
    for arch, quant in SCATTER_STEP_CASES:
        cfg, blocks, layers, ranks, pos, table = scatter_step_case(torch, arch, quant)
        what = f"{arch} ({len(layers)} layers, {'int8' if quant else 'bf16'} pages)"
        require(len(layers) == cfg.n_layers and layers[0]["k_pages"].dtype
                == (torch.int8 if quant else torch.bfloat16), what)
        leaves = step_leaves(layers)
        loop_leaves = [[t.clone() for t in pools] for pools in leaves]
        plain_leaves = [[t.clone() for t in pools] for pools in leaves]
        others = KV.pack_new_rows(ranks[1])
        torch.cuda.synchronize()
        reset(mods)
        for _ in range(SCATTER_STEP_CALLS):
            KV.share_new_rows(cfg, blocks, ranks[0], pos, table, GatherOfRanks(torch, others))
        torch.cuda.synchronize()
        counts = counts_of(mods)
        want = dict(dict.fromkeys(KERNELS, 0), paged_scatter_step=SCATTER_STEP_CALLS)
        require(counts == want, f"{what}: share_new_rows launches {counts}, want {want}")
        for k in total:
            total[k] += counts[k]

        whole = torch.cat([KV.pack_new_rows(ranks[0]), others])
        page_idx, off = KV.write_slots(pos, table, 16)
        reset(mods)
        per_layer_loop(PA, whole, loop_leaves, page_idx, off)
        loop_counts = counts_of(mods)
        require(loop_counts == dict(dict.fromkeys(KERNELS, 0), paged_scatter=len(layers)),
                f"{what}: the loop's launches {loop_counts}")
        PA.paged_scatter_step_plain(whole, plain_leaves, page_idx, off)
        torch.cuda.synchronize()
        for got, loop, plain in zip(leaves, loop_leaves, plain_leaves):
            for a, b, c in zip(got, loop, plain):
                require(torch.equal(a, c) and torch.equal(b, c), f"{what}: pools differ")
        dest = {(int(p), int(o)) for p, o in zip(page_idx.tolist(), off.tolist())}
        require(len(dest) == 6 and (0, 0) in dest, f"{what}: destinations {sorted(dest)}")
        require(torch.equal(leaves[0][0][int(page_idx[1]), int(off[1])], ranks[1][0][0][2]),
                f"{what}: the last row aimed at a place did not win")
        log(f"kernel ok: paged_scatter_step {what}, 8 rows of {whole.shape[1]} bytes from "
            f"2 ranks: pools bit-equal to the per-layer loop and to plain; "
            f"share_new_rows x{SCATTER_STEP_CALLS} launches {counts}")

        kern = lambda: PA.paged_scatter_step(whole, leaves, page_idx, off)  # noqa: E731
        loop = lambda: per_layer_loop(PA, whole, loop_leaves, page_idx, off)  # noqa: E731
        plain = lambda: PA.paged_scatter_step_plain(  # noqa: E731
            whole, plain_leaves, page_idx, off)
        ops = {name: device_ops(torch, fn) for name, fn in (
            ("kernel", kern), ("loop", loop),
            ("send side", lambda: KV.pack_new_rows(ranks[0])))}
        reset(mods)
        require(len(ops["kernel"]) == 1, f"{what}: the kernel's device operations {ops['kernel']}")
        per_leaf = 3 if not quant else 5
        require(len(ops["loop"]) == per_leaf * len(layers),
                f"{what}: the loop's device operations {len(ops['loop'])}, want "
                f"{per_leaf} x {len(layers)}")
        index_put = step_index_put(torch, whole, leaves, page_idx, off)
        host = {name: host_call_ms(torch, fn) for name, fn in (
            ("kernel", kern), ("loop", loop), ("plain", plain), ("index_put_", index_put))}
        # the sleep covers four times a call's enqueue, so no device time
        # below takes in the host's; plain's is taken three times, its spread
        # shown
        cover = {name: max(5.0, 4 * t) for name, t in host.items()}
        plain_runs = sorted(time_ms(torch, plain, sleep_ms=cover["plain"]) for _ in range(3))
        ms = {"kernel": time_ms(torch, kern, sleep_ms=cover["kernel"]),
              "loop": time_ms(torch, loop, sleep_ms=cover["loop"]), "plain": plain_runs[1],
              "index_put_": time_ms(torch, index_put, sleep_ms=cover["index_put_"])}
        n, w = whole.shape
        # the rows that win are read once and written once (a row a later
        # row overwrites is not read), page_idx and off read once
        b_ms, b_by = bound(2 * len(dest) * w + 2 * 4 * n, 0)
        log(f"paged_scatter_step timing, {what}: one launch {ms['kernel']:.6f} ms, the per-layer "
            f"loop ({len(ops['loop'])} device operations: {len(layers)} scatters and "
            f"{len(ops['loop']) - len(layers)} copies) {ms['loop']:.6f} ms "
            f"({ms['loop'] / ms['kernel']:.2f} x), plain {ms['plain']:.6f} ms (3 runs "
            f"{', '.join(f'{t:.6f}' for t in plain_runs)}), one index_put_ a leaf "
            f"({sum(map(len, leaves))} calls) {ms['index_put_']:.6f} ms; bound {b_ms:.7f} ms "
            f"({b_by}: {len(dest)} of {n} rows of {w} bytes read and written); host wall time a "
            f"call (median, not synchronised): the kernel's wrapper {host['kernel']:.4f} ms, the "
            f"loop {host['loop']:.4f} ms, plain {host['plain']:.4f} ms, index_put_ "
            f"{host['index_put_']:.4f} ms; the send side's pack {len(ops['send side'])} device "
            f"operation(s) {sorted(set(ops['send side']))}; the card: {card}")
        if (arch, quant) == SCATTER_STEP_CASES[0]:
            record = dict(max_abs_err=0.0, ms=ms["kernel"], plain_ms=ms["plain"], bound_ms=b_ms,
                          bound_by=b_by, library_ms=ms["index_put_"])
        del blocks, layers, leaves, loop_leaves, plain_leaves
        torch.cuda.empty_cache()
    log("paged_scatter_step record, llama3.2-1b bf16: " + json.dumps(record))
    return total, record


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
                paged_attention=0, paged_scatter=0, paged_scatter_step=0,
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


# --------------------------------------------------------------------------
# phase 19: the prefix cache
# --------------------------------------------------------------------------

PREFIX_LEN = 120          # 7 pages of 16 and a partial page of 8
PREFIX_GROUPS = 4
PREFIX_MEMBERS = 4        # requests a group after its priming request
PREFIX_MAX_LEN = 192      # the longest request: 120 + 20 prompt tokens, 28 new


def prefix_stream(vocab, rng, prefix_len=PREFIX_LEN, groups=PREFIX_GROUPS,
                  members=PREFIX_MEMBERS):
    """(prompt, new tokens) in arrival order, all at t 0: each group's
    priming request of its bare prefix (one new token, so the trie ends in
    the partial page), then round by round one member of every group, the
    prefix and a suffix of its own (8, 12, ... tokens; 16, 20, ... new)."""
    prefixes = [rng.integers(0, vocab, prefix_len).astype(np.int32) for _ in range(groups)]
    stream = [(p, 1) for p in prefixes]
    for m in range(members):
        for p in prefixes:
            suffix = rng.integers(0, vocab, 8 + 4 * m).astype(np.int32)
            stream.append((np.concatenate([p, suffix]), 16 + 4 * m))
    return stream


def teacher_forced(torch, base):
    """``base`` (a ``ContinuousEngine`` class) feeding request ``i`` of
    ``order`` (rid -> i) the tokens ``script[i]`` in place of its own draws
    (its own draws when ``script`` is None) and keeping the logits of every
    such draw on the device by (i, n); other requests draw as ``base``
    draws."""

    class TeacherForced(base):
        order, script, draws = {}, None, None

        def _select_step(self, logits, active):
            tok = super()._select_step(logits, active)
            for slot, req in active:
                i, n = self.order.get(req.rid), req.n_generated
                if i is not None:
                    self.draws[i, n] = logits[slot].float()
                    if self.script is not None:
                        tok[slot] = int(self.script[i][n])
            return tok

    return TeacherForced


def serve_prefix(torch, mods, cfg, params, device, stream, temperature, with_cache,
                 script=None, kernel="cuda"):
    """Serve ``stream`` on a fresh engine (8 slots, page 16), with the
    prefix cache or without, sampled at ``temperature`` (request i's key
    ``fold_in(key(0), i)``) or, given ``script``, teacher-forced.  Checks
    every request's length, the launch counts (flash once a layer a cold
    join, the paged kernel once a layer a step, forced steps included,
    RMSNorm once a norm a cold join and a step) and that no page is held
    at the end but the cache's resident ones.  Returns the run."""
    from repro_torch import jrandom
    from repro_torch.serve.engine import ContinuousEngine
    from repro_torch.serve.scheduler import Request

    cls = ContinuousEngine if script is None else teacher_forced(torch, ContinuousEngine)
    eng = cls(cfg, params, n_slots=8, max_len=PREFIX_MAX_LEN, page=16,
              temperature=temperature if script is None else 1.0, attn_kernel=kernel,
              device=device)
    eng.generate({"tokens": stream[-1][0][None]}, n_steps=2)      # warm-up, untimed
    cache = eng.enable_prefix_cache() if with_cache else None
    base = jrandom.key(0)
    reqs = [Request(prompt=p, max_new=n, arrival=0.0,
                    key=jrandom.fold_in(base, i) if temperature > 0 else None)
            for i, (p, n) in enumerate(stream)]
    if script is not None:
        eng.order, eng.script, eng.draws = {r.rid: i for i, r in enumerate(reqs)}, script, {}
    joins = []
    join = eng._join_request

    def timed_join(req):
        t0 = time.monotonic()
        join(req)                        # each join ends once the device is done
        joins.append((req.prefix_match is not None and req.prefix_match.n_tokens > 0,
                      time.monotonic() - t0))

    eng._join_request = timed_join
    j0, s0 = eng.n_joins, eng.n_decode_steps
    reset(mods)
    t0 = time.monotonic()
    eng.serve(reqs)
    wall = time.monotonic() - t0
    counts = counts_of(mods)
    dj, ds = eng.n_joins - j0, eng.n_decode_steps - s0
    n_attn = cfg.layer_kinds().count("attn")
    if kernel == "cuda":
        want = dict(paged_attention_scatter=ds * n_attn, paged_attention=0, paged_scatter=0,
                    paged_scatter_step=0,
                    flash_attention=dj * n_attn, rmsnorm=(dj + ds) * (2 * cfg.n_layers + 1),
                    ssd_scan=0, rglru_scan=0)
        require(counts == want, f"prefix path launches {counts}, want {want}")
    for r, (_, n) in zip(reqs, stream):
        require(len(r.out) == n and all(0 <= t < cfg.vocab for t in r.out), r.rid)
    pool = eng.pool
    resident = cache.n_resident_pages if cache is not None else 0
    require(not pool._reserved and not pool._allocated and not eng._forced
            and len(pool._free) == pool.capacity_pages - resident,
            f"pages held after the run: {len(pool._free)} free of {pool.capacity_pages}, "
            f"{resident} resident")
    hits = [r for r in reqs if r.prefix_match is not None and r.prefix_match.n_tokens > 0]
    require(dj == len(reqs) - len(hits), (dj, len(hits)))
    return dict(outs=[list(r.out) for r in reqs], counts=counts, joins=dj, steps=ds,
                hits=len(hits), clones=sum(r.prefix_match.partial_page is not None
                                           for r in hits),
                matched=cache.tokens_matched if cache is not None else 0,
                looked_up=cache.tokens_looked_up if cache is not None else 0,
                resident=resident, wall_s=wall,
                tok_per_s=sum(len(r.out) for r in reqs) / wall,
                step_ms_p50=float(np.median(eng._last_session.step_seconds)) * 1e3,
                cold_join_ms=[t * 1e3 for warm, t in joins if not warm],
                prefix_join_ms=[t * 1e3 for warm, t in joins if warm],
                draws=getattr(eng, "draws", None))


def top2_margin(torch, logits) -> float:
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def phase_prefix(torch, mods, cfg=None, params=None, device="cuda", kernel="cuda"):
    """Full-width llama3.2-1b (fp32 params, bf16 compute, random weights
    from seed 0) with the prefix cache, through the kernels: 4 groups of
    requests sharing a 120-token prefix (7 pages of 16 and a partial one),
    each a priming request and 4 members with suffixes of their own, over
    8 slots, so later members join on pages an earlier request left
    resident.  Cold (no cache) and warm, greedy and at T 0.8: hits and at
    least one copy-on-write clone, the launch counts, no page leaked.  The
    warm run's tokens must equal the cold run's request by request; where
    they part, the first parting step and both runs' top-2 logit margins
    there are logged.  Both runs are then teacher-forced with the cold
    run's tokens, and every draw's logits are held to the cold run's at the
    bf16 bar (3e-2).  Logs the matched tokens, hits, clones, the decode
    step p50 and the joins' host time, warm beside cold.  Returns the warm
    greedy run's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    if cfg is None:
        cfg = get_config("llama3.2-1b")
        params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    stream = prefix_stream(cfg.vocab, np.random.default_rng(19))
    summary = {}
    for temperature in (0.0, 0.8):
        cold = serve_prefix(torch, mods, cfg, params, device, stream, temperature, False,
                            kernel=kernel)
        warm = serve_prefix(torch, mods, cfg, params, device, stream, temperature, True,
                            kernel=kernel)
        require(warm["hits"] > 0 and warm["clones"] > 0, f"hits {warm['hits']}, "
                f"clones {warm['clones']}")
        parted = {i: next(k for k, (a, b) in enumerate(zip(w, c)) if a != b)
                  for i, (w, c) in enumerate(zip(warm["outs"], cold["outs"])) if w != c}
        # teacher forcing: both paths fed the cold run's tokens, logits compared
        forced = [serve_prefix(torch, mods, cfg, params, device, stream, temperature,
                               with_cache, script=cold["outs"], kernel=kernel)
                  for with_cache in (False, True)]
        fc, fw = forced[0]["draws"], forced[1]["draws"]
        require(set(fc) == set(fw) == {(i, n) for i, o in enumerate(cold["outs"])
                                       for n in range(len(o))}, "teacher-forced draws")
        if temperature == 0:
            require(all(int(torch.argmax(fc[i, n])) == t for i, o in enumerate(cold["outs"])
                        for n, t in enumerate(o)), "the forced cold run's argmax is not the "
                    "cold run's greedy token")
        err = 0.0
        for key in fc:
            torch.testing.assert_close(fw[key], fc[key], **BF16_TOL)
            err = max(err, float((fw[key] - fc[key]).abs().max()))
        margins = {i: dict(step=k, cold_top2=top2_margin(torch, fc[i, k]),
                           warm_top2=top2_margin(torch, fw[i, k])) for i, k in parted.items()}
        mode = "greedy" if temperature == 0 else f"T {temperature}"
        log(f"prefix {cfg.name} {mode}: {len(stream)} requests, warm tokens equal cold for "
            f"{len(stream) - len(parted)}; parted (request: first step, top-2 logit margins "
            f"cold/warm there) {json.dumps(margins)}; teacher-forced logits, warm against "
            f"cold, max_abs_err {err:.4g} over {len(fc)} draws (atol/rtol 3e-2)")
        for name, run in (("cold", cold), ("warm", warm)):
            log(f"prefix {cfg.name} {mode} {name}: hits {run['hits']}, clones "
                f"{run['clones']}, matched {run['matched']} of {run['looked_up']} prompt "
                f"tokens, resident pages {run['resident']}, {run['joins']} prefills, "
                f"{run['steps']} decode steps, serve wall {run['wall_s'] * 1e3:.3f} ms "
                f"({run['tok_per_s']:.2f} tok/s), step p50 {run['step_ms_p50']:.3f} ms, join "
                f"host ms median: prefill {np.median(run['cold_join_ms']):.3f} over "
                f"{len(run['cold_join_ms'])}"
                + (f", prefix {np.median(run['prefix_join_ms']):.3f} over "
                   f"{len(run['prefix_join_ms'])}" if run["prefix_join_ms"] else "")
                + f"; launches {json.dumps(run['counts'])}")
        summary[mode] = dict(parted=len(parted), forced_err=err)
        if temperature == 0:
            counts = warm["counts"]
    return counts, summary


# --------------------------------------------------------------------------
# phase 20: telemetry
# --------------------------------------------------------------------------

def check_serve_telemetry(res, objs):
    """The files of a served run with every telemetry flag: the port's
    validators accept them, the metrics' last report is the run's, the
    Perfetto trace has one slack span a booked phase and a join and an
    evict instant a request, and the trace replays to the run's report."""
    from repro_torch.cluster.trace import load, replay
    from repro_torch.obs.export import validate_metrics_jsonl
    from repro_torch.obs.tracer import validate_trace

    rep = objs["report"].to_dict()
    require(validate_metrics_jsonl(res["metrics_out"]) == [], res["metrics_out"])
    with open(res["metrics_out"]) as f:
        last = json.loads(f.readlines()[-1])
    require(last["report"] == json.loads(json.dumps(rep)), "metrics report")
    with open(res["perfetto_out"]) as f:
        trace = json.load(f)
    require(validate_trace(trace, require_tracks=("ranks", "serve")) == [], "perfetto")
    events = trace["traceEvents"]
    n_slack = sum(e["ph"] == "X" and e["name"] == "slack" for e in events)
    n_join = sum(e["ph"] == "i" and e["name"] == "join" for e in events)
    n_evict = sum(e["ph"] == "i" and e["name"] == "evict" for e in events)
    require(n_slack == res["phases"] == rep["n_calls"], (n_slack, res["phases"]))
    require(n_join == n_evict == res["requests"], (n_join, n_evict))
    header, records = load(res["trace_out"])
    require(header["meta"]["report"] == rep and replay(records)[1].to_dict() == rep,
            "trace replay")
    require(res["power"]["watts"].startswith("modelled") and res["dashboard_frames"] == 1,
            res["power"])
    return n_slack, len(records)


def phase_telemetry(torch, mods, card):
    """Full-width llama3.2-1b served (phase 2's arguments) with and without
    ``--trace-out --perfetto-out --metrics-out --power-cap 300 --dashboard``
    in turns (off, on, on, off), each with phase 2's launch checks, every
    telemetry run's files checked (``check_serve_telemetry``); logs the
    step p50 and tok/s of each turn and the tenant's watts, modelled from
    ``core.pstate.DEFAULT_HW`` and not the card's.  Then two
    ``launch.train`` steps of full-width llama3.2-1b with ``--live-events``
    and the same flags: no kernel launched, the files valid, the trace
    replayed to the run's report."""
    import tempfile

    from repro_torch.cluster.trace import load, replay
    from repro_torch.launch import train
    from repro_torch.obs.export import validate_metrics_jsonl
    from repro_torch.obs.tracer import validate_trace

    turns = {"off": [], "on": []}
    with tempfile.TemporaryDirectory() as d:
        flags = ["--trace-out", os.path.join(d, "trace.jsonl"),
                 "--perfetto-out", os.path.join(d, "perfetto.json"),
                 "--metrics-out", os.path.join(d, "metrics.jsonl"),
                 "--power-cap", "300", "--dashboard"]
        for turn in ("off", "on", "on", "off"):
            counts, eng, res, objs = phase_serving(
                torch, mods, LLAMA_SERVE + (flags if turn == "on" else []), LLAMA_DIMS)
            turns[turn].append((res["step_ms_p50"], res["tok_per_s"]))
            if turn == "on":
                spans, records = check_serve_telemetry(res, objs)
                log(f"telemetry llama3.2-1b: {spans} slack spans = booked phases, "
                    f"{res['perfetto_events']} Perfetto captures, {records} trace records "
                    f"replayed to the run's report, {res['metrics_lines']} metrics line; "
                    f"power cap {res['power']['cap_w']} W, MODELLED draw "
                    f"{res['power']['power_w']:.3f} W (core.pstate.DEFAULT_HW, a CPU-node "
                    f"model, not the card's; the card: {card})")
            del eng, objs
            torch.cuda.empty_cache()
        log("decode step p50 ms and tok/s, llama3.2-1b, telemetry off and on in turns "
            "(off, on, on, off): " + json.dumps(turns))

        reset(mods)
        res = train.run(train.parser().parse_args(
            ["--arch", "llama3.2-1b", "--steps", "2", "--live-events"] + flags))
        counts = counts_of(mods)
        require(not any(counts.values()), f"kernels launched on the training path: {counts}")
        rep = res["governor"]
        require(rep["n_calls"] == 4, rep)
        require(validate_metrics_jsonl(res["metrics_out"]) == [], "train metrics")
        with open(res["metrics_out"]) as f:
            require(json.loads(f.readlines()[-1])["report"] == rep, "train metrics report")
        require(validate_trace(res["perfetto_out"], require_tracks=("governor",)) == [],
                "train perfetto")
        require(replay(load(res["trace_out"])[1])[1].to_dict() == rep, "train trace replay")
        require(len(res["power"]["epochs"]) == 2, res["power"])
        log(f"telemetry train llama3.2-1b, 2 steps with --live-events: {rep['n_calls']} "
            f"cd_psum calls booked, {res['perfetto_events']} Perfetto captures, "
            f"{res['trace_records']} trace records replayed to the report, "
            f"{res['metrics_lines']} metrics lines; MODELLED energy "
            f"{res['power']['energy_j']:.3f} J over {res['power']['wall_s']:.3f} s "
            f"(core.pstate.DEFAULT_HW, not the card's; the card: {card})")
    return turns


# --------------------------------------------------------------------------
# phase 21: restart after failure
# --------------------------------------------------------------------------

CKPT_DIR = os.path.join(ROOT, "build", "chip_smoke_ckpt")     # gitignored, removed after


def same_bits(torch, a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def run_error(run) -> str:
    """The message of the ``RuntimeError`` ``run()`` raises, else ""."""
    try:
        run()
    except RuntimeError as e:
        return str(e)
    return ""


def phase_checkpoint(torch, mods, card):
    """Restart after failure (``repro_torch.dist.checkpoint``, the train
    launcher's ``--checkpoint-dir``/``--save-every``/``--resume``/
    ``--fail-at``, ``examples/torch_train_lm.py``), under the gitignored
    ``build/``, every file removed at the end:

    - full-width llama3.2-1b's training state on the card (fp32 params and
      both AdamW moments): two ``make_train_step`` steps, a synchronous
      save (``keep=1``) loaded into a skeleton on the card, every leaf
      bit-equal; then an async save with a step taken at once, in place:
      after ``wait()`` the file is bit-equal to the state before that step
      (and the step did change it).  Logged: the state's bytes, the time
      ``save`` blocks, the whole write, the load, and GB/s;
    - the launcher on full-width countdown-100m (its default arch): 12
      steps saving every 4 (files 4, 8, 12), then ``--resume --steps 16``:
      it starts at 12, its learning rates continue the schedule from the
      restored step counter (rtol 1e-6), and its first loss is the loss of
      the step-12 file's parameters on a fresh loader's first batch (rtol
      1e-6); ``--fail-at 6 --save-every 4`` in the card's world of 1 raises
      the reference's ``RuntimeError`` (no survivor to rebuild from), and
      without ``--checkpoint-dir`` its other one;
    - ``examples/torch_train_lm.py --preset 100m --steps 100``: the mean of
      the last ten losses at least 0.25 below that of the first ten.

    No kernel is launched (training runs plain PyTorch)."""
    import dataclasses
    import shutil

    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.dist.checkpoint import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.train import loop as TL
    from repro_torch.train.data import DataLoader
    from repro_torch.train.optimizer import OptConfig, schedule
    from repro_torch.tree import leaves, tree_map

    t_phase = time.perf_counter()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    reset(mods)
    try:
        # -- full-width llama3.2-1b's state: sync and async round trips --
        cfg = get_config("llama3.2-1b")
        opt_cfg = OptConfig(warmup_steps=1, total_steps=10)
        state = TL.init_state(cfg, opt_cfg, torch.Generator(device="cuda").manual_seed(0),
                              "cuda")
        step = TL.make_train_step(cfg, opt_cfg)
        loader = DataLoader(cfg, batch=2, seq_len=128, seed=0, device="cuda")
        try:
            for _ in range(2):
                state, _ = step(state, next(loader))
            torch.cuda.synchronize()
            nbytes = sum(t.numel() * t.element_size() for t in leaves(state))
            mgr = CheckpointManager(os.path.join(CKPT_DIR, "sync"), keep=1)
            t0 = time.perf_counter()
            mgr.save(2, state)
            sync_s = time.perf_counter() - t0
            file_bytes = os.path.getsize(os.path.join(mgr.directory, "step_00000002.npz"))
            skel = tree_map(torch.empty_like, state)
            t0 = time.perf_counter()
            loaded = mgr.load(2, skel)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            del skel
            require(all(same_bits(torch, a, b) for a, b in zip(leaves(state), leaves(loaded))),
                    "the synchronous save did not load back bit-equal")
            del loaded
            shutil.rmtree(mgr.directory)

            before = tree_map(torch.clone, state)
            amgr = CheckpointManager(os.path.join(CKPT_DIR, "async"), keep=1, async_save=True)
            t0 = time.perf_counter()
            amgr.save(2, state)
            block_s = time.perf_counter() - t0
            state, _ = step(state, next(loader))           # in place, at once
            torch.cuda.synchronize()
            amgr.wait()
            async_s = time.perf_counter() - t0
            require(not same_bits(torch, state["params"]["embed"], before["params"]["embed"]),
                    "the step after the async save changed nothing")
            loaded = amgr.load(2, tree_map(torch.empty_like, state))
            require(all(same_bits(torch, a, b) for a, b in zip(leaves(before), leaves(loaded))),
                    "the async save wrote values from after the next step")
            del loaded, before
            shutil.rmtree(amgr.directory)
        finally:
            loader.close()
        del state, step
        torch.cuda.empty_cache()
        gb = nbytes / 1e9
        log(f"checkpoint llama3.2-1b full width (fp32 params, m, v; {card}): state "
            f"{nbytes} bytes ({gb:.3f} GB), file {file_bytes} bytes; synchronous save "
            f"{sync_s:.3f} s ({gb / sync_s:.3f} GB/s), load onto the card {load_s:.3f} s "
            f"({gb / load_s:.3f} GB/s), bit-equal; async save blocked {block_s:.3f} s "
            f"({gb / block_s:.3f} GB/s to host memory), whole write with one step taken "
            f"meanwhile {async_s:.3f} s ({gb / async_s:.3f} GB/s), the file bit-equal to "
            f"the state before that step")

        # -- the launcher on full-width countdown-100m: save, resume, fail --
        d = os.path.join(CKPT_DIR, "launcher")
        args = ["--steps", "12", "--save-every", "4", "--checkpoint-dir", d]
        first = train.run(train.parser().parse_args(args))
        require(CheckpointManager(d).all_steps() == [4, 8, 12] and
                first["checkpoint_steps"] == [4, 8, 12], first["checkpoint_steps"])
        res = train.run(train.parser().parse_args(
            ["--steps", "16", "--save-every", "4", "--checkpoint-dir", d, "--resume"]))
        require(res["start_step"] == 12 and len(res["losses"]) == 4, res["start_step"])
        opt_cfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=16)
        want_lrs = [float(schedule(opt_cfg, torch.tensor(s, device="cuda")))
                    for s in (13, 14, 15, 16)]
        np.testing.assert_allclose(res["lrs"], want_lrs, rtol=1e-6)
        cfg = dataclasses.replace(get_config("countdown-100m"), remat=True)
        fresh = TL.init_state(cfg, opt_cfg, torch.Generator(device="cuda").manual_seed(1),
                              "cuda")
        restored = bridge.state_from_numpy(
            cfg, CheckpointManager(d).load(12, bridge.state_to_numpy(cfg, fresh)), "cuda")
        require(int(restored["opt"]["step"]) == 12, "the step-12 file's step counter")
        loader = DataLoader(cfg, batch=8, seq_len=128, seed=0, device="cuda")
        try:
            want_loss = float(TL._grads(cfg, restored["params"], next(loader))[0])
        finally:
            loader.close()
        del fresh, restored
        np.testing.assert_allclose(res["losses"][0], want_loss, rtol=1e-6)
        errors = {}
        for name, extra, msg in (
                ("with a directory", ["--checkpoint-dir", os.path.join(CKPT_DIR, "fail")],
                 "ElasticMesh: no healthy devices left to build from"),
                ("without", [], "node failure without checkpointing enabled")):
            err = run_error(lambda: train.run(train.parser().parse_args(
                ["--steps", "8", "--fail-at", "6", "--save-every", "4"] + extra)))
            require(msg in err, f"--fail-at 6 {name} --checkpoint-dir: {err!r}")
            errors[name] = err
        log(f"launcher countdown-100m full width ({card}): 12 steps saving every 4 -> files "
            f"{first['checkpoint_steps']}, step clock median {first['step_s_median'] * 1e3:.3f} "
            f"ms; --resume --steps 16 started at {res['start_step']}, lrs {res['lrs']} "
            f"(schedule {want_lrs}), first loss {res['losses'][0]!r} against the step-12 "
            f"file's {want_loss!r}; --fail-at 6 in a world of 1: {json.dumps(errors)}")

        # -- the example --
        example = load_example("train_lm")
        t0 = time.perf_counter()
        losses = example.main(["--preset", "100m", "--steps", "100", "--checkpoint-dir",
                               os.path.join(CKPT_DIR, "example")])
        example_s = time.perf_counter() - t0
        drop = float(np.mean(losses[:10]) - np.mean(losses[-10:]))
        require(np.isfinite(losses).all() and drop >= 0.25, f"loss drop {drop}")
        require(CheckpointManager(os.path.join(CKPT_DIR, "example")).all_steps() == [100],
                "the example's checkpoint")
        log(f"examples/torch_train_lm.py --preset 100m --steps 100 ({card}): loss "
            f"{np.mean(losses[:10]):.4f} -> {np.mean(losses[-10:]):.4f} (first and last "
            f"ten, drop {drop:.4f}) in {example_s:.3f} s")
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    counts = counts_of(mods)
    require(not any(counts.values()), f"kernels launched on the training path: {counts}")
    log(f"restart-after-failure phase took {time.perf_counter() - t_phase:.1f} s")


# --------------------------------------------------------------------------
# phase 22: the other four examples
# --------------------------------------------------------------------------

def load_example(name):
    import importlib.util

    path = os.path.join(ROOT, "examples", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_examples(torch, mods, card):
    """``examples/torch_quickstart.py``, ``torch_serve_decode.py``,
    ``torch_cluster_budget.py`` and ``torch_energy_aware_training.py`` with
    no arguments (the card, their default sizes), each with its counts set
    to 0 just before and read just after: the quickstart's loss falls and
    no kernel runs (training is plain PyTorch); serve_decode's batched
    demos generate (4, 16) tokens a family through flash, RMSNorm, the SSD
    and the RG-LRU scans, and its continuous engine serves every request
    through the fused paged kernel, flash and RMSNorm; the cluster budget's
    arbiter wins (host only, no kernel); energy-aware training in a world
    of 1 books two instrumented collectives a step, no kernel."""
    import torch.distributed as dist

    def run(name, argv=()):
        reset(mods)
        t0 = time.perf_counter()
        out = load_example(name).main(list(argv))
        return out, time.perf_counter() - t0, counts_of(mods)

    none = dict.fromkeys(KERNELS, 0)
    losses, quick_s, counts = run("quickstart")
    require(np.isfinite(losses).all() and losses[-1] < losses[0], f"quickstart {losses}")
    require(counts == none, f"quickstart launched kernels: {counts}")
    log(f"examples/torch_quickstart.py ({card}): loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"over {len(losses)} steps, {quick_s:.3f} s, no kernel")

    serve = load_example("serve_decode")
    split = {}
    plain_continuous = serve.demo_continuous

    def continuous(*a, **k):
        split["batched"] = counts_of(mods)       # the four batched demos' launches
        reset(mods)
        return plain_continuous(*a, **k)

    serve.demo_continuous = continuous
    reset(mods)
    t0 = time.perf_counter()
    res = serve.main([])
    serve_s = time.perf_counter() - t0
    split["continuous"] = counts_of(mods)
    for arch, out in res["batched"].items():
        require(tuple(out.shape) == (4, 16) and out.device.type == "cuda", (arch, out.shape))
    cont = res["continuous"]
    require(cont["requests"] == 8 and cont["tokens"] > 0 and cont["report"].n_calls > 0, cont)
    batched, served = split["batched"], split["continuous"]
    require(all(batched[k] > 0 for k in ("flash_attention", "rmsnorm", "ssd_scan",
                                         "rglru_scan")), f"batched demos {batched}")
    require(all(served[k] > 0 for k in ("paged_attention_scatter", "flash_attention",
                                        "rmsnorm")), f"continuous engine {served}")
    require(served["ssd_scan"] == served["rglru_scan"] == 0, served)
    require(batched["paged_attention"] == batched["paged_scatter"] ==
            served["paged_attention"] == served["paged_scatter"] == 0, split)
    log(f"examples/torch_serve_decode.py ({card}): {len(res['batched'])} families x (4, 16) "
        f"tokens, continuous {cont['tokens']} tokens / {cont['requests']} requests, "
        f"{serve_s:.3f} s; launches in the batched demos {json.dumps(batched)}, in the "
        f"continuous engine {json.dumps(served)}")

    budget, budget_s, counts = run("cluster_budget")
    require(budget["saving_pct"] > 0.0 and budget["overhead_pct"] <= 1.0, budget)
    require(counts == none, f"cluster_budget launched kernels: {counts}")
    log(f"examples/torch_cluster_budget.py ({card}): arbiter vs static "
        f"{budget['saving_pct']:+.3f}% energy at {budget['overhead_pct']:+.3f}% makespan "
        f"(modelled watts, core.pstate.DEFAULT_HW), {budget_s:.3f} s")

    require(not dist.is_initialized(), "a process group is left from an earlier phase")
    energy, energy_s, counts = run("energy_aware_training")
    require(energy["world"] == 1 and np.isfinite(energy["losses"]).all(), energy["losses"])
    require(energy["report"].n_calls == 2 * len(energy["losses"]), energy["report"].n_calls)
    require(counts == none and not dist.is_initialized(), counts)
    log(f"examples/torch_energy_aware_training.py ({card}, NCCL world of 1): loss "
        f"{energy['losses'][0]:.4f} -> {energy['losses'][-1]:.4f} over "
        f"{len(energy['losses'])} steps, {energy['report'].n_calls} instrumented "
        f"collectives, {energy_s:.3f} s, no kernel")


# --------------------------------------------------------------------------
# phase 23: the serving fleet
# --------------------------------------------------------------------------

FLEET_ARGV = ["--arch", "llama3.2-1b", "--fleet", "2", "--slots", "8", "--page-size", "16",
              "--attn-kernel", "cuda", "--seed", "0"]
FLEET_TRACES = {"flash-crowd": ["--fleet-trace", "flash-crowd", "--fleet-duration", "3"],
                "session-reuse": ["--fleet-trace", "session-reuse"]}


def storages(eng) -> set:
    from repro_torch.device import is_dtensor

    return {(t.to_local() if is_dtensor(t) else t).untyped_storage().data_ptr()
            for layer in eng.pool.blocks["layers"] for t in layer.values()}


def check_fleet_launches(engines, counts) -> None:
    """Every replica on the kernels, and the exact launches of their joins
    and steps, the warm-ups' included: flash once an attention layer a
    prefill (none for a prefix hit), the paged kernel once an attention
    layer a step (forced steps included), RMSNorm once a norm a prefill
    and a step."""
    require(all(e.attn_kernel == "cuda" for e in engines), [e.attn_kernel for e in engines])
    cfg = engines[0].cfg
    n_attn = cfg.layer_kinds().count("attn")
    joins = sum(e.n_joins for e in engines)
    steps = sum(e.n_decode_steps for e in engines)
    want = dict(paged_attention_scatter=steps * n_attn, paged_attention=0, paged_scatter=0,
                paged_scatter_step=0,
                flash_attention=joins * n_attn, rmsnorm=(joins + steps) * (2 * cfg.n_layers + 1),
                ssd_scan=0, rglru_scan=0)
    require(counts == want, f"fleet launches {counts}, want {want}")
    require(all(counts[k] > 0 for k in ("paged_attention_scatter", "flash_attention",
                                        "rmsnorm")), counts)


def fleet_alone(torch, cfg, params, reqs, max_len):
    """The fleet's requests, in trace order, served by one engine alone
    (8 slots, page 16, the kernels, no prefix cache), all at t 0, each
    draw's logits kept by (request, token): the requests carry no key, so
    every draw is the argmax.  Returns (tokens, logits)."""
    from repro_torch.serve.engine import ContinuousEngine
    from repro_torch.serve.scheduler import Request

    eng = teacher_forced(torch, ContinuousEngine)(
        cfg, params, n_slots=8, max_len=max_len, page=16, temperature=1.0,
        attn_kernel="cuda", device="cuda")
    alone = [Request(prompt=r.prompt, max_new=r.max_new, arrival=0.0) for r in reqs]
    eng.order, eng.draws = {r.rid: i for i, r in enumerate(alone)}, {}
    eng.serve(alone)
    return [list(r.out) for r in alone], eng.draws


def fleet_forced(torch, mods, res, objs, script, mesh=None):
    """The same fleet again (two engines on the same weights, their prefix
    caches, the reference's warm-up), each request fed ``script``'s tokens
    in place of its own draws; returns every draw's logits by (request,
    token) and the run's launches.  With ``mesh`` (the weights DTensors on
    its replica), the engines serve on it (their slots split over its data
    axis, the sessions on its clock), the pools go onto
    ``page_pool_shardings`` and the activation hooks are installed, as the
    serve launcher's fleet does."""
    from repro_torch.core.governor import Governor
    from repro_torch.dist import sharding as SH
    from repro_torch.models.hooks import install_constraint
    from repro_torch.models.inputs import make_batch
    from repro_torch.serve.engine import ContinuousEngine
    from repro_torch.serve.fleet import run_engine_fleet

    first = objs["engines"][0]
    cls = teacher_forced(torch, ContinuousEngine)
    engines = []
    reqs = objs["trace"].fresh_requests()
    if mesh is not None:
        install_constraint(SH.activation_constraint_fn(SH.replica_mesh(mesh)))
    try:
        reset(mods)                     # the engines' counts include their warm-ups
        for _ in objs["engines"]:
            eng = cls(first.cfg, objs["params"], n_slots=first.n_slots,
                      max_len=first.max_len, page=first.page, temperature=1.0,
                      attn_kernel="cuda", device="cuda", serve_mesh=mesh)
            if mesh is not None:
                eng.pool.blocks = SH.distribute(
                    eng.pool.blocks, SH.page_pool_shardings(eng.mesh, eng.pool.blocks))
            eng.enable_prefix_cache()
            eng.generate(make_batch(first.cfg, batch=1, seq_len=len(reqs[0].prompt),
                                    kind="prefill"), n_steps=2)
            eng.order, eng.script, eng.draws = ({r.rid: i for i, r in enumerate(reqs)},
                                                script, {})
            engines.append(eng)
        run_engine_fleet(engines, reqs, cap_w=res["cap_w"], floor_w=4.0,
                         governors=[Governor() for _ in engines])
        counts = counts_of(mods)
    finally:
        install_constraint(None)
    check_fleet_launches(engines, counts)
    require([list(r.out) for r in reqs] == script, "the forced fleet's tokens are the script")
    draws = {}
    for eng in engines:
        draws.update(eng.draws)
    return draws, counts


def phase_fleet(torch, mods, card):
    """The real fleet through the serve launcher's ``main``: full-width
    llama3.2-1b (fp32 params, bf16 compute), ``--fleet 2``, 8 slots, page
    16, through the kernels, on the flash-crowd trace (3 s of arrivals)
    and on the session-reuse trace (8 sessions of 4 turns).  Each run:
    exact launches, no plain attention, every request finished, the two
    replicas on one copy of the weights and no pool storage shared; the
    session-reuse run routes to a resident prefix and hits.  Each request's
    tokens are held to one engine alone on the same weights; where they
    part, the first parting step and both runs' top-2 logit margins there
    are logged.  Either way the fleet is run once more teacher-forced with
    the single engine's tokens, and every draw's logits are held to the
    single engine's at the bf16 bar (3e-2).  Then ``--fleet 2
    --autoscale`` twice on one trace: the same result, no kernel launched,
    no weight built.  Logged per run: routed and prefix-routed counts,
    hits and lookups, each replica's decode-step p50, tok/s, wall and
    warm-up seconds, the card's memory peak and the modelled watts
    (``core.pstate.DEFAULT_HW``, not the card's) beside the card."""
    from repro_torch.launch import serve

    summary = {}
    for name, flags in FLEET_TRACES.items():
        t_phase = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        reset(mods)
        res = serve.main(FLEET_ARGV + flags)
        counts = counts_of(mods)
        peak = torch.cuda.max_memory_allocated()
        objs = res.pop("objects")
        engines, reqs = objs["engines"], objs["requests"]
        cfg = engines[0].cfg
        require((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.vocab)
                == LLAMA_DIMS, cfg)
        check_fleet_launches(engines, counts)
        require(res["requests"] == res["n_requests"] == len(reqs) == len(objs["finished"]) > 0,
                res)
        for r in reqs:
            require(len(r.out) == r.max_new and all(0 <= t < cfg.vocab for t in r.out), r.rid)
        require(all(e.params is objs["params"] for e in engines), "one copy of the weights")
        require(not storages(engines[0]) & storages(engines[1]), "replicas share a pool")
        if name == "session-reuse":
            require(res["prefix_routed"] > 0 and res["prefix_hits"] > 0, res)
        fleet = [list(r.out) for r in reqs]
        alone, alone_draws = fleet_alone(torch, cfg, objs["params"], reqs, engines[0].max_len)
        parted = {i: next(k for k, (a, b) in enumerate(zip(f, s)) if a != b)
                  for i, (f, s) in enumerate(zip(fleet, alone)) if f != s}
        forced, forced_counts = fleet_forced(torch, mods, res, objs, alone)
        require(set(forced) == set(alone_draws) == {(i, n) for i, o in enumerate(alone)
                                                    for n in range(len(o))}, "the draws")
        err = 0.0
        for key in alone_draws:
            torch.testing.assert_close(forced[key], alone_draws[key], **BF16_TOL)
            err = max(err, float((forced[key] - alone_draws[key]).abs().max()))
        margins = {i: dict(step=k, fleet_top2=top2_margin(torch, forced[i, k]),
                           alone_top2=top2_margin(torch, alone_draws[i, k]))
                   for i, k in parted.items()}
        wall = time.perf_counter() - t_phase
        log(f"fleet llama3.2-1b {name}: {res['requests']} requests, {res['tokens']} tokens, "
            f"routed {res['routed']}, prefix-routed {res['prefix_routed']}, prefix hits "
            f"{res['prefix_hits']} of {res['prefix_lookups']} lookups (2 warm-ups included), "
            f"wall {res['wall_s']:.3f} s, {res['tok_per_s']:.2f} tok/s, warm-up "
            f"{res['warmup_s']:.3f} s, card memory peak {peak / 2**30:.3f} GiB; per replica "
            + json.dumps(res["per_replica"]) + f"; launches {json.dumps(counts)}")
        log(f"fleet llama3.2-1b {name}: tokens equal one engine alone for "
            f"{len(reqs) - len(parted)} of {len(reqs)} requests; parted (request: first "
            f"step, top-2 logit margins fleet/alone there) {json.dumps(margins)}; the fleet "
            f"teacher-forced with the single engine's tokens: max_abs_err {err:.4g} over "
            f"{len(alone_draws)} draws (atol/rtol 3e-2), launches {json.dumps(forced_counts)}")
        log(f"fleet llama3.2-1b {name}: MODELLED watts (core.pstate.DEFAULT_HW, a CPU-node "
            f"model, not the card's): cap {res['cap_w']} W, last grants "
            f"{json.dumps(res['grants_w'])} over {res['arbiter_epochs']} epochs; the card: "
            f"{card}; the phase's run {wall:.3f} s")
        summary[name] = dict(parted=len(parted), forced_err=err, counts=counts,
                             step_ms_p50=[r["step_ms_p50"] for r in res["per_replica"]])
        del engines, objs, forced, alone_draws
        gc.collect()            # an engine and its last session refer to each other
        torch.cuda.empty_cache()

    sims = []
    for _ in range(2):
        before = torch.cuda.memory_allocated()
        reset(mods)
        res = serve.main(FLEET_ARGV + ["--autoscale"] + FLEET_TRACES["flash-crowd"])
        require(counts_of(mods) == dict.fromkeys(KERNELS, 0), "the sim fleet launched kernels")
        require(torch.cuda.memory_allocated() == before, "the sim fleet built weights")
        objs = res.pop("objects")
        require(res["requests"] == res["n_requests"] > 0 and res["watts"].startswith("modelled"),
                res)
        sims.append((res, dataclasses.asdict(objs["result"]),
                     [d.replica_id for d in objs["sim"].router.decisions]))
    require(sims[0] == sims[1], "two autoscaled sim runs differ")
    log(f"fleet sim llama3.2-1b flash-crowd --autoscale, twice, equal: " + json.dumps(sims[0][0])
        + f" (watts MODELLED, core.pstate.DEFAULT_HW; host only, no kernel; the card: {card})")
    return summary


# --------------------------------------------------------------------------
# phase 24: sharding inside a pod, on one card
# --------------------------------------------------------------------------

SHARD_DEGREES = (2, 4, 8)        # llama3.2-1b: Hq 32, Hkv 8 split over the model axis
SHARD_PROMPTS, SHARD_NEW = 8, 16


def shard_paged_record(torch, PA, rng, what, hkv, g, d, window):
    """The fused paged step at one rank's shapes (B 8, page 16, slots
    between positions 128 and 175, bf16 pages, fp32 query) against its
    plain version, the pools bit-equal outside the scratch page; timed
    beside its plain version, SDPA and its bound."""
    case, pos = paged_case(torch, rng, torch.bfloat16, torch.float32, b=8, hkv=hkv, g=g,
                           d=d, page=16, m=11, pos_lo=128)
    plain_in = {k: v.clone() for k, v in case.items()}
    kern_in = {k: v.clone() for k, v in case.items()}
    want = PA.paged_attention_scatter_plain(**plain_in, window=window)
    got = PA.paged_attention_scatter(**kern_in, window=window)
    err = compare(torch, got, want, BF16_TOL, f"paged per rank, {what}")
    ratio = slot_ratio(got, want)
    require(ratio <= SLOT_REL_TOL, f"paged {what}: slot error {ratio:.3g} of its RMS")
    for pool in ("k_pages", "v_pages"):
        require(torch.equal(kern_in[pool][1:], plain_in[pool][1:]), f"{what}: {pool}")
    b_ms, b_by = paged_bound(case, pos, window)
    return dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: PA.paged_attention_scatter(**kern_in, window=window)),
        plain_ms=time_ms(torch, lambda: PA.paged_attention_scatter_plain(**plain_in,
                                                                          window=window)),
        bound_ms=b_ms, bound_by=b_by, library_ms=paged_sdpa_ms(torch, case, window))


def shard_flash_record(torch, FA, rng, what, hq, hkv):
    """Causal flash at one rank's heads (B 1, S 128, D 64, fp32 as the path
    promotes) against its plain version; timed beside its plain version,
    SDPA and its bound."""
    import torch.nn.functional as F

    q = randn(torch, rng, 1, hq, 128, 64)
    k = randn(torch, rng, 1, hkv, 128, 64)
    v = randn(torch, rng, 1, hkv, 128, 64)
    err = compare(torch, FA.flash_attention(q, k, v), FA.flash_attention_plain(q, k, v),
                  F32_TOL, f"flash per rank, {what}: Hq {hq} Hkv {hkv} S 128")
    b_ms, b_by = bound(4 * (2 * q.numel() + 2 * k.numel()),
                       4 * 64 * hq * flash_pairs(128, 0, True))
    mask = flash_mask(torch, 128, 0, True)
    return dict(
        max_abs_err=err, ms=time_ms(torch, lambda: FA.flash_attention(q, k, v)),
        plain_ms=time_ms(torch, lambda: FA.flash_attention_plain(q, k, v)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)))


def phase_shard_kernels(torch, mods, card):
    """The paged step, flash and RMSNorm at each rank's shapes under model
    degree 2, 4 and 8 of tensor-parallel llama3.2-1b serving, held to their
    plain versions and timed beside them, their bounds and their library
    calls.  Returns the records by (kernel, degree)."""
    import torch.nn.functional as F

    PA, FA, RN = mods["PA"], mods["FA"], mods["RN"]
    rng = np.random.default_rng(24)
    records = {}
    for mp in SHARD_DEGREES:
        hq, hkv = 32 // mp, 8 // mp
        records["paged_attention_scatter", mp] = shard_paged_record(
            torch, PA, rng, f"degree {mp}: Hkv {hkv}", hkv, 4, 64, 0)
        records["flash_attention", mp] = shard_flash_record(torch, FA, rng, f"degree {mp}",
                                                            hq, hkv)
        for rows in (8, 128):                  # the residual is whole on every rank
            x = randn(torch, rng, rows, 2048, std=2.0)
            scale = randn(torch, rng, 2048, mean=1.0, std=0.2)
            err = compare(torch, RN.rmsnorm(x, scale), RN.rmsnorm_plain(x, scale), F32_TOL,
                          f"rmsnorm per rank, degree {mp}: {rows} x 2048")
            b_ms, b_by = bound(2 * x.numel() * 4 + scale.numel() * 4, 4 * x.numel())
            records[f"rmsnorm_{rows}", mp] = dict(
                max_abs_err=err, ms=time_ms(torch, lambda: RN.rmsnorm(x, scale)),
                plain_ms=time_ms(torch, lambda: RN.rmsnorm_plain(x, scale)),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(torch, lambda: F.rms_norm(x, (2048,), scale, 1e-6)))
    for (name, mp), rec in records.items():
        log(f"per-rank timing, {name} at model degree {mp}: " + json.dumps(rec)
            + f" (the card: {card})")
    return records


def shard_prompts(vocab):
    rng = np.random.default_rng(24)
    return [rng.integers(0, vocab, 128).astype(np.int32) for _ in range(SHARD_PROMPTS)]


def serve_prompts(torch, mods, eng, prompts, mesh=None):
    """One warm-up generate, then the prompts served greedy from t=0 with
    the kernel counts set to 0 just before and read just after; returns
    (tokens per request, counts, joins, decode steps, step p50 ms).  With
    ``mesh``, the pool goes onto ``page_pool_shardings`` and the activation
    hooks are installed for the run."""
    from repro_torch.dist import sharding as SH
    from repro_torch.models.hooks import install_constraint
    from repro_torch.serve.scheduler import Request

    if mesh is not None:
        eng.pool.blocks = SH.distribute(eng.pool.blocks,
                                        SH.page_pool_shardings(mesh, eng.pool.blocks))
        install_constraint(SH.activation_constraint_fn(mesh))
    try:
        eng.generate({"tokens": prompts[0][None]}, n_steps=2)
        joins, steps = eng.n_joins, eng.n_decode_steps
        reset(mods)
        reqs = [Request(prompt=p, max_new=SHARD_NEW, arrival=0.0) for p in prompts]
        order = {r.rid: i for i, r in enumerate(reqs)}
        done = sorted(eng.serve(reqs), key=lambda r: order[r.rid])
        torch.cuda.synchronize()
        counts = counts_of(mods)
    finally:
        install_constraint(None)
    p50 = float(np.percentile(eng._last_session.step_seconds, 50)) * 1e3
    return ([list(r.out) for r in done], counts, eng.n_joins - joins,
            eng.n_decode_steps - steps, p50)


def first_route_flip(plain, sharded):
    """The first router call (in call order) where a row's chosen experts
    differ between two runs' ``RouteLog.calls``, with the largest router
    probability difference over the calls up to it; None when every call
    chose alike."""
    for i, ((pp, pi), (sp, si)) in enumerate(zip(plain, sharded)):
        if pi.shape != si.shape or not bool((pi.sort(-1).values == si.sort(-1).values).all()):
            drift = max(float((a - b).abs().max()) for (a, _), (b, _) in
                        zip(plain[:i + 1], sharded[:i + 1]) if a.shape == b.shape)
            return i, drift
    return None


def phase_sharded_serving(torch, mods, card, archs):
    """Each of ``archs`` at full width (fp32 params, random weights from
    seed 0) served greedy, 8 requests of 128-token prompts and 16 new
    tokens, 8 slots, page 16, by the plain-tensor engine and by the
    sharded code path on a (1, 1) NCCL mesh
    (every leaf a DTensor, the kernels on local shards, the engine's slots
    split over the mesh's data axis: at one data rank all 8): launches
    exact and equal, tokens equal per request (an MoE request excused only
    where the two runs' routers part at a near tie), both decode-step p50s
    and the data degree logged.  Returns the launch counts by arch."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as SH
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ContinuousEngine
    from repro_torch.tree import leaves

    made = not dist.is_initialized()
    if made:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    out = {}
    try:
        whole = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        mesh = SH.replica_mesh(whole)
        for arch in archs:
            t0 = time.perf_counter()
            cfg = get_config(arch)
            params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
            prompts = shard_prompts(cfg.vocab)
            max_len = 128 + SHARD_NEW + 16

            def engine(p, serve_mesh=None):
                return ContinuousEngine(cfg, p, n_slots=8, max_len=max_len, page=16,
                                        temperature=0.0, serve_mesh=serve_mesh)

            runs, routes = {}, {}
            with RouteLog() as rl:
                runs["plain"] = serve_prompts(torch, mods, engine(params), prompts)
            routes["plain"] = rl.calls
            sharded = SH.distribute(params, SH.serve_param_shardings(mesh, params))
            require(all(isinstance(t, DTensor) for t in leaves(sharded)),
                    f"{arch}: a leaf is not a DTensor")
            eng = engine(sharded, whole)
            require(eng.mesh is mesh, f"{arch}: the engine does not see the mesh")
            split = eng.split
            require((split.lo, split.hi, split.size) == (0, 8, 1) and eng.clock_mesh is whole,
                    f"{arch}: the slots over one data rank: {split}")
            with RouteLog() as rl:
                runs["sharded"] = serve_prompts(torch, mods, eng, prompts, mesh)
            routes["sharded"] = rl.calls
            require(all(isinstance(t, DTensor) for t in leaves(eng.pool.blocks)),
                    f"{arch}: the pool")
            kinds = cfg.layer_kinds()
            norms = sum(1 if k == "ssm" else 2 for k in kinds) + 1
            for name, (tokens, counts, joins, steps, _) in runs.items():
                want = dict.fromkeys(KERNELS, 0)
                want.update(paged_attention_scatter=steps * kinds.count("attn"),
                            flash_attention=joins * kinds.count("attn"),
                            rmsnorm=(joins + steps) * norms,
                            ssd_scan=joins * kinds.count("ssm"),
                            rglru_scan=joins * kinds.count("rglru"))
                require(joins == SHARD_PROMPTS and counts == want,
                        f"{arch} {name}: {joins} joins, {steps} steps, launches {counts}, "
                        f"want {want}")
                for i, toks in enumerate(tokens):
                    require(len(toks) == SHARD_NEW and all(0 <= t < cfg.vocab for t in toks),
                            (arch, name, i))
            (pt, pc, _, psteps, pp50), (st, sc, _, ssteps, sp50) = (runs["plain"],
                                                                    runs["sharded"])
            require(pc == sc and psteps == ssteps, f"{arch}: launches plain {pc}, sharded {sc}")
            parted = [i for i, (u, w) in enumerate(zip(pt, st)) if u != w]
            excused = ""
            if parted:
                flip = first_route_flip(routes["plain"], routes["sharded"]) if cfg.is_moe \
                    else None
                require(flip is not None and flip[1] <= ROUTE_PROB_TOL,
                        f"{arch}: requests {parted} part from the plain engine's tokens "
                        f"(router flip {flip})")
                excused = (f"; requests {parted} excused: the routers part at call "
                           f"{flip[0]} with probabilities {flip[1]:.3g} apart")
            log(f"sharded serving, {arch} on a (1, 1) NCCL mesh, data degree {split.size} "
                f"(slots {split.lo}-{split.hi - 1} on this rank): {SHARD_PROMPTS} requests, "
                f"{psteps} decode steps, tokens equal to the plain engine's for "
                f"{SHARD_PROMPTS - len(parted)} of {SHARD_PROMPTS} requests{excused}; launches "
                f"{json.dumps(sc)} (equal); decode step p50 plain {pp50:.3f} ms, sharded "
                f"{sp50:.3f} ms ({sp50 / pp50:.2f} x); {time.perf_counter() - t0:.1f} s; "
                f"the card: {card}")
            out[arch] = sc
            del eng, sharded, params
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if made:
            dist.destroy_process_group()
    return out


# --------------------------------------------------------------------------
# phase 25: the dry run against the card
# --------------------------------------------------------------------------

DRYRUN_CLI_CELLS = (["--shape", "decode_32k", "--mesh", "pod"],
                    ["--shape", "train_4k", "--mesh", "multipod", "--instrument", "barrier"])
# one-card cells of full-width llama3.2-1b: name -> (seq_len, batch, kind); a
# serving cell's cache holds seq_len positions
DRYRUN_CARD_CELLS = {"train": (128, 8, "train"), "prefill": (2048, 8, "prefill"),
                     "decode": (2048, 8, "decode")}
BF16_FLOPS_PER_S = 989.4e12   # H100 SXM dense bf16 tensor cores
DRYRUN_PEAK_TOL, DRYRUN_PEAK_FLOOR = 0.10, 256 << 20
DRYRUN_ROOF_SHARE = 1.05
DRYRUN_TIMED = 5
# the error's RMS over the plain output's RMS (bf16): each kernel against its
# plain version at the cells' shapes (measured about 1e-4 and below), and the
# step through the kernels against the plain step on the same arguments
# (measured 1.8e-2 at prefill, where the plain path's bf16 attention rounds
# differently through 16 layers; flash over half the keys gives 0.16)
DRYRUN_KERNEL_REL_RMS = 1e-3
DRYRUN_STEP_REL_RMS = 5e-2
# the kernels' calls in the one-card cells, bf16: flash at prefill (B, Hq,
# Hkv, S, D) and RMSNorm at prefill's and decode's rows
DRYRUN_FLASH = (8, 32, 8, 2048, 64)
DRYRUN_NORMS = ((16384, 2048), (8, 2048))
DRYRUN_COUNT = """
import json, torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import sharding as SH
from repro_torch.launch import dryrun as D
from repro_torch.models.hooks import install_constraint
D.fake_world(1)
mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
install_constraint(SH.activation_constraint_fn(mesh))
cfg = D.production_config("llama3.2-1b")
out = {}
for name, (seq, batch, kind) in CELLS.items():
    fn, args = D.build_cell("llama3.2-1b", ShapeConfig(name, seq, batch, kind), mesh)
    out[name] = D.count_step(fn, args, cfg)
print(json.dumps(out))
"""


def dryrun_processes(out_dir):
    """The dry run's CLI cells and the one-rank counts, each a subprocess
    over its own fake world (phase 24's NCCL group cannot share a process
    with one), all started at once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cli = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "llama3.2-1b",
           "--out-dir", out_dir, "--force"]
    procs = [subprocess.Popen(cli + cell, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cell in DRYRUN_CLI_CELLS]
    code = DRYRUN_COUNT.replace("CELLS", repr(DRYRUN_CARD_CELLS))
    procs.append(subprocess.Popen([sys.executable, "-c", code], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def finish(proc, what, timeout=300):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"chip_smoke check failed: {what} ran over {timeout} s")
    require(proc.returncode == 0, f"{what} exited {proc.returncode}: {err[-3000:]}")
    return out


def dryrun_card_args(torch, cfg, name):
    """The cell's arguments materialised on the card (random weights from
    seed 0, a zeroed cache), its plain and kernel steps, and the bytes of
    the arguments it does not read (the prefill cache, written whole)."""
    from repro_torch.models.inputs import make_batch
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.serve.engine import make_serve_steps
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.tree import leaves

    seq, batch, kind = DRYRUN_CARD_CELLS[name]
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    if kind == "train":
        step = make_train_step(cfg, OptConfig())
        args = ({"params": params, "opt": init_opt_state(params, OptConfig())},
                make_batch(cfg, batch, seq, kind="train", device="cuda"))
        return args, step, step, 0
    plain = make_serve_steps(cfg, kernel="plain")
    kern = make_serve_steps(cfg)
    cache = init_cache(cfg, batch, seq, "cuda")
    if kind == "prefill":
        args = (params, make_batch(cfg, batch, seq, kind="prefill", device="cuda"), cache)
        return args, plain[0], kern[0], sum(t.numel() * t.element_size()
                                            for t in leaves(cache))
    token = torch.randint(0, cfg.vocab, (batch,), dtype=torch.int32, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(1))
    # the port reads the position on the host
    args = (params, token, torch.tensor(seq - 1, dtype=torch.int32), cache)
    return args, plain[1], kern[1], 0


def rel_rms(torch, got, want) -> float:
    """The RMS of ``got - want`` over the RMS of ``want``, summed in fp64
    over slices of at most 2**26 elements (no fp64 copy of the whole)."""
    got, want = got.reshape(-1), want.reshape(-1)
    err = ref = 0.0
    for g, w in zip(got.split(1 << 26), want.split(1 << 26)):
        require(bool(torch.isfinite(g).all()), "non-finite output")
        err += float(torch.sum(torch.square(g.double() - w.double())))
        ref += float(torch.sum(torch.square(w.double())))
    return (err / max(ref, 1e-300)) ** 0.5


def dryrun_kernels_at_cell_shapes(torch, mods):
    """Flash and RMSNorm at the bf16 shapes the one-card cells give them,
    each held to its plain version: ``compare`` at BF16_TOL and the error's
    relative RMS within DRYRUN_KERNEL_REL_RMS."""
    FA, RN = mods["FA"], mods["RN"]
    rng = np.random.default_rng(25)
    bf16 = torch.bfloat16
    b, hq, hkv, s, d = DRYRUN_FLASH
    q = randn(torch, rng, b, hq, s, d, dtype=bf16)
    k = randn(torch, rng, b, hkv, s, d, dtype=bf16)
    v = randn(torch, rng, b, hkv, s, d, dtype=bf16)
    cases = [(f"flash B {b} Hq {hq} Hkv {hkv} S {s} D {d} bf16 causal",
              FA.flash_attention(q, k, v), FA.flash_attention_plain(q, k, v))]
    del q, k, v
    for rows, width in DRYRUN_NORMS:
        x = randn(torch, rng, rows, width, dtype=bf16, std=2.0)
        scale = randn(torch, rng, width, dtype=bf16, mean=1.0, std=0.2)   # bf16 params
        cases.append((f"rmsnorm {rows} x {width} bf16 (bf16 scale)",
                      RN.rmsnorm(x, scale), RN.rmsnorm_plain(x, scale)))
    for what, got, want in cases:
        err = compare(torch, got, want, BF16_TOL, what)
        rel = rel_rms(torch, got, want)
        log(f"kernel ok at the dry-run cells' shapes: {what}: max_abs_err {err:.3g}, "
            f"relative RMS error {rel:.3e} (limit {DRYRUN_KERNEL_REL_RMS})")
        require(rel <= DRYRUN_KERNEL_REL_RMS, f"{what}: relative RMS error {rel:.3e}")
    gc.collect()
    torch.cuda.empty_cache()


def dryrun_rel_errors(torch, name, args, plain, kern):
    """The kernel step against the plain step, each on its own copy of
    ``args``' cache: the relative RMS errors of the logits and of each
    float cache leaf (the integer positions, written by neither kernel,
    must be equal)."""
    from repro_torch.tree import leaves

    def run(step):
        fresh = args[:-1] + (_to(args[-1], torch, "cuda", copy=True),)
        logits, cache = step(*fresh)
        return [logits] + leaves(cache)

    want, got = run(plain), run(kern)
    require(all(torch.equal(g, w) for g, w in zip(got, want) if not w.is_floating_point()),
            f"{name}: the cache's positions differ")
    rels = [rel_rms(torch, g, w) for g, w in zip(got, want) if w.is_floating_point()]
    log(f"{name}: the step through the kernels against the plain step on copies of the same "
        f"arguments: logits relative RMS error {rels[0]:.3e}, max_abs_err "
        f"{float((got[0].float() - want[0].float()).abs().max()):.3g} (logits RMS "
        f"{float(want[0].float().square().mean().sqrt()):.3g}); the cache's {len(rels) - 1} "
        f"leaves at most {max(rels[1:]):.3e} (limit {DRYRUN_STEP_REL_RMS})")
    return rels


def dryrun_outputs_agree(torch, name, args, plain, kern):
    """:func:`dryrun_rel_errors` within DRYRUN_STEP_REL_RMS; returns the
    largest."""
    rels = dryrun_rel_errors(torch, name, args, plain, kern)
    require(max(rels) <= DRYRUN_STEP_REL_RMS, f"{name}: the kernel step's outputs part from the "
            f"plain step's: relative RMS errors {['%.3e' % r for r in rels]}")
    return max(rels)


def dryrun_limit_catches_skipped_work(torch, mods, cfg):
    """The agreement check against two wrappers that skip work, patched in
    for this check only: flash attending to the last half of the keys, and
    RMSNorm leaving the second half of its rows zero.  The prefill cell's
    outputs must then part from the plain step's beyond DRYRUN_STEP_REL_RMS."""
    FA, RN = mods["FA"], mods["RN"]
    flash, norm = FA.flash_attention, RN.rmsnorm

    def half_keys(q, k, v, *, positions=None, window=0, causal=True):
        return flash(q, k, v, positions=positions, window=q.shape[2] // 2, causal=causal)

    def half_rows(x, scale, eps=1e-6):
        y = norm(x, scale, eps)
        y.view(-1, y.shape[-1])[y.numel() // y.shape[-1] // 2:] = 0
        return y

    args, plain, kern, _ = dryrun_card_args(torch, cfg, "prefill")
    for what, patch in (("flash over half the keys", dict(flash_attention=half_keys)),
                        ("RMSNorm zeroing half the rows", dict(rmsnorm=half_rows))):
        FA.flash_attention = patch.get("flash_attention", flash)
        RN.rmsnorm = patch.get("rmsnorm", norm)
        try:
            rels = dryrun_rel_errors(torch, f"prefill, {what}", args, plain, kern)
        finally:
            FA.flash_attention, RN.rmsnorm = flash, norm
        require(max(rels) > DRYRUN_STEP_REL_RMS, f"prefill with {what}: the agreement check "
                f"missed it (relative RMS errors at most {max(rels):.3e})")
        log(f"the agreement check catches {what}: logits {rels[0]:.3e}, cache at most "
            f"{max(rels[1:]):.3e}, against the limit {DRYRUN_STEP_REL_RMS}")
    del args, plain, kern
    gc.collect()
    torch.cuda.empty_cache()


def median_step_ms(torch, step, args) -> float:
    """Median wall time of ``DRYRUN_TIMED`` synchronised calls after a
    warm-up."""
    step(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(DRYRUN_TIMED):
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def dryrun_card_cell(torch, mods, cfg, name, count):
    """One cell on the card against its count: the argument bytes, the
    peak, the FLOPs of the plain step, the kernel step's outputs against the
    plain step's, its time beside the roofline from the counts."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.tree import leaves

    seq, batch, kind = DRYRUN_CARD_CELLS[name]
    gc.collect()
    torch.cuda.empty_cache()
    args, plain, kern, unread = dryrun_card_args(torch, cfg, name)
    tensors = [t for t in leaves(args) if isinstance(t, torch.Tensor)]
    on_card = sum(t.numel() * t.element_size() for t in tensors)
    mem = count["memory"]
    require(on_card - unread == mem["argument_bytes"],
            f"{name}: arguments on the card {on_card - unread} B, counted "
            f"{mem['argument_bytes']} B")
    reset(mods)
    with FlopCounterMode(display=False) as fc:
        plain(*args)
    torch.cuda.synchronize()
    flops = fc.get_total_flops()
    require(flops == count["cost"]["flops"],
            f"{name}: FlopCounterMode on the card {flops}, counted {count['cost']['flops']}")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    out = plain(*args)
    torch.cuda.synchronize()
    raw = torch.cuda.max_memory_allocated()
    del out
    # allocations of earlier phases still held are not this step's
    peak = raw - (resident - sum(t.numel() * t.element_size() for t in tensors if t.is_cuda))
    want = mem["peak_args_plus_temp"]
    tol = max(DRYRUN_PEAK_TOL * want, DRYRUN_PEAK_FLOOR)
    require(abs(peak - want) <= tol, f"{name}: peak {peak} B on the card, predicted {want} B")
    plain_ms = median_step_ms(torch, plain, args)
    require(counts_of(mods) == dict.fromkeys(KERNELS, 0), f"{name}: a kernel ran on plain")
    ms = median_step_ms(torch, kern, args)
    counts = counts_of(mods)
    runs = DRYRUN_TIMED + 1
    kinds = cfg.layer_kinds()
    want_counts = dict.fromkeys(KERNELS, 0)
    if kind != "train":
        want_counts["rmsnorm"] = runs * (2 * len(kinds) + 1)
    if kind == "prefill":
        want_counts["flash_attention"] = runs * kinds.count("attn")
    require(counts == want_counts, f"{name}: launches {counts}, want {want_counts}")
    # train has no kernel on its path (its two steps are one)
    agree = dryrun_outputs_agree(torch, name, args, plain, kern) if kind != "train" else None
    flops_ms = count["cost"]["flops"] / BF16_FLOPS_PER_S * 1e3
    traffic_ms = count["traffic"]["traffic_bytes"] / HBM_BYTES_PER_S * 1e3
    roof = max(flops_ms, traffic_ms)
    # what any implementation must move: each argument read once, each
    # output written once
    must = (mem["argument_bytes"] + mem["output_bytes"]) / HBM_BYTES_PER_S * 1e3
    share, kshare = roof / plain_ms, roof / ms
    log(f"dry run against the card, llama3.2-1b {name} (batch {batch}, {seq} positions, bf16, "
        f"one rank): arguments {mem['argument_bytes']} B (equal); peak {peak} B on the card "
        f"(max allocated {raw} B), predicted {want} B ({100 * (peak - want) / want:+.2f} %); "
        f"FLOPs {flops:.6e} (equal); roofline from the counts {roof:.3f} ms (flops "
        f"{flops_ms:.3f}, traffic {traffic_ms:.3f}); "
        f"plain step {plain_ms:.3f} ms median of {DRYRUN_TIMED}, share {share:.3f}; step through "
        f"the kernels {ms:.3f} ms (launches {json.dumps(counts)}), share {kshare:.3f}, "
        f"must-move bound {must:.3f} ms")
    require(share <= DRYRUN_ROOF_SHARE, f"{name}: the plain step took {plain_ms:.3f} ms, under "
            f"the roofline {roof:.3f} ms from its counts (share {share:.3f})")
    require(must / ms <= DRYRUN_ROOF_SHARE, f"{name}: the kernel step took {ms:.3f} ms, under "
            f"the must-move bound {must:.3f} ms")
    del args, plain, kern, tensors
    return {"ms": ms, "plain_ms": plain_ms, "roof_ms": roof, "share": share,
            "kernel_share": kshare, "peak": peak, "predicted": want, "rel_rms": agree}


def phase_dryrun(torch, mods, card):
    """The dry run's CLI on two full-width cells in subprocesses (flash and
    RMSNorm held to their plain versions at the cells' shapes meanwhile),
    then three one-card cells of full-width llama3.2-1b counted on ``meta``
    over a one-rank fake world and run on the card."""
    import tempfile

    from repro_torch.launch.dryrun import production_config

    t0 = time.time()
    with tempfile.TemporaryDirectory() as out_dir:
        procs = dryrun_processes(out_dir)
        dryrun_kernels_at_cell_shapes(torch, mods)
        outs = [finish(p, f"the dry run {' '.join(c)}")
                for p, c in zip(procs, list(DRYRUN_CLI_CELLS) + [["one-rank counts"]])]
        names = sorted(os.listdir(out_dir))
        require(len(names) == len(DRYRUN_CLI_CELLS), names)
        for fname in names:
            with open(os.path.join(out_dir, fname)) as f:
                rec = json.load(f)
            require(rec["status"] == "ok", f"{fname}: {rec.get('error')}")
            log(f"dry run {rec['arch']} {rec['shape']} {rec['mesh']} (instrument "
                f"{rec['instrument']}, {rec['n_devices']} ranks): per-rank peak "
                f"{rec['memory']['peak_args_plus_temp'] / 2**30:.4f} GiB, FLOPs "
                f"{rec['cost']['flops']:.6e}, collectives "
                + json.dumps({k: v["count"] for k, v in rec["collectives"].items()})
                + f", {rec['compile_scan_s']} s")
    counts = json.loads(outs[-1].strip().splitlines()[-1])
    log(f"dry run subprocesses done in {time.time() - t0:.1f} s")
    cfg = production_config("llama3.2-1b")
    res = {name: dryrun_card_cell(torch, mods, cfg, name, counts[name])
           for name in DRYRUN_CARD_CELLS}
    dryrun_limit_catches_skipped_work(torch, mods, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 25 done in {time.time() - t0:.1f} s; the card: {card}")
    return res


# --------------------------------------------------------------------------
# phase 26: the other families sharded, on one card
# --------------------------------------------------------------------------

# per-rank widths at model degree 2, 4 and 8: recurrentgemma-2b's RG-LRU
# lanes (W 2560), mamba2-130m's SSD heads (H 24), granite's attention heads
# (Hq 24, Hkv 8, G 3)
FAMILY_SHARD_LANES = (1280, 640, 320)
FAMILY_SHARD_HEADS = (12, 6, 3)
GRANITE_SHARD_HEADS = ((12, 4), (6, 2), (3, 1))
# recurrentgemma-2b at degree 2: Hq 10 split 5 and 5 over its one KV head,
# whose pages every rank holds whole (Hkv, G, D, window)
RG_SHARD_PAGED = (1, 5, 256, 2048)
FAMILY_SHARD_ARCHS = ("granite-moe-3b-a800m", "recurrentgemma-2b", "mamba2-130m")
FAMILY_DRYRUN_CELL = ["--arch", "granite-moe-3b-a800m", "--shape", "decode_32k", "--mesh", "pod"]


def phase_family_shard_kernels(torch, mods, card):
    """The kernels of the other families' tensor-parallel serving at each
    rank's shapes under model degree 2, 4 and 8: the RG-LRU scan on
    recurrentgemma-2b's W/mp lanes (B 1, S 2032 and 128, with h0), the SSD
    scan on mamba2-130m's H/mp heads (B 1, P 64, N 128, chunk 128, S 2048
    and 128, with a state), granite's paged step and flash at S 128 on its
    heads, and recurrentgemma's degree-2 paged step (its query heads split
    over the one KV head).  Each held to its plain version and timed beside
    it, its bound and its library call.  Returns the records."""
    PA, FA, RS, SSD = mods["PA"], mods["FA"], mods["RS"], mods["SSD"]
    rng = np.random.default_rng(26)
    records = {}
    for mp, w in zip(SHARD_DEGREES, FAMILY_SHARD_LANES):
        for s in (2032, 128):
            a = torch.from_numpy(rng.uniform(0.3, 0.999, (1, s, w)).astype(np.float32)).to("cuda")
            bb = randn(torch, rng, 1, s, w, std=0.3)
            h0 = randn(torch, rng, 1, w)
            plan = RS.scan_plan(1, s, w, RS.sm_count(a.device))
            require(w % RS.LANES == 0, f"W {w} is not a whole number of {RS.LANES}-lane blocks")
            err = compare(torch, RS.rglru_scan(a, bb, h0), RS.linear_scan(a, bb, h0)[0],
                          F32_TOL, f"rglru_scan per rank, degree {mp}: W {w} S {s} with h0")
            b_ms, b_by = bound(3 * a.numel() * 4 + h0.numel() * 4, 2 * a.numel())
            records[f"rglru_scan S {s}", mp] = dict(
                max_abs_err=err, ms=time_ms(torch, lambda: RS.rglru_scan(a, bb, h0)),
                plain_ms=time_ms(torch, lambda: RS.linear_scan(a, bb, h0)),
                bound_ms=b_ms, bound_by=b_by, library_ms=None, plan=plan._asdict())
    b, p, n, chunk = 1, 64, 128, 128
    for mp, h in zip(SHARD_DEGREES, FAMILY_SHARD_HEADS):
        a_log = torch.from_numpy(-rng.uniform(1.0, 16.0, h).astype(np.float32)).to("cuda")
        for s in (2048, 128):
            x = randn(torch, rng, b, s, h, p)
            dt = torch.from_numpy(rng.uniform(0.001, 0.2, (b, s, h)).astype(np.float32)).to("cuda")
            bb, cc = randn(torch, rng, b, s, n), randn(torch, rng, b, s, n)
            h0 = randn(torch, rng, b, h, p, n, std=0.1)
            y, state = SSD.ssd_scan(x, dt, a_log, bb, cc, chunk=chunk, init_state=h0)
            want_y, want_state = SSD.ssd_chunked(x, dt, a_log, bb, cc, chunk, h0)
            what = f"ssd per rank, degree {mp}: H {h} S {s} with a state"
            err = max(compare(torch, y, want_y, SSD_TOL, what + ": y"),
                      compare(torch, state, want_state, SSD_TOL, what + ": final state"))
            b_ms, b_by = ssd_bound(b, s, h, p, n, chunk, True)
            records[f"ssd_scan S {s}", mp] = dict(
                max_abs_err=err,
                ms=time_ms(torch, lambda: SSD.ssd_scan(x, dt, a_log, bb, cc, chunk=chunk,
                                                       init_state=h0), reps=20),
                plain_ms=time_ms(torch, lambda: SSD.ssd_chunked(x, dt, a_log, bb, cc, chunk,
                                                                h0), reps=20),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)
    for mp, (hq, hkv) in zip(SHARD_DEGREES, GRANITE_SHARD_HEADS):
        records["granite paged_attention_scatter", mp] = shard_paged_record(
            torch, PA, rng, f"granite degree {mp}: Hkv {hkv} G 3 D 64", hkv, 3, 64, 0)
        records["granite flash_attention", mp] = shard_flash_record(
            torch, FA, rng, f"granite degree {mp}", hq, hkv)
    hkv, g, d, window = RG_SHARD_PAGED
    records["recurrentgemma paged_attention_scatter", 2] = shard_paged_record(
        torch, PA, rng, f"recurrentgemma degree 2: Hkv {hkv} G {g} D {d} window {window}",
        hkv, g, d, window)
    for (name, mp), rec in records.items():
        log(f"per-rank timing, {name} at model degree {mp}: " + json.dumps(rec)
            + f" (the card: {card})")
    return records


def phase_family_sharding(torch, mods, card):
    """Phase 26: the dry run's CLI on granite's ``decode_32k`` pod cell in a
    subprocess (``ok``) while the kernels run at the per-rank shapes, then
    the three families served sharded on one card."""
    import tempfile

    t0 = time.time()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as out_dir:
        proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun",
                                 "--out-dir", out_dir, "--force"] + FAMILY_DRYRUN_CELL,
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        records = phase_family_shard_kernels(torch, mods, card)
        finish(proc, "the dry run " + " ".join(FAMILY_DRYRUN_CELL))
        (fname,) = os.listdir(out_dir)
        with open(os.path.join(out_dir, fname)) as f:
            rec = json.load(f)
        require(rec["status"] == "ok", f"{fname}: {rec.get('error')}")
        log(f"dry run {rec['arch']} {rec['shape']} {rec['mesh']} ({rec['n_devices']} ranks): "
            f"per-rank peak {rec['memory']['peak_args_plus_temp'] / 2**30:.4f} GiB, FLOPs "
            f"{rec['cost']['flops']:.6e}, collectives "
            + json.dumps({k: v["count"] for k, v in rec["collectives"].items()})
            + f", {rec['compile_scan_s']} s")
    counts = phase_sharded_serving(torch, mods, card, FAMILY_SHARD_ARCHS)
    log(f"phase 26 done in {time.time() - t0:.1f} s; the card: {card}")
    return records, counts


# --------------------------------------------------------------------------
# phase 27: the serving fleet on a mesh
# --------------------------------------------------------------------------

def phase_fleet_on_mesh(torch, mods, card, plain):
    """Phase 23's flash-crowd fleet (full-width llama3.2-1b, ``--fleet 2``,
    8 slots, page 16, the kernels, seed 0) through the serve launcher's
    ``run_fleet_real`` on a (1, 1) NCCL mesh, as ``--fleet`` runs under
    ``torchrun``: the weights DTensors on ``serve_param_shardings``, each
    replica's pool on ``page_pool_shardings``, the sessions on the mesh's
    clock.  Phase 23's rules: exact launches, no plain attention, every
    request finished, one copy of the weights and no pool storage shared;
    each request's tokens against one plain engine alone on the same
    (gathered) weights, and the fleet teacher-forced with that engine's
    tokens, every draw's logits at the bf16 bar (3e-2).  Logged: the
    sharded fleet's per-replica decode-step p50 beside phase 23's plain
    fleet's (``plain``, its flash-crowd summary) and the card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.device import is_dtensor
    from repro_torch.dist import sharding as SH
    from repro_torch.launch import serve
    from repro_torch.models.hooks import install_constraint
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        args = serve.parser().parse_args(FLEET_ARGV + FLEET_TRACES["flash-crowd"])
        args.mesh = mesh
        install_constraint(SH.activation_constraint_fn(SH.replica_mesh(mesh)))
        try:
            reset(mods)
            res = serve.run_fleet_real(args)
            counts = counts_of(mods)
        finally:
            install_constraint(None)
        objs = res.pop("objects")
        engines, reqs = objs["engines"], objs["requests"]
        cfg = engines[0].cfg
        require((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.vocab)
                == LLAMA_DIMS, cfg)
        require(all(is_dtensor(t) for t in leaves(objs["params"])), "a weight is not a DTensor")
        for e in engines:
            require(e.mesh is not None and e.clock_mesh is mesh
                    and all(is_dtensor(t) for t in leaves(e.pool.blocks)),
                    "a replica is not on the mesh")
            require((e.split.lo, e.split.hi, e.split.size) == (0, e.n_slots, 1)
                    and res["data_ranks"] == 1, f"a replica's slots: {e.split}")
        check_fleet_launches(engines, counts)
        require(res["requests"] == res["n_requests"] == len(reqs) == len(objs["finished"]) > 0,
                res)
        for r in reqs:
            require(len(r.out) == r.max_new and all(0 <= t < cfg.vocab for t in r.out), r.rid)
        require(all(e.params is objs["params"] for e in engines), "one copy of the weights")
        require(not storages(engines[0]) & storages(engines[1]), "replicas share a pool")
        fleet = [list(r.out) for r in reqs]
        whole = SH.gather(objs["params"])
        alone, alone_draws = fleet_alone(torch, cfg, whole, reqs, engines[0].max_len)
        parted = {i: next(k for k, (a, b) in enumerate(zip(f, s)) if a != b)
                  for i, (f, s) in enumerate(zip(fleet, alone)) if f != s}
        forced, forced_counts = fleet_forced(torch, mods, res, objs, alone, mesh=mesh)
        require(set(forced) == set(alone_draws), "the draws")
        err = 0.0
        for key in alone_draws:
            torch.testing.assert_close(forced[key], alone_draws[key], **BF16_TOL)
            err = max(err, float((forced[key] - alone_draws[key]).abs().max()))
        margins = {i: dict(step=k, fleet_top2=top2_margin(torch, forced[i, k]),
                           alone_top2=top2_margin(torch, alone_draws[i, k]))
                   for i, k in parted.items()}
        sharded_p50 = [r["step_ms_p50"] for r in res["per_replica"]]
        log(f"fleet llama3.2-1b flash-crowd on a (1, 1) NCCL mesh, data degree "
            f"{res['data_ranks']}: {res['requests']} "
            f"requests, {res['tokens']} tokens, routed {res['routed']}, prefix-routed "
            f"{res['prefix_routed']}, prefix hits {res['prefix_hits']} of "
            f"{res['prefix_lookups']} lookups, wall {res['wall_s']:.3f} s, "
            f"{res['tok_per_s']:.2f} tok/s; launches {json.dumps(counts)}")
        log(f"fleet llama3.2-1b flash-crowd on a (1, 1) NCCL mesh: tokens equal one plain "
            f"engine alone for {len(reqs) - len(parted)} of {len(reqs)} requests; parted "
            f"(request: first step, top-2 logit margins fleet/alone there) "
            f"{json.dumps(margins)}; teacher-forced with the single engine's tokens: "
            f"max_abs_err {err:.4g} over {len(alone_draws)} draws (atol/rtol 3e-2), launches "
            f"{json.dumps(forced_counts)}")
        log(f"fleet llama3.2-1b flash-crowd decode-step p50 per replica: sharded "
            f"{json.dumps(sharded_p50)} ms, plain (phase 23) {json.dumps(plain['step_ms_p50'])} "
            f"ms; the phase's run {time.perf_counter() - t0:.3f} s; the card: {card}")
        del engines, objs, forced, alone_draws, whole
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        if made:
            dist.destroy_process_group()
    return counts


def moe_exchange_step(torch, cfg, p, x, r, exchange, group=None):
    """One forward and backward of granite's MoE layer on a plain (T, d)
    batch, the aux loss left out: through the data-split exchange on a
    one-rank ``group`` (``exchange``: route, plan, ``send_rows``, the
    experts on the rank's slots, ``return_rows``) or through the plain
    ``dispatch`` and ``combine``.  Returns the output and the gradients of
    ``sum(out * r)`` for x and every parameter."""
    from repro_torch.models import moe as M

    p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    x = x.detach().clone().requires_grad_(True)
    cap = M.capacity(cfg, x.shape[0])
    if exchange:
        _, counts, gates, idx = M._route_own(cfg, p["router"], x)
        starts, sizes = M.slot_spans(cap, [1])
        ex, keep = M.plan_exchange(counts, idx, 0, cap, starts, sizes)
        out_buf = M.experts(p, M.send_rows(x, ex, cfg.n_experts, cfg.top_k, group))
        w = (gates.reshape(-1) * keep.float()).to(x.dtype)
        out = M.return_rows(out_buf, ex, w, cfg.top_k, group)
    else:
        buf, src_e, src_c, w, _ = M.dispatch(cfg, p["router"], x, cap)
        out = M.combine(M.experts(p, buf), src_e, src_c, w, cfg.top_k)
    (out.float() * r).sum().backward()
    return out.detach(), {"x": x.grad, **{k: v.grad for k, v in p.items()}}


def phase_moe_exchange(torch, mods, card):
    """The data-split MoE exchange (``models/moe.py``: ``plan_exchange``,
    ``send_rows``, ``return_rows``) at granite-moe-3b-a800m's full width
    (d 1536, E 40, top-8, moe_d_ff 512) on T = 8 × 128 bf16 tokens that
    share a direction (skewed routing, capacity 256), over a one-rank NCCL
    group (a one-rank mesh has no token group, so the exchange functions
    are called directly), against the plain ``dispatch`` and ``combine``
    on the same inputs: the output and the gradients of x, the router and
    w1, w3, w2 at the bf16 bar (3e-2); no kernel launched.  Logged: both
    paths' forward and backward on the host clock (synchronised; medians
    of 20 each, run in turns plain, exchange, exchange, plain) and peak
    bytes, and the card."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models import moe as M

    t0 = time.perf_counter()
    cfg = get_config("granite-moe-3b-a800m")
    require((cfg.d_model, cfg.n_experts, cfg.top_k, cfg.moe_d_ff) == (1536, 40, 8, 512), cfg)
    p = {k: v.to("cuda") for k, v in
         M.init_moe(cfg, torch.Generator().manual_seed(0), torch.bfloat16, "cpu").items()}
    rng = np.random.default_rng(11)
    t, d = 8 * 128, cfg.d_model
    x = (randn(torch, rng, t, d) + randn(torch, rng, d, std=1.5)).to(torch.bfloat16)
    r = randn(torch, rng, t, d)
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        reset(mods)
        got, got_g = moe_exchange_step(torch, cfg, p, x, r, True, group)
        counts = counts_of(mods)
        want, want_g = moe_exchange_step(torch, cfg, p, x, r, False)
        require(not any(counts.values()), f"a kernel launched: {counts}")
        errs = {"out": compare(torch, got, want, BF16_TOL, "MoE exchange: out")}
        for k in want_g:
            errs[k] = compare(torch, got_g[k], want_g[k], BF16_TOL, f"MoE exchange: d{k}")
        times, peaks = {True: [], False: []}, {}
        for exchange in (False, True, True, False):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            for _ in range(10):
                t1 = time.perf_counter()
                moe_exchange_step(torch, cfg, p, x, r, exchange, group)
                torch.cuda.synchronize()
                times[exchange].append((time.perf_counter() - t1) * 1e3)
            peaks[exchange] = torch.cuda.max_memory_allocated() - base
        log(f"MoE exchange, granite-moe-3b-a800m full width (T {t}, d {d}, E 40, top-8, "
            f"capacity {M.capacity(cfg, t)}, bf16) on a one-rank NCCL group: max_abs_err "
            f"{json.dumps({k: float(f'{v:.4g}') for k, v in errs.items()})} (atol/rtol 3e-2); "
            f"forward and backward, host clock median of 20: exchange "
            f"{np.median(times[True]):.3f} ms, plain dispatch/combine "
            f"{np.median(times[False]):.3f} ms; peak above the inputs: exchange "
            f"{peaks[True]} B, plain {peaks[False]} B; the phase's run "
            f"{time.perf_counter() - t0:.3f} s; the card: {card}")
    finally:
        if made:
            dist.destroy_process_group()


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
    step_counts, timing["paged_scatter_step"] = phase_scatter_step(torch, mods, card)

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
    prefix_counts, _ = phase_prefix(torch, mods)
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
                 paged_scatter=ops_counts, paged_scatter_step=step_counts,
                 flash_attention=rg_counts, rmsnorm=mamba_counts, ssd_scan=mamba_counts,
                 rglru_scan=rg_counts)
    require(all(paths[k][k] > 0 for k in KERNELS), paths)
    phase_collectives(torch, card)
    torch.cuda.empty_cache()
    phase_train_parity(torch, mods)
    torch.cuda.empty_cache()
    phase_train(torch, mods, card)
    torch.cuda.empty_cache()
    phase_train_live(torch, mods, card)
    torch.cuda.empty_cache()
    phase_telemetry(torch, mods, card)
    torch.cuda.empty_cache()
    phase_checkpoint(torch, mods, card)
    torch.cuda.empty_cache()
    phase_examples(torch, mods, card)
    torch.cuda.empty_cache()
    fleet = phase_fleet(torch, mods, card)
    torch.cuda.empty_cache()
    phase_shard_kernels(torch, mods, card)
    phase_sharded_serving(torch, mods, card, ("llama3.2-1b",))
    torch.cuda.empty_cache()
    phase_dryrun(torch, mods, card)
    torch.cuda.empty_cache()
    _, shard_counts = phase_family_sharding(torch, mods, card)
    torch.cuda.empty_cache()
    mesh_fleet_counts = phase_fleet_on_mesh(torch, mods, card, fleet["flash-crowd"])
    torch.cuda.empty_cache()
    phase_moe_exchange(torch, mods, card)
    log("launches on the llama3.2-1b path " + json.dumps(llama_counts)
        + "; under --theta predictive " + json.dumps(predictive_counts)
        + "; with the prefix cache (warm, greedy) " + json.dumps(prefix_counts)
        + "; on the recurrentgemma-2b path " + json.dumps(rg_counts)
        + "; on the mamba2-130m path " + json.dumps(mamba_counts)
        + "; on the granite-moe-3b-a800m path " + json.dumps(granite_counts)
        + "; on the kernels.ops path " + json.dumps(ops_counts)
        + "; on the data-split step's write (share_new_rows) " + json.dumps(step_counts)
        + "; on the fleet's (flash crowd, session reuse) "
        + json.dumps({name: run["counts"] for name, run in fleet.items()}))
    log("launches on the other families' paths " + json.dumps(family_counts))
    log("launches on the other families' sharded paths, (1, 1) mesh "
        + json.dumps(shard_counts))
    log("launches on the fleet's path on a (1, 1) mesh (flash crowd) "
        + json.dumps(mesh_fleet_counts))
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
