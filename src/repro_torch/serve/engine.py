"""Serving engines: continuous batching over the paged KV pool + legacy API.

Ported from ``repro.serve.engine``.  ``ContinuousEngine`` keeps a decode
batch of ``n_slots`` continuously refilled: arrived requests **join on
prefill** (``transformer.prefill``; attention K/V scattered into pool
pages, RG-LRU and SSM state into the slot's row), finished requests
**evict on EOS**.  Each decode step runs every slot through one paged step (idle
slots write the scratch page) and reports filled versus capacity, plus the
idle gaps between arrivals, to the governor through
:class:`~repro_torch.serve.slack.DecodeSlackMeter`.

``attn_kernel`` picks plain PyTorch (``"plain"``, the reference's XLA
branches) or the hand-written kernels (``"cuda"``, the counterpart of the
reference's ``"pallas"``: paged decode attention, RMSNorm, flash prefill
attention, RG-LRU scan, SSD scan).  An attention-free arch (mamba2)
launches no paged kernel.  ``None``, the default, follows the device:
the kernels on a CUDA device, plain PyTorch on the CPU.  A step is timed
from before its inputs go to the device until the device has finished it
(``torch.cuda.synchronize``): the meter prices slack from those times,
and a clock stopped at launch would price the wrong slack.

Greedy decoding matches the reference token for token; the argmax runs on
the device and only ``B`` tokens come back.  Sampling with a temperature
draws as the reference does, with :mod:`repro_torch.jrandom` (the draws
of ``jax.random`` on torch tensors): a request's ``n``-th token is
``categorical(fold_in(req.key, n), logits / T)``, and a decode step draws
every keyed slot at once on the logits' device and copies the ``(B,)``
tokens to the host once.  A temperature with no key is greedy, as in the
reference.  The prefix cache and the tracer hooks are not ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import jrandom
from repro_torch.device import resolve_device, resolve_kernel
from repro_torch.models.transformer import decode_step as _decode
from repro_torch.models.transformer import init_cache
from repro_torch.models.transformer import prefill as _prefill
from repro_torch.serve.kvcache import (
    SCRATCH_PAGE,
    PagedKVPool,
    paged_attention_decode,
    scatter_prefill_attn,
)
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.slack import DecodeSlackMeter


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tempered(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """``logits / temperature`` in the logits' dtype, a true division as the
    reference's (a CUDA tensor divided by a Python float is multiplied by
    the reciprocal, which can move the last bit)."""
    return logits / torch.full((), temperature, dtype=logits.dtype, device=logits.device)


def sample_rows(logits: torch.Tensor, rows: List[int], keys: Optional[torch.Tensor],
                temperature: float) -> torch.Tensor:
    """(B,) int32 tokens on the logits' device from (B, V) logits: greedy,
    except that row ``rows[i]`` is drawn at ``temperature`` with
    ``keys[i]`` (``keys (R, 2)``), all in one
    :func:`~repro_torch.jrandom.categorical_rows` pass."""
    tok = torch.argmax(logits, dim=-1)
    if rows:
        idx = torch.tensor(rows, device=logits.device)
        tok[idx] = jrandom.categorical_rows(keys, _tempered(logits[idx], temperature))
    return tok.to(torch.int32)


# --------------------------------------------------------------------------
# legacy static-batch engine (dense cache)
# --------------------------------------------------------------------------

@dataclass
class ServeEngine:
    cfg: Any
    params: Any
    max_len: int
    temperature: float = 0.0
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @torch.no_grad()
    def generate(self, batch: Dict[str, Any], n_steps: int,
                 key: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Greedy/sampled continuation of ``batch['tokens']`` (B,S) for
        n_steps, after ``batch['prefix_embeds']`` where there is one."""
        tokens = torch.as_tensor(np.asarray(batch["tokens"]), device=self.device)
        b, s = tokens.shape
        prompt_len = s + self.cfg.n_prefix
        inputs = {"tokens": tokens}
        if "prefix_embeds" in batch:
            inputs["prefix_embeds"] = torch.as_tensor(np.array(batch["prefix_embeds"]),
                                                      device=self.device)
        cache = init_cache(self.cfg, b, self.max_len, self.device)
        logits, cache = _prefill(self.cfg, self.params, inputs, cache)
        tok = self._select(logits, key, 0)
        out = [tok]
        for i in range(1, n_steps):
            logits, cache = _decode(self.cfg, self.params, tok, prompt_len + i - 1, cache)
            tok = self._select(logits, key, i)
            out.append(tok)
        return torch.stack(out, dim=1)                         # (B, n_steps)

    def _select(self, logits: torch.Tensor, key: Optional[torch.Tensor], i: int):
        """Greedy, or one draw over the whole (B, V) logits with
        ``fold_in(key, i)``, as the reference's ``_select``."""
        if self.temperature <= 0.0 or key is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        sub = jrandom.fold_in(key, i)
        return jrandom.categorical(sub, _tempered(logits, self.temperature)).to(torch.int32)


# --------------------------------------------------------------------------
# paged step factories
# --------------------------------------------------------------------------

def make_paged_decode_step(cfg, attn_kernel: Optional[str] = None,
                           fused_sample: bool = False) -> Callable:
    """decode(params, token (B,), pos (B,), table (B,M), blocks) -> (out, blocks).

    Reuses ``transformer.decode_step`` and swaps only the attention for the
    paged one; RG-LRU and SSM layers step every slot's row of the pool's
    state.
    ``attn_kernel`` (None: follow the tokens' device) picks plain PyTorch
    or the kernels.  The pool blocks are updated in place.  With
    ``fused_sample`` the greedy argmax runs in the step and ``out`` is the
    sampled (B,) int32 tokens on the device; otherwise the logits.
    """
    resolve_kernel(attn_kernel, "cpu")            # refuse an unknown name now

    def step(params, token, pos, table, blocks):
        kernel = resolve_kernel(attn_kernel, token.device)

        def paged_attn(p_attn, h, bc):
            return paged_attention_decode(cfg, p_attn, h, pos, table, bc, kernel=kernel)

        logits, blocks = _decode(cfg, params, token, pos, blocks, attn_fn=paged_attn,
                                 kernel=kernel)
        if fused_sample:
            return torch.argmax(logits, dim=-1).to(torch.int32), blocks
        return logits, blocks

    return step


def make_join_step(cfg) -> Callable:
    """join(blocks, prefill_cache, page_ids (n_used,), slot) -> blocks:
    scatter a batch-1 prefill cache into the pool, in place: attention K/V
    into the slot's freshly allocated pages, recurrent state into the
    slot's row (cast to the pool's dtype, as the reference's ``.set``)."""

    def join(blocks, cache, page_ids, slot: int):
        for kind, pb, cb in zip(cfg.layer_kinds(), blocks["layers"], cache["layers"]):
            if kind == "attn":
                scatter_prefill_attn(pb, cb, page_ids)
            else:
                for name, big in pb.items():
                    big[slot] = cb[name][0].to(big.dtype)
        return blocks

    return join


# --------------------------------------------------------------------------
# continuous-batching engine
# --------------------------------------------------------------------------

@dataclass
class ContinuousEngine:
    """Continuous batching over a paged KV pool with governor-priced slack.

    ``n_slots`` is the decode batch width, ``max_len`` the per-request
    position budget (multiple of ``page``), ``num_pages`` optionally
    shrinks the pool below full occupancy.  For windowed archs prompts
    must fit inside the window (the pool stores positions linearly and
    masks by window at read).  A frontend arch's request (``cfg.n_prefix``)
    carries ``prefix_embeds`` (n_prefix, d), prefilled before its prompt
    and counted in its positions; one without is refused when submitted.
    ``device`` is ``cuda`` unless the caller names another; the params
    must already be there.
    """

    cfg: Any
    params: Any
    n_slots: int = 4
    max_len: int = 128
    page: int = 16
    num_pages: Optional[int] = None
    temperature: float = 0.0
    attn_kernel: Optional[str] = None
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.attn_kernel = resolve_kernel(self.attn_kernel, self.device)
        if self.params["embed"].device != self.device:
            raise ValueError(f"params are on {self.params['embed'].device}, "
                             f"the engine on {self.device}")
        self.pool = PagedKVPool(self.cfg, self.n_slots, self.max_len, self.page,
                                self.num_pages, device=self.device)
        # greedy decoding samples inside the step; a temperature needs logits
        self._fused_sample = self.temperature <= 0.0
        self._decode = make_paged_decode_step(self.cfg, self.attn_kernel,
                                              self._fused_sample)
        self._join = make_join_step(self.cfg)
        m = self.pool.max_pages_per_req
        self._table = np.full((self.n_slots, m), SCRATCH_PAGE, np.int32)
        self._lengths = np.zeros((self.n_slots,), np.int32)
        self._tokens = np.zeros((self.n_slots,), np.int32)
        self.n_decode_steps = 0                # every decode step this engine ran
        self.n_joins = 0                       # every prefill this engine ran
        self._last_meter: Optional[DecodeSlackMeter] = None
        self._last_session: Optional["EngineSession"] = None

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ---- request lifecycle ----------------------------------------------
    def _join_request(self, req: Request) -> None:
        cfg = self.cfg
        prompt = np.asarray(req.prompt, np.int32)
        total = len(prompt) + cfg.n_prefix
        n_used = self.pool.pages_needed(total)
        lpad = n_used * self.pool.page
        if cfg.attention in ("swa", "local") and cfg.window and lpad > cfg.window:
            raise ValueError(
                f"paged serving stores positions linearly: prompt pages {lpad} "
                f"must fit the attention window {cfg.window}"
            )
        batch = {"tokens": self._to_device(prompt[None])}
        if req.prefix_embeds is not None:
            batch["prefix_embeds"] = self._to_device(np.array(req.prefix_embeds)[None])
        cache = init_cache(cfg, 1, lpad, self.device)
        logits, cache = _prefill(cfg, self.params, batch, cache, kernel=self.attn_kernel)
        self.n_joins += 1
        req.pages = self.pool.alloc(req.rid, n_used)
        slot = req.slot
        self._table[slot] = SCRATCH_PAGE
        self._table[slot, :n_used] = req.pages
        self.pool.blocks = self._join(self.pool.blocks, cache,
                                      self._to_device(np.asarray(req.pages, np.int32)), slot)
        tok = self._select_one(logits[0], req)
        req.out.append(tok)
        self._lengths[slot] = total
        self._tokens[slot] = tok

    def _select_one(self, logits: torch.Tensor, req: Request) -> int:
        """A join's first token from its (V,) logits, drawn as a step draws."""
        return int(self._select_step(logits[None], [(0, req)])[0])

    def _select_step(self, logits: torch.Tensor, active: List[tuple]) -> torch.Tensor:
        """(B,) int32 tokens on the device from (B, V) logits: at a
        temperature, every active slot whose request has a key draws with
        ``fold_in(req.key, req.n_generated)``; the others take the argmax."""
        keyed = [(slot, req) for slot, req in active
                 if req.key is not None and self.temperature > 0.0]
        keys = None
        if keyed:
            keys = jrandom.fold_in(torch.stack([req.key for _, req in keyed]),
                                   torch.tensor([req.n_generated for _, req in keyed]))
        return sample_rows(logits, [slot for slot, _ in keyed], keys, self.temperature)

    def _grow_pages(self, req: Request) -> None:
        pos = int(self._lengths[req.slot])
        while pos // self.pool.page >= len(req.pages):
            (pid,) = self.pool.alloc(req.rid, 1)
            self._table[req.slot, len(req.pages)] = pid
            req.pages.append(pid)

    def _retire(self, req: Request, sched: Scheduler, slo, now: float) -> None:
        if slo is not None:
            slo.on_finish(req, now)
        else:
            req.t_done = now
        self._table[req.slot] = SCRATCH_PAGE
        self._tokens[req.slot] = 0
        self._lengths[req.slot] = 0
        sched.release(req)

    # ---- driving loop ----------------------------------------------------
    @torch.no_grad()
    def serve(self, requests: List[Request], governor=None, slo=None,
              max_steps: int = 100_000) -> List[Request]:
        """Run all requests to completion; returns them with outputs filled.

        Arrival offsets are honored against a wall clock started at call
        time; idle waits and per-step underfill are published as phases to
        ``governor`` (a :class:`~repro_torch.core.governor.Governor` or an
        :class:`~repro_torch.core.events.EventBus`) when given.
        """
        sess = EngineSession(self, governor=governor, slo=slo)
        for r in requests:
            sess.submit(r)
        steps = 0
        while not sess.done:
            sess.admit()
            if sess.n_active == 0:
                if not sess.sleep_until_next():
                    break
                continue
            sess.decode_step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"serve() exceeded {max_steps} decode steps")
        return sess.finished

    # ---- ServeEngine-compatible entry point ------------------------------
    def generate(self, batch: Dict[str, Any], n_steps: int,
                 key: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Static-batch compatibility: all rows arrive at t=0, run to n_steps.

        Greedy output matches ``ServeEngine.generate`` token for token.
        Sampled output gives row ``i`` the key ``fold_in(key, i)``, as the
        reference (not the static engine's one key a step).  Row ``i`` of
        ``batch["prefix_embeds"]``, where there is one, is request ``i``'s.
        """
        tokens = np.asarray(batch["tokens"])
        b = tokens.shape[0]
        if b > self.n_slots:
            raise ValueError(f"batch {b} exceeds n_slots {self.n_slots}")
        reqs = [Request(prompt=tokens[i], max_new=n_steps, arrival=0.0,
                        key=None if key is None else jrandom.fold_in(key, i))
                for i in range(b)]
        if "prefix_embeds" in batch:
            pre = np.asarray(batch["prefix_embeds"])
            for i, req in enumerate(reqs):
                req.prefix_embeds = pre[i]
        order = {r.rid: i for i, r in enumerate(reqs)}
        done = sorted(self.serve(reqs), key=lambda r: order[r.rid])
        return torch.as_tensor(np.stack([np.asarray(r.out[:n_steps], np.int32) for r in done]))


# --------------------------------------------------------------------------
# step-granular session
# --------------------------------------------------------------------------

class EngineSession:
    """One engine's serving loop, exposed a step at a time.  All timestamps
    are relative to ``t_start``.  ``step_seconds`` keeps every decode
    step's synchronised duration."""

    def __init__(self, engine: ContinuousEngine, governor=None, slo=None,
                 t_start: Optional[float] = None):
        self.engine = engine
        self.slo = slo
        self.sched = Scheduler(engine.pool, engine.n_slots, n_prefix=engine.cfg.n_prefix,
                               slo=slo)
        self.meter = DecodeSlackMeter(governor) if governor is not None else None
        engine._last_meter = self.meter
        engine._last_session = self
        self.finished: List[Request] = []
        self.t_start = time.monotonic() if t_start is None else t_start
        self.steps = 0
        self.step_seconds: List[float] = []

    # ---- clock -----------------------------------------------------------
    def now(self) -> float:
        return time.monotonic() - self.t_start

    # ---- queue state -----------------------------------------------------
    @property
    def done(self) -> bool:
        return self.sched.done

    @property
    def n_active(self) -> int:
        return self.sched.n_active

    @property
    def n_queued(self) -> int:
        return self.sched.n_queued

    def next_arrival(self) -> Optional[float]:
        return self.sched.next_arrival()

    def fill_fraction(self) -> float:
        return self.sched.n_active / max(self.engine.n_slots, 1)

    # ---- lifecycle -------------------------------------------------------
    def submit(self, req: Request) -> None:
        cfg = self.engine.cfg
        if cfg.n_prefix and req.prefix_embeds is None:
            # without the prefix, positions [S, S+n_prefix) would never be
            # written and the page mask would attend their zero K/V
            raise ValueError(
                f"arch {cfg.name!r} has n_prefix={cfg.n_prefix}: "
                f"request {req.rid} must carry prefix_embeds")
        self.sched.submit(req)

    def admit(self, now: Optional[float] = None) -> List[Request]:
        """Join every arrived request that fits; returns the joins."""
        eng = self.engine
        joins = self.sched.admit(self.now() if now is None else now)
        for req in joins:
            eng._join_request(req)
            tnow = self.now()
            if self.slo is not None:
                self.slo.on_first_token(req, tnow)
            else:
                req.t_first = req.t_prev = tnow
            if not req.wants_more():
                eng._retire(req, self.sched, self.slo, tnow)
                self.finished.append(req)
        return joins

    def sleep_until_next(self) -> bool:
        """Idle until the next arrival (metered); False when queue is empty."""
        nxt = self.sched.next_arrival()
        if nxt is None:
            return False
        t0 = time.monotonic()
        wait = (self.t_start + nxt) - t0
        if wait > 0:
            time.sleep(wait)
        t1 = time.monotonic()
        self.note_idle(t0, t1)
        return True

    def note_idle(self, t0: float, t1: float) -> None:
        if self.meter is not None and t1 > t0:
            self.meter.idle(t0, t1)

    def decode_step(self) -> None:
        """One batched decode step over all active slots."""
        eng = self.engine
        sched = self.sched
        for req in sched.active.values():
            eng._grow_pages(req)
        # clamp the table to the live pages: no request's K/V extends past
        # ceil((max_pos + 1) / page) pages
        max_pos = int(eng._lengths.max())
        m_live = min(eng._table.shape[1], max_pos // eng.pool.page + 1)
        t0 = time.monotonic()
        out, blocks = eng._decode(
            eng.params,
            eng._to_device(eng._tokens),
            eng._to_device(eng._lengths),
            eng._to_device(eng._table[:, :m_live]),
            eng.pool.blocks,
        )
        _sync(eng.device)                      # t1 is when the device is done
        t1 = time.monotonic()
        eng.pool.blocks = blocks
        eng.n_decode_steps += 1
        self.step_seconds.append(t1 - t0)
        if self.meter is not None:
            self.meter.step(t0, t1, sched.n_active, eng.n_slots)
        active = list(sched.active.items())
        if not eng._fused_sample:
            out = eng._select_step(out, active)
        tokens = out.cpu().numpy()             # the step's one copy to the host
        tnow = self.now()
        for slot, req in active:
            eng._lengths[slot] += 1
            tok = int(tokens[slot])
            first = not req.out
            req.out.append(tok)
            eng._tokens[slot] = tok
            if self.slo is not None:
                if first:
                    self.slo.on_first_token(req, tnow)
                else:
                    self.slo.on_token(req, tnow)
            else:
                if first:
                    req.t_first = tnow
                req.t_prev = tnow
            if not req.wants_more():
                eng._retire(req, sched, self.slo, tnow)
                self.finished.append(req)
        self.steps += 1
