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
reference.

``enable_prefix_cache`` attaches a
:class:`~repro_torch.serve.fleet.prefix.PrefixCache` to the pool, as the
reference's: a request whose prompt begins with resident pages joins
without prefill, sharing the full pages, writing into a copy-on-write
clone of a partial one, and replaying the rest of its prompt through the
decode step as *forced* tokens; a retiring request's pages join the trie.
``tracer`` (a :class:`~repro_torch.obs.tracer.SpanTracer`) receives the
``join`` and ``evict`` instants, stamped on ``time.monotonic`` as the
decode phases are (the reference stamps them on the session's clock, so
its trace puts them apart from the phases; ROADMAP.md, queue 3).  A
tracer with a ``span`` hook also receives the serving loop's spans, on
the same clock: each decode ``step`` tiled by ``prepare`` (page growth),
``dispatch`` (the host enqueues the step; the device's time too where the
launch queue fills or the step syncs), ``device_wait`` (until the device
is done), ``publish`` (the slack meter's bus and governor), ``sample``
(the draw and the tokens' copy to the host) and ``bookkeep`` (the token
loop); each ``admit`` that joins, holding a ``join`` a request
(``join_dispatch``: until the prefill is enqueued, ``join_wait``: the
pages' copy, which waits for the prefill, the pool scatter and the draw,
until its first token is on the host); and each request's ``queue`` wait,
from when it was due to its join.  Spans nest by time; the metered idle
gaps are the slack meter's phases.  A span cut by an exception is
dropped.  Without the hook, or without a tracer, each site costs one
``None`` check.

On a ``(data, model)`` mesh (``serve_mesh``) an engine splits its slots
over the data ranks, as the reference's batch constraint does under XLA:
the weights and the pages are DTensors on the rank's ``model`` row
(:func:`~repro_torch.dist.sharding.replica_mesh`), and each data rank
decodes its own span of the slots
(:func:`~repro_torch.dist.sharding.slot_split`) as plain local rows, with
only those slots' recurrent state.  Once a step the ranks gather the new
K/V rows into every rank's replicated pages
(:func:`~repro_torch.serve.kvcache.share_new_rows`) and the sampled
tokens, so that every rank's host runs the same scheduler on the same
tokens.  Joins prefill on every rank, as the reference's batch-1 prefill
replicates.  A batch the data size does not divide replicates: every rank
decodes all of it.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import jrandom
from repro_torch.device import resolve_device, resolve_kernel
from repro_torch.dist import sharding as SH
from repro_torch.models.transformer import decode_step as _decode
from repro_torch.models.transformer import init_cache
from repro_torch.models.transformer import prefill as _prefill
from repro_torch.serve.kvcache import (
    SCRATCH_PAGE,
    PagedKVPool,
    make_clone_pages,
    paged_attention_decode,
    scatter_prefill_attn,
    share_new_rows,
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

def make_serve_steps(cfg, kernel: Optional[str] = None):
    """Returns (prefill_step(params, batch, cache), decode_step(params, token,
    pos, cache)) over ``transformer.prefill`` and ``decode_step``, without
    autograd, the cache written in place.  ``kernel`` as in
    :func:`~repro_torch.device.resolve_kernel` (None follows the device)."""

    @torch.no_grad()
    def prefill_step(params, batch, cache):
        return _prefill(cfg, params, batch, cache, kernel=kernel)

    @torch.no_grad()
    def decode_step(params, token, pos, cache):
        return _decode(cfg, params, token, pos, cache, kernel=kernel)

    return prefill_step, decode_step


@dataclass
class ServeEngine:
    """The static batch.  ``serve_mesh`` (a ``(data, model)`` mesh, the
    params DTensors on its :func:`~repro_torch.dist.sharding.replica_mesh`)
    splits each batch's rows over the data ranks where the data size
    divides it."""

    cfg: Any
    params: Any
    max_len: int
    temperature: float = 0.0
    device: Any = None
    serve_mesh: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.mesh = SH.mesh_of(self.params)      # None unless the params are DTensors

    @torch.no_grad()
    def generate(self, batch: Dict[str, Any], n_steps: int,
                 key: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Greedy/sampled continuation of ``batch['tokens']`` (B,S) for
        n_steps, after ``batch['prefix_embeds']`` where there is one.  With
        DTensor params the cache takes ``cache_shardings(serve_tp=True)``
        and the logits are gathered over the model axis before the draw.
        On ``serve_mesh`` each data rank decodes its own rows, draws them
        as the whole batch's draw does, and the (B, n_steps) tokens are
        gathered once at the end.  An MoE prefill routes each rank's rows at
        the whole batch's capacity and slots (``transformer.prefill``'s
        ``split``)."""
        split = SH.slot_split(self.serve_mesh, len(batch["tokens"]))
        rows = slice(split.lo, split.hi)
        tokens = torch.as_tensor(np.asarray(batch["tokens"])[rows], device=self.device)
        b, s = tokens.shape
        prompt_len = s + self.cfg.n_prefix
        inputs = {"tokens": tokens}
        if "prefix_embeds" in batch:
            inputs["prefix_embeds"] = torch.as_tensor(np.array(batch["prefix_embeds"])[rows],
                                                      device=self.device)
        cache = _sharded_cache(self.mesh, init_cache(self.cfg, b, self.max_len, self.device))
        with SH.replicating(self.mesh):
            logits, cache = _prefill(self.cfg, self.params, inputs, cache, split=split)
            tok = self._select(SH.whole(logits), key, 0, split.lo)
            out = [tok]
            for i in range(1, n_steps):
                logits, cache = _decode(self.cfg, self.params, tok, prompt_len + i - 1, cache)
                tok = self._select(SH.whole(logits), key, i, split.lo)
                out.append(tok)
        return split.gather(torch.stack(out, dim=1))          # (B, n_steps)

    def _select(self, logits: torch.Tensor, key: Optional[torch.Tensor], i: int,
                row0: int = 0):
        """Greedy, or one draw over the whole (B, V) logits with
        ``fold_in(key, i)``, as the reference's ``_select``; ``logits`` are
        the batch's rows from ``row0`` on, drawn as in that draw."""
        if self.temperature <= 0.0 or key is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        sub = jrandom.fold_in(key, i)
        return jrandom.categorical(sub, _tempered(logits, self.temperature),
                                   row0).to(torch.int32)


def _sharded_cache(mesh, cache):
    """A dense cache on the model's mesh (``cache_shardings(serve_tp=True)``:
    KV heads split as the projections split them, where the degree divides
    Hkv); as it is without a mesh."""
    if mesh is None:
        return cache
    return SH.distribute(cache, SH.cache_shardings(mesh, cache, serve_tp=True))


# --------------------------------------------------------------------------
# paged step factories
# --------------------------------------------------------------------------

def make_paged_decode_step(cfg, attn_kernel: Optional[str] = None,
                           fused_sample: bool = False, split: Optional[SH.SlotSplit] = None
                           ) -> Callable:
    """decode(params, token (B,), pos (B,), table (B,M), blocks) -> (out, blocks).

    Reuses ``transformer.decode_step`` and swaps only the attention for the
    paged one; RG-LRU and SSM layers step every slot's row of the pool's
    state.
    ``attn_kernel`` (None: follow the tokens' device) picks plain PyTorch
    or the kernels.  The pool blocks are updated in place.  With
    ``fused_sample`` the greedy argmax runs in the step and ``out`` is the
    sampled (B,) int32 tokens on the device; otherwise the logits.  With
    DTensor params (tensor parallel) the step runs with plain inputs
    replicated and ``out`` is whole over the model axis.  With ``split``
    (a :class:`~repro_torch.dist.sharding.SlotSplit` that splits the B
    slots over data ranks) the step takes the whole batch's inputs and
    decodes the rank's own rows ``[split.lo, split.hi)`` alone, on a pool
    whose recurrent state holds those rows; ``out`` is those rows', and
    every rank's new K/V rows land in every rank's pages before it returns
    (:func:`~repro_torch.serve.kvcache.share_new_rows`).
    """
    resolve_kernel(attn_kernel, "cpu")            # refuse an unknown name now
    shared = split is not None and split.split

    def step(params, token, pos, table, blocks):
        kernel = resolve_kernel(attn_kernel, token.device)
        whole_pos, whole_table = pos, table
        new_rows = None
        if shared:
            token, pos, table = (t[split.lo:split.hi] for t in (token, pos, table))
            new_rows = []

        def paged_attn(p_attn, h, bc):
            return paged_attention_decode(cfg, p_attn, h, pos, table, bc, kernel=kernel,
                                          new_rows=new_rows)

        with SH.replicating(SH.mesh_of(params["embed"])):
            logits, blocks = _decode(cfg, params, token, pos, blocks, attn_fn=paged_attn,
                                     kernel=kernel)
            logits = SH.whole(logits)
        if shared:
            blocks = share_new_rows(cfg, blocks, new_rows, whole_pos, whole_table, split)
        if fused_sample:
            return torch.argmax(logits, dim=-1).to(torch.int32), blocks
        return logits, blocks

    return step


def make_join_step(cfg, split: Optional[SH.SlotSplit] = None) -> Callable:
    """join(blocks, prefill_cache, page_ids (n_used,), slot) -> blocks:
    scatter a batch-1 prefill cache into the pool, in place: attention K/V
    into the slot's freshly allocated pages, recurrent state into the
    slot's row (cast to the pool's dtype, as the reference's ``.set``).
    With ``split``, the slot's row of recurrent state is written by the
    rank that owns the slot, at its local row; the pages by every rank."""
    lo = 0 if split is None else split.lo

    def join(blocks, cache, page_ids, slot: int):
        owned = split is None or split.owns(slot)
        for kind, pb, cb in zip(cfg.layer_kinds(), blocks["layers"], cache["layers"]):
            if kind == "attn":
                scatter_prefill_attn(pb, cb, page_ids)
            elif owned:
                for name, big in pb.items():
                    big[slot - lo] = cb[name][0].to(big.dtype)
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
    must already be there.  ``tracer`` (duck-typed: ``.serve_event``) gets
    each join and evict instant and, where its ``span`` hook is not None,
    the serving loop's spans (module docstring); ``prefix_cache`` is
    attached by :meth:`enable_prefix_cache`.  ``serve_mesh``, a ``(data, model)``
    mesh whose :func:`~repro_torch.dist.sharding.replica_mesh` holds the
    params, splits the slots over the data ranks (``split``) and gives the
    sessions its first rank's clock.
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
    tracer: Any = None
    prefix_cache: Any = None
    serve_mesh: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.attn_kernel = resolve_kernel(self.attn_kernel, self.device)
        if self.params["embed"].device != self.device:
            raise ValueError(f"params are on {self.params['embed'].device}, "
                             f"the engine on {self.device}")
        # the params' mesh when they are DTensors (tensor parallel): the
        # launcher puts the pool on it too; None for plain tensors
        self.mesh = SH.mesh_of(self.params)
        # this rank's span of the slots (all of them without a data split)
        self.split = SH.slot_split(self.serve_mesh, self.n_slots)
        # the ranks whose first rank's clock the engine's sessions take: the
        # whole serving mesh, else the params' own
        self.clock_mesh = self.mesh if self.serve_mesh is None else self.serve_mesh
        self.pool = PagedKVPool(self.cfg, self.n_slots, self.max_len, self.page,
                                self.num_pages, device=self.device,
                                state_rows=self.split.rows)
        # greedy decoding samples inside the step; a temperature needs logits
        self._fused_sample = self.temperature <= 0.0
        self._decode = make_paged_decode_step(self.cfg, self.attn_kernel,
                                              self._fused_sample, self.split)
        self._join = make_join_step(self.cfg, self.split)
        self._clone = make_clone_pages(self.cfg)
        m = self.pool.max_pages_per_req
        self._table = np.full((self.n_slots, m), SCRATCH_PAGE, np.int32)
        self._lengths = np.zeros((self.n_slots,), np.int32)
        self._tokens = np.zeros((self.n_slots,), np.int32)
        self.n_decode_steps = 0                # every decode step this engine ran
        self.n_joins = 0                       # every prefill this engine ran
        self._last_meter: Optional[DecodeSlackMeter] = None
        self._last_session: Optional["EngineSession"] = None
        # slot -> deque of prompt-suffix tokens still to force-decode after
        # a prefix-cache join (no sampling/appending until drained)
        self._forced: Dict[int, collections.deque] = {}

    def enable_prefix_cache(self, max_pages: Optional[int] = None):
        """Attach a :class:`~repro_torch.serve.fleet.prefix.PrefixCache` to
        the pool.

        Only attention K/V lives in shareable pages: recurrent state
        (SSM/RG-LRU) is per-slot and position-dependent, and frontend
        prefixes occupy positions the trie cannot key, so prefix reuse is
        restricted to all-attention archs with ``n_prefix == 0``.
        """
        if self.cfg.n_prefix:
            raise ValueError("prefix cache requires n_prefix == 0 "
                             "(frontend prefixes are not token-addressable)")
        if any(k != "attn" for k in self.cfg.pattern):
            raise ValueError("prefix cache requires an all-attention arch "
                             "(recurrent state is per-slot, not paged)")
        from repro_torch.serve.fleet.prefix import PrefixCache
        self.prefix_cache = PrefixCache(self.pool, max_pages=max_pages)
        return self.prefix_cache

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ---- request lifecycle ----------------------------------------------
    def _join_request(self, req: Request, stamp: bool = False) -> Optional[float]:
        """Prefill ``req`` into its slot and draw its first token.  With
        ``stamp``, returns the ``time.monotonic`` instant at which the
        prefill was enqueued (a prefix join's clone): before the pages'
        copy, which waits for the device."""
        m = req.prefix_match
        if m is not None and m.n_tokens > 0:
            return self._join_via_prefix(req, stamp)
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
        cache = _sharded_cache(self.mesh, init_cache(cfg, 1, lpad, self.device))
        with SH.replicating(self.mesh):
            logits, cache = _prefill(cfg, self.params, batch, cache, kernel=self.attn_kernel)
            t_enqueued = time.monotonic() if stamp else None
            self.n_joins += 1
            req.pages = self.pool.alloc(req.rid, n_used)
            slot = req.slot
            self._table[slot] = SCRATCH_PAGE
            self._table[slot, :n_used] = req.pages
            self.pool.blocks = self._join(self.pool.blocks, cache,
                                          self._to_device(np.asarray(req.pages, np.int32)),
                                          slot)
        tok = self._select_one(SH.whole(logits)[0], req)
        req.out.append(tok)
        self._lengths[slot] = total
        self._tokens[slot] = tok
        return t_enqueued

    def _join_via_prefix(self, req: Request, stamp: bool = False) -> Optional[float]:
        """Join without prefill: resident pages cover ``m.n_tokens`` prompt
        positions, the remaining suffix is replayed through the paged decode
        step as *forced* tokens (exact K/V, no sampling); the first sampled
        token only lands once the suffix drains.  Returns once the device
        has finished the clone, so the join's instant is not early."""
        m = req.prefix_match
        prompt = np.asarray(req.prompt, np.int32)
        pages = list(m.full_pages)
        if m.partial_page is not None:
            # copy-on-write: this request extends the half-filled page in
            # place, so it writes into a private clone while other referents
            # keep reading the shared original
            (pid,) = self.pool.alloc(req.rid, 1)
            self.pool.blocks = self._clone(self.pool.blocks, m.partial_page, pid)
            pages.append(pid)
        req.pages = pages
        slot = req.slot
        self._table[slot] = SCRATCH_PAGE
        self._table[slot, :len(pages)] = pages
        self._lengths[slot] = m.n_tokens              # next write position
        self._tokens[slot] = int(prompt[m.n_tokens])  # next input token
        rest = prompt[m.n_tokens + 1:]
        if len(rest):
            self._forced[slot] = collections.deque(int(t) for t in rest)
        t_enqueued = time.monotonic() if stamp else None
        _sync(self.device)
        return t_enqueued

    def _select_one(self, logits: torch.Tensor, req: Request) -> int:
        """A join's first token from its (V,) logits, drawn as a step draws."""
        return int(self._select_step(logits[None], [(0, req)])[0])

    def _select_step(self, logits: torch.Tensor, active: List[tuple]) -> torch.Tensor:
        """(R,) int32 tokens on the device from (R, V) logits: at a
        temperature, every active ``(row, request)`` whose request has a key
        draws its row with ``fold_in(req.key, req.n_generated)``; the other
        rows take the argmax.  A data rank's step hands it its own rows."""
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
        if self.tracer is not None:
            # on the phases' clock (time.monotonic), not the session's
            self.tracer.serve_event("evict", self._last_session.t_start + now,
                                    req.rid, req.slot)
        drained = self._forced.pop(req.slot, None) is None
        if self.prefix_cache is not None and req.pages and drained:
            # adopt this request's written pages into the resident trie:
            # positions 0..lengths-1 hold K/V of prompt + out[:-1] (the last
            # sampled token was never decoded, so its K/V was never written)
            n_written = int(self._lengths[req.slot])
            tokens = np.concatenate([
                np.asarray(req.prompt, np.int64), np.asarray(req.out, np.int64)
            ])[:n_written]
            self.prefix_cache.insert(tokens, req.pages)
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
    are relative to ``t_start``, except the spans' (``time.monotonic``).
    ``step_seconds`` keeps every decode step's synchronised duration.  The
    engine's tracer's ``span`` hook is resolved once, here."""

    def __init__(self, engine: ContinuousEngine, governor=None, slo=None,
                 t_start: Optional[float] = None):
        self.engine = engine
        self.slo = slo
        self.sched = Scheduler(engine.pool, engine.n_slots, n_prefix=engine.cfg.n_prefix,
                               slo=slo, prefix_cache=engine.prefix_cache)
        self.meter = DecodeSlackMeter(governor) if governor is not None else None
        engine._last_meter = self.meter
        engine._last_session = self
        self.finished: List[Request] = []
        self.t_start = time.monotonic() if t_start is None else t_start
        self.steps = 0
        self.step_seconds: List[float] = []
        # getattr-not-None: a tracer may carry the attribute and disown it
        self._span = getattr(engine.tracer, "span", None)

    # ---- clock -----------------------------------------------------------
    def now(self) -> float:
        """Session seconds.  An engine on a mesh runs one session on every
        rank of it, and every rank takes the first rank's clock (a
        broadcast a mesh dim a call, over the engine's ``clock_mesh``: its
        whole serving mesh, data and model ranks alike), so all admit the
        same requests on the same step."""
        return self._agreed(time.monotonic() - self.t_start)

    def _agreed(self, t: float) -> float:
        mesh = self.engine.clock_mesh
        return t if mesh is None else SH.agree(mesh, t, self.engine.device)

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
        span = self._span
        if span is not None:
            t_pop = time.monotonic()
        joins = self.sched.admit(self.now() if now is None else now)
        for req in joins:
            if span is not None:
                t_join = time.monotonic()
            t_enqueued = eng._join_request(req, span is not None)
            tnow = self.now()
            if span is not None:
                t_first = self.t_start + tnow
                n = len(req.prompt) if req.out else 0     # a prefix join prefills none
                span("queue", self.t_start + req.arrival, t_join, req.rid, n)
                span("join", t_join, t_first, req.rid, n)
                span("join_dispatch", t_join, t_enqueued, req.rid, n)
                span("join_wait", t_enqueued, t_first, req.rid, n)
            if eng.tracer is not None:
                # on the phases' clock (time.monotonic), not the session's
                eng.tracer.serve_event("join", self.t_start + tnow, req.rid, req.slot)
            if req.out:
                # prefill joins produce the first token immediately; prefix
                # joins stay silent until the forced suffix drains
                if self.slo is not None:
                    self.slo.on_first_token(req, tnow)
                else:
                    req.t_first = req.t_prev = tnow
            if not req.wants_more():
                eng._retire(req, self.sched, self.slo, tnow)
                self.finished.append(req)
        if span is not None and joins:
            span("admit", t_pop, t_first, None, len(joins))
        return joins

    def sleep_until_next(self) -> bool:
        """Idle until the next arrival (metered); False when queue is empty."""
        nxt = self.sched.next_arrival()
        if nxt is None:
            return False
        t0 = time.monotonic()
        wait = nxt - self._agreed(t0 - self.t_start)
        if wait > 0:
            time.sleep(wait)
        t1 = time.monotonic()
        self.note_idle(t0, t1)
        return True

    def note_idle(self, t0: float, t1: float) -> None:
        if self.meter is not None and t1 > t0:
            self.meter.idle(t0, t1)

    def decode_step(self) -> None:
        """One batched decode step over all active slots: this rank's span
        of them where the slots are split over data ranks, whose sampled
        tokens are then gathered, so that every rank's host books the whole
        batch's tokens."""
        eng = self.engine
        sched = self.sched
        span = self._span
        if span is not None:
            t_step = time.monotonic()
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
        if span is not None:
            t_enqueued = time.monotonic()
        _sync(eng.device)                      # t1 is when the device is done
        t1 = time.monotonic()
        eng.pool.blocks = blocks
        eng.n_decode_steps += 1
        self.step_seconds.append(t1 - t0)
        t_published = t1
        if self.meter is not None:
            self.meter.step(t0, t1, sched.n_active, eng.n_slots)
            if span is not None:
                t_published = time.monotonic()
        active = list(sched.active.items())
        split = eng.split
        if not eng._fused_sample:
            # a slot still replaying its prompt suffix discards this step's
            # token, so it draws nothing; a rank draws its own slots' rows
            out = eng._select_step(out, [(slot - split.lo, req) for slot, req in active
                                         if slot not in eng._forced and split.owns(slot)])
        tokens = split.gather(out).cpu().numpy()   # the step's one copy to the host
        tnow = self.now()
        for slot, req in active:
            eng._lengths[slot] += 1
            forced = eng._forced.get(slot)
            if forced:
                # prompt-suffix replay after a prefix join: exact K/V was
                # just written for the fed token, next one goes in verbatim
                eng._tokens[slot] = forced.popleft()
                if not forced:
                    del eng._forced[slot]
                continue
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
        if span is not None:
            t_end = time.monotonic()
            t_host = self.t_start + tnow
            n = len(active)
            span("step", t_step, t_end, None, n)
            span("prepare", t_step, t0, None, n)
            span("dispatch", t0, t_enqueued, None, n)
            span("device_wait", t_enqueued, t1, None, n)
            if self.meter is not None:
                span("publish", t1, t_published, None, n)
            span("sample", t_published, t_host, None, n)
            span("bookkeep", t_host, t_end, None, n)
