"""Block-paged KV cache pool for continuous-batching serving.

Ported from ``repro.serve.kvcache``:

* :class:`PagedKVPool` — the host-side free list, admission reservations
  and refcounts are copied verbatim; the device blocks are torch tensors,
  one dict per layer: for an attention layer
  ``{"k_pages", "v_pages"[, "k_scale_pages", "v_scale_pages"]}``
  (``(n_pages, page, Hkv, D)``, int8 with fp32 scale pages under
  ``cfg.kv_quant``); for an RG-LRU or SSM layer the per-slot recurrent
  state ``{"conv": (n_slots, K-1, C), "h": (n_slots, W)}`` (SSM: ``h`` is
  ``(n_slots, H, P, N)``), which is O(1) per request and not paged.  An
  attention-free arch (mamba2) has no page arrays at all; the accounting
  is the same.  Page id 0 is the scratch page: idle decode
  slots write into it and nothing live reads it.
* :func:`paged_attention_decode` — single-token decode attention over the
  pool, with the sliding window of ``attention="local"``/``"swa"``
  applied at read.  ``kernel="plain"`` runs the reference's XLA branch in
  PyTorch; ``kernel="cuda"`` is the counterpart of ``"pallas"`` and goes
  through the kernel wrapper of :mod:`repro_torch.kernels.paged_attention`.
  Both quantise (or round to the page dtype) the new K/V rows first, so the
  stored pages are bit-identical, and both update the pages **in place**.
* :func:`share_new_rows` — where an engine's slots are split over data
  ranks (:func:`repro_torch.dist.sharding.slot_split`), each rank's decode
  step writes its own slots' new rows; once a step every rank's rows of
  every attention layer are gathered, in one collective, and written into
  each rank's pages in slot order, every layer in one launch
  (:func:`repro_torch.kernels.paged_attention.paged_scatter_step`), so
  that every rank's replicated pages stay those of one engine over the
  whole batch: a page one rank's slot writes may later be read by another
  rank's (the prefix cache shares pages across slots).
* :func:`make_clone_pages` — the prefix cache's copy-on-write page clone:
  one page copied onto another in every attention layer's page leaves, in
  place on the pool's device (the reference clones with XLA's
  ``.at[dst].set(leaf[src])``; it has no Pallas kernel for it).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.device import is_dtensor, resolve_device, resolve_kernel
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import layers as L
from repro_torch.models.transformer import check_supported, init_recurrent_state

Params = Dict[str, Any]

SCRATCH_PAGE = 0          # page id reserved for idle slots; never read


def rope_at(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Per-request RoPE for single-token decode.  x: (B,1,H,D); pos: (B,)."""
    freqs = L.rope_frequencies(x.shape[-1], theta, x.device)   # (D/2,)
    angles = pos[:, None].float() * freqs                       # (B, D/2)
    return L._rotate(x, torch.cos(angles)[:, None, None, :],
                     torch.sin(angles)[:, None, None, :])


# --------------------------------------------------------------------------
# device-side pool construction (mirrors transformer.init_cache structure)
# --------------------------------------------------------------------------

def _attn_page_block(cfg, num_pages: int, page: int, dtype, device) -> Params:
    shape = (num_pages, page, cfg.n_kv_heads, cfg.head_dim)
    kv_dtype = torch.int8 if cfg.kv_quant else dtype
    block = {
        "k_pages": torch.zeros(shape, dtype=kv_dtype, device=device),
        "v_pages": torch.zeros(shape, dtype=kv_dtype, device=device),
    }
    if cfg.kv_quant:
        block["k_scale_pages"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
        block["v_scale_pages"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
    return block


def init_pool_blocks(cfg, num_pages: int, page: int, n_slots: int, device) -> Params:
    """``{"layers": [...]}``: a page block per attention layer (pages in the
    compute dtype), the per-slot recurrent state per RG-LRU or SSM layer,
    ``n_slots`` rows of it (a data rank's span where the slots are split
    over data ranks: its own slots' rows alone)."""
    check_supported(cfg)
    dtype = L.dtype_of(cfg.compute_dtype)
    return {"layers": [
        _attn_page_block(cfg, num_pages, page, dtype, device) if kind == "attn"
        else init_recurrent_state(cfg, kind, n_slots, dtype, device)
        for kind in cfg.layer_kinds()]}


# --------------------------------------------------------------------------
# paged decode attention
# --------------------------------------------------------------------------

def write_slots(pos: torch.Tensor, table: torch.Tensor, page: int):
    """(page_idx, off), (B,) int32 each: where each slot's row at ``pos``
    lands, its table's page for ``pos`` (the last column past the table's
    width) and the offset in it."""
    rows = torch.arange(table.shape[0], device=table.device)
    page_idx = table[rows, torch.clamp(pos // page, max=table.shape[1] - 1).long()]
    return page_idx, pos % page


def paged_attention_decode(cfg, p, x, pos, table, block, kernel: Optional[str] = None,
                           new_rows: Optional[list] = None):
    """Single-token attention over paged KV.

    x: (B,1,d); pos: (B,) int32 write positions; table: (B, M) int32 page
    table (0 = scratch); block: one layer's page block, updated in place.
    ``kernel`` None follows x's device.  ``new_rows``, where given, gets
    the rows this call wrote, as the step held them: ``(k, v)`` (B, Hkv,
    D) in the page dtype, with their (B, Hkv) fp32 scales for int8 pages,
    this rank's heads of them on a sharded pool.  Returns (out (B,1,d),
    block).
    """
    kernel = resolve_kernel(kernel, x.device)
    b = x.shape[0]
    page = block["k_pages"].shape[1]
    q, k, v = L._project_qkv(cfg, p, x)                        # (B,1,H*,D)
    q = rope_at(q, pos, cfg.rope_theta)
    k = rope_at(k, pos, cfg.rope_theta)

    page_idx, off = write_slots(pos, table, page)
    hd = cfg.head_dim
    new = {}
    if cfg.kv_quant:
        kq, k_sc = L._kv_quantize(k)                           # (B,1,H,D),(B,1,H)
        vq, v_sc = L._kv_quantize(v)
        k, v = kq, vq
        new = dict(k_scale_new=k_sc[:, 0].contiguous(), v_scale_new=v_sc[:, 0].contiguous(),
                   k_scale_pages=block["k_scale_pages"],
                   v_scale_pages=block["v_scale_pages"])
    # the rows are stored in the page dtype (fp32 K/V round to nearest even
    # into bf16 pages, as the reference's ``.at[].set()`` casts them)
    pool_dtype = block["k_pages"].dtype
    k_new = k[:, 0].to(pool_dtype).contiguous()
    v_new = v[:, 0].to(pool_dtype).contiguous()
    q1 = q[:, 0].contiguous()                                  # (B,Hq,D)
    window = L._window(cfg)
    if kernel == "cuda":
        step = functools.partial(PA.paged_attention_scatter, window=window)
    else:
        step = functools.partial(PA.paged_attention_scatter_plain, window=window,
                                 dequant_dtype=x.dtype)

    def attend(q1, *rest):
        # (B,Hq,D) -> (B,Hkv,G,D) on the heads this call holds (the new K
        # row's); the int8 pages' scales (None without them) by name
        if new_rows is not None:
            new_rows.append(tuple(t for t in rest[:2] + rest[8:10] if t is not None))
        return step(q1.reshape(q1.shape[0], rest[0].shape[1], -1, hd), *rest[:8],
                    **dict(zip(_QUANT_ARGS, rest[8:])))

    args = (q1, k_new, v_new, block["k_pages"], block["v_pages"], table, pos, page_idx, off,
            *(new.get(name) for name in _QUANT_ARGS))
    out = _attend_on_shards(attend, args) if is_dtensor(block["k_pages"]) else attend(*args)
    out = out.to(x.dtype).reshape(b, 1, cfg.n_heads * hd)
    return L.matmul(out, p["wo"]), block


_QUANT_ARGS = ("k_scale_new", "v_scale_new", "k_scale_pages", "v_scale_pages")


def _attend_on_shards(attend, args):
    """The paged step on each rank's local KV heads: the pool's ``'model'``
    split of its head dim (``page_pool_shardings``: only where the degree
    divides Hkv) is the split of q's and the new rows' head dim.  A pool of
    one KV head is whole on every rank, and each rank attends with its own
    query heads (a split of the one group) where the degree divides Hq, and
    writes the same new row into its copy.  Otherwise every rank attends
    over all heads.  The pools keep their placements, so the step writes
    their local storage in place; the table and positions are plain
    tensors, the same on every rank.  q is (B,Hq,D), split on whole GQA
    groups where the pool is split."""
    from repro_torch.dist.sharding import local_placements, model_size, on_shards

    q, pages = args[0], args[3]
    split = any(name == "model" and p.is_shard()
                for name, p in zip(pages.device_mesh.mesh_dim_names, pages.placements))
    mp = model_size(q.device_mesh)
    split_q = split or (pages.shape[2] == 1 and mp > 1 and q.shape[1] % mp == 0)
    rows = [local_placements(a, model_dim=1 if split else None)
            for a in args[1:3] + args[9:11]]            # the new rows, their scales
    pq = local_placements(q, model_dim=1 if split_q else None)
    pools = [getattr(a, "placements", None) for a in args[3:5] + args[11:]]
    in_pl = tuple([pq] + rows[:2] + pools[:2] + [None] * 4 + rows[2:] + pools[2:])
    return on_shards(attend, args, in_pl, pq)


PAGE_LEAVES = ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages")


def pack_new_rows(new_rows: List[tuple]) -> torch.Tensor:
    """One rank's new rows of every attention layer (``new_rows`` as
    :func:`share_new_rows` takes them) as one (b, W) uint8 buffer, a row
    holding each layer's K, V (and scale) rows in turn as bytes: the layout
    :func:`repro_torch.kernels.paged_attention.paged_scatter_step` reads."""
    return torch.cat([t.reshape(t.shape[0], -1).contiguous().view(torch.uint8)
                      for rows in new_rows for t in rows], dim=1)


def share_new_rows(cfg, blocks, new_rows: List[tuple], pos: torch.Tensor,
                   table: torch.Tensor, split) -> Params:
    """Every data rank's new rows of one decode step into this rank's pages.

    ``new_rows`` holds, for each attention layer in order, the rows this
    rank's step wrote for its own slots (:func:`paged_attention_decode`'s
    ``new_rows``); ``pos`` (B,) and ``table`` (B, M) are the whole batch's,
    as the step had them.  All layers' rows go in one all-gather over the
    data group (``split``, a :class:`~repro_torch.dist.sharding.SlotSplit`),
    as bytes, and every layer's whole batch of rows is written in slot
    order straight from the gathered bytes, by one launch of
    :func:`repro_torch.kernels.paged_attention.paged_scatter_step` on the
    card (the last row aimed at a place wins, as in one engine's step over
    the whole batch; a rank's own rows land again with the same bits).  On
    a sharded pool the rows are this rank's heads, and so are the pages
    written: the data group's ranks share the model coordinate.  Nothing
    happens where the batch is not split."""
    if not split.split or not new_rows:
        return blocks
    whole = split.gather(pack_new_rows(new_rows))
    attn = [pb for kind, pb in zip(cfg.layer_kinds(), blocks["layers"]) if kind == "attn"]
    page_idx, off = write_slots(pos, table, attn[0]["k_pages"].shape[1])
    PA.paged_scatter_step(whole, [[_local(block[name]) for name in PAGE_LEAVES if name in block]
                                  for block in attn], page_idx, off)
    return blocks


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (its storage: the caller writes it in place);
    a plain tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def make_clone_pages(cfg) -> Callable:
    """clone(blocks, src, dst) -> blocks with page ``dst`` a copy of page
    ``src`` in every attention leaf, written in place.

    The copy-on-write primitive for prefix sharing: a joiner extending a
    *partially filled* cached page writes into fresh storage while every
    other referent keeps reading the original.  Recurrent-state blocks are
    per-slot, not paged, so only attention leaves participate (the prefix
    cache is gated to attention-only archs anyway).  The copies are queued
    on the pool's stream ahead of any later write to ``dst``.
    """
    kinds = cfg.layer_kinds()

    def clone(blocks, src: int, dst: int):
        for kind, block in zip(kinds, blocks["layers"]):
            if kind == "attn":
                for name in PAGE_LEAVES:
                    if name in block:
                        block[name][dst].copy_(block[name][src])
        return blocks

    return clone


def scatter_prefill_attn(block, cache_block, page_ids: torch.Tensor) -> Params:
    """Scatter a batch-1 contiguous prefill cache (``n_used * page``
    positions) into the pool pages ``page_ids`` (n_used,), in place."""
    page = block["k_pages"].shape[1]
    n_used = page_ids.shape[0]
    pairs = [("k", "k_pages"), ("v", "v_pages")]
    if "k_scale_pages" in block:
        pairs += [("k_scale", "k_scale_pages"), ("v_scale", "v_scale_pages")]
    ids = page_ids.long()
    for name, pname in pairs:
        leaf = cache_block[name][0]                            # (Lpad, ...)
        chunks = leaf.reshape(n_used, page, *leaf.shape[1:]).to(block[pname].dtype)
        if is_dtensor(block[pname]):
            # each rank writes its own heads' rows into its own shard of the
            # pages (the chunks take the pool's placements first)
            from repro_torch.dist.sharding import write_on_shards

            pool = block[pname]
            write_on_shards(_put_pages, (pool, ids, chunks), (pool.placements, None,
                                                              pool.placements))
        else:
            _put_pages(block[pname], ids, chunks)
    return block


def _put_pages(pages: torch.Tensor, ids: torch.Tensor, chunks: torch.Tensor) -> None:
    pages[ids] = chunks


# --------------------------------------------------------------------------
# host-side pool accounting (copied from the reference)
# --------------------------------------------------------------------------

class PagedKVPool:
    """Fixed-size page pool: refcounted free-list + admission reservations.

    ``reserve`` is the admission-control primitive: it books a request's
    *worst-case* page need against the pool; ``alloc`` then hands out
    physical pages lazily (prefill pages at join, one page per crossed
    boundary during decode).  Because allocations never exceed the sum of
    reservations, lazy growth can never fail after admission succeeded.
    ``release`` drops one reference per attached page on completion
    (evict-on-EOS); a page returns to the free list only when its last
    referent lets go.

    :meth:`share`, :meth:`retain` and :meth:`unretain` are the reference
    paths a prefix cache adds; the optional ``on_pressure`` hook is asked
    to surrender resident pages before admission fails.

    ``materialize=False`` skips building the device tensors; otherwise
    they go to ``device`` (``cuda`` unless the caller names another).
    ``state_rows`` is how many slots' recurrent state the device blocks
    hold (a data rank's span of the ``n_slots``; None: all of them).
    """

    def __init__(self, cfg, n_slots: int, max_len: int, page: int = 16,
                 num_pages: Optional[int] = None, materialize: bool = True,
                 device=None, state_rows: Optional[int] = None):
        if max_len % page:
            raise ValueError(f"max_len {max_len} must be a multiple of page {page}")
        self.cfg = cfg
        self.page = page
        self.n_slots = n_slots
        self.max_len = max_len
        self.max_pages_per_req = max_len // page
        # +1 for the scratch page idle slots write into
        self.num_pages = num_pages or n_slots * self.max_pages_per_req + 1
        if self.num_pages < 2:
            raise ValueError("pool needs at least one non-scratch page")
        self._free: List[int] = list(range(self.num_pages - 1, SCRATCH_PAGE, -1))
        self._reserved: Dict[Any, int] = {}    # rid -> pages still reservable
        self._allocated: Dict[Any, List[int]] = {}
        self._ref: Dict[int, int] = {}         # page id -> reference count
        # asked to free >= n resident pages; returns how many it freed
        self.on_pressure: Optional[Any] = None
        self.blocks = (
            init_pool_blocks(cfg, self.num_pages, page,
                             n_slots if state_rows is None else state_rows,
                             resolve_device(device))
            if materialize else None
        )

    # ---- accounting ------------------------------------------------------
    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page)

    @property
    def capacity_pages(self) -> int:
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        """Pages available to NEW reservations (free minus outstanding IOUs)."""
        outstanding = sum(self._reserved.values())
        return len(self._free) - outstanding

    @property
    def utilization(self) -> float:
        in_use = self.capacity_pages - len(self._free)
        return in_use / max(self.capacity_pages, 1)

    def refcount(self, page_id: int) -> int:
        return self._ref.get(page_id, 0)

    def can_admit(self, n_tokens: int) -> bool:
        return self.pages_needed(n_tokens) <= self.free_pages

    def reserve(self, rid, n_tokens: int) -> bool:
        return self.reserve_pages(rid, self.pages_needed(n_tokens))

    def reserve_pages(self, rid, need: int) -> bool:
        """Book ``need`` physical pages for ``rid``.  Under pressure the
        resident-prefix evictor is asked to free pages before giving up."""
        if need > self.capacity_pages:
            raise ValueError(
                f"request {rid!r} needs {need} pages, pool holds {self.capacity_pages}"
            )
        if need > self.free_pages and self.on_pressure is not None:
            self.on_pressure(need - self.free_pages)
        if need > self.free_pages:
            return False
        self._reserved[rid] = need
        self._allocated[rid] = []
        return True

    def alloc(self, rid, n: int = 1) -> List[int]:
        if self._reserved.get(rid, 0) < n:
            raise RuntimeError(f"request {rid!r} exceeded its page reservation")
        ids = [self._free.pop() for _ in range(n)]
        self._reserved[rid] -= n
        self._allocated[rid].extend(ids)
        for pid in ids:
            self._ref[pid] = 1
        return ids

    def share(self, rid, page_ids: List[int]) -> None:
        """Attach already-allocated pages to ``rid`` (prefix reuse): one
        reference each, released with the rest of ``rid``'s pages."""
        if rid not in self._allocated:
            raise RuntimeError(f"request {rid!r} has no reservation to share into")
        for pid in page_ids:
            if self._ref.get(pid, 0) <= 0:
                raise RuntimeError(f"page {pid} is not live; cannot share")
            self._ref[pid] += 1
        self._allocated[rid].extend(page_ids)

    def retain(self, page_ids: List[int]) -> None:
        """Anonymous reference (prefix-cache residency): keeps pages out of
        the free list after their writer releases."""
        for pid in page_ids:
            if self._ref.get(pid, 0) <= 0:
                raise RuntimeError(f"page {pid} is not live; cannot retain")
            self._ref[pid] += 1

    def unretain(self, page_ids: List[int]) -> None:
        for pid in page_ids:
            self._drop_ref(pid)

    def _drop_ref(self, pid: int) -> None:
        n = self._ref.get(pid, 0)
        if n <= 0:
            raise RuntimeError(f"double free of page {pid}")
        if n == 1:
            del self._ref[pid]
            self._free.append(pid)
        else:
            self._ref[pid] = n - 1

    def release(self, rid) -> None:
        for pid in reversed(self._allocated.pop(rid, [])):
            self._drop_ref(pid)
        self._reserved.pop(rid, None)
