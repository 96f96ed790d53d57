"""Top-k mixture-of-experts FFN with capacity-based scatter/gather dispatch,
ported from ``repro.models.moe``.

GShard-style semantics (top-k routing, capacity factor, load-balance aux
loss) with scatter/gather instead of one-hot einsums, so the dispatch
buffer stays ``(E, C, d)``.  Token routing skew is the "rank imbalance"
the paper's slack mechanism exploits (DESIGN.md §4).

The semantics are the reference's, step for step: router logits in fp32,
softmax, top-k, the gates renormalised with a 1e-9 floor; each assignment's
position in its expert is a running count over the ``T·k`` assignments in
token-major order; assignments at or past the capacity go to a trash row
``E`` of the buffer and are discarded; SwiGLU experts over the buffer; the
combine weighted by the kept gates.  Everything is index arithmetic on the
device: no boolean indexing and no ``nonzero``, which would sync the host.
Every kept ``(expert, position)`` has exactly one writer, so the scatter's
order does not matter.  On a sharded model the routing, the scatter and the
combine run on local tensors (DTensor has no rule for the scatter), and
the expert products on the experts' split weights (:func:`moe_forward`).
Where the tokens are split over the data ranks, each rank routes its own
and sends its kept rows, at the slots the whole batch's running count
gives them, to the ranks that own those slots: an all-to-all each way, no
rank holding more than its own slots of the buffer.  Its split sizes are
read on the host, the one sync of this module (:func:`plan_exchange`).

The expert products are plain batched matrix products, which the
reference also leaves to XLA outside any Pallas kernel; dtypes promote as
JAX promotes them (``layers.matmul``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.device import is_dtensor
from repro_torch.dist import sharding as SH
from repro_torch.models.layers import matmul

Params = Dict[str, Any]


def init_moe(cfg, gen: torch.Generator, dtype, device) -> Params:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(f)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    return {
        "router": (normal(d, e) * s_in).to(torch.float32),
        "w1": (normal(e, d, f) * s_in).to(dtype),
        "w3": (normal(e, d, f) * s_in).to(dtype),
        "w2": (normal(e, f, d) * s_out).to(dtype),
    }


def capacity(cfg, n_tokens: int) -> int:
    c = int(math.ceil(cfg.top_k * n_tokens / cfg.n_experts * cfg.capacity_factor))
    return max(c, cfg.top_k)


def route(cfg, p: Params, xf: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xf: (T, d) -> (probs (T, E) fp32, renormalised gates (T, k), expert
    ids (T, k)), the ids in ``jax.lax.top_k``'s order (largest first)."""
    logits = matmul(xf.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gate_vals, gate_idx


def positions(gate_idx: torch.Tensor, n_experts: int, cap: int,
              base: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each assignment's position in its expert, a running count over the
    flattened (T·k,) assignments, and whether it fits under ``cap``.
    ``base`` (E,) starts each expert's count there: the assignments that
    come before these ones in the whole batch."""
    flat_e = gate_idx.reshape(-1)
    pos_all = torch.cumsum(F.one_hot(flat_e, n_experts), dim=0) - 1   # (T·k, E)
    my_pos = torch.gather(pos_all, 1, flat_e[:, None])[:, 0]
    if base is not None:
        my_pos = my_pos + base[flat_e]
    return my_pos, my_pos < cap


def scatter(cfg, xf: torch.Tensor, gate_vals: torch.Tensor, gate_idx: torch.Tensor, cap: int,
            base: Optional[torch.Tensor] = None):
    """The routed (T, d) tokens into the expert buffer -> (buf (E, C, d),
    each assignment's expert (T·k,) and slot in it (T·k,), its combine
    weight (T·k,)).  A dropped assignment's slot is 0 of expert 0 with
    weight 0; ``base`` as :func:`positions` takes it."""
    e, k = cfg.n_experts, cfg.top_k
    t, d = xf.shape
    flat_e = gate_idx.reshape(-1)
    my_pos, keep = positions(gate_idx, e, cap, base)
    # dropped assignments go to a trash expert row e (the scatter stays static)
    dest_c = torch.where(keep, my_pos, 0)
    tok_of = torch.arange(t * k, device=xf.device) // k
    buf = torch.zeros((e + 1, cap, d), dtype=xf.dtype, device=xf.device)
    buf.index_put_((torch.where(keep, flat_e, e), dest_c), xf[tok_of], accumulate=True)
    w = (gate_vals.reshape(-1) * keep.float()).to(xf.dtype)
    return buf[:e], torch.where(keep, flat_e, 0), dest_c, w


def dispatch(cfg, router: torch.Tensor, xf: torch.Tensor, cap: int):
    """Route the (T, d) tokens and scatter them into the expert buffer ->
    (:func:`scatter`'s four, the aux load-balance loss)."""
    e = cfg.n_experts
    probs, gate_vals, gate_idx = route(cfg, {"router": router}, xf)

    # load-balance auxiliary loss (Switch/GShard)
    me = probs.mean(dim=0)                                          # (E,)
    ce = F.one_hot(gate_idx, e).float().sum(dim=1).mean(dim=0)
    aux = e * torch.sum(me * ce) * cfg.router_aux_coef
    return (*scatter(cfg, xf, gate_vals, gate_idx, cap), aux)


# --------------------------------------------------------------------------
# tokens split over the data ranks: each rank's part of the dispatch
# --------------------------------------------------------------------------

def _route_own(cfg, router: torch.Tensor, xf: torch.Tensor):
    """One rank's (T/D, d) tokens routed -> (its sum of the router
    probabilities (E,), its assignments' count in each expert (1, E), the
    gates and ids (T/D, k))."""
    probs, gate_vals, gate_idx = route(cfg, {"router": router}, xf)
    flat_e = gate_idx.reshape(-1)
    counts = torch.zeros(cfg.n_experts, dtype=flat_e.dtype, device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    return probs.sum(dim=0), counts[None], gate_vals, gate_idx


def _first_slots(counts: torch.Tensor):
    """Every rank's counts (D, E), in the order of its tokens in the batch
    -> (where each rank's assignments start in each expert: the exclusive
    scan of the counts (D, E); the whole batch's counts (E,))."""
    return torch.cumsum(counts, dim=0) - counts, counts.sum(dim=0)


class Exchange(NamedTuple):
    """One rank's half of the all-to-all that carries a data-split batch's
    kept assignments to the ranks that own their slots (:func:`plan_exchange`)."""
    send_splits: List[int]     # rows this rank sends to each rank of the group
    recv_splits: List[int]     # rows it receives from each
    send_idx: torch.Tensor     # (n·k,) each assignment's row of the send buffer
                               # (the buffer's length for a dropped one)
    assign_of_row: torch.Tensor  # (rows sent,) the assignment each sent row carries
    recv_expert: torch.Tensor  # (rows received,) each one's expert
    recv_slot: torch.Tensor    # ... and its slot among this rank's C_g
    slots: int                 # C_g, this rank's slots of every expert


def slot_spans(cap: int, sizes: Sequence[int]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Where each rank of a token group's slots start, and how many of each
    expert's ``cap`` slots it owns: ``Shard(1)`` over the group's mesh dims
    of ``sizes``, as DTensor lays it out.  Each mesh dim in turn cuts what
    the dims before it left into ``torch.chunk``'s pieces (``ceil(n/D)``
    each, the last ones smaller or empty); the ranks in the row-major order
    of their coordinates, which is their order in the flattened group."""
    spans = [(0, cap)]
    for g in sizes:
        cut = []
        for start, n in spans:
            step = -(-n // g)
            cut += [(start + min(i * step, n), max(0, min(step, n - i * step)))
                    for i in range(g)]
        spans = cut
    return tuple(s for s, _ in spans), tuple(n for _, n in spans)


def _exchange_runs(counts: torch.Tensor, cap: int, starts: Sequence[int],
                  sizes: Sequence[int]) -> torch.Tensor:
    """Every rank's assignment counts (D, E), in the order of its tokens in
    the batch -> the rows of rank r's assignments to expert e that land in
    rank q's slots (D, E, D).  Rank r's kept rows of expert e hold the
    slots ``[first, min(first + count, cap))`` (the running count is
    token-major over the batch), one run that each owner's span cuts."""
    first, _ = _first_slots(counts)
    lo = first[:, :, None]
    hi = torch.clamp(first + counts, max=cap)[:, :, None]
    start = torch.tensor(starts, dtype=counts.dtype, device=counts.device)
    end = start + torch.tensor(sizes, dtype=counts.dtype, device=counts.device)
    return (torch.minimum(hi, end) - torch.maximum(lo, start)).clamp(min=0)


def even_counts(n_ranks: int, n_experts: int, n_assign: int) -> torch.Tensor:
    """The counts (D, E) of routing that spreads each rank's ``n_assign``
    assignments evenly over the experts: what :func:`plan_exchange` takes
    for its split sizes on ``meta``, where the counts hold no values."""
    c = torch.full((n_ranks, n_experts), n_assign // n_experts, dtype=torch.long)
    c[:, :n_assign % n_experts] += 1
    return c


def plan_exchange(counts: torch.Tensor, gate_idx: torch.Tensor, rank: int, cap: int,
                  starts: Sequence[int], sizes: Sequence[int]
                  ) -> Tuple[Exchange, torch.Tensor]:
    """Rank ``rank``'s :class:`Exchange` from every rank's counts (D, E) and
    its own expert ids (n, k), and which of its assignments fit under
    ``cap``.  The send buffer holds the kept rows by owner, then expert,
    then slot; a rank receives, from each rank in turn, each expert's run
    of rows in slot order, so the receiver places them from the counts
    alone.  The split sizes are read on the host: one sync, here."""
    e = counts.shape[1]
    runs = _exchange_runs(counts, cap, starts, sizes)             # (D, E, D)
    host = even_counts(*counts.shape, gate_idx.numel()) if counts.is_meta else counts.cpu()
    splits = _exchange_runs(host, cap, starts, sizes).sum(dim=1)  # (D, D)
    send_splits, recv_splits = splits[rank].tolist(), splits[:, rank].tolist()
    n_send, n_recv = sum(send_splits), sum(recv_splits)
    dev = gate_idx.device
    first = _first_slots(counts)[0]
    start = torch.tensor(starts, dtype=first.dtype, device=dev)

    # send: each kept assignment's row, from its owner's chunk, its expert's
    # run in that chunk and its place in the run
    flat_e = gate_idx.reshape(-1)
    pos, keep = positions(gate_idx, e, cap, base=first[rank])
    ends = start + torch.tensor(sizes, dtype=first.dtype, device=dev)
    owner = torch.searchsorted(ends, pos, right=True).clamp(max=len(sizes) - 1)
    mine = runs[rank]                                             # (E, D)
    chunk = torch.cumsum(mine.sum(dim=0), 0) - mine.sum(dim=0)    # (D,)
    run_at = torch.cumsum(mine, 0) - mine                         # (E, D)
    row = (chunk[owner] + run_at[flat_e, owner] + pos
           - torch.maximum(first[rank][flat_e], start[owner]))
    send_idx = torch.where(keep, row, n_send)
    assign_of_row = torch.zeros(n_send + 1, dtype=send_idx.dtype, device=dev).index_copy(
        0, send_idx, torch.arange(flat_e.numel(), device=dev))[:n_send]

    # receive: rank r's run of expert e starts at its first slot past this
    # rank's start
    c_g = sizes[rank]
    lens = runs[:, :, rank].reshape(-1)                           # (D·E,)
    lo = (torch.maximum(first, start[rank]) - start[rank]).reshape(-1)
    run_of = torch.repeat_interleave(torch.arange(lens.numel(), device=dev), lens,
                                     output_size=n_recv)
    within = torch.arange(n_recv, device=dev) - (torch.cumsum(lens, 0) - lens)[run_of]
    return Exchange(send_splits, recv_splits, send_idx, assign_of_row, run_of % e,
                    lo[run_of] + within, c_g), keep


def send_rows(xf: torch.Tensor, ex: Exchange, n_experts: int, k: int,
              group) -> torch.Tensor:
    """A rank's (n, d) tokens -> its slots of the expert buffer (E, C_g, d):
    the kept rows sent to their owners in one all-to-all, each received row
    written at its slot, every other slot zero.  The rows are the tokens'
    k copies in assignment order (:func:`scatter`'s), so that the backward
    sums each token's k gradients in the order the reference does."""
    from torch.distributed._functional_collectives import all_to_all_single_autograd

    tok_of = torch.arange(xf.shape[0] * k, device=xf.device) // k
    recv = all_to_all_single_autograd(xf[tok_of][ex.assign_of_row], ex.recv_splits,
                                      ex.send_splits, group)
    buf = torch.zeros(n_experts, ex.slots, xf.shape[-1], dtype=xf.dtype, device=xf.device)
    return buf.index_put((ex.recv_expert, ex.recv_slot), recv)


def return_rows(out_buf: torch.Tensor, ex: Exchange, w: torch.Tensor, k: int,
                group) -> torch.Tensor:
    """The inverse all-to-all of :func:`send_rows`: each expert output row
    of this rank's slots (E, C_g, d) back to its token's rank, and the
    rank's k rows a token summed by their weights ``w`` (n·k,) -> (n, d)."""
    from torch.distributed._functional_collectives import all_to_all_single_autograd

    rows = out_buf[ex.recv_expert, ex.recv_slot]
    back = all_to_all_single_autograd(rows, ex.send_splits, ex.recv_splits, group)
    back = F.pad(back, (0, 0, 0, 1))                  # a dropped assignment's zero row
    return (back[ex.send_idx] * w[:, None]).reshape(-1, k, out_buf.shape[-1]).sum(dim=1)


def _group_of(mesh, dims: Tuple[int, ...]):
    """The process group over the mesh dims ``dims`` (one flattened group,
    its ranks in the row-major order of their coordinates)."""
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    return mesh[tuple(mesh.mesh_dim_names[i] for i in dims)]._flatten().get_group()


def _split_moe(cfg, p: Params, xf, cap: int, group: Tuple[int, ...]):
    """:func:`moe_forward`'s layer on a DTensor ``xf`` (T, d) whose tokens
    are split over the mesh dims ``group``, no rank holding more than its
    own T/D rows or its C/D slots of each expert -> (out (T, d) split as
    ``xf``, aux).

    Each rank routes its tokens, and one all-gather brings every rank's
    (E,) counts.  The running count runs token-major over the batch, whose
    dim 0 DTensor splits in the group's rank order, so the ranks below this
    one hold exactly the assignments that come before its own: the
    exclusive scan of the counts gives each kept row its slot in the whole
    batch's buffer.  One all-to-all sends each kept row to the rank that
    owns its slot under ``Shard(1)`` (the layout a reduce-scatter of the
    whole buffer would give); the experts run on those slots; the inverse
    all-to-all brings each output row back to its token's rank for the
    combine.  Autograd runs the two exchanges in reverse."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = xf.device_mesh
    (t, d), e = xf.shape, cfg.n_experts
    tok = SH.local_placements(xf, keep=(0,))
    rep = (Replicate(),) * mesh.ndim
    part = tuple(Partial() if i in group else Replicate() for i in range(mesh.ndim))
    probs_sum, counts, gate_vals, gate_idx = SH.on_shards(
        functools.partial(_route_own, cfg), (p["router"], xf), (rep, tok),
        (part, tok, tok, tok), grad_placements=(part, tok))
    counts, first, total = SH.on_shards(lambda c: (c, *_first_slots(c)), (counts,), (rep,),
                                        (rep, rep, rep))
    # load-balance auxiliary loss over the whole batch
    aux = (e * torch.sum(probs_sum / t * (total.float() / t))
           * cfg.router_aux_coef).redistribute(mesh, rep)

    pg = _group_of(mesh, group)
    starts, sizes = slot_spans(cap, [mesh.size(i) for i in group])
    gates, idx = gate_vals.to_local(), gate_idx.to_local()
    ex, keep = plan_exchange(counts.to_local(), idx, dist.get_rank(pg), cap, starts, sizes)
    slots = tuple(Shard(1) if i in group else Replicate() for i in range(mesh.ndim))
    buf = DTensor.from_local(send_rows(xf.redistribute(mesh, tok).to_local(), ex, e,
                                       cfg.top_k, pg),
                             mesh, slots, run_check=False, shape=(e, cap, d),
                             stride=(cap * d, d, 1))

    # the experts on this rank's slots, each expert weight whole over the
    # token group (FSDP's gather; its gradient comes back reduce-scattered),
    # so that DTensor moves no slot of the buffer
    out_buf = experts({n: p[n].redistribute(mesh, tuple(
        Replicate() if i in group else pl for i, pl in enumerate(p[n].placements)))
        for n in ("w1", "w3", "w2")}, buf)

    w = (gates.reshape(-1) * keep.float()).to(xf.dtype)
    out = return_rows(out_buf.redistribute(mesh, slots).to_local(), ex, w, cfg.top_k, pg)
    return DTensor.from_local(out, mesh, tok, run_check=False, shape=(t, d),
                              stride=(d, 1)), aux


def _split_rows_moe(cfg, p: Params, xf, cap: int, split):
    """:func:`moe_forward`'s layer on this data rank's own (T/D, d) rows of
    a batch whose rows are split over the data group of ``split`` (a
    :class:`~repro_torch.dist.sharding.SlotSplit`) as plain local rows, not
    as a DTensor: a serving engine's split batch -> (out (T/D, d), aux).
    The exchange of :func:`_split_moe` on the data group: each rank routes
    its rows, one gather of every rank's (E,) counts (and router
    probabilities, for the aux loss) gives its assignments' slots in the
    whole batch's running count at the whole batch's capacity ``cap``, one
    all-to-all sends its kept rows to the ranks that own their slots, the
    experts run on the rank's slots (weights whole over the model axis
    where they are split), and the inverse all-to-all brings its rows
    back.  Inference only: the collectives are not differentiated."""
    from torch.distributed.tensor import DTensor, Replicate

    e, k = cfg.n_experts, cfg.top_k
    xl = SH.whole(xf)
    probs_sum, counts, gate_vals, gate_idx = _route_own(cfg, SH.whole(p["router"]), xl)
    counts = split.gather(counts)                                  # (D, E)
    t = xl.shape[0] * split.size
    aux = (e * torch.sum(split.gather(probs_sum[None]).sum(dim=0) / t
                         * (counts.sum(dim=0).float() / t)) * cfg.router_aux_coef)
    starts, sizes = slot_spans(cap, [split.size])
    ex, keep = plan_exchange(counts, gate_idx, split.index, cap, starts, sizes)
    out_buf = SH.whole(experts(p, send_rows(xl, ex, e, k, split.group)))
    w = (gate_vals.reshape(-1) * keep.float()).to(xl.dtype)
    out = return_rows(out_buf, ex, w, k, split.group)
    if is_dtensor(xf):
        mesh = xf.device_mesh
        out = DTensor.from_local(out, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    return out, aux


def _token_group(xf) -> Tuple[int, ...]:
    """The mesh dims of more than one rank that split a DTensor's tokens
    (dim 0); none for a plain tensor."""
    if not is_dtensor(xf):
        return ()
    sizes = xf.device_mesh.shape
    return tuple(i for i, pl in enumerate(xf.placements)
                 if pl.is_shard(0) and sizes[i] > 1)


def experts(p: Params, buf: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts over the buffer (E, C, d) -> (E, C, d)."""
    act = F.silu(matmul(buf, p["w1"])) * matmul(buf, p["w3"])
    return matmul(act, p["w2"])


def combine(out_buf: torch.Tensor, src_e: torch.Tensor, src_c: torch.Tensor,
            w: torch.Tensor, k: int) -> torch.Tensor:
    """Each token's k expert outputs (E, C, d) gathered and summed by their
    weights -> (T, d)."""
    gathered = out_buf[src_e, src_c]                                # (T·k, d)
    return (gathered * w[:, None]).reshape(-1, k, out_buf.shape[-1]).sum(dim=1)


def moe_forward(cfg, p: Params, x: torch.Tensor, cap_override: int = 0, split=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (out (B,S,d), aux load-balance loss, a scalar).

    ``cap_override`` sets an explicit capacity; decode passes ``B·S`` for
    the dropless (exact top-k) path, the serving-correct behaviour.
    ``split`` (a :class:`~repro_torch.dist.sharding.SlotSplit` over more
    than one data rank) says that ``x`` is this rank's rows of a batch
    split over the data ranks as local rows: the capacity is the whole
    batch's, and each rank routes its own rows at the whole batch's slots
    (:func:`_split_rows_moe`).

    On DTensors (a sharded model) routing and dispatch run on local
    tensors (:func:`repro_torch.dist.sharding.on_shards`), where DTensor
    has no rule for the scatter.  Where the tokens are split over data
    ranks (:func:`_split_moe`) each rank routes its own and exchanges its
    kept rows with the ranks that own their slots, and ``out`` comes back
    split as ``x`` is; otherwise every rank runs them over the whole
    tokens and the whole router, the same index arithmetic on the same
    values.  The expert products stay DTensor products on the experts'
    split weights; their partial sums are reduced once, before the
    combine."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    if split is not None and split.split:
        out, aux = _split_rows_moe(cfg, p, xf, cap_override or capacity(cfg, t * split.size),
                                   split)
        return out.reshape(b, s, d), aux
    cap = cap_override or capacity(cfg, t)
    group = _token_group(xf)
    if group:
        out, aux = _split_moe(cfg, p, xf, cap, group)
        return out.reshape(b, s, d), aux
    if is_dtensor(xf):
        rep = SH.local_placements(xf)                  # every mesh dim replicated
        buf, src_e, src_c, w, aux = SH.on_shards(
            functools.partial(dispatch, cfg, cap=cap), (p["router"], xf), (rep, rep),
            (rep,) * 5)
    else:
        buf, src_e, src_c, w, aux = dispatch(cfg, p["router"], xf, cap)

    out_buf = experts(p, buf)
    if is_dtensor(xf):
        out = SH.on_shards(functools.partial(combine, k=cfg.top_k), (out_buf, src_e, src_c, w),
                           (rep,) * 4, rep)
    else:
        out = combine(out_buf, src_e, src_c, w, cfg.top_k)
    return out.reshape(b, s, d), aux
