"""The arithmetic of the data-split MoE exchange (``repro_torch.models.moe``),
in one process on the CPU: D ranks' halves of the all-to-all simulated by
splitting and concatenating their buffers.

* ``slot_spans`` is DTensor's ``Shard(1)`` layout of the capacity over the
  token group's mesh dims: ``torch.chunk``'s pieces, nested in mesh-dim
  order, for a capacity that the group divides and one it does not.
* ``plan_exchange`` sends each kept assignment to the rank that owns its
  slot of the whole batch's buffer, and the owner writes it there: the
  owners' slots side by side are ``scatter``'s whole buffer, bit for bit,
  drops included; the inverse exchange gives ``combine``'s output.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import moe as M

ARCH = "granite-moe-3b-a800m"
# (tokens, capacity factor, the group's mesh-dim sizes): the capacity
# 20 = 2 × 10, 23 over 2 and over (2, 2), 8 = 4 × 2 (drops on every
# rank), 23 over 3, 60 over 4 (no drops; the last ranks receive nothing)
CASES = [(32, 1.25, (2,)), (32, 1.4, (2,)), (32, 1.4, (2, 2)), (32, 0.5, (4,)),
         (36, 1.25, (3,)), (40, 3.0, (4,))]


def chunked_spans(cap, sizes):
    """``Shard(1)`` over mesh dims of ``sizes`` as ``torch.chunk`` cuts an
    arange of the slots, each dim cutting the pieces the dims before it
    left (a piece ``chunk`` does not return is empty)."""
    pieces = [torch.arange(cap)]
    for g in sizes:
        cut = []
        for p in pieces:
            parts = list(p.chunk(g)) if len(p) else []
            cut += parts + [p[:0]] * (g - len(parts))
        pieces = cut
    return ([int(p[0]) if len(p) else sum(len(q) for q in pieces[:i])
             for i, p in enumerate(pieces)], [len(p) for p in pieces])


@pytest.mark.parametrize("cap,sizes", [(20, (2,)), (23, (2,)), (9, (4,)), (5, (4,)),
                                       (10, (2, 2)), (7, (2, 4)), (23, (3,))])
def test_slot_spans_are_the_chunks_of_the_capacity(cap, sizes):
    starts, counts = M.slot_spans(cap, sizes)
    assert (list(starts), list(counts)) == chunked_spans(cap, sizes)
    assert sum(counts) == cap and all(a + n == b for a, n, b in
                                      zip(starts, counts, starts[1:] + (cap,)))


def routed_batch(cfg, t, seed):
    """A (t, d) batch whose tokens share a direction (skewed routing), the
    router from a seed."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    x = rng.normal(0, 1, (t, d)) + 1.5 * rng.normal(0, 1, d)
    router = rng.normal(0, 1, (d, cfg.n_experts)) / np.sqrt(d)
    return (torch.from_numpy(x.astype(np.float32)),
            torch.from_numpy(router.astype(np.float32)))


@pytest.mark.parametrize("t,cf,sizes", CASES, ids=str)
def test_exchange_puts_each_kept_row_at_its_owners_slot(t, cf, sizes):
    """Each rank routes its own t/D tokens; from every rank's counts its
    plan sends each kept assignment to the owner of the assignment's slot
    in the whole batch's buffer.  The owners' buffers side by side equal
    ``scatter``'s whole buffer (bit for bit), each sent row lands at
    (its expert, its slot - the owner's first slot), the split sizes
    agree both ways, and the inverse exchange equals ``combine``."""
    cfg = reduced(get_config(ARCH), capacity_factor=cf)
    e, k = cfg.n_experts, cfg.top_k
    x, router = routed_batch(cfg, t, seed=len(sizes) * 100 + t)
    cap = M.capacity(cfg, t)
    n_ranks = int(np.prod(sizes))
    starts, counts = M.slot_spans(cap, sizes)
    whole, src_e, src_c, w = M.scatter(cfg, x, *M.route(cfg, {"router": router}, x)[1:], cap)
    parts = x.chunk(n_ranks)
    routed = [M._route_own(cfg, router, xp) for xp in parts]
    assign_counts = torch.cat([r[1] for r in routed])
    plans = [M.plan_exchange(assign_counts, r[3], q, cap, starts, counts)
             for q, r in enumerate(routed)]

    # the kept assignments: which owner and which of its slots each goes to
    _, keep_all = M.positions(torch.cat([r[3] for r in routed]), e, cap)
    assert torch.equal(torch.cat([keep for _, keep in plans]), keep_all)
    n_loc = t // n_ranks * k
    for r, (ex, keep) in enumerate(plans):
        assert sum(ex.send_splits) == int(keep.sum())
        rows = ex.send_idx[keep]
        assert torch.equal(torch.sort(rows).values, torch.arange(len(rows)))
        owner = torch.searchsorted(torch.tensor(np.cumsum(ex.send_splits)), rows, right=True)
        for q in range(n_ranks):
            assert plans[q][0].recv_splits[r] == ex.send_splits[q]
        glob = torch.arange(r * n_loc, (r + 1) * n_loc)[keep]
        for i, (o, row) in enumerate(zip(owner.tolist(), rows.tolist())):
            dst = plans[o][0]
            j = sum(plans[o][0].recv_splits[:r]) + row - sum(ex.send_splits[:o])
            assert (int(dst.recv_expert[j]), int(dst.recv_slot[j]) + starts[o]) == (
                int(src_e[glob[i]]), int(src_c[glob[i]]))

    # the exchange, simulated: rank q receives each rank's chunk for it in turn
    sent = [xp[ex.assign_of_row // k].split(ex.send_splits)
            for xp, (ex, _) in zip(parts, plans)]
    bufs = []
    for q, (ex, _) in enumerate(plans):
        recv = torch.cat([sent[r][q] for r in range(n_ranks)])
        bufs.append(torch.zeros(e, ex.slots, cfg.d_model).index_put(
            (ex.recv_expert, ex.recv_slot), recv))
    assert torch.equal(torch.cat(bufs, dim=1), whole)

    # the inverse exchange of stand-in expert outputs, then the combine
    out_buf = torch.from_numpy(np.random.default_rng(t).normal(
        0, 1, whole.shape).astype(np.float32))
    back = [out_buf[ex.recv_expert, ex.recv_slot + starts[q]].split(ex.recv_splits)
            for q, (ex, _) in enumerate(plans)]
    got = []
    for r, ((ex, keep), gates) in enumerate(zip(plans, (rr[2] for rr in routed))):
        rows = torch.cat([back[q][r] for q in range(n_ranks)] + [torch.zeros(1, cfg.d_model)])
        wr = (gates.reshape(-1) * keep.float())
        got.append((rows[ex.send_idx] * wr[:, None]).reshape(-1, k, cfg.d_model).sum(dim=1))
    torch.testing.assert_close(torch.cat(got), M.combine(out_buf, src_e, src_c, w, k),
                               rtol=0, atol=0)


def test_even_counts_spread_each_ranks_assignments():
    """What the dry run's split sizes assume on ``meta``: each rank's
    assignments spread evenly over the experts."""
    c = M.even_counts(3, 40, 8 * 100)
    assert c.shape == (3, 40) and c.sum(dim=1).tolist() == [800] * 3
    assert int(c.max() - c.min()) == 0
    c = M.even_counts(2, 40, 8 * 13)
    assert c.sum(dim=1).tolist() == [104] * 2 and int(c.max() - c.min()) == 1
