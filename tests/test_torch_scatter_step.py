"""The data-split decode step's scatter, on the CPU: every attention layer's
gathered rows written into every layer's pools by one call
(``kernels.paged_attention.paged_scatter_step``), against the per-layer
loop it replaces and against the reference's ``paged_scatter``.

A reduced hybrid recurrentgemma-2b (9 layers: 3 attention layers among 6
RG-LRU layers, whose state blocks the write skips) with fp32, bf16 and int8
pages.  Two fake data ranks of 3 slots each pack their new rows as
``kvcache.share_new_rows`` does, and a stand-in for the data group's
all-gather concatenates them in rank order.  Among the 6 slots, two idle
slots aim at the scratch row (page 0, offset 0) and a slot of the second
rank at a live slot's place on the first rank: the last row wins.

* ``share_new_rows`` through the one call leaves every pool bit-equal to
  the loop that wrote each layer with ``ops.paged_scatter`` (the port's
  code before the one-launch write, copied below), and to the plain
  whole-step function given that gathered buffer;
* both equal, bit for bit, the reference's ``repro.kernels.ops.paged_scatter``
  (``paged_scatter_quant`` for int8) applied layer by layer, its Pallas
  kernel in interpret mode as ``tests/test_kernels.py`` runs it;
* a buffer whose width is not the pools' rows' is refused, and a tensor on
  a device with no kernel raises rather than running the loop.

The kernel is held to the plain version bit for bit on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as PA
from repro_torch.serve import kvcache as KV

SLOTS_A_RANK, RANKS, PAGE, N_PAGES = 3, 2, 4, 9
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def cfg_of(page_dtype):
    cfg = reduced(get_config("recurrentgemma-2b"), n_layers=9)
    if page_dtype == "int8":
        return dataclasses.replace(cfg, kv_quant=True)
    return dataclasses.replace(cfg, compute_dtype=page_dtype)


def random_like(rng, t, name):
    if t.dtype == torch.int8:
        return torch.from_numpy(rng.integers(-127, 128, t.shape).astype(np.int8))
    if "scale" in name:
        return torch.from_numpy(rng.uniform(0.005, 0.025, t.shape).astype(np.float32))
    return torch.from_numpy(rng.normal(0, 1, t.shape).astype(np.float32)).to(t.dtype)


def pools_of(cfg, rng):
    """The pool's blocks, every page leaf filled with random values (so
    that a write to a wrong place shows)."""
    blocks = KV.init_pool_blocks(cfg, N_PAGES, PAGE, RANKS * SLOTS_A_RANK, "cpu")
    for kind, block in zip(cfg.layer_kinds(), blocks["layers"]):
        if kind == "attn":
            for name in block:
                block[name].copy_(random_like(rng, block[name], name))
    return blocks


def attn_blocks(cfg, blocks):
    return [b for k, b in zip(cfg.layer_kinds(), blocks["layers"]) if k == "attn"]


def rank_rows(cfg, rng, block):
    """One rank's new rows of every attention layer, as the decode step
    hands them to ``share_new_rows``: (K, V[, K scales, V scales]) of its
    slots, K and V in the page dtype."""
    out = []
    for pb in attn_blocks(cfg, block):
        rows = tuple(random_like(rng, pb[name][0, :SLOTS_A_RANK], name)
                     for name in KV.PAGE_LEAVES if name in pb)
        out.append(rows)
    return out


def schedule():
    """(pos, table) of the 6 slots: slots 2 and 5 idle (position 0 on the
    scratch page), slot 4 (second rank) at slot 1's place."""
    pos = torch.tensor([5, 9, 0, 14, 9, 0], dtype=torch.int32)
    table = torch.tensor([[1, 2, 0, 0], [3, 4, 5, 0], [0, 0, 0, 0], [6, 7, 8, 2],
                          [3, 4, 5, 0], [0, 0, 0, 0]], dtype=torch.int32)
    return pos, table


class GatherOfRanks:
    """A data group of two ranks seen from the first: ``gather`` puts the
    second rank's packed rows after this rank's, as the all-gather does."""

    split = True

    def __init__(self, others):
        self.others = others

    def gather(self, t):
        return torch.cat([t, self.others])


def loop_before(cfg, blocks, new_rows, whole, page_idx, off):
    """The per-layer write of ``share_new_rows`` before the one-call step:
    each layer's slices of the gathered bytes copied out and written with
    ``ops.paged_scatter`` (``paged_scatter_quant`` for int8 pages)."""
    at = 0
    for rows, block in zip(new_rows, attn_blocks(cfg, blocks)):
        got = []
        for t in rows:
            width = t[0].numel() * t.element_size()
            got.append(whole[:, at:at + width].contiguous().view(t.dtype)
                       .reshape((whole.shape[0],) + tuple(t.shape[1:])))
            at += width
        pools = [block[name] for name in KV.PAGE_LEAVES if name in block]
        if len(pools) == 4:
            tops.paged_scatter_quant(*pools, *got, page_idx, off)
        else:
            tops.paged_scatter(*pools, *got, page_idx, off)


def to_jax(t):
    return jnp.asarray(bridge.tensor_to_numpy(t, bf16_dtype=jnp.bfloat16))


def reference_layer_by_layer(cfg, blocks, rows_of_ranks, page_idx, off):
    """The reference's ``paged_scatter`` on each attention layer's pools and
    the whole batch's rows (the ranks' rows in rank order); numpy pools."""
    out = []
    for i, block in enumerate(attn_blocks(cfg, blocks)):
        names = [n for n in KV.PAGE_LEAVES if n in block]
        rows = [torch.cat([rank[i][j] for rank in rows_of_ranks]) for j in range(len(names))]
        args = [to_jax(block[n]) for n in names] + [to_jax(r) for r in rows]
        fn = jops.paged_scatter_quant if len(names) == 4 else jops.paged_scatter
        pools = fn(*args, jnp.asarray(page_idx.numpy()), jnp.asarray(off.numpy()))
        out.append({n: np.asarray(p) for n, p in zip(names, pools)})
    return out


def copy_of(blocks):
    return {"layers": [{n: t.clone() for n, t in b.items()} for b in blocks["layers"]]}


def leaves_of(cfg, blocks):
    return [[b[n] for n in KV.PAGE_LEAVES if n in b] for b in attn_blocks(cfg, blocks)]


def same_pools(cfg, a, b):
    for pa, pb in zip(attn_blocks(cfg, a), attn_blocks(cfg, b)):
        assert pa.keys() == pb.keys()
        for name in pa:
            assert torch.equal(pa[name], pb[name]), name


def step_case(page_dtype, seed=0):
    rng = np.random.default_rng(seed)
    cfg = cfg_of(page_dtype)
    assert cfg.layer_kinds().count("attn") == 3 and len(cfg.layer_kinds()) == 9
    blocks = pools_of(cfg, rng)
    ranks = [rank_rows(cfg, rng, blocks) for _ in range(RANKS)]
    pos, table = schedule()
    page_idx, off = KV.write_slots(pos, table, PAGE)
    return cfg, blocks, ranks, pos, table, page_idx, off


@pytest.mark.parametrize("page_dtype", list(DTYPES))
def test_the_case_collides_in_the_page_dtype(page_dtype):
    cfg, blocks, _, _, _, page_idx, off = step_case(page_dtype)
    assert {b["k_pages"].dtype for b in attn_blocks(cfg, blocks)} == {DTYPES[page_dtype]}
    dest = list(zip(page_idx.tolist(), off.tolist()))
    assert dest[2] == dest[5] == (0, 0)                 # two idle slots on the scratch row
    assert dest[1] == dest[4] != (0, 0)                 # a live place two ranks' slots aim at
    assert len(set(dest)) == 4


@pytest.mark.parametrize("page_dtype", list(DTYPES))
def test_shared_rows_equal_the_per_layer_loop_and_the_reference(page_dtype):
    cfg, blocks, ranks, pos, table, page_idx, off = step_case(page_dtype)
    loop, plain = copy_of(blocks), copy_of(blocks)
    whole = torch.cat([KV.pack_new_rows(rows) for rows in ranks])
    layout = sum(t[0].numel() * t.element_size() for rows in ranks[0] for t in rows)
    assert whole.shape == (RANKS * SLOTS_A_RANK, layout) and whole.dtype == torch.uint8
    want = reference_layer_by_layer(cfg, blocks, ranks, page_idx, off)

    launches = (PA.scatter_launches, PA.scatter_step_launches)
    KV.share_new_rows(cfg, blocks, ranks[0], pos, table, GatherOfRanks(KV.pack_new_rows(ranks[1])))
    assert (PA.scatter_launches, PA.scatter_step_launches) == launches   # the CPU counts none

    loop_before(cfg, loop, ranks[0], whole, page_idx, off)
    PA.paged_scatter_step_plain(whole, leaves_of(cfg, plain), page_idx, off)
    same_pools(cfg, blocks, loop)
    same_pools(cfg, blocks, plain)
    for got, ref in zip(attn_blocks(cfg, blocks), want):
        for name, w in ref.items():
            np.testing.assert_array_equal(
                bridge.tensor_to_numpy(got[name], bf16_dtype=jnp.bfloat16), w, err_msg=name)
    # the last row aimed at a place wins: slot 4 at slot 1's place, slot 5 on scratch
    k0 = attn_blocks(cfg, blocks)[0]["k_pages"]
    assert torch.equal(k0[int(page_idx[1]), int(off[1])], ranks[1][0][0][1])
    assert torch.equal(k0[0, 0], ranks[1][0][0][2])


@pytest.mark.parametrize("page_dtype", list(DTYPES))
def test_rows_of_the_recurrent_layers_are_untouched(page_dtype):
    """The write reaches the attention layers' pools only: the RG-LRU
    layers' state blocks keep their bits."""
    cfg, blocks, ranks, pos, table, _, _ = step_case(page_dtype, seed=1)
    rec = [{n: t.clone() for n, t in b.items()}
           for k, b in zip(cfg.layer_kinds(), blocks["layers"]) if k != "attn"]
    KV.share_new_rows(cfg, blocks, ranks[0], pos, table, GatherOfRanks(KV.pack_new_rows(ranks[1])))
    after = [b for k, b in zip(cfg.layer_kinds(), blocks["layers"]) if k != "attn"]
    assert len(after) == 6
    for a, b in zip(rec, after):
        for name in a:
            assert torch.equal(a[name], b[name]), name


def test_a_buffer_of_another_layout_is_refused():
    cfg, blocks, ranks, _, _, page_idx, off = step_case("int8")
    whole = torch.cat([KV.pack_new_rows(rows) for rows in ranks])
    layers = leaves_of(cfg, blocks)
    with pytest.raises(ValueError, match="paged_scatter_step: rows of"):
        PA.paged_scatter_step(whole[:, :-4], layers, page_idx, off)
    with pytest.raises(ValueError, match="paged_scatter_step: rows of"):
        PA.paged_scatter_step(whole, layers[:2], page_idx, off)


def test_no_kernel_device_raises_instead_of_the_loop():
    """Off the CPU the step goes to the kernel or raises; it never runs the
    per-layer loop (``meta`` stands in for a device with no kernel)."""
    cfg, blocks, ranks, _, _, page_idx, off = step_case("bfloat16")
    whole = torch.cat([KV.pack_new_rows(rows) for rows in ranks]).to("meta")
    layers = [[t.to("meta") for t in leaves] for leaves in leaves_of(cfg, blocks)]
    launches = PA.scatter_launches
    with pytest.raises(ValueError, match="paged_scatter_step: no kernel for device meta"):
        PA.paged_scatter_step(whole, layers, page_idx.to("meta"), off.to("meta"))
    assert PA.scatter_launches == launches
