"""The port's prefix cache, copy-on-write page clone and prefix joins
against the JAX package's, on the CPU.

``repro_torch.serve.fleet.prefix`` is a copy pinned to the original's
text.  The reference's prefix-cache and pool cases (``tests/test_fleet.py``)
run on both packages' pools and caches from the same operations, and the
two end in the same free list, references, reservations, trie and
counters.  ``make_clone_pages`` is bit-equal to the reference's on bridged
pools.  A served stream whose later requests share a prompt prefix that
is not a whole number of pages (two full pages and a partial one, so each
hit clones a page) gives the same tokens through the port's prefix joins,
the port's cold path and the reference's prefix joins, greedy and at
T 0.8, with float and with int8 pages.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import init_params as jinit_params
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import PagedKVPool as JPool
from repro.serve import Request as JRequest
from repro.serve import kvcache as JK
from repro.serve.fleet import PrefixCache as JPrefixCache
from repro_torch import bridge, jrandom
from repro_torch.configs import get_config, reduced
from repro_torch.models import transformer as TT
from repro_torch.serve import fleet as TF
from repro_torch.serve import kvcache as TK
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.serve.fleet import PrefixCache
from repro_torch.serve.scheduler import Request

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_prefix_module_text_equals_the_original():
    mine = open(os.path.join(ROOT, "src", "repro_torch", "serve", "fleet", "prefix.py")).read()
    theirs = open(os.path.join(ROOT, "src", "repro", "serve", "fleet", "prefix.py")).read()
    assert mine.replace("repro_torch", "repro") == theirs
    assert {"PrefixCache", "PrefixMatch"} <= set(TF.__all__)
    assert TF.PrefixMatch.__module__ == "repro_torch.serve.fleet.prefix"


# --------------------------------------------------------------------------
# the pool and the cache, operation for operation against the reference
# --------------------------------------------------------------------------

PKGS = {"repro": (JPool, JPrefixCache, jreduced(jget_config("llama3.2-1b"))),
        "repro_torch": (TK.PagedKVPool, PrefixCache, reduced(get_config("llama3.2-1b")))}


def reachable_nodes(cache) -> int:
    """Resident trie nodes reachable from the root (``tests/test_fleet.py``)."""
    n, stack = 0, [cache._root]
    while stack:
        node = stack.pop()
        n += len(node.children) + len(node.partials)
        stack.extend(node.children.values())
    return n


def state(pool, cache) -> dict:
    """Everything the pool and the cache hold, the trie as nested tuples."""
    def trie(node):
        return (node.tokens, node.page_id, node.n_tokens, node.last_use,
                sorted(trie(c) for c in node.children.values()),
                sorted(trie(c) for c in node.partials.values()))
    return dict(free=list(pool._free), ref=dict(pool._ref), reserved=dict(pool._reserved),
                allocated={k: list(v) for k, v in pool._allocated.items()},
                counters=(cache.n_lookups, cache.n_hits, cache.tokens_matched,
                          cache.tokens_looked_up, cache.n_insertions, cache.n_evictions,
                          cache.n_resident_pages, cache._clock),
                trie=trie(cache._root))


def match_insert_and_cow_partial(Pool, Cache, cfg):
    pool = Pool(cfg, n_slots=2, max_len=32, page=8, num_pages=17, materialize=False)
    cache = Cache(pool, max_pages=8)
    assert pool.reserve_pages("w", 3)
    pages = pool.alloc("w", 3)
    tokens = np.arange(1, 21)                       # 20 tokens: 2 full + 4 partial
    assert cache.insert(tokens, pages) == 3
    pool.release("w")
    assert all(pool.refcount(p) == 1 for p in pages)
    m = cache.match(np.arange(1, 41))
    assert m.n_tokens == 20 and m.full_pages == pages[:2]
    assert m.partial_page == pages[2] and m.partial_len == 4
    m = cache.match(tokens)                         # capped at len - 1
    assert m.n_tokens == 16 and m.partial_page is None
    lookups = cache.n_lookups
    assert cache.peek(np.arange(1, 41)) == 20 and cache.n_lookups == lookups
    return pool, cache


def pressure_eviction_unblocks_admission(Pool, Cache, cfg):
    pool = Pool(cfg, n_slots=2, max_len=32, page=8, num_pages=9, materialize=False)
    cache = Cache(pool, max_pages=8)
    assert pool.reserve_pages("w", 6)
    cache.insert(np.arange(1, 49), pool.alloc("w", 6))
    pool.release("w")
    assert cache.n_resident_pages == 6 and pool.free_pages == 2
    assert pool.reserve_pages("big", 5)             # only with the cache pressured
    assert cache.n_evictions >= 3
    pool.release("big")
    cache.clear()
    assert pool.free_pages == pool.capacity_pages
    return pool, cache


def insert_at_capacity_never_detaches_own_path(Pool, Cache, cfg):
    pool = Pool(cfg, n_slots=2, max_len=64, page=8, num_pages=17, materialize=False)
    cache = Cache(pool, max_pages=2)
    assert pool.reserve_pages("a", 2)
    cache.insert(np.arange(1, 17), pool.alloc("a", 2))
    pool.release("a")
    assert pool.reserve_pages("b", 4)
    cache.insert(np.arange(1, 31), pool.alloc("b", 4))
    pool.release("b")
    assert reachable_nodes(cache) == cache.n_resident_pages == 2
    cache.clear()
    assert cache.n_resident_pages == 0 and pool.free_pages == pool.capacity_pages
    return pool, cache


def insert_at_capacity_evicts_off_path_leaf(Pool, Cache, cfg):
    pool = Pool(cfg, n_slots=2, max_len=64, page=8, num_pages=17, materialize=False)
    cache = Cache(pool, max_pages=2)
    assert pool.reserve_pages("cold", 1)
    cache.insert(np.arange(50, 58), pool.alloc("cold", 1))
    pool.release("cold")
    assert pool.reserve_pages("hot", 2)
    assert cache.insert(np.arange(1, 17), pool.alloc("hot", 2)) == 2
    pool.release("hot")
    assert cache.n_evictions == 1
    assert reachable_nodes(cache) == cache.n_resident_pages == 2
    return pool, cache


def match_stats_commit_only_on_admission(Pool, Cache, cfg):
    pool = Pool(cfg, n_slots=2, max_len=32, page=8, num_pages=9, materialize=False)
    cache = Cache(pool, max_pages=4)
    assert pool.reserve_pages("w", 2)
    cache.insert(np.arange(1, 17), pool.alloc("w", 2))
    pool.release("w")
    clock = cache._clock
    for _ in range(5):
        m = cache.match(np.arange(1, 25))
    assert m.n_tokens == 16 and cache.n_lookups == 0 and cache._clock == clock
    cache.commit(m)
    assert (cache.n_lookups, cache.tokens_looked_up, cache.n_hits) == (1, 24, 1)
    assert cache.hit_rate == pytest.approx(16 / 24)
    return pool, cache


def shared_page_survives_eviction_until_release(Pool, Cache, cfg):
    pool = Pool(cfg, n_slots=2, max_len=32, page=8, num_pages=9, materialize=False)
    cache = Cache(pool, max_pages=4)
    assert pool.reserve_pages("w", 2)
    pages = pool.alloc("w", 2)
    cache.insert(np.arange(1, 17), pages)
    pool.release("w")
    assert pool.reserve_pages("r", 0)
    pool.share("r", pages)
    cache.clear()
    assert all(pool.refcount(p) == 1 for p in pages)
    pool.release("r")
    assert pool.free_pages == pool.capacity_pages
    return pool, cache


SCENARIOS = [match_insert_and_cow_partial, pressure_eviction_unblocks_admission,
             insert_at_capacity_never_detaches_own_path, insert_at_capacity_evicts_off_path_leaf,
             match_stats_commit_only_on_admission, shared_page_survives_eviction_until_release]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_pool_and_cache_cases_match_the_reference(scenario):
    """Each of the reference's prefix cases, its own checks included, on
    both packages; the two end in the same state."""
    got = state(*scenario(*PKGS["repro_torch"]))
    assert got == state(*scenario(*PKGS["repro"]))


def admit_and_retire(Pool, Cache, cfg, ops):
    """``tests/test_fleet.py``'s refcount property body: prefix-aware
    admissions (match, pin, reserve, share, copy-on-write alloc) and
    retirements (insert, release) under pressure eviction; returns the
    state after every operation and after teardown."""
    pool = Pool(cfg, n_slots=4, max_len=64, page=8, num_pages=17, materialize=False)
    cache = Cache(pool, max_pages=8)
    live, states, rid = [], [], 0
    for base, length, evict_n in ops:
        if evict_n and len(live) > 2:
            old, pages, tokens = live.pop(0)
            cache.insert(tokens, pages)
            pool.release(old)
            assert reachable_nodes(cache) == cache.n_resident_pages
        prompt = np.array([(base + j) % 7 + 1 for j in range(length)], np.int32)
        m = cache.match(prompt)
        shared = list(m.full_pages) + ([m.partial_page] if m.partial_page is not None else [])
        need = pool.pages_needed(len(prompt)) - len(m.full_pages)
        pool.retain(shared)
        rid += 1
        if not pool.reserve_pages(rid, need):
            pool.unretain(shared)
            states.append(state(pool, cache))
            continue
        pages = list(m.full_pages)
        if shared:
            pool.share(rid, shared)
            pool.unretain(shared)
        cache.commit(m)
        if m.partial_page is not None:
            pages.extend(pool.alloc(rid, 1))
        rest = pool.pages_needed(len(prompt)) - len(pages)
        if rest > 0:
            pages.extend(pool.alloc(rid, rest))
        live.append((rid, pages, prompt))
        assert all(pool.refcount(pid) == 0 for pid in pool._free)
        states.append(state(pool, cache))
    for old, pages, tokens in live:
        cache.insert(tokens, pages)
        pool.release(old)
        assert reachable_nodes(cache) == cache.n_resident_pages
    cache.clear()
    assert cache.n_resident_pages == 0 and pool.free_pages == pool.capacity_pages
    assert sorted(pool._free) == list(range(1, pool.num_pages))
    return states


@settings(max_examples=30, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 5), st.integers(1, 30), st.integers(0, 6)),
                min_size=1, max_size=30))
def test_refcount_free_list_never_double_frees(ops):
    """The reference's property: no double free, no leak; and the port's
    pool and cache pass through the reference's states, step by step."""
    assert admit_and_retire(*PKGS["repro_torch"], ops) == \
        admit_and_retire(*PKGS["repro"], ops)


def test_pool_double_free_raises():
    pool = TK.PagedKVPool(PKGS["repro_torch"][2], n_slots=2, max_len=32, page=8, num_pages=9,
                          materialize=False)
    assert pool.reserve_pages("a", 1)
    (pid,) = pool.alloc("a", 1)
    pool.release("a")
    with pytest.raises(RuntimeError, match="double free"):
        pool.unretain([pid])


# --------------------------------------------------------------------------
# the copy-on-write clone
# --------------------------------------------------------------------------

def random_blocks(rng, blocks):
    """The reference's pool tree with every leaf random: int8 pages in
    [-127, 127], float leaves normal in their dtype."""
    def fill(a):
        if a.dtype == jnp.int8:
            return jnp.asarray(rng.integers(-127, 128, a.shape), jnp.int8)
        return jnp.asarray(rng.normal(0, 1, a.shape), a.dtype)
    return jax.tree.map(fill, blocks)


def to_bits(tree):
    return jax.tree.map(lambda a: np.asarray(a).tobytes(), tree)


@pytest.mark.parametrize("arch,mods", [
    ("llama3.2-1b", {}), ("llama3.2-1b", {"compute_dtype": "bfloat16"}),
    ("llama3.2-1b", {"kv_quant": True}),
    ("recurrentgemma-2b", {"n_layers": 3, "window": 16}),
])
def test_clone_pages_bit_equal_to_the_reference(arch, mods):
    """``make_clone_pages`` on bridged pools (fp32, bf16, int8 with scale
    pages): page ``dst`` becomes page ``src`` in every attention leaf, bit
    for bit as the reference's XLA clone, in place; every other page and
    the recurrent state are left as they were."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **mods)
    tcfg = dataclasses.replace(reduced(get_config(arch)), **mods)
    jblocks = random_blocks(np.random.default_rng(3), JPool(jcfg, 2, 32, 8).blocks)
    tblocks = bridge.blocks_from_numpy(tcfg, jax.tree.map(np.asarray, jblocks), "cpu")
    before = {id(t): t.clone() for layer in tblocks["layers"] for t in layer.values()}
    src, dst = 3, 6
    want = jax.jit(JK.make_clone_pages(jcfg))(jblocks, jnp.int32(src), jnp.int32(dst))
    got = TK.make_clone_pages(tcfg)(tblocks, src, dst)
    assert got is tblocks                            # in place
    assert to_bits(bridge.blocks_to_numpy(tcfg, got, bf16_dtype=jnp.bfloat16)) == \
        to_bits(jax.tree.map(np.asarray, want))
    n_attn = 0
    for kind, layer in zip(tcfg.layer_kinds(), got["layers"]):
        for name, t in layer.items():
            old = before[id(t)]
            if kind == "attn":
                n_attn += 1
                assert torch.equal(t[dst], old[src]), name
                keep = [p for p in range(t.shape[0]) if p != dst]
                assert torch.equal(t[keep], old[keep]), name
            else:
                assert torch.equal(t, old), name
    assert n_attn == tcfg.layer_kinds().count("attn") * (4 if tcfg.kv_quant else 2)


# --------------------------------------------------------------------------
# prefix joins, token for token
# --------------------------------------------------------------------------

PAGE = 8
PREFIX = 2 * PAGE + PAGE // 2      # two full pages and a partial one of 4


def stream(vocab, seed=0):
    """Two groups: each a priming request of the bare prefix (one new
    token, so the trie ends in the partial page) and two members, the
    prefix with a 4-token suffix of their own, 6 new tokens; all at t 0,
    in the order the two slots take them."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, vocab, PREFIX).astype(np.int32) for _ in range(2)]
    prime = [(p, 1) for p in prefixes]
    members = [(np.concatenate([prefixes[g], rng.integers(0, vocab, 4).astype(np.int32)]), 6)
               for _ in range(2) for g in range(2)]
    return prime + members


def serve(engine_cls, request_cls, cfg, params, temperature, key_fn, with_cache, **kw):
    eng = engine_cls(cfg, params, n_slots=2, max_len=48, page=PAGE, temperature=temperature,
                     **kw)
    if with_cache:
        eng.enable_prefix_cache()
    reqs = [request_cls(prompt=p, max_new=n, arrival=0.0, key=key_fn(i))
            for i, (p, n) in enumerate(stream(cfg.vocab))]
    done = eng.serve(reqs)
    order = {r.rid: i for i, r in enumerate(reqs)}
    return eng, [list(r.out) for r in sorted(done, key=lambda r: order[r.rid])], reqs


@pytest.mark.parametrize("temperature,kv_quant", [(0.0, False), (0.8, False), (0.0, True),
                                                  (0.8, True)])
def test_prefix_joins_give_the_cold_tokens_and_the_references(temperature, kv_quant):
    """The port's prefix-cache engine (shared full pages, a clone of the
    partial one, the suffix replayed as forced tokens) serves the tokens
    of its own cold path and of the reference's prefix-cache engine, with
    at least one hit and one clone; sampled requests draw with
    ``fold_in(key, n)`` for their n-th token in all three.  At the end no
    page is held but the resident ones."""
    jcfg = dataclasses.replace(jreduced(jget_config("llama3.2-1b")), kv_quant=kv_quant)
    tcfg = dataclasses.replace(reduced(get_config("llama3.2-1b")), kv_quant=kv_quant)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    sampled = temperature > 0

    def tkey(i):
        return jrandom.fold_in(jrandom.key(5), i) if sampled else None

    def jkey(i):
        return jax.random.fold_in(jax.random.PRNGKey(5), i) if sampled else None

    _, cold, _ = serve(ContinuousEngine, Request, tcfg, tp, temperature, tkey, False,
                       device="cpu")
    eng, warm, reqs = serve(ContinuousEngine, Request, tcfg, tp, temperature, tkey, True,
                            device="cpu")
    _, ref, _ = serve(JContinuousEngine, JRequest, jcfg, jp, temperature, jkey, True)
    cache = eng.prefix_cache
    clones = sum(r.prefix_match.partial_page is not None for r in reqs)
    # every member hits; the later two find their partial page evicted to
    # make room for the earlier members' pages (max_pages 6), so they share
    # the two full pages only
    assert (cache.n_hits, clones) == (4, 2)
    assert eng.n_joins == len(reqs) - cache.n_hits         # a hit runs no prefill
    assert [len(o) for o in warm] == [1, 1, 6, 6, 6, 6]
    assert warm == cold
    assert warm == ref
    pool = eng.pool
    assert not pool._reserved and not pool._allocated and not eng._forced
    assert len(pool._free) == pool.capacity_pages - cache.n_resident_pages


def test_joiners_never_write_the_shared_pages():
    """The pages a priming request leaves resident are bit for bit the same
    after later requests joined on them: their writes went to the clone
    and to pages of their own, in the pool's stream order."""
    tcfg = reduced(get_config("llama3.2-1b"))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    eng = ContinuousEngine(tcfg, tp, n_slots=2, max_len=48, page=PAGE, device="cpu")
    cache = eng.enable_prefix_cache()
    (prime, n1), *members = stream(tcfg.vocab)[::2]
    eng.serve([Request(prompt=prime, max_new=n1)])
    resident = sorted(pool_id for pool_id, n in eng.pool._ref.items() if n)
    assert len(resident) == 3 == cache.n_resident_pages
    snap = [{k: v[resident].clone() for k, v in layer.items()} for layer in eng.pool.blocks["layers"]]
    done = eng.serve([Request(prompt=p, max_new=n) for p, n in members])
    assert cache.n_hits == 2 and all(len(r.out) == 6 for r in done)
    for layer, old in zip(eng.pool.blocks["layers"], snap):
        for k, v in layer.items():
            assert torch.equal(v[resident], old[k]), k


def test_prefix_cache_refuses_what_the_reference_refuses():
    """Recurrent state is per slot and frontend prefixes are not
    token-addressable: mamba2, recurrentgemma and internvl2 are refused
    with the reference's messages; an all-attention arch is taken."""
    for arch in ("mamba2-130m", "recurrentgemma-2b", "internvl2-1b"):
        tcfg = reduced(get_config(arch))
        tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
        jcfg = jreduced(jget_config(arch))
        with pytest.raises(ValueError) as want:
            JContinuousEngine(jcfg, None, n_slots=1, max_len=32,     # guards read no weight
                              page=8).enable_prefix_cache()
        with pytest.raises(ValueError) as got:
            ContinuousEngine(tcfg, tp, n_slots=1, max_len=32, page=8,
                             device="cpu").enable_prefix_cache()
        assert str(got.value) == str(want.value), arch
    tcfg = reduced(get_config("olmo-1b"))
    eng = ContinuousEngine(tcfg, TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu"),
                           n_slots=1, max_len=32, page=8, device="cpu")
    assert isinstance(eng.enable_prefix_cache(max_pages=3), PrefixCache)
    assert eng.pool.on_pressure == eng.prefix_cache.evict
