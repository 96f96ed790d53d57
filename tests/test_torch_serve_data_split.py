"""One engine's decode slots split over the data ranks of a (2, 1) mesh, on
2 spawned gloo ranks, against the JAX package and the port's one-rank
engine, on the CPU.

For reduced llama3.2-1b, recurrentgemma-2b, mamba2-130m and
granite-moe-3b-a800m (the reference's weights), 4 slots, each rank
decoding its 2 (``sharding.slot_split``):

* the continuous engine's tokens, greedy and at T 0.8 with per-request
  keys, equal the reference's ``ContinuousEngine``'s on one device, and the
  static engine's at T 0.8 with ``key(1)`` the reference's ``ServeEngine``'s;
* each rank's recurrent-state leaves hold its 2 slots' rows, close to the
  one-rank engine's rows of those slots, and every rank's pages are close
  to the one-rank engine's (the bar of ``test_torch_sharding_dist``'s
  ``pool_close``, 1e-5) after the same run;
* one decode step's matrix-product FLOPs on a rank (``FlopCounterMode``)
  are exactly half those of the one-rank engine's step over the 4 slots,
  and the two ranks' FLOPs of a static generate sum to the one-rank
  engine's exactly (an MoE prefill routes each rank's rows at the whole
  batch's capacity, and the experts run on the rank's slots).

Then, on reduced llama3.2-1b: the slack meter books the whole batch's
filled and total slots on every rank, each step's slack share equal to
the one-rank engine's; 3 slots, which 2 ranks do not divide,
replicate (each rank decodes all 3) and give the one-rank engine's tokens;
a prefix the prefix cache keeps, whose later positions one rank's slot
decoded, reached again from slots on both ranks, gives the one-rank
engine's tokens (the other rank reads the rows the step gathered into its
pages); int8 pages give the reference's tokens, and every rank's pages
stay within one int8 step, their scales close, of the one-rank engine's.

The spawn helpers are ``test_torch_sharding_dist``'s; this file holds its
own 2-rank run, so that ``--dist loadfile`` runs it beside that file's.
The ranks serve while this process runs the reference's engines on the
same weights.  JAX is imported inside the reference-side helpers only.
"""
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from test_torch_sharding_dist import init_rank, join

ARCHS = ("llama3.2-1b", "recurrentgemma-2b", "mamba2-130m", "granite-moe-3b-a800m")
SLOTS, PROMPT_LEN, N_STEPS, MAX_LEN, PAGE = 4, 12, 6, 32, 8
TEMPERATURE = 0.8
POOL_TOL = dict(atol=1e-5, rtol=1e-5)
PREFIX_MAX_LEN = 48


def cfg_of(arch, kv_quant=False):
    return dataclasses.replace(reduced(get_config(arch)), kv_quant=kv_quant)


def prompts(vocab, n=SLOTS):
    return np.random.default_rng(1).integers(0, vocab, (n, PROMPT_LEN)).astype(np.int32)


CASES = [(a, False) for a in ARCHS] + [("llama3.2-1b", True)]     # (arch, int8 pages)


def jax_config(arch, kv_quant):
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced

    return dataclasses.replace(jreduced(jget_config(arch)), kv_quant=kv_quant)


def reference_weights(work_dir):
    """The reference's weights for each case, written for the ranks."""
    import jax

    from repro.models import init_params as jinit_params

    out = {case: jinit_params(jax_config(*case), jax.random.PRNGKey(0)) for case in CASES}
    with open(os.path.join(work_dir, "ref.pkl"), "wb") as f:
        pickle.dump({case: {"params": jax.tree.map(np.asarray, jp)}
                     for case, jp in out.items()}, f)
    return out


def reference_tokens(weights):
    """The reference's one-device tokens for each case."""
    import jax
    import jax.numpy as jnp

    from repro.serve import ContinuousEngine as JContinuousEngine
    from repro.serve import ServeEngine as JServeEngine

    out = {}
    for (arch, kv_quant), jp in weights.items():
        jcfg = jax_config(arch, kv_quant)
        batch = {"tokens": jnp.asarray(prompts(jcfg.vocab))}

        def continuous(temperature, key=None):
            return np.asarray(JContinuousEngine(jcfg, jp, n_slots=SLOTS, max_len=MAX_LEN,
                                                page=PAGE, temperature=temperature)
                              .generate(batch, n_steps=N_STEPS, key=key))

        case = {"greedy": continuous(0.0)}
        if not kv_quant:
            case["sampled"] = continuous(TEMPERATURE, jax.random.PRNGKey(3))
            case["static"] = np.asarray(JServeEngine(
                jcfg, jp, max_len=PROMPT_LEN + N_STEPS + 8, temperature=TEMPERATURE)
                .generate(batch, n_steps=N_STEPS, key=jax.random.PRNGKey(1)))
        out[arch, kv_quant] = case
    return out


# --------------------------------------------------------------------------
# on each rank
# --------------------------------------------------------------------------

def local(t):
    from repro_torch.device import is_dtensor

    return t.to_local() if is_dtensor(t) else t


def engines(mesh, cfg, params):
    """(a split engine maker, a one-rank engine maker, the sharded params):
    the split engine's weights on the rank's model row, its pool there, its
    slots split over the data axis."""
    from repro_torch.dist import sharding as SH
    from repro_torch.serve.engine import ContinuousEngine

    replica = SH.replica_mesh(mesh)
    sp = SH.distribute(params, SH.serve_param_shardings(replica, params))

    def split(**kw):
        eng = ContinuousEngine(cfg, sp, device="cpu", serve_mesh=mesh, **kw)
        eng.pool.blocks = SH.distribute(eng.pool.blocks,
                                        SH.page_pool_shardings(replica, eng.pool.blocks))
        return eng

    def plain(**kw):
        return ContinuousEngine(cfg, params, device="cpu", **kw)

    return split, plain, sp


def pages_close(eng, plain, tol=POOL_TOL):
    """Every page leaf of ``eng`` (this rank's copy) close to the one-rank
    engine's; int8 pages within one step."""
    ok = True
    for kind, mine, whole in zip(eng.cfg.layer_kinds(), eng.pool.blocks["layers"],
                                 plain.pool.blocks["layers"]):
        if kind != "attn":
            continue
        for name, t in mine.items():
            a, b = local(t), whole[name]
            if a.dtype == torch.int8:
                ok &= bool((a.int() - b.int()).abs().max() <= 1)
            else:
                ok &= bool(torch.allclose(a, b, **tol))
    return ok


def state_rows(eng, plain):
    """Each recurrent-state leaf's rows on this rank, and whether they are
    close to the one-rank engine's rows of the rank's slots."""
    lo, hi = eng.split.lo, eng.split.hi
    rows, close = [], True
    for kind, mine, whole in zip(eng.cfg.layer_kinds(), eng.pool.blocks["layers"],
                                 plain.pool.blocks["layers"]):
        if kind == "attn":
            continue
        for name, t in mine.items():
            rows.append(local(t).shape[0])
            close &= bool(torch.allclose(local(t), whole[name][lo:hi], **POOL_TOL))
    return rows, close


def flops(fn):
    """The matrix-product FLOPs that ``fn()`` runs on this rank."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc, torch.no_grad():
        fn()
    return fc.get_total_flops()


def step_flops(eng, params):
    """One decode step of ``eng`` over its whole batch's inputs (the step
    decodes the rank's own rows)."""
    return flops(lambda: eng._decode(
        params, eng._to_device(eng._tokens), eng._to_device(eng._lengths),
        eng._to_device(eng._table[:, :2]), eng.pool.blocks))


def serve_arch(mesh, arch, ref):
    from repro_torch import jrandom
    from repro_torch.serve.engine import ServeEngine

    cfg = cfg_of(arch)
    params = bridge.params_from_numpy(cfg, ref["params"], "cpu")
    split, plain, sp = engines(mesh, cfg, params)
    batch = {"tokens": prompts(cfg.vocab)}
    kw = dict(n_slots=SLOTS, max_len=MAX_LEN, page=PAGE)
    greedy = split(**kw).generate(batch, n_steps=N_STEPS)
    eng = split(temperature=TEMPERATURE, **kw)
    sampled = eng.generate(batch, n_steps=N_STEPS, key=jrandom.key(3))
    one = plain(temperature=TEMPERATURE, **kw)
    one_sampled = one.generate(batch, n_steps=N_STEPS, key=jrandom.key(3))
    rows, rows_close = state_rows(eng, one)
    static_engines = [ServeEngine(cfg, w, max_len=PROMPT_LEN + N_STEPS + 8,
                                  temperature=TEMPERATURE, device="cpu", serve_mesh=m)
                      for w, m in ((sp, mesh), (params, None))]

    def static_run(i):
        return static_engines[i].generate(batch, n_steps=N_STEPS, key=jrandom.key(1))

    static = static_run(0)
    return dict(span=(eng.split.lo, eng.split.hi, eng.split.size), greedy=greedy.numpy(),
                sampled=sampled.numpy(), one_sampled=one_sampled.numpy(),
                static=static.numpy(), rows=rows, rows_close=rows_close,
                pages_close=pages_close(eng, one),
                flops=(step_flops(eng, sp), step_flops(one, params)),
                static_flops=(flops(lambda: static_run(0)), flops(lambda: static_run(1))))


def prefix_stream(vocab, first_out):
    """Four requests whose prompts all begin with the first request's prompt
    and its first 5 decoded tokens (17 positions: two full pages, positions
    12-15 of the second decoded, and position 16 in a partial one), each
    with a 3-token suffix of its own; 6 new tokens each."""
    rng = np.random.default_rng(7)
    shared = np.concatenate([prompts(vocab, 1)[0], np.asarray(first_out[:5], np.int32)])
    return [np.concatenate([shared, rng.integers(0, vocab, 3).astype(np.int32)])
            for _ in range(SLOTS)]


def serve_prefix(make):
    """The first request alone (slot 0, the first rank's), then the four
    that reach its resident prefix, all at t 0 (slots 0-3, both ranks)."""
    from repro_torch.serve.scheduler import Request

    class Joins:
        slots = []

        def serve_event(self, kind, t, rid, slot):
            if kind == "join":
                self.slots.append(slot)

    eng = make(n_slots=SLOTS, max_len=PREFIX_MAX_LEN, page=PAGE)
    cache = eng.enable_prefix_cache()
    (first,) = eng.serve([Request(prompt=prompts(eng.cfg.vocab, 1)[0], max_new=6)])
    reqs = [Request(prompt=p, max_new=6, arrival=0.0)
            for p in prefix_stream(eng.cfg.vocab, first.out)]
    order = {r.rid: i for i, r in enumerate(reqs)}
    eng.tracer = joins = Joins()
    done = sorted(eng.serve(reqs), key=lambda r: order[r.rid])
    return [list(first.out)] + [list(r.out) for r in done], cache.n_hits, sorted(joins.slots)


def metered(make):
    """Requests of 2 to 6 new tokens served from t 0 with a meter on a
    recording governor: (the meter's slot counts, each step's slack share
    of its span)."""
    from repro_torch.serve.scheduler import Request

    class Phases:
        shares = []

        def on_phase(self, rec):
            if rec.t_copy_end > rec.t_enter:
                self.shares.append((rec.t_slack_end - rec.t_enter)
                                   / (rec.t_copy_end - rec.t_enter))

    eng, gov = make(n_slots=SLOTS, max_len=MAX_LEN, page=PAGE), Phases()
    eng.serve([Request(prompt=p, max_new=2 + i, arrival=0.0)
               for i, p in enumerate(prompts(eng.cfg.vocab))], governor=gov)
    m = eng._last_meter
    return (m.n_steps, m.slot_steps_filled, m.slot_steps_total), gov.shares


def llama_cases(mesh, refs):
    cfg = cfg_of("llama3.2-1b")
    params = bridge.params_from_numpy(cfg, refs["llama3.2-1b", False]["params"], "cpu")
    split, plain, _ = engines(mesh, cfg, params)
    batch = {"tokens": prompts(cfg.vocab, 3)}
    kw = dict(n_slots=3, max_len=MAX_LEN, page=PAGE)
    odd = split(**kw)
    out = {"slack": (metered(split), metered(plain)), "odd": dict(size=odd.split.size, rows=odd.split.rows,
                       tokens=odd.generate(batch, n_steps=N_STEPS).numpy(),
                       one=plain(**kw).generate(batch, n_steps=N_STEPS).numpy())}
    tokens, hits, slots = serve_prefix(split)
    one_tokens, one_hits, _ = serve_prefix(plain)
    out["prefix"] = dict(tokens=tokens, hits=hits, slots=slots, one=one_tokens,
                         one_hits=one_hits)
    qcfg = cfg_of("llama3.2-1b", kv_quant=True)
    qparams = bridge.params_from_numpy(qcfg, refs["llama3.2-1b", True]["params"], "cpu")
    split, plain, _ = engines(mesh, qcfg, qparams)
    kw = dict(n_slots=SLOTS, max_len=MAX_LEN, page=PAGE)
    eng, one = split(**kw), plain(**kw)
    batch = {"tokens": prompts(qcfg.vocab)}
    out["int8"] = dict(tokens=eng.generate(batch, n_steps=N_STEPS).numpy(),
                       one=one.generate(batch, n_steps=N_STEPS).numpy(),
                       pages_close=pages_close(eng, one),
                       int8=eng.pool.blocks["layers"][0]["k_pages"].dtype == torch.int8)
    return out


def split_rank(rank, world, store_path, work_dir):
    init_rank(rank, world, store_path)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.dist import sharding as SH
        from repro_torch.models.hooks import install_constraint

        with open(os.path.join(work_dir, "ref.pkl"), "rb") as f:
            refs = pickle.load(f)
        mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
        install_constraint(SH.activation_constraint_fn(SH.replica_mesh(mesh)))
        try:
            out = {arch: serve_arch(mesh, arch, refs[arch, False]) for arch in ARCHS}
            out.update(llama_cases(mesh, refs))
        finally:
            install_constraint(None)
        with open(os.path.join(work_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# the checks
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("split")
    weights = reference_weights(work)
    ctx = mp.start_processes(split_rank, args=(2, str(work / "store"), str(work)), nprocs=2,
                             join=False, start_method="spawn")
    try:
        refs = reference_tokens(weights)
    finally:
        join(ctx, 2)
    got = []
    for r in range(2):
        with open(work / f"{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return refs, got


@pytest.mark.parametrize("arch", ARCHS)
def test_split_slots_serve_the_references_tokens(two_ranks, arch):
    refs, got = two_ranks
    want = refs[arch, False]
    for r, res in enumerate(got):
        case = res[arch]
        assert case["span"] == (2 * r, 2 * r + 2, 2), case["span"]
        np.testing.assert_array_equal(case["greedy"], want["greedy"], err_msg=f"{arch} {r}")
        np.testing.assert_array_equal(case["sampled"], want["sampled"], err_msg=f"{arch} {r}")
        np.testing.assert_array_equal(case["one_sampled"], want["sampled"], err_msg=arch)
        np.testing.assert_array_equal(case["static"], want["static"], err_msg=f"{arch} {r}")


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_slots_state_and_every_page(two_ranks, arch):
    _, got = two_ranks
    kinds = cfg_of(arch).layer_kinds()
    for r, res in enumerate(got):
        case = res[arch]
        # conv and h of each recurrent layer, 2 rows each
        assert case["rows"] == [2] * 2 * (len(kinds) - kinds.count("attn")), case["rows"]
        assert case["rows_close"] and case["pages_close"], (arch, r)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_rank_runs_its_share_of_the_products(two_ranks, arch):
    _, got = two_ranks
    for res in got:
        split, one = res[arch]["flops"]
        assert one > 0 and 2 * split == one, (arch, split, one)
    ranks, one = zip(*(res[arch]["static_flops"] for res in got))
    assert one[0] == one[1] > 0 and sum(ranks) == one[0], (arch, ranks, one)
    assert max(ranks) < one[0], (arch, ranks)


def test_the_meter_books_the_whole_batch_on_every_rank(two_ranks):
    _, got = two_ranks
    for res in got:
        (counts, shares), (one_counts, one_shares) = res["slack"]
        assert counts == one_counts and counts[0] > 0, (counts, one_counts)
        np.testing.assert_allclose(shares, one_shares, rtol=0, atol=1e-6)   # clock rounding
        assert min(shares) < max(shares)            # underfill as requests finish


def test_a_batch_the_ranks_do_not_divide_replicates(two_ranks):
    _, got = two_ranks
    for res in got:
        odd = res["odd"]
        assert (odd["size"], odd["rows"]) == (1, 3)
        np.testing.assert_array_equal(odd["tokens"], odd["one"])


def test_a_prefix_reached_from_both_ranks_gives_the_one_rank_tokens(two_ranks):
    _, got = two_ranks
    for res in got:
        pre = res["prefix"]
        assert pre["slots"] == [0, 1, 2, 3]
        assert pre["hits"] == pre["one_hits"] == SLOTS
        assert pre["tokens"] == pre["one"]
        assert [len(t) for t in pre["tokens"]] == [6] * (SLOTS + 1)


def test_int8_pages_split_over_the_ranks(two_ranks):
    refs, got = two_ranks
    for r, res in enumerate(got):
        q = res["int8"]
        assert q["int8"] and q["pages_close"], r
        np.testing.assert_array_equal(q["tokens"], refs["llama3.2-1b", True]["greedy"])
        np.testing.assert_array_equal(q["tokens"], q["one"])
