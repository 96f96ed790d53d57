"""Sharding inside a pod on the port (``repro_torch.dist.sharding``,
``repro_torch.models.hooks``, ``repro_torch.launch.mesh``) against the JAX
package, in one process on the CPU.

* Every arch of the registry at full size (shapes only: the reference's
  ``eval_shape``, the port's trees on the ``meta`` device), on the
  reference's ``AbstractMesh`` at (1, 1), (2, 2), (4, 2), (16, 16) and
  ("pod", "data", "model") (2, 16, 16) and a mesh-shaped namespace on the
  port's side: the port's rule functions applied to the reference's
  stacked trees give the reference's specs, compared as whole
  ``PartitionSpec`` s, for ``param_shardings`` (2-d and zero3, with
  ``include_pod`` and ``gather_safe``), ``serve_param_shardings``,
  ``opt_state_shardings``, ``batch_shardings`` (both modes),
  ``cache_shardings`` (with and without ``serve_tp``) and
  ``page_pool_shardings``; each leaf of the port's split layout has its
  stacked counterpart's spec without the stack axis (2-d rules), and in
  zero3 the rule on its own shape (the split layout has no layer axis to
  shard: ROADMAP.md, queue 3).
* The reference's own cases (``tests/test_dist.py``,
  ``tests/test_serve_paged.py::test_page_pool_shardings_rules``, the
  latter with whole specs).
* ``placements()`` on the production meshes of a ``fake`` world of 256 and
  512 ranks, grouped entries included; axes named out of the mesh's order
  refused.
* The hooks: identity when nothing is installed, the port's call sites
  the reference's (plus its own ``tokens``, ``heads:n``, ``groups:n`` and
  ``flat:n``), and ``forward``, ``prefill`` and ``decode_step`` bit-equal
  with and without the constraint installed on plain tensors.
* Every arch of the registry, reduced, served greedy on a one-rank (1, 1)
  gloo mesh, every leaf a DTensor: tokens equal to the plain engine's.
"""
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.dist import sharding as JSH
from repro.models import transformer as JT
from repro.serve import kvcache as JKV
from repro.train import optimizer as JO
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.dist import sharding as SH
from repro_torch.models import hooks
from repro_torch.models import transformer as TT
from repro_torch.serve import kvcache as TKV
from repro_torch.train.optimizer import OptConfig, init_opt_state

MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((4, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def port_mesh(shape, names):
    """The reference's FakeMesh: axis names and a shape mapping."""
    return types.SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))


def specs(tree):
    """{path: spec tuple} of a tree of the port's or the reference's
    NamedShardings (dicts, lists; the reference's keys as they are)."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, (list, tuple)) and not hasattr(t, "spec"):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        elif t is not None:
            out[path] = tuple(t.spec)
    walk(tree, ())
    return out


def assert_same(got, want, what):
    g, w = specs(got), specs(want)
    assert g.keys() == w.keys(), what
    bad = {p: (g[p], w[p]) for p in g if g[p] != w[p]}
    assert not bad, (what, bad)


def meta(tree):
    """A jax shape tree as meta tensors, keys kept."""
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), tree)


def ref_trees(arch):
    jcfg = jget_config(arch)
    key = jax.random.PRNGKey(0)
    params = jax.eval_shape(lambda: JT.init_params(jcfg, key))
    opt = jax.eval_shape(lambda: JO.init_opt_state(
        JT.init_params(jcfg, key), JO.OptConfig()))
    cache = jax.eval_shape(lambda: JT.init_cache(jcfg, 4, 64))
    pool = jax.eval_shape(lambda: JKV.init_pool_blocks(jcfg, 17, 16, 4))
    batch = {"tokens": jax.ShapeDtypeStruct((8, 32), np.int32),
             "labels": jax.ShapeDtypeStruct((8, 32), np.int32),
             "mask": jax.ShapeDtypeStruct((8, 32), np.float32),
             "step": jax.ShapeDtypeStruct((), np.int32)}
    return dict(params=params, opt=opt, cache=cache, pool=pool, batch=batch)


CASES = {
    "param 2d": lambda M, m, t: M.param_shardings(m, t["params"]),
    "param 2d no pod": lambda M, m, t: M.param_shardings(m, t["params"], include_pod=False),
    "param 2d gather-safe": lambda M, m, t: M.param_shardings(m, t["params"], gather_safe=True),
    "param zero3": lambda M, m, t: M.param_shardings(m, t["params"], mode="zero3"),
    "param zero3 no pod": lambda M, m, t: M.param_shardings(m, t["params"], mode="zero3",
                                                          include_pod=False),
    "serve params": lambda M, m, t: M.serve_param_shardings(m, t["params"]),
    "opt state": lambda M, m, t: M.opt_state_shardings(
        m, M.param_shardings(m, t["params"]), t["opt"]),
    "batch 2d": lambda M, m, t: M.batch_shardings(m, t["batch"]),
    "batch zero3": lambda M, m, t: M.batch_shardings(m, t["batch"], mode="zero3"),
    "cache": lambda M, m, t: M.cache_shardings(m, t["cache"]),
    "cache serve_tp": lambda M, m, t: M.cache_shardings(m, t["cache"], serve_tp=True),
    "page pool": lambda M, m, t: M.page_pool_shardings(m, t["pool"]),
    "page pool no tp": lambda M, m, t: M.page_pool_shardings(m, t["pool"], serve_tp=False),
}


# the tree each case's split-layout leaves come from
TREE_OF = {"param": "params", "serve": "params", "opt": "params", "cache": "cache",
           "page": "pool"}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_port_rules_give_the_reference_specs(arch):
    """Every arch at full size: the port's rules on the reference's stacked
    trees equal the reference's specs on every mesh and in every mode; on
    the port's split layout the top-level leaves equal the reference's and
    each layer's leaf takes its stacked counterpart's spec without the
    stack axis, or in zero3 the reference's rule on its own shape."""
    cfg = get_config(arch)
    jt = ref_trees(arch)
    stacked = {k: meta(v) for k, v in jt.items()}
    params = TT.init_params(cfg, torch.Generator(), "meta")
    port = dict(params=params, opt=init_opt_state(params, OptConfig()),
                cache=TT.init_cache(cfg, 4, 64, "meta"),
                pool=TKV.init_pool_blocks(cfg, 17, 16, 4, "meta"))
    for shape, names in MESHES:
        jm, pm = AbstractMesh(shape, names), port_mesh(shape, names)
        for name, case in CASES.items():
            want = case(JSH, jm, jt)
            assert_same(case(SH, pm, stacked), want, (arch, shape, name))
            if name.startswith("batch"):
                continue                     # a batch has one layout in both packages
            got = case(SH, pm, port)
            if name == "opt state":
                assert specs(got["step"]) == specs(want["step"]) == {(): ()}
                got, want = got["m"], want["m"]
            for top in ("embed", "head", "final_norm"):
                assert (top in got) == (top in want), (arch, name, top)
                if top in got:
                    assert specs(got[top]) == specs(want[top]), (arch, shape, name, top)
            zero3 = name.startswith("param zero3")
            axes = tuple(a for a in names if "no pod" not in name or a != "pod")
            tree = port[TREE_OF[name.split()[0]]]
            for (group, j, i), layer, sh in zip(bridge._layer_places(cfg), tree["layers"],
                                                 got["layers"]):
                ref = want[group][j]
                for path, spec in specs(sh).items():
                    leaf, w = layer, ref
                    for k in path:
                        leaf, w = leaf[k], w[k]
                    if zero3:
                        assert spec == tuple(JSH._zero3_spec(jm, tuple(leaf.shape), axes)), \
                            (arch, shape, name, path)
                    else:
                        assert (None,) * (i is not None) + spec == tuple(w.spec), \
                            (arch, shape, name, path)


def test_zero3_split_layout_shards_another_dim_than_the_stacked_one():
    """Kept apart (ROADMAP.md, queue 3): on a (2, 2) mesh the reference's
    zero3 shards a llama matrix's stacked layer axis (16 layers over 4
    ranks); the port's per-layer leaf has no such axis and shards its first
    dim the product divides."""
    cfg = get_config("llama3.2-1b")
    jt = ref_trees("llama3.2-1b")
    port = TT.init_params(cfg, torch.Generator(), "meta")
    jm, pm = AbstractMesh((2, 2), ("data", "model")), port_mesh((2, 2), ("data", "model"))
    want = JSH.param_shardings(jm, jt["params"], mode="zero3")["stack"]["0"]["attn"]["wq"]
    got = SH.param_shardings(pm, port, mode="zero3")["layers"][0]["attn"]["wq"]
    assert tuple(want.spec) == (("data", "model"), None, None)
    assert tuple(got.spec) == (("data", "model"), None)
    assert tuple(SH.param_shardings(pm, meta(jt["params"]), mode="zero3")
                 ["stack"]["0"]["attn"]["wq"].spec) == tuple(want.spec)


# --------------------------------------------------------------------------
# the reference's own cases, on the port
# --------------------------------------------------------------------------

def test_sanitize_spec_drops_nondividing_axes():
    P = SH.P
    mesh1 = port_mesh((1,), ("data",))
    assert SH.sanitize_spec(mesh1, P("data"), (7,)) == P("data")

    class FakeMesh:
        axis_names = ("data", "model")
        shape = {"data": 4, "model": 2}

    fm = FakeMesh()
    assert SH.sanitize_spec(fm, P("data", "model"), (8, 6)) == P("data", "model")
    assert SH.sanitize_spec(fm, P("data", "model"), (7, 6)) == P(None, "model")
    assert SH.sanitize_spec(fm, P(("data", "model"), None), (16, 3)) == P(("data", "model"), None)
    assert SH.sanitize_spec(fm, P(("data", "model"), None), (4, 3)) == P(None, None)
    assert P(("data",)) == P("data") and P("a", None) != P("a")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_shardings_cover_every_leaf(arch):
    mesh = port_mesh((1, 1), ("data", "model"))
    cfg = reduced(get_config(arch))
    params = TT.init_params(cfg, torch.Generator(), "meta")
    sh = SH.param_shardings(mesh, params)
    n_leaves = len(specs(sh))
    assert n_leaves == sum(1 for _ in TT.leaves(params))


def test_matrix_params_are_2d_sharded_on_production_spec():
    P = SH.P
    assert SH._param_spec("w1", 2, "data") == P("data", "model")
    assert SH._param_spec("w2", 3, ("pod", "data")) == P(None, "model", ("pod", "data"))
    assert tuple(JSH._param_spec("w2", 3, ("pod", "data"))) == \
        tuple(SH._param_spec("w2", 3, ("pod", "data")))


def test_page_pool_shardings_rules():
    """The reference's case with whole specs (its raw entry check reads
    ``'data'`` under jax 0.9, which normalises ``("data",)``): page arrays
    split their KV-head dim over 'model', per-slot state its slot dim over
    the data axes."""
    P = SH.P
    mesh = port_mesh((1, 1), ("data", "model"))
    cfg = reduced(get_config("llama3.2-1b"))
    attn = TKV.PagedKVPool(cfg, n_slots=2, max_len=32, page=8, device="cpu").blocks
    sh = SH.page_pool_shardings(mesh, attn)
    assert sh["layers"][0]["k_pages"].spec == P(None, None, "model", None)
    cfg_ssm = reduced(get_config("mamba2-130m"))
    state = TKV.PagedKVPool(cfg_ssm, n_slots=2, max_len=32, page=8, device="cpu").blocks
    sh = SH.page_pool_shardings(mesh, state)
    assert sh["layers"][0]["conv"].spec == P("data", None, "model")
    # and the reference's stacked tree, through the reference's own rules
    jm = AbstractMesh((1, 1), ("data", "model"))
    jcfg = jreduced(jget_config("mamba2-130m"))
    jstate = jax.eval_shape(lambda: JKV.init_pool_blocks(jcfg, 9, 8, 2))
    assert JSH.page_pool_shardings(jm, jstate)["stack"]["0"]["conv"].spec == \
        JP(None, "data", None, "model")
    assert SH.page_pool_shardings(mesh, meta(jstate))["stack"]["0"]["conv"].spec == \
        P(None, "data", None, "model")


# --------------------------------------------------------------------------
# placements on the production meshes
# --------------------------------------------------------------------------

@pytest.fixture
def fake_world():
    """A ``fake`` default group of the asked size, torn down after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    made = []

    def make(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
        made.append(n)

    yield make
    if made:
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_placements_on_the_production_mesh(fake_world, multi_pod):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_production_mesh

    P = SH.P
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod else ("data", "model"))
    assert tuple(mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16))
    cfg = get_config("llama3.2-1b")
    params = TT.init_params(cfg, torch.Generator(), "meta")
    sh = SH.param_shardings(mesh, params)
    wq = sh["layers"][0]["attn"]["wq"]
    embed = sh["embed"]
    if multi_pod:
        assert wq.spec == P(("pod", "data"), "model")
        assert wq.placements() == (Shard(0), Shard(0), Shard(1))
        assert embed.placements() == (Shard(1), Shard(1), Shard(0))
        no_pod = SH.param_shardings(mesh, params, include_pod=False)["layers"][0]["attn"]["wq"]
        assert no_pod.placements() == (Replicate(), Shard(0), Shard(1))
        with pytest.raises(ValueError, match="order"):
            SH.NamedSharding(mesh, P(("data", "pod"), None)).placements()
    else:
        assert wq.spec == P("data", "model")
        assert wq.placements() == (Shard(0), Shard(1))
        assert embed.placements() == (Shard(1), Shard(0))
    assert sh["final_norm"]["scale"].placements() == (Replicate(),) * mesh.ndim
    # zero3: 128256 vocab rows split 256 ways; over 512 ranks the first
    # dim the product divides is d (2048)
    zero3 = SH.param_shardings(mesh, params, mode="zero3")["embed"]
    assert zero3.placements() == (Shard(1 if multi_pod else 0),) * mesh.ndim
    with pytest.raises(ValueError, match="ranks"):
        make_production_mesh(multi_pod=not multi_pod)


def test_make_host_mesh_follows_the_reference_degree_rule(fake_world):
    from repro_torch.launch.mesh import make_host_mesh

    fake_world(12)
    for k, want in ((1, (12, 1)), (2, (6, 2)), (5, (3, 4)), (16, (1, 12))):
        assert tuple(make_host_mesh(k).shape) == want, k
    mesh = make_host_mesh(2, pods=2)
    assert mesh.mesh_dim_names == ("pod", "data", "model") and tuple(mesh.shape) == (2, 3, 2)


# --------------------------------------------------------------------------
# the launchers
# --------------------------------------------------------------------------

@pytest.fixture
def gloo_world():
    """A ``gloo`` default group of one rank, torn down after."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", list(ARCHS))
def test_every_family_serves_sharded_on_a_one_rank_mesh(arch, gloo_world):
    """Tensor-parallel serving takes every arch of the registry: each reduced
    arch served greedy by the sharded code path on a one-rank (1, 1) gloo
    mesh (weights on ``serve_param_shardings``, the pool on
    ``page_pool_shardings``, the hooks installed; the kernels' plain
    versions on local shards), its tokens equal to the plain engine's."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.serve.engine import ContinuousEngine
    from repro_torch.tree import leaves

    cfg = reduced(get_config(arch))
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)}
    if cfg.n_prefix:
        batch["prefix_embeds"] = rng.normal(0, 0.02, (2, cfg.n_prefix, cfg.d_model)).astype(
            np.float32)

    def engine(p):
        return ContinuousEngine(cfg, p, n_slots=2, max_len=32, page=8, device="cpu",
                                attn_kernel="cuda")

    plain = engine(params).generate(batch, n_steps=4)
    mesh = SH.replica_mesh(init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model")))
    hooks.install_constraint(SH.activation_constraint_fn(mesh))
    try:
        eng = engine(SH.distribute(params, SH.serve_param_shardings(mesh, params)))
        eng.pool.blocks = SH.distribute(eng.pool.blocks,
                                        SH.page_pool_shardings(mesh, eng.pool.blocks))
        sharded = eng.generate(batch, n_steps=4)
    finally:
        hooks.install_constraint(None)
    assert eng.mesh is mesh
    assert all(isinstance(t, DTensor) for t in leaves(eng.params) + leaves(eng.pool.blocks))
    np.testing.assert_array_equal(sharded.numpy(), plain.numpy())


def test_live_events_takes_model_parallel_1_with_the_references_warning(capsys):
    from repro_torch.launch import train as ltrain

    res = ltrain.main(["--reduced", "--steps", "1", "--device", "cpu", "--live-events",
                       "--model-parallel", "2"])
    assert res["step"] == "build_live" and res["mesh"] == [1, 1]
    out = capsys.readouterr().out
    assert "live_events_dp_only model_parallel=2 using=1" in out, out


# --------------------------------------------------------------------------
# the hooks
# --------------------------------------------------------------------------

def test_constrain_is_identity_with_nothing_installed():
    x = torch.randn(2, 3, 4)
    hooks.install_constraint(None)
    assert hooks.constrain(x, "residual") is x
    fn = SH.activation_constraint_fn(port_mesh((2, 2), ("data", "model")))
    for name in ("residual", "logits", "tokens", "heads:4", "groups:2", "flat:4", "lookup",
                 "other"):
        assert fn(x, name) is x                # a plain tensor passes through


def record_hooks(mod, run):
    names = []

    def fn(x, name):
        names.append(name)
        return x

    mod.install_constraint(fn)
    try:
        out = run()
    finally:
        mod.install_constraint(None)
    return names, out


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-2b", "mamba2-130m"])
def test_hook_sites_are_the_references(arch):
    """The port's ``forward``, ``prefill`` and ``decode_step`` call the hook
    with the reference's names in the reference's order, plus the port's
    own ``tokens``, ``heads:n``, ``groups:n`` and ``flat:n`` and the
    residual after the embedding in prefill and decode; with a recording
    hook installed the results are bit-equal to those with none."""
    import dataclasses

    from repro.models import hooks as jhooks
    from repro.models.inputs import make_batch as jmake_batch

    # no scan and no remat: the reference runs every layer's Python (a
    # checkpointed period is traced once and reused)
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), scan_layers=False, remat=False)
    cfg = dataclasses.replace(reduced(get_config(arch)), scan_layers=False, remat=False)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    batch = jmake_batch(jcfg, batch=1, seq_len=8, kind="train")
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    own = ("tokens", "heads:", "groups:", "flat:")

    jnames, _ = record_hooks(jhooks, lambda: JT.loss_fn(jcfg, jp, batch))
    tnames, (tl, _) = record_hooks(hooks, lambda: TT.loss_fn(cfg, tp, tb))
    assert [n for n in tnames if not n.startswith(own)] == jnames
    assert tnames.count(f"flat:{cfg.ssm_heads}") == cfg.layer_kinds().count("ssm")
    assert torch.equal(tl, TT.loss_fn(cfg, tp, tb)[0])

    jnames, _ = record_hooks(jhooks, lambda: JT.prefill(
        jcfg, jp, {"tokens": batch["tokens"]}, JT.init_cache(jcfg, 1, 16)))
    cache = TT.init_cache(cfg, 1, 16, "cpu")
    tnames, (logits, _) = record_hooks(hooks, lambda: TT.prefill(
        cfg, tp, {"tokens": tb["tokens"]}, cache))
    assert [n for n in tnames if not n.startswith(own)] == ["residual"] + jnames
    cache2 = TT.init_cache(cfg, 1, 16, "cpu")
    assert torch.equal(logits, TT.prefill(cfg, tp, {"tokens": tb["tokens"]}, cache2)[0])
    tok = torch.argmax(logits, -1).to(torch.int32)
    tnames, (dl, _) = record_hooks(hooks, lambda: TT.decode_step(cfg, tp, tok, 8, cache))
    assert [n for n in tnames if not n.startswith(own)] == ["residual"]
    assert torch.equal(dl, TT.decode_step(cfg, tp, tok, 8, cache2)[0])
    want_own = {"attn": 3 + 1, "rglru": 0, "ssm": 0}      # q, k, v heads; GQA groups
    n_own = sum(want_own[k] for k in cfg.layer_kinds())
    assert sum(n.startswith(("heads:", "groups:")) for n in tnames) == n_own


def test_embedding_and_nll_are_bit_equal_to_indexing_and_the_old_order():
    """``F.embedding`` returns the rows indexing returned; the NLL with the
    label's logit subtracted before its axis is dropped is the old
    ``logsumexp - gather[..., 0]`` bit for bit."""
    g = torch.Generator().manual_seed(0)
    table = torch.randn(50, 8, generator=g)
    tokens = torch.randint(0, 50, (3, 7), generator=g)
    assert torch.equal(torch.nn.functional.embedding(tokens, table), table[tokens])
    logits = torch.randn(3, 7, 50, generator=g)
    labels = torch.randint(0, 50, (3, 7), generator=g)
    from repro_torch.models import layers as L

    old = torch.logsumexp(logits, -1) - torch.gather(logits, -1, labels[..., None])[..., 0]
    assert torch.equal(L._nll(logits, labels), old)
