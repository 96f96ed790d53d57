"""The dry run (``repro_torch.launch.dryrun``) and what it builds on: the
input specs, ``make_serve_steps`` and the per-rank counts, against the
reference's ``repro.launch.dryrun``.

* The port's input specs have the reference's shapes and dtypes for every
  arch x shape; ``make_serve_steps`` gives the reference's logits on
  reduced llama3.2-1b (2e-5).
* Per-rank memory, each side in its own subprocess (the port's cells over a
  fake world of 8 ranks; the reference's compiled over 8 of its 512
  emulated devices, ``get_config`` and ``SHAPES`` patched into its
  module's namespace): ``argument_bytes`` equal the reference's
  ``memory_analysis()`` in every cell, and so do ``output_bytes`` and
  ``alias_bytes`` (serving cells and train cells alike: the train
  metrics are the reference's five fp32 scalars, 20 bytes, on both
  sides).  The figures are pinned too.  The port's multi-pod barrier cell
  on (2, 2, 2) is held to the arithmetic of its specs (the reference's
  aborts in XLA's SPMD partitioner on jax 0.9).
* The ring wire model against the reference's ``parse_collectives`` on one
  synthetic HLO line of each kind; the FLOPs of one product equal 2·m·k·n
  of its local shapes; a (1, 1) cell's FLOPs equal ``FlopCounterMode``
  over the same step on plain CPU tensors.
* The port's ``temp_bytes`` of those cells are pinned; a second count of
  a cell in the same process equals the first; a count that recognises no
  run of DTensor's sharding propagation raises.
* ``--list`` prints the reference's cells in the reference's order; one
  full-width CLI cell writes a record with the reference's keys.
* The other families' reduced cells, each side in its own subprocess:
  granite-moe-3b-a800m's train and tensor-parallel decode cells on (2, 4)
  and a mamba2-130m whose model axis of 8 cuts its 64-wide heads, on
  (2, 8): argument, output and alias bytes equal the reference's, temp
  bytes pinned; the cut-head cell fails without the ``flat:n`` hook.

The reference's dry-run module sets ``XLA_FLAGS`` when it is imported, so
it is imported in subprocesses only.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
ARCH = "llama3.2-1b"

# name -> (kind, seq_len, batch, mesh shape, build_cell options); the cache
# of a serving cell holds seq_len positions
CELLS = {
    "train": ("train", 32, 8, (2, 4), {}),
    "prefill": ("prefill", 32, 8, (2, 4), {}),
    "decode": ("decode", 64, 8, (2, 4), {}),
    "decode_serve_tp": ("decode", 64, 8, (2, 4), {"serve_tp": True}),
    "train_zero3": ("train", 32, 8, (2, 4), {"zero3": True}),
}
# the reference's memory_analysis().argument_size_in_bytes of each cell
ARGUMENT_BYTES = {"train": 612612, "prefill": 87808, "decode": 153364,
                  "decode_serve_tp": 239380, "train_zero3": 603620}
# the port's temp_bytes of each cell (XLA's buffer assigner has no
# counterpart): pinned, so that a count that takes DTensor's global-shape
# propagation runs for the rank's own shows
TEMP_BYTES = {"train": 1381892, "prefill": 361088, "decode": 215040,
              "decode_serve_tp": 427008, "train_zero3": 1180948}


# the other families' reduced cells: name -> (arch, config overrides, kind,
# seq_len, batch, mesh shape, build_cell options).  mamba2 with 64-wide heads
# (4 heads of d_inner 256) on a model axis of 8 cuts a head: the flatten of
# the SSD's output views its gradient's 32-column split as heads
FAMILY_CELLS = {
    "granite_train": ("granite-moe-3b-a800m", {}, "train", 32, 8, (2, 4), {}),
    "granite_decode_serve_tp": ("granite-moe-3b-a800m", {}, "decode", 64, 8, (2, 4),
                                {"serve_tp": True}),
    "mamba2_cut_head_train": ("mamba2-130m", {"ssm_d_head": 64}, "train", 32, 16, (2, 8), {}),
}
# (granite_train: the reference's memory_analysis() gives 1692264; the
# port's MoE layer exchanges its kept rows and holds only its own slots)
FAMILY_TEMP_BYTES = {"granite_train": 1499352, "granite_decode_serve_tp": 427008,
                     "mamba2_cut_head_train": 6209884}


def run_script(code, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


REFERENCE = textwrap.dedent("""
    import json, sys
    import repro.launch.dryrun as D
    import jax
    from repro.configs import get_config, reduced
    from repro.configs.base import ShapeConfig
    from repro.dist import sharding as SH
    from repro.dist.compat import set_mesh
    from repro.models.hooks import install_constraint

    shapes = D.SHAPES
    D.get_config = lambda a: reduced(get_config(a))
    out = {"memory": {}}
    for name, (kind, seq, batch, shape, opts) in CELLS.items():
        D.SHAPES = {name: ShapeConfig(name, seq, batch, kind)}
        axes = ("data", "model")
        mesh = jax.make_mesh(shape, axes, axis_types=(jax.sharding.AxisType.Auto,) * 2)
        install_constraint(SH.activation_constraint_fn(
            mesh, mode="zero3" if opts.get("zero3") else "2d"))
        with set_mesh(mesh):
            fn, args, ins, outs, donate = D.build_cell(ARCH, name, mesh, **opts)
            ma = (jax.jit(fn, in_shardings=ins, out_shardings=outs, donate_argnums=donate)
                  .lower(*args).compile().memory_analysis())
        out["memory"][name] = {"argument_bytes": ma.argument_size_in_bytes,
                               "output_bytes": ma.output_size_in_bytes,
                               "alias_bytes": ma.alias_size_in_bytes}
    install_constraint(None)
    D.SHAPES = shapes
    lines = {
        "all-reduce": "%ar = f32[1024]{0} all-reduce(f32[1024]{0} %p), replica_groups={{0,1,2,3}}, to_apply=%add",
        "all-gather": "%ag = bf16[8,256]{1,0} all-gather(bf16[2,256]{1,0} %p), replica_groups={{0,1,2,3}}, dimensions={0}",
        "reduce-scatter": "%rs = f32[64]{0} reduce-scatter(f32[256]{0} %p), replica_groups=[2,4]<=[8], dimensions={0}, to_apply=%add",
        "all-to-all": "%aa = f32[4,32]{1,0} all-to-all(f32[4,32]{1,0} %p), replica_groups={{0,1,2,3}}, dimensions={0}",
        "collective-permute": "%cp = s32[16]{0} collective-permute(s32[16]{0} %p), source_target_pairs={{0,1},{1,0}}",
    }
    out["wire"] = {k: D.parse_collectives(v)[k] for k, v in lines.items()}
    out["keys"] = sorted(["arch", "shape", "mesh", "tag", "instrument", "status",
                          "compile_scan_s", "n_devices", "memory", "compile_unroll_s", "cost",
                          "collectives", "traffic", "hlo_bytes"])
    out["collective_ops"] = list(D.COLLECTIVE_OPS)
    lists = []
    for argv in (["--list"], ["--list", "--all", "--mesh", "both"],
                 ["--list", "--arch", "olmo-1b", "--mesh", "multipod"]):
        import io, contextlib
        buf = io.StringIO()
        sys.argv = ["dryrun"] + argv
        with contextlib.redirect_stdout(buf):
            D.main()
        lists.append(buf.getvalue())
    out["lists"] = lists
    print(json.dumps(out))
""").replace("CELLS", repr(CELLS)).replace("ARCH", repr(ARCH))


PORT = textwrap.dedent("""
    import json
    import torch
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import instrument
    from repro_torch.dist import sharding as SH
    from repro_torch.launch import dryrun as D
    from repro_torch.models.hooks import install_constraint
    from repro_torch.models.inputs import make_batch
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.serve.engine import make_serve_steps
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptConfig, init_opt_state

    D.get_config = lambda a: reduced(get_config(a))
    cfg = D.production_config(ARCH)
    out = {"cells": {}}
    D.fake_world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    for name, (kind, seq, batch, shape, opts) in CELLS.items():
        install_constraint(SH.activation_constraint_fn(
            mesh, mode="zero3" if opts.get("zero3") else "2d"))
        fn, args = D.build_cell(ARCH, ShapeConfig(name, seq, batch, kind), mesh, **opts)
        out["cells"][name] = D.count_step(fn, args, cfg)
    # the decode cell again in this process, DTensor's caches warm
    install_constraint(SH.activation_constraint_fn(mesh))
    kind, seq, batch, _, _ = CELLS["decode"]
    fn, args = D.build_cell(ARCH, ShapeConfig("decode", seq, batch, kind), mesh)
    out["decode_again"] = D.count_step(fn, args, cfg)["memory"]
    # a propagator the counter no longer recognises fails the count
    found = D._in_sharding_propagation
    D._in_sharding_propagation = lambda: False
    try:
        D.count_step(fn, args, cfg)
        out["unrecognised"] = None
    except RuntimeError as e:
        out["unrecognised"] = str(e)
    finally:
        D._in_sharding_propagation = found
    install_constraint(None)

    # one product of known local shapes: (8,16) rows over data @ (16,32)
    # columns over model -> a (4,16) @ (16,8) product on each rank
    a = distribute_tensor(torch.empty(8, 16, device="meta"), mesh, (Shard(0), Replicate()))
    b = distribute_tensor(torch.empty(16, 32, device="meta"), mesh, (Replicate(), Shard(1)))
    out["product"] = D.count_step(lambda a, b: a @ b, (a, b))["cost"]["flops"]
    with FlopCounterMode(display=False) as fc:
        a @ b
    out["product_global"] = fc.get_total_flops()

    # the multi-pod barrier cell on (2, 2, 2)
    D.fake_world(8)
    pmesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    install_constraint(SH.activation_constraint_fn(pmesh))
    instrument.set_mode("barrier")
    fn, args = D.build_cell(ARCH, ShapeConfig("t", 32, 8, "train"), pmesh)
    out["multipod"] = D.count_step(fn, args, cfg)
    out["multipod_placements"] = sorted({str(p.placements) for p in
                                         args[0]["params"]["layers"][0]["attn"].values()})
    instrument.set_mode("off")
    install_constraint(None)

    # a (1, 1) cell against FlopCounterMode over the same step on plain CPU
    # tensors
    one = DeviceMesh("cpu", torch.tensor([[0]]), mesh_dim_names=("data", "model"))
    install_constraint(SH.activation_constraint_fn(one))
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, "cpu")
    out["one"] = {}
    for name, (kind, seq, batch) in {"train": ("train", 32, 4), "prefill": ("prefill", 32, 4),
                                      "decode": ("decode", 64, 4)}.items():
        fn, args = D.build_cell(ARCH, ShapeConfig(name, seq, batch, kind), one)
        counted = D.count_step(fn, args, cfg)["cost"]["flops"]
        prefill, decode = make_serve_steps(cfg)
        b = make_batch(cfg, batch, seq, kind="train" if kind == "train" else "prefill")
        cache = init_cache(cfg, batch, seq, "cpu")
        with FlopCounterMode(display=False) as fc:
            if kind == "train":
                make_train_step(cfg, OptConfig())(
                    {"params": params, "opt": init_opt_state(params, OptConfig())}, b)
            elif kind == "prefill":
                prefill(params, b, cache)
            else:
                decode(params, b["tokens"][:, 0], torch.tensor(seq - 1, dtype=torch.int32),
                       cache)
        out["one"][name] = [counted, fc.get_total_flops()]
    install_constraint(None)
    print(json.dumps(out))
""").replace("CELLS", repr(CELLS)).replace("ARCH", repr(ARCH))


FAMILY_REFERENCE = textwrap.dedent("""
    import json
    import repro.launch.dryrun as D
    import jax
    from repro.configs import get_config, reduced
    from repro.configs.base import ShapeConfig
    from repro.dist import sharding as SH
    from repro.dist.compat import set_mesh
    from repro.models.hooks import install_constraint

    out = {}
    for name, (arch, mods, kind, seq, batch, shape, opts) in CELLS.items():
        D.get_config = lambda a, mods=mods: reduced(get_config(a), **mods)
        D.SHAPES = {name: ShapeConfig(name, seq, batch, kind)}
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        install_constraint(SH.activation_constraint_fn(mesh))
        with set_mesh(mesh):
            fn, args, ins, outs, donate = D.build_cell(arch, name, mesh, **opts)
            ma = (jax.jit(fn, in_shardings=ins, out_shardings=outs, donate_argnums=donate)
                  .lower(*args).compile().memory_analysis())
        out[name] = {"argument_bytes": ma.argument_size_in_bytes,
                     "output_bytes": ma.output_size_in_bytes,
                     "alias_bytes": ma.alias_size_in_bytes}
    install_constraint(None)
    print(json.dumps(out))
""").replace("CELLS", repr(FAMILY_CELLS))


FAMILY_PORT = textwrap.dedent("""
    import json
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import sharding as SH
    from repro_torch.launch import dryrun as D
    from repro_torch.models.hooks import install_constraint

    out = {}
    for name, (arch, mods, kind, seq, batch, shape, opts) in CELLS.items():
        D.get_config = lambda a, mods=mods: reduced(get_config(a), **mods)
        cfg = D.production_config(arch)
        D.fake_world(shape[0] * shape[1])
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        constrain = SH.activation_constraint_fn(mesh)
        install_constraint(constrain)
        fn, args = D.build_cell(arch, ShapeConfig(name, seq, batch, kind), mesh, **opts)
        out[name] = D.count_step(fn, args, cfg)["memory"]
        if arch == "mamba2-130m":
            # the same cell with the flatten's hook left out fails in the backward
            install_constraint(lambda x, n: x if n.startswith("flat:") else constrain(x, n))
            fn, args = D.build_cell(arch, ShapeConfig(name, seq, batch, kind), mesh, **opts)
            try:
                D.count_step(fn, args, cfg)
                out["without_flat"] = None
            except RuntimeError as e:
                out["without_flat"] = str(e)
    install_constraint(None)
    print(json.dumps(out))
""").replace("CELLS", repr(FAMILY_CELLS))


@pytest.fixture(scope="module")
def reference():
    return run_script(REFERENCE)


@pytest.fixture(scope="module")
def port():
    return run_script(PORT)


@pytest.fixture(scope="module")
def family_reference():
    return run_script(FAMILY_REFERENCE)


@pytest.fixture(scope="module")
def family_port():
    return run_script(FAMILY_PORT)


# --------------------------------------------------------------------------
# input specs and serve steps
# --------------------------------------------------------------------------

def _archs():
    from repro_torch.configs import ARCHS

    return list(ARCHS)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", _archs())
def test_input_specs_equal_the_reference(arch, shape):
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config
    from repro.models import inputs as JI

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models import inputs as TI

    jcfg, tcfg = jget_config(arch), get_config(arch)
    jspecs = JI.input_specs(jcfg, JSHAPES[shape])
    tspecs = TI.input_specs(tcfg, SHAPES[shape])
    assert list(tspecs) == list(jspecs)
    for k, js in jspecs.items():
        t = tspecs[k]
        assert t.is_meta and tuple(t.shape) == tuple(js.shape), k
        assert str(t.dtype).replace("torch.", "") == str(js.dtype), k
    jt, jp = JI.decode_inputs_specs(jcfg, JSHAPES[shape], batch_override=3)
    tt, tp = TI.decode_inputs_specs(tcfg, SHAPES[shape], batch_override=3)
    assert tuple(tt.shape) == jt.shape == (3,) and tuple(tp.shape) == jp.shape == ()
    assert tt.dtype == tp.dtype == torch.int32


def test_make_serve_steps_equal_the_reference():
    import jax

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import transformer as JT
    from repro.models.inputs import make_batch as jmake_batch
    from repro.serve.engine import make_serve_steps as jmake_serve_steps

    from repro_torch import bridge
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import init_cache
    from repro_torch.serve import make_serve_steps

    jcfg, tcfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    jb = jmake_batch(jcfg, batch=2, seq_len=12, kind="prefill")
    jpre, jdec = jmake_serve_steps(jcfg)
    tpre, tdec = make_serve_steps(tcfg)
    jl, jc = jax.jit(jpre)(jp, jb, JT.init_cache(jcfg, 2, 16))
    tl, tc = tpre(tp, {"tokens": torch.from_numpy(np.asarray(jb["tokens"]))},
                  init_cache(tcfg, 2, 16, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5, atol=2e-5)
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    jl2, _ = jax.jit(jdec)(jp, tok, np.int32(12), jc)
    tl2, _ = tdec(tp, torch.from_numpy(tok), 12, tc)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=2e-5, atol=2e-5)
    assert not tl2.requires_grad


# --------------------------------------------------------------------------
# per-rank memory against the reference's memory_analysis()
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cell", list(CELLS))
def test_per_rank_bytes_equal_the_reference(cell, reference, port):
    ref = reference["memory"][cell]
    got = port["cells"][cell]["memory"]
    assert ref["argument_bytes"] == ARGUMENT_BYTES[cell]
    for key in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert got[key] == ref[key], (cell, key, got, ref)
    assert got["temp_bytes"] > 0
    assert got["peak_args_plus_temp"] == (got["argument_bytes"] + got["temp_bytes"]
                                          + got["output_bytes"] - got["alias_bytes"])
    if CELLS[cell][0] == "prefill":
        # the cache is written whole before it is read: output only
        assert got["alias_bytes"] == 0


def test_temp_bytes_are_pinned_and_the_propagator_recognised(port):
    assert {c: port["cells"][c]["memory"]["temp_bytes"] for c in CELLS} == TEMP_BYTES
    # a second count in the same process (DTensor's caches warm) is the same
    assert port["decode_again"] == port["cells"]["decode"]["memory"]
    # a count that recognises no propagation run fails, where it would
    # have counted those runs as the rank's
    assert "sharding-propagation runs was recognised" in port["unrecognised"]


@pytest.mark.parametrize("cell", list(FAMILY_CELLS))
def test_other_families_per_rank_bytes_equal_the_reference(cell, family_reference,
                                                           family_port):
    """MoE (its dispatch on local tensors) and an SSM whose model degree cuts
    a head: the port's per-rank argument, output and alias bytes equal the
    reference's ``memory_analysis()``, and its temp bytes are pinned."""
    ref, got = family_reference[cell], family_port[cell]
    for key in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert got[key] == ref[key], (cell, key, got, ref)
    assert got["temp_bytes"] == FAMILY_TEMP_BYTES[cell], (cell, got)


def test_the_cut_head_cell_needs_the_flatten_hook(family_port):
    """Without the ``flat:n`` hook the cut-head cell's backward fails to view
    the gradient's split as heads: the cell exercises the hook."""
    assert "Cannot unflatten unevenly sharded tensor" in family_port["without_flat"]


def _local_bytes(tree, shardings, sizes):
    """Bytes a rank holds of ``tree`` under ``shardings``, from the specs."""
    from repro_torch.tree import leaves

    total = 0
    for x, sh in zip(leaves(tree), leaves(shardings)):
        n = x.numel() * x.element_size()
        for entry in tuple(sh.spec):
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis is not None:
                    n //= sizes[axis]
        total += n
    return total


def test_multipod_barrier_cell_holds_the_arithmetic_of_its_specs(port):
    import dataclasses
    from types import SimpleNamespace

    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import sharding as SH
    from repro_torch.models.inputs import input_specs
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(reduced(get_config(ARCH)), param_dtype="bfloat16",
                              compute_dtype="bfloat16", pad_vocab_to=256)
    sizes = {"pod": 2, "data": 2, "model": 2}
    mesh = SimpleNamespace(axis_names=("pod", "data", "model"), shape=sizes)
    params = init_params(cfg, torch.Generator(), "meta")
    opt = init_opt_state(params, OptConfig())
    batch = input_specs(cfg, ShapeConfig("t", 32, 8, "train"))
    ps = SH.param_shardings(mesh, params, include_pod=False, gather_safe=True)
    want = (_local_bytes(params, ps, sizes)
            + _local_bytes(opt, SH.opt_state_shardings(mesh, ps, opt), sizes)
            + _local_bytes(batch, SH.batch_shardings(mesh, batch), sizes))
    got = port["multipod"]
    assert got["memory"]["argument_bytes"] == want
    # the state is updated in place: every state byte is an alias
    state = want - _local_bytes(batch, SH.batch_shardings(mesh, batch), sizes)
    assert got["memory"]["alias_bytes"] == state
    # FSDP over data only (gather_safe), whole over pod and model
    assert port["multipod_placements"] == ["(Replicate(), Shard(dim=0), Replicate())",
                                           "(Replicate(), Shard(dim=1), Replicate())"]
    # one cd_psum: an all-reduce a gradient leaf over the 2 pods, and the
    # artificial barrier's 1-element all-reduce
    ar = got["collectives"]["all-reduce"]
    assert ar["count"] >= len(leaves(params)) + 1
    assert got["cost"]["flops"] > 0


# --------------------------------------------------------------------------
# the counts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_wire_model_equals_the_reference_parse(kind, reference):
    from repro_torch.launch.dryrun import COLLECTIVE_OPS, wire_bytes

    assert list(COLLECTIVE_OPS) == reference["collective_ops"]
    rec = reference["wire"][kind]
    assert rec["count"] == 1
    # every synthetic line's group has 4 ranks (a permute has no group)
    assert wire_bytes(kind, rec["result_bytes"], 4) == rec["wire_bytes"]


def test_product_flops_are_those_of_its_local_shapes(port):
    assert port["product"] == 2 * 4 * 16 * 8
    assert port["product_global"] == 2 * 8 * 16 * 32      # FlopCounterMode over DTensor


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_one_rank_flops_equal_flop_counter_on_plain_tensors(kind, port):
    counted, plain = port["one"][kind]
    assert counted == plain > 0


def test_cell_flops_and_collectives_are_per_rank(port):
    cells = port["cells"]
    for name, c in cells.items():
        assert c["cost"]["flops"] > 0, name
        assert c["traffic"]["traffic_bytes"] == (c["traffic"]["tensor_bytes"]
                                                 + c["memory"]["argument_bytes"])
        assert c["cost"]["bytes_accessed"] == c["traffic"]["traffic_bytes"]
    # the 2-D train step moves parameters and gradients: gathers and
    # reduce-scatters inside the (2, 4) mesh
    coll = cells["train"]["collectives"]
    assert coll["all-gather"]["count"] > 0 and coll["reduce-scatter"]["count"] > 0


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def test_list_prints_the_reference_cells_in_order(reference, capsys):
    from repro_torch.launch import dryrun as D

    for argv, want in zip((["--list"], ["--list", "--all", "--mesh", "both"],
                           ["--list", "--arch", "olmo-1b", "--mesh", "multipod"]),
                          reference["lists"]):
        D.main(argv)
        assert capsys.readouterr().out == want
    assert len(reference["lists"][1].splitlines()) == 80


def test_cli_cell_writes_a_record_with_the_reference_keys(tmp_path, reference):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH, "--shape",
         "decode_32k", "--mesh", "pod", "--out-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(tmp_path / f"{ARCH}__decode_32k__pod.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    # hlo_bytes has no counterpart here
    assert sorted(rec) == sorted(set(reference["keys"]) - {"hlo_bytes"})
    assert sorted(rec["memory"]) == sorted(["argument_bytes", "output_bytes", "temp_bytes",
                                            "alias_bytes", "peak_args_plus_temp"])
    assert sorted(rec["cost"]) == ["bytes_accessed", "flops"]
    assert list(rec["collectives"]) == reference["collective_ops"]
    assert sorted(rec["traffic"]) == ["param_bytes", "tensor_bytes", "traffic_bytes"]
    assert rec["compile_scan_s"] == rec["compile_unroll_s"] > 0
