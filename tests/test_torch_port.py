"""The PyTorch port (``repro_torch``) against the JAX package, module by module.

Inputs are made with numpy from fixed seeds and handed to both packages;
weights come from ``repro.models.init_params`` through ``repro_torch.bridge``.
Everything runs on the CPU: the port's paged-attention wrapper takes its
plain version for CPU tensors, and the reference's Pallas kernel runs in
interpret mode, as ``tests/test_kernels.py`` runs it.
"""
import dataclasses
import os
import re
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.kernels import ops as jops
from repro.models import init_params as jinit_params
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import kvcache as JK
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve import kvcache as TK

ROOT = os.path.join(os.path.dirname(__file__), "..")


def cfgs(**mods):
    """The same reduced llama3.2-1b in both packages."""
    jcfg = dataclasses.replace(jreduced(jget_config("llama3.2-1b")), **mods)
    tcfg = dataclasses.replace(reduced(get_config("llama3.2-1b")), **mods)
    return jcfg, tcfg


def weights(jcfg, tcfg, seed=0):
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    return jp, bridge.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")


def t(a):
    return bridge.tensor_from_numpy(np.asarray(a), "cpu")


# --------------------------------------------------------------------------
# (a) the port stands alone
# --------------------------------------------------------------------------

def test_every_module_imports_with_jax_and_repro_blocked():
    code = textwrap.dedent("""
        import glob, importlib, importlib.util, os, pkgutil, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not bad, bad
        for n in ("models.ssm", "kernels.ssd", "kernels.ops", "configs.mamba2_130m", "jrandom",
                  "core.simulator", "core.predictor", "core.workloads", "core.profiler",
                  "core.instrument", "train.loop", "train.optimizer", "train.data",
                  "dist.compression", "launch.train", "models.inputs", "obs.log", "tree",
                  "configs.countdown_100m", "models.moe", "configs.glm4_9b",
                  "configs.internlm2_1_8b", "configs.olmo_1b", "configs.granite_moe_3b_a800m",
                  "configs.mixtral_8x22b", "configs.internvl2_1b", "configs.musicgen_large",
                  "obs", "obs.metrics", "obs.tracer", "obs.export", "cluster", "cluster.power",
                  "cluster.arbiter", "cluster.job", "cluster.trace", "cluster.coschedule",
                  "serve.fleet", "serve.fleet.prefix", "dist.checkpoint", "dist.elastic",
                  "serve.fleet.router", "serve.fleet.scenarios", "serve.fleet.autoscaler",
                  "serve.fleet.replica", "serve.fleet.fleet", "dist.sharding",
                  "models.hooks", "launch.mesh", "launch.dryrun"):
            assert "repro_torch." + n in names, n
        examples = sorted(glob.glob(os.path.join(EXAMPLES, "torch_*.py")))
        assert len(examples) == 5, examples
        for path in examples:               # the examples run main() only as scripts
            spec = importlib.util.spec_from_file_location(os.path.basename(path)[:-3], path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        from repro_torch.serve import ContinuousEngine, PrefixCache  # noqa: F401
        from repro_torch.serve import FleetSim, run_engine_fleet  # noqa: F401
        from repro_torch.models import init_params  # noqa: F401
        from repro_torch.dist import CheckpointManager, ElasticMesh, sharding  # noqa: F401
        from repro_torch.launch import mesh  # noqa: F401
        # the dry run counts a small cell over a fake world of 4 ranks
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import get_config, reduced
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import dryrun
        dryrun.fake_world(4)
        dryrun.get_config = lambda a: reduced(get_config(a))
        dm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        fn, args = dryrun.build_cell("llama3.2-1b", ShapeConfig("d", 16, 4, "decode"), dm)
        assert dryrun.count_step(fn, args)["memory"]["argument_bytes"] > 0
        bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not bad, bad
        print(len(names))
    """).replace("EXAMPLES", repr(os.path.join(ROOT, "examples")))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30           # every module was imported


def test_no_source_names_jax_or_the_reference_package():
    pat = re.compile(r"import jax|from jax|import repro[.\s]|from repro\.")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith((".py", ".cu"))]
    examples = os.path.join(ROOT, "examples")
    files += [os.path.join(examples, n) for n in os.listdir(examples)
              if n.startswith("torch_") and n.endswith(".py")]
    hits = [f for f in files if pat.search(open(f).read())]
    assert len(files) > 25 and not hits, hits
    assert sum(os.path.dirname(f) == examples for f in files) == 5


def test_copied_logger_renders_as_the_original():
    """``repro_torch.obs.log`` renders every record as the reference's
    logger does, in text and JSON (but the timestamp), honours the level,
    and installs the same flags."""
    import argparse
    import io
    import json

    from repro.obs import log as JLog
    from repro_torch.obs import log as TLog

    def rendered(mod):
        lines = []
        try:
            for json_logs in (False, True):
                buf = io.StringIO()
                mod.configure(level="info", json_logs=json_logs, stream=buf)
                lg = mod.get_logger("train")
                lg.info("step", step=3, loss=1.2345678, name="a b", empty="", ok=True)
                lg.warning("device_failed", step=12, device=[1, 2])
                lg.debug("hidden", y=1)
                lines += buf.getvalue().splitlines()
        finally:
            mod.configure()
        return [dict(json.loads(x), t=0) if x.startswith("{") else x for x in lines]

    def flags(mod):
        ap = argparse.ArgumentParser()
        mod.add_flags(ap)
        return sorted(a.dest for a in ap._actions)

    assert rendered(TLog) == rendered(JLog)
    assert len(rendered(TLog)) == 4
    assert flags(TLog) == flags(JLog)


def test_copied_config_equals_reference():
    for mods in ({}, {"kv_quant": True}):
        jcfg, tcfg = cfgs(**mods)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    from repro.configs import ARCHS as JARCHS
    from repro_torch.configs import ARCHS

    assert ARCHS == JARCHS                            # every arch, in the same order
    for arch in JARCHS:
        assert dataclasses.asdict(jget_config(arch)) == dataclasses.asdict(get_config(arch))
        assert dataclasses.asdict(jreduced(jget_config(arch))) == \
            dataclasses.asdict(reduced(get_config(arch)))
        assert dataclasses.asdict(jreduced(jget_config(arch), n_layers=8)) == \
            dataclasses.asdict(reduced(get_config(arch), n_layers=8))
    with pytest.raises(KeyError):
        get_config("gpt-2")                           # in neither registry


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.device import resolve_device
    from repro_torch.serve.engine import ContinuousEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    _, tcfg = cfgs()
    params = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousEngine(tcfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TK.PagedKVPool(tcfg, n_slots=2, max_len=16, page=8)


# --------------------------------------------------------------------------
# (b) bridge
# --------------------------------------------------------------------------

@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_bit_exact(param_dtype):
    jcfg, tcfg = cfgs(param_dtype=param_dtype)
    jp, tp = weights(jcfg, tcfg)
    assert len(tp["layers"]) == tcfg.n_layers
    assert tp["embed"].dtype == TL.dtype_of(param_dtype)
    back = bridge.params_to_numpy(tcfg, tp, bf16_dtype=jnp.bfloat16)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_port_init_params_has_the_reference_layout():
    jcfg, tcfg = cfgs()
    jp = jax.tree.map(np.asarray, jinit_params(jcfg, jax.random.PRNGKey(0)))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    mine = bridge.params_to_numpy(tcfg, tp)
    assert jax.tree.structure(mine) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(jp)):
        assert a.shape == b.shape and a.dtype == b.dtype
    # same initializer scales: embed std 0.02, dense 1/sqrt(d_in)
    assert abs(float(tp["embed"].std()) - 0.02) < 2e-3
    wq = tp["layers"][0]["attn"]["wq"]
    assert abs(float(wq.std()) * np.sqrt(tcfg.d_model) - 1.0) < 0.05


# --------------------------------------------------------------------------
# (c) layers and the dense transformer
# --------------------------------------------------------------------------

def test_kv_quantize_bit_equal_and_rounds_half_to_even():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (3, 5, 2, 32)).astype(np.float32)
    x[0, 0, 0, :5] = [127.0, 2.5, -3.5, 0.5, 1.5]      # scale 1: exact halves
    jq, js = JL._kv_quantize(jnp.asarray(x))
    tq, ts = TL._kv_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    assert tq[0, 0, 0, :5].tolist() == [127, 2, -4, 0, 2]
    np.testing.assert_array_equal(
        np.asarray(JL._kv_dequantize(jq, js, jnp.float32)),
        TL._kv_dequantize(tq, ts, torch.float32).numpy())


@pytest.mark.parametrize("impl,window,s", [
    ("naive", 0, 24), ("naive", 16, 24), ("chunked", 0, 40), ("banded", 16, 40),
])
def test_attention_cores_match(impl, window, s):
    """fp32, atol/rtol 1e-5: the same einsums in another summation order."""
    rng = np.random.default_rng(2)
    q = rng.normal(0, 1, (2, s, 2, 2, 16)).astype(np.float32)
    k = rng.normal(0, 1, (2, s, 2, 16)).astype(np.float32)
    v = rng.normal(0, 1, (2, s, 2, 16)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    jargs = [jnp.asarray(a) for a in (q, k, v, pos)]
    targs = [torch.from_numpy(a) for a in (q, k, v, pos)]
    if impl == "naive":
        want = JL.naive_causal_attention(*jargs, jargs[3], window=window)
        got = TL.naive_causal_attention(*targs, targs[3], window=window)
    elif impl == "chunked":
        want = JL.chunked_causal_attention(*jargs, jargs[3], kv_chunk=16)
        got = TL.chunked_causal_attention(*targs, targs[3], kv_chunk=16)
    else:
        want = JL.banded_attention(*jargs, window)
        got = TL.banded_attention(*targs, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mods", [{}, {"kv_quant": True}, {"attention": "swa", "window": 16}])
def test_prefill_and_decode_logits_and_caches_match(mods):
    """fp32 logits at atol/rtol 1e-4 over prefill and 4 decode steps;
    float caches agree to 1e-5, int8 caches and slot positions exactly."""
    jcfg, tcfg = cfgs(**mods)
    jp, tp = weights(jcfg, tcfg)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, (2, 20)).astype(np.int32)
    jc = JT.init_cache(jcfg, 2, 32)
    jl, jc = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, jc)
    tc = TT.init_cache(tcfg, 2, 32, "cpu")
    tl, tc = TT.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for i in range(4):
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(tok), jnp.int32(20 + i), jc)
        tl, tc = TT.decode_step(tcfg, tp, torch.from_numpy(tok), 20 + i, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    want = bridge.blocks_from_numpy(tcfg, jax.tree.map(np.asarray, jc), "cpu")
    for wl, gl in zip(want["layers"], tc["layers"]):
        assert set(wl) == set(gl)
        for name in wl:
            if wl[name].dtype.is_floating_point:
                torch.testing.assert_close(gl[name], wl[name], atol=1e-5, rtol=1e-5)
            else:
                assert torch.equal(gl[name], wl[name]), name


# --------------------------------------------------------------------------
# (d) paged decode attention
# --------------------------------------------------------------------------

def paged_inputs(rng, b, hkv, g, d, page, m, quant, dtype=np.float32):
    n_pages = b * m + 1
    table = rng.permutation(np.arange(1, n_pages, dtype=np.int32)).reshape(b, m)
    pos = rng.integers(0, m * page, b).astype(np.int32)
    table[-1], pos[-1] = 0, 0                          # an idle slot on scratch
    page_idx = table[np.arange(b), pos // page]
    ins = dict(q=rng.normal(0, 1, (b, hkv, g, d)).astype(np.float32))
    if quant:
        ins.update(
            k_new=rng.integers(-127, 128, (b, hkv, d)).astype(np.int8),
            v_new=rng.integers(-127, 128, (b, hkv, d)).astype(np.int8),
            k_pages=rng.integers(-127, 128, (n_pages, page, hkv, d)).astype(np.int8),
            v_pages=rng.integers(-127, 128, (n_pages, page, hkv, d)).astype(np.int8),
            k_scale_new=rng.uniform(1e-3, 0.05, (b, hkv)).astype(np.float32),
            v_scale_new=rng.uniform(1e-3, 0.05, (b, hkv)).astype(np.float32),
            k_scale_pages=rng.uniform(1e-3, 0.05, (n_pages, page, hkv)).astype(np.float32),
            v_scale_pages=rng.uniform(1e-3, 0.05, (n_pages, page, hkv)).astype(np.float32))
    else:
        for name, shape in (("k_new", (b, hkv, d)), ("v_new", (b, hkv, d)),
                            ("k_pages", (n_pages, page, hkv, d)),
                            ("v_pages", (n_pages, page, hkv, d))):
            ins[name] = np.asarray(jnp.asarray(rng.normal(0, 1, shape), dtype))
    ins.update(table=table, pos=pos, page_idx=page_idx.astype(np.int32),
               off=(pos % page).astype(np.int32))
    return ins


POOLS = ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages")


@pytest.mark.parametrize("quant,window,dtype,atol,rtol", [
    (False, 0, np.float32, 2e-5, 2e-4), (False, 16, np.float32, 2e-5, 2e-4),
    (True, 0, np.float32, 2e-5, 2e-4), (True, 16, np.float32, 2e-5, 2e-4),
    (False, 0, jnp.bfloat16, 3e-2, 3e-2),
])
def test_scatter_attend_plain_matches_pallas_kernel(quant, window, dtype, atol, rtol):
    """The port's plain version (and its wrapper, which takes the plain
    version for CPU tensors) against the reference's fused Pallas kernel in
    interpret mode, on identical inputs: outputs allclose (fp32 2e-5 / 2e-4;
    bf16 pages 3e-2, since the plain version rounds the probabilities to the
    page dtype and the kernel does not); pools bit-equal outside page 0."""
    ins = paged_inputs(np.random.default_rng(4), 3, 2, 4, 32, 8, 5, quant, dtype)
    names = ["q", "k_new", "v_new"] + (["k_scale_new", "v_scale_new"] if quant else []) \
        + list(POOLS[:4 if quant else 2]) + ["table", "pos", "page_idx", "off"]
    jin = [jnp.asarray(ins[n]) for n in names]
    if quant:
        want, want_pools = jops.paged_attention_scatter_quant(*jin, window=window)
    else:
        want, want_pools = jops.paged_attention_scatter(*jin, window=window)
    for fn in (PA.paged_attention_scatter_plain, PA.paged_attention_scatter):
        tin = {n: t(ins[n]) for n in names}
        before = PA.launches
        got = fn(**tin, window=window)
        assert PA.launches == before                  # CPU: never the kernel
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=atol, rtol=rtol)
        for name, w in zip(POOLS, want_pools):
            g = bridge.tensor_to_numpy(tin[name], jnp.bfloat16)
            assert g.dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g[1:], np.asarray(w)[1:])


def test_wrapper_checks_device():
    ins = paged_inputs(np.random.default_rng(5), 2, 1, 2, 16, 8, 2, False)
    tin = {n: t(a).to("meta") for n, a in ins.items()}
    with pytest.raises(ValueError, match="no kernel for device meta"):
        PA.paged_attention_scatter(**tin)


def jax_block(rng, jcfg, n_pages, page):
    shape = (n_pages, page, jcfg.n_kv_heads, jcfg.head_dim)
    if jcfg.kv_quant:
        return {"k_pages": jnp.asarray(rng.integers(-127, 128, shape), jnp.int8),
                "v_pages": jnp.asarray(rng.integers(-127, 128, shape), jnp.int8),
                "k_scale_pages": jnp.asarray(rng.uniform(1e-3, 0.05, shape[:3]), jnp.float32),
                "v_scale_pages": jnp.asarray(rng.uniform(1e-3, 0.05, shape[:3]), jnp.float32)}
    return {"k_pages": jnp.asarray(rng.normal(0, 1, shape), jnp.float32),
            "v_pages": jnp.asarray(rng.normal(0, 1, shape), jnp.float32)}


@pytest.mark.parametrize("mods", [{}, {"kv_quant": True}, {"attention": "swa", "window": 16},
                                  {"kv_quant": True, "attention": "swa", "window": 16}])
def test_paged_attention_decode_matches_xla_and_pallas(mods):
    """``kvcache.paged_attention_decode``, projections included: the port's
    plain and cuda-wrapper paths against the reference's ``xla`` and
    ``pallas`` branches.  Outputs allclose at fp32 1e-4; the pages agree
    outside page 0 (float pages to 1e-5, int8 pages exactly where the
    quantisation scale matched, and within one step everywhere) — the new
    rows come through matmuls and RoPE that differ from XLA's in the last
    ulps, so bitwise page equality is held at the kernel level above."""
    jcfg, tcfg = cfgs(**mods)
    jp, tp = weights(jcfg, tcfg)
    j_attn = jax.tree.map(lambda a: a[0], jp["stack"]["0"]["attn"])
    t_attn = tp["layers"][0]["attn"]
    rng = np.random.default_rng(6)
    b, page, m = 3, 8, 5
    block = jax_block(rng, jcfg, b * m + 1, page)
    table = rng.permutation(np.arange(1, b * m + 1, dtype=np.int32)).reshape(b, m)
    pos = np.array([13, 37, 0], np.int32)
    table[-1] = 0
    x = rng.normal(0, 1, (b, 1, jcfg.d_model)).astype(np.float32)
    wants = [JK.paged_attention_decode(jcfg, j_attn, jnp.asarray(x), jnp.asarray(pos),
                                       jnp.asarray(table), dict(block), kernel=k)
             for k in ("xla", "pallas")]
    for kernel in ("plain", "cuda"):
        tblock = {k: t(v) for k, v in block.items()}
        got, tblock = TK.paged_attention_decode(tcfg, t_attn, torch.from_numpy(x),
                                                torch.from_numpy(pos), torch.from_numpy(table),
                                                tblock, kernel=kernel)
        for want, wblock in wants:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
            for name, w in wblock.items():
                g, w = tblock[name][1:], t(w)[1:]
                if w.dtype == torch.int8:
                    assert int((g.int() - w.int()).abs().max()) <= 1
                else:
                    torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_pool_accounting_matches_reference():
    """The copied free list: the same sequence of reserve/alloc/share/
    retain/release leaves both pools in the same state."""
    jcfg, tcfg = cfgs()
    jpool = JK.PagedKVPool(jcfg, n_slots=2, max_len=32, page=8, num_pages=9,
                           materialize=False)
    tpool = TK.PagedKVPool(tcfg, n_slots=2, max_len=32, page=8, num_pages=9,
                           materialize=False)
    for pool in (jpool, tpool):
        assert pool.reserve("a", 20) and pool.reserve("b", 24)
        pool.alloc("a", 2)
        pool.alloc("b", 1)
        pool.retain(pool._allocated["a"][:1])
        pool.share("b", pool._allocated["a"][:1])
        assert not pool.reserve("c", 30)
        pool.release("a")
    for attr in ("_free", "_reserved", "_allocated", "_ref"):
        assert getattr(jpool, attr) == getattr(tpool, attr), attr
    assert (jpool.free_pages, jpool.utilization) == (tpool.free_pages, tpool.utilization)


def test_rope_at_matches():
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (3, 1, 4, 32)).astype(np.float32)
    pos = np.array([0, 17, 300], np.int32)
    want = JK.rope_at(jnp.asarray(x), jnp.asarray(pos), 500_000.0)
    got = TK.rope_at(torch.from_numpy(x), torch.from_numpy(pos), 500_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
