"""The port's other model families against the JAX package, on the CPU:
MoE (granite-moe-3b-a800m, mixtral-8x22b), LayerNorm and the
nonparametric norm (musicgen-large, olmo-1b), the GELU MLP (musicgen) and
the frontend prefixes (internvl2-1b, musicgen), with glm4-9b and
internlm2-1.8b served beside them.

Configs are the reduced ones (2 layers, d 128); weights come from the
reference's initializers through ``repro_torch.bridge`` and inputs from
numpy seeds.  Bars: layers and the MoE layer at the fp32 bar, atol 2e-5 /
rtol 2e-4; the loss rtol 1e-5 and its gradients at the fp32 bar, as
``test_torch_train.py`` holds llama; served tokens token for token.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch import serve as jserve
from repro.models import init_params as jinit_params
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.inputs import make_batch as jmake_batch
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import ServeEngine as JServeEngine
from repro.train import loop as JLoop
from repro.train import optimizer as JO
from repro_torch import bridge
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.kernels import rmsnorm as RN
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.inputs import make_batch
from repro_torch.serve.engine import ContinuousEngine, ServeEngine
from repro_torch.serve.scheduler import Request
from repro_torch.train import loop as TLoop

F32_TOL = dict(atol=2e-5, rtol=2e-4)
LOSS_TOL = dict(rtol=1e-5, atol=0)
NEW_ARCHS = ("granite-moe-3b-a800m", "mixtral-8x22b", "internvl2-1b", "musicgen-large",
             "olmo-1b", "glm4-9b", "internlm2-1.8b")
MOE_ARCHS = ("granite-moe-3b-a800m", "mixtral-8x22b")


def cfgs(arch, **mods):
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **mods)
    tcfg = dataclasses.replace(reduced(get_config(arch)), **mods)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def setup(arch, seed=0, **mods):
    jcfg, tcfg = cfgs(arch, **mods)
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, bridge.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")


def t(a):
    return bridge.tensor_from_numpy(np.asarray(a), "cpu")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------------
# configs, bridge, layout, batches
# --------------------------------------------------------------------------

@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "olmo-1b", "musicgen-large"])
def test_bridge_round_trip_is_bit_exact(arch, param_dtype):
    """The MoE leaves (router, w1, w3, w2), olmo's empty norm dicts and
    LayerNorm's bias cross to the port and back bit for bit."""
    jcfg, tcfg, jp, tp = setup(arch, param_dtype=param_dtype)
    back = bridge.params_to_numpy(tcfg, tp, bf16_dtype=jnp.bfloat16)
    want = np_tree(jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    layer = tp["layers"][0]
    if tcfg.is_moe:
        assert sorted(layer["ffn"]) == ["router", "w1", "w2", "w3"]
        assert layer["ffn"]["router"].dtype == torch.float32     # fp32 whatever the params
    if tcfg.norm == "nonparametric":
        assert layer["ln1"] == layer["ln2"] == tp["final_norm"] == {}
    if tcfg.norm == "layernorm":
        assert sorted(layer["ln1"]) == ["bias", "scale"] and "w3" not in layer["ffn"]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_port_init_params_has_the_reference_layout(arch):
    jcfg, tcfg = cfgs(arch)
    jp = np_tree(jinit_params(jcfg, jax.random.PRNGKey(0)))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    mine = bridge.params_to_numpy(tcfg, tp)
    assert jax.tree.structure(mine) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(jp)):
        assert a.shape == b.shape and a.dtype == b.dtype
    if tcfg.is_moe:
        # the reference's scales: router and w1/w3 1/sqrt(d), w2 1/sqrt(f)
        ffn = tp["layers"][0]["ffn"]
        assert abs(float(ffn["w1"].std()) * np.sqrt(tcfg.d_model) - 1.0) < 0.05
        assert abs(float(ffn["w2"].std()) * np.sqrt(tcfg.moe_d_ff) - 1.0) < 0.05


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-large"])
def test_make_batch_with_prefix_is_bit_equal(arch, kind):
    jcfg, tcfg = cfgs(arch)
    want = jmake_batch(jcfg, batch=3, seq_len=20, seed=4, kind=kind)
    got = make_batch(tcfg, batch=3, seq_len=20, seed=4, kind=kind)
    assert sorted(got) == sorted(want) and "prefix_embeds" in got
    assert got["tokens"].shape == (3, 20 - tcfg.n_prefix)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype and got[k].numpy().tobytes() == w.tobytes(), k


# --------------------------------------------------------------------------
# norms and the GELU MLP
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("norm", ["layernorm", "nonparametric"])
def test_apply_norm_matches_reference(norm, dtype):
    """Mean and variance in fp32, eps 1e-5, the result in x's dtype; a
    random scale and bias, so both are exercised.  ``kernel="cuda"`` names
    the RMSNorm kernel only, and launches nothing for these norms."""
    jcfg, tcfg = cfgs("olmo-1b", norm=norm)
    rng = np.random.default_rng(0)
    x = np.asarray(jnp.asarray(rng.normal(0.5, 2.0, (2, 7, 128)), dtype))
    p = {}
    if norm == "layernorm":
        p = {"scale": rng.normal(1, 0.2, 128).astype(np.float32),
             "bias": rng.normal(0, 0.2, 128).astype(np.float32)}
    assert sorted(TL.init_norm(tcfg, 128, torch.float32, "cpu")) == sorted(
        JL.init_norm(jcfg, 128, jnp.float32))
    want = JL.apply_norm(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: t(v) for k, v in p.items()}
    before = RN.launches
    for kernel in ("plain", "cuda"):
        got = TL.apply_norm(tcfg, tp, t(x), kernel=kernel)
        assert got.dtype == t(x).dtype
        tol = F32_TOL if dtype == np.float32 else dict(atol=3e-2, rtol=3e-2)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    assert RN.launches == before


def test_gelu_mlp_matches_reference_and_is_the_tanh_form():
    """musicgen's two-matrix MLP: ``jax.nn.gelu`` defaults to the tanh
    approximation.  The exact erf form misses the fp32 bar."""
    jcfg, tcfg = cfgs("musicgen-large")
    jp = JL.init_mlp(jcfg, jax.random.PRNGKey(1), jnp.float32)
    assert sorted(jp) == ["w1", "w2"]
    tp = {k: t(v) for k, v in jp.items()}
    x = np.random.default_rng(1).normal(0, 1, (2, 5, 128)).astype(np.float32)
    want = np.asarray(JL.mlp_forward(jcfg, jp, jnp.asarray(x)))
    got = TL.mlp_forward(tcfg, tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    erf = (torch.nn.functional.gelu(torch.from_numpy(x) @ tp["w1"]) @ tp["w2"]).numpy()
    assert not np.allclose(erf, want, **F32_TOL)


# --------------------------------------------------------------------------
# the MoE layer
# --------------------------------------------------------------------------

def running_positions(idx: np.ndarray, n_experts: int) -> np.ndarray:
    """Each assignment's position in its expert, counted in a loop."""
    seen = np.zeros(n_experts, np.int64)
    out = []
    for e in idx.reshape(-1):
        out.append(seen[e])
        seen[e] += 1
    return np.asarray(out)


@pytest.mark.parametrize("routing", ["capacity", "dropless"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_reference(arch, routing):
    """``moe_forward`` out and aux at the fp32 bar; the routing indices equal
    ``jax.lax.top_k``'s; positions equal a running count.  The tokens share
    a common direction, which skews the routing (as real traffic does), so
    capacity routing drops assignments and the dropless path keeps all."""
    jcfg, tcfg = cfgs(arch)
    jp = JM.init_moe(jcfg, jax.random.PRNGKey(2), jnp.float32)
    tp = {k: t(v) for k, v in jp.items()}
    rng = np.random.default_rng(3)
    b, s, d = 2, 16, tcfg.d_model
    x = (rng.normal(0, 1, (b, s, d)) + 1.5 * rng.normal(0, 1, d)).astype(np.float32)
    cap = b * s if routing == "dropless" else 0
    want, want_aux = JM.moe_forward(jcfg, jp, jnp.asarray(x), cap_override=cap)
    got, aux = TM.moe_forward(tcfg, tp, torch.from_numpy(x), cap_override=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **F32_TOL)
    assert float(aux) > 0

    xf = x.reshape(-1, d)
    probs = jax.nn.softmax(jnp.asarray(xf) @ jp["router"], axis=-1)
    _, jidx = jax.lax.top_k(probs, jcfg.top_k)
    _, _, idx = TM.route(tcfg, tp, torch.from_numpy(xf))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    my_pos, keep = TM.positions(idx, tcfg.n_experts, cap or TM.capacity(tcfg, b * s))
    np.testing.assert_array_equal(my_pos.numpy(), running_positions(np.asarray(jidx),
                                                                    tcfg.n_experts))
    assert TM.capacity(tcfg, b * s) == JM.capacity(jcfg, b * s)
    if routing == "capacity":
        assert not bool(keep.all())                     # a drop happened
        full, _ = TM.moe_forward(tcfg, tp, torch.from_numpy(x), cap_override=b * s)
        assert float((full - got).abs().max()) > 1e-6
    else:
        assert bool(keep.all())


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "internvl2-1b", "musicgen-large",
                                  "olmo-1b"])
@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_loss_and_grads_match_reference(arch, remat):
    """``loss_fn`` and its gradients from the reference's initial state:
    MoE's aux in the loss; the prefix archs' ``prefix_embeds`` before the
    tokens and the mask's zeros over them; LayerNorm's and the GELU MLP's
    gradients; olmo's parameter-free norms."""
    jcfg, tcfg = cfgs(arch, remat=remat)
    js = JLoop.init_state(jcfg, JO.OptConfig(), jax.random.PRNGKey(0))
    ts = bridge.state_from_numpy(tcfg, np_tree(js), "cpu")
    jb = jmake_batch(jcfg, batch=2, seq_len=33, seed=1, kind="train")
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, jb), has_aux=True))(js["params"])
    loss, met, grads = TLoop._grads(tcfg, ts["params"], tb)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    np.testing.assert_allclose(float(met["nll"]), float(jmet["nll"]), **LOSS_TOL)
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]), **LOSS_TOL)
    assert (float(met["aux"]) > 0) == tcfg.is_moe
    got, want = bridge.params_to_numpy(tcfg, grads), np_tree(jgrads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=jax.tree_util.keystr(path),
                                   **F32_TOL)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def prompt_batch(jcfg, b, prompt_len, seed=0):
    """The reference's prefill batch: ``prompt_len`` tokens after the
    config's prefix."""
    jb = jmake_batch(jcfg, batch=b, seq_len=prompt_len + jcfg.n_prefix, seed=seed,
                     kind="prefill")
    return jb, {k: np.asarray(v) for k, v in jb.items()}


ENGINE_CASES = [(arch, {}) for arch in NEW_ARCHS] + [
    ("granite-moe-3b-a800m", {"kv_quant": True})]


@pytest.mark.parametrize("arch,mods", ENGINE_CASES,
                         ids=[a + ("-int8" if m else "") for a, m in ENGINE_CASES])
def test_continuous_engine_matches_reference_token_for_token(arch, mods):
    """Greedy tokens of the port's continuous engine, plain and through the
    kernel wrappers (their plain versions on the CPU), against the
    reference's: page 8, a 12-token prompt (after the prefix) and 8 steps,
    so decode crosses a page boundary; MoE prefill routes each request at
    its own capacity, decode dropless, as in the reference."""
    jcfg, tcfg, jp, tp = setup(arch, **mods)
    jb, nb = prompt_batch(jcfg, 2, 12, seed=5)
    kw = dict(n_slots=3, max_len=40, page=8)
    want = np.asarray(JContinuousEngine(jcfg, jp, **kw).generate(jb, n_steps=8))
    for kernel in ("plain", "cuda"):
        eng = ContinuousEngine(tcfg, tp, attn_kernel=kernel, device="cpu", **kw)
        got = eng.generate(nb, n_steps=8).numpy()
        np.testing.assert_array_equal(got, want)
        if tcfg.kv_quant:
            assert eng.pool.blocks["layers"][0]["k_pages"].dtype == torch.int8


@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-large"])
def test_prefix_arch_static_and_continuous_parity_and_guard(arch):
    """The static engine with the prefix (reference and port) and the port's
    paged engine agree; a request without ``prefix_embeds`` is refused with
    the reference's error."""
    jcfg, tcfg, jp, tp = setup(arch)
    jb, nb = prompt_batch(jcfg, 2, 12, seed=6)
    want = np.asarray(JServeEngine(jcfg, jp, max_len=64).generate(jb, n_steps=6))
    dense = ServeEngine(tcfg, tp, max_len=64, device="cpu").generate(nb, n_steps=6).numpy()
    eng = ContinuousEngine(tcfg, tp, n_slots=2, max_len=64, page=8, device="cpu")
    paged = eng.generate(nb, n_steps=6).numpy()
    np.testing.assert_array_equal(dense, want)
    np.testing.assert_array_equal(paged, want)
    with pytest.raises(ValueError, match="prefix_embeds"):
        eng.serve([Request(prompt=np.arange(12, dtype=np.int32), max_new=4)])


@pytest.mark.parametrize("arch,reduce", [("internvl2-1b", True), ("musicgen-large", True),
                                         ("granite-moe-3b-a800m", True),
                                         ("internvl2-1b", False)])
def test_launcher_request_stream_matches_reference(arch, reduce):
    """Prompts, new-token counts, arrivals, keys and prefix embeddings of
    ``_make_requests``, bit-equal to the reference's: the prefix is drawn
    at the same point of the numpy stream."""
    argv = ["--arch", arch, "--continuous", "--n-requests", "5", "--steps", "8",
            "--prompt-len", "12", "--seed", "7"] + (["--reduced"] if reduce else [])
    args = tserve.parser().parse_args(argv)
    jcfg = jreduced(jget_config(arch)) if reduce else jget_config(arch)
    tcfg = reduced(get_config(arch)) if reduce else get_config(arch)
    jargs = argparse.Namespace(seed=7, n_requests=5, arrival_rate=args.arrival_rate,
                               slots=args.slots, temperature=args.temperature,
                               prompt_len=12, steps=8)
    jreqs = jserve._make_requests(jargs, jcfg)
    treqs = tserve._make_requests(args, tcfg)
    for jr, tr in zip(jreqs, treqs, strict=True):
        np.testing.assert_array_equal(tr.prompt, jr.prompt)
        assert (tr.max_new, tr.arrival) == (jr.max_new, jr.arrival)
        np.testing.assert_array_equal(tr.key.numpy(), np.asarray(jr.key).astype(np.int64))
        if tcfg.n_prefix:
            assert tr.prefix_embeds.shape == (tcfg.n_prefix, tcfg.d_model)
            assert tr.prefix_embeds.tobytes() == jr.prefix_embeds.tobytes()
        else:
            assert tr.prefix_embeds is None is jr.prefix_embeds


@pytest.mark.parametrize("arch", JARCHS)
def test_serve_cli_serves_every_registered_arch(arch):
    """``python -m repro_torch.launch.serve --arch <a> --continuous --device
    cpu --reduced`` for every arch of the reference's registry, which the
    port registers and admits at full size too."""
    assert arch in ARCHS
    TT.check_supported(get_config(arch))
    res = tserve.main(["--arch", arch, "--reduced", "--continuous", "--device", "cpu",
                       "--n-requests", "2", "--steps", "4", "--prompt-len", "8"])
    assert res["completed"] == 2 and res["arch"] == arch + "-smoke"
    for r in res["objects"]["requests"]:
        assert len(r.out) == r.max_new and all(0 <= x < res["objects"]["engine"].cfg.vocab
                                               for x in r.out)
