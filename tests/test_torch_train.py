"""The port's training path (``repro_torch.train``, ``models.transformer.
loss_fn``, ``models.inputs``) against the JAX package's, on the CPU.

Every check starts both packages from one state: the reference's
``init_state`` carried across by ``repro_torch.bridge``.  Tolerances are
the repo's fp32 bar: loss rtol 1e-5, gradients atol 2e-5 / rtol 2e-4; over
five AdamW steps losses rtol 1e-4 and parameters atol 1e-5.  The data
streams are bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.inputs import make_batch as jmake_batch
from repro.train import data as JD
from repro.train import loop as JLoop
from repro.train import optimizer as JO
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as TL
from repro_torch.models.inputs import make_batch
from repro_torch.train import data as TD
from repro_torch.train import loop as TLoop
from repro_torch.train import optimizer as TO
from repro_torch.tree import leaves

# the reduced configs: countdown-100m as tests/test_system.py::_tiny_cfg;
# recurrentgemma-2b at 5 layers, one period and a remainder of two RG-LRU
# blocks (the reference's params["rem"]), with its logits softcap
ARCHS = {
    "countdown-100m": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                           vocab=256),
    "llama3.2-1b": {},
    "recurrentgemma-2b": dict(n_layers=5),
    "mamba2-130m": {},
}
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(atol=2e-5, rtol=2e-4)
SEQ = 33


def cfgs(arch, **mods):
    jcfg = dataclasses.replace(jreduced(jget_config(arch), **ARCHS[arch]), **mods)
    tcfg = dataclasses.replace(reduced(get_config(arch), **ARCHS[arch]), **mods)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def states(jcfg, tcfg, opt_cfg, seed=0):
    """The reference's initial training state and the port's copy of it."""
    js = JLoop.init_state(jcfg, opt_cfg, jax.random.PRNGKey(seed))
    return js, bridge.state_from_numpy(tcfg, np_tree(js), "cpu")


def batches(jcfg, b, s, seed):
    """One batch from the reference's make_batch, for both packages."""
    jb = jmake_batch(jcfg, batch=b, seq_len=s, seed=seed, kind="train")
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def assert_tree_close(got, want, what, **tol):
    """Two trees of the reference's structure, leaf by leaf."""
    assert jax.tree.structure(got) == jax.tree.structure(want), what
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32),
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}", **tol)


# --------------------------------------------------------------------------
# loss and gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_and_grads_match_reference(arch, remat):
    jcfg, tcfg = cfgs(arch, remat=remat)
    opt_cfg = JO.OptConfig()
    js, ts = states(jcfg, tcfg, opt_cfg)
    jb, tb = batches(jcfg, 2, SEQ, seed=1)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, jb), has_aux=True))(js["params"])
    loss, met, grads = TLoop._grads(tcfg, ts["params"], tb)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    np.testing.assert_allclose(float(met["nll"]), float(jmet["nll"]), **LOSS_TOL)
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    assert_tree_close(bridge.params_to_numpy(tcfg, grads), np_tree(jgrads), arch, **GRAD_TOL)


def test_remat_gives_the_same_numbers():
    """Checkpointed periods recompute their activations in the backward
    pass; nothing draws random numbers, so the gradients are the same
    bits as without it."""
    jcfg, tcfg = cfgs("recurrentgemma-2b")
    _, ts = states(jcfg, tcfg, JO.OptConfig())
    _, tb = batches(jcfg, 2, SEQ, seed=2)
    on = TLoop._grads(tcfg, ts["params"], tb)
    off = TLoop._grads(dataclasses.replace(tcfg, remat=False), ts["params"], tb)
    assert torch.equal(on[0], off[0])
    for a, b in zip(leaves(on[2]), leaves(off[2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_scan", [True, False])
def test_chunked_cross_entropy_with_a_remainder_chunk_matches_reference(use_scan):
    """S 33 in chunks of 16: two full chunks and a remainder of one, and a
    mask with zeros, against the reference's scanned and unrolled splits."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, SEQ, 32)).astype(np.float32)
    w = rng.normal(0, 0.2, (32, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, SEQ)).astype(np.int32)
    mask = (rng.random((2, SEQ)) > 0.3).astype(np.float32)
    want = JL.chunked_cross_entropy(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels),
                                    jnp.asarray(mask), chunk=16, use_scan=use_scan)
    got = TL.chunked_cross_entropy(*map(torch.from_numpy, (x, w, labels, mask)), chunk=16)
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    empty = TL.chunked_cross_entropy(*map(torch.from_numpy, (x, w, labels, 0 * mask)),
                                     chunk=16)
    assert float(empty) == 0.0                        # the count is clamped at 1


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

def random_grads(jparams, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: rng.normal(0, 1e-2, p.shape).astype(np.float32), jparams)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(param_dtype):
    """Three updates from one state on the same gradients; bf16 params
    carry fp32 masters."""
    jcfg, tcfg = cfgs("recurrentgemma-2b", param_dtype=param_dtype)
    opt_cfg = JO.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    js, ts = states(jcfg, tcfg, opt_cfg)
    assert ("master" in js["opt"]) == ("master" in ts["opt"]) == (param_dtype == "bfloat16")
    jp, jo = js["params"], js["opt"]
    tp, to = ts["params"], ts["opt"]
    for i in range(3):
        g = random_grads(jp, seed=i)
        jp, jo, jm = jax.jit(JO.adamw_update, static_argnums=3)(jp, g, jo, opt_cfg)
        tg = bridge.params_from_numpy(tcfg, g, "cpu")
        tp, to, tm = TO.adamw_update(tp, tg, to, opt_cfg, TO.decay_mask(tcfg, tp))
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        assert float(tm["lr"]) == float(jm["lr"])
    got = bridge.state_to_numpy(tcfg, {"params": tp, "opt": to}, jnp.bfloat16)
    want = {"params": np_tree(jp), "opt": np_tree(jo)}
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 3
    for k in ("m", "v") + (("master",) if param_dtype == "bfloat16" else ()):
        assert_tree_close(got["opt"][k], want["opt"][k], k, atol=1e-7, rtol=1e-5)
    if param_dtype == "float32":
        assert_tree_close(got["params"], want["params"], "params", atol=1e-6, rtol=1e-5)
    else:
        # bf16 params are their masters rounded: where the two packages'
        # fp32 masters differ in the last bit, the rounding may land one
        # bf16 step (a relative 2**-8 to 2**-7) apart
        for p, master in zip(leaves(tp), leaves(to["master"])):
            assert torch.equal(p, master.to(p.dtype))
        assert_tree_close(got["params"], want["params"], "params", atol=1e-8, rtol=2 ** -7)


def test_weight_decay_follows_the_reference_leaf_rank():
    """With zero gradients AdamW only decays.  The reference stacks each
    full period's leaves, so a layer's 1-D norm scales and ``lam`` are
    decayed there; ``final_norm`` and the remainder blocks' 1-D leaves are
    not.  The port decays exactly the same leaves."""
    jcfg, tcfg = cfgs("recurrentgemma-2b")
    opt_cfg = JO.OptConfig(lr=1e-2, warmup_steps=0, total_steps=10, weight_decay=0.5)
    js, ts = states(jcfg, tcfg, opt_cfg)
    zeros = jax.tree.map(lambda p: np.zeros(p.shape, np.float32), np_tree(js["params"]))
    jp, _, _ = jax.jit(JO.adamw_update, static_argnums=3)(js["params"], zeros, js["opt"],
                                                          opt_cfg)
    before = [{k: v.clone() for k, v in layer["ln1"].items()} for layer in ts["params"]["layers"]]
    tp, _, _ = TO.adamw_update(ts["params"], bridge.params_from_numpy(tcfg, zeros, "cpu"),
                               ts["opt"], opt_cfg, TO.decay_mask(tcfg, ts["params"]))
    assert_tree_close(bridge.params_to_numpy(tcfg, tp), np_tree(jp), "decayed", atol=0,
                      rtol=1e-6)
    mask = TO.decay_mask(tcfg, tp)
    assert mask["embed"] and not mask["final_norm"]["scale"]
    kinds = tcfg.layer_kinds()
    assert kinds == ("rglru", "rglru", "attn", "rglru", "rglru")
    assert [m["ln1"]["scale"] for m in mask["layers"]] == [True, True, True, False, False]
    assert [m["rglru"]["lam"] for m in mask["layers"] if "rglru" in m] == [True, True, False,
                                                                          False]
    assert all(m["ffn"]["w1"] for m in mask["layers"])
    # the stacked period's norm scales moved, the remainder's did not
    for i, layer in enumerate(tp["layers"]):
        moved = not torch.equal(layer["ln1"]["scale"], before[i]["scale"])
        assert moved == (i < 3), i


@pytest.mark.parametrize("step", [0, 3, 10, 55, 100, 140])
def test_schedule_matches_reference(step):
    """Step 0, inside the warmup (10 steps), its end, mid-decay, the end
    of the decay (100) and past it."""
    cfg = JO.OptConfig(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    want = JO.schedule(cfg, jnp.asarray(step, jnp.int32))
    got = TO.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)


# --------------------------------------------------------------------------
# train steps
# --------------------------------------------------------------------------

def run_steps(jcfg, tcfg, opt_cfg, train_cfg, n, b=4):
    js, ts = states(jcfg, tcfg, opt_cfg)
    jstep = jax.jit(JLoop.make_train_step(jcfg, opt_cfg, JLoop.TrainConfig(
        **dataclasses.asdict(train_cfg))))
    tstep = TLoop.make_train_step(tcfg, opt_cfg, train_cfg)
    jl, tl = [], []
    for i in range(n):
        jb, tb = batches(jcfg, b, SEQ, seed=10 + i)
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        jl.append((float(jm["loss"]), float(jm["grad_norm"])))
        tl.append((float(tm["loss"]), float(tm["grad_norm"])))
    return js, ts, np.array(jl), np.array(tl)


@pytest.mark.parametrize("arch", ["countdown-100m", "mamba2-130m"])
def test_five_step_trajectory_matches_reference(arch):
    jcfg, tcfg = cfgs(arch)
    opt_cfg = JO.OptConfig(warmup_steps=2, total_steps=10)       # the default lr, 3e-4
    js, ts, jl, tl = run_steps(jcfg, tcfg, opt_cfg, TLoop.TrainConfig(), 5)
    np.testing.assert_allclose(tl[:, 0], jl[:, 0], rtol=1e-4)
    np.testing.assert_allclose(tl[:, 1], jl[:, 1], rtol=1e-3)
    assert_tree_close(bridge.params_to_numpy(tcfg, ts["params"]), np_tree(js["params"]),
                      "params", atol=1e-5, rtol=0)
    assert int(ts["opt"]["step"]) == 5


@pytest.mark.parametrize("train_cfg", [TLoop.TrainConfig(microbatch=2),
                                       TLoop.TrainConfig(grad_reduce_dtype="bfloat16")],
                         ids=["microbatch2", "grad_reduce_bf16"])
def test_step_variants_match_reference(train_cfg):
    """Microbatches of 2 (gradients and loss averaged over 4 of them), and
    gradients cast to bf16 before the update."""
    jcfg, tcfg = cfgs("countdown-100m")
    opt_cfg = JO.OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    js, ts, jl, tl = run_steps(jcfg, tcfg, opt_cfg, train_cfg, 2, b=8)
    np.testing.assert_allclose(tl[:, 0], jl[:, 0], **LOSS_TOL)
    np.testing.assert_allclose(tl[:, 1], jl[:, 1], rtol=1e-3)
    assert_tree_close(bridge.params_to_numpy(tcfg, ts["params"]), np_tree(js["params"]),
                      "params", atol=1e-5, rtol=0)


def test_training_reduces_loss():
    """The port's counterpart of tests/test_system.py::test_training_reduces_loss."""
    _, cfg = cfgs("countdown-100m")
    opt_cfg = TO.OptConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    state = TLoop.init_state(cfg, opt_cfg, torch.Generator().manual_seed(0), "cpu")
    step = TLoop.make_train_step(cfg, opt_cfg)
    loader = TD.DataLoader(cfg, batch=8, seq_len=33, seed=0)
    losses = []
    try:
        for _, batch in zip(range(60), loader):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
    finally:
        loader.close()
    assert not loader._thread.is_alive()
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.25, (first, last)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def test_data_streams_are_bit_equal():
    jcfg, tcfg = cfgs("countdown-100m")
    assert np.array_equal(TD.SyntheticCorpus(256, seed=3).sample(4, 70),
                          JD.SyntheticCorpus(256, seed=3).sample(4, 70))
    jl = JD.DataLoader(jcfg, batch=4, seq_len=33, seed=5)
    tl = TD.DataLoader(tcfg, batch=4, seq_len=33, seed=5)
    try:
        for _ in range(3):
            want, got = next(jl), next(tl)
            assert sorted(want) == sorted(got) == ["labels", "mask", "tokens"]
            for k in want:
                assert got[k].dtype == {"mask": torch.float32}.get(k, torch.int32)
                assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    finally:
        jl.close()
        tl.close()
    assert not tl._thread.is_alive()
    for seed in (0, 7):
        want = jmake_batch(jcfg, batch=3, seq_len=SEQ, seed=seed)
        got = make_batch(tcfg, batch=3, seq_len=SEQ, seed=seed)
        assert sorted(want) == sorted(got)
        for k in want:
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
