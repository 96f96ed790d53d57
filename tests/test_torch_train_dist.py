"""The port's data-parallel training step and the int8 gradient codec
(``repro_torch.train.loop.make_pod_train_step``,
``repro_torch.dist.compression``) and the training launcher, on gloo.

* The codec against the reference's: codes and scales bit-equal, the round
  trip within half a step (½ LSB).
* A gloo world of 1 in this process: ``compressed_psum`` bit-equal to the
  reference's under a 1-device mesh, each element within ½ LSB of its
  input, and the start/wait pair equal to the blocking call; the pod step
  with ``"manual"`` reduce equals ``make_train_step`` bit for bit; with
  ``"compressed"`` its gradients lie within ½ LSB of the exact ones element
  by element, and its step is AdamW on exactly those gradients.
* One spawn of 4 gloo ranks: each rank takes a quarter of the batch, and
  the ``"manual"`` pod step's loss and parameters equal the reference's
  single-process step on the whole batch (loss rtol 1e-5, parameters atol
  1e-5); each rank's governor books one instrumented ``cd_psum`` a step.
  Then each rank's ``compressed_psum`` mean equals the sum of every rank's
  dequantised shard (the reference's codec) over 4, and its
  ``"compressed"`` pod step is AdamW on that mean.
* The launcher in a world of 1 on the CPU.

JAX is imported inside the reference-side helpers only, so the spawned
ranks, which import this module, load torch alone.
"""
import json
import math
import os
import pickle
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.core import instrument as TI
from repro_torch.core.governor import Governor
from repro_torch.core.policies import COUNTDOWN_SLACK
from repro_torch.dist import compression as TC
from repro_torch.launch import train as ltrain
from repro_torch.train import loop as TLoop
from repro_torch.train.optimizer import OptConfig, adamw_update, decay_mask
from repro_torch.tree import leaves

WORLD = 4
JOIN_LIMIT_S = 180.0
STEPS = 2
SEQ = 33
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)


@pytest.fixture(autouse=True)
def _fresh_port_instrumentation():
    TI.reset_instrumentation()
    yield
    TI.reset_instrumentation()


@pytest.fixture
def world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def tiny_cfg():
    return reduced(get_config("countdown-100m"), **TINY)


def reference_state_and_batches(n_batches, b=8, seed=0):
    """The reference's initial state and batches of ``b`` rows, as numpy."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models.inputs import make_batch as jmake_batch
    from repro.train import loop as JLoop
    from repro.train import optimizer as JO

    jcfg = jreduced(jget_config("countdown-100m"), **TINY)
    js = JLoop.init_state(jcfg, JO.OptConfig(), jax.random.PRNGKey(seed))
    bs = [jmake_batch(jcfg, batch=b, seq_len=SEQ, seed=100 + i) for i in range(n_batches)]
    return jcfg, js, bs


def to_torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


# --------------------------------------------------------------------------
# the codec
# --------------------------------------------------------------------------

def codec_inputs():
    rng = np.random.default_rng(0)
    return [rng.normal(0, 1, (7, 5)).astype(np.float32),
            (rng.normal(0, 1e-3, (300,)) * (rng.random(300) > 0.5)).astype(np.float32),
            np.zeros((4,), np.float32),
            np.array([127.0, 0.5, -1.5, 2.5, -3.5], np.float32),    # ties: scale 1
            rng.normal(0, 3, (2, 3, 4)).astype(np.float32)]


@pytest.mark.parametrize("i", range(5))
def test_quantize_is_bit_equal_to_the_reference(i):
    import jax.numpy as jnp

    from repro.dist import compression as JC

    g = codec_inputs()[i]
    jq, js = JC._quantize(jnp.asarray(g))
    q, s = TC._quantize(torch.from_numpy(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    back = TC._dequantize(q, s)
    assert np.array_equal(back.numpy(), np.asarray(JC._dequantize(jq, js)))
    assert float((back - torch.from_numpy(g)).abs().max()) <= float(s) / 2


def half_lsb(g):
    """Half a quantisation step of ``g``'s leaf, plus one fp32 ulp of its
    largest element for the rounding of ``codes * scale`` and of the
    difference taken to compare it."""
    scale = float(TC._quantize(g)[1])
    return scale / 2 + 127 * scale * 2.0 ** -23


def reference_compressed_psum(gs, mean, split=False):
    """The reference's ``compressed_psum`` (or its start/wait pair, with
    ``split``) under a 1-device mesh, in mode off."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.dist import compression as JC
    from repro.dist.compat import set_mesh, shard_map

    mesh = jax.make_mesh((1,), ("r",))

    def f(g):
        if split:
            return JC.compressed_psum_wait(JC.compressed_psum_start(g, "r", mean=mean))
        return JC.compressed_psum(g, "r", mean=mean)

    spec = [P()] * len(gs)
    with set_mesh(mesh):
        out = shard_map(f, mesh=mesh, in_specs=(spec,), out_specs=spec,
                        manual_axes=("r",))([jnp.asarray(g) for g in gs])
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("mean", [False, True])
def test_compressed_psum_equals_the_reference_in_a_world_of_one(world_of_one, mean):
    gs = codec_inputs()
    want = reference_compressed_psum(gs, mean)
    got = TC.compressed_psum([torch.from_numpy(g) for g in gs], None, mean=mean)
    for g, a, w in zip(gs, got, want):
        assert a.dtype == torch.float32 and a.shape == g.shape
        assert a.numpy().tobytes() == w.tobytes()
        assert float((a - torch.from_numpy(g)).abs().max()) <= half_lsb(torch.from_numpy(g))


@pytest.mark.parametrize("mode", ["off", "profile"])
def test_compressed_psum_async_pair_matches_blocking(world_of_one, mode):
    """The start/wait pair is numerically the blocking path and the
    reference's pair; in profile mode it books one call as the async
    phases ``dispatch_enter -> wait_enter -> barrier_exit -> copy_exit``."""
    gs = codec_inputs()
    tgs = [torch.from_numpy(g) for g in gs]
    blocking = TC.compressed_psum(tgs, None)
    events = []
    TI.set_event_sink(lambda r, p, c, t: events.append((r, p, c)))
    TI.set_mode(mode)
    TI.enable_events(mode == "profile")
    handle = TC.compressed_psum_start(tgs, None)
    overlapped = [g * 2.0 for g in tgs]                 # compute while the gather flies
    split = TC.compressed_psum_wait(handle)
    want = reference_compressed_psum(gs, False, split=True)
    for a, b, w in zip(split, blocking, want):
        assert torch.equal(a, b)
        assert a.numpy().tobytes() == w.tobytes()
    assert all(torch.equal(o, g * 2.0) for o, g in zip(overlapped, tgs))
    if mode == "profile":
        assert events == [(0, p, 1) for p in ("dispatch_enter", "wait_enter",
                                              "barrier_exit", "copy_exit")]
    else:
        assert events == []


def test_compression_ratio_matches_reference():
    import jax.numpy as jnp

    from repro.dist import compression as JC

    gs = codec_inputs()
    want = JC.compression_ratio([jnp.asarray(g) for g in gs])
    assert TC.compression_ratio([torch.from_numpy(g) for g in gs]) == pytest.approx(want,
                                                                                  rel=1e-12)


# --------------------------------------------------------------------------
# a world of 1
# --------------------------------------------------------------------------

def fresh_state(tcfg, js):
    return bridge.state_from_numpy(tcfg, js, "cpu")


def adamw_on(tcfg, state, grads, opt_cfg):
    """``state`` after one AdamW update with ``grads``, and its metrics."""
    params, opt, metrics = adamw_update(state["params"], grads, state["opt"], opt_cfg,
                                        decay_mask(tcfg, state["params"]))
    return {"params": params, "opt": opt}, metrics


def test_pod_step_in_a_world_of_one(world_of_one):
    """``manual`` equals ``make_train_step`` bit for bit.  ``compressed``
    keeps the loss; its reduced gradients lie within ½ LSB of the exact
    ones element by element, and its step equals AdamW on exactly those
    gradients, so it books one instrumented call and nothing else
    differs."""
    import jax

    jcfg, js, bs = reference_state_and_batches(1)
    js = jax.tree.map(np.asarray, js)
    tcfg = tiny_cfg()
    opt_cfg = OptConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    batch = to_torch_batch(bs[0])
    plain, mp_ = TLoop.make_train_step(tcfg, opt_cfg)(fresh_state(tcfg, js), batch)
    manual, mm = TLoop.make_pod_train_step(
        tcfg, opt_cfg, None, TLoop.TrainConfig(pod_reduce="manual"))(fresh_state(tcfg, js), batch)
    for k in ("loss", "grad_norm", "lr"):
        assert torch.equal(mm[k], mp_[k]), k
    for a, b in zip(leaves(manual), leaves(plain)):
        assert torch.equal(a, b)

    _, _, grads = TLoop._grads(tcfg, fresh_state(tcfg, js)["params"], batch)
    mean = TC.compressed_psum(grads, None, mean=True)
    for g, c in zip(leaves(grads), leaves(mean)):
        assert c.dtype == g.dtype and c.shape == g.shape
        assert float((c - g).abs().max()) <= half_lsb(g)
    assert not all(torch.equal(c, g) for g, c in zip(leaves(grads), leaves(mean)))
    want, wm = adamw_on(tcfg, fresh_state(tcfg, js), mean, opt_cfg)
    TI.set_mode("profile")
    TI.enable_events(True)
    gov = Governor(policy=COUNTDOWN_SLACK)
    TI.get_event_bus().subscribe(gov)
    comp, mc = TLoop.make_pod_train_step(
        tcfg, opt_cfg, None, TLoop.TrainConfig(pod_reduce="compressed"))(
            fresh_state(tcfg, js), batch)
    assert gov.finalize().n_calls == 1                 # one instrumented all-gather
    assert torch.equal(mc["loss"], mp_["loss"])
    assert torch.equal(mc["grad_norm"], wm["grad_norm"])
    assert not torch.equal(mc["grad_norm"], mp_["grad_norm"])
    for a, b in zip(leaves(comp), leaves(want)):
        assert torch.equal(a, b)


def test_warm_up_counts_no_call_and_emits_no_event(world_of_one):
    """The launcher warms the communicators before its first step: that
    costs no call id and publishes nothing, so the first instrumented call
    is still call 1."""
    events = []
    TI.set_event_sink(lambda r, p, c, t: events.append((r, p, c)))
    TI.set_mode("profile")
    TI.enable_events(True)
    TI.warm_up(torch.device("cpu"))
    assert events == []
    TI.cd_psum(torch.ones(3))
    assert events == [(0, p, 1) for p in ("barrier_enter", "barrier_exit", "copy_exit")]


def test_pod_step_refuses_what_it_does_not_take(world_of_one):
    tcfg = tiny_cfg()
    with pytest.raises(ValueError, match="pod_reduce"):
        TLoop.make_pod_train_step(tcfg, OptConfig(), None, TLoop.TrainConfig(pod_reduce="x"))


# --------------------------------------------------------------------------
# four gloo ranks against the reference's whole-batch step
# --------------------------------------------------------------------------

def rank_main(rank, store_path, work_dir):
    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=60))
    try:
        with open(os.path.join(work_dir, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        tcfg = tiny_cfg()
        state = bridge.state_from_numpy(tcfg, inputs["state"], "cpu")
        step = TLoop.make_pod_train_step(tcfg, OptConfig(**inputs["opt"]), None,
                                         TLoop.TrainConfig(pod_reduce="manual"))
        events = []
        TI.set_mode("profile")
        TI.enable_events(True)
        gov = Governor(policy=COUNTDOWN_SLACK)
        TI.get_event_bus().subscribe(gov)
        TI.set_event_sink(lambda r, p, c, t: events.append((int(r), p, int(c))))
        losses = []
        for b in inputs["batches"]:
            state, m = step(state, to_torch_batch(b))
            losses.append(float(m["loss"]))
        rep = gov.finalize()
        TI.reset_instrumentation()
        out = {"losses": losses, "n_calls": rep.n_calls, "events": events,
               "params": bridge.params_to_numpy(tcfg, state["params"]),
               "compressed": compressed_on_rank(tcfg, inputs)}
        with open(os.path.join(work_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def compressed_on_rank(tcfg, inputs):
    """This rank's exact gradients of its shard of the first batch, their
    ``compressed_psum`` mean over the world, and one ``"compressed"`` pod
    step from the initial state: its loss, its booked calls, and whether it
    equals AdamW on that mean bit for bit."""
    opt_cfg = OptConfig(**inputs["opt"])
    batch = to_torch_batch(inputs["batches"][0])
    fresh = lambda: bridge.state_from_numpy(tcfg, inputs["state"], "cpu")   # noqa: E731
    _, _, grads = TLoop._grads(tcfg, fresh()["params"], TLoop.shard_of(batch))
    mean = TC.compressed_psum(grads, None, mean=True)
    want, _ = adamw_on(tcfg, fresh(), mean, opt_cfg)
    TI.set_mode("profile")
    TI.enable_events(True)
    gov = Governor(policy=COUNTDOWN_SLACK)
    TI.get_event_bus().subscribe(gov)
    step = TLoop.make_pod_train_step(tcfg, opt_cfg, None,
                                     TLoop.TrainConfig(pod_reduce="compressed"))
    state, m = step(fresh(), batch)
    n_calls = gov.finalize().n_calls
    TI.reset_instrumentation()
    return {"grads": [g.numpy() for g in leaves(grads)],
            "mean": [g.numpy() for g in leaves(mean)],
            "loss": float(m["loss"]), "n_calls": n_calls,
            "step_is_adamw_on_mean": all(torch.equal(a, b)
                                         for a, b in zip(leaves(state), leaves(want)))}


def test_four_gloo_ranks_equal_the_reference_whole_batch_step(tmp_path):
    import jax

    from repro.train import loop as JLoop
    from repro.train import optimizer as JO

    jcfg, js, bs = reference_state_and_batches(STEPS)
    opt = dict(warmup_steps=1, total_steps=10)           # the default lr, 3e-4
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump({"state": jax.tree.map(np.asarray, js), "opt": opt,
                     "batches": [{k: np.asarray(v) for k, v in b.items()} for b in bs]}, f)
    ctx = mp.start_processes(rank_main, args=(str(tmp_path / "store"), str(tmp_path)),
                             nprocs=WORLD, join=False, start_method="spawn")
    jstep = jax.jit(JLoop.make_train_step(jcfg, JO.OptConfig(**opt)))
    want_losses = []
    for b in bs:
        js, m = jstep(js, b)
        want_losses.append(float(m["loss"]))
    want = jax.tree.map(np.asarray, js["params"])
    deadline = time.monotonic() + JOIN_LIMIT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"the {WORLD} ranks did not finish in {JOIN_LIMIT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    for r in range(WORLD):
        with open(tmp_path / f"{r}.pkl", "rb") as f:
            got = pickle.load(f)
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5, atol=0)
        for g, w in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(want)):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
        assert got["n_calls"] == STEPS, got["n_calls"]
        assert got["events"] == [(r, p, c) for c in range(1, STEPS + 1)
                                 for p in ("barrier_enter", "barrier_exit", "copy_exit")]
    check_compressed_ranks(tmp_path)


def check_compressed_ranks(tmp_path):
    """Every rank's ``compressed_psum`` mean is the reference codec's
    dequantised shards of all 4 ranks, summed in fp32 and divided by 4
    (atol 1e-5 of the leaf's largest scale: a different order of the four
    fp32 additions; a code paired with another rank's scale, or a missing
    division, is off by whole steps); every rank's compressed pod step is
    AdamW on that mean, books one call, and has the manual step's loss."""
    import jax.numpy as jnp

    from repro.dist import compression as JC

    got = []
    for r in range(WORLD):
        with open(tmp_path / f"{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    comp = [g["compressed"] for g in got]
    for i in range(len(comp[0]["grads"])):
        shards = [JC._quantize(jnp.asarray(c["grads"][i])) for c in comp]
        deq = np.stack([np.asarray(q).astype(np.float32) * np.float32(s) for q, s in shards])
        want = deq.sum(axis=0, dtype=np.float32) / np.float32(WORLD)
        tol = 1e-5 * max(float(s) for _, s in shards)
        assert not np.allclose(comp[0]["grads"][i], comp[1]["grads"][i])    # the shards differ
        for c in comp:
            np.testing.assert_allclose(c["mean"][i], want, rtol=0, atol=tol)
    for g in got:
        c = g["compressed"]
        assert c["step_is_adamw_on_mean"] and c["n_calls"] == 1
        assert c["loss"] == g["losses"][0]


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def test_launcher_live_events_books_two_calls_a_step(capsys):
    res = ltrain.main(["--reduced", "--steps", "3", "--device", "cpu", "--live-events"])
    assert res["step"] == "build_live" and res["world"] == 1
    assert res["governor"]["n_calls"] == 6
    assert all(math.isfinite(x) for x in res["losses"] + res["grad_norms"])
    assert not dist.is_initialized()                   # the world of 1 was taken down
    out = capsys.readouterr().out.splitlines()
    assert any(line.startswith("[train] governor calls=6") for line in out), out
    assert json.loads(out[-1])["losses"] == res["losses"]


def test_launcher_runs_make_train_step_on_the_reference_defaults():
    """Without --live-events a world of 1 runs ``make_train_step`` with the
    reference's schedule (warmup min(100, steps // 10 + 1)) and remat on,
    on the loader's batches from the seed: the same numbers as that step
    driven by hand."""
    from repro_torch.train.data import DataLoader

    res = ltrain.main(["--reduced", "--steps", "4", "--batch", "2", "--seq", "16",
                       "--device", "cpu", "--seed", "3"])
    assert res["step"] == "build" and res["governor"] is None
    cfg = reduced(get_config("countdown-100m"))
    assert cfg.remat
    opt_cfg = OptConfig(lr=3e-4, warmup_steps=1, total_steps=4)
    state = TLoop.init_state(cfg, opt_cfg, torch.Generator().manual_seed(3), "cpu")
    step = TLoop.make_train_step(cfg, opt_cfg)
    loader = DataLoader(cfg, batch=2, seq_len=16, seed=3)
    try:
        losses = [float(step(state, next(loader))[1]["loss"]) for _ in range(4)]
    finally:
        loader.close()
    assert losses == res["losses"]


@pytest.mark.parametrize("flag", [["--checkpoint-dir", "ckpt"], ["--save-every", "5"],
                                  ["--resume"], ["--fail-at", "3"], ["--model-parallel", "2"],
                                  ["--trace-out", "t.jsonl"], ["--power-cap", "300"],
                                  ["--perfetto-out", "p.json"], ["--metrics-out", "m.jsonl"],
                                  ["--dashboard"]])
def test_launcher_refuses_the_flags_that_wait(flag):
    with pytest.raises(SystemExit, match=r"not ported to repro_torch yet \(ROADMAP.md, queue 1, "
                                         r"item [578]"):
        ltrain.main(["--reduced", "--steps", "1", "--device", "cpu"] + flag)
