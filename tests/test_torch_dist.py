"""Restart after failure on the port (``repro_torch.dist.checkpoint``,
``repro_torch.dist.elastic``, the training launcher's checkpoint and
failure flags) against the JAX package, on the CPU.

* The reference's checkpoint-manager cases on both packages: retention and
  latest, no tmp file left behind (and one from a crash swept), async
  save, and the hypothesis round trip.
* Files cross packages: a reduced llama3.2-1b training state either
  package's manager wrote is restored by the other's, bit-exact, and the
  next step from it meets the training parity bars (loss rtol 1e-5, grad
  norm rtol 1e-3, parameters atol 1e-5); bf16 and float8 leaves bit-exact
  both ways.
* The async save copies before it returns: a leaf updated in place right
  after ``save`` is written with its old values.
* ``FailureInjector`` is the reference's text; ``ElasticMesh`` lays the
  survivors out as the reference's mesh does; a world of 1 cannot rebuild.
* The launcher: ``--resume`` starts at the newest step and continues the
  schedule; a failure raises the reference's errors in a world of 1; over
  4 spawned gloo ranks, ``--fail-at 12 --save-every 5`` restores step 10
  on 3 ranks and its losses equal an in-process replay from that file to
  1e-6, the failed rank takes no step after 12, and every rank tears its
  group down; a failure before the first save restarts from init; one
  whose survivors do not divide the batch trains on, the batch replicated
  over the survivors (the 2-D sharded step's sanitized batch spec), with
  the in-process replay's losses; survivors that train on past the world
  group's timeout finish, since the failed rank leaves after the rebuild.

JAX is imported inside the reference-side helpers only, so the spawned
ranks, which import this module, load torch alone.
"""
import dataclasses
import importlib
import inspect
import os
import pickle
import socket
import tempfile
import threading
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.dist import checkpoint as TCK
from repro_torch.dist import elastic as TEL
from repro_torch.launch import train as ltrain
from repro_torch.train import loop as TLoop
from repro_torch.train.data import DataLoader
from repro_torch.train.optimizer import OptConfig, schedule

WORLD = 4
JOIN_LIMIT_S = 240.0
PKGS = ("repro", "repro_torch")
LOSS_TOL = dict(rtol=1e-5, atol=0)


def manager(pkg):
    return importlib.import_module(f"{pkg}.dist.checkpoint").CheckpointManager


def same_leaves(got, want):
    """Two trees of numpy/torch leaves in the checkpoint order: same dtypes
    (by name), shapes and bits."""
    got, want = TCK.flatten(got), TCK.flatten(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = (x.detach().cpu() if isinstance(x, torch.Tensor) else np.asarray(x)
                for x in (g, w))
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype).removeprefix("torch.")
        assert tuple(g.shape) == tuple(w.shape)
        assert raw(g) == raw(w)


def raw(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


# --------------------------------------------------------------------------
# the reference's manager cases, on both packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_checkpoint_manager_gc_and_latest(pkg, tmp_path):
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    mgr = manager(pkg)(str(tmp_path), keep=2)
    for step in [1, 5, 9]:
        mgr.save(step, tree)
    assert mgr.all_steps() == [5, 9]          # step 1 garbage-collected
    assert mgr.latest_step() == 9
    step, restored = mgr.restore_latest(tree)
    assert step == 9
    np.testing.assert_array_equal(restored["w"], tree["w"])
    with pytest.raises(FileNotFoundError):
        mgr.load(1, tree)


@pytest.mark.parametrize("pkg", PKGS)
def test_checkpoint_atomicity_no_tmp_left_behind(pkg, tmp_path):
    tree = {"w": np.zeros((4,), np.float32)}
    (tmp_path / "step_00000007.npz.tmp").write_bytes(b"a crash mid-write")
    mgr = manager(pkg)(str(tmp_path), keep=3)
    assert os.listdir(tmp_path) == []          # the crash's litter swept
    mgr.save(3, tree)
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    assert mgr.all_steps() == [3]


@pytest.mark.parametrize("pkg", PKGS)
def test_checkpoint_async_save(pkg, tmp_path):
    tree = {"w": np.ones((8, 8), np.float32)}
    mgr = manager(pkg)(str(tmp_path), keep=2, async_save=True)
    mgr.save(1, tree)
    mgr.wait()
    assert mgr.latest_step() == 1


@pytest.mark.parametrize("pkg", PKGS)
@given(seed=st.integers(min_value=0, max_value=10_000))
@settings(max_examples=20, deadline=None)
def test_checkpoint_roundtrip(pkg, seed):
    """``tests/test_properties.py``'s round trip; the port's file also
    restores in the other package, leaf for leaf."""
    rng = np.random.default_rng(seed)
    tree = {
        "a": rng.normal(size=(3, 5)).astype(np.float32),
        "b": {"c": rng.integers(0, 10, (4,)).astype(np.int32),
              "d": [rng.normal(size=(2, 2)).astype(np.float32)]},
    }
    other = PKGS[1 - PKGS.index(pkg)]
    with tempfile.TemporaryDirectory() as d:
        mgr = manager(pkg)(d, keep=2)
        mgr.save(seed % 7, tree)
        step, restored = mgr.restore_latest(tree)
        assert step == seed % 7
        same_leaves(restored, tree)
        same_leaves(manager(other)(d).load(step, tree), tree)


# --------------------------------------------------------------------------
# files across the packages
# --------------------------------------------------------------------------

def llama_cfgs():
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced

    return jreduced(jget_config("llama3.2-1b")), reduced(get_config("llama3.2-1b"))


def reference_step(jcfg, opt_cfg):
    import jax

    from repro.train import loop as JLoop
    from repro.train import optimizer as JO

    jopt = JO.OptConfig(**dataclasses.asdict(opt_cfg))
    return jax.jit(JLoop.make_train_step(jcfg, jopt))


def train_batch(jcfg, seed):
    from repro.models.inputs import make_batch as jmake_batch

    jb = jmake_batch(jcfg, batch=2, seq_len=33, seed=seed, kind="train")
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


@pytest.mark.parametrize("writer", PKGS)
def test_training_state_crosses_packages_and_steps_alike(writer, tmp_path):
    """A reduced llama3.2-1b state after one step, written by ``writer``'s
    manager (the port's through ``bridge.state_to_numpy``, as its launcher
    saves), restored by the other's into a fresh state's skeleton: every
    leaf bit-exact, then one step on each side from it at the parity bars."""
    import jax

    from repro.dist.checkpoint import CheckpointManager as JManager
    from repro.train import loop as JLoop
    from repro.train import optimizer as JO

    jcfg, tcfg = llama_cfgs()
    opt_cfg = OptConfig(warmup_steps=1, total_steps=10)
    jstep = reference_step(jcfg, opt_cfg)
    js = JLoop.init_state(jcfg, JO.OptConfig(), jax.random.PRNGKey(0))
    js, _ = jstep(js, train_batch(jcfg, 1)[0])
    fresh = TLoop.init_state(tcfg, opt_cfg, torch.Generator().manual_seed(5), "cpu")
    if writer == "repro":
        JManager(str(tmp_path)).save(1, js)
        want = jax.tree.map(np.asarray, js)
        tree = TCK.CheckpointManager(str(tmp_path)).load(1, bridge.state_to_numpy(tcfg, fresh))
        same_leaves(tree, want)
        ts = bridge.state_from_numpy(tcfg, tree, "cpu")
    else:
        ts = bridge.state_from_numpy(tcfg, jax.tree.map(np.asarray, js), "cpu")
        ts, _ = TLoop.make_train_step(tcfg, opt_cfg)(ts, train_batch(jcfg, 2)[1])
        want = bridge.state_to_numpy(tcfg, ts)
        TCK.CheckpointManager(str(tmp_path)).save(2, want)
        skel = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), js)
        js = JManager(str(tmp_path)).load(2, skel)
        same_leaves(js, want)
        assert jax.tree.structure(js) == jax.tree.structure(skel)
    assert int(ts["opt"]["step"]) == int(js["opt"]["step"])
    jb, tb = train_batch(jcfg, 3)
    js, jm = jstep(js, jb)
    ts, tm = TLoop.make_train_step(tcfg, opt_cfg)(ts, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    for g, w in zip(jax.tree.leaves(bridge.params_to_numpy(tcfg, ts["params"])),
                    jax.tree.leaves(jax.tree.map(np.asarray, js["params"]))):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


LOW = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


def low_precision_trees(seed=0):
    """The same values as a reference tree (jnp leaves) and a port tree
    (torch leaves, keys in another order): every low-precision dtype, fp32
    and int32."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    x = rng.normal(0, 3, (3, 7)).astype(np.float32)
    j = {name: jnp.asarray(x).astype(getattr(jnp, name)) for name in LOW}
    j["f32"] = jnp.asarray(x)
    j["i32"] = jnp.asarray(rng.integers(-9, 9, (5,)).astype(np.int32))
    t = {}
    for k in reversed(list(j)):               # another key order than the reference tree's
        a = np.array(j[k])
        if k in LOW:                          # the bits, as torch's dtype of that name
            a = a.view({1: np.uint8, 2: np.int16}[a.itemsize])
        t[k] = torch.from_numpy(a)
        if k in LOW:
            t[k] = t[k].view(getattr(torch, k))
    return j, t


@pytest.mark.parametrize("writer", PKGS)
def test_low_precision_leaves_cross_bit_exact(writer, tmp_path):
    import jax

    from repro.dist.checkpoint import CheckpointManager as JManager

    j, t = low_precision_trees()
    same_leaves(t, jax.tree.map(np.asarray, j))          # the two trees hold the same bits
    if writer == "repro":
        JManager(str(tmp_path)).save(4, j)
        got = TCK.CheckpointManager(str(tmp_path)).load(4, t)
        assert list(got) == list(t)                         # the skeleton's key order
        same_leaves(got, t)
    else:
        TCK.CheckpointManager(str(tmp_path)).save(4, t)
        got = JManager(str(tmp_path)).load(4, j)
        same_leaves(jax.tree.map(np.asarray, got), jax.tree.map(np.asarray, j))
        # a numpy skeleton of the reference's dtypes takes them without ml_dtypes here
        same_leaves(TCK.CheckpointManager(str(tmp_path)).load(4, jax.tree.map(np.asarray, j)),
                    t)


def test_load_refuses_a_skeleton_that_disagrees(tmp_path):
    mgr = TCK.CheckpointManager(str(tmp_path))
    tree = {"a": torch.zeros(2, 3), "b": torch.zeros(4, dtype=torch.int32)}
    mgr.save(1, tree)
    for bad, what in (({"a": torch.zeros(2, 3)}, "2 leaves"),
                      ({"a": torch.zeros(3, 2), "b": tree["b"]}, "skeleton"),
                      ({"a": torch.zeros(2, 3, dtype=torch.bfloat16), "b": tree["b"]},
                       "skeleton"),
                      ({"a": np.zeros((2, 3), np.float64), "b": tree["b"]}, "skeleton")):
        with pytest.raises(ValueError, match=what):
            mgr.load(1, bad)


# --------------------------------------------------------------------------
# the async save and in-place updates
# --------------------------------------------------------------------------

def test_async_save_writes_the_values_at_save_not_after(tmp_path):
    """The port's AdamW updates the state in place.  The write is held back
    until after the tree was updated in place (CPU tensors, whose
    ``.numpy()`` shares their memory, and a numpy leaf): the file still
    holds the values at ``save``."""
    mgr = TCK.CheckpointManager(str(tmp_path), async_save=True)
    gate = threading.Event()
    write = mgr._write
    mgr._write = lambda step, leaves: (gate.wait(10), write(step, leaves))
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "h": torch.ones(5, dtype=torch.bfloat16), "n": np.arange(3, dtype=np.int32),
            "step": torch.tensor(7, dtype=torch.int32)}
    want = {k: v.clone() if isinstance(v, torch.Tensor) else v.copy() for k, v in tree.items()}
    mgr.save(1, tree)
    for v in tree.values():
        v += 1
    gate.set()
    mgr.wait()
    same_leaves(mgr.load(1, want), want)


# --------------------------------------------------------------------------
# the elastic rank set and the failure injector
# --------------------------------------------------------------------------

def test_failure_injector_is_the_reference_text():
    from repro.dist import elastic as JEL

    assert inspect.getsource(TEL.FailureInjector) == inspect.getsource(JEL.FailureInjector)
    inj = TEL.FailureInjector(fail_at_steps=[10, 12], device_ids=[3])
    assert inj.check(9) is None and inj.check(10) == 3
    assert inj.check(10) is None and inj.pending() == {12: 3}
    with pytest.raises(ValueError):
        TEL.FailureInjector([1], [])


@pytest.mark.parametrize("survivors", range(1, 9))
def test_elastic_layout_follows_the_reference_rule(survivors, monkeypatch):
    """A world of 8 with ``8 - survivors`` ranks failed: for model-parallel
    1-4 the port's (data, model) layout of the surviving ranks is the
    reference's mesh of the surviving devices (ids), and the group and the
    ``DeviceMesh`` are made over exactly those ranks."""
    from repro.dist import elastic as JEL

    failed = np.random.default_rng(survivors).permutation(8)[:8 - survivors]
    devices = [types.SimpleNamespace(id=i) for i in range(8)]
    monkeypatch.setattr(JEL, "jax", types.SimpleNamespace(
        devices=lambda: devices,
        sharding=types.SimpleNamespace(Mesh=lambda grid, names: (grid, names))))
    made = []
    monkeypatch.setattr(TEL, "dist", types.SimpleNamespace(
        get_world_size=lambda: 8, group=types.SimpleNamespace(WORLD="world"),
        new_group=lambda ranks: made.append(list(ranks)) or ("group", tuple(ranks))))
    monkeypatch.setattr(TEL, "device_mesh", lambda layout, names: ("mesh", layout, names))
    jem, tem = JEL.ElasticMesh(), TEL.ElasticMesh()
    for r in failed:
        jem.fail(int(r))
        tem.fail(int(r))
    assert tem.failed_ids() == jem.failed_ids()
    assert tem.healthy_devices() == [d.id for d in jem.healthy_devices()]
    for k in range(1, 5):
        grid, names = jem.build(model_parallel=k)
        mesh = tem.build(model_parallel=k)
        want = np.vectorize(lambda d: d.id, otypes=[np.int64])(grid)
        np.testing.assert_array_equal(mesh.layout, want)
        assert mesh.axis_names == names == ("data", "model")
        assert mesh.group == ("world" if survivors == 8 else ("group", tuple(mesh.ranks)))
        assert mesh.device_mesh == ("mesh", mesh.layout, ("data", "model"))
    assert all(m == tem.healthy_devices() for m in made)


def test_a_world_of_one_cannot_rebuild():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        em = TEL.ElasticMesh()
        mesh = em.build(model_parallel=2)
        assert mesh.ranks == [0] and mesh.group is dist.group.WORLD
        em.fail(0)
        with pytest.raises(RuntimeError, match="no healthy devices"):
            em.build()
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# the launcher in a world of 1
# --------------------------------------------------------------------------

TINY = ["--reduced", "--batch", "2", "--seq", "16", "--device", "cpu"]


@pytest.mark.parametrize("with_dir, error", [
    (False, "node failure without checkpointing enabled"),
    (True, "ElasticMesh: no healthy devices left to build from")])
def test_launcher_failure_in_a_world_of_one_raises(with_dir, error, tmp_path):
    argv = TINY + ["--steps", "4", "--fail-at", "3", "--save-every", "2"]
    if with_dir:
        argv += ["--checkpoint-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match=error):
        ltrain.main(argv)
    assert not dist.is_initialized()
    if with_dir:                         # restored before the rebuild, as the reference
        assert TCK.CheckpointManager(str(tmp_path)).all_steps() == [2]


def first_loss_from(ckpt_dir, step, cfg, opt_cfg, batch, seq, seed=0):
    """The loss of ``step``'s file on a fresh loader's first batch, as the
    resumed run's first step computes it."""
    fresh = TLoop.init_state(cfg, opt_cfg, torch.Generator().manual_seed(seed + 1), "cpu")
    tree = TCK.CheckpointManager(ckpt_dir).load(step, bridge.state_to_numpy(cfg, fresh))
    state = bridge.state_from_numpy(cfg, tree, "cpu")
    loader = DataLoader(cfg, batch=batch, seq_len=seq, seed=seed)
    try:
        return float(TLoop._grads(cfg, state["params"], next(loader))[0])
    finally:
        loader.close()


def test_launcher_resume_starts_at_the_latest_step(tmp_path):
    """``--resume`` on an existing directory starts at its newest step: the
    learning rates continue the schedule from the restored step counter,
    and the first loss is the restored parameters' on the fresh loader's
    first batch."""
    d = str(tmp_path)
    first = ltrain.main(TINY + ["--steps", "4", "--save-every", "2", "--checkpoint-dir", d])
    assert first["start_step"] == 0 and first["checkpoint_steps"] == [2, 4]
    res = ltrain.main(TINY + ["--steps", "6", "--save-every", "2", "--checkpoint-dir", d,
                              "--resume"])
    assert res["start_step"] == 4 and len(res["losses"]) == 2 and res["restarts"] == []
    assert TCK.CheckpointManager(d).all_steps() == [2, 4, 6]
    opt_cfg = OptConfig(lr=3e-4, warmup_steps=1, total_steps=6)
    want = [float(schedule(opt_cfg, torch.tensor(s))) for s in (5, 6)]
    np.testing.assert_allclose(res["lrs"], want, rtol=1e-6)
    cfg = dataclasses.replace(reduced(get_config("countdown-100m")), remat=True)
    np.testing.assert_allclose(res["losses"][0], first_loss_from(d, 4, cfg, opt_cfg, 2, 16),
                               rtol=1e-6)
    assert not dist.is_initialized()


# --------------------------------------------------------------------------
# four gloo ranks: fail, restore, rebuild
# --------------------------------------------------------------------------

ELASTIC = ["--reduced", "--steps", "20", "--batch", "12", "--seq", "32", "--device", "cpu",
           "--save-every", "5", "--fail-at", "12"]
COLD = ["--reduced", "--steps", "6", "--batch", "12", "--seq", "32", "--device", "cpu",
        "--save-every", "5", "--fail-at", "3"]
UNEVEN = ["--reduced", "--steps", "4", "--batch", "8", "--seq", "16", "--device", "cpu",
          "--save-every", "1", "--fail-at", "2"]
# a world group timing out after SHORT_S, and survivors that each sleep
# SLOW_S a step after the failure: they outlast that timeout (the failure
# comes after 2 steps, so the failed rank's run stays short beside it)
OUTLAST = ["--reduced", "--steps", "6", "--batch", "12", "--seq", "32", "--device", "cpu",
           "--save-every", "2", "--fail-at", "2"]
SHORT_S, SLOW_S = 8.0, 2.5


def slow_survivors(make):
    """``make_train_step`` whose steps sleep ``SLOW_S`` first from its
    second build on: the step the launcher builds over the survivors'
    mesh after the rebuild."""
    builds = []

    def made(cfg, opt_cfg, *rest):
        step = make(cfg, opt_cfg, *rest)
        builds.append(step)
        if len(builds) == 1:
            return step

        def slow(state, batch):
            time.sleep(SLOW_S)
            return step(state, batch)
        return slow
    return made


def outlast_run(ports, ckpt):
    """The launcher inside a world group made with a ``SHORT_S`` timeout
    (the ranks first line up in a group with the default one)."""
    import datetime

    os.environ["MASTER_PORT"] = str(ports[0])
    dist.init_process_group("gloo", init_method="env://")
    dist.barrier()
    dist.destroy_process_group()
    os.environ["MASTER_PORT"] = str(ports[1])
    dist.init_process_group("gloo", init_method="env://",
                            timeout=datetime.timedelta(seconds=SHORT_S))
    try:
        ltrain.make_train_step = slow_survivors(TLoop.make_train_step)
        t0 = time.monotonic()
        res = ltrain.run(ltrain.parser().parse_args(OUTLAST + ["--checkpoint-dir", ckpt]))
        res["run_s"] = time.monotonic() - t0
    except RuntimeError as e:
        res = {"error": str(e)}
    finally:
        ltrain.make_train_step = TLoop.make_train_step
        dist.destroy_process_group()
    return res


def elastic_rank(rank, ports, work_dir):
    """One rank of ``torchrun``'s world (its environment set by hand): the
    elastic run, the failure before the first save, and a failure whose 3
    survivors do not divide the batch, each joining and tearing down its
    own group through the launcher."""
    torch.set_num_threads(1)            # as torchrun's ranks: one core each
    os.environ.update(MASTER_ADDR="127.0.0.1", RANK=str(rank), WORLD_SIZE=str(WORLD))
    out = {}
    for name, port, argv in (("elastic", ports[0], ELASTIC), ("cold", ports[1], COLD),
                             ("uneven", ports[2], UNEVEN)):
        os.environ["MASTER_PORT"] = str(port)
        ckpt = os.path.join(work_dir, name)
        try:
            res = ltrain.run(ltrain.parser().parse_args(argv + ["--checkpoint-dir", ckpt]))
        except ValueError as e:
            res = {"error": str(e)}
        out[name] = {**res, "torn_down": not dist.is_initialized()}
    out["outlast"] = outlast_run(ports[3:], os.path.join(work_dir, "outlast"))
    with open(os.path.join(work_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def replay(cfg, opt_cfg, state, first_batch, n, batch, seq):
    """``n`` whole-batch steps from ``state`` on the loader's batches from
    index ``first_batch`` on."""
    loader = DataLoader(cfg, batch=batch, seq_len=seq, seed=0)
    try:
        batches = [next(loader) for _ in range(first_batch + n)][first_batch:]
    finally:
        loader.close()
    step = TLoop.make_train_step(cfg, opt_cfg)
    return [float(step(state, b)[1]["loss"]) for b in batches]


def test_four_gloo_ranks_fail_restore_and_rebuild(tmp_path):
    ctx = mp.start_processes(elastic_rank, args=(free_ports(5), str(tmp_path)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_LIMIT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"the {WORLD} ranks did not finish in {JOIN_LIMIT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    got = []
    for r in range(WORLD):
        with open(tmp_path / f"{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    cfg = dataclasses.replace(reduced(get_config("countdown-100m")), remat=True)

    runs = [g["elastic"] for g in got]
    for r, res in enumerate(runs):
        assert res["torn_down"] and res["rank"] == r and res["world"] == WORLD
        assert res["restarts"] == [{"step": 12, "failed_rank": 3, "restored_step": 10,
                                    "survivors": 3}]
    assert len(runs[3]["losses"]) == 12                 # no step after the failure
    assert runs[3]["losses"] == runs[0]["losses"][:12]
    for res in runs[:3]:
        assert res["checkpoint_steps"] == [5, 10, 15, 20]
        assert len(res["losses"]) == 22 and res["losses"] == runs[0]["losses"]
    ckpt = str(tmp_path / "elastic")
    assert TCK.CheckpointManager(ckpt).all_steps() == [10, 15, 20]
    opt_cfg = OptConfig(lr=3e-4, warmup_steps=3, total_steps=20)
    fresh = TLoop.init_state(cfg, opt_cfg, torch.Generator().manual_seed(1), "cpu")
    state = bridge.state_from_numpy(
        cfg, TCK.CheckpointManager(ckpt).load(10, bridge.state_to_numpy(cfg, fresh)), "cpu")
    assert int(state["opt"]["step"]) == 10
    np.testing.assert_allclose(runs[0]["losses"][12:], replay(cfg, opt_cfg, state, 12, 10, 12, 32),
                               rtol=1e-6, atol=0)

    # a failure before the first save: a cold restart from the seed's init
    cold = [g["cold"] for g in got]
    for res in cold:
        assert res["torn_down"]
        assert res["restarts"] == [{"step": 3, "failed_rank": 3, "restored_step": 0,
                                    "survivors": 3}]
    assert len(cold[3]["losses"]) == 3
    res = cold[0]
    assert len(res["losses"]) == 9 and res["checkpoint_steps"] == [5]
    after = np.array(res["grad_norms"][3:])
    assert np.isfinite(after).all() and (after > 0).all()
    assert res["lrs"][3] == res["lrs"][0]               # the step counter starts again
    opt_cfg = OptConfig(lr=3e-4, warmup_steps=1, total_steps=6)
    init = TLoop.init_state(cfg, opt_cfg, torch.Generator().manual_seed(0), "cpu")
    np.testing.assert_allclose(res["losses"][3:5], replay(cfg, opt_cfg, init, 3, 2, 12, 32),
                               rtol=1e-6, atol=0)

    # 3 survivors and a batch of 8: the batch replicates over them, and the
    # survivors' losses are the whole-batch replay's from the file
    uneven = [g["uneven"] for g in got]
    for res in uneven:
        assert "error" not in res and res["torn_down"]
        assert res["restarts"] == [{"step": 2, "failed_rank": 3, "restored_step": 2,
                                    "survivors": 3}]
    assert len(uneven[3]["losses"]) == 2
    for res in uneven[:3]:
        assert res["mesh"] == [3, 1] and res["losses"] == uneven[0]["losses"]
        assert len(res["losses"]) == 4
    ckpt = str(tmp_path / "uneven")
    opt_cfg = OptConfig(lr=3e-4, warmup_steps=1, total_steps=4)
    fresh = TLoop.init_state(cfg, opt_cfg, torch.Generator().manual_seed(1), "cpu")
    state = bridge.state_from_numpy(
        cfg, TCK.CheckpointManager(ckpt).load(2, bridge.state_to_numpy(cfg, fresh)), "cpu")
    np.testing.assert_allclose(uneven[0]["losses"][2:], replay(cfg, opt_cfg, state, 2, 2, 8, 16),
                               rtol=1e-6, atol=0)

    # the survivors outlast the world group's timeout: the failed rank,
    # which takes no part in their collectives, leaves after the rebuild
    outlast = [g["outlast"] for g in got]
    for res in outlast:
        assert "error" not in res, res["error"]
        assert res["restarts"] == [{"step": 2, "failed_rank": 3, "restored_step": 2,
                                    "survivors": 3}]
    assert len(outlast[3]["losses"]) == 2 and outlast[3]["run_s"] < SHORT_S
    for res in outlast[:3]:
        assert len(res["losses"]) == 6 and res["run_s"] > 4 * SLOW_S > SHORT_S
        assert np.isfinite(res["losses"]).all()
