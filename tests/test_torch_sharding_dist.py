"""Sharding inside a pod on spawned gloo ranks, against the port on plain
tensors and the JAX package, on the CPU.

* Tensor-parallel serving of reduced llama3.2-1b (weights from the
  reference's ``init_params``, greedy, fp32) on 2 ranks at model degree 2
  and on 4 ranks at a (2, 2) mesh: every request's tokens equal the port's
  unsharded engine's and the reference's ``ContinuousEngine``'s (and the
  static engine's the reference's ``ServeEngine``'s), with KV heads that
  split over the ranks (8/2 heads) and with ones that do not (the reduced
  config's single KV head).  Each rank's DTensors live on its row's
  model axis; at (2, 2) the continuous engine's 4 slots split over the
  two data rows, each decoding 2 (``test_torch_serve_data_split.py``
  holds the split on its own).  The kernels take
  their plain versions on these CPU tensors, through the same local-shard
  calls as on the card.  One decode step's collectives are counted by kind
  (``CommDebugMode``), and none of them moves a parameter's storage; the
  pool's local shards are the DTensors' own storage, written in place.
  The serve launcher runs ``--model-parallel 2`` over the 2 ranks, and
  ``--fleet`` (held to one engine's tokens in ``test_torch_fleet_dist.py``).
* On the same 2 ranks the static launcher serves mamba2-130m sharded and
  the train launcher takes reduced granite's sharded step.  The other
  families' serving, ``moe_forward`` and the scans on DTensors are held
  to the reference in ``test_torch_sharding_families.py``.
* 2-D sharded training on 4 ranks at (2, 2): three steps of reduced
  llama3.2-1b, granite-moe-3b-a800m (MoE) and internvl2-1b (a frontend
  prefix) through the launcher's ``build`` equal the port's
  single-process ``make_train_step`` and the reference's step (losses
  rtol 1e-4; every gathered parameter at rtol 1e-4 and atol 1e-4), each
  rank holding under half the parameter bytes.
* An elastic restart onto a smaller mesh, the reference's
  ``test_elastic_restart_on_smaller_mesh`` on gloo: the sharded state
  saved under (2, 2) (gathered on every rank's calling thread, written
  asynchronously by the first), two ranks failed, the survivors' mesh
  rebuilt, the state restored through ``load(..., shardings)`` equal to
  the saved one, and a finite step taken on it.

JAX is imported inside the reference-side helpers only, so the spawned
ranks, which import this module, load torch alone.
"""
import dataclasses
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
from repro_torch.tree import leaves

JOIN_LIMIT_S = 240
# (name, config overrides, model degree on 2 ranks / on 4 ranks)
SERVE_CASES = {"hkv2": dict(n_heads=8, n_kv_heads=2, d_head=16),   # KV heads split
               "hkv1": {}}                                          # one KV head: replicated
PROMPT_LEN, N_STEPS, BATCH = 12, 8, 3
TRAIN_STEPS = 3
TRAIN_ARCHS = ("llama3.2-1b", "granite-moe-3b-a800m", "internvl2-1b")


def serve_cfg(name):
    return reduced(get_config("llama3.2-1b"), **SERVE_CASES[name])


def reference_serving(work_dir):
    """The reference's weights for each case, its continuous and static
    engines' greedy tokens, written for the ranks."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import init_params as jinit_params
    from repro.serve import ContinuousEngine as JContinuousEngine
    from repro.serve import ServeEngine as JServeEngine

    out = {}
    for name, mods in SERVE_CASES.items():
        jcfg = jreduced(jget_config("llama3.2-1b"), **mods)
        jp = jinit_params(jcfg, jax.random.PRNGKey(0))
        toks = np.random.default_rng(1).integers(0, jcfg.vocab, (BATCH, PROMPT_LEN))
        toks = toks.astype(np.int32)
        cont = JContinuousEngine(jcfg, jp, n_slots=4, max_len=32, page=8).generate(
            {"tokens": jnp.asarray(toks)}, n_steps=N_STEPS)
        static = JServeEngine(jcfg, jp, max_len=PROMPT_LEN + N_STEPS + 8).generate(
            {"tokens": jnp.asarray(toks)}, n_steps=N_STEPS)
        out[name] = {"params": jax.tree.map(np.asarray, jp), "tokens": toks,
                     "continuous": np.asarray(cont), "static": np.asarray(static)}
    with open(os.path.join(work_dir, "serve.pkl"), "wb") as f:
        pickle.dump(out, f)
    return out


def join(ctx, n):
    deadline = time.monotonic() + JOIN_LIMIT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"the {n} ranks did not finish in {JOIN_LIMIT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def start(fn, world, tmp_path, *args):
    ctx = mp.start_processes(fn, args=(world, str(tmp_path / "store"), str(tmp_path)) + args,
                             nprocs=world, join=False, start_method="spawn")
    join(ctx, world)
    got = []
    for r in range(world):
        with open(tmp_path / f"{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return got


def init_rank(rank, world, store_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))


# --------------------------------------------------------------------------
# on each rank: tensor-parallel serving
# --------------------------------------------------------------------------

def serve_on_mesh(mesh, work_dir):
    """Each case served by the continuous and the static engine on
    ``mesh``, and by the continuous engine on plain tensors: tokens, one
    decode step's collectives, the moved storages, the pool's storage."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _dispatch, _redistribute
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.dist import sharding as SH
    from repro_torch.models.hooks import install_constraint
    from repro_torch.serve.engine import ContinuousEngine, ServeEngine

    with open(os.path.join(work_dir, "serve.pkl"), "rb") as f:
        ref = pickle.load(f)
    out = {}
    for name in SERVE_CASES:
        cfg = serve_cfg(name)
        params = bridge.params_from_numpy(cfg, ref[name]["params"], "cpu")
        batch = {"tokens": ref[name]["tokens"]}
        plain = ContinuousEngine(cfg, params, n_slots=4, max_len=32, page=8, device="cpu",
                                 attn_kernel="cuda").generate(batch, n_steps=N_STEPS)
        replica = SH.replica_mesh(mesh)
        install_constraint(SH.activation_constraint_fn(replica))
        try:
            sp = SH.distribute(params, SH.serve_param_shardings(replica, params))
            eng = ContinuousEngine(cfg, sp, n_slots=4, max_len=32, page=8, device="cpu",
                                   attn_kernel="cuda", serve_mesh=mesh)
            eng.pool.blocks = SH.distribute(eng.pool.blocks,
                                            SH.page_pool_shardings(replica, eng.pool.blocks))
            assert eng.mesh is replica
            pool = eng.pool.blocks["layers"][0]["k_pages"]
            storage = pool.to_local().untyped_storage().data_ptr()
            cont = eng.generate(batch, n_steps=N_STEPS)
            written = bool(pool.to_local().abs().sum() > 0)
            same_storage = (eng.pool.blocks["layers"][0]["k_pages"] is pool and
                            pool.to_local().untyped_storage().data_ptr() == storage)
            # the rank's heads of the plain engine's pool after the same run
            plain_eng = ContinuousEngine(cfg, params, n_slots=4, max_len=32, page=8,
                                         device="cpu")
            plain_eng.generate(batch, n_steps=N_STEPS)
            whole = plain_eng.pool.blocks["layers"][0]["k_pages"]
            local = pool.to_local()
            offset = pool.placements[-1].is_shard() and mesh.get_local_rank("model")
            lo = int(offset or 0) * local.shape[2]
            pool_close = bool(torch.allclose(local, whole[:, :, lo:lo + local.shape[2]],
                                             atol=1e-5, rtol=1e-5))
            # one more step: its collectives by kind, and every storage a
            # redistribution reads
            moved = []
            real = _redistribute.redistribute_local_tensor

            def spy(local_tensor, *a, **k):
                moved.append(local_tensor.untyped_storage().data_ptr())
                return real(local_tensor, *a, **k)

            _redistribute.redistribute_local_tensor = spy
            _dispatch.redistribute_local_tensor = spy
            try:
                with CommDebugMode() as comm:
                    eng._decode(eng.params, eng._to_device(eng._tokens),
                                eng._to_device(eng._lengths),
                                eng._to_device(eng._table[:, :2]), eng.pool.blocks)
            finally:
                _redistribute.redistribute_local_tensor = real
                _dispatch.redistribute_local_tensor = real
            param_storages = {p.to_local().untyped_storage().data_ptr()
                              for p in leaves(sp)}
            static = ServeEngine(cfg, sp, max_len=PROMPT_LEN + N_STEPS + 8, device="cpu",
                                 serve_mesh=mesh).generate(batch, n_steps=N_STEPS)
        finally:
            install_constraint(None)
        out[name] = dict(
            continuous=cont.numpy(), static=static.numpy(), plain=plain.numpy(),
            all_dtensors=all(isinstance(p, DTensor) for p in leaves(sp)),
            pool_placements=[str(p) for p in pool.placements],
            written=written, same_storage=same_storage, pool_close=pool_close,
            data_ranks=eng.split.size,
            comm={str(k): v for k, v in comm.get_comm_counts().items()},
            n_redistributions=len(moved),
            params_moved=len(param_storages & set(moved)))
    return out


def serve_rank(rank, world, store_path, work_dir, model_parallel):
    init_rank(rank, world, store_path)
    try:
        from repro_torch.launch import serve as lserve
        from repro_torch.launch import train as ltrain
        from repro_torch.launch.mesh import make_host_mesh

        mesh = make_host_mesh(model_parallel)
        out = {"mesh": list(mesh.shape), "serve": serve_on_mesh(mesh, work_dir)}
        if world == 2:
            res = lserve.main(["--reduced", "--continuous", "--device", "cpu",
                               "--model-parallel", "2", "--temperature", "0",
                               "--n-requests", "3", "--steps", "4", "--prompt-len", "8"])
            out["launcher"] = {k: res[k] for k in ("mesh", "ranks", "completed", "tokens")}
            out["launcher_tokens"] = [list(r.out) for r in res["objects"]["requests"]]
            refused = {}
            for name, main, argv in (
                    ("fleet", lserve.main, ["--fleet", "2", "--fleet-duration", "1"]),
                    ("ssm", lserve.main, ["--arch", "mamba2-130m", "--model-parallel", "2"]),
                    ("moe train", ltrain.main, ["--arch", "granite-moe-3b-a800m"])):
                try:
                    res = main(["--reduced", "--device", "cpu", "--steps", "1"] + argv)
                    refused[name] = ("ran", res["mesh"])
                except SystemExit as e:
                    refused[name] = str(e)
            out["refused"] = refused
        else:
            out["train"] = train_on_mesh(rank, mesh, work_dir)
            out["elastic"] = elastic_restart(rank, work_dir)
        with open(os.path.join(work_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def check_serving(got, ref):
    for r, res in enumerate(got):
        for name, case in res["serve"].items():
            want = ref[name]
            np.testing.assert_array_equal(case["continuous"], want["continuous"], (r, name))
            np.testing.assert_array_equal(case["plain"], want["continuous"], (r, name))
            np.testing.assert_array_equal(case["static"], want["static"], (r, name))
            assert case["all_dtensors"] and case["written"] and case["same_storage"], (r, name)
            assert case["pool_close"], (r, name)
            assert case["n_redistributions"] > 0 and case["params_moved"] == 0, (r, name, case)
            assert sum(case["comm"].values()) > 0, (r, name)


def test_two_ranks_serve_tensor_parallel(tmp_path):
    ref = reference_serving(tmp_path)
    got = start(serve_rank, 2, tmp_path, 2)
    check_serving(got, ref)
    for r, res in enumerate(got):
        assert res["mesh"] == [1, 2]
        pl = res["serve"]
        assert all(case["data_ranks"] == 1 for case in pl.values()), pl
        assert pl["hkv2"]["pool_placements"] == ["S(2)"], pl
        assert pl["hkv1"]["pool_placements"] == ["R"], pl
        launcher = res["launcher"]
        assert launcher["mesh"] == [1, 2] and launcher["completed"] == 3
        assert launcher["ranks"] == [{"device": "cpu", "attn_kernel": "plain"}] * 2
        assert res["launcher_tokens"] == got[0]["launcher_tokens"]     # the ranks agree
        refused = res["refused"]
        assert refused["fleet"] == ("ran", [2, 1]), refused
        assert refused["ssm"] == ("ran", [1, 2]), refused        # the static mode, sharded
        assert refused["moe train"] == ("ran", [2, 1]), refused
    print("decode-step collectives, 2 ranks:",
          {name: case["comm"] for name, case in got[0]["serve"].items()})


# --------------------------------------------------------------------------
# on each rank: 2-D sharded training and the elastic restart
# --------------------------------------------------------------------------

def train_cfg(arch="llama3.2-1b"):
    return dataclasses.replace(reduced(get_config(arch)), remat=True)


def reference_training(work_dir):
    """The reference's initial state, batches, three-step losses and
    parameters of each of ``TRAIN_ARCHS``, written for the ranks."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models.inputs import make_batch as jmake_batch
    from repro.train import loop as JLoop
    from repro.train import optimizer as JO

    out = {}
    for arch in TRAIN_ARCHS:
        jcfg = dataclasses.replace(jreduced(jget_config(arch)), remat=True)
        opt = dict(warmup_steps=1, total_steps=10)
        js = JLoop.init_state(jcfg, JO.OptConfig(**opt), jax.random.PRNGKey(0))
        state0 = jax.tree.map(np.asarray, js)
        batches = [jax.tree.map(np.asarray, jmake_batch(jcfg, batch=8, seq_len=32,
                                                        kind="train", seed=i))
                   for i in range(TRAIN_STEPS)]
        step = jax.jit(JLoop.make_train_step(jcfg, JO.OptConfig(**opt)))
        losses = []
        for b in batches:
            js, m = step(js, b)
            losses.append(float(m["loss"]))
        out[arch] = {"state": state0, "opt": opt, "batches": batches, "losses": losses,
                     "params": jax.tree.map(np.asarray, js["params"])}
    with open(os.path.join(work_dir, "train.pkl"), "wb") as f:
        pickle.dump(out, f)
    return out


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def train_on_mesh(rank, mesh, work_dir):
    from repro_torch.dist import sharding as SH
    from repro_torch.launch import train as ltrain
    from repro_torch.models.hooks import install_constraint
    from repro_torch.train.optimizer import OptConfig

    with open(os.path.join(work_dir, "train.pkl"), "rb") as f:
        refs = pickle.load(f)
    out = {}
    for arch, ref in refs.items():
        cfg = train_cfg(arch)
        state = bridge.state_from_numpy(cfg, ref["state"], "cpu")
        try:
            state, step = ltrain.build(mesh, cfg, OptConfig(**ref["opt"]), state)
            losses = []
            for b in ref["batches"]:
                b = to_torch(b)
                state, m = step(state, SH.distribute(b, SH.batch_shardings(mesh, b)))
                losses.append(float(m["loss"]))
        finally:
            install_constraint(None)
        resident = sum(p.to_local().numel() * p.element_size() for p in leaves(state["params"]))
        whole = SH.gather(state["params"])
        total = sum(p.numel() * p.element_size() for p in leaves(whole))
        out[arch] = {"losses": losses, "resident": resident, "total": total,
                     "params": bridge.params_to_numpy(cfg, whole) if rank == 0 else None}
    return out


def elastic_restart(rank, work_dir):
    """Save under (2, 2), fail ranks 2 and 3, rebuild, restore through
    ``load(..., shardings)`` and step."""
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.checkpoint import CheckpointManager
    from repro_torch.dist.elastic import ElasticMesh
    from repro_torch.launch import train as ltrain
    from repro_torch.models.hooks import install_constraint
    from repro_torch.train.loop import init_state
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.tree import tree_map

    with open(os.path.join(work_dir, "train.pkl"), "rb") as f:
        ref = pickle.load(f)["llama3.2-1b"]
    cfg = dataclasses.replace(reduced(get_config("olmo-1b")), remat=True)
    opt_cfg = OptConfig(warmup_steps=2, total_steps=10)
    batch = to_torch(ref["batches"][0])
    em = ElasticMesh(axis_names=("data", "model"))
    rm = em.build(model_parallel=2)
    ckpt = os.path.join(work_dir, "ckpt")
    try:
        state = init_state(cfg, opt_cfg, torch.Generator().manual_seed(0), "cpu")
        state, step = ltrain.build(rm.device_mesh, cfg, opt_cfg, state)
        state, m = step(state, SH.distribute(batch, SH.batch_shardings(rm.device_mesh, batch)))
        saved = SH.gather(state)
        mgr = CheckpointManager(ckpt, async_save=True)
        mgr.save(1, state)         # every rank gathers; the first writes, on another thread
        mgr.wait()
        dist.barrier()
        for r in (2, 3):
            em.fail(r)
        rm2 = em.build(model_parallel=2)
        out = {"before": float(m["loss"]), "mesh": list(rm2.layout.shape),
               "in_mesh": rm2.device_mesh.get_coordinate() is not None}
        if rank in em.failed_ids():
            return out
        mesh2 = rm2.device_mesh
        install_constraint(SH.activation_constraint_fn(mesh2))
        skel = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), saved)
        ps = SH.param_shardings(mesh2, skel["params"])
        sh = {"params": ps, "opt": SH.opt_state_shardings(mesh2, ps, skel["opt"])}
        _, restored = CheckpointManager(ckpt).restore_latest(skel, sh)
        back = SH.gather(restored)
        out["equal"] = all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(saved)))
        out["placements"] = str(restored["params"]["layers"][0]["attn"]["wq"].placements)
        from repro_torch.train.loop import make_train_step

        train_step = make_train_step(cfg, opt_cfg)
        with SH.replicating(mesh2):
            restored, m2 = train_step(
                restored, SH.distribute(batch, SH.batch_shardings(mesh2, batch)))
        out["after"] = float(SH.whole(m2["loss"]))
        return out
    finally:
        install_constraint(None)


def test_four_ranks_serve_train_and_restart_on_a_smaller_mesh(tmp_path):
    import jax

    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptConfig

    ref = reference_serving(tmp_path)
    trefs = reference_training(tmp_path)
    got = start(serve_rank, 4, tmp_path, 2)
    check_serving(got, ref)
    for arch, tref in trefs.items():
        # the port's single-process step on the same state and batches
        cfg = train_cfg(arch)
        state = bridge.state_from_numpy(cfg, tref["state"], "cpu")
        step = make_train_step(cfg, OptConfig(**tref["opt"]))
        losses = []
        for b in tref["batches"]:
            state, m = step(state, to_torch(b))
            losses.append(float(m["loss"]))
        single = bridge.params_to_numpy(cfg, state["params"])
        for r, res in enumerate(got):
            assert res["mesh"] == [2, 2]
            tr = res["train"][arch]
            np.testing.assert_allclose(tr["losses"], losses, rtol=1e-4, atol=0)
            np.testing.assert_allclose(tr["losses"], tref["losses"], rtol=1e-4, atol=0)
            assert tr["resident"] < tr["total"] / 2, (arch, tr["resident"], tr["total"])
        # AdamW normalises each element's step, so where a gradient element
        # is near zero its update follows the reduction order's last bits:
        # the port's own single-process step and the reference's part by
        # 4.4e-5 on llama's embedding.  Each parameter is held at rtol 1e-4
        # and atol 1e-4 (a third of one step's learning rate), the
        # embedding's rows included.
        for want in (single, tref["params"]):
            for g, w in zip(jax.tree.leaves(got[0]["train"][arch]["params"]),
                            jax.tree.leaves(want)):
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=arch)
    for r, res in enumerate(got):
        assert all(case["data_ranks"] == 2 for case in res["serve"].values()), r
        el = res["elastic"]
        assert el["mesh"] == [1, 2] and el["in_mesh"] == (r < 2)
        assert np.isfinite(el["before"])
        if r < 2:
            assert el["equal"] and np.isfinite(el["after"]), el
            assert el["placements"] == "(Replicate(), Shard(dim=1))", el
    print("decode-step collectives, 4 ranks:",
          {name: case["comm"] for name, case in got[0]["serve"].items()})
