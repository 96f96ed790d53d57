"""The multi-pod step with sharding inside each pod
(``repro_torch.train.loop.make_pod_train_step`` over a ``DeviceMesh`` with a
``pod`` axis), on one spawn of 4 gloo ranks, as a (pod 2, data 1, model 2)
mesh and as a (pod 2, data 2, model 1) mesh, where FSDP over ``data``
splits parameters inside each pod, against the reference's single-process
``make_train_step`` on the whole batch.

* ``pod_reduce="manual"``: the loss, the updated parameters and the
  step's ``grad_norm`` equal the reference's (loss and ``grad_norm`` rtol
  1e-4; parameters rtol 1e-4 and atol 1e-4, as in
  ``tests/test_torch_sharding_dist.py``: AdamW normalises each element's
  step, so where a gradient element is near zero its update follows the
  reduction order's last bits).  The reduced local shards are the mean of
  the two pods' (the rank's and its peer's at the same (data, model)
  coordinate).  In ``profile`` mode the governor books one instrumented
  ``cd_psum`` a step on every rank.
* ``"compressed"``: the loss equals the manual step's at rtol 1e-4; each
  reduced element is within the int8 codec's error of the manual mean,
  ``(s_rank + s_peer) / 4`` for the two pods' per-leaf scales ``s``
  (``max |g| / 127``); the updated parameters are within what that error
  allows AdamW's first step (``lr * g / (|g| + eps)``): the bound from the
  smaller clipped magnitude wherever the manual mean exceeds twice the
  error (the two steps share their sign), ``2 lr`` elsewhere.

JAX is imported inside the reference-side helper only, so the spawned
ranks, which import this module, load torch alone.
"""
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
from repro_torch.tree import leaves

WORLD = 4
MESHES = ((2, 1, 2), (2, 2, 1))
JOIN_LIMIT_S = 180.0
OPT = dict(warmup_steps=1, total_steps=10)


def reference_step(work_dir):
    """The reference's initial state, batch, and one whole-batch step's
    loss and parameters, written for the ranks."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models.inputs import make_batch as jmake_batch
    from repro.train import loop as JLoop
    from repro.train import optimizer as JO

    jcfg = jreduced(jget_config("llama3.2-1b"))
    js = JLoop.init_state(jcfg, JO.OptConfig(**OPT), jax.random.PRNGKey(0))
    state0 = jax.tree.map(np.asarray, js)
    batch = jax.tree.map(np.asarray, jmake_batch(jcfg, batch=8, seq_len=32, kind="train"))
    js, m = jax.jit(JLoop.make_train_step(jcfg, JO.OptConfig(**OPT)))(js, batch)
    out = {"state": state0, "batch": batch, "loss": float(m["loss"]),
           "grad_norm": float(m["grad_norm"]),
           "params": jax.tree.map(np.asarray, js["params"])}
    with open(os.path.join(work_dir, "ref.pkl"), "wb") as f:
        pickle.dump(out, f)
    return out


def pod_step_on_rank(cfg, mesh, ref, how):
    """One pod step from the reference's state: (metrics, state, governor
    calls, the pod reduction's local input and output leaves)."""
    from repro_torch.dist import sharding as SH
    from repro_torch.train import loop as TLoop
    from repro_torch.train.optimizer import OptConfig

    state = bridge.state_from_numpy(cfg, ref["state"], "cpu")
    ps = SH.param_shardings(mesh, state["params"], include_pod=False, gather_safe=True)
    state = SH.distribute(state, {"params": ps,
                                  "opt": SH.opt_state_shardings(mesh, ps, state["opt"])})
    batch = {k: torch.from_numpy(np.array(v)) for k, v in ref["batch"].items()}
    batch = SH.distribute(batch, SH.batch_shardings(mesh, batch))
    step = TLoop.make_pod_train_step(cfg, OptConfig(**OPT), mesh,
                                     TLoop.TrainConfig(pod_reduce=how))
    reduce, seen = TLoop._pod_reduce, {}

    def spy(grads, group, n, train_cfg):
        seen["in"] = [g.detach().clone().numpy() for g in grads]
        out = reduce(grads, group, n, train_cfg)
        seen["out"] = [g.detach().clone().numpy() for g in leaves(out)]
        return out

    TI.set_mode("profile")
    TI.enable_events(True)
    gov = Governor(policy=COUNTDOWN_SLACK)
    TI.get_event_bus().subscribe(gov)
    TLoop._pod_reduce = spy
    try:
        state, m = step(state, batch)
        n_calls = gov.finalize().n_calls
    finally:
        TLoop._pod_reduce = reduce
        TI.reset_instrumentation()
    metrics = {k: float(SH.whole(v)) for k, v in m.items()}
    return metrics, state, n_calls, seen


def rank_main(rank, store_path, work_dir):
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=120))
    try:
        from repro_torch.dist import sharding as SH

        with open(os.path.join(work_dir, "ref.pkl"), "rb") as f:
            ref = pickle.load(f)
        cfg = reduced(get_config("llama3.2-1b"))
        out = {}
        for shape in MESHES:
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=("pod", "data", "model"))
            m, state, n_calls, seen = pod_step_on_rank(cfg, mesh, ref, "manual")
            cm, cstate, cn, cseen = pod_step_on_rank(cfg, mesh, ref, "compressed")
            out[shape] = {
                "metrics": m, "n_calls": n_calls, "seen": seen,
                "placements": {str(p.placements) for p in leaves(state["params"])},
                "params": bridge.params_to_numpy(cfg, SH.gather(state["params"])),
                "local": [p.to_local().numpy() for p in leaves(state["params"])],
                "compressed_metrics": cm, "compressed_calls": cn, "compressed_seen": cseen,
                "compressed_local": [p.to_local().numpy() for p in leaves(cstate["params"])]}
        with open(os.path.join(work_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def test_four_gloo_ranks_pod_step_equals_the_reference_whole_batch_step(tmp_path):
    import jax

    ref = reference_step(tmp_path)
    ctx = mp.start_processes(rank_main, args=(str(tmp_path / "store"), str(tmp_path)),
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
    from repro_torch.train.optimizer import OptConfig

    opt = OptConfig(**OPT)
    got = []
    for r in range(WORLD):
        with open(tmp_path / f"{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    for shape in MESHES:
        for r in range(WORLD):
            g, peer = got[r][shape], got[r ^ 2][shape]     # the other pod, same (data, model)
            m, cm = g["metrics"], g["compressed_metrics"]
            np.testing.assert_allclose(m["loss"], ref["loss"], rtol=1e-4, atol=0)
            np.testing.assert_allclose(m["grad_norm"], ref["grad_norm"], rtol=1e-4, atol=0)
            for a, w in zip(jax.tree.leaves(g["params"]), jax.tree.leaves(ref["params"])):
                np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-4)
            assert g["n_calls"] == 1 and g["compressed_calls"] == 1, (shape, r)
            # the manual reduction: the mean of the two pods' local shards
            for mine, theirs, mean in zip(g["seen"]["in"], peer["seen"]["in"],
                                          g["seen"]["out"]):
                np.testing.assert_allclose(mean, (mine + theirs) / 2, rtol=1e-6, atol=1e-12)
            # the compressed one: within the int8 codec's error of that mean
            np.testing.assert_allclose(cm["loss"], m["loss"], rtol=1e-4, atol=0)
            lr, eps = m["lr"], opt.eps
            # the smaller of the two steps' clipping factors
            clip = min(min(1.0, opt.grad_clip / max(x["grad_norm"], 1e-9)) for x in (m, cm))
            for mine, theirs, mean, cmean, p, cp in zip(
                    g["seen"]["in"], peer["seen"]["in"], g["seen"]["out"],
                    g["compressed_seen"]["out"], g["local"], g["compressed_local"]):
                err = (np.abs(mine).max() + np.abs(theirs).max()) / 127 / 4
                assert np.all(np.abs(cmean - mean) <= err * (1 + 1e-5) + 1e-12), (shape, r)
                # AdamW's first step moves an element by lr * g / (|g| + eps)
                # (and the same decay): where both means exceed half of
                # |mean| with one sign, the steps differ by at most
                # lr * eps / (c + eps), c the smaller clipped magnitude;
                # elsewhere by at most 2 lr
                sure = np.abs(mean) > 2 * err
                c = clip * np.abs(mean) / 2
                diff = np.abs(cp - p)
                assert np.all(diff[sure] <= (lr * eps / (c + eps) + 1e-7)[sure]), (shape, r)
                assert np.all(diff <= 2 * lr + 1e-7), (shape, r)
    # (2, 1, 2): FSDP over data of size 1, nothing over pod or model;
    # (2, 2, 1): FSDP over data splits every matrix inside each pod
    assert got[0][(2, 1, 2)]["placements"] == {"(Replicate(), Replicate(), Replicate())"}
    assert got[0][(2, 2, 1)]["placements"] >= {"(Replicate(), Shard(dim=0), Replicate())"}
