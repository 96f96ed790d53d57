"""The other families sharded inside a pod on 2 spawned gloo ranks at model
degree 2, against the port on plain tensors and the JAX package, on the
CPU.

* The serve launcher's ``--model-parallel 2`` path serves reduced
  granite-moe-3b-a800m, recurrentgemma-2b and mamba2-130m greedy, every
  request's tokens equal to the port's unsharded engine's on the same
  (gathered) weights and to the reference's ``ContinuousEngine``'s.
* ``moe_forward`` on DTensors equals the reference's at 2e-5, out, aux
  and every gradient, with dropless routing, with capacity routing (which
  drops) and with capacity routing at a capacity factor of 0.5 (which
  drops on both ranks' tokens), and with skewed routing at a capacity
  that the two ranks' slots split unevenly (one owner receives most
  rows), on the (1, 2) mesh (the router and experts split over the model
  axis, every rank routing the whole batch) and on the (2, 1) mesh (the
  tokens split over the data axis: each rank routes only its own T/2
  rows, at the whole batch's slots, and sends its kept rows to the rank
  that owns their slots; no rank allocates the whole (E, C, d) buffer).
* ``rglru_scan`` and ``ssd_scan`` on DTensors run their plain versions on
  each rank's lanes or heads and equal the whole-tensor calls.

The spawn helpers are ``test_torch_sharding_dist``'s; this file holds its
own 2-rank run so that it runs beside that file's.  JAX is imported inside
the reference-side helpers only, so the spawned ranks load torch alone.
"""
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.tree import leaves
from test_torch_sharding_dist import init_rank, start

# served through the launcher on 2 ranks at model degree 2
FAMILY_ARCHS = ("granite-moe-3b-a800m", "recurrentgemma-2b", "mamba2-130m")
FAMILY_ARGV = ["--reduced", "--continuous", "--device", "cpu", "--model-parallel", "2",
               "--temperature", "0", "--n-requests", "3", "--steps", "6", "--prompt-len", "8"]
MOE_ARCH = "granite-moe-3b-a800m"
# routing -> (capacity override, config overrides); at a capacity factor of
# 1.25 a rank's T/2 tokens cannot fill an expert's capacity alone, so only
# the second rank's assignments drop; at 0.5 (capacity T/4) both ranks' do.
# The tokens share a direction, so routing is skewed (half the assignments
# go to one expert, almost none to another): at a capacity of 47 slots, 24
# and 23 a rank, no expert's rows reach the second rank's slots but the
# busiest one's, and that rank receives a few rows against the first's many
MOE_ROUTINGS = {"dropless": ("whole", {}), "capacity": (0, {}),
                "tight capacity": (0, {"capacity_factor": 0.5}),
                "skewed": (0, {"capacity_factor": 2.9})}
# model-parallel degree on 2 ranks -> the mesh
MOE_MESHES = {2: (1, 2), 1: (2, 1)}
MOE_BATCH = (2, 16)
F32_TOL = dict(atol=2e-5, rtol=2e-4)
SSD_TOL = dict(atol=2e-4, rtol=2e-3)


def moe_cap(routing):
    cap, _ = MOE_ROUTINGS[routing]
    return MOE_BATCH[0] * MOE_BATCH[1] if cap == "whole" else cap


def reference_moe(work_dir):
    """The reference's ``moe_forward`` on reduced granite: out, aux and the
    gradients of ``sum(out * r) + aux`` for each of ``MOE_ROUTINGS``; the
    tokens share a direction, so capacity routing drops."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import moe as JM

    jp = JM.init_moe(jreduced(jget_config(MOE_ARCH)), jax.random.PRNGKey(2), jnp.float32)
    rng = np.random.default_rng(3)
    (b, s), d = MOE_BATCH, jp["w1"].shape[1]
    x = (rng.normal(0, 1, (b, s, d)) + 1.5 * rng.normal(0, 1, d)).astype(np.float32)
    r = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    out = {"params": jax.tree.map(np.asarray, jp), "x": x, "r": r}
    for routing, (_, mods) in MOE_ROUTINGS.items():
        jcfg = jreduced(jget_config(MOE_ARCH), **mods)
        cap = moe_cap(routing)

        def loss(p, x):
            y, aux = JM.moe_forward(jcfg, p, x, cap_override=cap)
            return jnp.sum(y * r) + aux

        y, aux = JM.moe_forward(jcfg, jp, jnp.asarray(x), cap_override=cap)
        gp, gx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
        out[routing] = {"out": np.asarray(y), "aux": float(aux), "gx": np.asarray(gx),
                        "gp": jax.tree.map(np.asarray, gp)}
    with open(os.path.join(work_dir, "moe.pkl"), "wb") as f:
        pickle.dump(out, f)
    return out


def families_through_launcher(rank):
    """Each of ``FAMILY_ARCHS`` served by the launcher's sharded path; the
    same prompts by the port's engine on the gathered (whole) weights."""
    from repro_torch.dist import sharding as SH
    from repro_torch.launch import serve as lserve
    from repro_torch.serve.engine import ContinuousEngine

    out = {}
    for arch in FAMILY_ARCHS:
        res = lserve.main(["--arch", arch] + FAMILY_ARGV)
        eng = res["objects"]["engine"]
        reqs = sorted(res["objects"]["requests"], key=lambda r: r.rid)
        whole = SH.gather(eng.params)
        prompts = np.stack([r.prompt for r in reqs])
        n = max(r.max_new for r in reqs)
        plain = ContinuousEngine(eng.cfg, whole, n_slots=eng.n_slots, max_len=eng.max_len,
                                 page=eng.page, device="cpu").generate({"tokens": prompts},
                                                                       n_steps=n)
        out[arch] = dict(
            mesh=res["mesh"], ranks=res["ranks"], tokens=[list(r.out) for r in reqs],
            plain=[list(row[:r.max_new]) for row, r in zip(plain.tolist(), reqs)],
            prompts=prompts, n=n, engine=(eng.n_slots, eng.max_len, eng.page),
            all_dtensors=all(SH.mesh_of(t) is not None for t in leaves(eng.params)),
            params=bridge.params_to_numpy(eng.cfg, whole) if rank == 0 else None)
    return out


class LocalShapes(TorchDispatchMode):
    """The shapes of the plain tensors that the operations below DTensor
    return on this rank (DTensor's own operations let through, as
    ``CommDebugMode`` does; its propagation's ``meta`` runs left out)."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if type(t) is torch.Tensor and not t.is_meta:
                self.shapes.add(tuple(t.shape))
        return out


def moe_on_mesh(mesh, work_dir):
    """The port's ``moe_forward`` on DTensors: parameters on
    ``param_shardings``, x on ``batch_shardings``; out, aux and the
    gradients, gathered, the rows each call of ``route`` saw, which of the
    whole batch's assignments the routing kept, the split sizes of the
    rank's exchange (where the tokens are split) and the shapes of the
    tensors it allocated in the forward and backward pass."""
    from repro_torch.dist import sharding as SH
    from repro_torch.models import moe as TM
    from repro_torch.models.hooks import install_constraint

    with open(os.path.join(work_dir, "moe.pkl"), "rb") as f:
        ref = pickle.load(f)
    p = {k: torch.from_numpy(v) for k, v in ref["params"].items()}
    x = torch.from_numpy(ref["x"])
    r = torch.from_numpy(ref["r"])
    out = {}
    real_route, real_plan = TM.route, TM.plan_exchange
    rows, splits = [], []

    def route(cfg, p, xf):
        rows.append(xf.shape[0])
        return real_route(cfg, p, xf)

    def plan_exchange(*args):
        ex, keep = real_plan(*args)
        splits.append((ex.send_splits, ex.recv_splits))
        return ex, keep

    install_constraint(SH.activation_constraint_fn(mesh))
    TM.route, TM.plan_exchange = route, plan_exchange
    try:
        for routing, (_, mods) in MOE_ROUTINGS.items():
            cfg = reduced(get_config(MOE_ARCH), **mods)
            cap = moe_cap(routing)
            dp = SH.distribute(p, SH.param_shardings(mesh, p))
            for t in dp.values():
                t.requires_grad_(True)
            dx = SH.distribute(x, SH.batch_shardings(mesh, x)).requires_grad_(True)
            del rows[:], splits[:]
            with SH.replicating(mesh), LocalShapes() as shapes:
                y, aux = TM.moe_forward(cfg, dp, dx, cap_override=cap)
                loss = (y * r).sum() + aux
                grads = torch.autograd.grad(loss, list(dp.values()) + [dx])
            t = x.shape[0] * x.shape[1]
            _, _, idx = real_route(cfg, p, x.reshape(t, -1))
            _, keep = TM.positions(idx, cfg.n_experts, cap or TM.capacity(cfg, t))
            out[routing] = {
                "out": SH.whole(y).detach().numpy(), "aux": float(SH.whole(aux)),
                "gx": SH.whole(grads[-1]).numpy(),
                "gp": {k: SH.whole(g).numpy() for k, g in zip(dp, grads)},
                "placements": {k: str(t.placements) for k, t in dp.items()},
                "x placements": str(dx.placements), "out placements": str(y.placements),
                "route rows": list(rows), "keep": keep.reshape(t, -1).numpy(),
                "splits": list(splits), "shapes": shapes.shapes,
                "cap": cap or TM.capacity(cfg, t)}
    finally:
        TM.route, TM.plan_exchange = real_route, real_plan
        install_constraint(None)
    return out


def scans_on_mesh(mesh):
    """``rglru_scan`` and ``ssd_scan`` handed DTensors on the CPU: their
    outputs' placements and their gathered values against the whole-tensor
    calls; the SSD also at a head count the model axis does not divide."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels import rglru_scan as RS
    from repro_torch.kernels import ssd as SSD

    g = torch.Generator().manual_seed(5)
    rep = (Replicate(),) * mesh.ndim

    def dt(t):
        return distribute_tensor(t, mesh, rep, src_data_rank=None)

    out = {}
    a = torch.rand(2, 20, 64, generator=g) * 0.69 + 0.3
    b = torch.randn(2, 20, 64, generator=g)
    h0 = torch.randn(2, 64, generator=g)
    got = RS.rglru_scan(dt(a), dt(b), dt(h0))
    out["rglru"] = dict(placements=str(got.placements), local=tuple(got.to_local().shape),
                        err=float((got.full_tensor() - RS.rglru_scan(a, b, h0)).abs().max()),
                        close=bool(torch.allclose(got.full_tensor(), RS.rglru_scan(a, b, h0),
                                                  **F32_TOL)))
    for h in (4, 3):
        x = torch.randn(2, 24, h, 8, generator=g)
        dtv = torch.rand(2, 24, h, generator=g) * 0.2
        a_log = -torch.rand(h, generator=g) * 8 - 1
        bb, cc = torch.randn(2, 24, 16, generator=g), torch.randn(2, 24, 16, generator=g)
        s0 = torch.randn(2, h, 8, 16, generator=g) * 0.1
        y, state = SSD.ssd_scan(dt(x), dt(dtv), dt(a_log), dt(bb), dt(cc), chunk=8,
                                init_state=dt(s0))
        wy, ws = SSD.ssd_scan(x, dtv, a_log, bb, cc, chunk=8, init_state=s0)
        out[f"ssd H {h}"] = dict(
            placements=(str(y.placements), str(state.placements)),
            local=tuple(y.to_local().shape),
            close=bool(torch.allclose(y.full_tensor(), wy, **SSD_TOL)
                       and torch.allclose(state.full_tensor(), ws, **SSD_TOL)))
    return out


def family_rank(rank, world, store_path, work_dir):
    init_rank(rank, world, store_path)
    try:
        from repro_torch.launch.mesh import make_host_mesh

        mesh = make_host_mesh(2)
        out = {"families": families_through_launcher(rank), "scans": scans_on_mesh(mesh),
               "moe": {MOE_MESHES[mp]: moe_on_mesh(make_host_mesh(mp), work_dir)
                       for mp in MOE_MESHES}}
        with open(os.path.join(work_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def reference_family_tokens(case, arch):
    """The reference's ``ContinuousEngine`` greedy on the launcher's weights
    and prompts, each request cut to its own length."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.serve import ContinuousEngine as JContinuousEngine

    n_slots, max_len, page = case["engine"]
    jp = jax.tree.map(jnp.asarray, case["params"])
    out = JContinuousEngine(jreduced(jget_config(arch)), jp, n_slots=n_slots, max_len=max_len,
                            page=page).generate({"tokens": jnp.asarray(case["prompts"])},
                                                n_steps=case["n"])
    return [list(row[:len(toks)]) for row, toks in zip(np.asarray(out).tolist(),
                                                       case["tokens"])]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of the 2 ranks for every test of this file, and the
    reference's MoE figures."""
    tmp_path = tmp_path_factory.mktemp("families")
    mref = reference_moe(tmp_path)
    return mref, start(family_rank, 2, tmp_path)


def test_two_ranks_serve_and_route_the_other_families(two_ranks):
    mref, got = two_ranks
    assert not np.allclose(mref["capacity"]["out"], mref["dropless"]["out"])   # it dropped
    for arch in FAMILY_ARCHS:
        want = reference_family_tokens(got[0]["families"][arch], arch)
        for r, res in enumerate(got):
            case = res["families"][arch]
            assert case["mesh"] == [1, 2] and case["all_dtensors"], (r, arch)
            assert case["ranks"] == [{"device": "cpu", "attn_kernel": "plain"}] * 2
            assert case["tokens"] == case["plain"] == want, (r, arch, case["tokens"], want)
    for r, res in enumerate(got):
        for routing in MOE_ROUTINGS:
            case = res["moe"][(1, 2)][routing]
            assert case["placements"]["router"] == "(Replicate(), Shard(dim=1))", case
            assert case["placements"]["w1"] == "(Replicate(), Shard(dim=2))", case
            assert case["placements"]["w2"] == "(Replicate(), Shard(dim=1))", case
        scans = res["scans"]
        assert scans["rglru"]["close"] and scans["rglru"]["err"] == 0.0, scans
        assert scans["rglru"]["placements"] == "(Replicate(), Shard(dim=2))"
        assert scans["rglru"]["local"] == (2, 20, 32)
        assert scans["ssd H 4"]["close"] and scans["ssd H 3"]["close"], scans
        assert scans["ssd H 4"]["placements"] == ("(Replicate(), Shard(dim=2))",
                                                  "(Replicate(), Shard(dim=1))")
        assert scans["ssd H 4"]["local"] == (2, 24, 2, 8)
        assert scans["ssd H 3"]["placements"] == ("(Replicate(), Replicate())",) * 2


@pytest.mark.parametrize("routing", list(MOE_ROUTINGS))
@pytest.mark.parametrize("shape", list(MOE_MESHES.values()), ids=str)
def test_moe_on_two_ranks_equals_the_reference(two_ranks, shape, routing):
    """Out, aux and the gradients of x and of every parameter at 2e-5 on
    both ranks; on (2, 1) the tokens and the output split over the data
    axis."""
    mref, got = two_ranks
    want = mref[routing]
    for r, res in enumerate(got):
        case = res["moe"][shape][routing]
        np.testing.assert_allclose(case["out"], want["out"], atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(case["aux"], want["aux"], atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(case["gx"], want["gx"], atol=2e-5, rtol=2e-5)
        for k, g in case["gp"].items():
            np.testing.assert_allclose(g, want["gp"][k], atol=2e-5, rtol=2e-5,
                                       err_msg=f"{shape} {routing} d{k}")
        split = "(Shard(dim=0), Replicate())" if shape == (2, 1) else None
        if split:
            assert case["x placements"] == case["out placements"] == split, case


@pytest.mark.parametrize("shape", list(MOE_MESHES.values()), ids=str)
def test_moe_routes_each_ranks_own_rows(two_ranks, shape):
    """With the tokens split over the data axis every rank's one ``route``
    call sees its T/2 rows; with them replicated, all T."""
    _, got = two_ranks
    t = MOE_BATCH[0] * MOE_BATCH[1]
    for res in got:
        for routing in MOE_ROUTINGS:
            assert res["moe"][shape][routing]["route rows"] == [t // shape[0]], routing


def test_moe_capacity_drops_fall_on_both_sides_of_the_rank_boundary(two_ranks):
    """The data-split dispatch is held to the reference where it drops: at
    a capacity factor of 1.25 only the second rank's tokens drop (the
    first's fill the experts), at 0.5 both ranks' do; dropless keeps all."""
    _, got = two_ranks
    half = MOE_BATCH[0] * MOE_BATCH[1] // 2
    cases = got[0]["moe"][(2, 1)]
    dropped = {routing: (not case["keep"][:half].all(), not case["keep"][half:].all())
               for routing, case in cases.items()}
    assert dropped == {"dropless": (False, False), "capacity": (False, True),
                       "tight capacity": (True, True), "skewed": (False, False)}, dropped


@pytest.mark.parametrize("routing", list(MOE_ROUTINGS))
def test_moe_exchange_sends_each_kept_row_to_its_slots_owner(two_ranks, routing):
    """On (2, 1) each rank plans one exchange: what rank r sends rank q is
    what q receives from r, and the rows sent are the batch's kept
    assignments, each once; with skewed routing the first rank's slots
    take more than twice the second's rows."""
    _, got = two_ranks
    plans = [res["moe"][(2, 1)][routing]["splits"] for res in got]
    assert all(len(p) == 1 for p in plans), plans
    send = [p[0][0] for p in plans]
    recv = [p[0][1] for p in plans]
    assert [[recv[q][r] for r in range(2)] for q in range(2)] == [
        [send[r][q] for r in range(2)] for q in range(2)], (send, recv)
    kept = int(got[0]["moe"][(2, 1)][routing]["keep"].sum())
    assert sum(map(sum, send)) == sum(map(sum, recv)) == kept, (send, recv, kept)
    if routing == "skewed":
        assert sum(recv[0]) > 2 * sum(recv[1]) > 0, recv


@pytest.mark.parametrize("routing", list(MOE_ROUTINGS))
def test_moe_split_path_allocates_no_whole_buffer(two_ranks, routing):
    """With the tokens split (2, 1), no rank allocates the whole batch's
    (E, C, d) buffer (nor its trash row's (E + 1, C, d)) or its (T·k, d)
    assignment rows, in the forward or the backward pass; with them
    replicated (1, 2), where every rank runs the whole batch, the same
    record holds the buffer.  By shape: at the tight capacity E·C·d equals
    the element count of a rank's own (T/2·k, d) rows."""
    _, got = two_ranks
    cfg = reduced(get_config(MOE_ARCH), **MOE_ROUTINGS[routing][1])
    e, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    t = MOE_BATCH[0] * MOE_BATCH[1]
    for res in got:
        cap = res["moe"][(2, 1)][routing]["cap"]
        whole = {(e, cap, d), (e + 1, cap, d), (t * k, d), (t, k, d)}
        assert not whole & res["moe"][(2, 1)][routing]["shapes"], (
            routing, whole & res["moe"][(2, 1)][routing]["shapes"])
        assert (e + 1, cap, d) in res["moe"][(1, 2)][routing]["shapes"], routing
