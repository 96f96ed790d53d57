"""The serve launcher's ``--fleet`` over 2 spawned gloo ranks, on the CPU.

Reduced llama3.2-1b, greedy, through ``repro_torch.launch.serve.main``:

* ``--fleet 2 --model-parallel 2`` (a (1, 2) mesh: both replicas
  tensor-parallel over the two ranks) and ``--fleet 2`` (a (2, 1) mesh:
  each rank runs both replicas on its own copy of the weights, decoding
  2 of each replica's 4 slots) finish
  every request of a short flash crowd, and each request's tokens equal
  one unsharded engine's on the same (gathered) weights, as
  ``test_torch_fleet.test_engine_fleet_serves_the_reference_tokens`` holds
  the fleet on one rank.
* Both ranks route every request to the same replica and serve it the
  same tokens: every rank takes its host decisions from the first rank's
  clock.
* ``--fleet 2 --autoscale`` (the virtual-clock simulator, no model) gives
  both ranks the one-rank run's report.

The spawn helpers are ``test_torch_sharding_dist``'s; this file holds its
own 2-rank run, so that ``--dist loadfile`` runs it beside that file's.
"""
import dataclasses
import os
import pickle

import pytest
import torch.distributed as dist

from test_torch_sharding_dist import init_rank, start

FLEET_ARGV = ["--reduced", "--device", "cpu", "--fleet", "2", "--temperature", "0",
              "--fleet-trace", "flash-crowd", "--fleet-duration", "2"]
# mesh shape -> the flags that give it on 2 ranks
MESHES = {(1, 2): ["--model-parallel", "2"], (2, 1): []}
AUTOSCALE_ARGV = ["--reduced", "--device", "cpu", "--fleet", "2", "--autoscale",
                  "--fleet-trace", "diurnal", "--fleet-duration", "15", "--seed", "4"]


def fleet_on_mesh(extra):
    """The launcher's fleet; each request's tokens and route in trace order,
    and the same prompts served one at a time by an unsharded engine."""
    from repro_torch.device import is_dtensor
    from repro_torch.dist import sharding as SH
    from repro_torch.launch import serve as lserve
    from repro_torch.serve.engine import ContinuousEngine
    from repro_torch.serve.scheduler import Request
    from repro_torch.tree import leaves

    res = lserve.main(FLEET_ARGV + extra)
    objs = res["objects"]
    reqs, engines = objs["requests"], objs["engines"]
    index = {r.rid: i for i, r in enumerate(reqs)}
    eng = engines[0]
    single = ContinuousEngine(eng.cfg, SH.gather(objs["params"]), n_slots=eng.n_slots,
                              max_len=eng.max_len, page=eng.page, device="cpu")
    alone = [Request(prompt=r.prompt, max_new=r.max_new, arrival=0.0) for r in reqs]
    single.serve(alone)
    return dict(
        mesh=res["mesh"], ranks=res["ranks"], requests=res["requests"],
        data_ranks=res["data_ranks"], spans=[(e.split.lo, e.split.hi) for e in engines],
        n_requests=res["n_requests"], routed=res["routed"],
        tokens=[list(r.out) for r in reqs], max_new=[r.max_new for r in reqs],
        single=[list(r.out) for r in alone],
        routes=[(index[d.rid], d.replica_id) for d in objs["router"].decisions],
        decode_steps=[r["decode_steps"] for r in res["per_replica"]],
        one_copy=engines[0].params is engines[1].params,
        all_dtensors=all(is_dtensor(t) for t in leaves(objs["params"])),
        pools_on_mesh=all(SH.mesh_of(e.pool.blocks) is e.mesh for e in engines),
        clock=[e.clock_mesh.shape for e in engines])


def autoscale():
    from repro_torch.launch import serve as lserve

    res = lserve.main(AUTOSCALE_ARGV)
    report = {k: v for k, v in res.items() if k not in ("objects", "mesh", "ranks")}
    return report, dataclasses.asdict(res["objects"]["result"]), res.get("mesh"), res.get("ranks")


def fleet_rank(rank, world, store_path, work_dir):
    init_rank(rank, world, store_path)
    try:
        out = {shape: fleet_on_mesh(extra) for shape, extra in MESHES.items()}
        *out["autoscale"], out["autoscale_ranks"] = autoscale()
        with open(os.path.join(work_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return start(fleet_rank, 2, tmp_path_factory.mktemp("fleet"))


@pytest.mark.parametrize("shape", list(MESHES), ids=str)
def test_fleet_on_two_ranks_serves_one_engines_tokens(two_ranks, shape):
    for r, res in enumerate(two_ranks):
        case = res[shape]
        assert case["mesh"] == list(shape), (r, case["mesh"])
        assert case["ranks"] == [{"device": "cpu", "attn_kernel": "plain"}] * 2
        assert case["requests"] == case["n_requests"] == case["routed"] > 0, (r, case)
        assert [len(t) for t in case["tokens"]] == case["max_new"], r
        assert case["tokens"] == case["single"], (r, case["tokens"], case["single"])
        assert case["one_copy"] and case["all_dtensors"] and case["pools_on_mesh"], (r, case)
        assert case["clock"] == [shape] * 2, case["clock"]
        assert case["data_ranks"] == shape[0], case["data_ranks"]
        span = 4 // shape[0]
        assert case["spans"] == [(r * span % 4, r * span % 4 + span)] * 2, case["spans"]


@pytest.mark.parametrize("shape", list(MESHES), ids=str)
def test_fleet_ranks_agree_on_routes_and_tokens(two_ranks, shape):
    first, second = (res[shape] for res in two_ranks)
    assert first["routes"] == second["routes"]
    assert sorted(i for i, _ in first["routes"]) == list(range(first["n_requests"]))
    assert {k for _, k in first["routes"]} <= {0, 1}
    assert first["tokens"] == second["tokens"]
    assert first["decode_steps"] == second["decode_steps"]


def test_fleet_autoscale_gives_the_one_rank_report_on_every_rank(two_ranks):
    want_report, want_result, want_mesh, _ = autoscale()
    assert want_mesh is None
    for r, res in enumerate(two_ranks):
        report, result, mesh = res["autoscale"]
        assert mesh == [2, 1], r
        assert res["autoscale_ranks"] == [{"device": report["device"], "attn_kernel": "none"}] * 2
        assert result == want_result, r
        assert report == want_report, r
