"""The port's instrumented collectives (``repro_torch.core.instrument``) on
``torch.distributed`` against the reference's ``lax`` wrappers.

* A gloo world of 1 in this process against the reference under
  ``jax.make_mesh((1,), ("r",))`` (the setup of ``tests/test_timeout.py``):
  the same outputs in every mode, the same phase events (rank, phase, call
  id, in order) for the blocking wrappers and the async pairs, and the same
  ``EventBatch`` columns but time under batched ingest.
* One spawn of 4 gloo ranks: ring and partial ``cd_ppermute``,
  ``cd_all_gather``, ``cd_psum`` and ``cd_pmean`` against numpy, inputs
  untouched by every wrapper, slack booked through the port's governor by
  the ranks that wait on a rank 50 ms late, and compute between
  ``cd_psum_async`` and ``cd_wait`` booked as overlap, not slack.  Both are
  held to the ranks' own event times, so a loaded host cannot break them.

JAX is imported inside the reference-side helpers only, so the spawned
ranks, which import this module, load torch alone.
"""
import json
import os
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import instrument as TI
from repro_torch.core.governor import Governor
from repro_torch.core.policies import COUNTDOWN_SLACK

MODES = ("off", "barrier", "profile")
WORLD = 4
JOIN_LIMIT_S = 120.0


@pytest.fixture(autouse=True)
def _fresh_port_instrumentation():
    """The port's ambient state (mode, bus, call counter) is its own; the
    suite's conftest resets only the reference's."""
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


def inputs():
    rng = np.random.default_rng(0)
    return rng.normal(0, 1, (2, 4)).astype(np.float32), \
        rng.normal(0, 1, (3,)).astype(np.float32)


# --------------------------------------------------------------------------
# a world of 1 against the reference
# --------------------------------------------------------------------------

def reference_run(mode, x, v, batched):
    """The reference's wrappers under a 1-device mesh in ``mode``: outputs
    and the events (rank, phase, call id) or the batch columns."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import instrument as JI
    from repro.dist.compat import set_mesh, shard_map

    mesh = jax.make_mesh((1,), ("r",))
    events, batches = [], []
    JI.set_event_sink(lambda r, p, c, t: events.append((int(r), p, int(c))))
    JI.get_event_bus().subscribe(type("B", (), {"on_batch": lambda s, b: batches.append(b)})(),
                                 name="batches")
    if batched:
        JI.set_ingest_mode("batched")
    JI.set_mode(mode)
    JI.enable_events(mode == "profile")

    def f(x, v):
        a = JI.cd_psum(x, "r")
        b = JI.cd_pmean({"x": x, "v": [v]}, "r")
        c = JI.cd_all_gather(x, "r", tiled=True)
        d = JI.cd_all_gather(x, "r", axis=1, tiled=False)
        e = JI.cd_ppermute((x, v), "r", [(0, 0)])
        h1 = JI.cd_psum_async(x, "r")
        h2 = JI.cd_all_gather_async(v, "r", tiled=False)
        y = x * 2.0                                   # overlapped compute
        return a, b, c, d, e, JI.cd_wait(h1) + y, JI.cd_wait(h2)

    with set_mesh(mesh):
        g = shard_map(f, mesh=mesh, in_specs=P("r"), out_specs=P("r"), manual_axes=("r",))
        out = jax.block_until_ready(jax.jit(g)(jnp.asarray(x), jnp.asarray(v)))
    JI.flush_events()
    JI.reset_instrumentation()
    return jax.tree.map(np.asarray, out), events, batches


def port_run(mode, x, v, batched):
    events, batches = [], []
    TI.set_event_sink(lambda r, p, c, t: events.append((r, p, c)))
    TI.get_event_bus().subscribe(type("B", (), {"on_batch": lambda s, b: batches.append(b)})(),
                                 name="batches")
    if batched:
        TI.set_ingest_mode("batched")
    TI.set_mode(mode)
    TI.enable_events(mode == "profile")
    x, v = torch.from_numpy(x), torch.from_numpy(v)
    a = TI.cd_psum(x)
    b = TI.cd_pmean({"x": x, "v": [v]})
    c = TI.cd_all_gather(x, tiled=True)
    d = TI.cd_all_gather(x, axis=1, tiled=False)
    e = TI.cd_ppermute((x, v), [(0, 0)])
    h1 = TI.cd_psum_async(x)
    h2 = TI.cd_all_gather_async(v, tiled=False)
    y = x * 2.0
    out = (a, b, c, d, e, TI.cd_wait(h1) + y, TI.cd_wait(h2))
    TI.flush_events()
    TI.reset_instrumentation()
    return out, events, batches


def flat(tree):
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for t in tree for a in flat(t)]
    return [tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)]


@pytest.mark.parametrize("mode", MODES)
def test_world_of_one_matches_reference_outputs_and_events(world_of_one, mode):
    x, v = inputs()
    want, want_ev, _ = reference_run(mode, x, v, batched=False)
    got, got_ev, _ = port_run(mode, x, v, batched=False)
    w, g = flat(want), flat(got)
    assert len(w) == len(g) == 9
    for a, b in zip(w, g):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
    assert got_ev == want_ev
    if mode == "profile":
        blocking = ["barrier_enter", "barrier_exit", "copy_exit"]
        asyncs = ["dispatch_enter", "dispatch_enter", "wait_enter", "barrier_exit",
                  "copy_exit", "wait_enter", "barrier_exit", "copy_exit"]
        assert [p for _, p, _ in got_ev] == blocking * 5 + asyncs
        assert [c for _, _, c in got_ev] == [1] * 3 + [2] * 3 + [3] * 3 + [4] * 3 \
            + [5] * 3 + [6, 7, 6, 6, 6, 7, 7, 7]
    else:
        assert got_ev == []


def test_world_of_one_batched_ingest_matches_reference(world_of_one):
    x, v = inputs()
    _, _, want = reference_run("profile", x, v, batched=True)
    _, _, got = port_run("profile", x, v, batched=True)
    assert len(got) == len(want) == 1
    for col in ("rank", "code", "call_id"):
        np.testing.assert_array_equal(getattr(got[0], col), getattr(want[0], col))
        assert getattr(got[0], col).dtype == getattr(want[0], col).dtype
    assert got[0].n == 23 and bool(np.all(np.diff(got[0].t) >= 0))


def test_off_mode_issues_no_barrier_and_no_call_id(world_of_one):
    def barrier_groups():
        return [k for k in TI._BARRIER_GROUPS if k[0] is dist.group.WORLD]

    x = torch.arange(4.0)
    TI.cd_psum(x)
    TI.cd_wait(TI.cd_psum_async(x))
    assert TI._CALL_COUNTER[0] == 0 and not barrier_groups()
    TI.set_mode("barrier")
    TI.cd_psum(x)
    TI.cd_wait(TI.cd_psum_async(x))
    assert TI._CALL_COUNTER[0] == 2 and barrier_groups() == [(dist.group.WORLD, (0,))]


def test_ppermute_refuses_a_perm_that_is_not_one(world_of_one):
    TI.set_mode("barrier")
    with pytest.raises(ValueError, match="unique"):
        TI.cd_ppermute(torch.ones(2), [(0, 0), (0, 0)])
    with pytest.raises(ValueError, match="below 1"):
        TI.cd_ppermute(torch.ones(2), [(0, 1)])


# --------------------------------------------------------------------------
# 4 gloo ranks
# --------------------------------------------------------------------------

def rank_input(r):
    return np.arange(6, dtype=np.float32).reshape(2, 3) + 10.0 * r


def check_values(rank):
    """Every wrapper in every mode against numpy, inputs untouched."""
    xs = [rank_input(r) for r in range(WORLD)]
    x = torch.from_numpy(xs[rank])
    keep = x.clone()
    ring = [(r, (r + 1) % WORLD) for r in range(WORLD)]
    partial = [(0, 1), (1, 2)]                      # rank 0 and 3 get zeros
    for mode in MODES:
        TI.set_mode(mode)
        TI.enable_events(mode == "profile")
        got = TI.cd_ppermute(x, ring)
        np.testing.assert_array_equal(got.numpy(), xs[(rank - 1) % WORLD])
        got = TI.cd_ppermute({"a": x, "b": [x[0]]}, partial)
        src = {1: 0, 2: 1}.get(rank)
        want = np.zeros_like(xs[0]) if src is None else xs[src]
        np.testing.assert_array_equal(got["a"].numpy(), want)
        np.testing.assert_array_equal(got["b"][0].numpy(), want[0])
        for axis in (0, 1):
            np.testing.assert_array_equal(TI.cd_all_gather(x, axis=axis).numpy(),
                                          np.concatenate(xs, axis=axis))
            np.testing.assert_array_equal(TI.cd_all_gather(x, axis=axis, tiled=False).numpy(),
                                          np.stack(xs, axis=axis))
            h = TI.cd_all_gather_async(x, axis=axis)
            np.testing.assert_array_equal(TI.cd_wait(h).numpy(), np.concatenate(xs, axis=axis))
        np.testing.assert_allclose(TI.cd_psum(x).numpy(), np.sum(xs, axis=0))
        np.testing.assert_allclose(TI.cd_pmean(x).numpy(), np.mean(xs, axis=0), rtol=1e-6)
        np.testing.assert_allclose(TI.cd_wait(TI.cd_psum_async(x)).numpy(), np.sum(xs, axis=0))
        assert torch.equal(x, keep), mode
    TI.reset_instrumentation()


def governed(fn, on_event=None):
    """Run ``fn`` in profile mode with a fresh port governor on the bus:
    its report and the one call's event times by phase (``on_event`` sees
    each event as it is stamped)."""
    gov, times = Governor(policy=COUNTDOWN_SLACK), {}
    TI.get_event_bus().subscribe(gov)

    def sink(r, phase, c, t):
        times[phase] = t
        if on_event is not None:
            on_event(phase)

    TI.set_event_sink(sink)
    TI.set_mode("profile")
    TI.enable_events(True)
    fn()
    TI.reset_instrumentation()
    return gov.finalize(), times


def rank_main(rank, store_path, out_dir):
    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=60))
    try:
        check_values(rank)
        x = torch.full((1024,), float(rank))
        others = [f"in{r}" for r in range(WORLD - 1)]

        def arrived(phase):
            if phase == "barrier_enter":
                store.set(f"in{rank}", "1")

        def late():
            # the last rank enters 50 ms after every other rank has stamped
            # its own entry, however the host schedules the four processes
            if rank == WORLD - 1:
                store.wait(others, timedelta(seconds=60))
                time.sleep(0.05)
            TI.cd_psum(x)

        def overlapped():
            dist.barrier()
            h = TI.cd_psum_async(x)
            time.sleep(0.05)                          # compute under the flying sum
            TI.cd_wait(h)

        rep_late, t_late = governed(late, arrived)
        rep_overlap, t_overlap = governed(overlapped)
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
            json.dump({"late_slack": rep_late.total_slack,
                       "late_calls": rep_late.n_calls, "late_t": t_late,
                       "overlap": rep_overlap.total_overlap,
                       "overlap_slack": rep_overlap.total_slack,
                       "overlap_t": t_overlap}, f)
    finally:
        dist.destroy_process_group()


def test_four_gloo_ranks(tmp_path):
    """Slack and overlap are held to the ranks' own event times (one
    monotonic clock on one host), so the checks do not depend on how the
    host schedules the four processes."""
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
    res = [json.load(open(tmp_path / f"{r}.json")) for r in range(WORLD)]
    exact = dict(rel=0, abs=1e-12)

    # a rank 50 ms late: every other rank books, as slack, at least the time
    # from its own entry to the late rank's, which no rank leaves before
    enter = [got["late_t"]["barrier_enter"] for got in res]
    last = enter[-1]
    assert last >= max(enter[:-1]) + 0.05, enter
    for r, got in enumerate(res):
        t = got["late_t"]
        assert got["late_calls"] == 1, got
        assert list(t) == ["barrier_enter", "barrier_exit", "copy_exit"], t
        assert got["late_slack"] == pytest.approx(t["barrier_exit"] - t["barrier_enter"], **exact)
        assert t["barrier_exit"] >= last, (r, t, last)
    waiting = [got["late_slack"] for got in res[:-1]]
    assert min(waiting) >= 0.05, res                  # the ranks that waited on rank 3
    for r in range(WORLD - 1):
        assert waiting[r] >= last - enter[r], (r, res)

    # compute between dispatch and wait: the whole window is overlap, and
    # slack starts at the wait, so none of the compute is booked as slack
    wait = [got["overlap_t"]["wait_enter"] for got in res]
    for r, got in enumerate(res):
        t = got["overlap_t"]
        assert list(t) == ["dispatch_enter", "wait_enter", "barrier_exit", "copy_exit"], t
        assert got["overlap"] == pytest.approx(t["wait_enter"] - t["dispatch_enter"], **exact)
        assert got["overlap"] >= 0.05, (r, got)
        assert got["overlap_slack"] == pytest.approx(t["barrier_exit"] - t["wait_enter"], **exact)
        assert got["overlap_slack"] >= max(wait) - wait[r], (r, got, wait)
