"""Virtual-clock fleet replica: the real serving stack minus the model.

A fleet energy study needs thousands of admission / join / decode / evict
decisions per replica, reproduced bit-identically across runs — which a
wall-clock engine cannot give.  :class:`SimReplica` therefore runs the
*real* accounting components — :class:`~repro_torch.serve.scheduler.Scheduler`,
:class:`~repro_torch.serve.kvcache.PagedKVPool` (``materialize=False``),
:class:`~repro_torch.serve.fleet.prefix.PrefixCache`,
:class:`~repro_torch.serve.slack.DecodeSlackMeter` into a live
:class:`~repro_torch.core.governor.Governor`, and an
:class:`~repro_torch.serve.slo.SLOTracker` — on a virtual clock, replacing only
the jitted forward passes with a cost model (``step_s`` per decode step,
``prefill_tok_s`` per prefill token) and the sampled tokens with each
request's scripted ``out_script``.  The step loop mirrors
:class:`~repro_torch.serve.engine.EngineSession` exactly, including prefix
joins that replay their prompt suffix through *forced* decode steps.

The watt cap granted by the arbiter lands as a frequency clamp
(:meth:`HwModel.f_for_power`): a starved replica decodes slower, TTFT/
TPOT degrade, and the autoscaler sees it — the coupling the fleet story
is about.

Lifecycle: ``warming`` (spawned, paying warmup before it can serve) →
``active`` (routable) → ``draining`` (finishes what it has, gets no new
work) → ``stopped`` (resources dropped, zero watts).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.cluster.arbiter import JobSample
from repro_torch.core.governor import Governor
from repro_torch.core.policies import COUNTDOWN_SLACK, Policy
from repro_torch.core.pstate import DEFAULT_HW, HwModel
from repro_torch.serve.fleet.prefix import PrefixCache
from repro_torch.serve.fleet.router import ReplicaView
from repro_torch.serve.kvcache import PagedKVPool
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.slack import DecodeSlackMeter
from repro_torch.serve.slo import SLOTracker

WARMING, ACTIVE, DRAINING, STOPPED = "warming", "active", "draining", "stopped"


class SimReplica:
    """One simulated serving replica on a shared virtual clock."""

    def __init__(self, replica_id: int, cfg, *, n_slots: int = 4,
                 max_len: int = 128, page: int = 16,
                 num_pages: Optional[int] = None,
                 hw: HwModel = DEFAULT_HW, policy: Policy = COUNTDOWN_SLACK,
                 step_s: float = 2e-3, prefill_tok_s: float = 1e-4,
                 ttft_target: Optional[float] = None,
                 tpot_target: Optional[float] = None,
                 t_created: float = 0.0, state: str = ACTIVE):
        self.replica_id = replica_id
        self.job_id = f"replica{replica_id}"
        self.cfg = cfg
        self.n_slots = n_slots
        self.hw = hw
        self.step_s = step_s
        self.prefill_tok_s = prefill_tok_s
        self.pool = PagedKVPool(cfg, n_slots, max_len, page, num_pages,
                                materialize=False)
        self.prefix_cache = PrefixCache(self.pool)
        self.slo = SLOTracker(ttft_target=ttft_target, tpot_target=tpot_target)
        self.sched = Scheduler(self.pool, n_slots, n_prefix=0, slo=self.slo,
                               prefix_cache=self.prefix_cache)
        self.governor = Governor(policy=policy, hw=hw)
        self.meter = DecodeSlackMeter(self.governor, rank=0)
        self.now = t_created
        self.state = state
        self.cap_w = hw.watts_at_fmax
        self.f_eff = hw.f_max
        self.finished: List[Request] = []
        self.tokens_out = 0
        self._lengths: Dict[int, int] = {}      # slot -> written positions
        self._forced: Dict[int, int] = {}       # slot -> forced steps left

    # ---- arbiter coupling ------------------------------------------------
    def set_cap(self, watts: float) -> None:
        """Grant lands as a frequency clamp: decode slows under starvation."""
        self.cap_w = watts
        f = float(self.hw.f_for_power(watts, self.hw.act_comp))
        self.f_eff = min(max(f, self.hw.f_min), self.hw.f_max)

    @property
    def _step_s(self) -> float:
        return self.step_s * (self.hw.f_max / self.f_eff)

    # ---- router coupling -------------------------------------------------
    def view(self) -> ReplicaView:
        return ReplicaView(
            replica_id=self.replica_id, n_slots=self.n_slots,
            n_active=self.sched.n_active, n_queued=self.sched.n_queued,
            free_pages=self.pool.free_pages,
            capacity_pages=self.pool.capacity_pages,
            prefix_cache=self.prefix_cache,
        )

    def submit(self, req: Request) -> None:
        self.sched.submit(req)

    # ---- virtual-clock serving loop (mirrors EngineSession) --------------
    def _script_token(self, req: Request) -> int:
        if req.out_script is not None and req.n_generated < len(req.out_script):
            return int(req.out_script[req.n_generated])
        # deterministic fallback so unscripted requests still retire
        # reproducible sequences into the prefix trie
        return int((req.rid * 2654435761 + req.n_generated * 97 + 1) % 997) + 1

    def _join(self, req: Request) -> None:
        m = req.prefix_match
        slot = req.slot
        if m is not None and m.n_tokens > 0:
            pages = list(m.full_pages)
            if m.partial_page is not None:
                (pid,) = self.pool.alloc(req.rid, 1)   # CoW clone (accounting)
                pages.append(pid)
            req.pages = pages
            self._lengths[slot] = m.n_tokens
            n_forced = len(req.prompt) - m.n_tokens - 1
            if n_forced > 0:
                self._forced[slot] = n_forced
            return                                      # no prefill, no token
        n_used = self.pool.pages_needed(len(req.prompt))
        req.pages = self.pool.alloc(req.rid, n_used)
        self._lengths[slot] = len(req.prompt)
        self.now += self.prefill_tok_s * len(req.prompt) * (
            self.hw.f_max / self.f_eff)
        tok = self._script_token(req)
        req.out.append(tok)
        self.slo.on_first_token(req, self.now)

    def _grow_pages(self, req: Request) -> None:
        while self._lengths[req.slot] // self.pool.page >= len(req.pages):
            (pid,) = self.pool.alloc(req.rid, 1)
            req.pages.append(pid)

    def _retire(self, req: Request) -> None:
        self.slo.on_finish(req, self.now)
        slot = req.slot
        drained = self._forced.pop(slot, 0) == 0
        if req.pages and drained:
            n_written = self._lengths[slot]
            tokens = np.concatenate([
                np.asarray(req.prompt, np.int64),
                np.asarray(req.out, np.int64),
            ])[:n_written]
            self.prefix_cache.insert(tokens, req.pages)
        self._lengths.pop(slot, None)
        self.tokens_out += len(req.out)
        self.finished.append(req)
        self.sched.release(req)

    def _decode_step(self) -> None:
        for req in self.sched.active.values():
            self._grow_pages(req)
        t0 = self.now
        t1 = t0 + self._step_s
        self.meter.step(t0, t1, self.sched.n_active, self.n_slots)
        self.now = t1
        for slot, req in list(self.sched.active.items()):
            self._lengths[slot] += 1
            left = self._forced.get(slot, 0)
            if left > 0:
                if left == 1:
                    del self._forced[slot]
                else:
                    self._forced[slot] = left - 1
                continue
            tok = self._script_token(req)
            first = not req.out
            req.out.append(tok)
            if first:
                self.slo.on_first_token(req, t1)
            else:
                self.slo.on_token(req, t1)
            if not req.wants_more():
                self._retire(req)

    def advance_to(self, t_end: float) -> None:
        """Serve on the virtual clock until it reaches ``t_end``."""
        if self.state not in (ACTIVE, DRAINING):
            self.now = max(self.now, t_end)
            return
        while self.now < t_end:
            for req in self.sched.admit(self.now):
                self._join(req)
                if not req.wants_more():
                    self._retire(req)
            if self.sched.n_active == 0:
                nxt = self.sched.next_arrival()
                target = t_end if nxt is None else min(max(nxt, self.now), t_end)
                if target > self.now:
                    self.meter.idle(self.now, target)
                    self.now = target
                if nxt is None or nxt >= t_end:
                    break
                continue
            self._decode_step()

    # ---- lifecycle -------------------------------------------------------
    @property
    def done(self) -> bool:
        return self.sched.done

    def stop(self) -> None:
        """Drop all resources; the replica draws zero watts from here on."""
        self.prefix_cache.clear()
        self.state = STOPPED

    # ---- arbiter sample --------------------------------------------------
    def job_sample(self, epoch_dt: float) -> JobSample:
        """Model this epoch's draw from the governor's interval snapshot —
        the same accounting :class:`~repro_torch.cluster.job.GovernorJob` applies
        to live tenants, on the virtual clock.  Warming replicas draw full
        compute power (model load) and report zero slack."""
        hw = self.hw
        if self.state == WARMING:
            w = hw.watts(hw.f_max, hw.act_comp)
            return JobSample(self.job_id, float(w), 0.0)
        stats = self.governor.interval_snapshot()
        exploited = min(stats.exploited, epoch_dt)
        energy = (hw.watts(self.f_eff, hw.act_comp) * (epoch_dt - exploited)
                  + hw.watts(hw.f_min, hw.act_slack) * exploited)
        s = self.slo.summary()
        return JobSample(
            self.job_id, float(energy) / max(epoch_dt, 1e-30),
            exploited / max(epoch_dt, 1e-30),
            done=self.state == STOPPED,
            ttft_p50=s["ttft"]["p50"], ttft_p99=s["ttft"]["p99"],
            tpot_p50=s["tpot"]["p50"], tpot_p99=s["tpot"]["p99"],
            prefix_hits=self.prefix_cache.n_hits,
            prefix_lookups=self.prefix_cache.n_lookups,
            prefix_hit_rate=self.prefix_cache.hit_rate,
        )
