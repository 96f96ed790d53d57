"""Fleet arrival scenarios: diurnal, flash-crowd, and session-reuse traces.

A fleet earns its energy story on *time-varying* load: a statically
provisioned fleet burns peak watts all day, an autoscaled one follows the
curve.  These generators produce deterministic request traces (a seed
fully pins arrivals, prompts, and scripted outputs) in three shapes:

* :func:`diurnal_trace` — a non-homogeneous Poisson process whose rate
  follows one sinusoidal "day": the headline static-vs-autoscaled
  comparison runs here, because off-peak is where static provisioning
  strands joules;
* :func:`flash_crowd_trace` — baseline Poisson with a short multiplied
  burst window: the autoscaler's reaction-time stressor (CI smoke runs a
  tiny one);
* :func:`session_reuse_trace` — multi-turn conversations that resend the
  whole dialogue each turn over a shared system prompt: the prefix
  cache's home turf (every turn's prompt is a served-before prefix plus
  a short tail).

Each request carries ``out_script`` — the tokens it would "generate" —
so the fleet *simulator* retires deterministic sequences into the prefix
trie (turn ``k+1`` can only hit resident pages if turn ``k``'s scripted
output is part of its prompt).  The real engine ignores scripts and
samples from the model.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from repro_torch.serve.scheduler import Request


@dataclass
class FleetTrace:
    """One scenario: arrival-sorted requests plus its shape metadata."""

    name: str
    requests: List[Request]
    duration_s: float
    seed: int

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    def fresh_requests(self) -> List[Request]:
        """Re-instantiate every request (new rids, clean runtime state) so
        one trace can drive several fleets in the same process."""
        return [
            Request(prompt=r.prompt, max_new=r.max_new, arrival=r.arrival,
                    eos_id=r.eos_id, session=r.session,
                    out_script=r.out_script)
            for r in self.requests
        ]


def _thinned_arrivals(rate_fn: Callable[[float], float], rate_max: float,
                      duration_s: float, rng: np.random.Generator) -> np.ndarray:
    """Non-homogeneous Poisson arrivals on [0, duration) by thinning."""
    out: List[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate_max)
        if t >= duration_s:
            break
        if rng.uniform() * rate_max <= rate_fn(t):
            out.append(t)
    return np.asarray(out)


def _mk_requests(arrivals: np.ndarray, rng: np.random.Generator, *,
                 vocab: int, prompt_len: int, max_new: int,
                 shared_prefix_len: int = 0,
                 shared_prefix: Optional[np.ndarray] = None) -> List[Request]:
    if shared_prefix is None and shared_prefix_len:
        shared_prefix = rng.integers(1, vocab, shared_prefix_len)
    reqs = []
    for t in arrivals:
        tail = rng.integers(1, vocab, prompt_len)
        prompt = tail if shared_prefix is None else np.concatenate(
            [shared_prefix, tail])
        script = rng.integers(1, vocab, max_new)
        reqs.append(Request(prompt=prompt.astype(np.int32), max_new=max_new,
                            arrival=float(t),
                            out_script=script.astype(np.int32)))
    return reqs


def diurnal_trace(duration_s: float = 60.0, base_rate: float = 2.0,
                  peak_ratio: float = 6.0, prompt_len: int = 24,
                  max_new: int = 16, shared_prefix_len: int = 16,
                  vocab: int = 1000, seed: int = 0) -> FleetTrace:
    """One sinusoidal "day": rate swings ``base_rate`` .. ``base_rate *
    peak_ratio`` with the peak at mid-trace.  All requests share a system
    prompt of ``shared_prefix_len`` tokens (realistic, and it gives the
    router a prefix signal even on fresh traffic)."""
    rng = np.random.default_rng(seed)
    peak = base_rate * peak_ratio

    def rate(t: float) -> float:
        # cosine valley at t=0 and t=duration, peak at duration/2
        return base_rate + (peak - base_rate) * 0.5 * (
            1.0 - np.cos(2.0 * np.pi * t / duration_s))

    arrivals = _thinned_arrivals(rate, peak, duration_s, rng)
    reqs = _mk_requests(arrivals, rng, vocab=vocab, prompt_len=prompt_len,
                        max_new=max_new, shared_prefix_len=shared_prefix_len)
    return FleetTrace("diurnal", reqs, duration_s, seed)


def flash_crowd_trace(duration_s: float = 20.0, base_rate: float = 2.0,
                      burst_ratio: float = 10.0, burst_start_frac: float = 0.4,
                      burst_width_frac: float = 0.15, prompt_len: int = 24,
                      max_new: int = 16, shared_prefix_len: int = 16,
                      vocab: int = 1000, seed: int = 0) -> FleetTrace:
    """Steady Poisson load with one ``burst_ratio``× window — the
    autoscaler reaction-time stressor."""
    rng = np.random.default_rng(seed)
    b0 = burst_start_frac * duration_s
    b1 = b0 + burst_width_frac * duration_s
    peak = base_rate * burst_ratio

    def rate(t: float) -> float:
        return peak if b0 <= t < b1 else base_rate

    arrivals = _thinned_arrivals(rate, peak, duration_s, rng)
    reqs = _mk_requests(arrivals, rng, vocab=vocab, prompt_len=prompt_len,
                        max_new=max_new, shared_prefix_len=shared_prefix_len)
    return FleetTrace("flash_crowd", reqs, duration_s, seed)


def session_reuse_trace(n_sessions: int = 8, turns: int = 4,
                        system_len: int = 24, turn_len: int = 8,
                        max_new: int = 8, session_rate: float = 1.0,
                        turn_gap_s: float = 2.0, vocab: int = 1000,
                        seed: int = 0) -> FleetTrace:
    """Multi-turn conversations over one shared system prompt.

    Turn ``k``'s prompt is ``system + (user_1 + reply_1) + ... + user_k``
    — the full dialogue resent, exactly the traffic prefix caching exists
    for.  Replies are the scripted ``out_script`` tokens, so the
    simulator's retired pages really are the next turn's prefix.
    """
    rng = np.random.default_rng(seed)
    system = rng.integers(1, vocab, system_len).astype(np.int32)
    starts = np.cumsum(rng.exponential(1.0 / session_rate, n_sessions))
    starts[0] = 0.0
    reqs: List[Request] = []
    t_last = 0.0
    for sid in range(n_sessions):
        history = system
        t = float(starts[sid])
        for k in range(turns):
            user = rng.integers(1, vocab, turn_len).astype(np.int32)
            prompt = np.concatenate([history, user])
            script = rng.integers(1, vocab, max_new).astype(np.int32)
            reqs.append(Request(prompt=prompt, max_new=max_new, arrival=t,
                                session=sid, out_script=script))
            # the reply the next turn's prompt includes is what the engine
            # *wrote*: the last scripted token's K/V never lands (it is
            # sampled, then the request retires), so resend all but it
            history = np.concatenate([prompt, script[:-1]])
            t_last = max(t_last, t)
            t += turn_gap_s * (0.5 + rng.uniform())
    reqs.sort(key=lambda r: (r.arrival, r.rid))
    return FleetTrace("session_reuse", reqs, t_last, seed)
