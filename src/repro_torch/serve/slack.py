"""Decode-slack governor bridge: price serving underfill like MPI slack.

The paper isolates the slack inside a blocking collective with an
artificial barrier and spends it at the minimum P-state.  A serving
engine has the exact analogue in two forms:

* **underfill** — a decode step dispatched with ``filled < capacity``
  slots does full-width work but only ``filled/capacity`` of it moves
  payload; the empty fraction of the step is slack;
* **idle gaps** — wall time between the last completion and the next
  arrival, a whole phase of pure slack.

:class:`DecodeSlackMeter` maps both onto the canonical phase vocabulary
as fully-formed :class:`~repro_torch.core.events.PhaseRecord` values: a decode
step spanning ``[t0, t1]`` with ``f`` of ``C`` slots filled becomes a
phase entered at ``t0`` whose slack ends at ``t0 + (t1-t0)·(1 - f/C)``
and whose copy ends at ``t1`` — so ``finalize()`` prices underfill in
joules with the same ``theta_eff`` timeout filter, and idle intervals
book ``set_pstate_min``/``restore_pstate_max`` actuation pairs, exactly
as a blocked MPI rank would.  The meter targets either a
:class:`~repro_torch.core.governor.Governor` directly (``on_phase``) or an
:class:`~repro_torch.core.events.EventBus` (``publish_phase`` fan-out to N
subscribers) — it cannot tell the difference, which is the point.

Call ids live in a private namespace (upper bit set) so meter phases can
never collide with the instrumented-collective counter.  Because those ids
are minted fresh per phase, the meter also stamps a *stable site* on each
record (one for underfill steps, one for idle gaps): the
:class:`~repro_torch.core.timeout.ThetaTuner` keys its slack histograms by site,
so decode slack accumulates into two long-lived distributions — the same
tuner the MPI-side collectives feed — instead of one cold histogram per
step.
"""
from __future__ import annotations

import itertools

from repro_torch.core.events import PhaseRecord

_CALL_ID_BASE = 1 << 20

# stable tuner sites (see module docstring); ids count from past them
SITE_DECODE_STEP = _CALL_ID_BASE
SITE_IDLE_GAP = _CALL_ID_BASE + 1


class DecodeSlackMeter:
    """Feeds decode underfill + idle gaps into a governor or event bus."""

    def __init__(self, target, rank: int = 0):
        # duck-typed: an EventBus exposes publish_phase, a Governor (or any
        # canonical subscriber) exposes on_phase
        publish = getattr(target, "publish_phase", None)
        if publish is None:
            publish = target.on_phase
        self._publish = publish
        self.target = target
        self.rank = rank
        self._ids = itertools.count(_CALL_ID_BASE + 2)
        self.n_steps = 0
        self.n_idle = 0
        self.slot_steps_filled = 0
        self.slot_steps_total = 0

    def step(self, t0: float, t1: float, filled: int, capacity: int) -> None:
        """One decode step: the unfilled slot fraction of [t0, t1] is slack."""
        self.n_steps += 1
        self.slot_steps_filled += filled
        self.slot_steps_total += capacity
        underfill = 1.0 - filled / max(capacity, 1)
        t_slack_end = t0 + (t1 - t0) * underfill
        self._publish(PhaseRecord(self.rank, next(self._ids), t0, t_slack_end,
                                  t1, SITE_DECODE_STEP))

    def idle(self, t0: float, t1: float) -> None:
        """An inter-arrival gap with zero active slots: pure slack."""
        self.n_idle += 1
        self._publish(PhaseRecord(self.rank, next(self._ids), t0, t1, t1,
                                  SITE_IDLE_GAP))

    @property
    def fill_fraction(self) -> float:
        return self.slot_steps_filled / max(self.slot_steps_total, 1)
