"""SLO-driven replica autoscaling, AIMD-coupled to the watt arbiter.

The scaling signal is the same one :class:`~repro_torch.serve.slo.SLOTracker`
already feeds admission control: TTFT percentiles (queueing pressure —
scale **up**) and fleet fill fraction (stranded capacity — scale
**down**).  Decisions are additive in both directions (one replica per
cooldown window), because every membership change makes the
:class:`~repro_torch.cluster.arbiter.PowerBudgetArbiter` reprice the whole
fleet: a newcomer enters at the floor and climbs additively, a departure
returns its watts to the pool — thrashing membership thrashes every
tenant's budget.

``max_replicas`` is clamped to ``floor(cap_w / floor_w)``: the arbiter
*raises* on a fleet whose floors alone exceed the cluster cap, so the
scaler must never propose one.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class ScaleDecision:
    epoch: int
    action: int                  # +1 scale up, -1 scale down, 0 hold
    n_replicas: int              # membership after the action
    reason: str


@dataclass
class Autoscaler:
    """Additive-increase/additive-decrease replica count controller."""

    min_replicas: int = 1
    max_replicas: int = 4
    ttft_target: float = 0.5         # seconds, p95 over the recent window
    scale_down_fill: float = 0.35    # mean fill below which capacity strands
    backlog_per_replica: float = 4.0 # queued/replica that also forces up
    cooldown_epochs: int = 3
    down_consecutive: int = 4        # low-fill epochs required before a down
    cap_w: Optional[float] = None    # clamp max_replicas to the watt floor
    floor_w: Optional[float] = None
    decisions: List[ScaleDecision] = field(default_factory=list)
    _last_action_epoch: int = field(default=-10**9, repr=False)
    _down_streak: int = field(default=0, repr=False)

    def __post_init__(self):
        if self.cap_w is not None and self.floor_w:
            affordable = int(math.floor(self.cap_w / self.floor_w))
            self.max_replicas = min(self.max_replicas, max(affordable, 1))
        self.min_replicas = min(self.min_replicas, self.max_replicas)

    def decide(self, epoch: int, n_replicas: int, ttft_p95: float,
               fill_mean: float, n_queued: int) -> int:
        """Return -1 / 0 / +1; records the decision either way."""
        action, reason = 0, "hold"
        in_cooldown = epoch - self._last_action_epoch < self.cooldown_epochs
        backlog = n_queued / max(n_replicas, 1)
        pressure = (ttft_p95 > self.ttft_target or
                    backlog > self.backlog_per_replica)
        # hysteresis: one hot epoch resets the down-streak, so a down needs
        # `down_consecutive` quiet epochs in a row — a momentary dip during
        # the ramp must not shed the replica it will want back next epoch
        if pressure or fill_mean >= self.scale_down_fill or n_queued:
            self._down_streak = 0
        else:
            self._down_streak += 1
        if not in_cooldown:
            if pressure:
                if n_replicas < self.max_replicas:
                    action = +1
                    reason = (f"ttft_p95={ttft_p95:.3f}s"
                              if ttft_p95 > self.ttft_target
                              else f"backlog={backlog:.1f}/replica")
                else:
                    reason = "at max_replicas"
            elif (self._down_streak >= self.down_consecutive
                    and n_replicas > self.min_replicas):
                action = -1
                reason = f"fill={fill_mean:.2f}"
        else:
            reason = "cooldown"
        if action:
            self._last_action_epoch = epoch
            self._down_streak = 0
        self.decisions.append(ScaleDecision(
            epoch=epoch, action=action, n_replicas=n_replicas + action,
            reason=reason))
        return action

    @property
    def n_scale_ups(self) -> int:
        return sum(1 for d in self.decisions if d.action > 0)

    @property
    def n_scale_downs(self) -> int:
        return sum(1 for d in self.decisions if d.action < 0)

    def export_metrics(self, registry) -> None:
        registry.gauge("fleet_scale_ups", "autoscaler scale-up events").set(
            float(self.n_scale_ups))
        registry.gauge("fleet_scale_downs",
                       "autoscaler scale-down events").set(
                           float(self.n_scale_downs))
