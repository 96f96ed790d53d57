"""Power-management policies: COUNTDOWN Slack + all paper baselines (§4, §5).

Each policy is a declarative config consumed by the vectorized engine in
``repro_torch.core.simulator``:

  baseline      — max P-state everywhere (paper's *Baseline*).
  minfreq       — min P-state everywhere (paper's *Min Freq*).
  fermata_100ms — proactive: arms a 100 ms timer only when the last comm at
                  this call site was >= 2x the threshold; slows the WHOLE
                  comm (slack+copy).  Stack-hash cost per call.
  fermata_500us — same, threshold tuned to the PCU latency.
  andante       — proactive: last-value predicts (Tcomp, Tslack) per call
                  site and picks the compute P-state that absorbs the slack.
  adagio        — andante + fermata-500us applied to the isolated slack.
  countdown     — reactive: arms a 500 us timer at EVERY comm entry; slows
                  slack+copy.  No hash, no tables.
  cntd_slack    — COUNTDOWN Slack (the paper): artificial barrier isolates
                  the slack; 500 us reactive timer applies min P-state to
                  slack ONLY; copy runs at max P-state.
  cntd_adaptive — cntd_slack with the fixed 500 us replaced by the online
                  ThetaTuner (repro_torch.core.timeout): per-site slack-CDF decay
                  bounded by the 1% overhead budget, AIMD raise on observed
                  copy slowdown, clamped to [switch_latency/2, theta_max].
  cntd_predictive — cntd_adaptive plus the online duration predictor
                  (repro_torch.core.predictor.OnlinePredictor): when predicted
                  slack clears the residue-cost bar the downshift is
                  pre-armed at comm entry (no theta wait), wrapped in a
                  per-site misprediction guard that falls back to the pure
                  tuner path when realized cost exceeds the 1% budget.
  cntd_predict_only — the paper's prediction-only strawman (Guermouche /
                  Fermata-style): pre-arms on ANY predicted slack and slows
                  the WHOLE comm (slack+copy, no artificial barrier), with
                  NO reactive timeout fallback and NO guard — the
                  configuration whose misprediction + copy-slowdown cost
                  the Table-3 bench shows overshooting the overhead budget.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Policy:
    name: str
    compute_mode: str = "max"       # max | min | andante
    comm_mode: str = "none"         # none | timeout | predict_timeout | pin_min
    comm_scope: str = "comm"        # comm (slack+copy) | slack (barrier-isolated)
    theta: float = 500e-6           # timeout duration (s); theta0 when adaptive
    uses_hash: bool = False         # per-call stack-hash + lookup cost
    uses_barrier: bool = False      # artificial barrier inserted (cost + isolation)
    theta_mode: str = "fixed"       # fixed | adaptive (online ThetaTuner)
    #                               | predictive (guarded hybrid PredictiveTuner)
    #                               | predict_only (unguarded, no timeout fallback)


BASELINE = Policy("baseline")
MINFREQ = Policy("minfreq", compute_mode="min", comm_mode="pin_min")
FERMATA_100MS = Policy(
    "fermata_100ms", comm_mode="predict_timeout", comm_scope="comm",
    theta=100e-3, uses_hash=True,
)
FERMATA_500US = Policy(
    "fermata_500us", comm_mode="predict_timeout", comm_scope="comm",
    theta=500e-6, uses_hash=True,
)
ANDANTE = Policy(
    "andante", compute_mode="andante", comm_mode="none",
    uses_hash=True, uses_barrier=True,
)
ADAGIO = Policy(
    "adagio", compute_mode="andante", comm_mode="timeout", comm_scope="slack",
    theta=500e-6, uses_hash=True, uses_barrier=True,
)
COUNTDOWN = Policy("countdown", comm_mode="timeout", comm_scope="comm", theta=500e-6)
COUNTDOWN_SLACK = Policy(
    "cntd_slack", comm_mode="timeout", comm_scope="slack",
    theta=500e-6, uses_barrier=True,
)
CNTD_ADAPTIVE = Policy(
    "cntd_adaptive", comm_mode="timeout", comm_scope="slack",
    theta=500e-6, uses_barrier=True, theta_mode="adaptive",
)
CNTD_PREDICTIVE = Policy(
    "cntd_predictive", comm_mode="timeout", comm_scope="slack",
    theta=500e-6, uses_barrier=True, theta_mode="predictive",
)
CNTD_PREDICT_ONLY = Policy(
    "cntd_predict_only", comm_mode="timeout", comm_scope="comm",
    theta=500e-6, uses_barrier=False, theta_mode="predict_only",
)

# the 8 fixed-theta policies the paper evaluates — frozen by the golden
# conformance suite (tests/test_golden.py); cntd_adaptive and the
# predictive pair ride on top (cntd_predictive has its own fixture file)
FIXED_POLICIES = [
    BASELINE, MINFREQ, FERMATA_100MS, FERMATA_500US,
    ANDANTE, ADAGIO, COUNTDOWN, COUNTDOWN_SLACK,
]

ALL_POLICIES = {
    p.name: p
    for p in FIXED_POLICIES + [CNTD_ADAPTIVE, CNTD_PREDICTIVE, CNTD_PREDICT_ONLY]
}


def policy_for_theta(theta: str, base: Policy = COUNTDOWN_SLACK) -> Policy:
    """Resolve a CLI ``--theta`` value against ``base``: ``""`` keeps it
    untouched, ``"auto"`` switches it to adaptive mode (the governor
    attaches an online :class:`~repro_torch.core.timeout.ThetaTuner`; the base's
    scope/costs/theta0 are honored), ``"predictive"`` to the guarded
    predictor+timeout hybrid (a
    :class:`~repro_torch.core.timeout.PredictiveTuner`), anything else parses as
    a fixed timeout in seconds."""
    if not theta:
        return base
    from dataclasses import replace

    if theta == "auto":
        return replace(base, theta_mode="adaptive", name="cntd_adaptive")
    if theta == "predictive":
        return replace(base, theta_mode="predictive", name="cntd_predictive")
    return replace(base, theta=float(theta))
