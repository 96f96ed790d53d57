"""Calibrated multi-rank workload generators (NPB suite + OMEN, §6.1).

Each application is parameterized by the paper's own measurements
(Table 2: Tcomm%, Tslack%, average MPI duration; Table 3: Min-Freq overhead
=> frequency-sensitivity beta) and the generator *self-calibrates*: it
draws the compute-imbalance sample, then solves the dispersion scale so the
simulated baseline reproduces the target slack/comm fractions.

Structure knobs that matter for the paper's story:
  * ``sigma_noise``   — task-to-task unpredictable variation (breaks
                        last-value prediction => Andante/Fermata overheads);
  * ``sigma_rank``    — persistent rank skew (predictable imbalance);
  * ``p2p_fraction``  — pairwise comms (pipelined solvers like LU);
  * ``n_sites``       — distinct call sites (stack-hash universe).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.core.policies import BASELINE
from repro_torch.core.pstate import DEFAULT_HW, HwModel
from repro_torch.core.simulator import Workload, simulate

EFFECTIVE_BW = 5e9  # bytes/s: copy seconds -> message bytes (feature only)


@dataclass(frozen=True)
class AppSpec:
    name: str
    n_ranks: int
    n_tasks: int
    comp_mean: float            # seconds per task (f_max)
    slack_mean: float           # target mean slack per task
    copy_mean: float            # seconds per task
    beta_comp: float
    beta_copy: float
    sigma_noise: float = 0.25   # lognormal sigma, unpredictable part
    sigma_rank: float = 0.10    # persistent rank skew
    sigma_task: float = 0.30    # per-task shared scale (heavy tail => some
                                # calls far above the mean, exploitable slack
                                # even when the *average* MPI call is tiny)
    p2p_fraction: float = 0.0
    n_sites: int = 12
    site_sigma: float = 0.4     # dispersion of per-site scales (bimodality)
    copy_sigma: float = 0.3     # dispersion of copy durations (tail mass)
    unique_sites: bool = False  # every call a fresh stack (defeats prediction)
    # paper Table 2 reference values [% of execution time] for reporting
    ref_tcomm: float = 0.0
    ref_tslack: float = 0.0


# Derivation of comp/slack/copy means from Table 2 (see DESIGN.md): with
# avg-MPI = slack+copy and Tcomm%, Tslack% per the paper,
#   task_total = avgMPI / Tcomm%,  comp = task_total - avgMPI,
#   slack = Tslack% * task_total,  copy = avgMPI - slack.
# beta = MinFreq-overhead% / (100 * (fmax/fmin - 1)).
APPS: Dict[str, AppSpec] = {
    "nas_bt.E.1024": AppSpec(
        "nas_bt.E.1024", 32, 400, comp_mean=1.525, slack_mean=1.07e-3,
        copy_mean=0.76e-3, beta_comp=0.54, beta_copy=0.15,
        sigma_noise=0.35, sigma_rank=0.05, n_sites=16,
        ref_tcomm=0.12, ref_tslack=0.07,
    ),
    "nas_cg.E.1024": AppSpec(
        "nas_cg.E.1024", 32, 2000, comp_mean=3.868e-3, slack_mean=4.2e-6,
        copy_mean=2.064e-3, beta_comp=0.16, beta_copy=0.10,
        sigma_noise=0.10, sigma_rank=0.02, p2p_fraction=0.5, n_sites=10, copy_sigma=0.8,
        ref_tcomm=34.84, ref_tslack=0.07,
    ),
    "nas_ep.E.128": AppSpec(
        "nas_ep.E.128", 32, 3, comp_mean=298.0, slack_mean=24.38,
        copy_mean=1e-3, beta_comp=1.0, beta_copy=0.10,
        sigma_noise=0.06, sigma_rank=0.04, sigma_task=0.05, n_sites=3, unique_sites=True,
        ref_tcomm=7.56, ref_tslack=7.56,
    ),
    "nas_ft.E.1024": AppSpec(
        "nas_ft.E.1024", 32, 160, comp_mean=1.273, slack_mean=0.448,
        copy_mean=1.927, beta_comp=0.26, beta_copy=0.12,
        sigma_noise=0.30, sigma_rank=0.10, n_sites=8,
        ref_tcomm=65.10, ref_tslack=12.28,
    ),
    "nas_is.D.128": AppSpec(
        "nas_is.D.128", 32, 800, comp_mean=164.6e-3, slack_mean=121.1e-3,
        copy_mean=155.9e-3, beta_comp=0.22, beta_copy=0.12,
        sigma_noise=0.45, sigma_rank=0.15, sigma_task=0.6, site_sigma=1.5, n_sites=6,
        ref_tcomm=62.73, ref_tslack=27.42,
    ),
    "nas_lu.E.1024": AppSpec(
        "nas_lu.E.1024", 32, 10000, comp_mean=0.095e-3, slack_mean=0.0883e-3,
        copy_mean=0.0107e-3, beta_comp=0.58, beta_copy=0.20,
        sigma_noise=0.55, sigma_rank=0.20, sigma_task=2.2, site_sigma=1.2, p2p_fraction=0.9, n_sites=24,
        ref_tcomm=51.01, ref_tslack=45.51,
    ),
    "nas_mg.E.128": AppSpec(
        "nas_mg.E.128", 32, 2000, comp_mean=11.55e-3, slack_mean=0.0114e-3,
        copy_mean=1.12e-3, beta_comp=0.03, beta_copy=0.10,
        sigma_noise=0.12, sigma_rank=0.02, p2p_fraction=0.3, n_sites=14, copy_sigma=1.3,
        ref_tcomm=8.94, ref_tslack=0.09,
    ),
    "nas_sp.E.1024": AppSpec(
        "nas_sp.E.1024", 32, 200, comp_mean=2.893, slack_mean=0.58e-3,
        copy_mean=0.87e-3, beta_comp=0.09, beta_copy=0.10,
        sigma_noise=0.20, sigma_rank=0.03, n_sites=16,
        ref_tcomm=0.05, ref_tslack=0.02,
    ),
    "omen_60p": AppSpec(
        "omen_60p", 16, 2000, comp_mean=40.4e-3, slack_mean=56.2e-3,
        copy_mean=3.7e-3, beta_comp=0.91, beta_copy=0.15,
        sigma_noise=0.80, sigma_rank=0.30, sigma_task=1.0, site_sigma=2.0, n_sites=10,
        ref_tcomm=59.69, ref_tslack=56.00,
    ),
    "omen_1056p": AppSpec(
        "omen_1056p", 48, 2000, comp_mean=34.2e-3, slack_mean=52.1e-3,
        copy_mean=6.0e-3, beta_comp=0.32, beta_copy=0.15,
        sigma_noise=0.85, sigma_rank=0.35, sigma_task=1.0, site_sigma=2.0, n_sites=10,
        ref_tcomm=62.96, ref_tslack=56.42,
    ),
}


def generate(spec: AppSpec, seed: int = 0, calibrate: bool = True,
             hw: HwModel = DEFAULT_HW) -> Workload:
    rng = np.random.default_rng(seed)
    t_tasks, n = spec.n_tasks, spec.n_ranks

    if spec.unique_sites:
        site = np.arange(t_tasks)
        n_sites_eff = t_tasks
    else:
        site = rng.integers(0, spec.n_sites, t_tasks)
        n_sites_eff = spec.n_sites
    site_scale = np.exp(rng.normal(0.0, spec.site_sigma, n_sites_eff))
    task_scale = np.exp(rng.normal(0.0, spec.sigma_task, t_tasks))
    rank_skew = np.exp(rng.normal(0.0, spec.sigma_rank, n))
    noise = np.exp(rng.normal(0.0, spec.sigma_noise, (t_tasks, n)))

    x = (site_scale[site] * task_scale)[:, None] * rank_skew[None, :] * noise
    x = x / x.mean()                                             # (T,N)

    is_p2p = rng.random(t_tasks) < spec.p2p_fraction
    partner = np.zeros((t_tasks, n), dtype=np.int64)
    for k in np.where(is_p2p)[0]:
        perm = rng.permutation(n)
        pairs = perm.reshape(-1, 2)
        p = np.zeros(n, dtype=np.int64)
        p[pairs[:, 0]] = pairs[:, 1]
        p[pairs[:, 1]] = pairs[:, 0]
        partner[k] = p

    # dispersion that reproduces the target slack:  comp = c*((1-l) + l*x)
    if is_p2p.any():
        spread_p2p = np.abs(x - x[np.arange(t_tasks)[:, None], partner]).mean()
    else:
        spread_p2p = 0.0
    spread_coll = (x.max(axis=1, keepdims=True) - x).mean()
    frac_p2p = is_p2p.mean()
    # for p2p the slack of a pair is |x1-x2|/2 on average per rank
    spread = (1 - frac_p2p) * spread_coll + frac_p2p * 0.5 * spread_p2p
    lam = min(spec.slack_mean / max(spec.comp_mean * spread, 1e-30), 1.0)
    comp = spec.comp_mean * ((1.0 - lam) + lam * x)

    copy_scale = np.exp(rng.normal(0.0, spec.copy_sigma, n_sites_eff))
    copy = spec.copy_mean * copy_scale[site] * np.exp(rng.normal(0, 0.2, t_tasks))
    copy = copy * (spec.copy_mean / max(copy.mean(), 1e-30))

    copy_jitter = np.exp(rng.normal(0.0, 0.25, (t_tasks, n)))
    copy_jitter /= copy_jitter.mean()

    wl = Workload(
        name=spec.name, n_ranks=n, comp=comp, copy=copy, is_p2p=is_p2p,
        partner=partner, site=site, nbytes=np.maximum(copy, 0.0) * EFFECTIVE_BW,
        beta_comp=spec.beta_comp, beta_copy=spec.beta_copy,
        copy_jitter=copy_jitter,
    )

    if calibrate:
        # one fixed-point refinement of the dispersion against the simulator
        res, _ = simulate(wl, BASELINE, hw)
        measured_slack = res.tslack / max(res.calls * n, 1)
        if measured_slack > 0 and spec.slack_mean > 0:
            ratio = spec.slack_mean / measured_slack
            lam2 = min(lam * ratio, 1.0)
            wl.comp[:] = spec.comp_mean * ((1.0 - lam2) + lam2 * x)
    return wl


def make_all(seed: int = 0) -> Dict[str, Workload]:
    return {name: generate(spec, seed) for name, spec in APPS.items()}
