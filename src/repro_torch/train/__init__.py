"""``repro_torch.train`` — training steps, optimizer, and synthetic data,
ported from ``repro.train``.

``loop``       :func:`make_train_step` and :func:`make_pod_train_step`
               (over a ``(pod, data, model)`` mesh, sharded inside each
               pod, or a process group; gradients reduced over the pods
               through the instrumented ``cd_psum``), plus
               :class:`TrainConfig` / :func:`init_state`.
``optimizer``  AdamW over trees of tensors: :class:`OptConfig`,
               :func:`adamw_update`, warmup-cosine :func:`schedule`,
               :func:`global_norm`.
``data``       :class:`SyntheticCorpus` / :class:`DataLoader` deterministic
               token streams for smoke and benchmark runs.
"""
from repro_torch.train.data import DataLoader, SyntheticCorpus  # noqa: F401
from repro_torch.train.loop import (  # noqa: F401
    TrainConfig,
    init_state,
    make_pod_train_step,
    make_train_step,
)
from repro_torch.train.optimizer import (  # noqa: F401
    OptConfig,
    adamw_update,
    global_norm,
    init_opt_state,
    schedule,
)

__all__ = [
    "DataLoader",
    "OptConfig",
    "SyntheticCorpus",
    "TrainConfig",
    "adamw_update",
    "global_norm",
    "init_opt_state",
    "init_state",
    "make_pod_train_step",
    "make_train_step",
    "schedule",
]
