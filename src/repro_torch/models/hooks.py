"""Activation-sharding hooks, ported from ``repro.models.hooks``.

The model code is distribution-agnostic; the dist layer installs a
constraint function keyed by a logical activation name
(:func:`repro_torch.dist.sharding.activation_constraint_fn`: a DTensor is
redistributed to the name's placements under the mesh).  Default is
identity so models run anywhere.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

_CONSTRAIN: Optional[Callable[[torch.Tensor, str], torch.Tensor]] = None


def install_constraint(fn: Optional[Callable[[torch.Tensor, str], torch.Tensor]]) -> None:
    global _CONSTRAIN
    _CONSTRAIN = fn


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    if _CONSTRAIN is None:
        return x
    return _CONSTRAIN(x, name)
