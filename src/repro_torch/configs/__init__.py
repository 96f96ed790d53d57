"""Architecture registry: ``get_config(name)`` / ``ARCHS``.

A copy of the JAX package's registry holding the architectures the port
runs so far: ``countdown-100m`` (dense, the trainer's default and the
paper's own ~100M vehicle), ``llama3.2-1b`` (dense), ``recurrentgemma-2b``
(hybrid) and ``mamba2-130m`` (SSM).
Each further family is registered here as its modules are ported
(ROADMAP.md, queue 1).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (
    FULL_ATTENTION_ONLY,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    cell_is_runnable,
    reduced,
)

ARCHS = ("countdown-100m", "llama3.2-1b", "recurrentgemma-2b", "mamba2-130m")

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}


__all__ = [
    "ARCHS",
    "SHAPES",
    "FULL_ATTENTION_ONLY",
    "ModelConfig",
    "ShapeConfig",
    "get_config",
    "all_configs",
    "cell_is_runnable",
    "reduced",
]
