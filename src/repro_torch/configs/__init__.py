"""Architecture registry: ``get_config(name)`` / ``ARCHS``.

A copy of the JAX package's registry, every architecture it registers:
the dense ``llama3.2-1b``, ``glm4-9b``, ``internlm2-1.8b`` and
``olmo-1b`` (nonparametric norm, MHA), the MoE ``granite-moe-3b-a800m``
and ``mixtral-8x22b`` (window 4096), the frontend-prefix ``internvl2-1b``
(vlm) and ``musicgen-large`` (audio: LayerNorm, the GELU MLP), the hybrid
``recurrentgemma-2b``, the SSM ``mamba2-130m`` and ``countdown-100m``
(dense, the trainer's default and the paper's own ~100M vehicle).
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

ARCHS = (
    "musicgen-large",
    "granite-moe-3b-a800m",
    "mixtral-8x22b",
    "internvl2-1b",
    "recurrentgemma-2b",
    "llama3.2-1b",
    "glm4-9b",
    "olmo-1b",
    "internlm2-1.8b",
    "mamba2-130m",
    # the paper's own evaluation vehicle: a ~100M dense LM used by examples/
    "countdown-100m",
)

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
