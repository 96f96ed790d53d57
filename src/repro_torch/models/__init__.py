"""Model code of the port: layers, the transformer of every family
(:mod:`repro_torch.models.transformer`), MoE, the recurrent blocks and the
input makers.  Exports the reference's names (``repro.models``), resolved
lazily (PEP 562): the kernels' modules import ``models`` submodules, and an
eager import of the transformer here would import them back."""
import importlib

_EXPORTS = ("init_params", "forward", "loss_fn", "init_cache", "prefill", "decode_step")

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        value = getattr(importlib.import_module("repro_torch.models.transformer"), name)
        globals()[name] = value               # cache: resolve once
        return value
    raise AttributeError(f"module 'repro_torch.models' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
