"""Input specs and synthetic batches, ported from ``repro.models.inputs``.

``input_specs`` and its siblings return ``meta`` tensors with the
reference's ``jax.ShapeDtypeStruct`` shapes and dtypes (no allocation):
the dry run (:mod:`repro_torch.launch.dryrun`) counts its steps on them.
Modality frontends are stubs, as in the reference: precomputed bf16
prefix embeddings.

:func:`make_batch` draws the reference's numpy stream in the reference's
order, so its tokens, prefix embeddings, labels and mask are bit-equal to
``repro.models.inputs.make_batch``'s for the same config, sizes and seed.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _token_len(cfg, seq_len: int) -> int:
    return seq_len - cfg.n_prefix


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg, shape, batch_override: int = 0) -> Dict[str, torch.Tensor]:
    b = batch_override or shape.global_batch
    s = shape.seq_len
    specs = {
        "tokens": _spec((b, _token_len(cfg, s)), torch.int32),
        "labels": _spec((b, s), torch.int32),
        "mask": _spec((b, s), torch.float32),
    }
    if cfg.n_prefix:
        specs["prefix_embeds"] = _spec((b, cfg.n_prefix, cfg.d_model), torch.bfloat16)
    return specs


def prefill_batch_specs(cfg, shape, batch_override: int = 0) -> Dict[str, torch.Tensor]:
    b = batch_override or shape.global_batch
    specs = {"tokens": _spec((b, _token_len(cfg, shape.seq_len)), torch.int32)}
    if cfg.n_prefix:
        specs["prefix_embeds"] = _spec((b, cfg.n_prefix, cfg.d_model), torch.bfloat16)
    return specs


def decode_inputs_specs(cfg, shape, batch_override: int = 0):
    """(token (B,) int32, pos () int32)."""
    b = batch_override or shape.global_batch
    return _spec((b,), torch.int32), _spec((), torch.int32)


def input_specs(cfg, shape, batch_override: int = 0) -> Dict[str, torch.Tensor]:
    """Spec tree for the step function of this cell's kind."""
    if shape.kind == "train":
        return train_batch_specs(cfg, shape, batch_override)
    if shape.kind == "prefill":
        return prefill_batch_specs(cfg, shape, batch_override)
    token, pos = decode_inputs_specs(cfg, shape, batch_override)
    return {"token": token, "pos": pos}


def make_batch(cfg, batch: int, seq_len: int, seed: int = 0, kind: str = "train",
               device="cpu") -> Dict[str, Any]:
    """Materialized synthetic batch on ``device``: tokens (B, S - n_prefix)
    int32 and, for ``kind="train"``, labels (B,S) int32 and mask (B,S) fp32
    (0 over the prefix); prefix embeddings (B, n_prefix, d) fp32 where the
    config has a prefix."""
    rng = np.random.default_rng(seed)
    tl = _token_len(cfg, seq_len)
    out: Dict[str, Any] = {"tokens": rng.integers(0, cfg.vocab, (batch, tl)).astype(np.int32)}
    if cfg.n_prefix:
        out["prefix_embeds"] = rng.normal(
            0, 0.02, (batch, cfg.n_prefix, cfg.d_model)).astype(np.float32)
    if kind == "train":
        out["labels"] = rng.integers(0, cfg.vocab, (batch, seq_len)).astype(np.int32)
        mask = np.ones((batch, seq_len), np.float32)
        mask[:, : cfg.n_prefix] = 0.0
        out["mask"] = mask
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}
