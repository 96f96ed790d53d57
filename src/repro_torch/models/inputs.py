"""Synthetic batches, ported from ``repro.models.inputs``.

:func:`make_batch` draws the reference's numpy stream in the reference's
order, so its tokens, prefix embeddings, labels and mask are bit-equal to
``repro.models.inputs.make_batch``'s for the same config, sizes and seed.
The shape specs (``input_specs`` and its siblings) belong to the dry-run and
are not ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _token_len(cfg, seq_len: int) -> int:
    return seq_len - cfg.n_prefix


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
