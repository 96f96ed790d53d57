"""Dense transformer assembly, ported from ``repro.models.transformer``.

The reference stacks the layers on a leading ``n_full`` axis and scans
over them.  PyTorch runs eagerly, so the port walks the layers in a Python
loop and keeps them **split**: ``params["layers"]`` is a list of per-layer
dicts, and caches and page pools are ``{"layers": [...]}`` trees of the
same shape.  :mod:`repro_torch.bridge` converts to and from the stacked
layout.  Only the dense family is ported (pattern ``("attn",)``).

Public API:
    init_params(cfg, generator, device)          -> params
    init_cache(cfg, batch, max_len, device)      -> cache
    prefill(cfg, params, batch, cache)           -> (logits_last (B,V), cache)
    decode_step(cfg, params, tok, pos, cache)    -> (logits (B,V), cache)
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import layers as L

Params = Dict[str, Any]


def check_dense(cfg) -> None:
    if cfg.pattern != ("attn",) or cfg.is_moe or cfg.n_prefix:
        raise NotImplementedError(
            f"arch {cfg.name!r} is not a dense transformer; only the dense "
            "family is ported (ROADMAP.md, queue 1: other families)")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_params(cfg, generator: torch.Generator, device) -> Params:
    """Random weights with the reference's initializers and layout (split
    per layer), drawn from ``generator`` on ``device``.  Different draws
    from JAX's: use :func:`repro_torch.bridge.params_from_numpy` to load the
    reference's weights."""
    check_dense(cfg)
    dtype = L.dtype_of(cfg.param_dtype)
    d = cfg.d_model
    params: Params = {
        "embed": L.embed_init(generator, cfg.padded_vocab, d, dtype, device),
        "final_norm": L.init_norm(cfg, d, dtype, device),
        "layers": [
            {
                "ln1": L.init_norm(cfg, d, dtype, device),
                "attn": L.init_attention(cfg, generator, dtype, device),
                "ln2": L.init_norm(cfg, d, dtype, device),
                "ffn": L.init_mlp(cfg, generator, dtype, device),
            }
            for _ in range(cfg.n_layers)
        ],
    }
    if not cfg.tie_embeddings:
        params["head"] = L.dense_init(generator, d, cfg.padded_vocab, dtype, device)
    return params


def _embed_inputs(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows cast to the compute dtype, then times sqrt(d)."""
    x = params["embed"][tokens.long()].to(L.dtype_of(cfg.compute_dtype))
    return L.scale_by(x, math.sqrt(cfg.d_model))


def _unembed_matrix(cfg, params) -> torch.Tensor:
    dtype = L.dtype_of(cfg.compute_dtype)
    if cfg.tie_embeddings:
        return params["embed"].T.to(dtype)
    return params["head"].to(dtype)


def logits_fn(cfg, params, hidden) -> torch.Tensor:
    logits = L.matmul(hidden, _unembed_matrix(cfg, params))
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# --------------------------------------------------------------------------
# cache / prefill / decode
# --------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device) -> Params:
    check_dense(cfg)
    dtype = L.dtype_of(cfg.compute_dtype)
    return {"layers": [L.init_kv_cache(cfg, batch, max_len, dtype, device)
                       for _ in range(cfg.n_layers)]}


def _block_prefill(cfg, p, x, positions, bc):
    h = L.apply_norm(cfg, p["ln1"], x)
    y, bc = L.attention_prefill(cfg, p["attn"], h, positions, bc)
    x = x + y
    h = L.apply_norm(cfg, p["ln2"], x)
    return x + L.mlp_forward(cfg, p["ffn"], h), bc


def _block_decode(cfg, p, x, pos, bc, attn_fn=None):
    """One block's single-token step.  ``attn_fn(p_attn, h, bc) -> (y, bc)``
    overrides the dense-cache attention (the paged serving engine passes a
    page-table closure); everything else is shared."""
    h = L.apply_norm(cfg, p["ln1"], x)
    if attn_fn is None:
        y, bc = L.attention_decode(cfg, p["attn"], h, pos, bc)
    else:
        y, bc = attn_fn(p["attn"], h, bc)
    x = x + y
    h = L.apply_norm(cfg, p["ln2"], x)
    return x + L.mlp_forward(cfg, p["ffn"], h), bc


def prefill(cfg, params, batch, cache) -> Tuple[torch.Tensor, Params]:
    """Full-sequence prefill of ``batch["tokens"]`` (B,S).  Fills ``cache``
    in place; returns (last-token logits (B,V), cache)."""
    x = _embed_inputs(cfg, params, batch["tokens"])
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for p, bc in zip(params["layers"], cache["layers"]):
        x, _ = _block_prefill(cfg, p, x, positions, bc)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return logits_fn(cfg, params, x[:, -1:])[:, 0], cache


def decode_step(cfg, params, token, pos, cache, *, attn_fn=None) -> Tuple[torch.Tensor, Params]:
    """One decode step.  token: (B,) int; pos: int position (or (B,)
    per-request positions when ``attn_fn`` handles them).  ``cache`` is the
    dense cache of :func:`init_cache` or any ``{"layers": [...]}`` tree
    whose entries ``attn_fn`` consumes (see ``repro_torch.serve.engine``)."""
    x = _embed_inputs(cfg, params, token[:, None])
    for p, bc in zip(params["layers"], cache["layers"]):
        x, _ = _block_decode(cfg, p, x, pos, bc, attn_fn)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return logits_fn(cfg, params, x)[:, 0], cache
