"""Model assembly for every family, ported from ``repro.models.transformer``.

The reference stacks the layers on a leading ``n_full`` axis of periods of
the config's block pattern (dense, MoE, vlm and audio: ``("attn",)``;
mamba2: ``("ssm",)``; recurrentgemma: ``("rglru", "rglru", "attn")``),
scans over them, and
unrolls a remainder ``"rem"``.  PyTorch runs eagerly, so the port walks the layers in a Python
loop and keeps them **split**: ``params["layers"]`` is a list of per-layer
dicts in layer order (``cfg.layer_kinds()`` names each one's kind), and
caches and page pools are ``{"layers": [...]}`` trees of the same shape.
:mod:`repro_torch.bridge` converts to and from the stacked layout.  Caches
are updated in place.

An MoE arch (``cfg.is_moe``) routes every attention block's FFN through
:func:`repro_torch.models.moe.moe_forward`: capacity routing, which drops
assignments past an expert's capacity, over a whole sequence (forward,
prefill), and dropless routing at decode (capacity ``B·S``), as the
reference does.  A frontend arch (``cfg.n_prefix``: vlm, audio) takes
``batch["prefix_embeds"]`` (B, n_prefix, d) before its tokens.

For serving, ``kernel`` picks plain PyTorch or the hand-written kernels
(RMSNorm, flash prefill attention, RG-LRU scan, SSD scan); ``None``
follows the device of the tokens (:func:`repro_torch.device.resolve_kernel`).
Training (:func:`forward`, :func:`loss_fn`) runs the plain functions on
every device, under autograd: the reference's ``forward`` reaches no
Pallas kernel, and the kernels have no backward (their wrappers refuse a
launch that autograd would record).

Public API:
    init_params(cfg, generator, device)          -> params
    forward(cfg, params, batch)                  -> (hidden (B,S,d), aux)
    loss_fn(cfg, params, batch)                  -> (loss, metrics)
    init_cache(cfg, batch, max_len, device)      -> cache
    prefill(cfg, params, batch, cache)           -> (logits_last (B,V), cache)
    decode_step(cfg, params, tok, pos, cache)    -> (logits (B,V), cache)
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_kernel
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S

Params = Dict[str, Any]

BLOCK_KINDS = ("attn", "rglru", "ssm")


def check_supported(cfg) -> None:
    """Admit the families the reference registers: dense, MoE, vlm and
    audio (``("attn",)``), SSM (``("ssm",)``) and hybrid (attention and
    RG-LRU blocks); refuse other combinations."""
    ok = set(cfg.pattern) <= set(BLOCK_KINDS)
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        ok = ok and cfg.pattern == ("attn",)
    elif cfg.family == "ssm":
        ok = ok and cfg.pattern == ("ssm",)
    elif cfg.family == "hybrid":
        ok = ok and "ssm" not in cfg.pattern
    else:
        ok = False
    if not ok:
        raise NotImplementedError(
            f"arch {cfg.name!r} (family {cfg.family!r}, pattern {cfg.pattern}) is not "
            "a combination the reference builds")


def stack_layout(cfg) -> Tuple[int, Tuple[str, ...]]:
    """(n_full periods, remainder block kinds), as the reference stacks them."""
    plen = len(cfg.pattern)
    return cfg.n_layers // plen, cfg.pattern[:cfg.n_layers % plen]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_block(cfg, kind: str, gen, dtype, device) -> Params:
    """An SSM block has ``ln1`` only; the others a norm and an MLP (the
    MoE FFN in an MoE arch's attention blocks) after their mixer."""
    d = cfg.d_model
    p = {"ln1": L.init_norm(cfg, d, dtype, device)}
    if kind == "ssm":
        p["ssm"] = S.init_ssm(cfg, gen, dtype, device)
        return p
    if kind == "attn":
        p["attn"] = L.init_attention(cfg, gen, dtype, device)
    else:
        p["rglru"] = R.init_rglru(cfg, gen, dtype, device)
    p["ln2"] = L.init_norm(cfg, d, dtype, device)
    moe = cfg.is_moe and kind == "attn"
    p["ffn"] = M.init_moe(cfg, gen, dtype, device) if moe else L.init_mlp(cfg, gen, dtype, device)
    return p


def init_params(cfg, generator: torch.Generator, device) -> Params:
    """Random weights with the reference's initializers and layout (split
    per layer), drawn from ``generator`` on ``device``.  Different draws
    from JAX's: use :func:`repro_torch.bridge.params_from_numpy` to load the
    reference's weights."""
    check_supported(cfg)
    dtype = L.dtype_of(cfg.param_dtype)
    d = cfg.d_model
    params: Params = {
        "embed": L.embed_init(generator, cfg.padded_vocab, d, dtype, device),
        "final_norm": L.init_norm(cfg, d, dtype, device),
        "layers": [_init_block(cfg, kind, generator, dtype, device)
                   for kind in cfg.layer_kinds()],
    }
    if not cfg.tie_embeddings:
        params["head"] = L.dense_init(generator, d, cfg.padded_vocab, dtype, device)
    return params


def _embed_inputs(cfg, params, tokens: torch.Tensor,
                  prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Embedding rows cast to the compute dtype, after the frontend's prefix
    embeddings (B, n_prefix, d) where the config has a prefix and one is
    given, then times sqrt(d)."""
    dtype = L.dtype_of(cfg.compute_dtype)
    x = params["embed"][tokens.long()].to(dtype)
    if cfg.n_prefix and prefix is not None:
        x = torch.cat([prefix.to(dtype), x], dim=1)
    return L.scale_by(x, math.sqrt(cfg.d_model))


def _ffn(cfg, kind: str, p: Params, h, decode: bool = False):
    """The FFN after a block's mixer -> (y, aux or None): the MLP, or in an
    MoE arch's attention blocks the MoE layer, capacity-routed over a
    sequence and dropless at decode."""
    if kind == "attn" and cfg.is_moe:
        return M.moe_forward(cfg, p, h, cap_override=h.shape[0] * h.shape[1] if decode else 0)
    return L.mlp_forward(cfg, p, h), None


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
# forward (train / scoring)
# --------------------------------------------------------------------------

def _block_forward(cfg, kind: str, p: Params, x):
    """One block over the full sequence, at positions 0..S-1, on the plain
    path.  Returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.apply_norm(cfg, p["ln1"], x)
    if kind == "ssm":
        y, _ = S.ssm_forward(cfg, p["ssm"], h)
        return x + y, aux
    if kind == "attn":
        x = x + L.attention_forward(cfg, p["attn"], h)
    else:
        y, _ = R.rglru_forward(cfg, p["rglru"], h)
        x = x + y
    h = L.apply_norm(cfg, p["ln2"], x)
    y, a = _ffn(cfg, kind, p["ffn"], h)
    return x + y, aux if a is None else a


def _period_forward(cfg, blocks, x):
    """One period of the pattern: the unit the reference rematerialises."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, p in zip(cfg.pattern, blocks):
        x, a = _block_forward(cfg, kind, p, x)
        aux = aux + a
    return x, aux


def forward(cfg, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (final hidden states (B,S,d), aux loss).  ``batch["tokens"]``:
    (B,S).  With ``cfg.remat`` each full period runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): its
    activations are recomputed in the backward pass, with the same numbers,
    since no layer draws random numbers.  The remainder blocks run without
    it, as in the reference."""
    x = _embed_inputs(cfg, params, batch["tokens"], batch.get("prefix_embeds"))
    n_full, rem_kinds = stack_layout(cfg)
    plen = len(cfg.pattern)
    layers = params["layers"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_full):
        blocks = layers[i * plen:(i + 1) * plen]
        if cfg.remat and torch.is_grad_enabled():
            x, a = checkpoint(_period_forward, cfg, blocks, x, use_reentrant=False)
        else:
            x, a = _period_forward(cfg, blocks, x)
        aux = aux + a
    for kind, p in zip(rem_kinds, layers[n_full * plen:]):
        x, a = _block_forward(cfg, kind, p, x)
        aux = aux + a
    return L.apply_norm(cfg, params["final_norm"], x), aux


def loss_fn(cfg, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens (B,S'), labels (B,S), mask (B,S) [, prefix_embeds
    (B, S - S', d)].  Returns (loss, {"nll", "aux"}): the mean NLL over the
    mask plus the aux loss (MoE's load-balance loss summed over the
    layers; 0 for the other families).  A softcapped arch (recurrentgemma)
    materialises its logits; the others take the chunked cross-entropy."""
    hidden, aux = forward(cfg, params, batch)
    labels = batch["labels"].long()
    mask = batch["mask"].float()
    if cfg.logits_softcap:
        logits = logits_fn(cfg, params, hidden).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, labels[..., None])[..., 0]
        nll = torch.sum((lse - tgt) * mask) / torch.clamp(torch.sum(mask), min=1.0)
    else:
        nll = L.chunked_cross_entropy(hidden, _unembed_matrix(cfg, params), labels, mask)
    return nll + aux, {"nll": nll, "aux": aux}


# --------------------------------------------------------------------------
# cache / prefill / decode
# --------------------------------------------------------------------------

def init_recurrent_state(cfg, kind: str, batch: int, dtype, device) -> Params:
    """The per-row recurrent state of an RG-LRU or SSM layer (conv window, h)."""
    if kind == "ssm":
        return S.init_ssm_state(cfg, batch, dtype, device)
    return R.init_rglru_state(cfg, batch, dtype, device)


def init_cache(cfg, batch: int, max_len: int, device) -> Params:
    """Per layer: a ring/linear KV cache for attention, the recurrent state
    (conv window, h) for RG-LRU and SSM layers."""
    check_supported(cfg)
    dtype = L.dtype_of(cfg.compute_dtype)
    return {"layers": [
        L.init_kv_cache(cfg, batch, max_len, dtype, device) if kind == "attn"
        else init_recurrent_state(cfg, kind, batch, dtype, device)
        for kind in cfg.layer_kinds()]}


def _block_prefill(cfg, kind, p, x, bc, kernel):
    """One block over the whole prompt, at positions 0..S-1."""
    h = L.apply_norm(cfg, p["ln1"], x, kernel)
    if kind == "ssm":
        y, state = S.ssm_forward(cfg, p["ssm"], h, bc, kernel)
        bc.update(state)
        return x + y, bc
    if kind == "attn":
        y, bc = L.attention_prefill(cfg, p["attn"], h, None, bc, kernel)
    else:
        y, state = R.rglru_forward(cfg, p["rglru"], h, bc, kernel)
        bc.update(state)
    x = x + y
    h = L.apply_norm(cfg, p["ln2"], x, kernel)
    y, _ = _ffn(cfg, kind, p["ffn"], h)
    return x + y, bc


def _block_decode(cfg, kind, p, x, pos, bc, attn_fn, kernel):
    """One block's single-token step.  ``attn_fn(p_attn, h, bc) -> (y, bc)``
    overrides the dense-cache attention (the paged serving engine passes a
    page-table closure); RG-LRU and SSM state is updated in place in ``bc``."""
    h = L.apply_norm(cfg, p["ln1"], x, kernel)
    if kind == "ssm":
        y, state = S.ssm_decode(cfg, p["ssm"], h, bc)
        bc.update(state)
        return x + y, bc
    if kind == "rglru":
        y, state = R.rglru_decode(cfg, p["rglru"], h, bc)
        bc.update(state)
    elif attn_fn is None:
        y, bc = L.attention_decode(cfg, p["attn"], h, pos, bc)
    else:
        y, bc = attn_fn(p["attn"], h, bc)
    x = x + y
    h = L.apply_norm(cfg, p["ln2"], x, kernel)
    y, _ = _ffn(cfg, kind, p["ffn"], h, decode=True)
    return x + y, bc


def prefill(cfg, params, batch, cache, *, kernel: Optional[str] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Full-sequence prefill of ``batch["tokens"]`` (B,S), after
    ``batch["prefix_embeds"]`` where the config has a prefix.  Fills
    ``cache`` in place; returns (last-token logits (B,V), cache)."""
    tokens = batch["tokens"]
    kernel = resolve_kernel(kernel, tokens.device)
    x = _embed_inputs(cfg, params, tokens, batch.get("prefix_embeds"))
    for kind, p, bc in zip(cfg.layer_kinds(), params["layers"], cache["layers"]):
        x, _ = _block_prefill(cfg, kind, p, x, bc, kernel)
    x = L.apply_norm(cfg, params["final_norm"], x, kernel)
    return logits_fn(cfg, params, x[:, -1:])[:, 0], cache


def decode_step(cfg, params, token, pos, cache, *, attn_fn=None,
                kernel: Optional[str] = None) -> Tuple[torch.Tensor, Params]:
    """One decode step.  token: (B,) int; pos: int position (or (B,)
    per-request positions when ``attn_fn`` handles them).  ``cache`` is the
    dense cache of :func:`init_cache` or any ``{"layers": [...]}`` tree
    whose attention entries ``attn_fn`` consumes (see
    ``repro_torch.serve.engine``)."""
    kernel = resolve_kernel(kernel, token.device)
    x = _embed_inputs(cfg, params, token[:, None])
    for kind, p, bc in zip(cfg.layer_kinds(), params["layers"], cache["layers"]):
        x, _ = _block_decode(cfg, kind, p, x, pos, bc, attn_fn, kernel)
    x = L.apply_norm(cfg, params["final_norm"], x, kernel)
    return logits_fn(cfg, params, x)[:, 0], cache
