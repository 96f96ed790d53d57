"""Shared layers of the dense transformer, ported from ``repro.models.layers``.

Plain functions over explicit parameter dicts of tensors, in the JAX
package's layouts (``x @ w`` with ``w`` stored ``(d_in, d_out)``), so the
parity tests compare like with like: the RMSNorm, LayerNorm and
nonparametric norms, RoPE, GQA attention (naive, chunked and banded,
chosen as ``attention_forward`` chooses), the linear/ring KV cache with
its int8 variant, the SwiGLU and GELU MLPs and the chunked cross-entropy
of the training loss.

``kernel`` picks plain PyTorch (``"plain"``) or the hand-written kernels
(``"cuda"``) for the RMSNorm and the prefill attention; the kernel
wrappers take their plain versions for CPU tensors.

**Dtypes follow JAX's promotion on purpose.**  JAX turns ``bf16 @ fp32``
into an fp32 product and ``bf16 + fp32`` into fp32; ``torch.matmul``
refuses mixed operands.  :func:`matmul` casts both operands to the promoted
type, so with fp32 parameters and bf16 compute (full llama3.2-1b) the
residual stream turns fp32 in block 0, exactly as in the reference.  A
Python scalar multiplies as JAX's weakly typed scalar does: rounded to the
tensor's dtype first (:func:`scale_by`).  Caches are updated in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rmsnorm as RN
from repro_torch.models.hooks import constrain

Params = Dict[str, Any]

NEG_INF = -1e30


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the dtype JAX would promote the pair to."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def scale_by(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x * c`` with ``c`` rounded to ``x``'s dtype, as JAX's weak type does."""
    return x * torch.tensor(c, dtype=x.dtype, device=x.device)


def concat(xs) -> torch.Tensor:
    """``jnp.concatenate`` along axis 1: promote, then join."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return torch.cat([x.to(dt) for x in xs], dim=1)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere (``F.softplus``
    turns linear above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=device) * scale
    return w.to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, device) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, device=device) * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def init_norm(cfg, d: int, dtype, device) -> Params:
    """RMSNorm: a scale; LayerNorm: a scale and a bias; the nonparametric
    norm (olmo): no parameter at all, ``{}``."""
    if cfg.norm == "nonparametric":
        return {}
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LayerNorm over the last axis, mean and variance in fp32, eps 1e-5;
    without ``scale`` and ``bias`` the nonparametric norm."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + 1e-5)
    if scale is not None:
        y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def apply_norm(cfg, p: Params, x: torch.Tensor, kernel: str = "plain") -> torch.Tensor:
    """The config's norm in ``x``'s dtype.  ``kernel="cuda"`` reaches the
    RMSNorm kernel, and only for ``cfg.norm == "rmsnorm"``: the reference
    computes LayerNorm and the nonparametric norm in XLA, with no Pallas
    kernel, so they are plain PyTorch on every device and no kernel is
    missing for them."""
    if cfg.norm in ("layernorm", "nonparametric"):
        return layer_norm(x, p.get("scale"), p.get("bias"))
    if kernel == "cuda":
        return RN.rmsnorm(x.contiguous(), p["scale"])
    return RN.rmsnorm_plain(x, p["scale"])


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (S,) absolute positions."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)     # (D/2,)
    angles = positions[:, None].float() * freqs                 # (S, D/2)
    return _rotate(x, torch.cos(angles)[None, :, None, :],
                   torch.sin(angles)[None, :, None, :])


# --------------------------------------------------------------------------
# attention cores
# --------------------------------------------------------------------------

def _gqa_reshape(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,S,Hq,D) -> (B,S,Hkv,G,D).  The ``groups:n`` hook (the port's own,
    as ``heads:n`` in :func:`_heads`) first replicates a split of the heads
    that would cut a GQA group."""
    b, s, hq, d = q.shape
    return constrain(q, f"groups:{n_kv}").reshape(b, s, n_kv, hq // n_kv, d)


def naive_causal_attention(q, k, v, q_pos, k_pos, window: int = 0):
    """Materialized-scores attention.  q: (B,Sq,Hkv,G,D); k/v: (B,T,Hkv,D)."""
    d = q.shape[-1]
    s = torch.einsum("bqkgd,btkd->bqkgt", q.float(), k.float())
    s = s * (1.0 / math.sqrt(d))
    mask = k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= k_pos[None, :] > (q_pos[:, None] - window)
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    dt = v.dtype
    return torch.einsum("bqkgt,btkd->bqkgd", p.to(dt), v)


def chunked_causal_attention(q, k, v, q_pos, k_pos, kv_chunk: int = 1024):
    """Online-softmax attention over KV chunks (the reference's unrolled
    form; PyTorch runs eagerly, so there is no scan variant).

    q: (B,Sq,Hkv,G,D); k/v: (B,T,Hkv,D); q_pos: (Sq,), k_pos: (T,).
    """
    b, sq, hkv, g, d = q.shape
    t = k.shape[1]
    kv_chunk = min(kv_chunk, t)
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    m = torch.full((b, sq, hkv, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, sq, hkv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, hkv, g, d), dtype=torch.float32, device=q.device)
    for lo in range(0, t, kv_chunk):
        kc, vc, kposc = k[:, lo:lo + kv_chunk], v[:, lo:lo + kv_chunk], k_pos[lo:lo + kv_chunk]
        s = torch.einsum("bqkgd,btkd->bqkgt", qf, kc.float()) * scale
        mask = kposc[None, :] <= q_pos[:, None]                 # (Sq, Tc)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqkgt,btkd->bqkgd", p.to(vc.dtype).float(), vc.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.to(v.dtype)


def banded_attention(q, k, v, positions, window: int):
    """Sub-quadratic sliding-window attention: each query chunk of
    ``window`` attends to (previous chunk ++ own chunk).
    q: (B,S,Hkv,G,D); k/v: (B,S,Hkv,D); positions: (S,)."""
    b, s, hkv, g, d = q.shape
    w = min(window, s)
    pad = (-s) % w
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        extra = positions[-1] + 1 + torch.arange(pad, dtype=positions.dtype,
                                                 device=positions.device)
        positions = torch.cat([positions, extra])
    sp = s + pad
    nc = sp // w
    qc = q.reshape(b, nc, w, hkv, g, d)
    kc = k.reshape(b, nc, w, hkv, d)
    vc = v.reshape(b, nc, w, hkv, d)
    pc = positions.reshape(nc, w)
    # previous chunk (chunk -1 is all-masked via the position trick)
    k_prev = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    v_prev = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    p_prev = torch.cat([torch.full_like(pc[:1], -(10 ** 9)), pc[:-1]], dim=0)
    k2 = torch.cat([k_prev, kc], dim=2)                      # (B,nc,2W,Hkv,D)
    v2 = torch.cat([v_prev, vc], dim=2)
    p2 = torch.cat([p_prev, pc], dim=1)                      # (nc, 2W)
    sco = torch.einsum("bcqkgd,bctkd->bcqkgt", qc.float(), k2.float())
    sco = sco * (1.0 / math.sqrt(d))
    mask = (p2[:, None, :] <= pc[:, :, None]) & (p2[:, None, :] > pc[:, :, None] - window)
    sco = torch.where(mask[None, :, :, None, None, :], sco, NEG_INF)
    prob = torch.softmax(sco, dim=-1)
    out = torch.einsum("bcqkgt,bctkd->bcqkgd", prob.to(v2.dtype).float(),
                       v2.float()).to(v2.dtype)
    return out.reshape(b, sp, hkv, g, d)[:, :s]


# --------------------------------------------------------------------------
# attention block (projections + dispatch + cache handling)
# --------------------------------------------------------------------------

def init_attention(cfg, gen, dtype, device) -> Params:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, d, hq * hd, dtype, device),
        "wk": dense_init(gen, d, hkv * hd, dtype, device),
        "wv": dense_init(gen, d, hkv * hd, dtype, device),
        "wo": dense_init(gen, hq * hd, d, dtype, device, scale=1.0 / math.sqrt(hq * hd)),
    }


def _heads(t: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(B,S,n*d) -> (B,S,n,d).  The ``heads:n`` hook (identity unless one is
    installed) sees the projection first: this site is the port's own, since
    a DTensor split of the n*d columns that cuts a head cannot be viewed as
    heads, where the reference's partitioner moves the data itself."""
    b, s, _ = t.shape
    return constrain(t, f"heads:{n}").reshape(b, s, n, d)


def _project_qkv(cfg, p, x):
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _heads(matmul(x, p["wq"]), hq, hd)
    k = _heads(matmul(x, p["wk"]), hkv, hd)
    v = _heads(matmul(x, p["wv"]), hkv, hd)
    return q, k, v


def _window(cfg) -> int:
    return cfg.window if cfg.attention in ("swa", "local") and cfg.window else 0


def _index(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[1], dtype=torch.int32, device=x.device)


def attention_forward(cfg, p, x, positions=None, *, impl: str = "auto",
                      kernel: str = "plain"):
    """Training / prefill attention over a full sequence.  x: (B,S,d);
    positions: (S,), or None for 0..S-1.  ``kernel="cuda"`` runs the flash
    kernel whatever ``impl`` says.  That kernel masks by index, so its
    wrapper checks given positions against ``arange(S)`` (a host sync) and
    refuses others; None needs no check."""
    b, s, _ = x.shape
    given, positions = positions, _index(x) if positions is None else positions
    q, k, v = _project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window = _window(cfg)
    if kernel == "cuda":
        out = FA.flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), positions=given, window=window)
        out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
        return matmul(out, p["wo"])
    qg = _gqa_reshape(q, cfg.n_kv_heads)
    if impl == "auto":
        if window and s > cfg.window:
            impl = "banded"
        elif s > 512:
            impl = "chunked"
        else:
            impl = "naive"
    if impl == "banded" and window:
        out = banded_attention(qg, k, v, positions, cfg.window)
    elif impl == "chunked":
        if window and s > cfg.window:
            raise ValueError("use banded impl for windowed attention on long seqs")
        kv_chunk = min(1024, max(512, s // 32)) if cfg.scan_layers else max(1024, s // 8)
        out = chunked_causal_attention(qg, k, v, positions, positions, kv_chunk=kv_chunk)
    else:
        out = naive_causal_attention(qg, k, v, positions, positions, window=window)
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return matmul(out, p["wo"])


def init_kv_cache(cfg, batch: int, max_len: int, dtype, device) -> Params:
    """Ring cache for windowed attention; linear cache otherwise.  With
    ``cfg.kv_quant`` the cache is int8 with a per-(token, head) scale."""
    window = _window(cfg)
    t = min(window, max_len) if window else max_len
    kv_dtype = torch.int8 if cfg.kv_quant else dtype
    shape = (batch, t, cfg.n_kv_heads, cfg.head_dim)
    cache = {
        "k": torch.zeros(shape, dtype=kv_dtype, device=device),
        "v": torch.zeros(shape, dtype=kv_dtype, device=device),
        "slot_pos": torch.full((t,), -1, dtype=torch.int32, device=device),
    }
    if cfg.kv_quant:
        cache["k_scale"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
        cache["v_scale"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
    return cache


def _kv_quantize(x: torch.Tensor):
    """x: (..., D) -> (int8 values, per-(...,) scale multiplier).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.round(xf / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def _kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def attention_prefill(cfg, p, x, positions, cache, kernel: str = "plain"):
    """Run full-sequence attention and fill ``cache`` in place; positions as
    in :func:`attention_forward`.  Returns (out, cache).  With the default
    positions 0..S-1 the kept rows land in one run of ring slots, or two
    where they wrap, written by slices (no index tensor: a sharded DTensor
    cache takes slice writes on every torch version the port runs on)."""
    out = attention_forward(cfg, p, x, positions, kernel=kernel)
    default = positions is None
    positions = _index(x) if positions is None else positions
    _, k, v = _project_qkv(cfg, p, x)
    k = apply_rope(k, positions, cfg.rope_theta)
    rows = {"k": k, "v": v}
    if cfg.kv_quant:
        rows["k"], rows["k_scale"] = _kv_quantize(k)
        rows["v"], rows["v_scale"] = _kv_quantize(v)
    t = cache["k"].shape[1]
    if x.shape[1] >= t:
        # keep the last t entries (ring fully covered)
        positions = positions[-t:]
        rows = {name: r[:, -t:] for name, r in rows.items()}
        for name in rows:
            cache[name].zero_()
        cache["slot_pos"].fill_(-1)
    if not default:
        slots = (positions % t).long()
        for name, r in rows.items():
            cache[name][:, slots] = r.to(cache[name].dtype)
        cache["slot_pos"][slots] = positions.to(torch.int32)
        return out, cache
    n = positions.shape[0]
    first = (x.shape[1] - n) % t                 # the slot of the first kept position
    runs = [(first, 0, min(n, t - first))]
    if n > t - first:
        runs.append((0, t - first, n))
    for dst, lo, hi in runs:
        for name, r in rows.items():
            cache[name][:, dst:dst + hi - lo] = r[:, lo:hi].to(cache[name].dtype)
        cache["slot_pos"][dst:dst + hi - lo] = positions[lo:hi].to(torch.int32)
    return out, cache


def attention_decode(cfg, p, x, pos, cache):
    """Single-token decode over the dense cache, updated in place.
    x: (B,1,d); pos: int (or 0-dim tensor) position.  Returns (out, cache)."""
    b = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x)                          # (B,1,H,D)
    pos = int(pos)
    pos_arr = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos_arr, cfg.rope_theta)
    k = apply_rope(k, pos_arr, cfg.rope_theta)
    t = cache["k"].shape[1]
    slot = pos % t
    if cfg.kv_quant:
        k, k_sc = _kv_quantize(k)
        v, v_sc = _kv_quantize(v)
        cache["k_scale"][:, slot] = k_sc[:, 0]
        cache["v_scale"][:, slot] = v_sc[:, 0]
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cache["slot_pos"][slot] = pos
    ck, cv, cp = cache["k"], cache["v"], cache["slot_pos"]
    if cfg.kv_quant:
        ck = _kv_dequantize(ck, cache["k_scale"], x.dtype)
        cv = _kv_dequantize(cv, cache["v_scale"], x.dtype)
    qg = _gqa_reshape(q, cfg.n_kv_heads)                       # (B,1,Hkv,G,D)
    s = torch.einsum("bqkgd,btkd->bqkgt", qg.float(), ck.float())
    s = s * (1.0 / math.sqrt(cfg.head_dim))
    valid = (cp >= 0) & (cp <= pos)
    window = _window(cfg)
    if window:
        valid &= cp > pos - window
    s = torch.where(valid[None, None, None, None, :], s, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgt,btkd->bqkgd", prob.to(cv.dtype).float(),
                       cv.float()).to(x.dtype)
    out = matmul(out.reshape(b, 1, cfg.n_heads * cfg.head_dim), p["wo"])
    return out, cache


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def init_mlp(cfg, gen, dtype, device) -> Params:
    """SwiGLU's three matrices; the ``audio`` family (musicgen) has the
    classic two-matrix GELU MLP."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.family == "audio":
        return {"w1": dense_init(gen, d, f, dtype, device),
                "w2": dense_init(gen, f, d, dtype, device)}
    return {
        "w1": dense_init(gen, d, f, dtype, device),
        "w3": dense_init(gen, d, f, dtype, device),
        "w2": dense_init(gen, f, d, dtype, device),
    }


def mlp_forward(cfg, p, x):
    """SwiGLU, ``(silu(x @ w1) * (x @ w3)) @ w2``, or, without ``w3``,
    ``gelu(x @ w1) @ w2`` with ``jax.nn.gelu``'s default tanh approximation
    (the exact erf form differs by about 1e-3)."""
    if "w3" not in p:
        return matmul(F.gelu(matmul(x, p["w1"]), approximate="tanh"), p["w2"])
    return matmul(F.silu(matmul(x, p["w1"])) * matmul(x, p["w3"]), p["w2"])


# --------------------------------------------------------------------------
# chunked cross-entropy (never materializes full (B,S,V) logits)
# --------------------------------------------------------------------------

def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logsumexp(logits) - logits[label]`` over the last axis.  The label's
    logit is subtracted before its size-1 axis is dropped: on vocab-split
    DTensor logits the gather is a masked partial sum, which DTensor reduces
    correctly only in the shape it was made in."""
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    tgt = torch.gather(logits, -1, labels[..., None].long())
    return (lse - tgt)[..., 0]


def chunked_cross_entropy(x, embed_t, labels, mask, chunk: int = 512) -> torch.Tensor:
    """x: (B,S,d); embed_t: (d,V); labels, mask: (B,S).  Mean NLL over the
    mask, the count clamped at 1.  The sequence is cut into chunks of
    ``min(chunk, S)`` and a remainder; each chunk's logits are made in fp32
    and dropped after its loss.  The reference's ``use_scan`` split computes
    the same sum; PyTorch runs eagerly, so the port loops."""
    s = x.shape[1]
    chunk = min(chunk, s)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, s, chunk):
        sl = slice(lo, lo + chunk)
        logits = constrain(matmul(x[:, sl], embed_t), "logits").float()   # (B,C,V)
        nll = _nll(logits, labels[:, sl])
        mc = mask[:, sl]
        total = total + torch.sum(nll * mc)
        count = count + torch.sum(mc)
    return total / torch.clamp(count, min=1.0)
