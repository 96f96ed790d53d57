"""The plain reference that decides a run's ``correct``: a served request's
prompt and tokens run once through the model in fp32 PyTorch, and each
served token is compared with the reference's logits (:func:`compare`).

It imports torch alone: nothing of the program, no kernel, no cache and no
batching.  It follows the semantics of the served model as configured
(``configs/<name>.json``, key ``model``), including the roundings that the
configuration's ``compute_dtype`` of bfloat16 puts into an fp32 model (a
``compute_dtype`` of float32 rounds nothing):

* embedding rows, and their product with sqrt(d), are rounded to bf16, so
  the first block's first norm sees, and returns, bf16 values; every later
  activation is fp32 (bf16 times fp32 promotes to fp32);
* K and V rows are kept in bf16: a prompt's own attention reads them in
  fp32, as they were computed, and every later position reads the rounded
  rows of every position before it and of itself, with q and the
  probabilities in fp32 (as the program's paged kernel keeps them);
* the unembedding matrix is rounded to bf16 before the fp32 product;
* RMSNorm with eps 1e-6 and a scale; RoPE over the whole head, half-split,
  base ``rope_theta``; attention scaled by 1/sqrt(head_dim); SwiGLU MLPs;
* an MoE FFN routes by softmax over fp32 router logits, keeps the top k
  with their gates renormalised (floor 1e-9), and combines each token's
  experts by those gates.  Over a prompt (one request's prefill) an expert
  takes at most ``max(ceil(k * S / E * capacity_factor), k)`` assignments,
  counted token-major over the prompt (each token's k in order of their
  probability) and the later ones dropped; at decode nothing is dropped.

TF32 is off while it runs (:func:`precision`).  The control of the
comparison runs the same code with every product in bf16 (fp32
accumulation, as cuBLAS's bf16 GEMMs): the step below the configuration's
fp32 products that tensor cores would tempt a program to take.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

EPS = 1e-6


@contextlib.contextmanager
def precision(tf32: bool):
    """fp32 products in fp32 (``tf32=False``) or in TF32, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _mm(a: torch.Tensor, b: torch.Tensor, products: torch.dtype) -> torch.Tensor:
    if products == torch.float32:
        return torch.matmul(a, b)
    return torch.matmul(a.to(products), b.to(products)).float()


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + EPS) * scale.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, D) at positions 0..T-1."""
    t, _, d = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, q_lo: int, products, block: int = 512) -> torch.Tensor:
    """Causal attention of the queries at positions q_lo.. (Tq, Hq, D) over
    keys 0.. (Tk, Hkv, D), in blocks of queries; -> (Tq, Hq * D)."""
    tq, hq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    kh = k.permute(1, 0, 2)                                   # (Hkv, Tk, D)
    vh = v.permute(1, 0, 2)
    outs = []
    for lo in range(0, tq, block):
        qb = q[lo:lo + block]                                 # (b, Hq, D)
        nb = qb.shape[0]
        last = q_lo + lo + nb                                 # keys needed: 0..last-1
        qg = qb.reshape(nb, hkv, g, d).permute(1, 0, 2, 3).reshape(hkv, nb * g, d)
        s = _mm(qg, kh[:, :last].transpose(1, 2), products) / math.sqrt(d)
        s = s.reshape(hkv, nb, g, last)
        pos_q = torch.arange(q_lo + lo, last, device=q.device)
        mask = torch.arange(last, device=q.device)[None, :] <= pos_q[:, None]
        s = s.masked_fill(~mask[None, :, None, :], float("-inf"))
        p = torch.softmax(s, dim=-1).reshape(hkv, nb * g, last)
        o = _mm(p, vh[:, :last], products).reshape(hkv, nb, g, d)
        outs.append(o.permute(1, 0, 2, 3).reshape(nb, hq * d))
    return torch.cat(outs, dim=0)


def _swiglu(h, w1, w3, w2, products):
    return _mm(F.silu(_mm(h, w1, products)) * _mm(h, w3, products), w2, products)


def capacity(m: Dict, n_tokens: int) -> int:
    c = math.ceil(m["top_k"] * n_tokens / m["n_experts"] * m.get("capacity_factor", 1.25))
    return max(c, m["top_k"])


def _moe(m: Dict, p: Dict, h: torch.Tensor, cap: int, products) -> torch.Tensor:
    """h (T, d) -> (T, d); an expert keeps its first ``cap`` assignments in
    token-major order (``cap >= T * k`` drops nothing)."""
    t, _ = h.shape
    k, e = m["top_k"], m["n_experts"]
    probs = torch.softmax(_mm(h, p["router"].float(), products), dim=-1)
    vals, idx = torch.topk(probs, k, dim=-1)
    gates = vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-9)
    flat = idx.reshape(-1)
    # rank of each assignment among its expert's, in token-major order
    order = torch.sort(flat, stable=True).indices
    sorted_e = flat[order]
    first = torch.searchsorted(sorted_e, sorted_e, right=False)
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(flat.numel(), device=h.device) - first
    keep = rank < cap
    y = torch.zeros_like(h)
    tok = torch.arange(t * k, device=h.device) // k
    gate = gates.reshape(-1)
    for ex in range(e):
        sel = torch.nonzero((flat == ex) & keep)[:, 0]
        if sel.numel() == 0:
            continue
        rows = tok[sel]
        out = _swiglu(h[rows], p["w1"][ex].float(), p["w3"][ex].float(), p["w2"][ex].float(),
                      products)
        y.index_add_(0, rows, out * gate[sel][:, None])
    return y


@torch.no_grad()
def logits(m: Dict, params: Dict, prompt: Sequence[int], served: Sequence[int],
           products: torch.dtype = torch.float32) -> torch.Tensor:
    """The reference's logits (n, V) for each of the ``n`` served tokens:
    row i is what position ``len(prompt) - 1 + i`` predicts, from the
    prompt and the served tokens before it; ``products`` is the type every
    product is computed in (the control's bf16)."""
    dev = params["embed"].device
    rnd = _bf16 if m.get("compute_dtype", "bfloat16") == "bfloat16" else _same
    s, n = len(prompt), len(served)
    toks = torch.tensor(list(prompt) + list(served[:-1]), dtype=torch.long, device=dev)
    d, hq, hkv = m["d_model"], m["n_heads"], m["n_kv_heads"]
    hd = m.get("d_head") or d // hq
    theta = m.get("rope_theta", 10000.0)
    x = rnd(params["embed"][toks].float())
    x = rnd(x * rnd(torch.tensor(math.sqrt(d), device=dev)))
    for li, p in enumerate(params["layers"]):
        h = _rmsnorm(x, p["ln1"]["scale"])
        if li == 0:
            h = rnd(h)                        # the bf16 stream's norm stays bf16
        a = p["attn"]
        q = _rope(_mm(h, a["wq"].float(), products).reshape(-1, hq, hd), theta)
        kk = _rope(_mm(h, a["wk"].float(), products).reshape(-1, hkv, hd), theta)
        vv = _mm(h, a["wv"].float(), products).reshape(-1, hkv, hd)
        att = [_attend(q[:s], kk[:s], vv[:s], 0, products)]
        if n > 1:
            att.append(_attend(q[s:], rnd(kk), rnd(vv), s, products))
        x = x + _mm(torch.cat(att, dim=0), a["wo"].float(), products)
        h = _rmsnorm(x, p["ln2"]["scale"])
        f = p["ffn"]
        if m.get("n_experts"):
            y = [_moe(m, f, h[:s], capacity(m, s), products)]
            if n > 1:
                y.append(_moe(m, f, h[s:], h.shape[0] * m["top_k"], products))
            x = x + torch.cat(y, dim=0)
        else:
            x = x + _swiglu(h, f["w1"].float(), f["w3"].float(), f["w2"].float(), products)
    x = _rmsnorm(x[s - 1:], params["final_norm"]["scale"])
    w = params["embed"].T if m.get("tie_embeddings") else params["head"]
    return _mm(x, rnd(w.float()), products)


def gaps(ref: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
    """How far each token's reference logit lies below the reference's best
    at its position (n,): 0 where the token is the reference's argmax."""
    t = torch.as_tensor(list(tokens), dtype=torch.long, device=ref.device)
    return ref.max(dim=-1).values - ref.gather(1, t[:, None])[:, 0]


def compare(m: Dict, params: Dict, requests: List, control: bool = False) -> Dict:
    """The numbers of the check over every served token of ``requests``,
    each ``(prompt, served, program_max)``: ``program_max`` holds the
    program's largest logit at each served position, the served token's own
    logit for a greedy request.  With TF32 off:

    * ``widest_gap``: how far a served token's reference logit lies below
      the reference's best, at its widest;
    * ``logit_err``: how far the program's logit of a served token lies from
      the reference's logit of it, at its widest.

    ``logit_err_median`` and ``logit_err_p90``: the median and the 90th
    percentile over the served tokens of the program's distance from the
    reference's logit.  With ``control`` the
    same numbers of the reference with bf16 products put in the program's
    place (``control_*``), at the same positions, and of the reference with
    fp64 products (``fp64_logit_err*``), a witness of how far two sound
    computations lie apart.  ``per_request`` holds each request's
    numbers."""
    out = {"tokens": 0, "widest_gap": 0.0, "logit_err": 0.0, "per_request": []}
    errs, ctrl_errs, wit_errs = [], [], []
    if control:
        out.update(control_widest_gap=0.0, control_logit_err=0.0)
    for prompt, served, prog_max in requests:
        with precision(False):
            ref = logits(m, params, prompt, served)
        t = torch.as_tensor(list(served), dtype=torch.long, device=ref.device)
        err = (torch.as_tensor(prog_max, device=ref.device) - ref.gather(1, t[:, None])[:, 0]).abs()
        errs.append(err)
        mine = {"widest_gap": float(gaps(ref, served).max()), "logit_err": float(err.max()),
                "logit_err_median": float(err.median()),
                "logit_err_p90": float(torch.quantile(err.float(), 0.9))}
        out["tokens"] += len(served)
        out["per_request"].append(mine)
        for k in ("widest_gap", "logit_err"):
            out[k] = max(out[k], mine[k])
        if control:
            with precision(False):
                low = logits(m, params, prompt, served, products=torch.bfloat16)
            best = low.max(dim=-1)
            picked = ref.gather(1, best.indices[:, None])[:, 0]
            out["control_widest_gap"] = max(out["control_widest_gap"],
                                            float((ref.max(dim=-1).values - picked).max()))
            ctrl_errs.append((best.values - picked).abs())
            out["control_logit_err"] = max(out["control_logit_err"], float(ctrl_errs[-1].max()))
            # a witness: fp64 products, as far from the fp32 reference as
            # two sound computations lie
            with precision(False):
                wide = logits(m, params, prompt, served, products=torch.float64)
            wit_errs.append((wide.gather(1, t[:, None]) - ref.gather(1, t[:, None]))[:, 0].abs())
            del low, wide
        del ref
    for name, e in (("logit_err", errs), ("control_logit_err", ctrl_errs),
                    ("fp64_logit_err", wit_errs)):
        if e and name == "fp64_logit_err":
            out[name] = float(torch.cat(e).max())
        if e:
            e = torch.cat(e)
            out[name + "_median"] = float(e.median())
            out[name + "_p90"] = float(torch.quantile(e.float(), 0.9))
    return out
