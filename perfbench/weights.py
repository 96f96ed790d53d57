"""Random weights for a configuration, drawn from ``--seed`` on the device.

One draw a kind of leaf, stacked over the layers (``torch.randn`` with a
``torch.Generator`` on the device, scaled in place), then handed out as
per-layer views in the layout the served program takes:
``{"embed", "final_norm": {"scale"}, "layers": [{"ln1", "attn": {wq, wk,
wv, wo}, "ln2", "ffn": {w1, w3, w2[, router]}}][, "head"]}`` with
``x @ w`` weights stored ``(d_in, d_out)`` and an MoE's experts stacked
``(E, d_in, d_out)``.  The same tensors go to the program and to the
reference; neither changes them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def shapes(m: Dict) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """Each stacked leaf kind -> (its shape, the scale of its normal draw)."""
    d, hq, hkv = m["d_model"], m["n_heads"], m["n_kv_heads"]
    hd = m.get("d_head") or d // hq
    n, v = m["n_layers"], m["vocab"]
    out = {
        "embed": ((v, d), 0.02),
        "wq": ((n, d, hq * hd), 1 / math.sqrt(d)),
        "wk": ((n, d, hkv * hd), 1 / math.sqrt(d)),
        "wv": ((n, d, hkv * hd), 1 / math.sqrt(d)),
        "wo": ((n, hq * hd, d), 1 / math.sqrt(hq * hd)),
    }
    if m.get("n_experts"):
        e, f = m["n_experts"], m["moe_d_ff"]
        out.update(router=((n, d, e), 1 / math.sqrt(d)), w1=((n, e, d, f), 1 / math.sqrt(d)),
                   w3=((n, e, d, f), 1 / math.sqrt(d)), w2=((n, e, f, d), 1 / math.sqrt(f)))
    else:
        f = m["d_ff"]
        out.update(w1=((n, d, f), 1 / math.sqrt(d)), w3=((n, d, f), 1 / math.sqrt(d)),
                   w2=((n, f, d), 1 / math.sqrt(f)))
    if not m.get("tie_embeddings"):
        out["head"] = ((d, v), 1 / math.sqrt(d))
    return out


def n_params(m: Dict) -> int:
    """Elements of every leaf, the norms' scales included."""
    total = sum(math.prod(s) for s, _ in shapes(m).values())
    return total + (2 * m["n_layers"] + 1) * m["d_model"]


def draw(m: Dict, seed: int, device) -> Dict:
    """The weights of configuration ``m`` (its ``model`` block) from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = _DTYPES[m.get("param_dtype", "float32")]
    stacked = {}
    for name, (shape, scale) in shapes(m).items():
        t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        stacked[name] = t.mul_(scale).to(dtype)
    if m.get("n_experts"):
        stacked["router"] = stacked["router"].float()     # routers stay fp32
    ones = torch.ones((2 * m["n_layers"] + 1, m["d_model"]), dtype=dtype, device=device)
    attn, ffn = ("wq", "wk", "wv", "wo"), ("router", "w1", "w3", "w2")
    layers: List[Dict] = []
    for i in range(m["n_layers"]):
        layers.append({
            "ln1": {"scale": ones[2 * i]},
            "attn": {k: stacked[k][i] for k in attn},
            "ln2": {"scale": ones[2 * i + 1]},
            "ffn": {k: stacked[k][i] for k in ffn if k in stacked},
        })
    params = {"embed": stacked["embed"], "final_norm": {"scale": ones[-1]}, "layers": layers}
    if "head" in stacked:
        params["head"] = stacked["head"]
    return params
