"""Operations and bytes that the work itself needs, from the shapes alone:
the yardstick of the roofline shares and of the step's share of the peak.
``m`` is a configuration's ``model`` block.  Bytes count each input read
once and each output written once, whatever a kernel reads again.
"""
from __future__ import annotations

from typing import Dict

_BYTES = {"float32": 4, "bfloat16": 2}


def head_dim(m: Dict) -> int:
    return m.get("d_head") or m["d_model"] // m["n_heads"]


def active_params_per_token(m: Dict) -> int:
    """Weights one token's forward multiplies: every layer's attention
    projections and its FFN (an MoE layer: its router and its top-k
    experts), and the unembedding; not the embedding lookup."""
    d, hq, hkv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], head_dim(m)
    attn = d * hq * hd * 2 + d * hkv * hd * 2
    if m.get("n_experts"):
        ffn = d * m["n_experts"] + m["top_k"] * 3 * d * m["moe_d_ff"]
    else:
        ffn = 3 * d * m["d_ff"]
    return m["n_layers"] * (attn + ffn) + d * m["vocab"]


def decode_flops(m: Dict, n_tokens: int, live_keys: int) -> float:
    """A decode step's model FLOPs: 2 x active parameters x tokens, plus
    QK^T and PV over the ``live_keys`` positions its tokens attend."""
    attn = 4 * m["n_heads"] * head_dim(m) * live_keys * m["n_layers"]
    return 2.0 * active_params_per_token(m) * n_tokens + attn


def paged_bytes(m: Dict, n_tokens: int, live_keys: int) -> float:
    """One layer's paged decode attention over the active slots: every live
    K and V row read once from the pages, each new row written once, q read
    once and the output written once (fp32)."""
    hq, hkv, hd = m["n_heads"], m["n_kv_heads"], head_dim(m)
    page = _BYTES[m.get("compute_dtype", "bfloat16")]
    return (2 * live_keys * hkv * hd * page + 2 * n_tokens * hkv * hd * page
            + 2 * n_tokens * hq * hd * 4)


def flash_flops(m: Dict, s: int) -> float:
    """One layer's causal prefill attention over ``s`` tokens: QK^T and PV
    over the s(s+1)/2 query-key pairs that the mask keeps."""
    return 4.0 * m["n_heads"] * head_dim(m) * s * (s + 1) / 2


def flash_bytes(m: Dict, s: int) -> float:
    """q, k and v read once and the output written once (fp32)."""
    hq, hkv, hd = m["n_heads"], m["n_kv_heads"], head_dim(m)
    return 4.0 * s * hd * (2 * hq + 2 * hkv)


def peak(peaks: Dict, kind: str) -> Dict:
    """The table row of the card named ``kind`` (``torch.cuda.get_device_name``)."""
    for name, row in peaks.items():
        if not name.startswith("_") and name in kind:
            return row
    raise KeyError(f"no peaks for {kind!r}")
