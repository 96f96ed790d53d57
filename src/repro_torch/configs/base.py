"""Configuration dataclasses for models, shapes and runs.

Every assigned architecture is expressed as a ``ModelConfig``; the four
assigned input shapes as ``ShapeConfig``.  Configs are plain frozen
dataclasses so they can be hashed, compared and serialized trivially.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Unified architecture description covering dense / MoE / SSM / hybrid LMs."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # --- attention ---
    d_head: int = 0                  # 0 -> d_model // n_heads
    attention: str = "full"          # full | swa | local | none
    window: int = 0                  # window size for swa/local
    rope_theta: float = 10_000.0
    qk_norm: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert FFN width (granite: 512)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01    # load-balance auxiliary loss

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0               # d_state (N)
    ssm_d_head: int = 64             # P
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_conv: int = 4                # depthwise conv kernel width
    ssm_chunk: int = 128             # SSD chunk length

    # --- RG-LRU (RecurrentGemma) ---
    rglru_width: int = 0             # 0 -> d_model
    rglru_c: float = 8.0

    # --- hybrid stacking ---
    # repeating pattern of block kinds; () means homogeneous:
    #   dense/moe -> ("attn",), ssm -> ("ssm",)
    block_pattern: Tuple[str, ...] = ()

    # --- misc ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm | nonparametric
    kv_quant: bool = False           # int8 KV cache (serving memory knob)
    pad_vocab_to: int = 0            # pad embedding rows to a multiple (TP):
                                     # odd vocabs (151655, 49155) otherwise
                                     # defeat vocab sharding entirely
    tie_embeddings: bool = False
    frontend: str = "none"           # none | vision | audio
    n_prefix: int = 0                # frontend prefix embedding length
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    logits_softcap: float = 0.0
    # scan-over-layers keeps HLO small (production default).  The dry-run
    # unrolls instead: XLA cost_analysis counts while-loop bodies ONCE, so
    # scanned modules under-report FLOPs/bytes/collectives for the roofline.
    scan_layers: bool = True

    # ---- derived helpers -------------------------------------------------
    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def padded_vocab(self) -> int:
        if not self.pad_vocab_to:
            return self.vocab
        m = self.pad_vocab_to
        return ((self.vocab + m - 1) // m) * m

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.block_pattern:
            return self.block_pattern
        if self.family == "ssm":
            return ("ssm",)
        return ("attn",)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, repeating ``pattern`` to n_layers."""
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_d_head

    @property
    def lru_width(self) -> int:
        return self.rglru_width or self.d_model

    # ---- parameter count (for roofline MODEL_FLOPS = 6*N*D) --------------
    def param_count(self, active_only: bool = False) -> int:
        """Total (or MoE-active) parameter count, embeddings included."""
        d, V = self.d_model, self.vocab
        total = V * d                          # token embedding
        if not self.tie_embeddings:
            total += V * d                     # output head
        hd = self.head_dim
        for kind in self.layer_kinds():
            total += 2 * d                     # two norms (rms weights), ~0 for nonparametric
            if kind == "attn":
                total += d * self.n_heads * hd           # q
                total += 2 * d * self.n_kv_heads * hd    # k, v
                total += self.n_heads * hd * d           # o
                if self.is_moe:
                    e = self.top_k if active_only else self.n_experts
                    total += d * self.n_experts          # router (always dense)
                    total += e * 3 * d * self.moe_d_ff   # gated ffn per expert
                else:
                    total += 3 * d * self.d_ff           # swiglu
            elif kind == "ssm":
                di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
                total += d * (2 * di + 2 * N + H)        # in_proj (z,x,B,C,dt)
                total += self.ssm_conv * (di + 2 * N)    # depthwise conv
                total += H + H + H * self.ssm_d_head * 0 # A_log, D
                total += di * d                          # out_proj
            elif kind == "rglru":
                w = self.lru_width
                total += 2 * d * w                       # two in-projections
                total += self.ssm_conv * w               # temporal conv
                total += w                               # Lambda (a parameter)
                total += 2 * w * w                       # input/recurrence gate projections
                total += w * d                           # out projection
                total += 3 * d * self.d_ff               # hybrid blocks keep a SwiGLU MLP
        return int(total)


@dataclass(frozen=True)
class ShapeConfig:
    """An assigned (seq_len, global_batch, kind) input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# Archs whose *every* attention layer is unwindowed full attention must skip
# long_500k (assignment rule: sub-quadratic attention required).
FULL_ATTENTION_ONLY = frozenset(
    {
        "musicgen-large",
        "granite-moe-3b-a800m",
        "internvl2-1b",
        "llama3.2-1b",
        "glm4-9b",
        "olmo-1b",
        "internlm2-1.8b",
    }
)


def cell_is_runnable(arch: str, shape: str) -> bool:
    if shape == "long_500k" and arch in FULL_ATTENTION_ONLY:
        return False
    return True


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family variant of ``cfg`` for CPU smoke tests."""
    small = dict(
        n_layers=min(cfg.n_layers, len(cfg.pattern) * 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads * 4 // max(cfg.n_heads, 1), 4)),
        d_ff=256,
        vocab=512,
        d_head=32,
        window=min(cfg.window, 64) if cfg.window else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        moe_d_ff=64 if cfg.n_experts else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_d_head=16,
        ssm_chunk=16,
        rglru_width=64 if cfg.family == "hybrid" else 0,
        n_prefix=8 if cfg.n_prefix else 0,
        param_dtype="float32",
        compute_dtype="float32",
        name=cfg.name + "-smoke",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
