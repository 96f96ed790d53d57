"""Mixtral 8x22B [arXiv:2401.04088] — 8-expert top-2 MoE with SWA."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    attention="swa",
    window=4096,            # sliding-window attention
    n_experts=8,
    top_k=2,
    moe_d_ff=16384,
    capacity_factor=1.25,
    rope_theta=1_000_000.0,
)
