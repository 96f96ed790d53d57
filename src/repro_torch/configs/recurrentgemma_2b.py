"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427].

Hybrid stack: repeating (RG-LRU, RG-LRU, local-attention) — 1 attention per
2 recurrent blocks; local attention window 2048; MQA (1 KV head).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    d_head=256,
    attention="local",
    window=2048,
    block_pattern=("rglru", "rglru", "attn"),
    rglru_width=2560,
    tie_embeddings=True,
    logits_softcap=30.0,
)
