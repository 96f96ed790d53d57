"""MusicGen-Large — decoder-only LM over EnCodec tokens [arXiv:2306.05284].

Backbone only: the EnCodec/conditioning frontend is an ``input_specs`` stub
providing precomputed frame embeddings as a prefix (see assignment note).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,          # MHA
    d_ff=8192,
    vocab=2048,             # EnCodec codebook size
    attention="full",
    norm="layernorm",
    frontend="audio",
    n_prefix=64,            # conditioning frame embeddings (stub)
)
