"""InternVL2-1B [arXiv:2404.16821] — InternLM2 LM backbone of the VLM.

Backbone only: InternViT patch embeddings arrive precomputed via the
``input_specs`` vision stub as a 256-token prefix.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    attention="full",
    frontend="vision",
    n_prefix=256,           # ViT patch embeddings (stub)
    tie_embeddings=True,
)
