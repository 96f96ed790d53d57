"""OLMo-1B [arXiv:2402.00838] — non-parametric LayerNorm, MHA."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,          # MHA
    d_ff=8192,
    vocab=50304,
    attention="full",
    norm="nonparametric",
    tie_embeddings=True,
)
