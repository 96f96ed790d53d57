"""Mamba-2 130M [arXiv:2405.21060] — attention-free SSD (state-space duality)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                 # Mamba-2 blocks replace the MLP
    vocab=50280,
    attention="none",
    ssm_state=128,
    ssm_d_head=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    tie_embeddings=True,
)
