"""IBM Granite 3.0 MoE (3b-a800m class) [hf:ibm-granite].

Fine-grained MoE: 40 experts, top-8, narrow (512-wide) expert FFNs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,               # per-expert width (mirrored in moe_d_ff)
    vocab=49155,
    attention="full",
    n_experts=40,
    top_k=8,
    moe_d_ff=512,
    capacity_factor=1.25,
    tie_embeddings=True,
)
