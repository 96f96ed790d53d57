"""The paper's own evaluation vehicle: a ~100M dense LM, the default arch of
the training launcher (``python -m repro_torch.launch.train``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="countdown-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=3072,
    vocab=32768,
    attention="full",
    tie_embeddings=True,
)
