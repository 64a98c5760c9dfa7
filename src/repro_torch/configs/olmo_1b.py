"""olmo-1b — non-parametric LayerNorm, tied embeddings. [arXiv:2402.00838]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=50_304, head_dim=128,
    mlp="swiglu", norm="nonparametric", tie_embeddings=True,
)
