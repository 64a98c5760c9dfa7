"""zamba2-2.7b — Mamba2 backbone + ONE weight-tied shared attention+MLP
block applied every 6 layers. [arXiv:2411.15242]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10_240, vocab=32_000, head_dim=80,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    hybrid_attn_every=6,
    mlp="swiglu",
)
