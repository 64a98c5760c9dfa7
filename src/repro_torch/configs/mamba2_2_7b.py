"""mamba2-2.7b — pure SSM, SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50_280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
)
