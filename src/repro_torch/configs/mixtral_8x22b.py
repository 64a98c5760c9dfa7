"""mixtral-8x22b — 8 experts, top-2 routing. [arXiv:2401.04088; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16_384, vocab=32_768, head_dim=128,
    n_experts=8, experts_per_token=2,
    mlp="swiglu",
    opt_state_dtype="bfloat16",   # 141B params: fp32 m/v won't fit one pod
)
