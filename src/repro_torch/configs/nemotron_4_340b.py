"""nemotron-4-340b — GQA + squared-ReLU MLP. [arXiv:2402.16819]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18_432, n_heads=96, n_kv_heads=8,
    d_ff=73_728, vocab=256_000, head_dim=192,
    mlp="relu2",
    opt_state_dtype="bfloat16",   # 341B params: fp32 m/v won't fit one pod
)
