"""nemotron-4-15b — GQA + squared-ReLU MLP. [arXiv:2402.16819]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=24_576, vocab=256_000, head_dim=128,
    mlp="relu2",
)
