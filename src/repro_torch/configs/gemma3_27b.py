"""gemma3-27b — 5:1 local:global attention (window 1024), 262k vocab.
[hf:google/gemma-3 family]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
    d_ff=21_504, vocab=262_144, head_dim=128,
    sliding_window=1024, local_global_ratio=5,
    mlp="swiglu", tie_embeddings=True,
)
