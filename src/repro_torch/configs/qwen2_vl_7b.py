"""qwen2-vl-7b — M-RoPE; the vision tower is a STUB: inputs are precomputed
patch embeddings. [arXiv:2409.12191; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18_944, vocab=152_064, head_dim=128,
    mlp="swiglu", mrope=True, frontend="vision_patches",
)
