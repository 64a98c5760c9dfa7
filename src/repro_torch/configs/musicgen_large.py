"""musicgen-large — decoder-only over EnCodec tokens; the EnCodec frontend
is a STUB: inputs are precomputed frame embeddings. [arXiv:2306.05284; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048, head_dim=64,
    mlp="gelu", frontend="audio_frames",
)
