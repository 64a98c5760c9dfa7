"""The JAX package's configs, the shapes the port is run at: the two EMD
workloads (``emd_20news.py``, ``emd_mnist.py``) and the ten LM
architectures, with ``--arch <id>`` resolution and reduced smoke variants.

``get_config(name)`` returns the full published configuration.
``smoke_config(name)`` returns a reduced same-family variant small enough
for a real CPU forward and decode.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "moonshot-v1-16b-a3b",
    "mixtral-8x22b",
    "mamba2-2.7b",
    "gemma3-27b",
    "nemotron-4-340b",
    "olmo-1b",
    "nemotron-4-15b",
    "musicgen-large",
    "qwen2-vl-7b",
    "zamba2-2.7b",
]

EMD_IDS = ["emd-20news", "emd-mnist"]


def _module_for(name: str) -> str:
    return "repro_torch.configs." + name.replace("-", "_").replace(".", "_")


def get_config(name: str):
    if name not in ARCH_IDS + EMD_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS + EMD_IDS}")
    return importlib.import_module(_module_for(name)).CONFIG


def smoke_config(name: str) -> ModelConfig:
    """Reduced config of the same family: few layers, narrow, tiny vocab."""
    full = get_config(name)
    updates = dict(
        n_layers=4,
        d_model=64,
        d_ff=128 if full.d_ff else 0,
        vocab=256,
        head_dim=16,
        param_dtype="float32",
        opt_state_dtype="float32",
        remat=False,
    )
    if full.n_heads:
        updates["n_heads"] = 4
        updates["n_kv_heads"] = (min(full.n_kv_heads, 2)
                                 if full.n_kv_heads < full.n_heads else 4)
    if full.is_moe:
        updates["n_experts"] = 4
        updates["experts_per_token"] = 2
    if full.ssm_state:
        updates["ssm_state"] = 16
        updates["ssm_head_dim"] = 16
        updates["ssm_chunk"] = 8
    if full.hybrid_attn_every:
        updates["hybrid_attn_every"] = 2
    if full.sliding_window:
        updates["sliding_window"] = 8
    return dataclasses.replace(full, **updates)
