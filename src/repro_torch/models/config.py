"""Model/architecture configuration schema and the assigned input shapes.

One ``ModelConfig`` per assigned architecture lives in
``repro_torch/configs/``. The config is the single source of truth for model
construction (``models/model.py``) and the smoke tests. This is the port's
own copy of the JAX package's ``models/config.py``: the same fields,
defaults and analytic ``param_count``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int          # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int             # dense MLP hidden (or per-expert hidden for MoE)
    vocab: int
    head_dim: int = 0     # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # Pack each expert's FFN into this many column slices so the packed
    # expert dim (n_experts * moe_ff_shards) matches the TP axis when
    # n_experts alone doesn't divide it (mixtral: 8 experts x 2 -> 16).
    # The combine is a cheap pairwise partial sum. 1 = plain layout.
    moe_ff_shards: int = 1
    # True: explicit shard_map expert parallelism — dispatch/compute/combine
    # run rank-local over the "model" axis with ONE activation psum per
    # layer, instead of letting SPMD reshard the (G,E,C,d) tensors
    # (EXPERIMENTS.md section Perf, mixtral iterations).
    moe_shard_map: bool = False

    # --- attention pattern ---
    sliding_window: int = 0          # >0: local window size for local layers
    local_global_ratio: int = 0      # gemma3: 5 => 5 local then 1 global
    rope_theta: float = 10_000.0
    mrope: bool = False              # qwen2-vl M-RoPE (sectioned rotary)

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    hybrid_attn_every: int = 0       # zamba2: shared attn block every N layers

    # --- MLP / norm flavor ---
    mlp: Literal["swiglu", "relu2", "gelu"] = "swiglu"
    norm: Literal["rmsnorm", "nonparametric"] = "rmsnorm"
    tie_embeddings: bool = False

    # --- modality frontend (audio/vlm): stubbed, inputs are embeddings ---
    frontend: Literal["none", "audio_frames", "vision_patches"] = "none"

    # --- numerics / training ---
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"   # bf16 for the very largest archs
    remat: bool = True
    # "full"  — recompute everything in backward (min memory, 8ND FLOPs)
    # "dots"  — save matmul outputs, recompute element-wise only (~6ND)
    remat_policy: str = "full"

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Analytic parameter count (cross-checked against init in tests)."""
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        total = self.vocab * d                       # embed
        if not self.tie_embeddings:
            total += self.vocab * d                  # lm head
        n_attn = self._n_attn_layers()
        n_ssm = self._n_ssm_layers()
        hd = self.head_dim
        attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d) if self.n_heads else 0
        if self.is_moe:
            mlp_mult = 3 if self.mlp == "swiglu" else 2
            mlp = self.n_experts * mlp_mult * d * ff + d * self.n_experts
            total += L * (attn + mlp + 2 * self._norm_params())
        elif self.family == "ssm":
            total += L * (self._ssm_params() + self._norm_params())
        elif self.family == "hybrid":
            total += n_ssm * (self._ssm_params() + self._norm_params())
            # one shared attn+MLP block (weight-tied across its call sites)
            mlp_mult = 3 if self.mlp == "swiglu" else 2
            total += attn + mlp_mult * d * ff + 2 * self._norm_params()
        else:
            mlp_mult = 3 if self.mlp == "swiglu" else 2
            mlp = mlp_mult * d * ff
            total += n_attn * (attn + mlp + 2 * self._norm_params())
        total += self._norm_params()                 # final norm
        return total

    def _norm_params(self) -> int:
        return 0 if self.norm == "nonparametric" else self.d_model

    def _n_attn_layers(self) -> int:
        if self.family == "ssm":
            return 0
        return self.n_layers

    def _n_ssm_layers(self) -> int:
        if self.family == "ssm":
            return self.n_layers
        if self.family == "hybrid":
            return self.n_layers
        return 0

    def _ssm_params(self) -> int:
        d = self.d_model
        d_in = self.ssm_expand * d
        h = d_in // self.ssm_head_dim
        ng = 1
        conv_dim = d_in + 2 * ng * self.ssm_state
        in_proj = d * (2 * d_in + 2 * ng * self.ssm_state + h)
        conv = conv_dim * self.ssm_conv_width + conv_dim
        extra = 3 * h                                # A_log, dt_bias, D
        norm = d_in
        out = d_in * d
        return in_proj + conv + extra + norm + out


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned (shape-id -> step kind) cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

#: Archs for which long_500k is runnable (sub-quadratic long-context path).
#: Pure full-attention archs skip it (see DESIGN.md section 6).
LONG_CONTEXT_ARCHS = frozenset({"mamba2-2.7b", "zamba2-2.7b", "gemma3-27b"})


def cells_for(arch_name: str) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch_name in LONG_CONTEXT_ARCHS:
        out.append("long_500k")
    return out
