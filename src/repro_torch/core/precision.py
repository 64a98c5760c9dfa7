"""Precision policies: the storage/compute/accumulate dtype triple the
batched scoring pipeline threads end to end.

``storage`` is the dtype of the Phase-1 handoff arrays (the (v, nq, h)
distance tensor and the (nq, v, k) Z/W ladders); ``compute`` that of the
distance-matmul operands; ``accum`` that of every reduction and sentinel
write, always float32.

=========  =========  =========  =======
name       storage    compute    accum
=========  =========  =========  =======
f32        float32    float32    float32   (default)
bf16       bfloat16   float32    float32
bf16_agg   bfloat16   bfloat16   float32
=========  =========  =========  =======

Under ``bf16_agg`` the compute dtype reaches the distances in two ways, as
in the JAX package: the plain Phase 1 (``core.geometry.pairwise_dist``)
rounds only the operands of its cross term to bfloat16, while the
``dist_topk`` kernel is given bfloat16 coordinates and computes the norms
from them too (``core.lc._phase1_batched_dispatch``).

Every reduced-precision path masks with :func:`pad_dist_for` (dtype)
rather than the float32 sentinel 1e30, which rounds in bfloat16 and
overflows float16. The sentinels are bitwise the JAX package's.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

#: ``lc.PAD_DIST`` (1e30) as float32: it rounds UP to ~1.000000015e30, so
#: it is itself a valid round-up sentinel.
_PAD_F32 = float(np.float32(1e30))


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """One storage/compute/accumulate dtype triple (dtype names as strings,
    as in the JAX package)."""
    name: str
    storage: str
    compute: str
    accum: str

    @property
    def storage_dtype(self) -> torch.dtype:
        return getattr(torch, self.storage)

    @property
    def compute_dtype(self) -> torch.dtype | None:
        """The matmul operands' dtype, or ``None`` for float32 (the
        ``compute_dtype`` argument of ``pairwise_dist``)."""
        return None if self.compute == "float32" else getattr(torch,
                                                               self.compute)


POLICIES = {
    "f32": PrecisionPolicy("f32", "float32", "float32", "float32"),
    "bf16": PrecisionPolicy("bf16", "bfloat16", "float32", "float32"),
    "bf16_agg": PrecisionPolicy("bf16_agg", "bfloat16", "bfloat16",
                                "float32"),
}


def resolve(precision) -> PrecisionPolicy:
    """Preset name (or an already-resolved policy) -> PrecisionPolicy."""
    if isinstance(precision, PrecisionPolicy):
        return precision
    if precision in POLICIES:
        return POLICIES[precision]
    raise ValueError(f"unknown precision policy {precision!r}; "
                     f"one of {sorted(POLICIES)}")


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


@functools.lru_cache(maxsize=None)
def _pad_dist_cached(dtype: torch.dtype) -> float:
    fi = torch.finfo(dtype)
    if fi.bits >= 32:
        return _PAD_F32
    # Narrow-range dtypes (float16: max 65504) cap the sentinel well below
    # the float32 one, still far above any real transport cost.
    target = min(_PAD_F32, float(fi.max) / 8.0)

    def rounded(x: float) -> float:
        return float(torch.tensor(x, dtype=dtype))

    x = rounded(target)
    # Round UP to the first representable value that clears the target
    # (nearest rounding may have landed below it).
    while x < target:
        x = rounded(x * (1.0 + float(fi.eps)))
    return x


def pad_dist_for(dtype) -> float:
    """The padding-distance sentinel for ``dtype`` (a torch dtype or a dtype
    name such as ``"bfloat16"``), as a Python float.

    Finite, above any real transport cost, exactly representable in
    ``dtype`` (a downcast-then-upcast round trip is exact) and, wherever
    the dtype's range allows, at least the float32 sentinel on upcast, so
    strict ``< pad`` comparisons stay right across mixed-precision
    handoffs. ``pad_dist_for(torch.float32)`` is bitwise ``float32(1e30)``.
    """
    return _pad_dist_cached(_torch_dtype(dtype))
