"""Ground-distance utilities: Euclidean costs between embedding vectors.

Cost matrices use the ``||a-b||^2 = ||a||^2 + ||b||^2 - 2 a.b`` expansion,
so the heavy term is one matrix product. In float32 that product must run
in full float32 (PyTorch's default, ``torch.get_float32_matmul_precision()
== "highest"``): TF32 drops mantissa bits, and identical coordinates would
then no longer snap to an exact zero.
"""
from __future__ import annotations

import torch

#: RELATIVE zero-snap: squared distances below ZERO_SNAP^2 x (|a|^2+|b|^2)
#: collapse to exact 0. The expansion leaves ~eps_f32 x (|a|^2+|b|^2) of
#: cancellation residue on IDENTICAL coordinates, which would defeat the
#: paper's zero-cost overlap detection; exact zeros are load-bearing.
ZERO_SNAP = 1e-3


def pairwise_dist(a: torch.Tensor, b: torch.Tensor,
                  snap: float = ZERO_SNAP) -> torch.Tensor:
    """Euclidean distances between rows of ``a`` (na, m) and ``b`` (nb, m);
    near-zero values collapse to exact 0 relative to the pair's magnitude
    (see ZERO_SNAP).

    The (na, nb) passes run in place on the product, so two such tensors
    and a mask are live at once. Each value is that of
    ``sqrt(clamp(a2 + b2 - 2 a.b, 0))``: -2 a.b is exact and a float sum
    does not depend on the order of its two terms."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)          # (na, 1)
    b2 = torch.sum(b * b, dim=-1, keepdim=True).T        # (1, nb)
    n2 = a2 + b2
    d2 = (a @ b.T).mul_(-2.0).add_(n2).clamp_min_(0.0)
    if snap:
        d2.masked_fill_(d2 < n2.mul_(snap * snap), 0.0)
    return d2.sqrt_()


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances between rows of ``a`` (na, m) and ``b``
    (nb, m), by the same expansion, clamped at 0 and not snapped."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)          # (na, 1)
    b2 = torch.sum(b * b, dim=-1, keepdim=True).T        # (1, nb)
    return torch.clamp_min(a2 + b2 - 2.0 * (a @ b.T), 0.0)


def l1_normalize(w: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """L1-normalize nonnegative weights along ``dim`` (histogram
    convention)."""
    return w / torch.clamp_min(torch.sum(w, dim=dim, keepdim=True), eps)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """Scale rows to unit Euclidean norm along ``dim``."""
    return x / torch.clamp_min(torch.linalg.norm(x, dim=dim, keepdim=True),
                               eps)
