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
                  snap: float = ZERO_SNAP, *, compute_dtype=None,
                  a_ids: torch.Tensor | None = None,
                  b_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Euclidean distances between rows of ``a`` (na, m) and ``b`` (nb, m);
    near-zero values collapse to exact 0 relative to the pair's magnitude
    (see ZERO_SNAP).

    The (na, nb) passes run in place on the product, so two such tensors
    and a mask are live at once. Each value is that of
    ``sqrt(clamp(a2 + b2 - 2 a.b, 0))``: -2 a.b is exact and a float sum
    does not depend on the order of its two terms.

    ``compute_dtype`` (a precision policy's compute role) drops only the
    product's operands to that dtype (bfloat16): they are rounded to it and
    multiplied as float32, so the products are exact and the sum runs in
    float32, as the JAX package's ``preferred_element_type`` product does
    (``torch.matmul`` on bfloat16 tensors would return bfloat16). The
    norms, the snap and the sqrt stay float32. ``None`` (or float32) is the
    float32 product.

    ``b_ids`` (nb,): the vocabulary ids of the rows of ``b``, and ``a_ids``
    (na,) those of ``a`` (``None``: ``a`` is the whole vocabulary, row i
    id i). Every pair with the same id then comes out exactly 0
    (:func:`_pin_same_ids`): the norms are ``torch.sum``s and the cross term
    a BLAS product, whose summation orders differ, and on one pair in a
    hundred of wide-ranging coordinates their residue exceeds the snap.
    Under a reduced ``compute_dtype`` no pair is pinned: the JAX package's
    cross term of bfloat16 operands leaves a residue at those pairs too.
    """
    a2 = torch.sum(a * a, dim=-1, keepdim=True)          # (na, 1)
    b2 = torch.sum(b * b, dim=-1, keepdim=True).T        # (1, nb)
    n2 = a2 + b2
    reduced = compute_dtype is not None and compute_dtype != a.dtype
    if reduced:
        cross = (a.to(compute_dtype).to(a.dtype)
                 @ b.to(compute_dtype).to(a.dtype).T)
    else:
        cross = a @ b.T
    d2 = cross.mul_(-2.0).add_(n2).clamp_min_(0.0)
    if snap:
        d2.masked_fill_(d2 < n2.mul_(snap * snap), 0.0)
    if b_ids is not None and not reduced:
        _pin_same_ids(d2, a_ids, b_ids)
    return d2.sqrt_()


def _pin_same_ids(d: torch.Tensor, a_ids: torch.Tensor | None,
                 b_ids: torch.Tensor) -> torch.Tensor:
    """Zero, in place, every entry of the (na, nb) distances ``d`` whose
    row and column carry the same vocabulary id: with ``a_ids`` None the
    rows are the whole vocabulary and that is one scatter of nb zeros, at
    (b_ids[j], j); else the pairs where a_ids[i] == b_ids[j]. Returns
    ``d``."""
    if a_ids is None:
        cols = torch.arange(d.shape[1], device=d.device)
        d[b_ids.long(), cols] = 0.0
    else:
        d.masked_fill_(a_ids[:, None] == b_ids[None, :], 0.0)
    return d


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
