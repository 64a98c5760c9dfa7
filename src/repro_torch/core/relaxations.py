"""The paper's relaxation measures, per histogram pair (Section 4), in
PyTorch: the port's own copy of the JAX package's ``core/relaxations.py``.

All four relax the EMD LP, in increasing tightness (Theorem 2):

    RWMD <= OMR <= ACT-k <= ICT <= EMD.

Directional convention: ``*_dir(p, q, C)`` is the cost of moving ``p``
(hp,) INTO ``q`` (hq,) under the costs ``C`` (hp, hq): out-flow
constraints kept, in-flow constraints removed or relaxed to the per-edge
capacity F_ij <= q_j. The symmetric measure is the max of the two
directions (the paper's Sections 2.1 and 6).

The greedy pour of Algorithms 2 and 3 is an exclusive prefix sum over the
cost-sorted destinations, not a loop. Ranked costs come from a stable sort,
so ties go to the lowest destination, as ``lax.top_k`` and ``jnp.argsort``
order them in the JAX package. These are readable oracles for the engines
of ``core/lc.py``, not a serving path.
"""
from __future__ import annotations

import torch

__all__ = [
    "rwmd_dir", "omr_dir", "ict_dir", "act_dir",
    "rwmd", "omr", "ict", "act",
]


def _smallest(C: torch.Tensor, k: int):
    """(values, destinations) of the k smallest costs of each row,
    ascending, the lowest destination first among ties."""
    vals, idx = torch.sort(C, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def rwmd_dir(p: torch.Tensor, q: torch.Tensor,
             C: torch.Tensor) -> torch.Tensor:
    """Relaxed WMD, direction p -> q: every source bin ships all its mass
    to its nearest destination (the in-flow constraints dropped)."""
    del q  # the relaxation ignores the destination weights
    return torch.sum(p * C.amin(dim=1))


def omr_dir(p: torch.Tensor, q: torch.Tensor,
            C: torch.Tensor) -> torch.Tensor:
    """Overlapping Mass Reduction (Algorithm 1), direction p -> q: where
    the nearest destination overlaps (cost 0), min(p_i, q_j) rides for
    free and the rest pays the second-nearest cost; elsewhere everything
    pays the nearest cost."""
    cost, dest = _smallest(C, 2)
    rest = p - torch.minimum(p, q[dest[:, 0]])
    return torch.sum(torch.where(cost[:, 0] == 0.0, rest * cost[:, 1],
                                 p * cost[:, 0]))


def _greedy_pour_rows(p: torch.Tensor, cap_sorted: torch.Tensor,
                      cost_sorted: torch.Tensor):
    """The greedy pour of Algorithms 2 and 3: row i pours p[i] into
    destinations l = 0, 1, ... of capacities cap_sorted[i, l] at costs
    cost_sorted[i, l]; slot l takes r_l = clip(p_i - prefix_<l, 0, cap_l).
    Returns (the poured cost per row, the mass left per row)."""
    prefix = torch.cumsum(cap_sorted, dim=1) - cap_sorted   # exclusive
    r = torch.minimum(torch.clamp_min(p[:, None] - prefix, 0.0), cap_sorted)
    poured = torch.sum(r * cost_sorted, dim=1)
    remainder = torch.clamp_min(p - torch.sum(r, dim=1), 0.0)
    return poured, remainder


def ict_dir(p: torch.Tensor, q: torch.Tensor,
            C: torch.Tensor) -> torch.Tensor:
    """Iterative Constrained Transfers (Algorithm 2), direction p -> q: the
    optimum of the relaxation {(1), (2), (4)}, per-edge capacity q_j, by a
    full sort of each cost row and a greedy pour until each source bin is
    empty. Histograms are L1-normalized, so no mass is left; any float
    residue pays the row's largest cost."""
    order = torch.argsort(C, dim=1, stable=True)
    cost_sorted = torch.take_along_dim(C, order, dim=1)
    poured, remainder = _greedy_pour_rows(p, q[order], cost_sorted)
    return torch.sum(poured) + torch.sum(remainder * cost_sorted[:, -1])


def act_dir(p: torch.Tensor, q: torch.Tensor, C: torch.Tensor,
            iters: int = 1) -> torch.Tensor:
    """Approximate ICT (Algorithm 3), direction p -> q: ``iters``
    capacity-constrained transfers to the nearest destinations (ACT-1 is
    iters=1), then the rest at the (iters+1)-th nearest cost. iters=0 is
    RWMD; iters >= hq - 1 is ICT."""
    iters = min(iters, C.shape[1] - 1)
    cost, dest = _smallest(C, iters + 1)
    if iters == 0:
        return torch.sum(p * cost[:, 0])
    poured, remainder = _greedy_pour_rows(p, q[dest[:, :iters]],
                                          cost[:, :iters])
    return torch.sum(poured) + torch.sum(remainder * cost[:, iters])


def _symmetric(fn_dir, p, q, C, **kw):
    return torch.maximum(fn_dir(p, q, C, **kw), fn_dir(q, p, C.T, **kw))


def rwmd(p: torch.Tensor, q: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Symmetric RWMD: the max of the two directional bounds."""
    return _symmetric(rwmd_dir, p, q, C)


def omr(p: torch.Tensor, q: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Symmetric OMR."""
    return _symmetric(omr_dir, p, q, C)


def ict(p: torch.Tensor, q: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Symmetric ICT."""
    return _symmetric(ict_dir, p, q, C)


def act(p: torch.Tensor, q: torch.Tensor, C: torch.Tensor,
        iters: int = 1) -> torch.Tensor:
    """Symmetric ACT-``iters``."""
    return _symmetric(act_dir, p, q, C, iters=iters)
