"""Exact EMD oracle (the discrete transportation LP), on the host.

The port's own copy of the JAX package's ``core/emd.py``: the ground truth
that Theorem 2's chain of lower bounds is measured against,

    RWMD <= OMR <= ACT-k <= ICT <= EMD,

solved by ``scipy.optimize.linprog`` (HiGHS) in float64 on numpy arrays.
It is the oracle, not the system: nothing here runs on a device.
"""
from __future__ import annotations

import numpy as np


def emd_exact(p, q, C) -> float:
    """Exact EMD between L1-normalized histograms ``p`` (hp,) and ``q``
    (hq,) under the nonnegative cost matrix ``C`` (hp, hq)."""
    from scipy.optimize import linprog

    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    C = np.asarray(C, dtype=np.float64)
    hp, hq = C.shape
    if p.shape != (hp,) or q.shape != (hq,):
        raise ValueError(f"histograms {p.shape}, {q.shape} do not match "
                         f"costs {C.shape}")
    # Float32 inputs normalized upstream may miss sum == 1 by ~1e-7, which
    # the equality constraints would reject; renormalize in float64.
    p = p / p.sum()
    q = q / q.sum()
    # Variables: the flow F row-major, F[i, j] = x[i * hq + j] >= 0.
    # Out-flow: sum_j F[i, j] = p_i (hp rows); in-flow: sum_i F[i, j] = q_j
    # (the last row dropped: redundant given the others and sum p = sum q).
    a_eq = np.zeros((hp + hq - 1, hp * hq))
    for i in range(hp):
        a_eq[i, i * hq:(i + 1) * hq] = 1.0
    for j in range(hq - 1):
        a_eq[hp + j, j::hq] = 1.0
    res = linprog(c=C.ravel(), A_eq=a_eq,
                  b_eq=np.concatenate([p, q[:-1]]), bounds=(0, None),
                  method="highs")
    if not res.success:
        raise RuntimeError(f"exact EMD LP failed: {res.message}")
    return float(res.fun)
