"""Sinkhorn distance baseline (Cuturi 2013) in PyTorch, in the log domain.

The port's copy of the JAX package's ``core/sinkhorn.py``: entropic
regularization lambda (the paper's 20), a fixed number of scaling
iterations, ``torch.logsumexp`` for the dual updates. The pair axes are the
last one (p, q) or two (C); any leading axes are a batch, where the JAX
version maps over pairs.
"""
from __future__ import annotations

import torch


def sinkhorn_cost(p: torch.Tensor, q: torch.Tensor, C: torch.Tensor,
                  lam: float = 20.0, n_iters: int = 200) -> torch.Tensor:
    """Entropic-OT transport cost <F*, C> with F* from Sinkhorn scaling.

    p: (..., hp) L1-normalized source histograms.
    q: (..., hq) L1-normalized target histograms.
    C: (..., hp, hq) nonnegative costs.
    Returns (...,) costs of the regularized plan: NOT a lower bound of EMD;
    it converges to EMD from above as lam -> inf.
    """
    eps = 1.0 / lam
    logp = torch.log(torch.clamp_min(p, 1e-35))
    logq = torch.log(torch.clamp_min(q, 1e-35))
    mK = -C / eps                                        # log kernel
    f = torch.zeros_like(logp)
    g = torch.zeros_like(logq).expand(logp.shape[:-1] + logq.shape[-1:])
    for _ in range(n_iters):
        f = eps * (logp - torch.logsumexp(mK + g[..., None, :] / eps, dim=-1))
        g = eps * (logq - torch.logsumexp(mK + f[..., :, None] / eps, dim=-2))
    F = torch.exp((f[..., :, None] + g[..., None, :]) / eps + mK)
    # Mass of empty bins is ~0; renormalize the plan defensively.
    F = F * (torch.sum(p, dim=-1) / torch.clamp_min(
        torch.sum(F, dim=(-2, -1)), 1e-35))[..., None, None]
    return torch.sum(F * C, dim=(-2, -1))
