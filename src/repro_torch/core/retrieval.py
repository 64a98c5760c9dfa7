"""Top-l nearest-neighbour retrieval on the batched LC engines.

The part of the JAX package's ``core/retrieval.py`` that serves
``EmdIndex``'s batched path: ``batch_scores`` for LC-ACT and LC-RWMD, and
``search``, whose top-l matches ``lax.top_k`` on the negated scores
(ascending scores, the lowest index first among ties).
"""
from __future__ import annotations

import torch

from repro_torch.core import lc

#: Methods of the JAX registry that this package scores, by registry key.
METHODS = ("act", "rwmd")


def batch_scores(corpus: lc.Corpus, q_ids: torch.Tensor, q_w: torch.Tensor,
                 *, method: str = "act", iters: int = 1,
                 use_kernels: bool = False, block_q: int = 8,
                 precision: str = "f32") -> torch.Tensor:
    """Query batch ``(nq, h)`` -> ``(nq, n)`` scores through the method's
    batched engine: Phase 1 once for the whole batch, Phase 2/3 in blocks
    of ``block_q`` queries. ``iters`` is read by ``act`` only."""
    kw = dict(use_kernels=use_kernels, block_q=block_q, precision=precision)
    if method == "act":
        return lc.lc_act_scores_batched(corpus, q_ids, q_w, iters=iters,
                                        **kw)
    if method == "rwmd":
        return lc.lc_rwmd_scores_batched(corpus, q_ids, q_w, **kw)
    raise ValueError(f"method {method!r} is not ported; one of {METHODS}")


def top_l_smallest(scores: torch.Tensor, top_l: int):
    """(values, indices) of the ``top_l`` smallest scores along the last
    axis, ascending; among equal scores the lowest index comes first."""
    if not 1 <= top_l <= scores.shape[-1]:
        raise ValueError(f"top_l must be in [1, {scores.shape[-1]}], got "
                         f"{top_l}")
    values, idx = torch.sort(scores, dim=-1, stable=True)
    return values[..., :top_l], idx[..., :top_l]


def search(corpus: lc.Corpus, q_ids: torch.Tensor, q_w: torch.Tensor,
           top_l: int, method: str = "act", iters: int = 1, *,
           use_kernels: bool = False, block_q: int = 8,
           precision: str = "f32"):
    """(scores, indices) of the top-l most similar database rows for each
    query of a ``(nq, h)`` batch, each ``(nq, top_l)``."""
    return top_l_smallest(
        batch_scores(corpus, q_ids, q_w, method=method, iters=iters,
                     use_kernels=use_kernels, block_q=block_q,
                     precision=precision), top_l)
