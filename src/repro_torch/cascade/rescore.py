"""Cascade rescorers: the measures that score the final survivor set.

Any ``retrieval.METHODS`` entry with a candidate-compacted scorer
(``MethodSpec.cand_fn``) can rescore; ``act`` and ``ict`` are the usual
choices. This module adds the two measures that live outside the method
registry because they cannot serve full corpora:

* ``sinkhorn``: Cuturi's entropic OT cost (``core/sinkhorn``) per (query,
  candidate) pair, on the device. Not admissible above the Theorem-2
  stages: the fixed-iteration, mass-renormalized plan is not exactly
  feasible, so its cost can dip below the true EMD, and cascades ending
  here report measured recall.
* ``emd``: the exact transportation LP (``core/emd``), one HiGHS solve per
  pair on the host, fed from CPU copies of the pruned candidates.

The port's own copy of the JAX package's ``cascade/rescore.py``.
``Rescorer.jittable`` keeps the JAX name for "runs on the device".
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.core import lc
from repro_torch.core.emd import emd_exact
from repro_torch.core.geometry import pairwise_dist
from repro_torch.core.retrieval import METHODS
from repro_torch.core.sinkhorn import sinkhorn_cost

#: Sinkhorn rescoring knobs: the paper's lambda, and fewer iterations than
#: the oracle's default (rescoring runs per surviving pair, and 100 rounds
#: converge at the histogram sizes the cascade rescores).
SINKHORN_LAM = 20.0
SINKHORN_ITERS = 100


@dataclasses.dataclass(frozen=True)
class Rescorer:
    """One final-stage scorer. Exactly one of ``fn`` (a device candidate
    scorer) or ``host_fn`` (numpy rescoring of device-pruned candidates)
    is set."""
    name: str
    fn: Callable | None = None
    host_fn: Callable | None = None

    @property
    def jittable(self) -> bool:
        """True when the rescorer runs on the device."""
        return self.fn is not None


def sinkhorn_cand(corpus: lc.Corpus, Q_ids: torch.Tensor, Q_w: torch.Tensor,
                  cand: torch.Tensor, *, block_q: int = 8,
                  **_) -> torch.Tensor:
    """Entropic-OT cost per (query, candidate) pair: (nq, b) scores, in
    blocks of ``block_q`` queries.

    One stacked distance matmul feeds every pair's (hmax, h) costs. The
    costs stay UNMASKED (no sentinel): the log-domain scaling handles the
    zero-mass padding bins by itself (their plan mass is ~1e-35), while a
    1e30 cost would blow up the dual updates.
    """
    nq, h = Q_ids.shape
    flat = Q_ids.reshape(-1)
    Dq = pairwise_dist(corpus.coords, corpus.coords[flat],
                       b_ids=flat).reshape(corpus.v, nq, h)
    Dq = Dq.movedim(1, 0)                                # (nq, v, h)

    def blk(Db, Wb, cb):                     # (bq, v, h), (bq, h), (bq, b)
        C = lc.gather_per_query(Db, corpus.ids[cb])      # (bq, b, hmax, h)
        return sinkhorn_cost(corpus.w[cb], Wb[:, None, :], C,
                             lam=SINKHORN_LAM, n_iters=SINKHORN_ITERS)
    return lc._map_query_blocks(blk, (Dq, Q_w, cand), block_q)


def emd_cand_host(corpus: lc.Corpus, Q_ids, Q_w, cand, **_) -> np.ndarray:
    """Exact EMD per (query, candidate) pair, solved on the host:
    (nq, b) float64 scores. Zero-weight (padding) bins are stripped per
    pair before the LP; an all-padding row scores 0 (it carries no
    mass)."""
    coords = corpus.coords.cpu()
    ids, w = corpus.ids.cpu().numpy(), corpus.w.cpu().numpy()
    Q_ids = torch.as_tensor(Q_ids).cpu().numpy()
    Q_w = torch.as_tensor(Q_w).cpu().numpy()
    cand = torch.as_tensor(cand).cpu().numpy()
    nq, b = cand.shape
    out = np.zeros((nq, b))
    for u in range(nq):
        vq = Q_w[u] > 0.0
        if not vq.any():
            continue                                    # padding query
        qi = torch.from_numpy(Q_ids[u][vq]).long()
        D = pairwise_dist(coords, coords[qi], b_ids=qi).numpy()  # (v, h')
        for j in range(b):
            r = cand[u, j]
            vr = w[r] > 0.0
            if vr.any():
                out[u, j] = emd_exact(w[r][vr], Q_w[u][vq], D[ids[r][vr]])
    return out


RESCORERS: dict[str, Rescorer] = {
    "sinkhorn": Rescorer("sinkhorn", fn=sinkhorn_cand),
    "emd": Rescorer("emd", host_fn=emd_cand_host),
}


def names() -> tuple[str, ...]:
    """Every valid rescorer: registry methods with a candidate scorer plus
    the cascade-only measures above."""
    return tuple(sorted([m for m, s in METHODS.items()
                         if s.cand_fn is not None] + list(RESCORERS)))


def resolve(name: str) -> Rescorer:
    """Rescorer for ``name``; registry methods wrap their ``cand_fn``."""
    if name in RESCORERS:
        return RESCORERS[name]
    spec = METHODS.get(name)
    if spec is not None and spec.cand_fn is not None:
        return Rescorer(name, fn=spec.cand_fn)
    raise ValueError(f"unknown rescorer {name!r}; one of {sorted(names())}")
