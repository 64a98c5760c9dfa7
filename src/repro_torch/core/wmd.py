"""WMD baseline: exact-EMD nearest-neighbour search with RWMD pruning, the
port's own copy of the JAX package's ``core/wmd.py``.

The method the paper is 10^4x faster than (Kusner et al. 2015 with the
prefetch-and-prune trick): LC-RWMD lower bounds for the whole corpus
(``lc.lc_rwmd_scores``, on the corpus's device: through the ``dist_topk``
kernel on a card, its plain version on the CPU), then the exact
transportation LP (``core/emd.emd_exact``, on the host) for the most
promising candidates only, stopping once the next lower bound reaches the
current top-l threshold. It is the accuracy and runtime reference, not a
serving path.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.emd import emd_exact
from repro_torch.core.histogram import pair_from_corpus
from repro_torch.core.lc import Corpus, lc_rwmd_scores


def wmd_search(corpus: Corpus, q_index: int, top_l: int,
               prune_factor: int = 4) -> tuple[np.ndarray, np.ndarray]:
    """(exact distances, row ids) of the ``top_l`` rows nearest to
    ``corpus`` row ``q_index`` under exact EMD, ascending (the query row
    itself excluded).

    prune_factor: how many RWMD-ranked candidates to solve exactly, as a
    multiple of top_l (the paper's pruning: a lower bound at or above the
    current top_l-th exact distance cannot enter the top-l)."""
    lb = lc_rwmd_scores(corpus, corpus.ids[q_index], corpus.w[q_index],
                        use_kernels=True).cpu().numpy()
    lb[q_index] = np.inf                      # exclude self
    order = np.argsort(lb, kind="stable")
    exact: dict[int, float] = {}
    threshold = np.inf
    for rank, u in enumerate(order):
        if lb[u] >= threshold and len(exact) >= top_l:
            break                             # the bound prunes the rest
        if rank >= prune_factor * top_l and len(exact) >= top_l:
            break
        p, q, C = (t.cpu().numpy() for t in pair_from_corpus(
            corpus, int(u), q_index))
        keep_p, keep_q = p > 0, q > 0
        exact[int(u)] = emd_exact(p[keep_p], q[keep_q],
                                  C[np.ix_(keep_p, keep_q)])
        if len(exact) >= top_l:
            threshold = sorted(exact.values())[top_l - 1]
    items = sorted(exact.items(), key=lambda kv: kv[1])[:top_l]
    return (np.asarray([d for _, d in items]),
            np.asarray([u for u, _ in items]))


def wmd_all_pairs_precision(corpus: Corpus, labels: np.ndarray, top_l: int,
                            n_queries: int | None = None,
                            prune_factor: int = 4) -> float:
    """precision@top-l of exact-EMD search over the corpus, or over its
    first ``n_queries`` rows (the paper does the same to keep the WMD
    benchmark tractable)."""
    n = corpus.n if n_queries is None else min(n_queries, corpus.n)
    hits = []
    for qi in range(n):
        _, idx = wmd_search(corpus, qi, top_l, prune_factor)
        hits.append(np.mean(labels[idx] == labels[qi]))
    return float(np.mean(hits))
