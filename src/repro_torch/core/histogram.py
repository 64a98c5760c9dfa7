"""Histogram construction (paper Section 6 preprocessing): token-id
documents -> L1-normalized, truncated, padded histograms over a shared
vocabulary, as the JAX package's ``core/histogram.py`` builds them."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lc import Corpus


def docs_to_corpus(docs: list[list[int]], coords: np.ndarray,
                   hmax: int) -> Corpus:
    """Token-id documents -> padded Corpus (CPU tensors), keeping each
    document's ``hmax`` most frequent bins, then L1-normalizing."""
    n = len(docs)
    ids = np.zeros((n, hmax), dtype=np.int32)
    w = np.zeros((n, hmax), dtype=np.float32)
    for u, doc in enumerate(docs):
        uniq, counts = np.unique(np.asarray(doc, dtype=np.int64),
                                 return_counts=True)
        if len(uniq) > hmax:                      # keep most-frequent hmax
            keep = np.argsort(-counts, kind="stable")[:hmax]
            uniq, counts = uniq[keep], counts[keep]
        h = len(uniq)
        ids[u, :h] = uniq
        w[u, :h] = counts / counts.sum()
    return Corpus(ids=torch.from_numpy(ids), w=torch.from_numpy(w),
                  coords=torch.from_numpy(np.asarray(coords, np.float32)))
