"""Histogram construction (paper Section 6 preprocessing), as the JAX
package's ``core/histogram.py`` builds them: token-id documents ->
L1-normalized, truncated, padded histograms over a shared vocabulary;
greyscale images -> pixel histograms whose coordinates are the pixel
positions (Fig. 1). The corpora come back as CPU tensors."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.geometry import pairwise_dist
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


def images_to_corpus(images: np.ndarray, include_background: bool) -> Corpus:
    """Greyscale images (n, H, W) -> histograms with pixel-position coords.

    include_background=False drops zero pixels (sparse MNIST mode, Tab. 5);
    include_background=True keeps every pixel with a small floor weight so
    all supports fully overlap (the RWMD failure mode, Tab. 6).
    """
    n, H, W = images.shape
    v = H * W
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    coords = np.stack([yy.ravel(), xx.ravel()], axis=1).astype(np.float32)
    flat = images.reshape(n, v).astype(np.float64)
    if include_background:
        flat = flat + 1e-3 * flat.max()           # background floor -> dense
        ids = np.tile(np.arange(v, dtype=np.int32), (n, 1))
        w = (flat / flat.sum(axis=1, keepdims=True)).astype(np.float32)
    else:
        hmax = int((flat > 0).sum(axis=1).max())
        ids = np.zeros((n, hmax), dtype=np.int32)
        w = np.zeros((n, hmax), dtype=np.float32)
        for u in range(n):
            nz = np.nonzero(flat[u])[0]
            ids[u, :len(nz)] = nz
            w[u, :len(nz)] = flat[u, nz] / flat[u, nz].sum()
    return Corpus(ids=torch.from_numpy(ids), w=torch.from_numpy(w),
                  coords=torch.from_numpy(coords))


def pair_from_corpus(corpus: Corpus, a: int, b: int):
    """(p, q, C) of rows a and b: their weights and the (hmax, hmax) cost
    matrix between their bins, the dense per-pair view of the oracles; two
    bins of the same vocabulary id cost exactly 0. Costs between padding
    slots are raised to the largest real cost + 1:
    a zero-cost overlap with pad id 0 must not help."""
    w_a, w_b = corpus.w[a], corpus.w[b]
    ids_a, ids_b = corpus.ids[a].long(), corpus.ids[b].long()
    C = pairwise_dist(corpus.coords[ids_a], corpus.coords[ids_b],
                      a_ids=ids_a, b_ids=ids_b)
    valid = (w_a[:, None] > 0) & (w_b[None, :] > 0)
    C = torch.where(valid, C, torch.max(torch.where(valid, C, 0.0)) + 1.0)
    return w_a, w_b, C
