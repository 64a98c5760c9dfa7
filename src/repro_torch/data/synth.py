"""Synthetic corpora with the structure of the paper's two evaluation
domains: 20 Newsgroups-like text (sparse histograms over a large embedded
vocabulary) and MNIST-like images (pixel histograms over a 2-D grid, with
an optional background floor that makes them dense).

The same numpy draws, from the same seed, as the JAX package's
``data/synth.py``, so both packages see identical arrays. The corpora come
back as :class:`~repro_torch.core.lc.Corpus` of CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.histogram import docs_to_corpus, images_to_corpus
from repro_torch.core.lc import Corpus


def make_text_like(n_docs: int = 64, n_classes: int = 4, vocab: int = 512,
                   m: int = 32, doc_len: int = 60, hmax: int = 32,
                   seed: int = 0) -> tuple[Corpus, np.ndarray]:
    """Class-conditional sparse documents over an embedded vocabulary."""
    rng = np.random.default_rng(seed)
    coords = rng.normal(size=(vocab, m))
    coords /= np.linalg.norm(coords, axis=1, keepdims=True)  # word2vec-style L2
    # Each class owns a topic concentrated near a class anchor.
    anchors = rng.normal(size=(n_classes, m))
    anchors /= np.linalg.norm(anchors, axis=1, keepdims=True)
    topic_logits = 6.0 * (coords @ anchors.T)                 # (vocab, classes)
    topic_probs = np.exp(topic_logits - topic_logits.max(axis=0))
    topic_probs /= topic_probs.sum(axis=0)
    labels = rng.integers(0, n_classes, size=n_docs)
    docs = []
    for u in range(n_docs):
        mix = 0.85 * topic_probs[:, labels[u]] + 0.15 / vocab
        mix /= mix.sum()
        docs.append(rng.choice(vocab, size=doc_len, p=mix))
    return docs_to_corpus(docs, coords.astype(np.float32), hmax), labels


def make_clustered_text(n_docs: int, n_topics: int = 64, vocab: int = 2048,
                        m: int = 16, hmax: int = 32, zipf_a: float = 1.3,
                        min_len: int = 4, seed: int = 0,
                        shard_docs: int = 16384) -> tuple[Corpus, np.ndarray]:
    """Large-corpus generator: one-topic documents with Zipf lengths, built
    in shards of ``shard_docs`` rows (peak extra memory O(shard_docs x
    vocab) float64). A document's words are the top-``hmax`` of
    Gumbel-perturbed topic log-probabilities (``hmax`` distinct
    p-weighted draws), its length a clipped Zipf draw, its weights
    normalized exponentials over the first ``length`` slots."""
    if n_docs < 1 or not 1 <= min_len <= hmax:
        raise ValueError(f"need n_docs >= 1 and 1 <= min_len <= hmax, got "
                         f"{n_docs}/{min_len}/{hmax}")
    rng = np.random.default_rng(seed)
    coords = rng.normal(size=(vocab, m)).astype(np.float32)
    coords /= np.linalg.norm(coords, axis=1, keepdims=True)
    anchors = rng.normal(size=(n_topics, m))
    anchors /= np.linalg.norm(anchors, axis=1, keepdims=True)
    logits = 6.0 * (coords @ anchors.T)                # (vocab, n_topics)
    logp = logits - logits.max(axis=0)
    logp = (logp - np.log(np.exp(logp).sum(axis=0))).T  # (n_topics, vocab)
    labels = rng.integers(0, n_topics, size=n_docs)
    ids = np.zeros((n_docs, hmax), np.int32)
    w = np.zeros((n_docs, hmax), np.float32)
    for s in range(0, n_docs, shard_docs):
        e = min(s + shard_docs, n_docs)
        k = e - s
        scores = logp[labels[s:e]] + rng.gumbel(size=(k, vocab))
        # Descending perturbed score, so truncating to a doc's length keeps
        # a correctly distributed Gumbel-top-k sample.
        top = np.argpartition(scores, vocab - hmax, axis=1)[:, vocab - hmax:]
        order = np.argsort(-np.take_along_axis(scores, top, axis=1), axis=1)
        top = np.take_along_axis(top, order, axis=1)
        lens = np.clip(rng.zipf(zipf_a, size=k), min_len, hmax)
        live = np.arange(hmax)[None, :] < lens[:, None]
        wt = rng.exponential(size=(k, hmax)).astype(np.float32) * live
        wt /= wt.sum(axis=1, keepdims=True)
        ids[s:e] = np.where(live, top, 0)
        w[s:e] = wt
    return Corpus(ids=torch.from_numpy(ids), w=torch.from_numpy(w),
                  coords=torch.from_numpy(coords)), labels


def make_image_like(n_images: int = 64, n_classes: int = 4, side: int = 12,
                    include_background: bool = False,
                    seed: int = 0) -> tuple[Corpus, np.ndarray]:
    """Digit-like greyscale blobs: each class is a fixed pattern of three
    gaussian strokes with per-sample jitter, rendered on a side x side grid
    and thresholded at 5% of the image's maximum."""
    rng = np.random.default_rng(seed)
    protos = rng.uniform(1.5, side - 2.5, size=(n_classes, 3, 2))
    yy, xx = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    grid = np.stack([yy, xx], axis=-1).astype(np.float64)    # (side, side, 2)
    labels = rng.integers(0, n_classes, size=n_images)
    images = np.zeros((n_images, side, side))
    for u in range(n_images):
        centers = protos[labels[u]] + rng.normal(scale=0.6, size=(3, 2))
        for c in centers:
            images[u] += np.exp(-np.sum((grid - c) ** 2, axis=-1) / 2.0)
        images[u] *= images[u] > 0.05 * images[u].max()      # sparsify
    return images_to_corpus(images, include_background), labels
