"""IVF/LSH candidate source over WCD centroids.

At build time every corpus row's weighted centroid is quantized into one
of ``n_buckets`` coarse cells (a k-means codebook, classic IVF, or random
hyperplane signs, classic LSH), and the rows of each cell are packed into a
dense ``(n_buckets, cap)`` table. At query time the step computes the query
centroids, ranks the bucket centroids (an ``(nq, n_buckets)`` distance:
buckets, not rows) and gathers the rows of the ``probes`` nearest buckets;
every operation is a dense distance or gather over fixed-width tables, so
the traffic is proportional to ``probes * cap`` probed rows, never to the
corpus (the nearest-neighbour-search EMD approximation of Meng et al. 2024,
arXiv:2401.07378, on the WCD embedding).

The port's copy of the JAX package's ``candidates/centroid_lsh.py``: the
same build (numpy) and the same query step on tensors.

Not admissible: a true neighbour whose bucket is not probed is lost, so
cascades sourced here report measured recall.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.candidates.base import (EMPTY_CENTER, SourceSpec,
                                         SourceTables, as_tensor,
                                         center_dist, corpus_centroids,
                                         kmeans, pack_table,
                                         query_centroids, refine_by_centroid,
                                         register_source, slot_centroids)
from repro_torch.core import lc


@register_source
@dataclasses.dataclass(frozen=True)
class CentroidLSHSpec(SourceSpec):
    """Build parameters of the coarse centroid quantizer.

    quantizer:   ``kmeans`` (IVF codebook, data-dependent) or
                 ``hyperplane`` (sign-pattern LSH, data-independent;
                 ``n_buckets`` must then be a power of two, one bit per
                 hyperplane).
    n_buckets:   coarse cells; sqrt(n)-ish is the usual IVF point.
    probes:      buckets gathered per query, nearest centroid first.
    bucket_cap:  rows kept per bucket; ``None`` sizes the table to the
                 fullest bucket (lossless), an int drops overflow beyond it.
    refine:      optional exact-WCD refine: the source stores per-slot row
                 centroids and returns only the ``refine`` centroid-nearest
                 of the probed rows (IVF-flat), the reference cascade's
                 full-scan WCD stage restricted to probed rows.
    kmeans_iters/seed: quantizer fitting knobs.
    """

    kind = "centroid_lsh"
    admissible = False
    full_scan = False

    quantizer: str = "kmeans"
    n_buckets: int = 64
    probes: int = 8
    bucket_cap: int | None = None
    refine: int | None = None
    kmeans_iters: int = 4
    seed: int = 0

    def __post_init__(self) -> None:
        if self.quantizer not in ("kmeans", "hyperplane"):
            raise ValueError(f"unknown quantizer {self.quantizer!r}; "
                             "one of ('kmeans', 'hyperplane')")
        if self.n_buckets < 2 or self.probes < 1:
            raise ValueError("need n_buckets >= 2 and probes >= 1, got "
                             f"{self.n_buckets}/{self.probes}")
        if self.probes > self.n_buckets:
            raise ValueError(f"probes={self.probes} exceeds "
                             f"n_buckets={self.n_buckets}")
        if self.quantizer == "hyperplane" and \
                self.n_buckets & (self.n_buckets - 1):
            raise ValueError("hyperplane LSH needs a power-of-two "
                             f"n_buckets (one sign bit per plane), got "
                             f"{self.n_buckets}")
        if self.bucket_cap is not None and self.bucket_cap < 1:
            raise ValueError(f"bucket_cap must be >= 1 or None, got "
                             f"{self.bucket_cap}")
        if self.refine is not None:
            if self.refine < 1:
                raise ValueError(f"refine must be >= 1 or None, got "
                                 f"{self.refine}")
            if self.bucket_cap is not None and \
                    self.refine > self.probes * self.bucket_cap:
                raise ValueError(
                    f"refine={self.refine} exceeds the probed width "
                    f"probes*bucket_cap={self.probes * self.bucket_cap}")
        if self.kmeans_iters < 1:
            raise ValueError("kmeans_iters must be >= 1")

    @property
    def width(self) -> int | None:
        """Candidate columns the built source emits per query, when
        statically known (``None`` = known only after build)."""
        if self.refine is not None:
            return self.refine
        return None if self.bucket_cap is None \
            else self.probes * self.bucket_cap

    def build(self, corpus, *, n_valid: int | None = None):
        """Quantize the (real) corpus rows' centroids and pack the bucket
        table: host-side numpy, once, at ``EmdIndex.build``. The tables
        come back as CPU tensors."""
        rng = np.random.default_rng(self.seed)
        x = corpus_centroids(corpus, n_valid=n_valid)
        if self.quantizer == "kmeans":
            centers, assign = kmeans(x, self.n_buckets, self.kmeans_iters,
                                     rng)
        else:
            nbits = self.n_buckets.bit_length() - 1
            planes = rng.standard_normal((nbits,
                                          x.shape[1])).astype(np.float32)
            bits = (x @ planes.T) > 0.0
            assign = bits @ (1 << np.arange(nbits, dtype=np.int64))
            centers = np.full((self.n_buckets, x.shape[1]), EMPTY_CENTER,
                              np.float32)
        rows, mask, dropped = pack_table(assign, self.n_buckets,
                                         self.bucket_cap)
        # Empirical bucket centroids (the probe targets) for BOTH
        # quantizers; empty cells keep the far sentinel, probed last.
        counts = np.bincount(assign, minlength=self.n_buckets)
        sums = np.empty((self.n_buckets, x.shape[1]), np.float64)
        for j in range(x.shape[1]):
            sums[:, j] = np.bincount(assign, weights=x[:, j],
                                     minlength=self.n_buckets)
        live = counts > 0
        centers[live] = (sums[live] / counts[live, None]).astype(np.float32)
        centers[~live] = EMPTY_CENTER
        if self.refine is not None and \
                self.refine > self.probes * rows.shape[1]:
            raise ValueError(
                f"refine={self.refine} exceeds the probed width "
                f"probes*cap={self.probes * rows.shape[1]} of the built "
                "table")
        leaves = (centers, rows, mask)
        if self.refine is not None:
            leaves += (slot_centroids(x, rows, mask),)
        return dataclasses.replace(self.wrap(leaves), dropped_rows=dropped)

    def wrap(self, leaves):
        if self.refine is not None:
            centroids, rows, mask, cents = leaves
        else:
            (centroids, rows, mask), cents = leaves, None
        return CentroidLSHSource(
            spec=self, centroids=as_tensor(centroids, torch.float32),
            rows=as_tensor(rows, torch.int32),
            mask=as_tensor(mask, torch.bool),
            cents=as_tensor(cents, torch.float32))

    def describe(self) -> str:
        cap = "max" if self.bucket_cap is None else self.bucket_cap
        ref = "" if self.refine is None else f" r{self.refine}"
        return (f"centroid_lsh[{self.quantizer} b{self.n_buckets} "
                f"p{self.probes} cap{cap}{ref}]")


@dataclasses.dataclass(frozen=True)
class CentroidLSHSource(SourceTables):
    """Built IVF/LSH index: bucket centroids + dense row table."""

    spec: CentroidLSHSpec
    centroids: torch.Tensor             # (n_buckets, m) float32
    rows: torch.Tensor                  # (n_buckets, cap) int32 row ids
    mask: torch.Tensor                  # (n_buckets, cap) validity
    cents: torch.Tensor | None = None   # (n_buckets, cap, m) refine table
    dropped_rows: int = 0               # overflow beyond an explicit cap

    _FIELDS = ("centroids", "rows", "mask", "cents")

    @property
    def width(self) -> int:
        if self.spec.refine is not None:
            return self.spec.refine
        return self.spec.probes * self.rows.shape[1]

    def candidates(self, corpus, q_ids, q_w, budget: int | None = None):
        """(nq, width) candidate row ids (int32) + validity mask: nearest
        probed bucket first, or ascending exact centroid distance under
        ``refine``; ``budget`` truncates to the best-ranked columns. Every
        shape is fixed by the spec; the data touched scales with probed
        rows."""
        qc = query_centroids(corpus, q_ids, q_w)
        d = center_dist(self.centroids, qc)
        _, probe = lc.streaming_smallest_k(d, self.spec.probes)
        probe = probe.long()
        nq = q_ids.shape[0]
        rows = self.rows[probe].reshape(nq, -1)
        mask = self.mask[probe].reshape(nq, -1)
        if self.spec.refine is not None:
            cents = self.cents[probe].reshape(nq, rows.shape[1], -1)
            rows, mask = refine_by_centroid(qc, rows, mask, cents,
                                            self.spec.refine)
        if budget is not None and budget < rows.shape[1]:
            rows, mask = rows[:, :budget], mask[:, :budget]
        return rows, mask
