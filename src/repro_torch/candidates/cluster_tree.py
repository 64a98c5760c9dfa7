"""Hierarchical k-means tree source with triangle-inequality pruning.

The data-dependent cluster-tree idea of Ding et al. 2020 (arXiv:2002.12354)
on WCD centroids: a ``branching``-ary tree of ``depth`` levels is fit by
recursive k-means at build time; each node stores its center and its RADIUS
(max member distance), so at query time ``max(d(q, center) - radius, 0)``
lower-bounds, by the triangle inequality, the distance to EVERY row under
the node: the pruning signal a beam descent keeps the ``beam`` most
promising nodes by.

The tree is flattened to fixed-depth arrays (a heap-layout node table, one
dense leaf-row table), so the descent is a loop over levels of fixed-shape
gathers (the JAX package's ``lax.scan``), touching ``beam * branching``
nodes per level plus ``probes * leaf_cap`` leaf rows, never the corpus.

The port's copy of the JAX package's ``candidates/cluster_tree.py``.

Not admissible (a pruned subtree can hide a true neighbour), so sourced
cascades report measured recall.
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


def _level_offset(branching: int, level: int) -> int:
    """Start index of 1-indexed ``level`` in the heap-flat node table
    (levels 1..depth stored contiguously; the root is implicit)."""
    return sum(branching ** j for j in range(1, level))


@register_source
@dataclasses.dataclass(frozen=True)
class ClusterTreeSpec(SourceSpec):
    """Build parameters of the cluster tree.

    branching/depth: tree shape, ``branching ** depth`` leaves.
    beam:            nodes kept per level during descent (<= branching, so
                     the frontier width is constant across levels).
    probes:          leaves whose rows are gathered (<= beam).
    leaf_cap:        rows kept per leaf; ``None`` = fullest leaf
                     (lossless).
    refine:          optional exact-WCD refine: keep only the ``refine``
                     centroid-nearest of the probed leaf rows (see
                     ``CentroidLSHSpec.refine``).
    kmeans_iters/seed: per-node k-means fitting knobs.
    """

    kind = "cluster_tree"
    admissible = False
    full_scan = False

    branching: int = 8
    depth: int = 2
    beam: int = 4
    probes: int = 4
    leaf_cap: int | None = None
    refine: int | None = None
    kmeans_iters: int = 4
    seed: int = 0

    def __post_init__(self) -> None:
        if self.branching < 2 or self.depth < 1:
            raise ValueError("need branching >= 2 and depth >= 1, got "
                             f"{self.branching}/{self.depth}")
        if not 1 <= self.beam <= self.branching:
            raise ValueError(
                f"beam must be in [1, branching={self.branching}] (the "
                f"descent frontier has constant width), got {self.beam}")
        if not 1 <= self.probes <= self.beam:
            raise ValueError(f"probes must be in [1, beam={self.beam}], "
                             f"got {self.probes}")
        if self.leaf_cap is not None and self.leaf_cap < 1:
            raise ValueError(f"leaf_cap must be >= 1 or None, got "
                             f"{self.leaf_cap}")
        if self.refine is not None:
            if self.refine < 1:
                raise ValueError(f"refine must be >= 1 or None, got "
                                 f"{self.refine}")
            if self.leaf_cap is not None and \
                    self.refine > self.probes * self.leaf_cap:
                raise ValueError(
                    f"refine={self.refine} exceeds the probed width "
                    f"probes*leaf_cap={self.probes * self.leaf_cap}")
        if self.kmeans_iters < 1:
            raise ValueError("kmeans_iters must be >= 1")

    @property
    def n_leaves(self) -> int:
        return self.branching ** self.depth

    @property
    def n_nodes(self) -> int:
        return _level_offset(self.branching, self.depth + 1)

    @property
    def width(self) -> int | None:
        if self.refine is not None:
            return self.refine
        return None if self.leaf_cap is None \
            else self.probes * self.leaf_cap

    def build(self, corpus, *, n_valid: int | None = None):
        """Recursive k-means over the row centroids, flattened level by
        level; radii are exact member maxima, so the descent's
        triangle-inequality bound is sound by construction. The tables come
        back as CPU tensors."""
        rng = np.random.default_rng(self.seed)
        x = corpus_centroids(corpus, n_valid=n_valid)
        B = self.branching
        nodes = np.full((self.n_nodes, x.shape[1]), EMPTY_CENTER,
                        np.float32)
        radii = np.zeros(self.n_nodes, np.float32)
        parent = np.zeros(x.shape[0], np.int64)
        for level in range(1, self.depth + 1):
            off = _level_offset(B, level)
            child = np.zeros(x.shape[0], np.int64)
            for p in range(B ** (level - 1)):
                member = np.nonzero(parent == p)[0]
                if member.size == 0:
                    continue                 # whole subtree stays empty
                c, a = kmeans(x[member], B, self.kmeans_iters, rng)
                counts = np.bincount(a, minlength=B)
                c[counts == 0] = EMPTY_CENTER
                nodes[off + p * B:off + (p + 1) * B] = c
                child[member] = p * B + a
                dist = np.linalg.norm(x[member] - c[a], axis=1)
                np.maximum.at(radii, off + p * B + a, dist)
            parent = child
        rows, mask, dropped = pack_table(parent, self.n_leaves,
                                         self.leaf_cap)
        if self.refine is not None and \
                self.refine > self.probes * rows.shape[1]:
            raise ValueError(
                f"refine={self.refine} exceeds the probed width "
                f"probes*cap={self.probes * rows.shape[1]} of the built "
                "table")
        leaves = (nodes, radii, rows, mask)
        if self.refine is not None:
            leaves += (slot_centroids(x, rows, mask),)
        return dataclasses.replace(self.wrap(leaves), dropped_rows=dropped)

    def wrap(self, leaves):
        if self.refine is not None:
            nodes, radii, rows, mask, cents = leaves
        else:
            (nodes, radii, rows, mask), cents = leaves, None
        return ClusterTreeSource(
            spec=self, nodes=as_tensor(nodes, torch.float32),
            radii=as_tensor(radii, torch.float32),
            rows=as_tensor(rows, torch.int32),
            mask=as_tensor(mask, torch.bool),
            cents=as_tensor(cents, torch.float32))

    def describe(self) -> str:
        cap = "max" if self.leaf_cap is None else self.leaf_cap
        ref = "" if self.refine is None else f" r{self.refine}"
        return (f"cluster_tree[b{self.branching}^d{self.depth} "
                f"beam{self.beam} p{self.probes} cap{cap}{ref}]")


@dataclasses.dataclass(frozen=True)
class ClusterTreeSource(SourceTables):
    """Built tree: heap-flat node centers/radii + dense leaf-row table."""

    spec: ClusterTreeSpec
    nodes: torch.Tensor                 # (n_nodes, m) float32 centers
    radii: torch.Tensor                 # (n_nodes,) float32 max member dist
    rows: torch.Tensor                  # (n_leaves, cap) int32 row ids
    mask: torch.Tensor                  # (n_leaves, cap) validity
    cents: torch.Tensor | None = None   # (n_leaves, cap, m) refine table
    dropped_rows: int = 0

    _FIELDS = ("nodes", "radii", "rows", "mask", "cents")

    @property
    def width(self) -> int:
        if self.spec.refine is not None:
            return self.spec.refine
        return self.spec.probes * self.rows.shape[1]

    def _bound(self, qc, node_ids):
        """Triangle-inequality descent key ``d(q, center) - radius``.
        Clamped at zero it lower-bounds the centroid distance from the
        query to ANY row under the node; the beam ranks by the UNCLAMPED
        value, so overlapping balls (where every clamped bound ties at 0)
        still order by how deep inside each ball the query sits."""
        return center_dist(self.nodes[node_ids], qc) - self.radii[node_ids]

    def candidates(self, corpus, q_ids, q_w, budget: int | None = None):
        """Beam descent, one level at a time, then a gather of the
        ``probes`` best leaves' rows. ``budget`` truncates to the
        best-ranked columns."""
        spec, B = self.spec, self.spec.branching
        qc = query_centroids(corpus, q_ids, q_w)
        nq = q_ids.shape[0]
        arange_b = torch.arange(B, device=qc.device)
        # Level 1: score all B children of the (implicit) root.
        lb = self._bound(qc, arange_b.expand(nq, B))
        _, ids = lc.streaming_smallest_k(lb, spec.beam)
        ids = ids.long()                     # absolute: level-1 offset is 0
        for lv in range(2, spec.depth + 1):
            rel = ids - _level_offset(B, lv - 1)
            child = (_level_offset(B, lv) + rel[:, :, None] * B
                     + arange_b).reshape(nq, -1)
            _, pos = lc.streaming_smallest_k(self._bound(qc, child),
                                             spec.beam)
            ids = torch.gather(child, 1, pos.long())
        leaf = ids[:, :spec.probes] - _level_offset(B, spec.depth)
        rows = self.rows[leaf].reshape(nq, -1)
        mask = self.mask[leaf].reshape(nq, -1)
        if spec.refine is not None:
            cents = self.cents[leaf].reshape(nq, rows.shape[1], -1)
            rows, mask = refine_by_centroid(qc, rows, mask, cents,
                                            spec.refine)
        if budget is not None and budget < rows.shape[1]:
            rows, mask = rows[:, :budget], mask[:, :budget]
        return rows, mask
