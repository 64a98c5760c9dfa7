"""The candidate-source protocol: pluggable cascade stage 0.

A cascade whose stage 1 scores the whole corpus costs O(n) per query
whatever its ladder. A candidate source is a build-time index over the
corpus (host-side numpy, once, at ``EmdIndex.build``) plus a query step
``candidates(corpus, q_ids, q_w, budget) -> (ids, mask)`` that emits each
query's candidate rows with traffic proportional to the rows it PROBES.
The cascade's stage 1 then scores only those rows through the candidate
engines (``retrieval.cand_scores``).

Two halves, as in the JAX package's ``candidates/base.py``:

* a **SourceSpec**, a frozen, hashable dataclass of build parameters
  (``FullScanSpec``, ``CentroidLSHSpec``, ``ClusterTreeSpec``). It rides in
  ``CascadeSpec.source`` and JSON-round-trips through the serving
  snapshot's config codec. ``spec.build(corpus)`` produces
* a **source**: the spec plus its built tables as tensors. ``leaves()``
  lists the tables in the JAX source's pytree leaf order (``None`` left
  out), which is the order a serving snapshot stores them in (``source/0``,
  ``source/1``, ...), and ``spec.wrap(leaves)`` reassembles the source from
  them, numpy arrays or tensors. ``to(device)`` moves the tables.

Admissibility: only the full scan sees every row, so only ``FullScanSpec``
is admissible. Any sublinear source can miss a true neighbour, which
forces the owning ``CascadeSpec.admissible`` to False and the recall to be
measured, never assumed.

The build helpers are the JAX package's numpy code, copied (this package
imports nothing of it); :func:`corpus_centroids` picks a block that keeps
its gather near 1 GB (below). The query step runs on tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import lc, retrieval

#: Sentinel coordinate of empty buckets / empty tree nodes: their distance
#: to any real query centroid overflows, so they are probed only after
#: every non-empty bucket (and their candidate slots are masked anyway).
EMPTY_CENTER = 1e30

#: Registered source-spec classes by ``kind`` (filled by the concrete
#: modules at import; ``CascadeSpec.source`` accepts these names).
SOURCES: dict[str, type] = {}

#: Bytes of the (block, hmax, m) float32 coordinate gather of
#: :func:`corpus_centroids`. The JAX package gathers 131,072 rows at once,
#: 11.3 GB for the whole 20 Newsgroups corpus (hmax 500, m 300); each row's
#: centroid is its own product, so the block changes no bit of it.
CENTROID_GATHER_BYTES = 1 << 30


def register_source(cls):
    """Class decorator: register a SourceSpec subclass under its ``kind``
    and return it unchanged."""
    SOURCES[cls.kind] = cls
    return cls


def resolve_source(spec):
    """A SourceSpec passes through; a string resolves to its registered
    spec class built with defaults (``"centroid_lsh"`` etc.)."""
    if isinstance(spec, SourceSpec):
        return spec
    if isinstance(spec, str):
        if spec not in SOURCES:
            raise ValueError(f"unknown candidate source {spec!r}; "
                             f"registered: {sorted(SOURCES)}")
        return SOURCES[spec]()
    raise TypeError(f"expected a SourceSpec or a registered source name, "
                    f"got {type(spec).__name__}")


@dataclasses.dataclass(frozen=True)
class SourceSpec:
    """Base class of the frozen build-parameter dataclasses. Concrete
    subclasses set the class attributes and implement :meth:`build` and
    :meth:`wrap`."""

    #: registry key (``CascadeSpec.source`` accepts it as a string).
    kind = "abstract"
    #: True only for the full scan: every row is a candidate, so an
    #: otherwise-admissible cascade keeps its exact-top-l guarantee.
    admissible = False
    #: True when the cascade driver should run the original full-corpus
    #: stage-1 path instead of candidate compaction.
    full_scan = False

    def build(self, corpus, *, n_valid: int | None = None):
        """Build the index state over ``corpus`` (host-side numpy; rows
        at index >= ``n_valid`` are padding and never enter a bucket)."""
        raise NotImplementedError

    def state_structs(self, m: int) -> tuple:
        """The static checkers' shapes of the state arrays (the JAX
        package traces its hazard and precision passes against them). Not
        yet ported: those passes are ROADMAP Queue 1 item 7 (the port's
        collectives pass runs built sources)."""
        raise ValueError(
            "SourceSpec.state_structs is not yet ported: it serves the "
            "hazards and precision passes (ROADMAP Queue 1 item 7)")

    def wrap(self, leaves):
        """Reassemble the built source from its state arrays (numpy arrays
        or tensors), in :meth:`leaves` order."""
        raise NotImplementedError

    def describe(self) -> str:
        return self.kind


class SourceTables:
    """Mixin of the built sources (frozen dataclasses): their state tables
    are the fields named in ``_FIELDS``, in the JAX source's pytree leaf
    order; a ``None`` table (no refine) is no leaf."""

    _FIELDS: tuple[str, ...] = ()

    def leaves(self) -> tuple[torch.Tensor, ...]:
        """The state tables, what a serving snapshot stores as
        ``source/0``, ``source/1``, ... and ``spec.wrap`` takes back."""
        return tuple(t for t in (getattr(self, f) for f in self._FIELDS)
                     if t is not None)

    def to(self, device):
        """The same source with its tables on ``device``."""
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in self._FIELDS
                     if getattr(self, f) is not None})


# --------------------------------------------------------------------------
# Host-side build helpers (numpy, shared by the concrete sources).
# --------------------------------------------------------------------------


def host_array(x) -> np.ndarray:
    """A numpy view of a corpus field: a tensor on any device, or an
    array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def centroid_block(hmax: int, m: int) -> int:
    """Rows per block of :func:`corpus_centroids`: the (block, hmax, m)
    float32 gather stays under :data:`CENTROID_GATHER_BYTES`."""
    return max(1, CENTROID_GATHER_BYTES // (4 * hmax * m))


def corpus_centroids(corpus, *, n_valid: int | None = None,
                     block: int | None = None) -> np.ndarray:
    """(n, m) float32 WCD centroid of every real corpus row, computed in
    ``block``-row shards (default :func:`centroid_block`) so the
    (n, hmax, m) gather never materializes."""
    ids = host_array(corpus.ids)
    w = host_array(corpus.w)
    coords = host_array(corpus.coords).astype(np.float32, copy=False)
    n = ids.shape[0] if n_valid is None else min(n_valid, ids.shape[0])
    m = coords.shape[1]
    block = centroid_block(ids.shape[1], m) if block is None else block
    out = np.empty((n, m), np.float32)
    for s in range(0, n, block):
        e = min(s + block, n)
        out[s:e] = np.einsum("bh,bhm->bm", w[s:e].astype(np.float32),
                             coords[ids[s:e]], optimize=True)
    return out


def kmeans(x: np.ndarray, k: int, iters: int, rng: np.random.Generator,
           *, block: int = 131072) -> tuple[np.ndarray, np.ndarray]:
    """Blocked Lloyd k-means: (k, m) float32 centers + (n,) assignment.

    Assignment passes stream ``block`` rows at a time (the distance matrix
    never exceeds block x k), center updates are per-dimension bincounts,
    and empty clusters reseed to random points."""
    n, m = x.shape
    x = np.ascontiguousarray(x, np.float32)
    if n == 0:
        return np.full((k, m), EMPTY_CENTER, np.float32), \
            np.zeros((0,), np.int64)
    init = rng.choice(n, size=min(k, n), replace=False)
    c = x[init].copy()
    if len(init) < k:                      # fewer points than centers
        c = np.concatenate([c, x[rng.integers(0, n, k - len(init))]])
    assign = np.zeros(n, np.int64)

    def assign_pass():
        c2 = 0.5 * (c * c).sum(axis=1)
        for s in range(0, n, block):
            e = min(s + block, n)
            # argmin of ||x-c||^2 == argmin of c.c/2 - x.c (x^2 constant)
            assign[s:e] = np.argmin(c2[None, :] - x[s:e] @ c.T, axis=1)

    for _ in range(max(iters, 1)):
        assign_pass()
        counts = np.bincount(assign, minlength=k)
        sums = np.empty((k, m), np.float64)
        for j in range(m):
            sums[:, j] = np.bincount(assign, weights=x[:, j], minlength=k)
        live = counts > 0
        c[live] = (sums[live] / counts[live, None]).astype(np.float32)
        dead = int((~live).sum())
        if dead:
            c[~live] = x[rng.integers(0, n, dead)]
    assign_pass()                          # final labels match centers
    return c, assign


def pack_table(assign: np.ndarray, n_buckets: int, cap: int | None,
               ) -> tuple[np.ndarray, np.ndarray, int]:
    """Dense (n_buckets, cap) row table + validity mask from a bucket
    assignment. ``cap=None`` sizes to the fullest bucket (lossless); an
    explicit cap keeps each bucket's FIRST ``cap`` rows (assignment order)
    and reports the overflow drop count. Unused slots hold row 0, masked."""
    n = assign.shape[0]
    order = np.argsort(assign, kind="stable")
    sorted_a = assign[order]
    counts = np.bincount(assign, minlength=n_buckets)
    starts = np.zeros(n_buckets + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    within = np.arange(n, dtype=np.int64) - starts[sorted_a]
    cap_eff = max(int(counts.max()) if cap is None else int(cap), 1)
    keep = within < cap_eff
    rows = np.zeros((n_buckets, cap_eff), np.int32)
    mask = np.zeros((n_buckets, cap_eff), bool)
    rows[sorted_a[keep], within[keep]] = order[keep].astype(np.int32)
    mask[sorted_a[keep], within[keep]] = True
    return rows, mask, int(n - keep.sum())


def slot_centroids(x: np.ndarray, rows: np.ndarray, mask: np.ndarray,
                   ) -> np.ndarray:
    """(n_buckets, cap, m) float32 per-slot row centroids matching a
    :func:`pack_table` layout: the exact-WCD refine table. Dead slots are
    zero; the query-side refine masks them before ranking."""
    return (x[rows] * mask[..., None]).astype(np.float32)


def as_tensor(x, dtype: torch.dtype) -> torch.Tensor | None:
    """A state table as a tensor of ``dtype`` (``None`` stays ``None``)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.tensor(np.asarray(x), dtype=dtype)


# --------------------------------------------------------------------------
# Query-side helpers (tensors).
# --------------------------------------------------------------------------


def query_centroids(corpus, q_ids: torch.Tensor,
                    q_w: torch.Tensor) -> torch.Tensor:
    """(nq, m) WCD centroids of a query batch."""
    return torch.einsum("qh,qhm->qm", q_w, corpus.coords[q_ids.long()])


def center_dist(centers: torch.Tensor, qc: torch.Tensor) -> torch.Tensor:
    """(nq, c) distance of each query centroid to ``centers`` (c, m) or
    per-query centers (nq, c, m), with ``EMPTY_CENTER`` distances clamped
    to 0.5 * PAD_DIST. Unclamped they overflow to +inf, above the
    min-extraction's sentinel, which would then pick a winner again
    (duplicate probes); clamped below it, empty centers rank last and stay
    distinct."""
    d = torch.linalg.vector_norm(centers - qc[:, None, :], dim=-1)
    return torch.clamp(d, max=0.5 * lc.PAD_DIST)


def refine_by_centroid(qc, rows, mask, cents, k: int):
    """Exact-WCD refine of gathered candidates: rank the (nq, W) probed
    rows by true centroid distance (``cents`` is their (nq, W, m) slot
    centroid gather) and keep the smallest ``k``: the reference cascade's
    full-scan WCD stage, restricted to probed rows. Returned columns are in
    ascending distance, the lowest column first among ties (JAX's
    ``lax.top_k`` of the negated distances), so any later budget truncation
    keeps the best."""
    d = torch.linalg.vector_norm(cents - qc[:, None, :], dim=-1)
    d = torch.where(mask, d, lc.PAD_DIST)
    _, pos = retrieval.top_l_smallest(d, k)
    return torch.gather(rows, 1, pos), torch.gather(mask, 1, pos)
