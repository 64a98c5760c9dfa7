"""Top-l nearest-neighbour retrieval on the LC engines, through a typed
method registry.

The JAX package's ``core/retrieval.py``: ``METHODS`` holds a
:class:`MethodSpec` for each of the seven JAX methods (act, rwmd, rwmd_rev,
omr, ict, bow, wcd) with its single-query, batched and
candidate-compacted scorers. ``query_scores`` dispatches one query through
``METHODS[method].fn`` (the full-precision oracle), ``batch_scores`` a
batch through ``batch_fn`` (or, for the symmetric measure, through
``symmetric_batch_fn`` or both directions), with ``engine="dist"`` through
the same scorers on a rank's shards, or with ``engine="scan"`` through a
loop of ``query_scores``; ``cand_scores`` through ``cand_fn``;
``search`` and ``top_l_smallest`` match ``lax.top_k`` on the negated
scores (ascending scores, the lowest index first among ties).

The paper's evaluation harness (Section 6) is here too: every corpus row
is a query against the whole corpus (``all_pairs_scores``, in chunks of
queries), and ``precision_at_l`` is the fraction of each row's top-l
neighbours, self excluded, that share its label; ``recall_at_l`` the
agreement of two rankings.

Every scorer takes the uniform keyword set ``iters``, ``use_kernels``,
``block_q``, ``precision`` and ``mesh`` and ignores the ones it does not
use. On a mesh (``launch.mesh.Mesh``) a scorer is given the rank's shards
(its queries, its corpus rows) and returns the rank's block.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.core import lc


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """Typed registry entry for one scoring method.

    name:        registry key (``EngineConfig.method`` value).
    paper_name:  the paper's name for the measure.
    symmetric:   True if the measure is symmetric in (query, db) (BoW, WCD).
    uses_iters:  True if ``iters`` changes the result (LC-ACT only).
    supports_kernels: True if ``use_kernels=True`` routes the full-corpus
                 engine through the CUDA kernels.
    reverse:     registry name of the opposite-direction bound, if any
                 (rwmd <-> rwmd_rev).
    fn:          one (h,) query -> (n,) scores, always float32; under
                 ``use_kernels`` act, rwmd and omr take the ``dist_topk``
                 kernel at nq=1, then act the fused-gather ``act_phase2``
                 at nq=1, rwmd and omr ``cand_pour``'s all-rows form.
    batch_fn:    (nq, h) queries -> (nq, n) scores.
    symmetric_batch_fn: the symmetric measure (max of both directions) of
                 a reverse-linked pair, sharing work between the two:
                 rwmd/rwmd_rev read one stacked Phase-1 distance tensor.
                 ``batch_scores`` takes it on the reference path only.
    cand_fn:     (nq, h) queries and (nq, b) candidate row ids -> (nq, b)
                 scores at those rows (Phase 1 unchanged, Phase 2/3
                 gather-compacted); for the five LC methods
                 ``use_kernels=True`` sends the gather and reduction to
                 the ``cand_pour`` / ``cand_dist`` kernels. The bow and wcd
                 baselines have no kernel and ignore the flag.
    dist_out:    the axes that split the (nq, n) score matrix's two dims
                 on the mesh (``"data"``, ``"model"`` or None for
                 replicated): the step gathers the rank's block over them.
    """
    name: str
    paper_name: str
    symmetric: bool = False
    uses_iters: bool = False
    supports_kernels: bool = False
    reverse: str | None = None
    fn: Callable | None = None
    batch_fn: Callable | None = None
    symmetric_batch_fn: Callable | None = None
    cand_fn: Callable | None = None
    dist_out: tuple = ("data", "model")


# The engines below take the kernels' tile knobs as keywords: block_v and
# block_h tile K1 (``dist_topk``), block_n the Phase-2/3 kernel each engine
# launches; rev_block is the reverse reference scorer's row block (JAX's
# ``_STATIC_KW``). None is the kernel's default tile; no knob changes a
# score.
_K1 = ("block_v", "block_h")
_ALL = ("block_v", "block_h", "block_n", "mesh")


def _tiles(kw, names):
    return {k: kw[k] for k in names if k in kw}


def _act(corpus, q_ids, q_w, *, iters=1, use_kernels=False, **kw):
    return lc.lc_act_scores(corpus, q_ids, q_w, iters=iters,
                            use_kernels=use_kernels, **_tiles(kw, _K1))


def _act_batch(corpus, q_ids, q_w, *, iters=1, use_kernels=False,
               block_q=8, precision="f32", **kw):
    return lc.lc_act_scores_batched(corpus, q_ids, q_w, iters=iters,
                                    use_kernels=use_kernels, block_q=block_q,
                                    precision=precision, **_tiles(kw, _ALL))


def _act_cand(corpus, q_ids, q_w, cand, *, iters=1, use_kernels=False,
              block_q=8, precision="f32", **kw):
    return lc.lc_act_scores_cand(corpus, q_ids, q_w, cand, iters=iters,
                                 use_kernels=use_kernels, block_q=block_q,
                                 precision=precision, **_tiles(kw, _ALL))


def _rwmd(corpus, q_ids, q_w, *, use_kernels=False, **kw):
    return lc.lc_rwmd_scores(corpus, q_ids, q_w, use_kernels=use_kernels,
                             **_tiles(kw, _K1))


def _rwmd_rev(corpus, q_ids, q_w, *, rev_block=256, **_):
    return lc.lc_rwmd_scores_rev(corpus, q_ids, q_w, block=rev_block)


def _rwmd_batch(corpus, q_ids, q_w, *, use_kernels=False, block_q=8,
                precision="f32", **kw):
    return lc.lc_rwmd_scores_batched(corpus, q_ids, q_w,
                                     use_kernels=use_kernels,
                                     block_q=block_q, precision=precision,
                                     **_tiles(kw, _ALL))


def _rwmd_cand(corpus, q_ids, q_w, cand, *, use_kernels=False, block_q=8,
               precision="f32", **kw):
    return lc.lc_rwmd_scores_cand(corpus, q_ids, q_w, cand,
                                  use_kernels=use_kernels, block_q=block_q,
                                  precision=precision, **_tiles(kw, _ALL))


def _rwmd_rev_batch(corpus, q_ids, q_w, *, use_kernels=False, block_q=8,
                    precision="f32", rev_block=256, **kw):
    return lc.lc_rwmd_scores_rev_batched(corpus, q_ids, q_w,
                                         block=rev_block, block_q=block_q,
                                         precision=precision,
                                         use_kernels=use_kernels,
                                         **_tiles(kw, ("block_n",)))


def _rwmd_symmetric_batch(corpus, q_ids, q_w, *, block_q=8, precision="f32",
                          rev_block=256, **_):
    return lc.lc_rwmd_symmetric_scores_batched(corpus, q_ids, q_w,
                                               block=rev_block,
                                               block_q=block_q,
                                               precision=precision)


def _rwmd_rev_cand(corpus, q_ids, q_w, cand, *, use_kernels=False,
                   block_q=8, precision="f32", **kw):
    return lc.lc_rwmd_scores_rev_cand(corpus, q_ids, q_w, cand,
                                      use_kernels=use_kernels,
                                      block_q=block_q, precision=precision,
                                      **_tiles(kw, ("block_n",)))


def _omr(corpus, q_ids, q_w, *, use_kernels=False, **kw):
    return lc.lc_omr_scores(corpus, q_ids, q_w, use_kernels=use_kernels,
                            **_tiles(kw, _K1))


def _omr_batch(corpus, q_ids, q_w, *, use_kernels=False, block_q=8,
               precision="f32", **kw):
    return lc.lc_omr_scores_batched(corpus, q_ids, q_w,
                                    use_kernels=use_kernels, block_q=block_q,
                                    precision=precision, **_tiles(kw, _ALL))


def _omr_cand(corpus, q_ids, q_w, cand, *, use_kernels=False, block_q=8,
              precision="f32", **kw):
    return lc.lc_omr_scores_cand(corpus, q_ids, q_w, cand,
                                 use_kernels=use_kernels, block_q=block_q,
                                 precision=precision, **_tiles(kw, _ALL))


def _ict(corpus, q_ids, q_w, **_):
    """The paper's tightest linear-complexity bound (Algorithm 2, the full
    cost-sorted ladder): between ACT-k and exact EMD (Theorem 2)."""
    return lc.lc_ict_scores(corpus, q_ids, q_w)


def _ict_batch(corpus, q_ids, q_w, *, use_kernels=False, block_q=8,
               precision="f32", **kw):
    return lc.lc_ict_scores_batched(corpus, q_ids, q_w,
                                    use_kernels=use_kernels, block_q=block_q,
                                    precision=precision,
                                    **_tiles(kw, ("block_n",)))


def _ict_cand(corpus, q_ids, q_w, cand, *, use_kernels=False, block_q=8,
              precision="f32", **kw):
    return lc.lc_ict_scores_cand(corpus, q_ids, q_w, cand,
                                 use_kernels=use_kernels, block_q=block_q,
                                 precision=precision,
                                 **_tiles(kw, ("block_n",)))


def _query_vectors(corpus, q_ids, q_w) -> torch.Tensor:
    """(nq, v) L2-normalized bag-of-words vectors of the queries (repeated
    ids add up)."""
    nq = q_ids.shape[0]
    qv = torch.zeros((nq, corpus.v), dtype=corpus.w.dtype,
                     device=corpus.device)
    rows = torch.arange(nq, device=corpus.device)[:, None].expand_as(q_ids)
    qv.index_put_((rows, q_ids.long()), q_w, accumulate=True)
    return qv / torch.clamp_min(torch.linalg.norm(qv, dim=1, keepdim=True),
                                1e-12)


def _bow_batch(corpus, q_ids, q_w, **_):
    """Bag-of-words cosine baseline: 1 - cosine as a distance. The dot is
    a multiply then a sum over the slots (JAX: einsum), so a query's scores
    do not depend on the batch around it."""
    qv = _query_vectors(corpus, q_ids, q_w)
    wn = corpus.w / torch.clamp_min(
        torch.linalg.norm(corpus.w, dim=1, keepdim=True), 1e-12)
    return 1.0 - torch.sum(wn * qv[:, corpus.ids], dim=-1)


def _bow(corpus, q_ids, q_w, **_):
    """One query's bag-of-words cosine baseline: the batch engine's
    arithmetic (a multiply then a sum per row) on a batch of one."""
    return _bow_batch(corpus, q_ids[None], q_w[None])[0]


def _bow_cand(corpus, q_ids, q_w, cand, **_):
    qv = _query_vectors(corpus, q_ids, q_w)
    w_c = corpus.w[cand]                                  # (nq, b, hmax)
    wn = w_c / torch.clamp_min(torch.linalg.norm(w_c, dim=-1, keepdim=True),
                               1e-12)
    qg = lc.gather_per_query(qv, corpus.ids[cand])
    return 1.0 - torch.einsum("qbs,qbs->qb", wn, qg)


#: Corpus rows per block of the centroid product: the (rows, hmax, m)
#: gather of one block stays near 2^27 floats at 20 Newsgroups width.
_CENTROID_ELEMS = 1 << 27


def _corpus_centroids(corpus) -> torch.Tensor:
    """(n, m) weight-centroid of every corpus row, in row blocks (the
    whole (n, hmax, m) gather would be 11 GB at 20 Newsgroups width)."""
    rows = max(1, _CENTROID_ELEMS // (corpus.hmax * corpus.m))
    return torch.cat([
        torch.einsum("nh,nhm->nm", corpus.w[s:s + rows],
                     corpus.coords[corpus.ids[s:s + rows]])
        for s in range(0, corpus.n, rows)])


def _query_centroids(corpus, q_ids, q_w) -> torch.Tensor:
    return torch.einsum("qh,qhm->qm", q_w, corpus.coords[q_ids])


def _wcd_batch(corpus, q_ids, q_w, **_):
    """Word Centroid Distance baseline."""
    qc = _query_centroids(corpus, q_ids, q_w)
    cent = _corpus_centroids(corpus)
    return torch.linalg.norm(cent[None, :] - qc[:, None], dim=-1)


def _wcd(corpus, q_ids, q_w, **_):
    """One query's Word Centroid Distance: the batch engine's on a batch
    of one."""
    return _wcd_batch(corpus, q_ids[None], q_w[None])[0]


def _wcd_cand(corpus, q_ids, q_w, cand, **_):
    # Centroids of the (nq, b) candidate rows only.
    qc = _query_centroids(corpus, q_ids, q_w)
    cent = torch.einsum("qbh,qbhm->qbm", corpus.w[cand],
                        corpus.coords[corpus.ids[cand]])
    return torch.linalg.norm(cent - qc[:, None, :], dim=-1)


#: ``rwmd_rev`` and ``ict`` support kernels here and not in the JAX
#: package, which has no kernel for their full-corpus engines: here the
#: batched ones take the all-rows form of K4's valid-bin entry (their
#: single-query engines have none, as in the JAX package).
METHODS: dict[str, MethodSpec] = {s.name: s for s in (
    MethodSpec("rwmd", "LC-RWMD (db -> query)", supports_kernels=True,
               reverse="rwmd_rev", fn=_rwmd, batch_fn=_rwmd_batch,
               symmetric_batch_fn=_rwmd_symmetric_batch,
               cand_fn=_rwmd_cand),
    MethodSpec("rwmd_rev", "LC-RWMD (query -> db)", supports_kernels=True,
               reverse="rwmd", fn=_rwmd_rev, batch_fn=_rwmd_rev_batch,
               symmetric_batch_fn=_rwmd_symmetric_batch,
               cand_fn=_rwmd_rev_cand),
    MethodSpec("omr", "LC-OMR", supports_kernels=True, fn=_omr,
               batch_fn=_omr_batch, cand_fn=_omr_cand),
    MethodSpec("act", "LC-ACT-k", uses_iters=True, supports_kernels=True,
               fn=_act, batch_fn=_act_batch, cand_fn=_act_cand),
    MethodSpec("ict", "LC-ICT (db -> query)", supports_kernels=True,
               fn=_ict, batch_fn=_ict_batch, cand_fn=_ict_cand),
    MethodSpec("bow", "BoW cosine baseline", symmetric=True, fn=_bow,
               batch_fn=_bow_batch, cand_fn=_bow_cand),
    MethodSpec("wcd", "Word Centroid Distance baseline", symmetric=True,
               fn=_wcd, batch_fn=_wcd_batch, cand_fn=_wcd_cand),
)}


def _spec(method: str) -> MethodSpec:
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of "
                         f"{sorted(METHODS)}")
    return METHODS[method]


#: The engines of :func:`batch_scores`.
ENGINES = ("batched", "scan", "dist")


def query_scores(corpus: lc.Corpus, q_ids: torch.Tensor, q_w: torch.Tensor,
                 *, method: str = "act", symmetric: bool = False,
                 iters: int = 1, use_kernels: bool = False, block_q: int = 8,
                 precision: str = "f32", block_v: int | None = None,
                 block_h: int | None = None, block_n: int | None = None,
                 rev_block: int = 256) -> torch.Tensor:
    """One query ``(h,)`` against the whole corpus -> ``(n,)`` scores,
    through ``METHODS[method].fn``.

    ``symmetric=True`` returns the paper's symmetric measure, the max of
    the two directional bounds (a method with a reverse direction: rwmd /
    rwmd_rev). ``block_q`` and ``precision`` are accepted for parity with
    :func:`batch_scores` and have no effect: the single-query engines are
    the full-precision oracle and always run float32. ``block_v`` /
    ``block_h`` tile K1, ``rev_block`` is rwmd_rev's row block; no knob
    changes a score."""
    spec = _spec(method)
    kw = dict(iters=iters, use_kernels=use_kernels, block_v=block_v,
              block_h=block_h, block_n=block_n, rev_block=rev_block)
    fwd = spec.fn(corpus, q_ids, q_w, **kw)
    if not symmetric or spec.symmetric:
        return fwd
    if spec.reverse is None:
        raise ValueError(
            f"method {method!r} has no reverse direction registered; "
            "per-query symmetric scoring needs one (use rwmd/rwmd_rev)")
    return torch.maximum(fwd, METHODS[spec.reverse].fn(corpus, q_ids, q_w,
                                                       **kw))


def batch_scores(corpus: lc.Corpus, q_ids: torch.Tensor, q_w: torch.Tensor,
                 *, method: str = "act", symmetric: bool = False,
                 engine: str = "batched", iters: int = 1,
                 use_kernels: bool = False, block_q: int = 8,
                 precision: str = "f32", block_v: int | None = None,
                 block_h: int | None = None, block_n: int | None = None,
                 rev_block: int = 256, mesh=None) -> torch.Tensor:
    """Query batch ``(nq, h)`` -> ``(nq, n)`` scores.

    ``engine="batched"`` (default) runs the method's batched engine: Phase 1
    once for the whole batch, Phase 2/3 in blocks of ``block_q`` queries.
    ``iters`` is read by ``act`` only. ``engine="scan"`` runs
    :func:`query_scores` on each query in turn and stacks the rows, so it
    is bitwise a loop of single-query calls (float32, whatever
    ``precision``): the check of the batched engine. ``engine="dist"`` is
    the mesh engine: the batched engine on the rank's shards. On a
    ``mesh`` (a ``launch.mesh.Mesh``) the corpus and queries are the
    rank's shards and the result is the rank's (nq/dp, n/mp) block; the
    kernel path's Phase 1 splits the vocabulary over ``model`` where it
    divides. Without a mesh, and on a 1 x 1 mesh, it is ``batched``. (The
    JAX package's ``dist_fn`` for rwmd_rev, a full-row reverse reduction
    because XLA cannot scan a sharded row axis, has no counterpart: a
    rank's shard is a local tensor that the batched engine's row blocks
    already walk, to the same bits.)

    ``symmetric=True`` scores the paper's symmetric measure, the max of the
    two directional bounds; it needs a method with a reverse direction
    (rwmd / rwmd_rev), and symmetric methods (bow, wcd) pass through. The
    batched reference path takes the shared-work ``symmetric_batch_fn``;
    under ``use_kernels`` the two directional engines run, each on its
    kernels, and their elementwise max is returned.

    ``block_v`` / ``block_h`` tile K1 and ``block_n`` the Phase-2/3
    kernels (None: each kernel's default tile); ``rev_block`` is the
    reverse reference scorer's row block. No knob changes a score."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    spec = _spec(method)
    kw = dict(iters=iters, use_kernels=use_kernels, block_q=block_q,
              precision=precision, block_v=block_v, block_h=block_h,
              block_n=block_n, rev_block=rev_block)
    if engine == "scan":
        if q_ids.shape[0] == 0:
            return torch.empty((0, corpus.n), dtype=torch.float32,
                               device=corpus.device)
        return torch.stack([
            query_scores(corpus, q_ids[i], q_w[i], method=method,
                         symmetric=symmetric, **kw)
            for i in range(q_ids.shape[0])])
    kw["mesh"] = mesh
    if symmetric and not spec.symmetric:
        if spec.reverse is None:
            raise ValueError(
                f"method {method!r} has no reverse direction registered; "
                "symmetric scoring needs one (use rwmd/rwmd_rev)")
        if spec.symmetric_batch_fn is not None and not use_kernels:
            return spec.symmetric_batch_fn(corpus, q_ids, q_w, **kw)
        fwd = spec.batch_fn(corpus, q_ids, q_w, **kw)
        return torch.maximum(
            fwd, METHODS[spec.reverse].batch_fn(corpus, q_ids, q_w, **kw))
    return spec.batch_fn(corpus, q_ids, q_w, **kw)


def cand_scores(corpus: lc.Corpus, q_ids: torch.Tensor, q_w: torch.Tensor,
                cand: torch.Tensor, *, method: str = "act", iters: int = 1,
                use_kernels: bool = False, block_q: int = 8,
                precision: str = "f32", block_v: int | None = None,
                block_h: int | None = None, block_n: int | None = None,
                rev_block: int = 256, mesh=None) -> torch.Tensor:
    """Candidate-compacted scoring: ``(nq, h)`` queries against each
    query's own ``(b,)`` candidate rows ``cand`` -> ``(nq, b)`` scores,
    through ``MethodSpec.cand_fn`` (the cascade's stage primitive); the
    tile knobs as for :func:`batch_scores`. On a ``mesh`` the corpus is
    the rank's row shard and ``cand`` holds global row ids: each model
    rank scores the candidates it owns and the scores are summed over
    ``model`` (``kernels/partition.cand_sharded``)."""
    spec = _spec(method)
    if spec.cand_fn is None:
        raise ValueError(f"method {method!r} has no candidate-compacted "
                         "scorer registered (MethodSpec.cand_fn)")
    kw = dict(iters=iters, use_kernels=use_kernels, block_q=block_q,
              precision=precision, block_v=block_v, block_h=block_h,
              block_n=block_n, rev_block=rev_block)
    if mesh is not None:
        from repro_torch.kernels import partition
        return partition.cand_sharded(mesh, spec.cand_fn, corpus, q_ids,
                                      q_w, cand, **kw)
    return spec.cand_fn(corpus, q_ids, q_w, cand, **kw)


def top_l_smallest(scores: torch.Tensor, top_l: int):
    """(values, indices) of the ``top_l`` smallest scores along the last
    axis, ascending; among equal scores the lowest index comes first.

    A stable sort of whole rows: for a query batch one launch, which on an
    H100 beats :func:`top_l_rows`'s selection (several launches and a host
    sync) by 0.3-0.6 ms a 16-query search at 20 Newsgroups width. The
    corpus-as-queries matrices of the evaluation take :func:`top_l_rows`,
    whose memory does not grow with n x n."""
    if not 1 <= top_l <= scores.shape[-1]:
        raise ValueError(f"top_l must be in [1, {scores.shape[-1]}], got "
                         f"{top_l}")
    values, idx = torch.sort(scores, dim=-1, stable=True)
    return values[..., :top_l], idx[..., :top_l]


def search(corpus: lc.Corpus, q_ids: torch.Tensor, q_w: torch.Tensor,
           top_l: int, method: str = "act", iters: int = 1, *,
           symmetric: bool = False, engine: str = "batched",
           use_kernels: bool = False, block_q: int = 8,
           precision: str = "f32", block_v: int | None = None,
           block_h: int | None = None, block_n: int | None = None,
           rev_block: int = 256):
    """(scores, indices) of the top-l most similar database rows: for one
    ``(h,)`` query through :func:`query_scores` (the JAX package's
    ``search``), ``(top_l,)`` each; for a ``(nq, h)`` batch through
    :func:`batch_scores`, ``(nq, top_l)`` each."""
    kw = dict(method=method, symmetric=symmetric, iters=iters,
              use_kernels=use_kernels, block_q=block_q, precision=precision,
              block_v=block_v, block_h=block_h, block_n=block_n,
              rev_block=rev_block)
    if q_ids.dim() == 1:
        scores = query_scores(corpus, q_ids, q_w, **kw)
    else:
        scores = batch_scores(corpus, q_ids, q_w, engine=engine, **kw)
    return top_l_smallest(scores, top_l)


#: Queries per chunk of :func:`all_pairs_scores`: the batch of the 20
#: Newsgroups workload (``configs/emd_20news.py``), far below K1's limit of
#: 65,535. The JAX package scores all n rows as one batch; at 20 Newsgroups
#: width the (n, v, k) ladders alone would be 84 GB.
ALL_PAIRS_QUERIES = 256

#: Most floats of the stacked (v, chunk * hmax) Phase-1 distance tensor
#: that one chunk of the reference path builds: 2^29 (2 GiB), 15 queries at
#: 20 Newsgroups width.
ALL_PAIRS_STACK_ELEMS = 1 << 29


def all_pairs_chunk(corpus: lc.Corpus, use_kernels: bool) -> int:
    """The default query chunk of :func:`all_pairs_scores`:
    ``ALL_PAIRS_QUERIES``, cut on the reference path so that the stacked
    distance tensor stays within ``ALL_PAIRS_STACK_ELEMS``."""
    if use_kernels:
        return ALL_PAIRS_QUERIES
    return max(1, min(ALL_PAIRS_QUERIES,
                      ALL_PAIRS_STACK_ELEMS // (corpus.v * corpus.hmax)))


def all_pairs_scores(corpus: lc.Corpus, method: str = "act", iters: int = 1,
                     *, engine: str = "batched", use_kernels: bool = False,
                     block_q: int = 8, precision: str = "f32",
                     block_v: int | None = None, block_h: int | None = None,
                     block_n: int | None = None,
                     rev_block: int = 256) -> torch.Tensor:
    """n x n symmetric bound matrix over the corpus (the paper's evaluation
    mode), float32 on the corpus's device.

    asym[a, b] = directional bound of moving histogram b INTO histogram a
    (query = row a), scored by ``batch_scores`` (with ``engine``) in
    chunks of :func:`all_pairs_chunk` corpus rows; every chunk size gives
    the same matrix. The matrix is then symmetrized in place, max(asym,
    asym^T) (:func:`lc.symmetric_scores`), so no second n x n matrix is
    held. For the symmetric measures (bow, wcd) that only evens out the
    float rounding of the two directions, which JAX leaves in their
    matrix: here every method's matrix is exactly symmetric."""
    _spec(method)
    chunk = all_pairs_chunk(corpus, use_kernels)
    n = corpus.n
    asym = torch.empty((n, n), dtype=torch.float32, device=corpus.device)
    for s in range(0, n, chunk):
        asym[s:s + chunk] = batch_scores(
            corpus, corpus.ids[s:s + chunk], corpus.w[s:s + chunk],
            method=method, engine=engine, iters=iters,
            use_kernels=use_kernels, block_q=block_q, precision=precision,
            block_v=block_v, block_h=block_h, block_n=block_n,
            rev_block=rev_block)
    return lc.symmetric_scores(asym)


#: Score-matrix entries one chunk of rows of the top-l selection holds:
#: 2^26, so a chunk and its masks stay near 1 GiB at any n.
SELECT_ELEMS = 1 << 26


def _mask_self(scores: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """A copy of ``scores`` (rows row0.. of a square corpus-as-queries
    matrix) with each row's own column pushed to the dtype max, so that a
    row never retrieves itself.

    The mask is written in the float32 ACCUMULATOR dtype, never a reduced
    storage dtype: ``finfo(bfloat16).max`` is also what bf16 overflow
    saturates to, so masking in-dtype would tie the diagonal with any
    saturated entry and let the index order pick between self and a real
    row. Upcasting first (exact for bf16/f16) keeps the sentinel strictly
    above every finite score; float32 values pass through unchanged."""
    acc = torch.promote_types(scores.dtype, torch.float32)
    out = scores.to(acc, copy=True)
    r = torch.arange(out.shape[0], device=out.device)
    out[r, row0 + r] = torch.finfo(acc).max
    return out


def _smallest_l(x: torch.Tensor, top_l: int) -> torch.Tensor:
    """The indices of each row's ``top_l`` smallest scores, ascending, the
    lowest index first among ties, without sorting whole rows:
    ``torch.topk`` gives each row's l-th smallest value t (its order among
    ties is unspecified, its values are not); the entries below t and the
    lowest-indexed of those equal to t are the row's top-l set, which a
    stable sort of its l values puts in order."""
    t = torch.topk(x, top_l, dim=-1, largest=False).values[:, -1:]
    below, tied = x < t, x == t
    need = top_l - below.sum(dim=-1, keepdim=True)
    take = below | (tied & (torch.cumsum(tied, dim=-1) <= need))
    idx = torch.nonzero(take)[:, 1].view(-1, top_l)      # ascending index
    order = torch.argsort(torch.gather(x, 1, idx), dim=-1, stable=True)
    return torch.gather(idx, 1, order)


def top_l_rows(scores: torch.Tensor, top_l: int, *,
               exclude_self: bool = False) -> torch.Tensor:
    """(rows, top_l) indices of each row's ``top_l`` smallest scores,
    ascending, the lowest index first among ties (``lax.top_k`` of the
    negated scores), in chunks of at most ``SELECT_ELEMS`` entries;
    ``exclude_self`` masks each row's own column first
    (:func:`_mask_self`)."""
    n_rows, n = scores.shape
    if not 1 <= top_l <= n:
        raise ValueError(f"top_l must be in [1, {n}], got {top_l}")
    rows = max(1, SELECT_ELEMS // n)
    out = []
    for s in range(0, n_rows, rows):
        chunk = scores[s:s + rows]
        chunk = _mask_self(chunk, s) if exclude_self else chunk.float()
        out.append(_smallest_l(chunk, top_l))
    return torch.cat(out)


def _f32_mean(total, count: int) -> float:
    """The float32 mean of ``count`` values summing to ``total``, rounded as
    JAX's float32 mean is: the sum times the float32 reciprocal of the
    count (XLA turns the division by the constant count into that
    product), which can be one ulp off the correctly rounded quotient."""
    return float(np.float32(total) * (np.float32(1) / np.float32(count)))


def precision_at_l(scores: torch.Tensor, labels, top_l: int) -> float:
    """Average precision@top-l: the fraction of each row's top-l
    neighbours (self excluded) that share the row's label, averaged over
    the rows. The row fractions are JAX's float32 row means and their sum
    is taken exactly, so the result is JAX's float32 mean of means
    whenever JAX's float32 sum of the fractions is exact too (for any
    top_l that is a power of two)."""
    idx = top_l_rows(scores, top_l, exclude_self=True)
    lab = torch.as_tensor(np.asarray(labels), device=idx.device)
    hits = (lab[idx] == lab[:, None]).sum(dim=1)
    frac = hits.to(torch.float32) * (np.float32(1) / np.float32(top_l))
    return _f32_mean(frac.double().sum().item(), frac.numel())


def topl_overlap(got_idx, ref_idx) -> float:
    """Mean fraction of each row's reference index set that the row's
    ``got_idx`` set retrieves (the cascade's recall against full
    scoring), as a float32 mean."""
    got, ref = torch.as_tensor(got_idx), torch.as_tensor(ref_idx)
    if got.shape != ref.shape:
        raise ValueError(f"index sets must share a shape, got "
                         f"{tuple(got.shape)} vs {tuple(ref.shape)}")
    hit = (got[..., :, None] == ref[..., None, :].to(got.device)).any(-1)
    return _f32_mean(int(hit.sum()), hit.numel())


def recall_at_l(scores: torch.Tensor, ref_scores: torch.Tensor, top_l: int,
                *, exclude_self: bool = False) -> float:
    """Average recall@top-l of ``scores`` against a reference ranking: the
    fraction of each row's reference top-l (by ``ref_scores``, e.g. exact
    EMD or full-corpus ACT) that the row's top-l under ``scores``
    retrieves. Shapes must match: (nq, n) query batches or (n, n)
    corpus-as-queries matrices (``exclude_self=True`` masks the diagonal
    of both, the convention of :func:`precision_at_l`)."""
    if scores.shape != ref_scores.shape:
        raise ValueError(f"score matrices must share a shape, got "
                         f"{tuple(scores.shape)} vs "
                         f"{tuple(ref_scores.shape)}")
    return topl_overlap(
        top_l_rows(scores, top_l, exclude_self=exclude_self),
        top_l_rows(ref_scores, top_l, exclude_self=exclude_self))
