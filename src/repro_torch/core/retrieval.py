"""Top-l nearest-neighbour retrieval on the LC engines, through a typed
method registry.

The part of the JAX package's ``core/retrieval.py`` that serves the port's
``EmdIndex`` and cascade: ``METHODS`` holds a :class:`MethodSpec` for each
of the seven JAX methods (act, rwmd, rwmd_rev, omr, ict, bow, wcd) with
its batched scorer and its candidate-compacted scorer. ``batch_scores``
dispatches through ``METHODS[method].batch_fn``, ``cand_scores`` through
``cand_fn``; ``search`` and ``top_l_smallest`` match ``lax.top_k`` on the
negated scores (ascending scores, the lowest index first among ties).

Every scorer takes the uniform keyword set ``iters``, ``use_kernels``,
``block_q`` and ``precision`` and ignores the ones it does not use.
Not yet ported, and so absent from :class:`MethodSpec`: the single-query
engines (``fn``) and the mesh and symmetric scorers (``dist_fn``,
``symmetric_batch_fn``, ``dist_out``).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

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
    batch_fn:    (nq, h) queries -> (nq, n) scores.
    cand_fn:     (nq, h) queries and (nq, b) candidate row ids -> (nq, b)
                 scores at those rows (Phase 1 unchanged, Phase 2/3
                 gather-compacted); for the five LC methods
                 ``use_kernels=True`` sends the gather and reduction to
                 the ``cand_pour`` / ``cand_dist`` kernels. The bow and wcd
                 baselines have no kernel and ignore the flag.
    """
    name: str
    paper_name: str
    symmetric: bool = False
    uses_iters: bool = False
    supports_kernels: bool = False
    reverse: str | None = None
    batch_fn: Callable | None = None
    cand_fn: Callable | None = None


def _act_batch(corpus, q_ids, q_w, *, iters=1, use_kernels=False,
               block_q=8, precision="f32", **_):
    return lc.lc_act_scores_batched(corpus, q_ids, q_w, iters=iters,
                                    use_kernels=use_kernels, block_q=block_q,
                                    precision=precision)


def _act_cand(corpus, q_ids, q_w, cand, *, iters=1, use_kernels=False,
              block_q=8, precision="f32", **_):
    return lc.lc_act_scores_cand(corpus, q_ids, q_w, cand, iters=iters,
                                 use_kernels=use_kernels, block_q=block_q,
                                 precision=precision)


def _rwmd_batch(corpus, q_ids, q_w, *, use_kernels=False, block_q=8,
                precision="f32", **_):
    return lc.lc_rwmd_scores_batched(corpus, q_ids, q_w,
                                     use_kernels=use_kernels,
                                     block_q=block_q, precision=precision)


def _rwmd_cand(corpus, q_ids, q_w, cand, *, use_kernels=False, block_q=8,
               precision="f32", **_):
    return lc.lc_rwmd_scores_cand(corpus, q_ids, q_w, cand,
                                  use_kernels=use_kernels, block_q=block_q,
                                  precision=precision)


def _rwmd_rev_batch(corpus, q_ids, q_w, *, block_q=8, precision="f32", **_):
    return lc.lc_rwmd_scores_rev_batched(corpus, q_ids, q_w,
                                         block_q=block_q,
                                         precision=precision)


def _rwmd_rev_cand(corpus, q_ids, q_w, cand, *, use_kernels=False,
                   block_q=8, precision="f32", **_):
    return lc.lc_rwmd_scores_rev_cand(corpus, q_ids, q_w, cand,
                                      use_kernels=use_kernels,
                                      block_q=block_q, precision=precision)


def _omr_batch(corpus, q_ids, q_w, *, use_kernels=False, block_q=8,
               precision="f32", **_):
    return lc.lc_omr_scores_batched(corpus, q_ids, q_w,
                                    use_kernels=use_kernels, block_q=block_q,
                                    precision=precision)


def _omr_cand(corpus, q_ids, q_w, cand, *, use_kernels=False, block_q=8,
              precision="f32", **_):
    return lc.lc_omr_scores_cand(corpus, q_ids, q_w, cand,
                                 use_kernels=use_kernels, block_q=block_q,
                                 precision=precision)


def _ict_batch(corpus, q_ids, q_w, *, block_q=8, precision="f32", **_):
    return lc.lc_ict_scores_batched(corpus, q_ids, q_w, block_q=block_q,
                                    precision=precision)


def _ict_cand(corpus, q_ids, q_w, cand, *, use_kernels=False, block_q=8,
              precision="f32", **_):
    return lc.lc_ict_scores_cand(corpus, q_ids, q_w, cand,
                                 use_kernels=use_kernels, block_q=block_q,
                                 precision=precision)


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
    """Bag-of-words cosine baseline: 1 - cosine as a distance."""
    qv = _query_vectors(corpus, q_ids, q_w)
    wn = corpus.w / torch.clamp_min(
        torch.linalg.norm(corpus.w, dim=1, keepdim=True), 1e-12)
    return 1.0 - torch.einsum("us,qus->qu", wn, qv[:, corpus.ids])


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


def _wcd_cand(corpus, q_ids, q_w, cand, **_):
    # Centroids of the (nq, b) candidate rows only.
    qc = _query_centroids(corpus, q_ids, q_w)
    cent = torch.einsum("qbh,qbhm->qbm", corpus.w[cand],
                        corpus.coords[corpus.ids[cand]])
    return torch.linalg.norm(cent - qc[:, None, :], dim=-1)


METHODS: dict[str, MethodSpec] = {s.name: s for s in (
    MethodSpec("rwmd", "LC-RWMD (db -> query)", supports_kernels=True,
               reverse="rwmd_rev", batch_fn=_rwmd_batch,
               cand_fn=_rwmd_cand),
    MethodSpec("rwmd_rev", "LC-RWMD (query -> db)", reverse="rwmd",
               batch_fn=_rwmd_rev_batch, cand_fn=_rwmd_rev_cand),
    MethodSpec("omr", "LC-OMR", supports_kernels=True, batch_fn=_omr_batch,
               cand_fn=_omr_cand),
    MethodSpec("act", "LC-ACT-k", uses_iters=True, supports_kernels=True,
               batch_fn=_act_batch, cand_fn=_act_cand),
    MethodSpec("ict", "LC-ICT (db -> query)", batch_fn=_ict_batch,
               cand_fn=_ict_cand),
    MethodSpec("bow", "BoW cosine baseline", symmetric=True,
               batch_fn=_bow_batch, cand_fn=_bow_cand),
    MethodSpec("wcd", "Word Centroid Distance baseline", symmetric=True,
               batch_fn=_wcd_batch, cand_fn=_wcd_cand),
)}


def _spec(method: str) -> MethodSpec:
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of "
                         f"{sorted(METHODS)}")
    return METHODS[method]


def batch_scores(corpus: lc.Corpus, q_ids: torch.Tensor, q_w: torch.Tensor,
                 *, method: str = "act", iters: int = 1,
                 use_kernels: bool = False, block_q: int = 8,
                 precision: str = "f32") -> torch.Tensor:
    """Query batch ``(nq, h)`` -> ``(nq, n)`` scores through the method's
    batched engine: Phase 1 once for the whole batch, Phase 2/3 in blocks
    of ``block_q`` queries. ``iters`` is read by ``act`` only."""
    return _spec(method).batch_fn(corpus, q_ids, q_w, iters=iters,
                                  use_kernels=use_kernels, block_q=block_q,
                                  precision=precision)


def cand_scores(corpus: lc.Corpus, q_ids: torch.Tensor, q_w: torch.Tensor,
                cand: torch.Tensor, *, method: str = "act", iters: int = 1,
                use_kernels: bool = False, block_q: int = 8,
                precision: str = "f32") -> torch.Tensor:
    """Candidate-compacted scoring: ``(nq, h)`` queries against each
    query's own ``(b,)`` candidate rows ``cand`` -> ``(nq, b)`` scores,
    through ``MethodSpec.cand_fn`` (the cascade's stage primitive)."""
    spec = _spec(method)
    if spec.cand_fn is None:
        raise ValueError(f"method {method!r} has no candidate-compacted "
                         "scorer registered (MethodSpec.cand_fn)")
    return spec.cand_fn(corpus, q_ids, q_w, cand, iters=iters,
                        use_kernels=use_kernels, block_q=block_q,
                        precision=precision)


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


def topl_overlap(got_idx, ref_idx) -> float:
    """Mean fraction of each row's reference index set that the row's
    ``got_idx`` set retrieves (the cascade's recall against full
    scoring)."""
    got, ref = torch.as_tensor(got_idx), torch.as_tensor(ref_idx)
    if got.shape != ref.shape:
        raise ValueError(f"index sets must share a shape, got "
                         f"{tuple(got.shape)} vs {tuple(ref.shape)}")
    hit = (got[..., :, None] == ref[..., None, :].to(got.device)).any(-1)
    return float(hit.float().mean())
