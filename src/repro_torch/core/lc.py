"""Batched LC-ACT and LC-RWMD engines (paper Section 5), in PyTorch.

A query batch (nq, h) is scored against ``n`` database histograms over a
shared vocabulary of ``v`` coordinates in R^m:

  Phase 1:  D = dist(V, Qcoords)            (v, nq, h)  -- one stacked matmul
            Z, S = row-top-k smallest of D  (nq, v, k)
            W[q, i, l] = q_w[q, S[q, i, l]] (nq, v, k)  -- capacities
  Phase 2:  k-1 rounds of the water-filling pour over each database entry
  Phase 3:  dump the remainder at the k-th cost

This is the batched pipeline of the JAX package's ``core/lc.py``, with the
same handoff arrays, sentinels and tie-breaks. Two pieces of the JAX code
have no counterpart here: the XLA bitcast fence of ``_map_query_blocks``
(query blocks are a plain Python loop) and the mesh sharding pins. JAX's
``_pad_const`` (the sentinel as a 0-d array) is ``pad_dist_for`` itself:
``torch.where`` takes the Python float.
``use_kernels=True`` sends Phase 1 to the ``dist_topk`` kernel and Phase
2/3 to the ``act_phase2`` kernel (``kernels/ops.py``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.geometry import pairwise_dist
from repro_torch.core.precision import pad_dist_for
from repro_torch.core.precision import resolve as resolve_precision
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class Corpus:
    """Padded dense-bucket histogram database over a shared vocabulary.

    ids: (n, hmax) int32 vocabulary indices; padding slots carry weight 0
         and an in-range id (0).
    w:   (n, hmax) float32 L1-normalized weights (padding = 0).
    coords: (v, m) float32 vocabulary embedding vectors.
    """
    ids: torch.Tensor
    w: torch.Tensor
    coords: torch.Tensor

    @property
    def n(self) -> int:
        return self.ids.shape[0]

    @property
    def hmax(self) -> int:
        return self.ids.shape[1]

    @property
    def v(self) -> int:
        return self.coords.shape[0]

    @property
    def m(self) -> int:
        return self.coords.shape[1]

    @property
    def device(self) -> torch.device:
        return self.coords.device

    def to(self, device) -> "Corpus":
        return Corpus(ids=self.ids.to(device), w=self.w.to(device),
                      coords=self.coords.to(device))


#: Finite sentinel for padding query slots: never chosen over a real bin,
#: finite so 0-mass remainders cost 0.0. This is the float32 value;
#: reduced-precision arrays use ``pad_dist_for(dtype)``.
PAD_DIST = 1e30


def _accum(x: torch.Tensor) -> torch.Tensor:
    """Upcast a reduced-precision handoff block to the float32 accumulator
    dtype (a no-op on float32)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def mask_pad_rows(scores: torch.Tensor, n_valid: int | None) -> torch.Tensor:
    """Push score columns of pad rows (index >= ``n_valid``) to the
    sentinel: zero-weight pad rows score 0, the best possible score, so
    every top-k consumer must mask them first."""
    if n_valid is None or n_valid >= scores.shape[-1]:
        return scores
    col = torch.arange(scores.shape[-1], device=scores.device)
    return torch.where(col < n_valid, scores, pad_dist_for(scores.dtype))


_INT_MAX = 2**31 - 1


def _extract_smallest_k(work: torch.Tensor, col_ids: torch.Tensor, k: int):
    """k rounds of masked min-extraction over the last axis: per row the
    (value, column id) of the k smallest entries, ascending, ties to the
    lowest id. Extracted entries are masked to the sentinel, so on a row
    with fewer than k entries below it the later slots repeat the lowest
    id that is masked or already taken."""
    big = pad_dist_for(work.dtype)
    zs, ss = [], []
    for _ in range(k):
        mv = work.amin(dim=-1, keepdim=True)
        mi = torch.where(work == mv, col_ids, _INT_MAX).amin(dim=-1,
                                                             keepdim=True)
        work = torch.where(col_ids == mi, big, work)
        zs.append(mv)
        ss.append(mi)
    return torch.cat(zs, dim=-1), torch.cat(ss, dim=-1).to(torch.int32)


def _merge_smallest_k(zr, sr, zt, st, k: int):
    """Merge running (value, index) registers with a tile's top-k: k
    extraction rounds over the 2k candidates, masking exactly one winner
    position per round (ids may repeat on degenerate rows, so masking by
    id alone would drop candidates)."""
    work = torch.cat([zr, zt], dim=-1)                   # (..., 2k)
    sc = torch.cat([sr, st], dim=-1)
    pos = torch.arange(2 * k, dtype=torch.int32, device=work.device)
    big = pad_dist_for(work.dtype)
    out_z, out_s = [], []
    for _ in range(k):
        mv = work.amin(dim=-1, keepdim=True)
        is_min = work == mv
        mi = torch.where(is_min, sc, _INT_MAX).amin(dim=-1, keepdim=True)
        win = torch.where(is_min & (sc == mi), pos, _INT_MAX).amin(
            dim=-1, keepdim=True)
        work = torch.where(pos == win, big, work)
        out_z.append(mv)
        out_s.append(mi)
    return torch.cat(out_z, dim=-1), torch.cat(out_s, dim=-1).to(torch.int32)


def smallest_k(D: torch.Tensor, k: int):
    """Row-wise k smallest (values, indices), ascending, ties to the lowest
    index, by k rounds of masked min-extraction. ``torch.topk`` promises no
    order among ties, so it is not used."""
    col = torch.arange(D.shape[-1], dtype=torch.int32, device=D.device)
    return _extract_smallest_k(D, col, k)


def streaming_smallest_k(D: torch.Tensor, k: int, chunk: int = 512):
    """The selection of :func:`smallest_k` in one pass over ``D``: columns
    stream through in tiles of ``chunk`` and k running (value, index)
    registers per row merge with each tile's candidates."""
    h = D.shape[-1]
    if h <= chunk:
        return smallest_k(D, k)
    nchunks = -(-h // chunk)
    # Pad with the sentinel at column ids >= h: real columns win all ties.
    Dp = F.pad(D, (0, nchunks * chunk - h), value=pad_dist_for(D.dtype))
    Dt = Dp.reshape(D.shape[:-1] + (nchunks, chunk)).movedim(-2, 0)
    tile_col = torch.arange(chunk, dtype=torch.int32, device=D.device)
    Z, S = _extract_smallest_k(Dt[0], tile_col, k)
    for i in range(1, nchunks):
        zt, st = _extract_smallest_k(Dt[i], i * chunk + tile_col, k)
        Z, S = _merge_smallest_k(Z, S, zt, st, k)
    return Z, S


#: Dedup the Phase-1 column stack only when it exceeds the vocabulary by
#: this factor (corpus-as-queries batches), as in the JAX package.
DEDUP_STACK_RATIO = 4


def stack_query_bins(coords: torch.Tensor, Q_ids: torch.Tensor):
    """Phase-1 column stacking with duplicate-bin dedup.

    Stacks every query's bins into one (cols, m) coordinate matrix. When
    nq*h >= DEDUP_STACK_RATIO * v the distinct ids are embedded once and a
    (nq*h,) inverse map re-expands the columns after the matmul. Returns
    (qc, inv) with ``inv`` None on the no-dedup path. Unlike the JAX
    version the deduped stack is not padded to the static size v.
    """
    nq, h = Q_ids.shape
    flat = Q_ids.reshape(-1)
    if nq * h < DEDUP_STACK_RATIO * coords.shape[0]:
        return coords[flat], None
    uniq, inv = torch.unique(flat, sorted=True, return_inverse=True)
    return coords[uniq], inv.reshape(-1)


def phase1_stacked_dist(coords: torch.Tensor, Q_ids: torch.Tensor,
                        Q_w: torch.Tensor, precision: str = "f32"):
    """Stacked Phase-1 distance tensor of the whole query batch: one
    (v, nq*h) matmul, viewed query-major as (v, nq, h). Padding query slots
    (weight 0) are masked to the storage dtype's sentinel, and the tensor
    is returned in the policy's storage dtype."""
    policy = resolve_precision(precision)
    nq, h = Q_ids.shape
    qc, inv = stack_query_bins(coords, Q_ids)
    D = pairwise_dist(coords, qc)
    if inv is not None:
        D = D[:, inv]                                    # re-expand dedup
    D = D.reshape(coords.shape[0], nq, h)
    D = torch.where(Q_w[None] > 0.0, D, pad_dist_for(policy.storage))
    return D.to(policy.storage_dtype)


def gather_capacities(Q_w: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """W[q, i, l] = Q_w[q, S[q, i, l]]: the capacity ladders at the
    selected query bins. Q_w (nq, h), S (nq, v, k) -> (nq, v, k)."""
    nq = S.shape[0]
    return torch.gather(Q_w, 1, S.reshape(nq, -1).long()).view(S.shape)


def phase1_batched(coords: torch.Tensor, Q_ids: torch.Tensor,
                   Q_w: torch.Tensor, k: int, precision: str = "f32"):
    """Batched Phase 1: stacked distance tensor + single-pass top-k.
    Returns the query-major handoff ladders Z, W (nq, v, k) in the storage
    dtype. Selection runs on the float32 upcast of the storage values."""
    policy = resolve_precision(precision)
    D = phase1_stacked_dist(coords, Q_ids, Q_w, precision=precision)
    Z, S = streaming_smallest_k(_accum(D), k)            # (v, nq, k)
    Zq = Z.movedim(1, 0).to(policy.storage_dtype).contiguous()
    W = gather_capacities(Q_w, S.movedim(1, 0))
    return Zq, W.to(policy.storage_dtype)


def _min_handoff(D: torch.Tensor) -> torch.Tensor:
    """(nq, v) masked-min handoff from the stacked (v, nq, h) tensor."""
    return D.amin(dim=-1).T.contiguous()


def phase1_min_batched(coords: torch.Tensor, Q_ids: torch.Tensor,
                       Q_w: torch.Tensor, precision: str = "f32"):
    """Masked-min Phase-1 fast path (LC-RWMD): only the nearest distance is
    read, so no ranked registers and no capacities. Returns (nq, v) in the
    storage dtype (a min selects an existing value)."""
    return _min_handoff(phase1_stacked_dist(coords, Q_ids, Q_w,
                                            precision=precision))


def pour(x: torch.Tensor, Zg: torch.Tensor, Wg: torch.Tensor,
         iters: int) -> torch.Tensor:
    """Phases 2+3 as one pour over padded entries.

    x:  (..., hmax) residual database weights.
    Zg: (..., hmax, iters+1) ascending per-entry transport costs.
    Wg: (..., hmax, iters)   per-entry capacities (query weights).
    Returns (...,) transport-cost lower bounds, by the exclusive-prefix
    form of the paper's k-1 min/subtract rounds.

    The remainder is x - min(x, sum_l Wg_l), which equals the JAX
    package's x - sum_l r_l in exact arithmetic. Computed from the poured
    amounts it can be left at one ulp, which a query with fewer valid bins
    than k then dumps at the sentinel cost (~1e30); computed from the
    capacities it is exactly 0 whenever the ladder holds all of x.
    """
    if iters == 0:
        return torch.sum(x * Zg[..., 0], dim=-1)
    cap = torch.cumsum(Wg, dim=-1)
    prefix = cap - Wg                                    # exclusive prefix
    r = torch.minimum(torch.clamp_min(x[..., None] - prefix, 0.0), Wg)
    poured = torch.sum(r * Zg[..., :iters], dim=(-1, -2))
    remainder = torch.clamp_min(x - cap[..., -1], 0.0)
    return poured + torch.sum(remainder * Zg[..., iters], dim=-1)


def _map_query_blocks(fn, arrays, block_q: int) -> torch.Tensor:
    """Run ``fn`` over blocks of ``block_q`` queries (leading axis of every
    array) and concatenate the (bq, ...) results."""
    nq = arrays[0].shape[0]
    return torch.cat([fn(*(a[s:s + block_q] for a in arrays))
                      for s in range(0, nq, block_q)])


def _phase1_batched_dispatch(corpus: Corpus, Q_ids: torch.Tensor,
                             Q_w: torch.Tensor, k: int, use_kernels: bool,
                             precision: str = "f32"):
    """Batched Phase 1 through the ``dist_topk`` kernel or the reference
    ops. Returns query-major Z, W (nq, v, k) in the storage dtype."""
    if use_kernels:
        policy = resolve_precision(precision)
        Z, S = kops.dist_topk_batched(corpus.coords, corpus.coords[Q_ids],
                                      Q_w > 0.0, k,
                                      out_dtype=policy.storage_dtype)
        return Z, gather_capacities(Q_w, S).to(policy.storage_dtype)
    return phase1_batched(corpus.coords, Q_ids, Q_w, k, precision=precision)


def pour_min_blocked(corpus: Corpus, Z0: torch.Tensor,
                     block_q: int) -> torch.Tensor:
    """Zero-round Phase 2 on the masked-min handoff Z0 (nq, v) -> (nq, n)."""
    def blk(Zb):                                         # (bq, v)
        return torch.sum(corpus.w * Zb[:, corpus.ids], dim=-1)
    return _map_query_blocks(blk, (Z0,), block_q)


def pour_blocked(corpus: Corpus, Z: torch.Tensor, W: torch.Tensor,
                 iters: int, block_q: int, *,
                 use_kernels: bool = False) -> torch.Tensor:
    """Query-blocked Phase 2/3: (nq, v, k) ladders -> (nq, n) bounds. Each
    block of ``block_q`` queries gathers its (bq, n, hmax, k) ladders once
    and pours them (the ``act_phase2`` kernel when ``use_kernels``);
    ``iters=0`` is the nearest-cost dump of Phase 3 and has no kernel."""
    x = corpus.w
    if iters == 0:
        def blk0(Zb):                                    # (bq, v, k)
            return torch.sum(x * Zb[..., 0][:, corpus.ids], dim=-1)
        return _map_query_blocks(blk0, (Z,), block_q)
    W = W[..., :iters]
    if use_kernels:
        def blk_k(Zb, Wb):
            return kops.act_phase2_batched(x, Zb[:, corpus.ids],
                                           Wb[:, corpus.ids])
        return _map_query_blocks(blk_k, (Z, W), block_q)

    def blk(Zb, Wb):
        # Gather in the storage dtype, pour in the float32 accumulator.
        Zg = _accum(Zb[:, corpus.ids])                   # (bq, n, hmax, k)
        Wg = _accum(Wb[:, corpus.ids])                   # (bq, n, hmax, iters)
        return pour(x, Zg, Wg, iters)
    return _map_query_blocks(blk, (Z, W), block_q)


def lc_act_scores_batched(corpus: Corpus, Q_ids: torch.Tensor,
                          Q_w: torch.Tensor, iters: int = 1, *,
                          use_kernels: bool = False, block_q: int = 8,
                          precision: str = "f32") -> torch.Tensor:
    """Batched LC-ACT: (nq, h) query batch -> (nq, n) lower bounds."""
    if iters == 0 and not use_kernels:
        Z0 = phase1_min_batched(corpus.coords, Q_ids, Q_w,
                                precision=precision)
        return pour_min_blocked(corpus, Z0, block_q)
    Z, W = _phase1_batched_dispatch(corpus, Q_ids, Q_w, iters + 1,
                                    use_kernels, precision=precision)
    return pour_blocked(corpus, Z, W, iters, block_q,
                        use_kernels=use_kernels)


def lc_rwmd_scores_batched(corpus: Corpus, Q_ids: torch.Tensor,
                           Q_w: torch.Tensor, *, use_kernels: bool = False,
                           block_q: int = 8,
                           precision: str = "f32") -> torch.Tensor:
    """Batched LC-RWMD db -> query (batched LC-ACT with zero rounds)."""
    return lc_act_scores_batched(corpus, Q_ids, Q_w, iters=0,
                                 use_kernels=use_kernels, block_q=block_q,
                                 precision=precision)
