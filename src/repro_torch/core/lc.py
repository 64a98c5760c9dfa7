"""LC-EMD engines (paper Section 5), in PyTorch: LC-ACT, LC-RWMD (both
directions), LC-OMR and LC-ICT, single-query and batched, and the batched
ones' candidate-compacted forms for the cascade.

A query batch (nq, h) is scored against ``n`` database histograms over a
shared vocabulary of ``v`` coordinates in R^m:

  Phase 1:  D = dist(V, Qcoords)            (v, nq, h)  -- one stacked matmul
            Z, S = row-top-k smallest of D  (nq, v, k)
            W[q, i, l] = q_w[q, S[q, i, l]] (nq, v, k)  -- capacities
  Phase 2:  k-1 rounds of the water-filling pour over each database entry
  Phase 3:  dump the remainder at the k-th cost

LC-RWMD query -> db (``rwmd_rev``) and LC-ICT read the whole distance
tensor instead, query-major as Dq (nq, v, h).

This is the pipeline of the JAX package's ``core/lc.py``, with the same
handoff arrays, sentinels and tie-breaks. The XLA bitcast fence of
``_map_query_blocks`` has no counterpart here (query blocks are a plain
Python loop). JAX's ``_pad_const`` (the sentinel as a 0-d array) is
``pad_dist_for`` itself: ``torch.where`` takes the Python float.

On a mesh (``mesh=``, a ``launch.mesh.Mesh``) the engines run on the
rank's shards: its queries and its corpus rows, the coordinates whole.
Only the kernel path's Phase 1 is then split further, over the vocabulary
(``kernels/partition.dist_topk_sharded``, then the handoff all-gather);
the reference Phase 1 runs each rank's queries over the whole vocabulary,
and every Phase 2/3 engine scores the rank's rows as it scores a corpus.

``use_kernels=True`` sends Phase 1 to the ``dist_topk`` kernel and Phase
2/3 to the ``act_phase2`` kernel's fused-gather entry (``kernels/ops.py``),
which reads the ladders at the corpus ids itself; the LC-RWMD dump
(iters=0) and LC-OMR to the all-rows form of the ``cand_pour`` kernel's
corpus-row entry; in the candidate engines it sends Phase 2/3 to that
entry's candidate form, one launch per batch; and, for ``rwmd_rev`` and
``ict``, full-corpus and candidate engines alike, Phase 1 to the valid-bin
distance handoff (:func:`phase1_valid_dist`) and Phase 2/3 to the
``cand_dist`` kernel's valid-bin entry (at every row, or at the
candidates), so the stacked (v, nq*h) tensor is never built there.

The candidate engines depart from the JAX package in one place. There,
Phase 1 of a candidate engine is the jnp pipeline on both paths, behind an
optimization barrier (``_pin_handoff``), so that XLA compiles the same
handoff into the kernel and the reference programs. Here the ranked Phase 1
(act, rwmd, omr) goes through ``_phase1_batched_dispatch`` under
``use_kernels``, that is through the ``dist_topk`` kernel, as the
full-corpus engines do: PyTorch runs eagerly, so there is no re-fusion to
pin, and the plain Phase 1 would cost every cascade stage on the card some
85 ms. The kernel and plain candidate paths then start from handoffs that
agree within K1's tolerance, not bitwise.

The reductions over the distance handoff (``rwmd_rev``, ``ict``) gather a
(rows, hmax, h) cost block per query block. The JAX package gathers all
rows of a query block at once; at 20 Newsgroups width that is 7.5 GB per 8
candidate queries and far more per 8 full-corpus queries, so here the rows
are cut into chunks of at most ``GATHER_ELEMS`` gathered costs. Per
(query, row) the arithmetic is unchanged.
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


def _stack_ids(v: int, Q_ids: torch.Tensor):
    """The vocabulary ids of the Phase-1 columns and the inverse map of
    :func:`stack_query_bins` (the ids of every slot, or the distinct ids
    when nq*h >= DEDUP_STACK_RATIO * v)."""
    flat = Q_ids.reshape(-1)
    if flat.numel() < DEDUP_STACK_RATIO * v:
        return flat, None
    uniq, inv = torch.unique(flat, sorted=True, return_inverse=True)
    return uniq, inv.reshape(-1)


def stack_query_bins(coords: torch.Tensor, Q_ids: torch.Tensor):
    """Phase-1 column stacking with duplicate-bin dedup.

    Stacks every query's bins into one (cols, m) coordinate matrix. When
    nq*h >= DEDUP_STACK_RATIO * v the distinct ids are embedded once and a
    (nq*h,) inverse map re-expands the columns after the matmul. Returns
    (qc, inv) with ``inv`` None on the no-dedup path. Unlike the JAX
    version the deduped stack is not padded to the static size v.
    """
    cols, inv = _stack_ids(coords.shape[0], Q_ids)
    return coords[cols], inv


def _vocab_dist(coords: torch.Tensor, cols: torch.Tensor,
                policy) -> torch.Tensor:
    """(v, len(cols)) distances of the vocabulary to its rows ``cols``,
    the product's operands in the policy's compute dtype; a column's
    distance to its own row is exactly 0 under float32 compute
    (``pairwise_dist``'s same-id pin)."""
    return pairwise_dist(coords, coords[cols],
                         compute_dtype=policy.compute_dtype, b_ids=cols)


def phase1_stacked_dist(coords: torch.Tensor, Q_ids: torch.Tensor,
                        Q_w: torch.Tensor, precision: str = "f32"):
    """Stacked Phase-1 distance tensor of the whole query batch: one
    (v, nq*h) matmul, viewed query-major as (v, nq, h). The matmul's
    operands run in the policy's compute dtype (float32 sums either way).
    Padding query slots (weight 0) are masked to the storage dtype's
    sentinel, and the tensor is returned in the policy's storage dtype."""
    policy = resolve_precision(precision)
    nq, h = Q_ids.shape
    cols, inv = _stack_ids(coords.shape[0], Q_ids)
    D = _vocab_dist(coords, cols, policy)
    if inv is not None:
        D = D[:, inv]                                    # re-expand dedup
    D = D.reshape(coords.shape[0], nq, h)
    D = torch.where(Q_w[None] > 0.0, D, pad_dist_for(policy.storage))
    return D.to(policy.storage_dtype)


def phase1_valid_dist(coords: torch.Tensor, Q_ids: torch.Tensor,
                      Q_w: torch.Tensor, precision: str = "f32"):
    """Valid-bin Phase-1 distance handoff of the whole query batch: the
    distances of every vocabulary row to the batch's P valid query bins
    (weight > 0) only, in one (v, P) matmul.

    The valid bins keep their flat order q*h + c, so each query's bins
    stay in their order and contiguous. Returns (Dv, qoff, qwv): Dv (v, P)
    in the policy's storage dtype, its rows at a stride padded to a
    multiple of 4 (the kernel's aligned vector loads); qoff (nq+1,) int32,
    query q owning columns [qoff[q], qoff[q+1]); qwv (P,) float32 their
    query weights. The dedup rule of :func:`stack_query_bins` applies to
    the P columns, and the compute dtype of :func:`phase1_stacked_dist`
    to the product. Sizing P is one host sync. On the valid columns Dv
    holds the values of :func:`phase1_stacked_dist`, which fills the other
    nq*h - P columns with the sentinel.
    """
    policy = resolve_precision(precision)
    valid = Q_w > 0.0
    flat = torch.nonzero(valid.reshape(-1))[:, 0]        # sizes P: a sync
    P = flat.numel()
    counts = valid.sum(dim=1, dtype=torch.int32)
    qoff = F.pad(torch.cumsum(counts, 0, dtype=torch.int32), (1, 0))
    cols, inv = _stack_ids(coords.shape[0], Q_ids.reshape(-1)[flat])
    pad = -P % 4                       # columns computed but never read
    if inv is None:
        # The pad columns repeat id 0: computed, pinned, never read.
        Dv = _vocab_dist(coords, F.pad(cols, (0, pad)), policy)
    else:
        Dv = _vocab_dist(coords, cols, policy)[:, F.pad(inv, (0, pad))]
    return (Dv.to(policy.storage_dtype)[:, :P], qoff,
            Q_w.reshape(-1)[flat].contiguous())


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


# ------------------------------------------------- single-query engines
#
# One query (h,) against every corpus row, the JAX package's full-precision
# parity oracle: float32 always, whatever the batch's precision policy.
# ``retrieval.query_scores`` dispatches to them and the scan engine loops
# over them. Under ``use_kernels`` each takes the ``dist_topk`` kernel at
# nq=1, and then a kernel that reads the (v, k) ladders at the corpus ids
# itself, so no (n, hmax, k) tensor is built (the JAX package gathers one
# for its Pallas kernel): LC-ACT the fused-gather ``act_phase2`` at nq=1,
# LC-RWMD and LC-OMR the all-rows form of ``cand_pour``'s corpus-row
# entry. rwmd_rev and ict have no kernel here, as in the JAX package.


def phase1(coords: torch.Tensor, q_ids: torch.Tensor, q_w: torch.Tensor,
           k: int):
    """Single-query Phase 1: the (v, h) distances to the query's bins
    (padding bins, weight 0, at the sentinel), then the k smallest per
    vocabulary row. Returns Z (v, k) ascending distances and W (v, k) the
    matching query capacities."""
    D = pairwise_dist(coords, coords[q_ids], b_ids=q_ids)
    D = torch.where(q_w[None, :] > 0.0, D, pad_dist_for(D.dtype))
    Z, S = streaming_smallest_k(D, k)
    return Z, q_w[S.long()]


def _phase1_one(corpus: Corpus, q_ids: torch.Tensor, q_w: torch.Tensor,
                k: int, use_kernels: bool, block_v: int | None = None,
                block_h: int | None = None):
    """Single-query Phase 1 through the ``dist_topk`` kernel (a batch of
    one, in the tile ``block_v`` x ``block_h``) or :func:`phase1`."""
    if use_kernels:
        Z, S = kops.dist_topk(corpus.coords, corpus.coords[q_ids],
                              q_w > 0.0, k, qids=q_ids, block_v=block_v,
                              block_h=block_h)
        return Z, q_w[S.long()]
    return phase1(corpus.coords, q_ids, q_w, k)


def lc_act_scores(corpus: Corpus, q_ids: torch.Tensor, q_w: torch.Tensor,
                  iters: int = 1, *, use_kernels: bool = False,
                  block_v: int | None = None, block_h: int | None = None
                  ) -> torch.Tensor:
    """LC-ACT of one query: lower bounds on EMD(x_u, q), the cost of
    moving each corpus row INTO the query, for all n rows -> (n,).

    Phase 2/3 gather the (n, hmax, k) ladders and pour them. Under
    ``use_kernels`` one launch reads the (v, k) ladders at the corpus ids
    instead: the fused-gather ``act_phase2`` at nq=1 (bitwise the unfused
    kernel on the gathered ladders), or at iters=0 (LC-RWMD: the nearest
    cost is dumped, no pour runs) the all-rows ``cand_pour_rows``.
    ``block_v`` / ``block_h``: K1's tile."""
    Z, W = _phase1_one(corpus, q_ids, q_w, iters + 1, use_kernels, block_v,
                       block_h)
    if use_kernels and iters == 0:
        return kops.cand_pour_rows(corpus.ids, corpus.w, None, Z[None], None,
                                   0)[0]
    if use_kernels:
        return kops.act_phase2_gather(corpus.w, corpus.ids, Z[None],
                                      W[None])[0]
    Zg = Z[corpus.ids]                                   # (n, hmax, k)
    if iters == 0:
        return torch.sum(corpus.w * Zg[..., 0], dim=-1)
    Wg = W[:, :iters][corpus.ids]                        # (n, hmax, iters)
    return pour(corpus.w, Zg, Wg, iters)


def lc_rwmd_scores(corpus: Corpus, q_ids: torch.Tensor, q_w: torch.Tensor,
                   *, use_kernels: bool = False, block_v: int | None = None,
                   block_h: int | None = None) -> torch.Tensor:
    """LC-RWMD of one query, direction db -> query (LC-ACT with zero
    Phase-2 rounds)."""
    return lc_act_scores(corpus, q_ids, q_w, iters=0,
                         use_kernels=use_kernels, block_v=block_v,
                         block_h=block_h)


def lc_rwmd_scores_rev(corpus: Corpus, q_ids: torch.Tensor,
                       q_w: torch.Tensor, block: int = 256) -> torch.Tensor:
    """LC-RWMD of one query, direction query -> db: each query bin ships
    to the nearest coordinate present in each corpus row, c[u, j] = min
    over the valid slots s of D[ids[u, s], j], then c[u] . q_w. In blocks
    of ``block`` rows (the last one ragged: no pad rows), each gathering
    its (block, hmax, h) costs. Invalid slots mask to the finite float32
    sentinel, so an all-padding row scores huge, never NaN. The
    contraction with q_w is a multiply then a sum over h, as the batched
    engine's (:func:`rev_min_sum`), so no block size changes a bit."""
    D = pairwise_dist(corpus.coords, corpus.coords[q_ids], b_ids=q_ids)
    big = pad_dist_for(D.dtype)
    out = []
    for s in range(0, corpus.n, block):
        Dg = D[corpus.ids[s:s + block]]                  # (b, hmax, h)
        Dg = torch.where((corpus.w[s:s + block] > 0.0)[..., None], Dg, big)
        out.append(torch.sum(Dg.amin(dim=1) * q_w, dim=-1))
    return torch.cat(out)


def lc_omr_scores(corpus: Corpus, q_ids: torch.Tensor, q_w: torch.Tensor,
                  *, use_kernels: bool = False, block_v: int | None = None,
                  block_h: int | None = None) -> torch.Tensor:
    """LC-OMR of one query: Algorithm 1 over every corpus row on the top-2
    Phase-1 ladders (under ``use_kernels`` the ``dist_topk`` kernel at
    k=2, then the all-rows ``cand_omr_rows``, which reads them at the
    corpus ids itself)."""
    Z, W = _phase1_one(corpus, q_ids, q_w, 2, use_kernels, block_v, block_h)
    if use_kernels:
        return kops.cand_omr_rows(corpus.ids, corpus.w, None, Z[None],
                                  W[None, :, 0].contiguous())[0]
    return omr_entries(corpus.w, Z[corpus.ids], W[:, 0][corpus.ids])


def lc_ict_scores(corpus: Corpus, q_ids: torch.Tensor,
                  q_w: torch.Tensor) -> torch.Tensor:
    """LC-ICT of one query: Algorithm 2 over every corpus row -> (n,).

    The JAX package gathers the (n, hmax, h) costs at once (18.8 GB at 20
    Newsgroups width). Here the query is first trimmed to its valid bins,
    whose order it keeps (its padding bins sort last at the sentinel with
    zero capacity, so nothing is poured there and the dump, the largest
    finite cost, is theirs too; a query without one keeps one padding bin
    and scores 0), and the rows go in blocks of at most ``GATHER_ELEMS``
    gathered costs. Trimming changes only the length of the sums over the
    bins, so the scores agree with JAX's to float32 rounding."""
    keep = torch.nonzero(q_w > 0.0)[:, 0]                # a sync
    if keep.numel() == 0:
        keep = keep.new_zeros(1)
    q_ids, q_w = q_ids[keep], q_w[keep]
    D = pairwise_dist(corpus.coords, corpus.coords[q_ids], b_ids=q_ids)
    D = torch.where(q_w[None, :] > 0.0, D, pad_dist_for(D.dtype))
    rows = max(1, GATHER_ELEMS // (corpus.hmax * q_ids.numel()))
    out = []
    for s in range(0, corpus.n, rows):
        C = D[corpus.ids[s:s + rows]]                    # (r, hmax, h')
        out.append(ict_pour(corpus.w[s:s + rows], q_w.expand(C.shape), C))
    return torch.cat(out)


def _map_query_blocks(fn, arrays, block_q: int) -> torch.Tensor:
    """Run ``fn`` over blocks of ``block_q`` queries (leading axis of every
    array) and concatenate the (bq, ...) results."""
    nq = arrays[0].shape[0]
    return torch.cat([fn(*(a[s:s + block_q] for a in arrays))
                      for s in range(0, nq, block_q)])


def _phase1_batched_dispatch(corpus: Corpus, Q_ids: torch.Tensor,
                             Q_w: torch.Tensor, k: int, use_kernels: bool,
                             precision: str = "f32",
                             block_v: int | None = None,
                             block_h: int | None = None, mesh=None):
    """Batched Phase 1 through the ``dist_topk`` kernel or the reference
    ops. Returns query-major Z, W (nq, v, k) in the storage dtype.

    Under a reduced compute dtype (``bf16_agg``) the kernel is given the
    coordinates in that dtype, as in the JAX package: its norms then come
    from the rounded coordinates too, where the reference path rounds only
    the cross term's operands (:func:`phase1_stacked_dist`).

    On a ``mesh`` whose ``model`` axis splits the vocabulary, the kernel
    runs on the rank's vocabulary slice and the ladders are gathered
    (``partition.dist_topk_sharded``); otherwise each rank runs the whole
    Phase 1 for its queries."""
    if use_kernels:
        policy = resolve_precision(precision)
        coords = corpus.coords
        if policy.compute_dtype is not None:
            coords = coords.to(policy.compute_dtype)
        if mesh is not None and mesh.size("model") > 1:
            from repro_torch.kernels import partition
            if partition.vocab_shardable(mesh, corpus.v):
                return partition.dist_topk_sharded(
                    mesh, coords, Q_ids, Q_w, k,
                    out_dtype=policy.storage_dtype, block_v=block_v,
                    block_h=block_h)
        Z, S = kops.dist_topk_batched(coords, coords[Q_ids], Q_w > 0.0, k,
                                      out_dtype=policy.storage_dtype,
                                      qids=Q_ids, block_v=block_v,
                                      block_h=block_h)
        return Z, gather_capacities(Q_w, S).to(policy.storage_dtype)
    return phase1_batched(corpus.coords, Q_ids, Q_w, k, precision=precision)


def pour_min_blocked(corpus: Corpus, Z0: torch.Tensor,
                     block_q: int) -> torch.Tensor:
    """Zero-round Phase 2 on the masked-min handoff Z0 (nq, v) -> (nq, n)."""
    def blk(Zb):                                         # (bq, v)
        return torch.sum(corpus.w * Zb[:, corpus.ids], dim=-1)
    return _map_query_blocks(blk, (Z0,), block_q)


def pour_blocked(corpus: Corpus, Z: torch.Tensor, W: torch.Tensor,
                 iters: int, block_q: int, *, use_kernels: bool = False,
                 block_n: int | None = None) -> torch.Tensor:
    """Query-blocked Phase 2/3: (nq, v, iters+1) ladders -> (nq, n)
    bounds. Each block of ``block_q`` queries gathers its (bq, n, hmax, k)
    ladders once and pours them; under ``use_kernels`` the whole batch goes
    to one launch instead, which reads the ladders at the corpus ids itself
    and so holds nothing per block: the fused-gather ``act_phase2`` kernel,
    or at ``iters=0`` (the nearest-cost dump of Phase 3) the all-rows form
    of ``cand_pour``'s corpus-row entry (either in the tile ``block_n``)."""
    x = corpus.w
    if iters == 0 and use_kernels:
        return kops.cand_pour_rows(corpus.ids, x, None, Z, None, 0,
                                   block_n=block_n)
    if iters == 0:
        def blk0(Zb):                                    # (bq, v, k)
            return torch.sum(x * Zb[..., 0][:, corpus.ids], dim=-1)
        return _map_query_blocks(blk0, (Z,), block_q)
    if use_kernels:
        return kops.act_phase2_gather(x, corpus.ids, Z, W, block_n=block_n)
    W = W[..., :iters]

    def blk(Zb, Wb):
        # Gather in the storage dtype, pour in the float32 accumulator.
        Zg = _accum(Zb[:, corpus.ids])                   # (bq, n, hmax, k)
        Wg = _accum(Wb[:, corpus.ids])                   # (bq, n, hmax, iters)
        return pour(x, Zg, Wg, iters)
    return _map_query_blocks(blk, (Z, W), block_q)


def lc_act_scores_batched(corpus: Corpus, Q_ids: torch.Tensor,
                          Q_w: torch.Tensor, iters: int = 1, *,
                          use_kernels: bool = False, block_q: int = 8,
                          precision: str = "f32", block_v: int | None = None,
                          block_h: int | None = None,
                          block_n: int | None = None,
                          mesh=None) -> torch.Tensor:
    """Batched LC-ACT: (nq, h) query batch -> (nq, n) lower bounds.
    ``block_v`` / ``block_h`` tile K1, ``block_n`` the Phase-2/3 kernel
    (None: the kernel's default tile; every tile gives the same bits).
    ``mesh``: the rank's shards on a mesh (module docstring)."""
    if iters == 0 and not use_kernels:
        Z0 = phase1_min_batched(corpus.coords, Q_ids, Q_w,
                                precision=precision)
        return pour_min_blocked(corpus, Z0, block_q)
    Z, W = _phase1_batched_dispatch(corpus, Q_ids, Q_w, iters + 1,
                                    use_kernels, precision, block_v, block_h,
                                    mesh)
    return pour_blocked(corpus, Z, W, iters, block_q,
                        use_kernels=use_kernels, block_n=block_n)


def lc_rwmd_scores_batched(corpus: Corpus, Q_ids: torch.Tensor,
                           Q_w: torch.Tensor, *, use_kernels: bool = False,
                           block_q: int = 8, precision: str = "f32",
                           block_v: int | None = None,
                           block_h: int | None = None,
                           block_n: int | None = None,
                           mesh=None) -> torch.Tensor:
    """Batched LC-RWMD db -> query (batched LC-ACT with zero rounds)."""
    return lc_act_scores_batched(corpus, Q_ids, Q_w, iters=0,
                                 use_kernels=use_kernels, block_q=block_q,
                                 precision=precision, block_v=block_v,
                                 block_h=block_h, block_n=block_n, mesh=mesh)


# ---------------------------------------------- distance-handoff engines


#: Most gathered costs (float32) one (bq, rows, hmax, h) block of a
#: distance-handoff reduction may hold: 2^26, 256 MiB.
GATHER_ELEMS = 1 << 26


def _rev_handoff(D: torch.Tensor) -> torch.Tensor:
    """(nq, v, h) query-major distance handoff from the stacked (v, nq, h)
    Phase-1 tensor, contiguous."""
    return D.movedim(1, 0).contiguous()


def gather_per_query(A: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-query gather: A (bq, v, ...) indexed on axis 1 by each query's
    own idx (bq, b, hmax) -> (bq, b, hmax, ...)."""
    q = torch.arange(A.shape[0], device=A.device)[:, None, None]
    return A[q, idx]


def reduce_dist_rows(reduce, Dq: torch.Tensor, Q_w: torch.Tensor,
                 idsg: torch.Tensor, xg: torch.Tensor, block_q: int,
                 rows: int | None = None) -> torch.Tensor:
    """Run ``reduce(C, x, qw) -> (bq, r)`` over the (bq, r, hmax, h)
    float32 cost blocks gathered from Dq (nq, v, h) at each query's own
    entry ids idsg (nq, b, hmax) (x: the matching weights), in blocks of
    ``block_q`` queries and ``rows`` rows (default: as many as
    ``GATHER_ELEMS`` allows). Returns (nq, b)."""
    nq, b, hmax = idsg.shape
    bq = min(block_q, nq)
    if rows is None:
        rows = max(1, GATHER_ELEMS // (bq * hmax * Dq.shape[-1]))
    out = []
    for s in range(0, nq, block_q):
        Db, Wb = Dq[s:s + block_q], Q_w[s:s + block_q]
        out.append(torch.cat([
            reduce(_accum(gather_per_query(Db, idsg[s:s + block_q,
                                                    r:r + rows])),
                   xg[s:s + block_q, r:r + rows], Wb)
            for r in range(0, b, rows)], dim=1))
    return torch.cat(out)


def _shared_rows(corpus: Corpus, nq: int):
    """The corpus rows as every query's own rows: (nq, n, hmax) views."""
    shape = (nq,) + tuple(corpus.ids.shape)
    return corpus.ids.expand(shape), corpus.w.expand(shape)


def rev_min_sum(C, x, qw):
    """Masked (min,+) by multiply then sum over h: unlike a dot (JAX
    contracts with einsum), its accumulation depends neither on the row
    count of the block nor on the number of queries."""
    cmin = torch.where((x > 0.0)[..., None], C,
                       pad_dist_for(C.dtype)).amin(dim=2)   # (bq, r, h)
    return torch.sum(cmin * qw[:, None, :], dim=-1)


def rev_min_blocked(corpus: Corpus, Dq: torch.Tensor, Q_w: torch.Tensor,
                    block: int, block_q: int) -> torch.Tensor:
    """Reverse-direction masked (min,+) reduction on the query-major
    distance handoff Dq (nq, v, h): for db row u and query bin j,
    c[u, j] = min over valid slots s of Dq[:, ids[u, s], j], then
    sum_j c[u, j] q_w[j], in (row-block, query-block) tiles of ``block``
    rows. Invalid slots mask to the float32 sentinel (finite, so an
    all-padding row scores huge instead of NaN)."""
    idsg, xg = _shared_rows(corpus, Dq.shape[0])
    return reduce_dist_rows(rev_min_sum, Dq, Q_w, idsg, xg, block_q,
                        rows=block)


def ict_pour(x: torch.Tensor, cap: torch.Tensor,
             C: torch.Tensor) -> torch.Tensor:
    """Full-ladder greedy pour (Algorithm 2) over padded entries.

    x:   (..., hmax) residual database weights.
    cap: (..., hmax, h) per-edge capacities (query weights; 0 at padded
         query bins).
    C:   (..., hmax, h) transport costs (the sentinel at padded query
         bins, so they sort last and their zero capacity absorbs nothing).
    Returns (...,) transport-cost bounds.

    The sort is stable: equal costs keep the lower query bin first. Any
    remainder is dumped at the max FINITE cost of the entry's row, never at
    the sentinel, where a ~1e-7 cumsum residue would explode to ~1e23.
    """
    order = torch.argsort(C, dim=-1, stable=True)
    cost_sorted = torch.take_along_dim(C, order, dim=-1)
    cap_sorted = torch.take_along_dim(cap, order, dim=-1)
    prefix = torch.cumsum(cap_sorted, dim=-1) - cap_sorted
    r = torch.minimum(torch.clamp_min(x[..., None] - prefix, 0.0),
                      cap_sorted)
    poured = torch.sum(r * cost_sorted, dim=-1)
    remainder = torch.clamp_min(x - torch.sum(r, dim=-1), 0.0)
    # Strict < : sentinel entries, upcast from any storage dtype, compare
    # >= the float32 pad value and are excluded.
    dump = torch.where(C < pad_dist_for(C.dtype), C, 0.0).amax(dim=-1)
    return torch.sum(poured + remainder * dump, dim=-1)


def ict_reduce(C, x, qw):
    """:func:`ict_pour` of (bq, r, hmax, h) costs with the query weights
    qw (bq, h) as every edge's capacity."""
    return ict_pour(x, qw[:, None, None, :].expand(C.shape), C)


def ict_reduce_blocked(corpus: Corpus, Dq: torch.Tensor, Q_w: torch.Tensor,
                       block_q: int) -> torch.Tensor:
    """Query-blocked Algorithm-2 reduction on the query-major distance
    handoff Dq (nq, v, h) -> (nq, n) LC-ICT bounds: gather each row's
    (hmax, h) costs and pour through the full sorted ladder."""
    idsg, xg = _shared_rows(corpus, Dq.shape[0])
    return reduce_dist_rows(ict_reduce, Dq, Q_w, idsg, xg, block_q)


def omr_reduce_blocked(corpus: Corpus, Z: torch.Tensor, W0: torch.Tensor,
                       block_q: int, *, use_kernels: bool = False,
                       block_n: int | None = None) -> torch.Tensor:
    """Query-blocked Algorithm-1 reduction on the top-2 handoff:
    Z (nq, v, 2), W0 (nq, v) -> (nq, n) LC-OMR bounds; under
    ``use_kernels`` one launch of ``cand_pour``'s all-rows form."""
    x = corpus.w
    if use_kernels:
        return kops.cand_omr_rows(corpus.ids, x, None, Z, W0.contiguous(),
                                  block_n=block_n)

    def blk(Zb, W0b):                                    # (bq, v, 2), (bq, v)
        Zg = Zb[:, corpus.ids]                           # (bq, n, hmax, 2)
        W0g = W0b[:, corpus.ids]                         # (bq, n, hmax)
        return omr_entries(x, Zg, W0g)
    return _map_query_blocks(blk, (Z, W0), block_q)


def omr_entries(x, Zg, W0g):
    """Algorithm 1 per entry: an entry whose nearest query bin is at cost 0
    (overlap) moves what that bin cannot take to the second-nearest; any
    other entry moves all of x to the nearest. Summed over hmax."""
    overlap = Zg[..., 0] == 0.0
    rest = x - torch.minimum(x, W0g)
    return torch.sum(torch.where(overlap, rest * Zg[..., 1],
                                 x * Zg[..., 0]), dim=-1)


def lc_rwmd_scores_rev_batched(corpus: Corpus, Q_ids: torch.Tensor,
                               Q_w: torch.Tensor, block: int = 256,
                               block_q: int = 8, precision: str = "f32", *,
                               use_kernels: bool = False,
                               block_n: int | None = None) -> torch.Tensor:
    """Batched LC-RWMD query -> db. ``use_kernels`` takes the valid-bin
    handoff and one launch of the all-rows form of K4's valid-bin entry
    (in the tile ``block_n``); otherwise one stacked distance tensor for
    the whole batch, through the (row-block, query-block) masked (min,+)
    reduction in blocks of ``block`` rows."""
    if use_kernels:
        return kops.cand_rev_min_valid(
            corpus.ids, corpus.w, None,
            *phase1_valid_dist(corpus.coords, Q_ids, Q_w, precision),
            block_n=block_n)
    Dq = _rev_handoff(phase1_stacked_dist(corpus.coords, Q_ids, Q_w,
                                          precision=precision))
    return rev_min_blocked(corpus, Dq, Q_w, block, block_q)


def lc_omr_scores_batched(corpus: Corpus, Q_ids: torch.Tensor,
                          Q_w: torch.Tensor, *, use_kernels: bool = False,
                          block_q: int = 8, precision: str = "f32",
                          block_v: int | None = None,
                          block_h: int | None = None,
                          block_n: int | None = None,
                          mesh=None) -> torch.Tensor:
    """Batched LC-OMR: batched Phase 1 with k=2 (the ``dist_topk`` kernel
    when ``use_kernels``), query-blocked Algorithm-1 reduction (one
    ``cand_pour`` launch when ``use_kernels``)."""
    Z, W = _phase1_batched_dispatch(corpus, Q_ids, Q_w, 2, use_kernels,
                                    precision, block_v, block_h, mesh)
    return omr_reduce_blocked(corpus, Z, W[..., 0], block_q,
                              use_kernels=use_kernels, block_n=block_n)


def lc_ict_scores_batched(corpus: Corpus, Q_ids: torch.Tensor,
                          Q_w: torch.Tensor, *, use_kernels: bool = False,
                          block_q: int = 8, precision: str = "f32",
                          block_n: int | None = None) -> torch.Tensor:
    """Batched LC-ICT. ``use_kernels`` takes the valid-bin handoff and one
    launch of the all-rows form of K4's valid-bin entry; otherwise one
    stacked Phase-1 distance tensor for the whole query batch,
    query-blocked full-ladder pour."""
    if use_kernels:
        return kops.cand_ict_valid(
            corpus.ids, corpus.w, None,
            *phase1_valid_dist(corpus.coords, Q_ids, Q_w, precision),
            block_n=block_n)
    Dq = _rev_handoff(phase1_stacked_dist(corpus.coords, Q_ids, Q_w,
                                          precision=precision))
    return ict_reduce_blocked(corpus, Dq, Q_w, block_q)


def lc_rwmd_symmetric_scores_batched(corpus: Corpus, Q_ids: torch.Tensor,
                                     Q_w: torch.Tensor, block: int = 256,
                                     block_q: int = 8,
                                     precision: str = "f32") -> torch.Tensor:
    """Symmetric batched LC-RWMD: the max of the two directional bounds,
    both read from ONE stacked Phase-1 distance tensor (the forward
    masked-min row and the reverse (min,+) reduction)."""
    D = phase1_stacked_dist(corpus.coords, Q_ids, Q_w, precision=precision)
    fwd = pour_min_blocked(corpus, _min_handoff(D), block_q)
    rev = rev_min_blocked(corpus, _rev_handoff(D), Q_w, block, block_q)
    return torch.maximum(fwd, rev)


#: Rows and columns of a tile of :func:`symmetric_scores`.
SYM_TILE = 4096


def symmetric_scores(asym: torch.Tensor) -> torch.Tensor:
    """Corpus-vs-corpus symmetrization, IN PLACE: asym[a, b] = cost(move b
    into a) becomes max(asym[a, b], asym[b, a]), the paper's symmetric
    measure (JAX: ``max(asym, asym.T)``, a second n x n array). Tile pairs
    (i, j), j >= i, of ``SYM_TILE`` rows are read and written together, so
    the extra memory is two tiles. Returns ``asym``."""
    n = asym.shape[0]
    for i in range(0, n, SYM_TILE):
        rows = slice(i, i + SYM_TILE)
        for j in range(i, n, SYM_TILE):
            cols = slice(j, j + SYM_TILE)
            m = torch.maximum(asym[rows, cols], asym[cols, rows].T)
            asym[rows, cols] = m
            asym[cols, rows] = m.T
    return asym


# --------------------------------------------------------------------------
# Candidate-compacted Phase 2/3: the cascade's gather-compaction layer.
#
# A cascade scores stage s+1 only on the (nq, b) candidate rows that
# survived stage s. Phase 1 never depends on which database rows are
# scored, so compaction is a Phase-2/3 matter: the same consumers as above,
# gathering each query's own (b, hmax) sub-corpus (``corpus.ids[cand]``)
# instead of all n rows. ``use_kernels`` fuses the candidate-row gather,
# the per-query ladder gather and the reduction into one launch per batch
# of ``cand_pour``'s corpus-row entry, so neither the (nq, b, hmax) rows
# nor the (nq, b, hmax, k) ladders reach memory; ``rwmd_rev`` and ``ict``
# go to the valid-bin ``cand_dist`` entry, one launch per batch, which
# also reads the candidate rows from the corpus itself.
# --------------------------------------------------------------------------


def pour_min_cand_blocked(corpus: Corpus, Z0: torch.Tensor,
                          cand: torch.Tensor, block_q: int, *,
                          use_kernels: bool = False,
                          block_n: int | None = None) -> torch.Tensor:
    """Candidate-compacted zero-round pour: Z0 (nq, v), cand (nq, b)
    -> (nq, b) scores at the candidate rows."""
    if use_kernels:
        return kops.cand_pour_rows(corpus.ids, corpus.w,
                                   cand.long().contiguous(),
                                   Z0[..., None].contiguous(), None, 0,
                                   block_n=block_n)

    def blk(Zb, cb):
        Zg = gather_per_query(Zb, corpus.ids[cb])       # (bq, b, hmax)
        return torch.sum(corpus.w[cb] * Zg, dim=-1)
    return _map_query_blocks(blk, (Z0, cand), block_q)


def pour_cand_blocked(corpus: Corpus, Z: torch.Tensor, W: torch.Tensor,
                      cand: torch.Tensor, iters: int, block_q: int, *,
                      use_kernels: bool = False,
                      block_n: int | None = None) -> torch.Tensor:
    """Candidate-compacted Phase 2/3 pour: (nq, v, k) handoff ladders +
    (nq, b) candidate rows -> (nq, b) lower bounds."""
    if iters == 0:
        return pour_min_cand_blocked(corpus, Z[..., 0], cand, block_q,
                                     use_kernels=use_kernels,
                                     block_n=block_n)
    if use_kernels:
        # The kernel reads the first iters capacity columns itself.
        return kops.cand_pour_rows(corpus.ids, corpus.w,
                                   cand.long().contiguous(), Z, W, iters,
                                   block_n=block_n)
    W = W[..., :iters]

    def blk(Zb, Wb, cb):
        ids_g = corpus.ids[cb]                           # (bq, b, hmax)
        # Gather in the storage dtype, pour in the float32 accumulator.
        Zg = _accum(gather_per_query(Zb, ids_g))        # (bq, b, hmax, k)
        Wg = _accum(gather_per_query(Wb, ids_g))        # (bq, b, hmax, iters)
        return pour(corpus.w[cb], Zg, Wg, iters)
    return _map_query_blocks(blk, (Z, W, cand), block_q)


def omr_reduce_cand_blocked(corpus: Corpus, Z: torch.Tensor,
                            W0: torch.Tensor, cand: torch.Tensor,
                            block_q: int, *, use_kernels: bool = False,
                            block_n: int | None = None) -> torch.Tensor:
    """Candidate-compacted Algorithm-1 reduction: Z (nq, v, 2), W0 (nq, v),
    cand (nq, b) -> (nq, b) LC-OMR bounds."""
    if use_kernels:
        return kops.cand_omr_rows(corpus.ids, corpus.w,
                                  cand.long().contiguous(), Z,
                                  W0.contiguous(), block_n=block_n)

    def blk(Zb, W0b, cb):
        ids_g = corpus.ids[cb]
        return omr_entries(corpus.w[cb], gather_per_query(Zb, ids_g),
                            gather_per_query(W0b, ids_g))
    return _map_query_blocks(blk, (Z, W0, cand), block_q)


def rev_min_cand_blocked(corpus: Corpus, Dq: torch.Tensor,
                         Q_w: torch.Tensor, cand: torch.Tensor,
                         block_q: int) -> torch.Tensor:
    """Candidate-compacted reverse masked (min,+) reduction: Dq (nq, v, h),
    cand (nq, b) -> (nq, b) reverse-RWMD bounds. Masking and reduction run
    in float32, the sentinel written in float32 (never a reduced storage
    dtype); the contraction is a multiply then a sum over h."""
    idsg, xg = corpus.ids[cand], corpus.w[cand]
    return reduce_dist_rows(rev_min_sum, Dq, Q_w, idsg, xg, block_q)


def ict_reduce_cand_blocked(corpus: Corpus, Dq: torch.Tensor,
                            Q_w: torch.Tensor, cand: torch.Tensor,
                            block_q: int) -> torch.Tensor:
    """Candidate-compacted Algorithm-2 reduction: Dq (nq, v, h),
    cand (nq, b) -> (nq, b) LC-ICT bounds, the remainder dumped at the max
    finite cost (see :func:`ict_pour`)."""
    idsg, xg = corpus.ids[cand], corpus.w[cand]
    return reduce_dist_rows(ict_reduce, Dq, Q_w, idsg, xg, block_q)


def lc_act_scores_cand(corpus: Corpus, Q_ids: torch.Tensor,
                       Q_w: torch.Tensor, cand: torch.Tensor,
                       iters: int = 1, *, use_kernels: bool = False,
                       block_q: int = 8, precision: str = "f32",
                       block_v: int | None = None, block_h: int | None = None,
                       block_n: int | None = None,
                       mesh=None) -> torch.Tensor:
    """Candidate-compacted batched LC-ACT: (nq, h) queries scored against
    each query's own (b,) candidate rows -> (nq, b). ``mesh``: Phase 1 on
    the mesh (the candidate rows are the caller's, already exchanged)."""
    if iters == 0 and not use_kernels:
        Z0 = phase1_min_batched(corpus.coords, Q_ids, Q_w,
                                precision=precision)
        return pour_min_cand_blocked(corpus, Z0, cand, block_q)
    Z, W = _phase1_batched_dispatch(corpus, Q_ids, Q_w, iters + 1,
                                    use_kernels, precision, block_v, block_h,
                                    mesh)
    return pour_cand_blocked(corpus, Z, W, cand, iters, block_q,
                             use_kernels=use_kernels, block_n=block_n)


def lc_rwmd_scores_cand(corpus: Corpus, Q_ids: torch.Tensor,
                        Q_w: torch.Tensor, cand: torch.Tensor, *,
                        use_kernels: bool = False, block_q: int = 8,
                        precision: str = "f32", block_v: int | None = None,
                        block_h: int | None = None,
                        block_n: int | None = None,
                        mesh=None) -> torch.Tensor:
    """Candidate-compacted batched LC-RWMD db -> query."""
    return lc_act_scores_cand(corpus, Q_ids, Q_w, cand, iters=0,
                              use_kernels=use_kernels, block_q=block_q,
                              precision=precision, block_v=block_v,
                              block_h=block_h, block_n=block_n, mesh=mesh)


def lc_rwmd_scores_rev_cand(corpus: Corpus, Q_ids: torch.Tensor,
                            Q_w: torch.Tensor, cand: torch.Tensor, *,
                            use_kernels: bool = False, block_q: int = 8,
                            precision: str = "f32",
                            block_n: int | None = None) -> torch.Tensor:
    """Candidate-compacted batched LC-RWMD query -> db. ``use_kernels``
    takes the valid-bin handoff and K4's valid-bin entry, in one launch;
    otherwise the stacked handoff and the reference reduction."""
    if use_kernels:
        return kops.cand_rev_min_valid(
            corpus.ids, corpus.w, cand.long().contiguous(),
            *phase1_valid_dist(corpus.coords, Q_ids, Q_w, precision),
            block_n=block_n)
    Dq = _rev_handoff(phase1_stacked_dist(corpus.coords, Q_ids, Q_w,
                                          precision=precision))
    return rev_min_cand_blocked(corpus, Dq, Q_w, cand, block_q)


def lc_omr_scores_cand(corpus: Corpus, Q_ids: torch.Tensor,
                       Q_w: torch.Tensor, cand: torch.Tensor, *,
                       use_kernels: bool = False, block_q: int = 8,
                       precision: str = "f32", block_v: int | None = None,
                       block_h: int | None = None,
                       block_n: int | None = None,
                       mesh=None) -> torch.Tensor:
    """Candidate-compacted batched LC-OMR."""
    Z, W = _phase1_batched_dispatch(corpus, Q_ids, Q_w, 2, use_kernels,
                                    precision, block_v, block_h, mesh)
    return omr_reduce_cand_blocked(corpus, Z, W[..., 0], cand, block_q,
                                   use_kernels=use_kernels, block_n=block_n)


def lc_ict_scores_cand(corpus: Corpus, Q_ids: torch.Tensor,
                       Q_w: torch.Tensor, cand: torch.Tensor, *,
                       use_kernels: bool = False, block_q: int = 8,
                       precision: str = "f32",
                       block_n: int | None = None) -> torch.Tensor:
    """Candidate-compacted batched LC-ICT (the cascade's tight rescorer).
    ``use_kernels`` takes the valid-bin handoff and K4's valid-bin entry,
    in one launch; otherwise the stacked handoff and the reference
    reduction."""
    if use_kernels:
        return kops.cand_ict_valid(
            corpus.ids, corpus.w, cand.long().contiguous(),
            *phase1_valid_dist(corpus.coords, Q_ids, Q_w, precision),
            block_n=block_n)
    Dq = _rev_handoff(phase1_stacked_dist(corpus.coords, Q_ids, Q_w,
                                          precision=precision))
    return ict_reduce_cand_blocked(corpus, Dq, Q_w, cand, block_q)
