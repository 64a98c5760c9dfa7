"""Cascaded search: prune with cheap bounds, rescore the survivors.

One search is a ladder of ``(method, budget)`` stages (``CascadeSpec``):
stage 1 scores the FULL corpus through the registry's batched engine (or,
when the spec names a sublinear candidate source, ``repro_torch.
candidates``, only the rows the built source emits, through the candidate
engines) and keeps its ``budget`` best rows per query; every later stage
scores only the surviving candidates through the method's
candidate-compacted engine (``retrieval.cand_scores``: Phase 1 unchanged,
Phase 2/3 gathered from a ``(nq, budget)`` sub-corpus); the final rescorer
ranks the last survivors and the top-l comes from ITS scores, mapped back
to global row ids.

The port's own copy of the JAX package's ``cascade/search.py``. Stages run
eagerly, one after the other; the exact ``emd`` rescorer prunes on the
device and rescores on the host.

On a mesh (``mesh=``, a ``launch.mesh.Mesh``) the corpus is the rank's row
shard and the queries its data shard. Stage 1's top-budget is then
shard-blocked (``topk_blocks`` = the ``model`` size): each model rank
selects its winners with global row ids, and only those cross the mesh
(``annotate.emd_shard_topk``), never the score matrix. Later stages score
the merged candidates, whose rows are exchanged over ``model``
(``kernels/partition.cand_sharded``). The host rescorer raises there.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.cascade import rescore
from repro_torch.cascade.spec import CascadeSpec, resolve_spec
from repro_torch.core import lc, retrieval
from repro_torch.kernels import partition
from repro_torch.sharding import annotate


class CascadeResult(NamedTuple):
    """Top-l outcome of one cascaded search: ascending rescorer scores and
    the matching global database row ids, (nq, top_l) each."""
    scores: torch.Tensor
    indices: torch.Tensor


def _first_k(scores: torch.Tensor, k: int):
    values, idx = torch.sort(scores, dim=-1, stable=True)
    return values[..., :k], idx[..., :k]


def _merge(values: torch.Tensor, ids: torch.Tensor, k: int):
    """The k smallest of the blocks' winners, laid out block after block:
    a stable sort keeps ties in (block, local rank) order."""
    v, pos = _first_k(values, k)
    return v, torch.gather(ids, -1, pos)


def topk_smallest(scores: torch.Tensor, k: int, blocks: int = 1, *,
                  mesh=None):
    """(values, indices) of the k smallest entries per row, ascending, the
    lowest index first among ties (``lax.top_k`` of the negated scores),
    by a stable sort.

    ``blocks > 1`` runs the shard-blocked schedule of the JAX package:
    each of ``blocks`` column blocks selects its min(k, n/blocks)
    smallest, and one merge over the winners picks the k. A block holds at
    most that many of the true k, so the result is the plain one; ties
    merge in (block, local rank) order, which is the lowest index first.
    An n that does not split takes the plain sort. On a ``mesh`` whose
    ``model`` axis has more than one rank, ``scores`` is this rank's
    column block (the model shard of the rows), ``blocks`` must be the
    ``model`` size, and the winners are gathered over ``model``
    (``annotate.emd_shard_topk``): the indices are global."""
    n_local = scores.shape[-1]
    if mesh is not None and mesh.size("model") > 1:
        if blocks != mesh.size("model"):
            raise ValueError(f"topk_blocks={blocks} on a mesh of "
                             f"{mesh.size('model')} model ranks; the "
                             "blocks are the model shards")
        n = n_local * blocks
        if not 1 <= k <= n:
            raise ValueError(f"k must be in [1, {n}], got {k}")
        v, i = _first_k(scores, min(k, n_local))
        i = i + mesh.index("model") * n_local
        return _merge(annotate.emd_shard_topk(v, mesh),
                      annotate.emd_shard_topk(i, mesh), k)
    if not 1 <= k <= n_local:
        raise ValueError(f"k must be in [1, {n_local}], got {k}")
    if blocks <= 1 or n_local % blocks:
        return _first_k(scores, k)
    per = n_local // blocks
    v, i = _first_k(scores.reshape(scores.shape[:-1] + (blocks, per)),
                    min(k, per))
    i = i + per * torch.arange(blocks, device=i.device)[:, None]
    flat = scores.shape[:-1] + (-1,)
    return _merge(v.reshape(flat), i.reshape(flat), k)


def _source_budgets(spec: CascadeSpec, budgets: tuple[int, ...],
                    width: int, top_l: int) -> tuple[int, ...]:
    """Clamp the resolved budget ladder to a sourced stage 1's candidate
    ``width``: the source already pruned below any larger budget."""
    if width < top_l:
        raise ValueError(
            f"candidate source emits {width} rows per query, fewer than "
            f"top_l={top_l} ({spec.describe()})")
    return tuple(min(b, width) for b in budgets)


def _resolved_budgets(spec: CascadeSpec, source, n: int,
                      top_l: int) -> tuple[int, ...]:
    """Budget ladder for one search: fraction resolution, and sourced
    clamping to the built source's candidate width."""
    budgets = spec.resolve_budgets(n, top_l)
    if source is not None and not source.spec.full_scan:
        budgets = _source_budgets(spec, budgets, source.width, top_l)
    return budgets


def stage_rows(spec: CascadeSpec, n: int, top_l: int) -> dict[str, int]:
    """Rows scored per query by each stage of ``spec`` on an ``n``-row
    corpus: stage 1 reads the full corpus (or, sourced, only the source's
    candidate width), later stages and the rescorer read the previous
    stage's survivors (the budget ladder)."""
    budgets = spec.resolve_budgets(n, top_l)
    prev = n
    if spec.sourced and spec.source.width is not None:
        prev = min(spec.source.width, n)
        budgets = _source_budgets(spec, budgets, prev, top_l)
    rows = {}
    for i, s in enumerate(spec.stages):
        rows[f"stage{i + 1}.{s.method}"] = prev
        prev = budgets[i]
    rows[f"rescore.{spec.rescorer}"] = prev
    return rows


def _masked(scores: torch.Tensor, cmask) -> torch.Tensor:
    """Push the scores of dead candidate slots to the sentinel, so they
    rank last (``cmask`` None: every slot is a real row)."""
    return scores if cmask is None else torch.where(cmask, scores,
                                                    lc.PAD_DIST)


def _prune(corpus: lc.Corpus, Q_ids: torch.Tensor, Q_w: torch.Tensor,
           spec: CascadeSpec, budgets: tuple[int, ...], *, n_valid,
           topk_blocks, engine, source=None, mesh=None, **knobs):
    """Run the pruning ladder; returns ``(cand, cmask)``: the
    (nq, budgets[-1]) global row ids surviving every stage, and their
    validity mask when stage 1 was fed by a sublinear source (``None`` on
    the full-scan path, where every survivor is a real row).

    Full scan: stage 1 scores the full corpus with the ``engine`` of
    ``retrieval.batch_scores``. A sourced stage 1 scores only the source's
    candidate rows through the candidate engine, with the dead slots (rows
    of under-full buckets, which the tables fill with row 0) pushed to the
    sentinel so they rank last; the mask rides along the ladder, because a
    later stage can still keep one when a query's probed buckets hold fewer
    real rows than its budget.

    On a ``mesh`` stage 1 scores the rank's rows, whose first global id is
    ``row0``, and the pad mask and the top-budget work on that block."""
    first = spec.stages[0]
    if source is None or source.spec.full_scan:
        s = retrieval.batch_scores(corpus, Q_ids, Q_w, method=first.method,
                                   iters=first.iters, engine=engine,
                                   mesh=mesh, **knobs)
        if n_valid is not None and mesh is not None:
            n_valid = max(0, n_valid - mesh.index("model") * corpus.n)
        _, cand = topk_smallest(lc.mask_pad_rows(s, n_valid), budgets[0],
                                topk_blocks, mesh=mesh)
        cmask, stages = None, zip(spec.stages[1:], budgets[1:], strict=True)
    else:
        cand, cmask = source.candidates(corpus, Q_ids, Q_w)
        cand = cand.long()
        stages = zip(spec.stages, budgets, strict=True)
    for stage, b in stages:
        sc = retrieval.cand_scores(corpus, Q_ids, Q_w, cand,
                                   method=stage.method, iters=stage.iters,
                                   mesh=mesh, **knobs)
        _, pos = topk_smallest(_masked(sc, cmask), b)
        cand = torch.gather(cand, 1, pos)
        if cmask is not None:
            cmask = torch.gather(cmask, 1, pos)
    return cand, cmask


def cascade_search(corpus: lc.Corpus, Q_ids: torch.Tensor,
                   Q_w: torch.Tensor, spec: CascadeSpec | str, top_l: int,
                   *, n_valid: int | None = None, topk_blocks: int = 1,
                   engine: str = "batched", use_kernels: bool = False,
                   block_q: int = 8, precision: str = "f32",
                   block_v: int | None = None, block_h: int | None = None,
                   block_n: int | None = None, rev_block: int = 256,
                   source=None, mesh=None) -> CascadeResult:
    """Cascaded top-l search of a ``(nq, h)`` query batch.

    ``spec`` is a :class:`~repro_torch.cascade.spec.CascadeSpec` or a
    preset name from :data:`~repro_torch.cascade.spec.CASCADES`.
    ``n_valid`` keeps zero-weight pad rows beyond it out of candidacy.
    ``engine`` is stage 1's ``retrieval.batch_scores`` engine (``scan``
    scores it one query at a time, float32). ``use_kernels`` sends stage 1
    through the Phase-1/2 kernels and every candidate stage and device
    rescorer of the LC methods through the candidate kernels
    (``kernels/cand_pour``). ``precision`` reaches every stage and device
    rescorer (under ``bf16_agg`` the kernels' coordinates are bfloat16 and
    the distance handoffs' products have bfloat16 operands). The tile
    knobs ``block_v`` / ``block_h`` (K1) and ``block_n`` (the Phase-2/3 and
    candidate kernels), and ``rev_block``, reach every stage and device
    rescorer as in ``retrieval.batch_scores``; no knob changes a score.

    ``source`` is a BUILT candidate source (``spec.source.build(corpus)``,
    or the one ``EmdIndex.build`` keeps), required when ``spec.sourced``:
    stage 1 then scores only the sourced candidates, at the price of
    measured recall.

    ``mesh``: the rank's shards of a mesh (``corpus`` its row shard,
    ``Q_ids`` / ``Q_w`` its queries); the result is its queries' (nq/dp,
    top_l), the same on every model rank, with global row ids. A host
    rescorer raises there.
    """
    spec = resolve_spec(spec)
    if spec.sourced:
        if source is None:
            raise ValueError(
                f"cascade {spec.describe()} is sourced but no built "
                "candidate source was passed; build one with "
                "spec.source.build(corpus) (EmdIndex does this for you)")
        if source.spec != spec.source:
            raise ValueError(
                f"built source {source.spec.describe()} does not match "
                f"the cascade's source spec {spec.source.describe()}")
    elif source is not None and not source.spec.full_scan:
        raise ValueError(
            f"a {source.spec.describe()} source was passed but cascade "
            f"{spec.describe()} does not declare one (set "
            "CascadeSpec.source so admissibility accounting sees it)")
    knobs = dict(use_kernels=use_kernels, block_q=block_q,
                 precision=precision, block_v=block_v, block_h=block_h,
                 block_n=block_n, rev_block=rev_block)
    if top_l < 1:
        raise ValueError(f"top_l must be >= 1, got {top_l}")
    resc = rescore.resolve(spec.rescorer)
    if mesh is not None and not resc.jittable:
        raise ValueError(
            f"rescorer {spec.rescorer!r} runs on the host and cannot run on "
            "the mesh; use a device rescorer (act/ict/sinkhorn/...) or run "
            "the cascade on a single device")
    n_rows = corpus.n * (1 if mesh is None else mesh.size("model"))
    n = n_valid if n_valid is not None else n_rows
    budgets = _resolved_budgets(spec, source, n, top_l)
    cand, cmask = _prune(corpus, Q_ids, Q_w, spec, budgets, n_valid=n_valid,
                         topk_blocks=topk_blocks, engine=engine,
                         source=source, mesh=mesh, **knobs)
    if resc.jittable:
        if mesh is None:
            rescored = resc.fn(corpus, Q_ids, Q_w, cand,
                               iters=spec.rescorer_iters, **knobs)
        else:
            rescored = partition.cand_sharded(mesh, resc.fn, corpus, Q_ids,
                                              Q_w, cand,
                                              iters=spec.rescorer_iters,
                                              **knobs)
        vals, pos = topk_smallest(_masked(rescored, cmask), top_l)
        return CascadeResult(vals, torch.gather(cand, 1, pos))
    # Host rescorer (exact emd): device pruning, numpy rescoring.
    cand = cand.cpu().numpy()
    rescored = resc.host_fn(corpus, Q_ids, Q_w, cand)
    if cmask is not None:
        rescored = np.where(cmask.cpu().numpy(), rescored, lc.PAD_DIST)
    pos = np.argsort(rescored, axis=1, kind="stable")[:, :top_l]
    device = corpus.device
    return CascadeResult(
        torch.tensor(np.take_along_axis(rescored, pos, axis=1),
                     dtype=torch.float32, device=device),
        torch.tensor(np.take_along_axis(cand, pos, axis=1), device=device))


def topk_recall(indices, ref_indices) -> float:
    """Fraction of the reference top-l retrieved by ``indices``, averaged
    over queries (1.0 for an admissible cascade with sufficient budgets).
    Delegates to :func:`retrieval.topl_overlap`."""
    return retrieval.topl_overlap(indices, ref_indices)
