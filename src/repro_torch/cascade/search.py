"""Cascaded search: prune with cheap bounds, rescore the survivors.

One search is a ladder of ``(method, budget)`` stages (``CascadeSpec``):
stage 1 scores the FULL corpus through the registry's batched engine and
keeps its ``budget`` best rows per query; every later stage scores only
the surviving candidates through the method's candidate-compacted engine
(``retrieval.cand_scores``: Phase 1 unchanged, Phase 2/3 gathered from a
``(nq, budget)`` sub-corpus); the final rescorer ranks the last survivors
and the top-l comes from ITS scores, mapped back to global row ids.

The port's own copy of the JAX package's ``cascade/search.py``. Stages run
eagerly, one after the other; the exact ``emd`` rescorer prunes on the
device and rescores on the host. Candidate sources and the shard-blocked
top-budget of the mesh (``topk_blocks > 1``) are not yet ported and raise.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.cascade import rescore
from repro_torch.cascade.spec import CascadeSpec, resolve_spec
from repro_torch.core import lc, retrieval


class CascadeResult(NamedTuple):
    """Top-l outcome of one cascaded search: ascending rescorer scores and
    the matching global database row ids, (nq, top_l) each."""
    scores: torch.Tensor
    indices: torch.Tensor


def topk_smallest(scores: torch.Tensor, k: int, blocks: int = 1):
    """(values, indices) of the k smallest entries per row, ascending, the
    lowest index first among ties (``lax.top_k`` of the negated scores),
    by a stable sort. ``blocks > 1``, the mesh's shard-blocked schedule,
    is not yet ported."""
    if blocks != 1:
        raise ValueError(f"topk_blocks={blocks} is not yet ported: the "
                         "shard-blocked top-budget needs the mesh")
    if not 1 <= k <= scores.shape[-1]:
        raise ValueError(f"k must be in [1, {scores.shape[-1]}], got {k}")
    values, idx = torch.sort(scores, dim=-1, stable=True)
    return values[..., :k], idx[..., :k]


def stage_rows(spec: CascadeSpec, n: int, top_l: int) -> dict[str, int]:
    """Rows scored per query by each stage of ``spec`` on an ``n``-row
    corpus: stage 1 reads the full corpus, later stages and the rescorer
    read the previous stage's survivors (the budget ladder)."""
    budgets = spec.resolve_budgets(n, top_l)
    rows, prev = {}, n
    for i, s in enumerate(spec.stages):
        rows[f"stage{i + 1}.{s.method}"] = prev
        prev = budgets[i]
    rows[f"rescore.{spec.rescorer}"] = prev
    return rows


def _prune(corpus: lc.Corpus, Q_ids: torch.Tensor, Q_w: torch.Tensor,
           spec: CascadeSpec, budgets: tuple[int, ...], *, n_valid,
           topk_blocks, engine, **knobs) -> torch.Tensor:
    """Run the pruning ladder; returns the (nq, budgets[-1]) global row
    ids surviving every stage. Stage 1 scores the full corpus with the
    ``engine`` of ``retrieval.batch_scores``."""
    first = spec.stages[0]
    s = retrieval.batch_scores(corpus, Q_ids, Q_w, method=first.method,
                               iters=first.iters, engine=engine, **knobs)
    _, cand = topk_smallest(lc.mask_pad_rows(s, n_valid), budgets[0],
                            topk_blocks)
    for stage, b in zip(spec.stages[1:], budgets[1:], strict=True):
        sc = retrieval.cand_scores(corpus, Q_ids, Q_w, cand,
                                   method=stage.method, iters=stage.iters,
                                   **knobs)
        _, pos = topk_smallest(sc, b)
        cand = torch.gather(cand, 1, pos)
    return cand


def cascade_search(corpus: lc.Corpus, Q_ids: torch.Tensor,
                   Q_w: torch.Tensor, spec: CascadeSpec | str, top_l: int,
                   *, n_valid: int | None = None, topk_blocks: int = 1,
                   engine: str = "batched", use_kernels: bool = False,
                   block_q: int = 8, precision: str = "f32") -> CascadeResult:
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
    the distance handoffs' products have bfloat16 operands).
    """
    spec = resolve_spec(spec)
    knobs = dict(use_kernels=use_kernels, block_q=block_q,
                 precision=precision)
    if top_l < 1:
        raise ValueError(f"top_l must be >= 1, got {top_l}")
    n = n_valid if n_valid is not None else corpus.n
    budgets = spec.resolve_budgets(n, top_l)
    cand = _prune(corpus, Q_ids, Q_w, spec, budgets, n_valid=n_valid,
                  topk_blocks=topk_blocks, engine=engine, **knobs)
    resc = rescore.resolve(spec.rescorer)
    if resc.jittable:
        rescored = resc.fn(corpus, Q_ids, Q_w, cand,
                           iters=spec.rescorer_iters, **knobs)
        vals, pos = topk_smallest(rescored, top_l)
        return CascadeResult(vals, torch.gather(cand, 1, pos))
    # Host rescorer (exact emd): device pruning, numpy rescoring.
    cand = cand.cpu().numpy()
    rescored = resc.host_fn(corpus, Q_ids, Q_w, cand)
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
