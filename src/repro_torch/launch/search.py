"""Distributed EMD similarity search: the JAX package's ``launch/search.py``
on a ``torch.distributed`` (data, model) mesh.

Each step takes the rank's shards of its five operands (corpus ids and
weights, coordinates, query ids and weights), laid out by
:data:`SEARCH_PLAN`: queries over ``data``, corpus rows over ``model``,
the vocabulary coordinates replicated (the kernel path's Phase 1 slices
them itself where the vocabulary divides, ``kernels/partition``). The
steps hold no scoring math of their own: they wrap the shards back into a
:class:`~repro_torch.core.lc.Corpus` and run ``retrieval.batch_scores`` or
``cascade.cascade_search`` with the mesh, whose engines launch the port's
kernels on the shards and call the collectives of ``sharding.annotate``.
Every rank passes its shards and gets the whole result back:

* scores - the rank's (nq/dp, n/mp) block (``MethodSpec.dist_out``),
  gathered over both axes;
* search - pad rows masked to the sentinel first (zero-weight pad rows
  otherwise score 0, the best score), then the shard-blocked top-l: each
  model rank selects its winners and only those cross the mesh, then the
  (nq/dp, top_l) results are gathered over ``data``;
* cascade - stage 1's shard-blocked top-budget, then at every later
  stage each model rank scores the candidates it owns and the scores are
  summed over ``model``; the results gathered over ``data``. A sourced
  cascade takes its source's tables as trailing operands, replicated.

Serving callers reach this through ``repro_torch.api.EmdIndex``
(``backend="distributed"``), which holds the rank's shards.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import lc, retrieval
from repro_torch.kernels import partition
from repro_torch.launch.mesh import model_axis_size
from repro_torch.sharding import annotate

#: Corpus rows are padded to a multiple of this so that they split over
#: any mesh (``EngineConfig.pad_multiple``).
DEFAULT_ROW_PAD_MULTIPLE = 512

#: The shard plan of a step's operands: for each, the mesh axis that
#: splits each of its dims (None: replicated). JAX's ``search_shardings``.
SEARCH_PLAN = {
    "corpus_ids": ("model", None),   # (n, hmax)
    "corpus_w": ("model", None),     # (n, hmax)
    "coords": (None, None),          # (v, m)
    "q_ids": ("data", None),         # (nq, hmax)
    "q_w": ("data", None),           # (nq, hmax)
}


def shard(mesh, x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """This rank's part of ``x`` under ``axes`` (one entry a dim: the axis
    that splits it, or None). Each split dim must divide."""
    for dim, axis in enumerate(axes):
        if axis is not None:
            a, b = partition.axis_slice(mesh, axis, x.shape[dim])
            x = x.narrow(dim, a, b - a)
    return x


def padded_rows(n: int, pad_multiple: int) -> int:
    return -(-n // pad_multiple) * pad_multiple


def _local_n_valid(mesh, n_valid, n_local: int):
    """``n_valid`` real rows of the whole corpus as a count of this rank's
    row shard (its rows start at model index x n_local)."""
    if mesh is None or n_valid is None:
        return n_valid
    return max(0, n_valid - mesh.index("model") * n_local)


def _gather_queries(mesh, *xs):
    """The (nq/dp, ...) results of this rank's queries -> (nq, ...)."""
    if mesh is None:
        return xs
    return tuple(annotate.all_gather(x, mesh, "data", 0, "results")
                 for x in xs)


def make_scores_step(iters: int = 1, *, method: str = "act",
                     symmetric: bool = False, engine: str = "dist",
                     use_kernels: bool = False, block_q: int = 8,
                     block_v: int | None = None, block_h: int | None = None,
                     block_n: int | None = None, rev_block: int = 256,
                     mesh=None, precision: str = "f32"):
    """Returns scores_step(corpus_ids, corpus_w, coords, q_ids, q_w) -> the
    whole (nq, n) score matrix of ``method``, on every rank, from the
    rank's shards. ``engine="dist"`` runs the method's batched scorer on
    them; ``engine="scan"`` the single-query engines, one query at a
    time. Without ``mesh`` the operands are whole and so is the result."""
    out = {axis: dim for dim, axis in
           enumerate(retrieval.METHODS[method].dist_out) if axis}

    def scores_step(corpus_ids, corpus_w, coords, q_ids, q_w):
        corpus = lc.Corpus(ids=corpus_ids, w=corpus_w, coords=coords)
        s = retrieval.batch_scores(
            corpus, q_ids, q_w, method=method, symmetric=symmetric,
            engine=engine, iters=iters, use_kernels=use_kernels,
            block_q=block_q, precision=precision, block_v=block_v,
            block_h=block_h, block_n=block_n, rev_block=rev_block, mesh=mesh)
        if mesh is None:
            return s
        return annotate.gather_blocks(s, mesh, out, "scores")

    return scores_step


def make_search_step(iters: int = 1, top_l: int = 16,
                     n_valid: int | None = None, *, mesh=None, **score_kw):
    """Returns search_step(corpus_ids, corpus_w, coords, q_ids, q_w) ->
    (top-l scores, top-l global row ids), each (nq, top_l), on every rank.

    ``n_valid``: the real (non-padding) rows of the whole corpus; the pad
    rows after them are masked before the top-l. The top-l is
    shard-blocked (``cascade.topk_smallest``), so no rank gathers the
    score matrix. The other keywords go to :func:`make_scores_step`."""
    from repro_torch.cascade.search import topk_smallest

    blocks = 1 if mesh is None else model_axis_size(mesh)

    def search_step(corpus_ids, corpus_w, coords, q_ids, q_w):
        corpus = lc.Corpus(ids=corpus_ids, w=corpus_w, coords=coords)
        s = retrieval.batch_scores(corpus, q_ids, q_w, iters=iters,
                                   mesh=mesh, **score_kw)
        s = lc.mask_pad_rows(s, _local_n_valid(mesh, n_valid, corpus.n))
        vals, idx = topk_smallest(s, top_l, blocks, mesh=mesh)
        return _gather_queries(mesh, vals, idx)

    return search_step


def make_cascade_search_step(spec, top_l: int = 16,
                             n_valid: int | None = None, *,
                             topk_blocks: int = 1, mesh=None, **knobs):
    """Returns cascade_step(corpus_ids, corpus_w, coords, q_ids, q_w,
    *source_tables) -> (top-l rescorer scores, top-l global row ids), each
    (nq, top_l), on every rank.

    ``spec`` is a ``CascadeSpec`` or preset name whose rescorer runs on the
    device: the host's exact ``emd`` rescorer raises here. ``n_valid``
    keeps the pad rows out of candidacy. A sourced spec's built tables
    (``source.leaves()``) follow the queries, replicated. ``knobs``: the
    batch knobs of ``cascade_search`` (``engine``, ``use_kernels``, the
    tiles, ``precision``)."""
    from repro_torch import cascade as cx

    rspec = cx.resolve_spec(spec)
    if not cx.rescore.resolve(rspec.rescorer).jittable:
        raise ValueError(
            f"rescorer {rspec.rescorer!r} runs on the host and cannot run "
            "in the mesh step; use a device rescorer (act/ict/sinkhorn/...) "
            "or run the cascade through cascade.cascade_search on a single "
            "device")

    def cascade_step(corpus_ids, corpus_w, coords, q_ids, q_w, *src_leaves):
        source = rspec.source.wrap(src_leaves) if rspec.sourced else None
        corpus = lc.Corpus(ids=corpus_ids, w=corpus_w, coords=coords)
        res = cx.cascade_search(corpus, q_ids, q_w, rspec, top_l,
                                n_valid=n_valid, topk_blocks=topk_blocks,
                                mesh=mesh, source=source, **knobs)
        return _gather_queries(mesh, res.scores, res.indices)

    return cascade_step


# ---------------------------------------------------------------------------
# The step registry: every servable mesh step as data, which the static
# checks walk (``analysis/collectives_check.py``) instead of hard-coding
# method lists, so a method or preset registered in ``retrieval.METHODS`` /
# ``cascade.CASCADES`` is covered the moment it lands. JAX's
# ``launch/search.py`` registry, case for case.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepCase:
    """One enumerable step.

    kind:          ``scores`` | ``search`` | ``cascade``.
    method:        registry method (None for cascade cases: the spec
                   carries its stages' methods).
    engine:        ``dist`` (the serving pipeline) or ``scan`` (the
                   single-query engines, one query at a time).
    cascade:       CascadeSpec or preset name for ``kind="cascade"``.
    scale_guarded: True when the step's collective bytes must not grow
                   with the corpus (the (nq, n) score matrix never crosses
                   the mesh): the collectives pass runs it at two corpus
                   sizes. A scores step hands every rank the whole matrix
                   by design (its ``scores`` label), so the pass exempts
                   that one label there. False for the scan engine and
                   for fractional-budget cascades, whose candidate counts
                   grow with n by design.
    use_kernels:   True runs the case on the kernel path (the kernels'
                   wrappers on each rank's shards, ``kernels/partition``).
    precision:     the precision policy (``core/precision.py``): the bf16
                   cases put the half-width Phase-1 handoff under the
                   checks.
    """
    name: str
    kind: str
    method: str | None
    engine: str
    cascade: object = None
    scale_guarded: bool = False
    use_kernels: bool = False
    precision: str = "f32"


def step_cases(*, engines: tuple[str, ...] = ("dist", "scan"),
               include_search: bool = True,
               include_cascades: bool = True) -> tuple[StepCase, ...]:
    """Every (kind x method x engine) step the mesh serves, the device
    cascade presets, an absolute-budget admissible ladder
    (``cascade:pinned``), sourced ladders, the kernel path of every method
    that has one, and the bf16 policy's cases."""
    from repro_torch import candidates as cand_mod
    from repro_torch import cascade as cx

    cases = [
        StepCase(f"scores:{method}:{engine}", "scores", method, engine,
                 scale_guarded=engine == "dist")
        for method in sorted(retrieval.METHODS)
        for engine in engines
    ]
    if include_search:
        cases += [StepCase(f"search:act:{engine}", "search", "act", engine,
                           scale_guarded=engine == "dist")
                  for engine in engines]
    if include_cascades:
        for preset in sorted(cx.CASCADES):
            if cx.rescore.resolve(cx.CASCADES[preset].rescorer).jittable:
                cases.append(StepCase(f"cascade:{preset}:dist", "cascade",
                                      None, "dist", cascade=preset))
        stages = (cx.CascadeStage("rwmd", 24),
                  cx.CascadeStage("act", 8, iters=2))
        pinned = cx.CascadeSpec(stages=stages, rescorer="ict")
        lsh = cx.CascadeSpec(stages=stages, rescorer="ict",
                             source=cand_mod.CentroidLSHSpec(
                                 n_buckets=16, probes=4, bucket_cap=8,
                                 refine=16))
        tree = cx.CascadeSpec(stages=stages, rescorer="ict",
                              source=cand_mod.ClusterTreeSpec(
                                  branching=4, depth=2, beam=4, probes=2,
                                  leaf_cap=8))
        for name, spec, kernels in (
                ("cascade:pinned:dist", pinned, False),
                ("cascade:pinned:dist:kernels", pinned, True),
                ("cascade:sourced:lsh:dist", lsh, False),
                ("cascade:sourced:lsh:dist:kernels", lsh, True),
                ("cascade:sourced:tree:dist", tree, False)):
            cases.append(StepCase(name, "cascade", None, "dist",
                                  cascade=spec, scale_guarded=True,
                                  use_kernels=kernels))
    if "dist" in engines:
        cases += [
            StepCase(f"scores:{method}:dist:kernels", "scores", method,
                     "dist", scale_guarded=True, use_kernels=True)
            for method in sorted(m for m, s in retrieval.METHODS.items()
                                 if s.supports_kernels)
        ]
        cases += [
            StepCase("scores:act:dist:bf16", "scores", "act", "dist",
                     scale_guarded=True, precision="bf16"),
            StepCase("scores:act:dist:kernels:bf16", "scores", "act",
                     "dist", scale_guarded=True, use_kernels=True,
                     precision="bf16"),
        ]
    return tuple(cases)


def build_step(case: StepCase, workload, mesh=None, *, top_l: int = 4,
               **score_kw):
    """The mesh step of one registry case for ``workload`` (the operands'
    padded row count is ``padded_rows(workload.n_db, pad_multiple)``;
    ``workload.n_db`` rows are real). ``score_kw``: the usual batch
    knobs. Without ``mesh`` the step takes whole operands."""
    score_kw.setdefault("use_kernels", case.use_kernels)
    score_kw.setdefault("precision", case.precision)
    if case.kind == "scores":
        return make_scores_step(workload.iters, method=case.method,
                                engine=case.engine, mesh=mesh, **score_kw)
    if case.kind == "search":
        return make_search_step(workload.iters, top_l, workload.n_db,
                                method=case.method, engine=case.engine,
                                mesh=mesh, **score_kw)
    assert case.kind == "cascade", case.kind
    blocks = 1 if mesh is None else model_axis_size(mesh)
    return make_cascade_search_step(case.cascade, top_l, workload.n_db,
                                    topk_blocks=blocks, engine=case.engine,
                                    mesh=mesh, **score_kw)


def case_operands(case: StepCase, corpus: lc.Corpus, q_ids: torch.Tensor,
                  q_w: torch.Tensor, mesh=None,
                  pad_multiple: int = DEFAULT_ROW_PAD_MULTIPLE) -> tuple:
    """This rank's operands of one case's step: the corpus padded to
    ``pad_multiple`` rows and the queries, sharded by
    :data:`SEARCH_PLAN`, then a sourced cascade's tables (its source
    built over ``corpus``), replicated."""
    n_pad = padded_rows(corpus.n, pad_multiple)
    ids, w = (torch.cat([x, x.new_zeros((n_pad - corpus.n, x.shape[1]))])
              for x in (corpus.ids, corpus.w))
    ops = (ids, w, corpus.coords, q_ids, q_w)
    if mesh is not None:
        ops = tuple(shard(mesh, x, axes)
                    for x, axes in zip(ops, SEARCH_PLAN.values()))
    if case.kind == "cascade":
        from repro_torch import cascade as cx
        rspec = cx.resolve_spec(case.cascade)
        if rspec.sourced:
            ops += tuple(rspec.source.build(corpus).leaves())
    return ops
