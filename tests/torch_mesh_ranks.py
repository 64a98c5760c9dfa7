"""Rank bodies of the port's mesh tests (``test_torch_mesh.py``,
``test_torch_partition.py``, ``test_torch_analysis.py``,
``test_torch_optim.py``).

``repro_torch.launch.local.run_local`` runs each function on every rank of
a local gloo mesh on the CPU. They import only the port (never JAX), take
numpy arrays and return numpy arrays; the test process holds them to the
JAX package and to the port's single-process index.
"""
import torch

from repro_torch.api import EmdIndex, EngineConfig, corpus_from_numpy
from repro_torch.candidates import CentroidLSHSpec
from repro_torch.cascade import CascadeSpec, CascadeStage, topk_smallest
from repro_torch.core import lc, retrieval
from repro_torch.kernels import ops, partition
from repro_torch.launch import search as dsearch
from repro_torch.sharding import annotate

#: The ladders of the mesh suite: the jittable presets, an admissible
#: ladder at absolute budgets, one at budgets that keep every true
#: neighbour of these corpora, and an LSH-sourced ladder.
PINNED = CascadeSpec(stages=(CascadeStage("rwmd", 24),
                             CascadeStage("act", 8, iters=2)),
                     rescorer="ict")
GENEROUS = CascadeSpec(stages=(CascadeStage("rwmd", 0.9),
                               CascadeStage("omr", 0.6)),
                       rescorer="act", rescorer_iters=3)
LSH = CascadeSpec(stages=(CascadeStage("rwmd", 16),), rescorer="act",
                  rescorer_iters=3,
                  source=CentroidLSHSpec(n_buckets=8, probes=3,
                                         bucket_cap=16, refine=24))
CASCADES = {"chain": "chain", "tight": "tight", "fast": "fast",
            "pinned": PINNED, "generous": GENEROUS, "lsh": LSH}


def _np(x):
    return x.cpu().numpy()


def shard_operands(mesh, corpus_ids, corpus_w, coords, q_ids, q_w):
    """The rank's shards of a step's five operands, by
    ``launch.search.SEARCH_PLAN``."""
    return tuple(dsearch.shard(mesh, x, axes) for x, axes in zip(
        (corpus_ids, corpus_w, coords, q_ids, q_w),
        dsearch.SEARCH_PLAN.values(), strict=True))


def index_suite(mesh, arrays, q_ids, q_w, top_l, pad_multiple):
    """Every method's ``scores`` and ``search``, the symmetric measure,
    bf16 and the scan engine, the cascades, ``all_pairs`` and the
    ``dist`` engine called directly, on ``backend="distributed"``."""
    corpus = corpus_from_numpy(*arrays, "cpu")
    qi, qw = torch.tensor(q_ids), torch.tensor(q_w)
    out = {}

    def build(**kw):
        cfg = EngineConfig(backend="distributed", top_l=top_l,
                           pad_multiple=pad_multiple, **kw)
        return EmdIndex.build(corpus, cfg, mesh=mesh)

    for method in sorted(retrieval.METHODS):
        index = build(method=method, iters=3)
        out[f"scores:{method}"] = _np(index.scores(qi, qw))
        s, i = index.search(qi, qw)
        out[f"search:{method}"] = (_np(s), _np(i))
    out["scores:rwmd:symmetric"] = _np(build(method="rwmd",
                                             symmetric=True).scores(qi, qw))
    out["scores:act:bf16"] = _np(build(method="act", iters=3,
                                       precision="bf16").scores(qi, qw))
    out["scores:act:scan"] = _np(build(method="act", iters=3,
                                       batch_engine="scan").scores(qi, qw))
    out["single:act"] = _np(build(method="act", iters=3).scores(qi[0],
                                                                 qw[0]))
    index = build(method="act", iters=3)
    for name, spec in CASCADES.items():
        s, i = index.with_config(cascade=spec).search(qi, qw)
        out[f"cascade:{name}"] = (_np(s), _np(i))
    out["all_pairs:act"] = _np(build(method="act", iters=3).all_pairs())
    out["all_pairs:rwmd"] = _np(build(method="rwmd").all_pairs())
    # The dist engine itself on this rank's shards: its block of the
    # (nq, n) matrix, placed by the caller from the offsets.
    n_pad = dsearch.padded_rows(corpus.n, pad_multiple)
    ids_p, w_p = (torch.cat([x, x.new_zeros((n_pad - corpus.n, x.shape[1]))])
                  for x in (corpus.ids, corpus.w))
    nq_pad = -(-qi.shape[0] // mesh.size("data")) * mesh.size("data")
    qi_p, qw_p = (torch.cat([x, x.new_zeros((nq_pad - x.shape[0],
                                             x.shape[1]))])
                  for x in (qi, qw))
    ids_l, w_l, coords, qi_l, qw_l = shard_operands(
        mesh, ids_p, w_p, corpus.coords, qi_p, qw_p)
    block = retrieval.batch_scores(
        lc.Corpus(ids=ids_l, w=w_l, coords=coords), qi_l, qw_l,
        method="act", iters=3, engine="dist", use_kernels=True, mesh=mesh)
    q0, _ = partition.axis_slice(mesh, "data", nq_pad)
    r0, _ = partition.axis_slice(mesh, "model", n_pad)
    out["dist_block"] = (q0, r0, _np(block))
    return out


def errors_suite(mesh, arrays):
    """The mesh's refusals, as (type name, message) pairs."""
    corpus = corpus_from_numpy(*arrays, "cpu")
    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = (type(e).__name__, str(e))

    cfg = EngineConfig(backend="distributed", pad_multiple=1)
    odd = lc.Corpus(ids=corpus.ids[:-1], w=corpus.w[:-1],
                    coords=corpus.coords)
    attempt("rows", lambda: EmdIndex.build(odd, cfg, mesh=mesh))
    index = EmdIndex.build(corpus, EngineConfig(backend="distributed",
                                                pad_multiple=16), mesh=mesh)
    attempt("exact", lambda: index.search(corpus.ids[:2], corpus.w[:2],
                                          cascade="exact"))
    attempt("not_a_mesh", lambda: EmdIndex.build(
        corpus, EngineConfig(backend="distributed"), mesh=object()))
    attempt("blocks", lambda: topk_smallest(torch.zeros(2, 8), 2, 1,
                                            mesh=mesh))
    return out


def shims_suite(mesh, arrays, q_ids, q_w, cand, k, scores, ks):
    """The partition shims on this rank's shards, each beside the
    unsharded kernel (its plain version here) on the same inputs, and the
    shard-blocked ``topk_smallest`` of ``scores`` for each k of ``ks``."""
    corpus = corpus_from_numpy(*arrays, "cpu")
    qi, qw = torch.tensor(q_ids), torch.tensor(q_w)
    q0, q1 = partition.axis_slice(mesh, "data", qi.shape[0])
    r0, r1 = partition.axis_slice(mesh, "model", corpus.n)
    qi_l, qw_l = qi[q0:q1], qw[q0:q1]
    local = lc.Corpus(ids=corpus.ids[r0:r1], w=corpus.w[r0:r1],
                      coords=corpus.coords)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        annotate.reset_traffic()
        Z, W = partition.dist_topk_sharded(mesh, corpus.coords, qi_l, qw_l,
                                           k, out_dtype=dtype)
        out[f"ladder_bytes:{dtype}"] = annotate.traffic().get(
            "emd_ladder", 0)
        Zf, S = ops.dist_topk_batched(corpus.coords, corpus.coords[qi_l],
                                      qw_l > 0, k, out_dtype=dtype,
                                      qids=qi_l)
        Wf = lc.gather_capacities(qw_l, S).to(dtype)
        out[f"k1:{dtype}"] = (torch.equal(Z, Zf) and torch.equal(W, Wf))
    Z, W = partition.dist_topk_sharded(mesh, corpus.coords, qi_l, qw_l, k)
    t = lc.pour_blocked(local, Z, W, k - 1, 8, use_kernels=True)
    full = ops.act_phase2_gather(corpus.w, corpus.ids, Z, W)
    out["k2"] = torch.equal(t, full[:, r0:r1])
    c = torch.tensor(cand)[q0:q1]
    # The candidate exchange: one float32 score a slot crosses, from each
    # of the other model ranks (besides Phase 1's ladder gather).
    annotate.reset_traffic()
    retrieval.cand_scores(local, qi_l, qw_l, c, method="rwmd",
                          use_kernels=True, mesh=mesh)
    moved = annotate.traffic()
    moved.pop("emd_ladder", None)
    out["exchange"] = moved == {
        "cand_scores": (mesh.size("model") - 1) * c.numel() * 4}
    for method in ("act", "rwmd", "omr", "rwmd_rev", "ict"):
        got = retrieval.cand_scores(local, qi_l, qw_l, c, method=method,
                                    iters=2, use_kernels=True, mesh=mesh)
        want = retrieval.cand_scores(corpus, qi_l, qw_l, c, method=method,
                                     iters=2, use_kernels=True)
        out[f"cand:{method}"] = (_np(got), _np(want))
    # topk_smallest on this rank's column block, the blocks the model
    # shards: the result of this rank's queries.
    s = torch.tensor(scores)
    s0, s1 = partition.axis_slice(mesh, "data", s.shape[0])
    c0, c1 = partition.axis_slice(mesh, "model", s.shape[1])
    for k_ in ks:
        v, i = topk_smallest(s[s0:s1, c0:c1], k_, mesh.size("model"),
                             mesh=mesh)
        out[f"topk:{k_}"] = (s0, _np(v), _np(i))
    return out


def misc_suite(mesh, arrays, dedup_arrays):
    """The mesh's refusals (:func:`errors_suite`) and the corpus-as-queries
    dedup case: all-pairs LC-RWMD whose query chunks cross the Phase-1
    dedup gate on every rank."""
    out = errors_suite(mesh, arrays)
    corpus = corpus_from_numpy(*dedup_arrays, "cpu")
    assert corpus.n * corpus.hmax >= lc.DEDUP_STACK_RATIO * corpus.v
    cfg = EngineConfig(method="rwmd", iters=0, backend="distributed",
                       pad_multiple=8, block_q=5)
    out["dedup"] = _np(EmdIndex.build(corpus, cfg, mesh=mesh).all_pairs())
    return out


def seeded_step(case, workload, mesh):
    """The registry's step of ``case`` after a step that gathers the (nq,
    n) rwmd score matrix over the mesh: the violation the collectives
    pass's scaling guard exists for (``collectives_check.measure``'s
    ``step_fn``)."""
    step = dsearch.build_step(case, workload, mesh)
    matrix = dsearch.make_scores_step(workload.iters, method="rwmd",
                                      mesh=mesh)

    def seeded(*ops):
        matrix(*ops[:5])             # the score matrix crosses the mesh
        return step(*ops)
    return seeded


def compressed_psum(mesh, axis, leaves, seed):
    """``optim.grad_utils.compressed_psum_tree`` of this rank's gradient
    tree ({name: numpy array}, the rank's own in ``leaves[rank]``) over
    ``axis``, with a generator seeded by ``seed`` + rank; returns the
    reduced tree and this rank's bytes by label."""
    import torch.distributed as dist

    from repro_torch.optim.grad_utils import compressed_psum_tree
    annotate.reset_traffic()
    mine = {k: torch.as_tensor(v) for k, v in
            leaves[dist.get_rank()].items()}
    gen = torch.Generator().manual_seed(seed + dist.get_rank())
    out = compressed_psum_tree(mine, gen, mesh, axis)
    return {k: _np(v.float()) for k, v in out.items()}, annotate.traffic()
