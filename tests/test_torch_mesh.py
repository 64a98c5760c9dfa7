"""The port's distributed backend (``EmdIndex(backend="distributed")`` on a
``torch.distributed`` (data, model) mesh) against the JAX package's
single-host results and the port's single-process index.

The ranks run on gloo meshes on the CPU (``repro_torch.launch.local``), the
kernels' plain versions on each rank's shards; their bodies are in
``torch_mesh_ranks.py`` and import only the port. Each mesh shape is one
spawn whose results the tests below share; 1 x 1 runs in this process.

The corpus: 60 rows (padded to 64, 16 rows a rank at 4 model ranks, the
last rank's 4 pad rows masked), a vocabulary of 130 words, which splits
over 2 model ranks and not over 4 (there every model rank runs the whole
Phase 1), and 6 queries, padded to 8 on 4 data ranks.

Tolerances:

* against JAX (``batch_scores`` / ``cascade_search`` / ``EmdIndex`` on its
  reference path): float32 rtol 1e-5 plus atol 1e-6, bf16 the 8e-3
  absolute band; top-l indices equal wherever JAX's ranking is separated
  by more than twice that;
* against the port's single-process index on the same plain versions:
  bitwise for act, rwmd, omr, bow and wcd, the ``chain`` cascade and
  all-pairs (every value is a row's, or a (query, row) pair's, whatever
  the shard shapes); the methods on the distance handoffs (rwmd_rev, ict,
  the symmetric measure) within the float32 tolerance, since their
  handoff is one product whose shape follows the query slice.
* every rank returns the same whole result, bitwise.

The traffic guard: the scale-guarded cascade steps (the pinned ladder and
the LSH-sourced one, reference and kernel paths: cases of the step
registry, ``launch.search.step_cases``) move the same bytes in each
collective at n and 4n rows, measured by the collectives pass on its 2 x 4
mesh; a step that gathers the stage-1 score matrix moves more at 4n, and
the pass's guard catches it.
"""
import dataclasses
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro import cascade as jc
from repro import candidates as jcand
from repro.api import EmdIndex as JIndex
from repro.api import EngineConfig as JConfig
from repro.core import retrieval as jr
from repro.data.synth import make_text_like
from repro_torch.analysis import collectives_check
from repro_torch.api import EmdIndex, EngineConfig, corpus_from_numpy
from repro_torch.cascade import topk_recall
from repro_torch.launch import search as dsearch
from repro_torch.launch.local import run_local
from repro_torch.launch.mesh import make_test_mesh

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_ATOL = 8e-3
SHAPES = [(2, 2), (1, 4), (4, 1), (1, 1)]
IDS = [f"{d}x{m}" for d, m in SHAPES]
NQ, TOP_L, PAD = 6, 4, 16
#: Methods whose every score is a (query, row) pair's own arithmetic on the
#: plain path, whatever the shard shapes: bitwise the single process.
BITWISE = ("act", "rwmd", "omr", "bow", "wcd")
METHODS = sorted(jr.METHODS)
SPAWN_TIMEOUT = 240
#: The scale-guarded cascades and the corpus sizes of their guard here (n
#: and 4n; n at least the pinned ladder's 4 shards x budget 24).
GUARDED = ("cascade:pinned:dist", "cascade:pinned:dist:kernels",
           "cascade:sourced:lsh:dist", "cascade:sourced:lsh:dist:kernels")
GUARD_NS = (96, 384)


@functools.cache
def _corpus():
    return make_text_like(n_docs=60, n_classes=4, vocab=130, m=8,
                          doc_len=10, hmax=16, seed=3)[0]


def _arrays(c):
    return (np.asarray(c.ids), np.asarray(c.w), np.asarray(c.coords))


@functools.cache
def _queries():
    c = _corpus()
    rows = [0, 9, 17, 30, 44, 59]
    return np.asarray(c.ids)[rows], np.asarray(c.w)[rows]


@functools.cache
def _mesh_results(shape):
    """Every rank's ``index_suite`` results on a gloo mesh of ``shape``."""
    args = (_arrays(_corpus()), *_queries(), TOP_L, PAD)
    if shape == (1, 1):
        mesh = make_test_mesh(1, 1, backend="gloo", device="cpu")
        return [ranks.index_suite(mesh, *args)]
    return run_local(ranks.index_suite, *shape, args=args,
                     timeout=SPAWN_TIMEOUT)


def _got(shape, key):
    return _mesh_results(shape)[0][key]


@functools.cache
def _port_index(method, **kw):
    c = _corpus()
    return EmdIndex.build(corpus_from_numpy(*_arrays(c), "cpu"),
                          EngineConfig(method=method, iters=3, top_l=TOP_L,
                                       **kw), device="cpu")


def _jq():
    qi, qw = _queries()
    return jnp.asarray(qi), jnp.asarray(qw)


@functools.cache
def _jax_scores(method, **kw):
    return np.asarray(jr.batch_scores(_corpus(), *_jq(), method=method,
                                      iters=3, **kw))


def _separated(s_ref, next_ref, tol):
    """Ranks of a reference top-l separated from both neighbours by more
    than twice ``tol`` (next_ref: the score after the last)."""
    band = 2 * (tol["atol"] + tol["rtol"] * np.abs(s_ref))
    gap_prev = np.concatenate([np.full_like(s_ref[:, :1], np.inf),
                               np.diff(s_ref, axis=1)], axis=1)
    gap_next = np.concatenate([s_ref[:, 1:], next_ref[:, None]],
                              axis=1) - s_ref
    return (gap_prev > band) & (gap_next > band)


def _hold_topl(got_v, got_i, want_v, want_i, next_want):
    np.testing.assert_allclose(got_v, want_v, **F32_TOL)
    firm = _separated(want_v, next_want, F32_TOL)
    assert firm.any()
    np.testing.assert_array_equal(got_i[firm], want_i[firm])


# ------------------------------------------------------- every method


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_mesh_scores_match_jax(shape, method):
    got = _got(shape, f"scores:{method}")
    assert got.shape == (NQ, _corpus().n) and got.dtype == np.float32
    np.testing.assert_allclose(got, _jax_scores(method), **F32_TOL)
    want = _port_index(method).scores(*map(torch.tensor, _queries()))
    if method in BITWISE:
        np.testing.assert_array_equal(got, want.numpy())
    else:
        np.testing.assert_allclose(got, want.numpy(), **F32_TOL)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_mesh_search_matches_jax(shape, method):
    """Top-l through the shard-blocked selection (pad rows masked first)
    against JAX's full-corpus top-l."""
    v, i = _got(shape, f"search:{method}")
    s = np.sort(_jax_scores(method), axis=1, kind="stable")
    want_i = np.argsort(_jax_scores(method), axis=1, kind="stable")
    _hold_topl(v, i, s[:, :TOP_L], want_i[:, :TOP_L], s[:, TOP_L])
    assert (i < _corpus().n).all()
    pv, pi = _port_index(method).search(*map(torch.tensor, _queries()))
    if method in BITWISE:
        np.testing.assert_array_equal(v, pv.numpy())
        np.testing.assert_array_equal(i, pi.numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_mesh_symmetric_bf16_scan_and_single_query(shape):
    """The symmetric measure, bf16 handoffs (crossing as 16-bit words), the
    scan engine and a single query on the mesh."""
    qi, qw = map(torch.tensor, _queries())
    sym = _got(shape, "scores:rwmd:symmetric")
    np.testing.assert_allclose(sym, _jax_scores("rwmd", symmetric=True),
                               **F32_TOL)
    np.testing.assert_allclose(
        sym, _port_index("rwmd", symmetric=True).scores(qi, qw).numpy(),
        **F32_TOL)
    bf16 = _got(shape, "scores:act:bf16")
    np.testing.assert_allclose(bf16, _jax_scores("act", precision="bf16"),
                               rtol=0, atol=BF16_ATOL)
    np.testing.assert_array_equal(
        bf16, _port_index("act", precision="bf16").scores(qi, qw).numpy())
    scan = _got(shape, "scores:act:scan")
    np.testing.assert_allclose(scan, _jax_scores("act", engine="scan"),
                               **F32_TOL)
    # The scan engine runs the kernels off on the distributed backend, as
    # in the JAX package: the reference backend's scan engine.
    np.testing.assert_array_equal(
        scan, _port_index("act", backend="reference",
                          batch_engine="scan").scores(qi, qw).numpy())
    single = _got(shape, "single:act")
    np.testing.assert_array_equal(single, _got(shape, "scores:act")[0])


# --------------------------------------------------------- the cascades


@functools.cache
def _jax_cascade(name):
    spec = ranks.CASCADES[name]
    if isinstance(spec, str):
        spec = jc.resolve_spec(spec)
    else:
        source = None
        if spec.source is not None:
            s = spec.source
            source = jcand.CentroidLSHSpec(
                n_buckets=s.n_buckets, probes=s.probes,
                bucket_cap=s.bucket_cap, refine=s.refine)
        spec = jc.CascadeSpec(
            stages=tuple(jc.CascadeStage(st.method, st.budget, st.iters)
                         for st in spec.stages),
            rescorer=spec.rescorer, rescorer_iters=spec.rescorer_iters,
            source=source)
    source = spec.source.build(_corpus()) if spec.sourced else None
    res = jc.cascade_search(_corpus(), *_jq(), spec, TOP_L, source=source)
    return np.asarray(res.scores), np.asarray(res.indices)


@pytest.mark.parametrize("name", sorted(ranks.CASCADES))
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_mesh_cascades_match_jax(shape, name):
    """Each ladder's top-l against JAX's single-host cascade (the last rank
    held where it is separated from the one before), and against the
    port's single-process cascade (``chain`` bitwise)."""
    v, i = _got(shape, f"cascade:{name}")
    wv, wi = _jax_cascade(name)
    _hold_topl(v, i, wv, wi, np.full(wv.shape[0], np.inf, np.float32))
    pv, pi = _port_index("act").with_config(
        cascade=ranks.CASCADES[name]).search(*map(torch.tensor, _queries()))
    np.testing.assert_allclose(v, pv.numpy(), **F32_TOL)
    if name == "chain":
        np.testing.assert_array_equal(v, pv.numpy())
        np.testing.assert_array_equal(i, pi.numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_mesh_admissible_cascade_at_generous_budgets_is_exact(shape):
    """An admissible ladder whose budgets keep every true neighbour gives
    full-corpus act-3 search's top-l."""
    _, i = _got(shape, "cascade:generous")
    _, full = _got(shape, "search:act")
    assert topk_recall(i, full) == 1.0


# ---------------------------------------------------------- all pairs


@functools.cache
def _jax_all_pairs(method):
    cfg = JConfig(method=method, iters=3, backend="reference")
    return np.asarray(JIndex.build(_corpus(), cfg).all_pairs())


@pytest.mark.parametrize("method", ["act", "rwmd"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_mesh_all_pairs(shape, method):
    """Corpus-as-queries all-pairs on the mesh: exactly symmetric, bitwise
    the single-process matrix and within tolerance of JAX's."""
    got = _got(shape, f"all_pairs:{method}")
    n = _corpus().n
    assert got.shape == (n, n)
    np.testing.assert_array_equal(got, got.T)
    np.testing.assert_array_equal(got, _port_index(method).all_pairs()
                                  .numpy())
    np.testing.assert_allclose(got, _jax_all_pairs(method), **F32_TOL)


# ------------------------------------------- the dist engine, the ranks


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_dist_engine_blocks_tile_the_jax_matrix(shape):
    """``batch_scores(engine="dist", mesh=)`` on each rank's shards returns
    its (nq/dp, n/mp) block; the blocks of all ranks tile JAX's matrix
    (the pad queries and pad rows cut off)."""
    n, c = _corpus().n, _corpus()
    n_pad = -(-n // PAD) * PAD
    dp = shape[0]
    full = np.full((-(-NQ // dp) * dp, n_pad), np.nan, np.float32)
    for res in _mesh_results(shape):
        q0, r0, block = res["dist_block"]
        full[q0:q0 + block.shape[0], r0:r0 + block.shape[1]] = block
    assert not np.isnan(full).any()
    np.testing.assert_allclose(full[:NQ, :n], _jax_scores("act"), **F32_TOL)
    assert c.n < n_pad


@pytest.mark.parametrize("shape", SHAPES[:3], ids=IDS[:3])
def test_every_rank_gets_the_whole_result(shape):
    results = _mesh_results(shape)
    assert len(results) == shape[0] * shape[1]
    for res in results[1:]:
        for key, want in results[0].items():
            if key != "dist_block":
                np.testing.assert_array_equal(np.asarray(res[key]),
                                              np.asarray(want), err_msg=key)


# ----------------------------------------------------- dedup and errors


@functools.cache
def _dedup_corpus():
    return make_text_like(n_docs=24, n_classes=4, vocab=40, m=6, doc_len=30,
                          hmax=16)[0]


@functools.cache
def _misc_results():
    return run_local(ranks.misc_suite, 2, 2,
                     args=(_arrays(_corpus()), _arrays(_dedup_corpus())),
                     timeout=SPAWN_TIMEOUT)[0]


def test_mesh_all_pairs_dedup_matches_jax():
    """All-pairs on a small vocabulary crosses the Phase-1 dedup gate on
    every rank (JAX: ``test_distributed_all_pairs_dedup_matches_reference``
    on a 4 x 2 mesh)."""
    cfg = JConfig(method="rwmd", iters=0, backend="reference",
                  pad_multiple=8, block_q=5)
    want = np.asarray(JIndex.build(_dedup_corpus(), cfg).all_pairs())
    np.testing.assert_allclose(_misc_results()["dedup"], want, **F32_TOL)


@pytest.mark.parametrize("case,match", [
    ("rows", "59 rows .*do not split over the mesh's 2 model ranks"),
    ("exact", "rescorer 'emd' runs on the host"),
    ("not_a_mesh", "mesh must be a .*Mesh, got object"),
    ("blocks", "topk_blocks=1 on a mesh of 2 model ranks"),
])
def test_mesh_refusals(case, match):
    err = _misc_results()[case]
    assert err is not None and err[0] == "ValueError", err
    assert re.search(match, err[1]), err[1]


@pytest.mark.parametrize("cfg,match", [
    (dict(cascade="exact"), "rescorer 'emd' runs on the host"),
    (dict(cascade=dataclasses.replace(
        ranks.LSH, source=dataclasses.replace(ranks.LSH.source,
                                              bucket_cap=None,
                                              refine=None))),
     "explicit capacity"),
    (dict(backend="pallas"), "backend='pallas' is not yet ported"),
])
def test_distributed_config_errors(cfg, match):
    cfg = dict(dict(backend="distributed"), **cfg)
    with pytest.raises(ValueError, match=match):
        EngineConfig(**cfg)


def test_implicit_mesh_leaves_the_process_group_alone():
    """``backend="distributed"`` without a mesh runs on a one-rank mesh that
    holds no process group: the process's ``torch.distributed`` state is
    left as it was, a second build works, and both score as the
    single-process index."""
    import torch.distributed as dist
    was = dist.is_initialized()
    corpus = corpus_from_numpy(*_arrays(_corpus()), "cpu")
    q = tuple(map(torch.tensor, _queries()))
    cfg = EngineConfig(backend="distributed", method="act", iters=3,
                       top_l=TOP_L)
    first = EmdIndex.build(corpus, cfg, device="cpu")
    second = EmdIndex.build(corpus, cfg, device="cpu")
    assert dist.is_initialized() == was
    assert first.mesh.shape == {"data": 1, "model": 1}
    want = _port_index("act").scores(*q)
    assert torch.equal(first.scores(*q), want)
    assert torch.equal(second.scores(*q), want)


def test_mesh_needs_its_ranks():
    with pytest.raises(ValueError, match="needs an initialized process "
                                         "group of 4 ranks|needs 4 ranks"):
        make_test_mesh(2, 2, backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="'nccl' needs a CUDA device"):
        make_test_mesh(1, 1, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="unknown mesh backend"):
        make_test_mesh(1, 1, backend="mpi", device="cpu")


# ------------------------------------------------------ the traffic guard


@functools.cache
def _traffic():
    """The collectives pass's measurement of the guarded cascades, and of
    the seeded step, at n and 4n rows (its 2 x 4 mesh, its workload)."""
    cases = {c.name: c for c in dsearch.step_cases()}
    jobs = [(cases[name], n) for name in GUARDED for n in GUARD_NS]
    out = collectives_check.measure(jobs)
    seeded = collectives_check.measure(
        [(cases["cascade:pinned:dist"], n) for n in GUARD_NS],
        step_fn=ranks.seeded_step)
    out.update({("seeded", n): t for (_, n), t in seeded.items()})
    return out


@pytest.mark.parametrize("case", GUARDED)
def test_guarded_cascades_move_the_same_bytes_at_n_and_4n(case):
    res = _traffic()
    small, big = (res[(case, n)] for n in GUARD_NS)
    assert small and small == big, (small, big)
    assert "scores" not in small
    cases = {c.name: c for c in dsearch.step_cases()}
    assert cases[case].scale_guarded
    assert collectives_check.check_scaling(cases[case], small, big) == []


def test_traffic_guard_catches_a_seeded_score_matrix_gather():
    res = _traffic()
    small, big = (res[("seeded", n)] for n in GUARD_NS)
    assert big["scores"] > small["scores"]
    assert {k: v for k, v in big.items() if k != "scores"} == \
        res[("cascade:pinned:dist", GUARD_NS[1])]
    case = next(c for c in dsearch.step_cases()
                if c.name == "cascade:pinned:dist")
    violations = collectives_check.check_scaling(case, small, big)
    assert violations and "scale with the corpus" in violations[0].message
