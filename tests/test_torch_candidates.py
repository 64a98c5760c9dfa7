"""The port's candidate sources (``repro_torch.candidates``) and sourced
cascades against the JAX package's, on the same numpy corpora.

Counterparts of ``tests/test_candidates.py`` (the registry, spec
validation, measured-recall labelling, ``pack_table``, ``kmeans``, blocked
centroids, the candidate contract of each sublinear spec, the
``wrap``/``leaves`` round trip, the exact-centroid refine, the tree's
admissible bound, empty buckets, the three ``source=`` errors, recall with
traffic, the full-scan identity and its Hypothesis variant), then parity
with JAX: built tables bitwise; the query step on JAX's tables carried
across through ``wrap`` equal to JAX's wherever the ranked distances are
separated by a relative 1e-5 (the rest counted, and bounded); sourced
``cascade_search`` indices equal to JAX's where the scores are separated,
scores within rtol 1e-5 / atol 1e-6, on the reference path and on the
kernel path (the kernels' plain versions here).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import candidates as jcs
from repro import cascade as jcascade
from repro.data.synth import make_clustered_text, make_text_like
from repro_torch import candidates as cs
from repro_torch import cascade
from repro_torch.api import EmdIndex, EngineConfig, corpus_from_numpy
from repro_torch.candidates import (EMPTY_CENTER, SOURCES, CentroidLSHSpec,
                                    ClusterTreeSpec, FullScanSpec,
                                    corpus_centroids, kmeans, pack_table,
                                    resolve_source)
from repro_torch.cascade import CascadeSpec, CascadeStage

F32_TOL = dict(rtol=1e-5, atol=1e-6)
#: Relative gap below which two ranked distances count as a near tie: the
#: two packages' norms may differ in the last bit there.
TIE_RTOL = 1e-5


@pytest.fixture(scope="module")
def jcorpus():
    # Clustered geometry (what the sources index) with pad slots in play.
    return make_clustered_text(192, n_topics=4, vocab=128, m=8, hmax=16,
                               min_len=8, seed=7)[0]


@pytest.fixture(scope="module")
def corpus(jcorpus):
    return _port(jcorpus)


def _port(c):
    return corpus_from_numpy(c.ids, c.w, c.coords, "cpu")


def _q(c, k):
    return torch.tensor(np.asarray(c.ids[:k])), torch.tensor(
        np.asarray(c.w[:k]))


def _jspec(spec):
    """The JAX package's SourceSpec equal to a port one."""
    return jcs.SOURCES[spec.kind](**dataclasses.asdict(spec))


# ----------------------------------------------------------- spec layer

def test_registry_and_resolution():
    assert set(SOURCES) == set(jcs.SOURCES) >= {"full_scan", "centroid_lsh",
                                                "cluster_tree"}
    assert isinstance(resolve_source("full_scan"), FullScanSpec)
    spec = CentroidLSHSpec(n_buckets=8, probes=2, bucket_cap=4)
    assert resolve_source(spec) is spec
    with pytest.raises(ValueError, match="unknown candidate source"):
        resolve_source("nope")
    with pytest.raises(TypeError):
        resolve_source(42)
    for kind, cls in SOURCES.items():
        assert {f.name for f in dataclasses.fields(cls)} == \
            {f.name for f in dataclasses.fields(jcs.SOURCES[kind])}
        assert cls().describe() == jcs.SOURCES[kind]().describe()


def test_spec_validation():
    with pytest.raises(ValueError, match="probes"):
        CentroidLSHSpec(n_buckets=4, probes=5)
    with pytest.raises(ValueError, match="power-of-two"):
        CentroidLSHSpec(quantizer="hyperplane", n_buckets=6, probes=2)
    with pytest.raises(ValueError, match="unknown quantizer"):
        CentroidLSHSpec(quantizer="nope")
    with pytest.raises(ValueError, match="refine"):
        CentroidLSHSpec(n_buckets=8, probes=2, bucket_cap=4, refine=0)
    with pytest.raises(ValueError, match="exceeds the probed width"):
        CentroidLSHSpec(n_buckets=8, probes=2, bucket_cap=4, refine=9)
    with pytest.raises(ValueError, match="beam"):
        ClusterTreeSpec(branching=4, beam=5)
    with pytest.raises(ValueError, match="probes"):
        ClusterTreeSpec(branching=4, beam=2, probes=3)
    with pytest.raises(ValueError, match="exceeds the probed width"):
        ClusterTreeSpec(branching=4, depth=1, beam=2, probes=2,
                        leaf_cap=4, refine=16)
    spec = ClusterTreeSpec(branching=4, depth=2, beam=2, probes=2,
                           leaf_cap=8)
    assert hash(spec) == hash(dataclasses.replace(spec))
    assert spec.n_leaves == 16 and spec.n_nodes == 20
    assert spec.width == 16
    assert CentroidLSHSpec(n_buckets=8, probes=2, bucket_cap=4,
                           refine=6).width == 6
    assert CentroidLSHSpec(n_buckets=8, probes=2).width is None
    # state_structs serves the static checks and the mesh: not yet ported
    with pytest.raises(ValueError, match="state_structs.*not yet ported"):
        spec.state_structs(8)


def test_measured_recall_labeling():
    stages = (CascadeStage("rwmd", 16),)
    unsourced = CascadeSpec(stages=stages, rescorer="act")
    lsh = CascadeSpec(stages=stages, rescorer="act",
                      source=CentroidLSHSpec(n_buckets=8, probes=2,
                                             bucket_cap=8))
    fullscan = CascadeSpec(stages=stages, rescorer="act",
                           source="full_scan")
    assert unsourced.admissible and not unsourced.sourced
    assert not lsh.admissible and lsh.sourced
    assert fullscan.admissible and not fullscan.sourced
    assert lsh.describe() == jcascade.CascadeSpec(
        stages=(jcascade.CascadeStage("rwmd", 16),), rescorer="act",
        source=_jspec(lsh.source)).describe()
    named = CascadeSpec(stages=stages, source="centroid_lsh")
    assert isinstance(named.source, CentroidLSHSpec)


def test_sourced_first_stage_needs_a_candidate_engine(monkeypatch):
    """A sublinear source makes EVERY stage candidate-compacted, the
    first one too. Every port method has a candidate engine, so one is
    taken out of the registry for the check."""
    from repro_torch.core import retrieval
    monkeypatch.setitem(retrieval.METHODS, "wcd", dataclasses.replace(
        retrieval.METHODS["wcd"], cand_fn=None))
    CascadeSpec(stages=(CascadeStage("wcd", 16),))        # full scan: ok
    with pytest.raises(ValueError, match="sourced candidates"):
        CascadeSpec(stages=(CascadeStage("wcd", 16),),
                    source="centroid_lsh")


# -------------------------------------------------------- build helpers

def test_pack_table_lossless_and_capped():
    assign = np.array([0, 2, 0, 2, 2, 1])
    rows, mask, dropped = pack_table(assign, 3, None)
    assert dropped == 0 and rows.shape == (3, 3)
    assert rows[mask].size == 6
    np.testing.assert_array_equal(sorted(rows[2][mask[2]]), [1, 3, 4])
    rows_c, mask_c, dropped_c = pack_table(assign, 3, 2)
    assert dropped_c == 1 and rows_c.shape == (3, 2)
    np.testing.assert_array_equal(rows_c[2][mask_c[2]], [1, 3])
    assert mask[1].sum() == 1 and rows[1][mask[1]][0] == 5
    # dead slots hold row 0 (the candidate kernels then see it repeated)
    assert (rows[~mask] == 0).all()
    for got, want in zip((rows, mask, dropped),
                         jcs.pack_table(assign, 3, None), strict=True):
        np.testing.assert_array_equal(got, want)


def test_kmeans_invariants_and_jax_equal(rng):
    x = rng.normal(size=(200, 6)).astype(np.float32)
    c, a = kmeans(x, 8, 3, np.random.default_rng(1))
    assert c.shape == (8, 6) and a.shape == (200,)
    assert a.min() >= 0 and a.max() < 8
    d = np.linalg.norm(x[:, None, :] - c[None, :, :], axis=-1)
    np.testing.assert_array_equal(a, np.argmin(d, axis=1))
    jc, ja = jcs.kmeans(x, 8, 3, np.random.default_rng(1))
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(a, ja)


@pytest.mark.parametrize("block", [17, None, 131072],
                         ids=["17", "port-default", "jax-default"])
def test_corpus_centroids_blocked_bitwise(jcorpus, corpus, block):
    """Each row's centroid is its own product: bitwise the same at any
    block, and bitwise JAX's (whose block is 131,072)."""
    got = corpus_centroids(corpus, block=block)
    np.testing.assert_array_equal(got, jcs.corpus_centroids(jcorpus))
    ref = np.einsum("bh,bhm->bm", np.asarray(jcorpus.w, np.float32),
                    np.asarray(jcorpus.coords,
                               np.float32)[np.asarray(jcorpus.ids)])
    np.testing.assert_allclose(got, ref, **F32_TOL)


def test_centroid_block_keeps_the_gather_near_a_gigabyte():
    assert cs.base.centroid_block(500, 300) == 1789   # 20 Newsgroups width
    assert 4 * 1789 * 500 * 300 <= cs.base.CENTROID_GATHER_BYTES
    assert cs.base.centroid_block(10**6, 10**6) == 1


# ----------------------------------------- full-scan bitwise identity

def _fullscan_identity(c, q_ids, q_w, stages, top_l, use_kernels):
    plain = CascadeSpec(stages=stages, rescorer="act", rescorer_iters=2)
    sourced = dataclasses.replace(plain, source="full_scan")
    src = sourced.source.build(c)
    r0 = cascade.cascade_search(c, q_ids, q_w, plain, top_l,
                                use_kernels=use_kernels)
    r1 = cascade.cascade_search(c, q_ids, q_w, sourced, top_l, source=src,
                                use_kernels=use_kernels)
    assert torch.equal(r0.indices, r1.indices)
    assert torch.equal(r0.scores, r1.scores)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["reference", "kernels"])
def test_fullscan_source_bitwise_identity(corpus, use_kernels):
    q_ids, q_w = _q(corpus, 6)
    _fullscan_identity(corpus, q_ids, q_w,
                       (CascadeStage("wcd", 64), CascadeStage("rwmd", 16)),
                       4, use_kernels)
    src = FullScanSpec().build(corpus)
    assert src.leaves() == () and src.to("cpu") == src
    ids, mask = src.candidates(corpus, q_ids, q_w, budget=7)
    assert torch.equal(ids, torch.arange(7, dtype=torch.int32).expand(6, 7))
    assert bool(mask.all())


def test_fullscan_bitwise_hypothesis_property():
    """Derandomized sweep of the same identity over corpus shapes, budgets
    and seeds."""
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=10, deadline=None, derandomize=True,
              database=None)
    @given(n=st.integers(12, 40), seed=st.integers(0, 5),
           budget=st.integers(4, 12))
    def prop(n, seed, budget):
        c = _port(make_text_like(n_docs=n, n_classes=3, vocab=48, m=6,
                                 doc_len=8, hmax=8, seed=seed)[0])
        q_ids, q_w = c.ids[:3], c.w[:3]
        _fullscan_identity(c, q_ids, q_w, (CascadeStage("rwmd", budget),),
                           3, False)

    prop()


# ------------------------------------------------- candidate contracts

SUBLINEAR_SPECS = [
    CentroidLSHSpec(n_buckets=8, probes=3, bucket_cap=32),
    CentroidLSHSpec(n_buckets=8, probes=3, bucket_cap=32, refine=48),
    CentroidLSHSpec(quantizer="hyperplane", n_buckets=8, probes=3,
                    bucket_cap=48),
    ClusterTreeSpec(branching=4, depth=2, beam=3, probes=2, leaf_cap=24),
    ClusterTreeSpec(branching=4, depth=2, beam=3, probes=2, leaf_cap=24,
                    refine=32),
    ClusterTreeSpec(branching=3, depth=3, beam=2, probes=2, leaf_cap=None),
]
_IDS = [s.describe() for s in SUBLINEAR_SPECS]


@pytest.fixture(scope="module")
def built(jcorpus, corpus):
    """Each spec built by both packages from the same corpus."""
    return {s.describe(): (s.build(corpus), _jspec(s).build(jcorpus))
            for s in SUBLINEAR_SPECS}


@pytest.mark.parametrize("spec", SUBLINEAR_SPECS, ids=_IDS)
def test_candidate_contract(corpus, built, spec):
    src = built[spec.describe()][0]
    q_ids, q_w = _q(corpus, 5)
    ids, mask = src.candidates(corpus, q_ids, q_w)
    assert ids.shape == (5, src.width) and mask.shape == ids.shape
    assert ids.dtype == torch.int32 and mask.dtype == torch.bool
    assert int(ids.min()) >= 0 and int(ids.max()) < corpus.n
    assert bool(mask.any(dim=1).all())
    for q in range(5):
        live = ids[q][mask[q]]
        assert len(set(live.tolist())) == live.numel()
    bids, bmask = src.candidates(corpus, q_ids, q_w, budget=7)
    assert torch.equal(bids, ids[:, :7]) and torch.equal(bmask, mask[:, :7])


@pytest.mark.parametrize("spec", SUBLINEAR_SPECS, ids=_IDS)
def test_tables_bitwise_jax(built, spec):
    """The same corpus and seed build bitwise JAX's tables, in JAX's
    pytree leaf order, with the same overflow count."""
    src, jsrc = built[spec.describe()]
    jleaves = jax.tree_util.tree_leaves(jsrc)
    assert len(src.leaves()) == len(jleaves)
    for got, want in zip(src.leaves(), jleaves, strict=True):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    assert src.dropped_rows == jsrc.dropped_rows
    assert src.width == jsrc.width


@pytest.mark.parametrize("spec", SUBLINEAR_SPECS, ids=_IDS)
def test_wrap_leaves_roundtrip(built, spec):
    src = built[spec.describe()][0]
    rebuilt = spec.wrap(src.leaves())
    for a, b in zip(src.leaves(), rebuilt.leaves(), strict=True):
        assert torch.equal(a, b)
    from_numpy = spec.wrap([t.numpy() for t in src.leaves()])
    for a, b in zip(src.leaves(), from_numpy.leaves(), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError):
        spec.wrap(src.leaves()[:-1])


def _min_gap(d, k):
    """Smallest relative gap between consecutive entries among the k+1
    smallest of each row of float64 ``d``."""
    s = np.sort(d, axis=-1)[..., :k + 1]
    gaps = np.diff(s, axis=-1) / np.maximum(np.abs(s[..., 1:]), 1e-30)
    return gaps.min(axis=-1) if gaps.shape[-1] else np.full(s.shape[0],
                                                            np.inf)


def _separation(jsrc, jcorpus, q_ids, q_w):
    """Per query, the smallest relative gap at a selection the source
    makes (probes, each beam level, the refine), recomputed in float64 on
    JAX's tables."""
    spec = jsrc.spec
    coords = np.asarray(jcorpus.coords, np.float64)
    qc = np.einsum("qh,qhm->qm", np.asarray(q_w, np.float64),
                   coords[np.asarray(q_ids)])
    nq = qc.shape[0]

    def dist(cent):
        return np.minimum(np.linalg.norm(cent - qc[:, None, :], axis=-1),
                          5e29)

    mask_t = np.asarray(jsrc.mask)
    if spec.kind == "centroid_lsh":
        d = dist(np.asarray(jsrc.centroids, np.float64)[None])
        gap = _min_gap(d, spec.probes)
        probe = np.argsort(d, axis=1, kind="stable")[:, :spec.probes]
    else:
        from repro.candidates.cluster_tree import _level_offset
        nodes = np.asarray(jsrc.nodes, np.float64)
        radii = np.asarray(jsrc.radii, np.float64)
        B = spec.branching
        cand = np.broadcast_to(np.arange(B), (nq, B))
        gap = np.full(nq, np.inf)
        for lv in range(1, spec.depth + 1):
            lb = dist(nodes[cand]) - radii[cand]
            gap = np.minimum(gap, _min_gap(lb, spec.beam))
            pos = np.argsort(lb, axis=1, kind="stable")[:, :spec.beam]
            sel = np.take_along_axis(cand, pos, axis=1)
            if lv < spec.depth:
                rel = sel - _level_offset(B, lv)
                cand = (_level_offset(B, lv + 1) + rel[:, :, None] * B
                        + np.arange(B)).reshape(nq, -1)
        probe = sel[:, :spec.probes] - _level_offset(B, spec.depth)
    if spec.refine is not None:
        cents = np.asarray(jsrc.cents, np.float64)[probe].reshape(
            nq, -1, coords.shape[1])
        d = np.where(mask_t[probe].reshape(nq, -1),
                     np.linalg.norm(cents - qc[:, None, :], axis=-1), 1e30)
        gap = np.minimum(gap, _min_gap(d, spec.refine))
    return gap


@pytest.mark.parametrize("nq", [5, 32])
@pytest.mark.parametrize("spec", SUBLINEAR_SPECS, ids=_IDS)
def test_query_step_parity_on_jax_tables(jcorpus, corpus, built, spec, nq):
    """JAX's tables carried across through ``wrap``: the port's (ids,
    mask) equal JAX's for every query whose ranked distances are separated
    by more than TIE_RTOL; near-tied queries are counted, and may differ
    only there."""
    jsrc = built[spec.describe()][1]
    src = spec.wrap([np.asarray(x) for x in jax.tree_util.tree_leaves(jsrc)])
    q_ids, q_w = _q(jcorpus, nq)
    ids, mask = src.candidates(corpus, q_ids, q_w)
    jids, jmask = jsrc.candidates(jcorpus, jnp.asarray(q_ids.numpy()),
                                  jnp.asarray(q_w.numpy()))
    same = (ids.numpy() == np.asarray(jids)).all(1) & \
        (mask.numpy() == np.asarray(jmask)).all(1)
    separated = _separation(jsrc, jcorpus, q_ids.numpy(), q_w.numpy()) \
        > TIE_RTOL
    assert same[separated].all(), np.nonzero(~same & separated)[0]
    assert int((~same).sum()) <= int((~separated).sum())


def test_refine_is_exact_centroid_topk(corpus):
    base = CentroidLSHSpec(n_buckets=8, probes=3, bucket_cap=32)
    refined = dataclasses.replace(base, refine=24)
    q_ids, q_w = _q(corpus, 4)
    raw_ids, raw_mask = base.build(corpus).candidates(corpus, q_ids, q_w)
    ids, mask = refined.build(corpus).candidates(corpus, q_ids, q_w)
    cents = corpus_centroids(corpus)
    qc = np.einsum("qh,qhm->qm", q_w.numpy(),
                   corpus.coords.numpy()[q_ids.numpy()])
    for q in range(4):
        live = raw_ids[q][raw_mask[q]].numpy()
        d = np.linalg.norm(cents[live] - qc[q], axis=-1)
        want = set(live[np.argsort(d, kind="stable")[:24]].tolist())
        got = ids[q][mask[q]].numpy()
        dg = np.linalg.norm(cents[got] - qc[q], axis=-1)
        assert set(got.tolist()) == want
        assert (np.diff(dg) >= -1e-6).all()        # ascending order


def test_cluster_tree_ti_bound_is_admissible(corpus):
    spec = ClusterTreeSpec(branching=4, depth=2, beam=4, probes=4,
                           leaf_cap=None)
    src = spec.build(corpus)
    cents = corpus_centroids(corpus)
    q_ids, q_w = _q(corpus, 6)
    qc = np.einsum("qh,qhm->qm", q_w.numpy(),
                   corpus.coords.numpy()[q_ids.numpy()])
    nodes, radii = src.nodes.numpy(), src.radii.numpy()
    rows, mask = src.rows.numpy(), src.mask.numpy()
    off = cs.cluster_tree._level_offset(spec.branching, spec.depth)
    for leaf in range(spec.n_leaves):
        member = rows[leaf][mask[leaf]]
        if member.size == 0:
            continue
        d = np.linalg.norm(nodes[off + leaf] - qc, axis=-1)
        bound = np.maximum(d - radii[off + leaf], 0.0)
        true = np.linalg.norm(cents[member][None, :, :]
                              - qc[:, None, :], axis=-1).min(axis=1)
        assert (bound <= true + 1e-5).all()
    # the port's own descent bound agrees with the table arithmetic
    lb = src._bound(torch.tensor(qc), torch.arange(
        off, off + spec.n_leaves).expand(6, -1))
    np.testing.assert_allclose(
        lb.numpy(), np.linalg.norm(nodes[off:][None] - qc[:, None],
                                   axis=-1) - radii[off:], **F32_TOL)


def test_empty_bucket_sentinel():
    jc = make_text_like(n_docs=10, n_classes=2, vocab=32, m=4, doc_len=6,
                        hmax=8, seed=1)[0]
    c = _port(jc)
    spec = CentroidLSHSpec(n_buckets=16, probes=16, bucket_cap=4)
    src = spec.build(c)
    empty = ~src.mask.any(dim=1)
    assert bool(empty.any())
    assert bool((src.centroids[empty] == EMPTY_CENTER).all())
    q_ids, q_w = _q(c, 3)
    ids, mask = src.candidates(c, q_ids, q_w)
    assert int(mask.sum(dim=1).max()) <= 10
    # every bucket probed once: the clamp keeps empty ones distinct
    _, probe = cs.base.lc.streaming_smallest_k(
        cs.base.center_dist(src.centroids, cs.base.query_centroids(
            c, q_ids, q_w)), 16)
    assert all(len(set(p.tolist())) == 16 for p in probe)
    jids, jmask = _jspec(spec).build(jc).candidates(jc, jc.ids[:3],
                                                    jc.w[:3])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def test_sources_move_to_a_device(corpus, built):
    for src, _ in built.values():
        moved = src.to("cpu")
        assert type(moved) is type(src) and moved.spec == src.spec
        for a, b in zip(src.leaves(), moved.leaves(), strict=True):
            assert torch.equal(a, b)


# --------------------------------------------------- cascade integration

def test_sourced_cascade_requires_matching_source(corpus):
    spec = CascadeSpec(stages=(CascadeStage("rwmd", 16),), rescorer="act",
                       source=CentroidLSHSpec(n_buckets=8, probes=2,
                                              bucket_cap=16))
    q_ids, q_w = _q(corpus, 3)
    with pytest.raises(ValueError, match="spec.source.build"):
        cascade.cascade_search(corpus, q_ids, q_w, spec, 4)
    other = CentroidLSHSpec(n_buckets=4, probes=2,
                            bucket_cap=16).build(corpus)
    with pytest.raises(ValueError, match="does not match"):
        cascade.cascade_search(corpus, q_ids, q_w, spec, 4, source=other)
    unsourced = CascadeSpec(stages=(CascadeStage("rwmd", 16),),
                            rescorer="act")
    with pytest.raises(ValueError, match="does not declare"):
        cascade.cascade_search(corpus, q_ids, q_w, unsourced, 4,
                               source=other)
    narrow = CentroidLSHSpec(n_buckets=8, probes=1, bucket_cap=2)
    with pytest.raises(ValueError, match="fewer than top_l"):
        cascade.cascade_search(
            corpus, q_ids, q_w, dataclasses.replace(spec, source=narrow), 4,
            source=narrow.build(corpus))


def test_sourced_cascade_recall_and_traffic(corpus):
    q_ids, q_w = _q(corpus, 8)
    full = CascadeSpec(stages=(CascadeStage("wcd", 96),
                               CascadeStage("rwmd", 32)),
                       rescorer="act", rescorer_iters=2)
    ref = cascade.cascade_search(corpus, q_ids, q_w, full, 8)
    spec = CascadeSpec(
        stages=(CascadeStage("rwmd", 32),), rescorer="act",
        rescorer_iters=2,
        source=CentroidLSHSpec(n_buckets=8, probes=4, bucket_cap=48,
                               refine=96))
    src = spec.source.build(corpus)
    got = cascade.cascade_search(corpus, q_ids, q_w, spec, 8, source=src)
    assert cascade.topk_recall(got.indices, ref.indices) >= 0.8
    rows = cascade.stage_rows(spec, corpus.n, 8)
    assert rows["stage1.rwmd"] == 96
    assert rows["rescore.act"] == 32
    assert spec.source.width == 96 < corpus.n
    assert rows == jcascade.stage_rows(
        jcascade.CascadeSpec(stages=(jcascade.CascadeStage("rwmd", 32),),
                             rescorer="act", rescorer_iters=2,
                             source=_jspec(spec.source)), corpus.n, 8)


def _jcascade(spec):
    return jcascade.CascadeSpec(
        stages=tuple(jcascade.CascadeStage(s.method, s.budget, s.iters)
                     for s in spec.stages),
        rescorer=spec.rescorer, rescorer_iters=spec.rescorer_iters,
        source=None if spec.source is None else _jspec(spec.source))


SOURCED_LADDERS = [
    # under-full buckets: dead slots reach every stage and the rescorer
    CascadeSpec(stages=(CascadeStage("rwmd", 24),), rescorer="act",
                rescorer_iters=3,
                source=CentroidLSHSpec(n_buckets=16, probes=2,
                                       bucket_cap=24)),
    CascadeSpec(stages=(CascadeStage("rwmd", 40), CascadeStage("act", 12,
                                                               iters=3)),
                rescorer="ict",
                source=CentroidLSHSpec(n_buckets=8, probes=3, bucket_cap=32,
                                       refine=48)),
    CascadeSpec(stages=(CascadeStage("omr", 20),), rescorer="act",
                rescorer_iters=2,
                source=ClusterTreeSpec(branching=4, depth=2, beam=3,
                                       probes=2, leaf_cap=24, refine=32)),
    CascadeSpec(stages=(CascadeStage("wcd", 30), CascadeStage("rwmd_rev",
                                                              16)),
                rescorer="emd",
                source=ClusterTreeSpec(branching=4, depth=2, beam=3,
                                       probes=3, leaf_cap=20)),
]


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["reference", "kernels"])
@pytest.mark.parametrize("spec", SOURCED_LADDERS,
                         ids=[s.describe() for s in SOURCED_LADDERS])
def test_sourced_cascade_matches_jax(jcorpus, corpus, spec, use_kernels):
    """JAX's built source carried across: the same ladder on the same
    candidates gives JAX's top-l (indices equal where JAX's scores are
    separated by twice the tolerance, scores within it), masked slots
    never in the result."""
    top_l = 6
    jspec = _jcascade(spec)
    jsrc = jspec.source.build(jcorpus)
    src = spec.source.wrap([np.asarray(x)
                            for x in jax.tree_util.tree_leaves(jsrc)])
    q_ids, q_w = _q(jcorpus, 8)
    want = jcascade.cascade_search(jcorpus, jnp.asarray(q_ids.numpy()),
                                   jnp.asarray(q_w.numpy()), jspec,
                                   top_l + 1, source=jsrc)
    got = cascade.cascade_search(corpus, q_ids, q_w, spec, top_l + 1,
                                 source=src, use_kernels=use_kernels)
    ws, wi = np.asarray(want.scores), np.asarray(want.indices)
    gs, gi = got.scores.numpy(), got.indices.numpy()
    np.testing.assert_allclose(gs, ws, **F32_TOL)
    tol = 2 * (F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(ws))
    gap = np.diff(ws, axis=1)
    firm = np.ones(ws.shape, bool)
    firm[:, 1:] &= gap > tol[:, 1:]
    firm[:, :-1] &= gap > tol[:, :-1]
    firm = firm[:, :top_l]
    assert (gi[:, :top_l] == wi[:, :top_l])[firm].all()
    assert (gs < 1e29).all()                 # no dead slot in a top-l
    # the sourced rows: every result is a candidate the source emitted
    cand, cmask = src.candidates(corpus, q_ids, q_w)
    for q in range(8):
        assert set(gi[q]) <= set(cand[q][cmask[q]].tolist())


def test_dead_slots_pushed_to_the_sentinel(corpus):
    """Row 0 fills every dead slot; with masks left out it would be
    scored as a real candidate. Its (repeated) dead slots must rank last
    at every stage."""
    spec = CascadeSpec(stages=(CascadeStage("rwmd", 30),), rescorer="act",
                       rescorer_iters=1,
                       source=CentroidLSHSpec(n_buckets=32, probes=1,
                                              bucket_cap=40))
    src = spec.source.build(corpus)
    q_ids, q_w = corpus.ids[100:104], corpus.w[100:104]
    cand, cmask = src.candidates(corpus, q_ids, q_w)
    assert not bool(cmask.all(dim=1).any())          # every query has dead
    budgets = cascade.search._resolved_budgets(spec, src, corpus.n, 4)
    surv, smask = cascade.search._prune(
        corpus, q_ids, q_w, spec, budgets, n_valid=None, topk_blocks=1,
        engine="batched", source=src, use_kernels=False, block_q=8,
        precision="f32")
    live = cmask.sum(dim=1)
    for q in range(4):
        # the live candidates come first; the dead ones after them
        assert bool(smask[q, :min(int(live[q]), 30)].all())
        assert not bool(smask[q, int(live[q]):].any())


def test_emdindex_builds_and_reuses_the_source(jcorpus, corpus):
    spec = SOURCED_LADDERS[1]
    cfg = EngineConfig(cascade=spec, top_l=5)
    assert cfg.source_spec == spec.source
    index = EmdIndex.build(corpus, cfg, device="cpu")
    assert index.source is not None and index.source.spec == spec.source
    q_ids, q_w = _q(jcorpus, 4)
    s, i = index.search(q_ids, q_w)
    want = cascade.cascade_search(corpus, q_ids, q_w, spec, 5,
                                  source=index.source, use_kernels=True)
    assert torch.equal(s, want.scores) and torch.equal(i, want.indices)
    s1, i1 = index.search(q_ids[0], q_w[0])
    assert torch.equal(s1, s[0]) and torch.equal(i1, i[0])
    # an unrelated knob keeps the built source; another spec rebuilds
    def same_tables(a, b):
        return all(x is y for x, y in zip(a.leaves(), b.leaves(),
                                          strict=True))

    ref = index.with_config(backend="reference")
    assert same_tables(ref.source, index.source)
    other = index.with_config(cascade="chain")
    assert other.source is None
    injected = EmdIndex.build(corpus, cfg, device="cpu",
                              source=index.source)
    assert same_tables(injected.source, index.source)
    with pytest.raises(ValueError, match="does not match"):
        EmdIndex.build(corpus, cfg, device="cpu",
                       source=CentroidLSHSpec().build(corpus))
    with pytest.raises(ValueError, match="mesh must be a .*Mesh, got object"):
        EmdIndex.build(corpus, cfg, device="cpu", mesh=object())
    # an unsourced cascade on the same index searches without the source
    s2, _ = index.search(q_ids, q_w, cascade="chain")
    assert s2.shape == (4, 5)
