"""The port's method registry and cascade (``repro_torch.cascade``) against
the JAX package's, on the same numpy corpora.

Covers: every ``batch_fn`` of the seven methods under f32 and bf16; the
static admissibility table and the presets' flags; budget resolution,
``stage_rows`` and the spec validation errors; ``cascade_search`` top-l
equal to JAX's for the ``chain``, ``tight``, ``fast`` and ``exact`` presets
and a ``sinkhorn`` spec, on the reference path and on the kernel path (the
kernels' plain versions here); the exactness property of an admissible
cascade at rank-covering budgets; and ``EngineConfig`` /
``EmdIndex.search(cascade=...)`` on ``device="cpu"``.

Tolerances: f32 rtol 1e-5 plus atol 1e-6; bf16 the reference's 8e-3
absolute band. Sinkhorn scores rtol 1e-5 plus atol 1e-6 as well: 100
log-domain iterations in another framework's logsumexp differ from JAX by
at most 5.3e-7 relative on these corpora (measured on the CPU), well
inside it. act and rwmd compare only where JAX's own two engines agree
(ROADMAP Queue 3); the corpora here have at least k valid bins per query,
so that is every score.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import cascade as jc
from repro.api import EngineConfig as JConfig
from repro.core import retrieval as jr
from repro.data.synth import make_clustered_text, make_text_like
from repro_torch import cascade as tc
from repro_torch.api import EmdIndex, EngineConfig, corpus_from_numpy
from repro_torch.cascade import rescore
from repro_torch.core import retrieval as tr

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_ATOL = 8e-3


@pytest.fixture(scope="module")
def corpus():
    # doc_len < hmax: padded slots on both the corpus and query side.
    return make_text_like(n_docs=40, n_classes=4, vocab=128, m=8,
                          doc_len=10, hmax=16, seed=3)[0]


def _port(c):
    return corpus_from_numpy(c.ids, c.w, c.coords, "cpu")


def _queries(c, nq=6):
    return np.asarray(c.ids[:nq]), np.asarray(c.w[:nq])


def _tspec(spec):
    """The port's CascadeSpec equal to a JAX one."""
    return tc.CascadeSpec(
        stages=tuple(tc.CascadeStage(s.method, s.budget, s.iters)
                     for s in spec.stages),
        rescorer=spec.rescorer, rescorer_iters=spec.rescorer_iters)


# --------------------------------------------------------- the registry


#: Methods whose full-corpus engine has a kernel in the port and none in
#: the JAX package: the all-rows form of K4's valid-bin entry.
PORT_ONLY_KERNELS = {"rwmd_rev", "ict"}


def test_registry_matches_jax():
    assert set(tr.METHODS) == set(jr.METHODS)
    for name, spec in tr.METHODS.items():
        j = jr.METHODS[name]
        assert (spec.paper_name, spec.symmetric, spec.uses_iters,
                spec.supports_kernels, spec.reverse) == \
            (j.paper_name, j.symmetric, j.uses_iters,
             j.supports_kernels or name in PORT_ONLY_KERNELS,
             j.reverse), name
        assert spec.batch_fn is not None and spec.cand_fn is not None
        assert (spec.symmetric_batch_fn is None) == \
            (j.symmetric_batch_fn is None), name


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["reference", "kernels"])
@pytest.mark.parametrize("method", sorted(jr.METHODS))
def test_batch_fn_matches_jax(corpus, method, use_kernels, precision):
    qi, qw = _queries(corpus)
    kw = dict(method=method, iters=3, precision=precision)
    jkw = dict(kw, use_kernels=use_kernels
               and jr.METHODS[method].supports_kernels)
    want = np.asarray(jr.batch_scores(corpus, jnp.asarray(qi),
                                      jnp.asarray(qw), **jkw))
    other = np.asarray(jr.batch_scores(
        corpus, jnp.asarray(qi), jnp.asarray(qw),
        **dict(jkw, use_kernels=not jkw["use_kernels"]
               and jr.METHODS[method].supports_kernels)))
    tol = F32_TOL if precision == "f32" else dict(rtol=0, atol=BF16_ATOL)
    assert np.isclose(want, other, **tol).all()
    got = tr.batch_scores(_port(corpus), torch.tensor(qi), torch.tensor(qw),
                          use_kernels=use_kernels, **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_cand_scores_rejects_unknown_method(corpus):
    qi, qw = _queries(corpus, 2)
    with pytest.raises(ValueError, match="unknown method"):
        tr.cand_scores(_port(corpus), torch.tensor(qi), torch.tensor(qw),
                       torch.zeros((2, 3), dtype=torch.long), method="nope")


def test_topl_overlap_and_recall():
    a = np.array([[0, 1, 2], [3, 4, 5]])
    assert tc.topk_recall(a, a[:, ::-1].copy()) == 1.0
    got = tc.topk_recall(a, np.array([[0, 1, 9], [3, 4, 9]]))
    assert got == pytest.approx(2 / 3)
    assert got == jc.topk_recall(a, np.array([[0, 1, 9], [3, 4, 9]]))
    with pytest.raises(ValueError, match="shape"):
        tc.topk_recall(a, a[:, :2])


# --------------------------------------------------------- the spec layer


def test_admissibility_table_matches_jax():
    methods = sorted(jr.METHODS) + ["sinkhorn", "emd"]
    for m in sorted(jr.METHODS):
        for it in (0, 1, 3):
            for r in methods:
                for rit in (0, 1, 3):
                    assert tc.is_lower_bound(m, it, r, rit) == \
                        jc.is_lower_bound(m, it, r, rit), (m, it, r, rit)
    assert tc.spec.BOUND_CHAIN == jc.spec.BOUND_CHAIN
    assert tc.spec.EMD_ONLY_BOUNDS == jc.spec.EMD_ONLY_BOUNDS


def test_presets_match_jax_and_their_declared_admissibility():
    assert set(tc.CASCADES) == set(jc.CASCADES) == \
        set(tc.spec.PRESET_ADMISSIBLE)
    for name, spec in tc.CASCADES.items():
        assert spec == _tspec(jc.CASCADES[name])
        assert tc.resolve_spec(name) is spec
        assert spec.admissible == tc.spec.PRESET_ADMISSIBLE[name] == \
            jc.CASCADES[name].admissible
        assert spec.describe() == jc.CASCADES[name].describe()


@pytest.mark.parametrize("stages,n,top_l", [
    ((("wcd", 0.5), ("rwmd", 0.1)), 100, 4),
    ((("wcd", 0.5), ("rwmd", 0.1)), 100, 30),
    ((("wcd", 0.5), ("rwmd", 0.1)), 10, 4),
    ((("wcd", 0.5), ("rwmd", 0.1)), 10, 11),
    ((("rwmd", 1000),), 64, 4),
    ((("wcd", 10), ("rwmd", 0.9)), 10, 2),
    ((("wcd", 10), ("rwmd", 0.9)), 1000, 4),
    ((("rwmd", 0.2), ("omr", 0.05)), 18828, 16),
    ((("wcd", 0.4), ("rwmd", 0.05)), 1000, 16),
])
def test_resolve_budgets_and_stage_rows_match_jax(stages, n, top_l):
    def run(pkg):
        spec = pkg.CascadeSpec(stages=tuple(pkg.CascadeStage(m, b)
                                            for m, b in stages))
        try:
            return spec.resolve_budgets(n, top_l), pkg.stage_rows(spec, n,
                                                                  top_l)
        except ValueError as e:
            return type(e), str(e).split(" ")[0]
    assert run(tc) == run(jc)


@pytest.mark.parametrize("case,match", [
    (lambda p: p.CascadeStage("nope", 8), "unknown cascade stage method"),
    (lambda p: p.CascadeStage("rwmd", 0), "budget"),
    (lambda p: p.CascadeStage("rwmd", 1.5), "budget"),
    (lambda p: p.CascadeStage("rwmd", True), "budget"),
    (lambda p: p.CascadeStage("rwmd", 8, iters=-1), "iters"),
    (lambda p: p.CascadeSpec(stages=(p.CascadeStage("wcd", 8),
                                     p.CascadeStage("rwmd", 16))),
     "non-increasing"),
    (lambda p: p.CascadeSpec(stages=()), "at least one"),
    (lambda p: p.CascadeSpec(stages=(p.CascadeStage("rwmd", 8),),
                             rescorer="nope"), "unknown rescorer"),
    (lambda p: p.CascadeSpec(stages=(p.CascadeStage("rwmd", 8),),
                             rescorer_iters=-1), "rescorer_iters"),
    (lambda p: p.resolve_spec("nope"), "unknown cascade preset"),
], ids=["method", "budget0", "budget_frac", "budget_bool", "iters",
        "increasing", "empty", "rescorer", "rescorer_iters", "preset"])
def test_spec_validation_errors_match_jax(case, match):
    for pkg in (tc, jc):
        with pytest.raises(ValueError, match=match):
            case(pkg)


def test_spec_is_hashable_and_servable():
    spec = tc.CascadeSpec(stages=(tc.CascadeStage("rwmd", 8),))
    assert hash(spec) == hash(tc.CascadeSpec(stages=(tc.CascadeStage(
        "rwmd", 8),)))
    tc.CASCADES["fast"].check_servable(1000, 16, require_jittable=True)
    with pytest.raises(ValueError, match="host"):
        tc.CASCADES["exact"].check_servable(1000, 16, require_jittable=True)
    with pytest.raises(ValueError, match="top_l"):
        tc.CASCADES["fast"].check_servable(10, 16)


def test_rescorer_registry_matches_jax():
    assert rescore.names() == jc.rescore.names()
    for name in rescore.names():
        assert rescore.resolve(name).jittable == \
            jc.rescore.resolve(name).jittable
    assert not rescore.resolve("emd").jittable
    with pytest.raises(ValueError, match="unknown rescorer"):
        rescore.resolve("nope")


@pytest.mark.parametrize("what", ["source"])
def test_unported_cascade_pieces_raise(corpus, what):
    # Sources are ported; their static-check shapes (state_structs, the
    # static checkers' hook) are not.
    spec = tc.CascadeSpec(stages=(tc.CascadeStage("rwmd", 8),),
                          source="centroid_lsh")
    with pytest.raises(ValueError,
                       match="SourceSpec.state_structs.*not yet ported"):
        spec.source.state_structs(8)


def _tied_scores(nq, n, seed):
    """Scores from a few distinct values, so that most entries tie."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=(nq, n)).astype(np.float32) / 4


@pytest.mark.parametrize("blocks", [2, 4, 3])
@pytest.mark.parametrize("k", [1, 5, 12, 24])
def test_topk_blocks_match_jax(blocks, k):
    """The shard-blocked top-k (each block's winners, then one merge) gives
    JAX's values and indices, ties included (both: the lowest index
    first), and so the plain sort's; a block count that does not divide
    n (3 of 24) takes the plain sort in both packages."""
    s = _tied_scores(5, 24, blocks * 100 + k)
    v, i = tc.topk_smallest(torch.tensor(s), k, blocks)
    jv, ji = jc.topk_smallest(jnp.asarray(s), k, blocks)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    pv, pi = tc.topk_smallest(torch.tensor(s), k)
    assert torch.equal(v, pv) and torch.equal(i, pi)


def test_cascade_with_topk_blocks_matches_jax(corpus):
    """A cascade's stage 1 through the shard-blocked top-budget gives JAX's
    top-l with the same blocks."""
    qi, qw = _queries(corpus, 4)
    got = tc.cascade_search(_port(corpus), torch.tensor(qi),
                            torch.tensor(qw), "chain", 4, topk_blocks=2)
    want = jc.cascade_search(corpus, jnp.asarray(qi), jnp.asarray(qw),
                             "chain", 4, topk_blocks=2)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               **F32_TOL)


# ------------------------------------------------------ cascade vs JAX


def _sinkhorn_spec(pkg):
    return pkg.CascadeSpec(stages=(pkg.CascadeStage("wcd", 20),
                                   pkg.CascadeStage("rwmd", 10)),
                           rescorer="sinkhorn")


def _clustered():
    """A larger corpus in the cascade's working regime: Zipf lengths with
    at least 4 bins (k of act-3)."""
    return make_clustered_text(300, n_topics=8, vocab=256, m=8, hmax=12,
                               seed=5)[0]


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["reference", "kernels"])
@pytest.mark.parametrize("which,preset", [
    (w, p) for w in ("text_like", "clustered")
    for p in ("chain", "tight", "fast", "exact", "sinkhorn")
    # the exact LP per pair would take minutes on the larger corpus
    if (w, p) != ("clustered", "exact")])
def test_cascade_search_matches_jax(corpus, which, preset, use_kernels):
    c = corpus if which == "text_like" else _clustered()
    nq, top_l = 6, 4
    qi, qw = _queries(c, nq)
    jspec = _sinkhorn_spec(jc) if preset == "sinkhorn" else preset
    tspec = _sinkhorn_spec(tc) if preset == "sinkhorn" else preset
    want = jc.cascade_search(c, jnp.asarray(qi), jnp.asarray(qw), jspec,
                             top_l)
    got = tc.cascade_search(_port(c), torch.tensor(qi), torch.tensor(qw),
                            tspec, top_l, use_kernels=use_kernels)
    assert got.indices.shape == got.scores.shape == (nq, top_l)
    assert got.scores.dtype == torch.float32
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               **F32_TOL)
    assert (got.indices[:, 0] == torch.arange(nq)).all()     # self first


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cascade_precision_matches_jax(precision):
    c = _clustered()
    qi, qw = _queries(c, 8)
    want = jc.cascade_search(c, jnp.asarray(qi), jnp.asarray(qw), "chain",
                             5, precision=precision)
    got = tc.cascade_search(_port(c), torch.tensor(qi), torch.tensor(qw),
                            "chain", 5, precision=precision,
                            use_kernels=True)
    tol = F32_TOL if precision == "f32" else dict(rtol=0, atol=BF16_ATOL)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               **tol)
    np.testing.assert_array_equal(got.indices[:, 0].numpy(),
                                  np.asarray(want.indices)[:, 0])


def test_cascade_masks_pad_rows(corpus):
    """n_valid: zero-weight pad rows (which score 0, the best) never enter
    candidacy."""
    ids = np.pad(np.asarray(corpus.ids), ((0, 8), (0, 0)))
    w = np.pad(np.asarray(corpus.w), ((0, 8), (0, 0)))
    padded = corpus_from_numpy(ids, w, corpus.coords, "cpu")
    qi, qw = _queries(corpus, 4)
    spec = tc.CascadeSpec(stages=(tc.CascadeStage("rwmd", 16),),
                          rescorer="act", rescorer_iters=1)
    n = corpus.ids.shape[0]
    res = tc.cascade_search(padded, torch.tensor(qi), torch.tensor(qw),
                            spec, 6, n_valid=n)
    assert int(res.indices.max()) < n


def test_full_budget_cascade_is_full_rescoring(corpus):
    """budget == n degenerates to full-corpus rescoring: identical
    indices and scores."""
    t = _port(corpus)
    qi, qw = t.ids[:4], t.w[:4]
    spec = tc.CascadeSpec(stages=(tc.CascadeStage("rwmd", t.n),),
                          rescorer="act", rescorer_iters=2)
    res = tc.cascade_search(t, qi, qw, spec, 5)
    v, i = tc.topk_smallest(tr.batch_scores(t, qi, qw, method="act",
                                            iters=2), 5)
    assert torch.equal(res.indices, i)
    torch.testing.assert_close(res.scores, v, rtol=1e-6, atol=1e-7)


# ---------------------------------------------- the exactness property


def _rank_budgets(stage_scores, ref_idx, top_l):
    """Smallest budget per stage that keeps every reference top-l row:
    1 + its worst stable-sort rank, maxed over queries, made
    non-increasing along the ladder."""
    budgets = []
    for s in stage_scores:
        order = np.argsort(s, axis=1, kind="stable")
        rank = np.empty_like(order)
        np.put_along_axis(rank, order, np.arange(s.shape[1])[None, :],
                          axis=1)
        need = int(np.take_along_axis(rank, ref_idx, axis=1).max()) + 1
        budgets.append(max(top_l, need))
    for i in range(len(budgets) - 2, -1, -1):
        budgets[i] = max(budgets[i], budgets[i + 1])
    return budgets


#: An admissible stage ladder for each rescorer (a measure bounds itself;
#: the chain and EMD relations cover the rest).
_ADMISSIBLE_STAGES = {
    "act": (("rwmd", 0), ("omr", 0)),
    "ict": (("rwmd", 0), ("act", 1)),
    "omr": (("rwmd", 0),),
    "rwmd": (("rwmd", 0),),
    "rwmd_rev": (("rwmd_rev", 0),),
    "bow": (("bow", 0),),
    "wcd": (("wcd", 0),),
    "sinkhorn": (("wcd", 0), ("rwmd", 0)),
    "emd": (("wcd", 0), ("rwmd", 0)),
}


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["reference", "kernels"])
@pytest.mark.parametrize("rescorer", sorted(_ADMISSIBLE_STAGES))
@pytest.mark.parametrize("seed", [3, 17])
def test_admissible_cascade_is_exact_at_rank_covering_budgets(
        seed, rescorer, use_kernels):
    """An admissible cascade whose budgets cover the stage ranks of every
    true top-l row returns the top-l set of full-corpus rescoring."""
    c, _ = make_text_like(n_docs=20, n_classes=3, vocab=64, m=6,
                          doc_len=8, hmax=8, seed=seed)
    t = _port(c)
    nq, top_l = 3, 3
    qi, qw = t.ids[:nq], t.w[:nq]
    iters = 2 if rescorer == "act" else 1
    all_rows = torch.arange(t.n).expand(nq, t.n)
    r = rescore.resolve(rescorer)
    full = (r.fn(t, qi, qw, all_rows, iters=iters,
                 use_kernels=use_kernels).numpy() if r.jittable
            else r.host_fn(t, qi, qw, all_rows))
    ref_idx = np.argsort(full, axis=1, kind="stable")[:, :top_l]
    stages = _ADMISSIBLE_STAGES[rescorer]
    stage_scores = [tr.batch_scores(t, qi, qw, method=m, iters=it,
                                    use_kernels=use_kernels).numpy()
                    for m, it in stages]
    budgets = _rank_budgets(stage_scores, ref_idx, top_l)
    spec = tc.CascadeSpec(
        stages=tuple(tc.CascadeStage(m, b, iters=it)
                     for (m, it), b in zip(stages, budgets, strict=True)),
        rescorer=rescorer, rescorer_iters=iters)
    assert spec.admissible == (rescorer != "sinkhorn"), spec.describe()
    res = tc.cascade_search(t, qi, qw, spec, top_l, use_kernels=use_kernels)
    np.testing.assert_array_equal(np.sort(res.indices.numpy(), axis=1),
                                  np.sort(ref_idx, axis=1))


# ------------------------------------------------------------ the API


def test_engine_config_cascade_validation():
    with pytest.raises(ValueError, match="unknown cascade preset"):
        EngineConfig(cascade="nope")
    with pytest.raises(ValueError, match="symmetric"):
        EngineConfig(method="rwmd", symmetric=True, cascade="fast")
    with pytest.raises(ValueError, match="symmetric"):
        JConfig(method="rwmd", symmetric=True, cascade="fast")
    cfg = EngineConfig(cascade="fast")
    assert cfg.cascade_spec is tc.CASCADES["fast"]
    assert hash(cfg) == hash(EngineConfig(cascade="fast"))
    assert EngineConfig().cascade_spec is None
    assert EngineConfig(backend="reference").cascade_knobs() == dict(
        use_kernels=False, block_q=8, precision="f32", block_v=None,
        block_h=None, block_n=None, rev_block=256)
    # cascade_knobs' use_kernels follows the backend alone; score_kwargs'
    # also the method's kernel support (bow has none; ict has the all-rows
    # K4 in the port).
    assert EngineConfig(method="bow").cascade_knobs()["use_kernels"]
    assert not EngineConfig(method="bow").score_kwargs()["use_kernels"]
    assert EngineConfig(method="ict").score_kwargs()["use_kernels"]


@pytest.mark.parametrize("method", sorted(jr.METHODS))
def test_every_method_builds_and_scores(corpus, method):
    qi, qw = _queries(corpus, 3)
    index = EmdIndex.build(_port(corpus), EngineConfig(method=method,
                                                       iters=2, top_l=4),
                           device="cpu")
    want = np.asarray(jr.batch_scores(corpus, jnp.asarray(qi),
                                      jnp.asarray(qw), method=method,
                                      iters=2))
    np.testing.assert_allclose(index.scores(qi, qw).numpy(), want,
                               **F32_TOL)
    s, i = index.search(qi, qw)
    assert s.shape == i.shape == (3, 4)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_emdindex_cascade_config_and_adhoc(corpus, backend):
    qi, qw = _queries(corpus, 5)
    spec = tc.CascadeSpec(stages=(tc.CascadeStage("rwmd", 24),
                                  tc.CascadeStage("omr", 12)),
                          rescorer="act", rescorer_iters=2)
    t = _port(corpus)
    cfg = EngineConfig(method="act", iters=2, top_l=4, cascade=spec,
                       backend=backend)
    via_config = EmdIndex.build(t, cfg, device="cpu")
    s, i = via_config.search(qi, qw)
    assert s.shape == i.shape == (5, 4)
    plain = EmdIndex.build(t, dataclasses.replace(cfg, cascade=None),
                           device="cpu")
    s2, i2 = plain.search(qi, qw, cascade=spec)       # ad-hoc spec
    assert torch.equal(i, i2) and torch.equal(s, s2)
    # a single query keeps the uniform shape contract
    s1, i1 = via_config.search(qi[0], qw[0])
    assert s1.shape == i1.shape == (4,)
    assert torch.equal(i1, i[0])
    # generous budgets: the cascade agrees with full search
    _, i_full = plain.search(qi, qw)
    assert tc.topk_recall(i, i_full) == 1.0
    # ... and with the JAX index's cascade
    from repro.api import EmdIndex as JIndex
    jcfg = JConfig(method="act", iters=2, top_l=4, cascade=jc.CascadeSpec(
        stages=(jc.CascadeStage("rwmd", 24), jc.CascadeStage("omr", 12)),
        rescorer="act", rescorer_iters=2),
        backend="pallas" if backend == "cuda" else "reference")
    js, ji = JIndex.build(corpus, jcfg).search(qi, qw)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **F32_TOL)
    with pytest.raises(ValueError):
        via_config.search(qi, qw, top_l=corpus.ids.shape[0] + 1)


# ------------------------------------------------------- on a CUDA card


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["chain", "tight", "fast"])
def test_cuda_cascade_matches_reference_on_the_card(corpus, preset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only there")
    c = _clustered()
    qi, qw = _queries(c, 8)
    t = _port(c)
    cfg = dict(top_l=5, cascade=preset)
    s_c, i_c = EmdIndex.build(t, EngineConfig(**cfg)).search(qi, qw)
    s_r, i_r = EmdIndex.build(t, EngineConfig(backend="reference",
                                              **cfg)).search(qi, qw)
    torch.testing.assert_close(s_c, s_r, **F32_TOL)
    assert torch.equal(i_c[:, 0], i_r[:, 0])
