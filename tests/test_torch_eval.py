"""The paper's evaluation path in the port against the JAX package, on the
same numpy inputs (every input from a numpy seed).

* ``make_image_like`` and ``images_to_corpus`` (sparse and dense mode):
  bitwise equal to JAX; ``pair_from_corpus`` and the geometry helpers.
* ``all_pairs_scores`` for all seven methods on text, sparse-image and
  dense-image corpora, on the reference path and on the kernel path (the
  kernels' plain versions here): exactly symmetric, identical at every
  query chunk size, and within tolerance of JAX's ``all_pairs_scores``.
* ``precision_at_l``, ``recall_at_l`` and the top-l selection under them:
  JAX's floats and indices exactly, also where every score ties (LC-RWMD
  on dense images scores exactly 0 off the diagonal); ``_mask_self`` on a
  bfloat16 matrix.
* Symmetric ``batch_scores`` and ``EngineConfig(symmetric=True)``.
* ``EmdIndex.all_pairs``, ``precision_at_l``, ``recall_at_l``,
  ``with_config`` and a symmetric index against the JAX ``EmdIndex``.
* The full-corpus ``rwmd_rev`` and ``ict`` engines on the all-rows form of
  K4's valid-bin entry against JAX's engines.

Tolerances. Scores: float32 rtol 1e-5 plus atol 1e-6 (the two frameworks
sum in other orders; a self-match scores ~1e-8 on one side and 0 on the
other); bfloat16 handoffs the reference's 8e-3 absolute band. The helpers:
1e-6. Generators, selections and precisions: exact. The corpora have at
least iters+1 valid bins in every row, where JAX's own two act paths agree
(ROADMAP Queue 3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import EmdIndex as JIndex
from repro.api import EngineConfig as JConfig
from repro.core import geometry as jgeo
from repro.core import histogram as jhist
from repro.core import lc as jlc
from repro.core import retrieval as jr
from repro.data import synth as jsynth
from repro_torch.api import EmdIndex, EngineConfig, corpus_from_numpy
from repro_torch.core import geometry, histogram, lc
from repro_torch.core import retrieval as tr
from repro_torch.data import synth
from repro_torch.kernels import cand_pour
from repro_torch.kernels import ops as tops

F32_TOL = dict(rtol=1e-5, atol=1e-6)
HELPER_TOL = dict(rtol=1e-6, atol=1e-6)
BF16_ATOL = 8e-3
ITERS = 3
METHODS = sorted(jr.METHODS)


@functools.cache
def _jax_corpus(kind):
    """(JAX corpus, labels) of one evaluation corpus."""
    if kind == "text":
        return jsynth.make_text_like(n_docs=24, n_classes=4, vocab=96, m=8,
                                     doc_len=12, hmax=16, seed=3)
    if kind == "sparse_image":
        return jsynth.make_image_like(24, n_classes=3, side=12, seed=1)
    return jsynth.make_image_like(20, n_classes=3, side=10,
                                  include_background=True, seed=2)


KINDS = ["text", "sparse_image", "dense_image"]


def _port(kind):
    c, labels = _jax_corpus(kind)
    assert int((np.asarray(c.w) > 0).sum(axis=1).min()) > ITERS
    return corpus_from_numpy(c.ids, c.w, c.coords, "cpu"), labels


@functools.cache
def _jax_all_pairs(kind, method):
    return np.asarray(jr.all_pairs_scores(_jax_corpus(kind)[0], method,
                                          ITERS))


# -------------------------------------------------------- data and helpers


@pytest.mark.parametrize("background", [False, True],
                         ids=["sparse", "dense"])
@pytest.mark.parametrize("side", [12, 28])
def test_make_image_like_matches_jax_bitwise(side, background):
    got, labels = synth.make_image_like(9, n_classes=3, side=side,
                                        include_background=background,
                                        seed=side)
    want, jlabels = jsynth.make_image_like(9, n_classes=3, side=side,
                                           include_background=background,
                                           seed=side)
    np.testing.assert_array_equal(labels, jlabels)
    for field in ("ids", "w", "coords"):
        t, j = getattr(got, field), np.asarray(getattr(want, field))
        assert t.device.type == "cpu" and t.numpy().dtype == j.dtype
        np.testing.assert_array_equal(t.numpy(), j)
    assert got.v == side * side and got.m == 2
    if background:
        assert got.hmax == side * side and bool((got.w > 0).all())


@pytest.mark.parametrize("background", [False, True],
                         ids=["sparse", "dense"])
def test_images_to_corpus_matches_jax_bitwise(rng, background):
    images = rng.uniform(size=(6, 5, 7)) * (rng.uniform(size=(6, 5, 7)) > 0.6)
    images[2] = 0.0                    # an image with no pixel on
    images[2, 1, 1] = 0.5
    got = histogram.images_to_corpus(images, background)
    want = jhist.images_to_corpus(images, background)
    for field in ("ids", "w", "coords"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))


@pytest.mark.parametrize("a,b", [(0, 1), (3, 3), (5, 2)])
def test_pair_from_corpus_matches_jax(a, b):
    jc, _ = _jax_corpus("text")
    got = histogram.pair_from_corpus(_port("text")[0], a, b)
    want = jhist.pair_from_corpus(jc, a, b)
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **HELPER_TOL)
    assert bool((got[2][got[0] == 0] == got[2].max()).all())


def test_geometry_helpers_match_jax(rng):
    a = rng.normal(size=(7, 5)).astype(np.float32)
    b = np.concatenate([rng.normal(size=(4, 5)), a[:2]]).astype(np.float32)
    w = rng.uniform(size=(6, 9)).astype(np.float32)
    w[3] = 0.0                                    # a zero row meets eps
    cases = [(geometry.pairwise_sqdist(torch.tensor(a), torch.tensor(b)),
              jgeo.pairwise_sqdist(a, b)),
             (geometry.l1_normalize(torch.tensor(w)), jgeo.l1_normalize(w)),
             (geometry.l1_normalize(torch.tensor(w), dim=0),
              jgeo.l1_normalize(w, axis=0)),
             (geometry.l2_normalize(torch.tensor(a)), jgeo.l2_normalize(a)),
             (geometry.l2_normalize(torch.tensor(w)), jgeo.l2_normalize(w))]
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **HELPER_TOL)


# --------------------------------------------------------------- all-pairs


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["reference", "kernels"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", KINDS)
def test_all_pairs_matches_jax_at_every_chunk(kind, method, use_kernels,
                                              monkeypatch):
    tc, _ = _port(kind)
    kw = dict(use_kernels=use_kernels and tr.METHODS[method].supports_kernels)
    got = {}
    for chunk in (1, 7, tc.n):
        monkeypatch.setattr(tr, "ALL_PAIRS_QUERIES", chunk)
        assert tr.all_pairs_chunk(tc, kw["use_kernels"]) == chunk
        got[chunk] = tr.all_pairs_scores(tc, method, ITERS, **kw)
    monkeypatch.undo()
    for chunk in (1, 7):
        assert torch.equal(got[chunk], got[tc.n]), chunk
    assert torch.equal(tr.all_pairs_scores(tc, method, ITERS, **kw),
                       got[tc.n])
    S = got[tc.n]
    assert S.shape == (tc.n, tc.n) and S.dtype == torch.float32
    assert torch.equal(S, S.T)
    np.testing.assert_allclose(S.numpy(), _jax_all_pairs(kind, method),
                               **F32_TOL)


def test_dense_rwmd_is_exactly_zero_off_the_diagonal():
    """Every dense image holds every pixel, so each entry's nearest query
    bin costs exactly 0 (no TF32, the zero snap): LC-RWMD collapses."""
    tc, _ = _port("dense_image")
    for use_kernels in (False, True):
        S = tr.all_pairs_scores(tc, "rwmd", use_kernels=use_kernels)
        assert bool((S == 0).all())
    assert bool((tr.all_pairs_scores(tc, "act", ITERS) > 0).any())


@pytest.mark.parametrize("n,tile", [(10, 4), (9, 3), (5, 8)])
def test_symmetric_scores_in_place_matches_jax(rng, monkeypatch, n, tile):
    monkeypatch.setattr(lc, "SYM_TILE", tile)
    a = rng.normal(size=(n, n)).astype(np.float32)
    t = torch.tensor(a)
    ptr = t.data_ptr()
    got = lc.symmetric_scores(t)
    assert got.data_ptr() == ptr                  # in place
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jlc.symmetric_scores(a)))


@pytest.mark.parametrize("method", ["rwmd", "act"])
def test_all_pairs_reference_cap_gives_the_same_matrix(monkeypatch, method):
    """The reference path's cut of the chunk (the stacked tensor's size)
    changes nothing in the matrix."""
    tc, _ = _port("text")
    want = tr.all_pairs_scores(tc, method, ITERS)
    monkeypatch.setattr(tr, "ALL_PAIRS_STACK_ELEMS", 7 * tc.v * tc.hmax)
    assert tr.all_pairs_chunk(tc, False) == 7
    assert torch.equal(tr.all_pairs_scores(tc, method, ITERS), want)


def test_all_pairs_chunk_bounds_the_stacked_tensor():
    tc, _ = _port("text")
    assert tr.all_pairs_chunk(tc, True) == tr.ALL_PAIRS_QUERIES
    assert tr.all_pairs_chunk(tc, False) == tr.ALL_PAIRS_QUERIES
    wide = lc.Corpus(ids=torch.empty((3, 500), dtype=torch.int32,
                                     device="meta"),
                     w=torch.empty((3, 500), device="meta"),
                     coords=torch.empty((69_682, 300), device="meta"))
    assert tr.all_pairs_chunk(wide, False) == 15    # 20 Newsgroups width
    assert tr.all_pairs_chunk(wide, True) == 256


# -------------------------------------------------- precision and recall


@pytest.mark.parametrize("top_l", [1, 4, 8])
@pytest.mark.parametrize("method", ["rwmd", "omr", "act", "bow"])
@pytest.mark.parametrize("kind", KINDS)
def test_precision_at_l_equals_jax(kind, method, top_l):
    tc, labels = _port(kind)
    S = _jax_all_pairs(kind, method)
    want = jr.precision_at_l(jnp.asarray(S), jnp.asarray(labels), top_l)
    assert tr.precision_at_l(torch.tensor(S), labels, top_l) == want
    own = tr.all_pairs_scores(tc, method, ITERS)
    assert tr.precision_at_l(own, labels, top_l) == want


@pytest.mark.parametrize("top_l", [1, 4, 8])
def test_dense_rwmd_precision_is_the_tie_rule(top_l):
    """All-zero scores: the top-l is each row's lowest other indices."""
    tc, labels = _port("dense_image")
    n = tc.n
    S = tr.all_pairs_scores(tc, "rwmd", use_kernels=True)
    idx = tr.top_l_rows(S, top_l, exclude_self=True)
    want_idx = np.array([[c for c in range(n) if c != r][:top_l]
                         for r in range(n)])
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    want = jr.precision_at_l(jnp.asarray(_jax_all_pairs("dense_image",
                                                        "rwmd")),
                             jnp.asarray(labels), top_l)
    assert tr.precision_at_l(S, labels, top_l) == want


@pytest.mark.parametrize("top_l", [1, 4, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_recall_at_l_equals_jax(kind, top_l):
    tc, _ = _port(kind)
    S, R = (_jax_all_pairs(kind, m) for m in ("rwmd", "act"))
    for exclude_self in (False, True):
        want = jr.recall_at_l(jnp.asarray(S), jnp.asarray(R), top_l,
                              exclude_self=exclude_self)
        got = tr.recall_at_l(torch.tensor(S), torch.tensor(R), top_l,
                             exclude_self=exclude_self)
        assert got == want
    own = [tr.all_pairs_scores(tc, m, ITERS) for m in ("rwmd", "act")]
    assert tr.recall_at_l(*own, top_l, exclude_self=True) == want
    with pytest.raises(ValueError, match="shape"):
        tr.recall_at_l(torch.tensor(S), torch.tensor(R)[:3], top_l)


@pytest.mark.parametrize("top_l", [1, 4, 8, 30])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_top_l_rows_is_lax_top_k_in_chunks(rng, monkeypatch, top_l,
                                           exclude_self):
    """Scores from {0, 1, 2} tie everywhere; chunks of 4 rows (a ragged
    last one) give each row's lax.top_k indices of the negated scores."""
    monkeypatch.setattr(tr, "SELECT_ELEMS", 4 * 30)
    S = rng.integers(0, 3, size=(30, 30)).astype(np.float32)
    got = tr.top_l_rows(torch.tensor(S), top_l, exclude_self=exclude_self)
    masked = jr._mask_self(jnp.asarray(S)) if exclude_self else S
    _, want = jax.lax.top_k(-jnp.asarray(masked), top_l)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    labels = rng.integers(0, 3, size=30)
    if exclude_self and top_l in (1, 4, 8):    # exact sums of fractions
        assert tr.precision_at_l(torch.tensor(S), labels, top_l) == \
            jr.precision_at_l(jnp.asarray(S), jnp.asarray(labels), top_l)


def test_top_l_rows_rejects_a_bad_top_l():
    with pytest.raises(ValueError, match="top_l"):
        tr.top_l_rows(torch.zeros((3, 3)), 4)
    with pytest.raises(ValueError, match="top_l"):
        tr.top_l_smallest(torch.zeros((3, 3)), 0)


@pytest.mark.parametrize("shape", [(30,), (5, 30), (2, 3, 30)])
@pytest.mark.parametrize("top_l", [1, 8, 30])
def test_top_l_smallest_is_lax_top_k(rng, shape, top_l):
    """The search's selection: values and indices of lax.top_k of the
    negated scores, over scores that tie everywhere, at any leading
    shape."""
    S = rng.integers(0, 3, size=shape).astype(np.float32)
    got_s, got_i = tr.top_l_smallest(torch.tensor(S), top_l)
    neg_s, want_i = jax.lax.top_k(-jnp.asarray(S), top_l)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), -np.asarray(neg_s))


def test_mask_self_upcasts_a_bf16_matrix():
    """The sentinel goes in in float32: bf16's max, which bf16 overflow
    saturates to, must not tie the diagonal."""
    big = float(torch.finfo(torch.bfloat16).max)
    S = torch.tensor([[0.5, big, 1.0], [big, 0.25, 2.0], [3.0, big, 0.0]],
                     dtype=torch.bfloat16)
    got = tr._mask_self(S)
    want = jr._mask_self(jnp.asarray(S.float().numpy(), jnp.bfloat16))
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    off = got.clone().fill_diagonal_(0).max()
    assert bool((got.diagonal() > off).all())
    assert tr.top_l_rows(S, 1, exclude_self=True).tolist() == [[2], [2], [0]]


# ------------------------------------------------------------- symmetric


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["reference", "kernels"])
@pytest.mark.parametrize("method", ["rwmd", "rwmd_rev"])
def test_symmetric_batch_scores_matches_jax(method, use_kernels):
    jc, _ = _jax_corpus("text")
    tc, _ = _port("text")
    qi, qw = np.asarray(jc.ids[:6]), np.asarray(jc.w[:6])
    want = np.asarray(jr.batch_scores(
        jc, jnp.asarray(qi), jnp.asarray(qw), method=method, symmetric=True,
        use_kernels=use_kernels and jr.METHODS[method].supports_kernels))
    got = tr.batch_scores(tc, torch.tensor(qi), torch.tensor(qw),
                          method=method, symmetric=True,
                          use_kernels=use_kernels)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    # The symmetric rows of the corpus are those of the all-pairs matrix.
    S = tr.all_pairs_scores(tc, "rwmd", use_kernels=use_kernels)
    torch.testing.assert_close(got, S[:6], **F32_TOL)


def test_symmetric_reference_path_shares_one_stacked_tensor(monkeypatch):
    tc, _ = _port("text")
    calls = []
    stacked = lc.phase1_stacked_dist
    monkeypatch.setattr(lc, "phase1_stacked_dist",
                        lambda *a, **k: calls.append(1) or stacked(*a, **k))
    got = tr.batch_scores(tc, tc.ids[:4], tc.w[:4], method="rwmd",
                          symmetric=True)
    assert len(calls) == 1
    want = torch.maximum(
        tr.batch_scores(tc, tc.ids[:4], tc.w[:4], method="rwmd"),
        tr.batch_scores(tc, tc.ids[:4], tc.w[:4], method="rwmd_rev"))
    assert torch.equal(got, want)


@pytest.mark.parametrize("method", ["bow", "wcd"])
def test_symmetric_methods_pass_through(method):
    jc, _ = _jax_corpus("text")
    tc, _ = _port("text")
    qi, qw = tc.ids[:5], tc.w[:5]
    got = tr.batch_scores(tc, qi, qw, method=method, symmetric=True)
    assert torch.equal(got, tr.batch_scores(tc, qi, qw, method=method))
    want = jr.batch_scores(jc, jnp.asarray(qi.numpy()),
                           jnp.asarray(qw.numpy()), method=method,
                           symmetric=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("method", ["act", "omr", "ict"])
def test_symmetric_without_a_reverse_raises_as_jax(method):
    jc, _ = _jax_corpus("text")
    tc, _ = _port("text")
    with pytest.raises(ValueError, match="reverse") as jerr:
        jr.batch_scores(jc, jc.ids[:2], jc.w[:2], method=method,
                        symmetric=True)
    with pytest.raises(jerr.type, match="reverse"):
        tr.batch_scores(tc, tc.ids[:2], tc.w[:2], method=method,
                        symmetric=True)


@pytest.mark.parametrize("method", METHODS)
def test_symmetric_config_accepted_where_jax_accepts_it(method):
    try:
        JConfig(method=method, symmetric=True)
    except ValueError:
        with pytest.raises(ValueError, match="reverse direction"):
            EngineConfig(method=method, symmetric=True)
    else:
        assert EngineConfig(method=method, symmetric=True).symmetric


# -------------------------------------------------------------- EmdIndex


def _indexes(kind, backend, **cfg):
    jc, labels = _jax_corpus(kind)
    tc, _ = _port(kind)
    jb = "pallas" if backend == "cuda" else "reference"
    return (EmdIndex.build(tc, EngineConfig(backend=backend, **cfg),
                           device="cpu"),
            JIndex.build(jc, JConfig(backend=jb, **cfg)), labels)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("method", ["rwmd", "act"])
@pytest.mark.parametrize("kind", KINDS)
def test_index_evaluation_matches_jax(kind, method, backend):
    index, jindex, labels = _indexes(kind, backend, method=method,
                                     iters=ITERS, top_l=4)
    S = index.all_pairs()
    jS = np.asarray(jindex.all_pairs())
    np.testing.assert_allclose(S.numpy(), jS, **F32_TOL)
    for top_l in (1, 4, 8):
        want = jindex.precision_at_l(labels, top_l, scores=jS)
        assert index.precision_at_l(labels, top_l, scores=jS) == want
        assert index.precision_at_l(labels, top_l) == want
    assert index.precision_at_l(labels) == \
        jindex.precision_at_l(labels, scores=jS)
    other = _jax_all_pairs(kind, "omr")
    want = jindex.recall_at_l(other, scores=jS)
    assert index.recall_at_l(other, scores=S) == want
    assert index.recall_at_l(torch.tensor(other), 4) == want


def test_index_with_config_matches_jax():
    index, jindex, labels = _indexes("sparse_image", "cuda", method="act",
                                     iters=1, top_l=4)
    moved = index.with_config(method="omr", top_l=8)
    assert moved.corpus is index.corpus
    assert (moved.config.method, moved.config.top_l, moved.config.iters) == \
        ("omr", 8, 1)
    assert index.config.method == "act"
    jmoved = jindex.with_config(method="omr", top_l=8)
    jS = np.asarray(jmoved.all_pairs())
    np.testing.assert_allclose(moved.all_pairs().numpy(), jS, **F32_TOL)
    assert moved.precision_at_l(labels) == jmoved.precision_at_l(labels,
                                                                 scores=jS)
    with pytest.raises(ValueError, match="reverse"):
        index.with_config(symmetric=True)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_symmetric_index_matches_jax(backend):
    index, jindex, _ = _indexes("text", backend, method="rwmd",
                                symmetric=True, top_l=4)
    jc, _ = _jax_corpus("text")
    qi, qw = np.asarray(jc.ids[:5]), np.asarray(jc.w[:5])
    np.testing.assert_allclose(index.scores(qi, qw).numpy(),
                               np.asarray(jindex.scores(qi, qw)), **F32_TOL)
    np.testing.assert_allclose(index.scores(qi[2], qw[2]).numpy(),
                               np.asarray(jindex.scores(qi[2], qw[2])),
                               **F32_TOL)
    s, i = index.search(qi, qw)
    _, ji = jindex.search(qi, qw)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    with pytest.raises(ValueError, match="symmetric"):
        index.search(qi, qw, cascade="fast")


# ---------------------------------------- the full-corpus rev / ict engines


_FULL = {"rev_min": ("lc_rwmd_scores_rev_batched", tops.cand_rev_min_valid),
         "ict": ("lc_ict_scores_batched", tops.cand_ict_valid)}


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["rev_min", "ict"])
def test_full_corpus_engines_on_all_rows_k4_match_jax(kind, mode, precision,
                                                      monkeypatch):
    jc, _ = _jax_corpus(kind)
    tc, _ = _port(kind)
    qi = np.asarray(jc.ids[:5])
    qw = np.asarray(jc.w[:5]).copy()
    qw[3] = 0.0                                   # an empty query
    name, entry = _FULL[mode]
    want = np.asarray(getattr(jlc, name)(jc, jnp.asarray(qi),
                                         jnp.asarray(qw),
                                         precision=precision))
    calls = []
    mod_entry = f"cand_{mode}_valid"
    monkeypatch.setattr(tops, mod_entry,
                        lambda *a, **k: calls.append(a[2]) or entry(*a, **k))

    def stacked(*a, **k):
        raise AssertionError("the stacked handoff was built")
    monkeypatch.setattr(lc, "phase1_stacked_dist", stacked)
    got = getattr(lc, name)(tc, torch.tensor(qi), torch.tensor(qw),
                            precision=precision, use_kernels=True)
    assert calls == [None]                        # one all-rows call
    tol = F32_TOL if precision == "f32" else dict(rtol=0, atol=BF16_ATOL)
    ok = np.asarray(qw).sum(axis=1) > 0
    np.testing.assert_allclose(got.numpy()[ok], want[ok], **tol)
    assert bool((got[3] == 0).all())


@pytest.mark.parametrize("mode", ["rev_min", "ict"])
def test_all_rows_form_is_the_candidate_form_at_every_row(mode):
    tc, _ = _port("sparse_image")
    valid = lc.phase1_valid_dist(tc.coords, tc.ids[:4], tc.w[:4])
    entry = _FULL[mode][1]
    every = torch.arange(tc.n).expand(4, tc.n).contiguous()
    before = dict(cand_pour.valid_launches)
    got = entry(tc.ids, tc.w, None, *valid)
    assert cand_pour.valid_launches == before     # CPU: no launch
    assert got.shape == (4, tc.n)
    assert torch.equal(got, entry(tc.ids, tc.w, every, *valid))
