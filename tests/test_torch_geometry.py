"""Exact zeros at identical coordinates, at every distance site of the port,
and ``pairwise_dist``'s bfloat16 compute rule, against the JAX package.

The port's distances are ``|a|^2 + |b|^2 - 2 a.b``, the norms from
``torch.sum`` and the cross term from a BLAS product. The two sum in
different orders, so on wide-ranging coordinates a word's distance to
itself can be left above the zero snap (on ``exp(3 N(0, 1))`` coordinates
at m=300, 5 of 429 self-distances, the largest 143.1). Every site knows
the vocabulary ids of both sides and pins the pairs of the same id to 0;
elsewhere each site is held to its JAX counterpart within float32 rtol
1e-5 / atol 1e-6, or, where a distance is small against its pair's norms,
within the float32 band of the expansion itself: d^2 within
EXPANSION_ULPS 2^-24 (|a|^2 + |b|^2) (on these inputs each package's d^2
is within 28 and 14 such units of the float64 value, and the two within
22 of each other, at m=300). Under a bfloat16 compute dtype nothing is
pinned (the JAX package's plain path leaves a residue there too); the
product's operands are rounded to bfloat16 and summed in float32, within a
few float32 ulps of JAX's ``preferred_element_type`` product.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import geometry as jgeo
from repro.core import histogram as jhist
from repro.core import lc as jlc
from repro_torch.api import EmdIndex, EngineConfig
from repro_torch.cascade import rescore
from repro_torch.core import geometry, histogram, lc
from repro_torch.core.lc import Corpus
from repro_torch.data.synth import make_clustered_text
from repro_torch.kernels import ops as tops

F32_TOL = dict(rtol=1e-5, atol=1e-6)
EXPANSION_ULPS = 64
ROWS, STEP, NQ = 3000, 7, 3          # 429 query bins: ids 0, 7, ..., 2996
SITES = ["pairwise_dist", "phase1_stacked_dist", "phase1_valid_dist",
         "dist_topk_plain", "phase1", "pair_from_corpus"]


@functools.cache
def _inputs(m):
    """Coordinates spread over many orders of magnitude and the query bins
    ``ids`` (NQ queries of 143 bins)."""
    a = np.exp(3 * np.random.default_rng(0).standard_normal(
        (ROWS, m))).astype(np.float32)
    ids = np.arange(0, ROWS, STEP)
    return a, ids


def _split(ids):
    q = ids.reshape(NQ, -1)
    return q, np.ones(q.shape, np.float32) / q.shape[1]


def _close(got, want, n2):
    """Where got is within F32_TOL of want, or its square within the
    expansion's float32 band (EXPANSION_ULPS 2^-24 n2)."""
    g, w = got.astype(np.float64), want.astype(np.float64)
    band = np.abs(g * g - w * w) <= EXPANSION_ULPS * 2.0**-24 * n2
    return np.isclose(got, want, **F32_TOL) | band


def _site(name, a, ids):
    """(port distances, JAX distances, mask of the same-id pairs, the
    pairs' |a|^2 + |b|^2) of one site on the inputs, as numpy arrays of one
    shape (for the selections, the row's with the widest query bin's)."""
    A, I = torch.tensor(a), torch.tensor(ids)
    r2 = (a.astype(np.float64) ** 2).sum(axis=1)
    n2 = r2[:, None] + r2[ids][None, :]
    q_ids, q_w = _split(ids)
    Q, W = torch.tensor(q_ids), torch.tensor(q_w)
    col = np.arange(len(ids))
    same = np.zeros((ROWS, len(ids)), bool)
    same[ids, col] = True
    if name == "pairwise_dist":
        got = geometry.pairwise_dist(A, A[I], b_ids=I).numpy()
        want = np.asarray(jgeo.pairwise_dist(jnp.asarray(a),
                                             jnp.asarray(a[ids])))
    elif name == "phase1_stacked_dist":
        got = lc.phase1_stacked_dist(A, Q, W).reshape(ROWS, -1).numpy()
        want = np.asarray(jlc.phase1_stacked_dist(
            jnp.asarray(a), jnp.asarray(q_ids), jnp.asarray(q_w))
        ).reshape(ROWS, -1)
    elif name == "phase1_valid_dist":
        Dv, _, _ = lc.phase1_valid_dist(A, Q, W)
        got = Dv.numpy()
        want = np.asarray(jlc.phase1_stacked_dist(
            jnp.asarray(a), jnp.asarray(q_ids), jnp.asarray(q_w))
        ).reshape(ROWS, -1)
    elif name == "dist_topk_plain":
        # k = 1: each row's nearest bin; a bin's own row holds 0 there.
        z, _ = tops.dist_topk_batched(A, A[Q].contiguous(), W > 0, 1,
                                      qids=Q)
        got = z[..., 0].T.numpy()                       # (v, nq)
        zj, _ = jlc.phase1_batched(jnp.asarray(a), jnp.asarray(q_ids),
                                   jnp.asarray(q_w), 1)
        want = np.asarray(zj)[..., 0].T
        same = np.zeros(got.shape, bool)
        for q in range(NQ):
            same[q_ids[q], q] = True
        n2 = r2[:, None] + r2[ids].max()
    elif name == "phase1":
        z, _ = lc.phase1(A, I, torch.ones(len(ids)) / len(ids), 2)
        got = z.numpy()
        zj, _ = jlc.phase1(jnp.asarray(a), jnp.asarray(ids),
                           jnp.ones(len(ids)) / len(ids), 2)
        want = np.asarray(zj)
        same = np.zeros(got.shape, bool)
        same[ids, 0] = True
        n2 = r2[:, None] + r2[ids].max()
    else:                               # pair_from_corpus: row 0 with itself
        c = Corpus(ids=Q.int(), w=W, coords=A)
        got = histogram.pair_from_corpus(c, 0, 0)[2].numpy()
        jc = jlc.Corpus(ids=jnp.asarray(q_ids, jnp.int32),
                        w=jnp.asarray(q_w), coords=jnp.asarray(a))
        want = np.asarray(jhist.pair_from_corpus(jc, 0, 0)[2])
        same = np.eye(got.shape[0], dtype=bool)
        n2 = r2[q_ids[0]][:, None] + r2[q_ids[0]][None, :]
    return got, want, same, np.broadcast_to(n2, got.shape)


@pytest.mark.parametrize("m", [300, 1000])
@pytest.mark.parametrize("site", SITES)
def test_same_ids_are_exactly_zero_at_every_site(site, m):
    got, want, same, n2 = _site(site, *_inputs(m))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[same], 0.0)
    assert _close(got, want, n2)[~same].all()
    assert np.isclose(got, want, **F32_TOL)[~same].mean() > 0.999


def test_the_unpinned_product_misses_zeros_on_these_inputs():
    """The inputs do show the fault: without the ids, the port's float32
    product leaves self-distances above the snap (JAX's are exactly 0)."""
    a, ids = _inputs(300)
    A = torch.tensor(a)
    d = geometry.pairwise_dist(A, A[torch.tensor(ids)]).numpy()
    self_d = d[ids, np.arange(len(ids))]
    assert (self_d > 0).sum() >= 1
    j = np.asarray(jgeo.pairwise_dist(jnp.asarray(a), jnp.asarray(a[ids])))
    np.testing.assert_array_equal(j[ids, np.arange(len(ids))], 0.0)


def test_dedup_branch_pins_the_distinct_columns():
    """phase1_stacked_dist / phase1_valid_dist past the dedup gate (nq*h >=
    4v) embed each distinct id once; its own row still reads 0."""
    a, _ = _inputs(300)
    v = 64
    q_ids = np.tile(np.arange(v), (5, 1))            # 320 slots >= 4 * 64
    q_w = np.full(q_ids.shape, 1.0 / v, np.float32)
    A, Q, W = (torch.tensor(x) for x in (a[:v], q_ids, q_w))
    D = lc.phase1_stacked_dist(A, Q, W)              # (v, nq, h)
    Dv, _, _ = lc.phase1_valid_dist(A, Q, W)         # (v, nq*h)
    want = np.asarray(jlc.phase1_stacked_dist(
        jnp.asarray(a[:v]), jnp.asarray(q_ids), jnp.asarray(q_w)))
    rows = np.arange(v)
    r2 = (a[:v].astype(np.float64) ** 2).sum(axis=1)
    n2 = (r2[:, None] + r2[None, :])[:, None, :]
    for got in (D.numpy(), Dv.numpy().reshape(v, 5, v)):
        np.testing.assert_array_equal(got[rows, :, rows], 0.0)
        assert _close(got, want, n2).all()


def test_rescorer_sites_see_exact_zeros(monkeypatch):
    """The cascade's rescorers: the exact LP of a row against itself is 0,
    and the Sinkhorn rescorer's costs are 0 between slots of one id."""
    a, ids = _inputs(300)
    q_ids, q_w = _split(ids)
    c = Corpus(ids=torch.tensor(q_ids, dtype=torch.int32),
               w=torch.tensor(q_w), coords=torch.tensor(a))
    cand = torch.arange(NQ)[:, None]
    exact = rescore.emd_cand_host(c, c.ids, c.w, cand)
    np.testing.assert_array_equal(exact, 0.0)
    seen = {}

    def spy(p, q, C, **_):
        seen["C"] = C
        return torch.zeros(C.shape[:2])
    monkeypatch.setattr(rescore, "sinkhorn_cost", spy)
    rescore.sinkhorn_cand(c, c.ids, c.w, cand)
    C = seen["C"]                                    # (nq, 1, hmax, h)
    for q in range(NQ):
        assert (torch.diagonal(C[q, 0]) == 0).all()


@pytest.mark.parametrize("shape", [(50, 16, 40), (200, 300, 30)])
def test_bf16_compute_is_jax_preferred_element_product(rng, shape):
    """compute_dtype=bfloat16: the operands rounded to bfloat16, products
    exact and sums float32, as JAX's dot_general with
    preferred_element_type=float32; norms, snap and sqrt float32."""
    na, m, nb = shape
    a = rng.standard_normal((na, m)).astype(np.float32)
    b = rng.standard_normal((nb, m)).astype(np.float32)
    got = geometry.pairwise_dist(torch.tensor(a), torch.tensor(b),
                                 compute_dtype=torch.bfloat16)
    want = np.asarray(jgeo.pairwise_dist(jnp.asarray(a), jnp.asarray(b),
                                         compute_dtype=jnp.bfloat16))
    assert got.dtype == torch.float32
    # A few float32 ulps of the squared distance's terms (~2m), through
    # the sqrt of a distance near sqrt(2m).
    np.testing.assert_allclose(got.numpy(), want, rtol=8 * 2.0**-23,
                               atol=0)
    exact = np.asarray(jgeo.pairwise_dist(jnp.asarray(a), jnp.asarray(b)))
    assert np.abs(got.numpy() - exact).max() > 1e-4     # it did round


def test_bf16_compute_pins_nothing():
    """Under a reduced compute dtype the same-id pin is off, as JAX's plain
    path leaves a residue at those pairs."""
    a, ids = _inputs(300)
    A, I = torch.tensor(a[:200]), torch.tensor(np.arange(0, 200, 7))
    d = geometry.pairwise_dist(A, A[I], compute_dtype=torch.bfloat16,
                               b_ids=I)
    j = np.asarray(jgeo.pairwise_dist(jnp.asarray(a[:200]),
                                      jnp.asarray(a[:200][I.numpy()]),
                                      compute_dtype=jnp.bfloat16))
    col = np.arange(len(I))
    assert (d.numpy()[I.numpy(), col] > 0).any()
    r2 = (a[:200].astype(np.float64) ** 2).sum(axis=1)
    assert _close(d.numpy(), j, r2[:, None] + r2[I.numpy()][None, :]).all()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["rwmd", "rwmd_rev"])
def test_all_pairs_diagonal_is_exactly_zero_on_the_card(cuda, method):
    """A 20 Newsgroups-width corpus (m=300) cut to 300 rows: the all-pairs
    diagonal, a row's distance to itself, is exactly 0 on both backends."""
    c, _ = make_clustered_text(300, vocab=4096, m=300, hmax=64, seed=0)
    index = EmdIndex.build(c, EngineConfig(method=method), device=cuda)
    for backend in ("cuda", "reference"):
        S = index.with_config(backend=backend).all_pairs()
        torch.cuda.synchronize()
        assert (torch.diagonal(S) == 0).all(), backend
