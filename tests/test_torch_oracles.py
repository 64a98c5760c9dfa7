"""The port's per-pair relaxations (``core/relaxations.py``) and WMD baseline
(``core/wmd.py``) against the JAX package's, on the same numpy inputs.

* Each relaxation and its symmetric form within a few float32 ulps of
  JAX's (the sums run in another order; the ranked costs and destinations
  are the same, ties to the lowest destination).
* Theorem 2's chain RWMD <= OMR <= ACT-k <= ICT <= EMD on random pairs.
* The single-query engines equal the relaxation of each (row, query) pair
  (``pair_from_corpus``), within float32 rtol 1e-5 / atol 1e-6.
* ``wmd_search``: the same row ids and exact distances as JAX's on a small
  corpus; ``wmd_all_pairs_precision`` the same float.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import histogram as jhist
from repro.core import lc as jlc
from repro.core import relaxations as jrel
from repro.core import wmd as jwmd
from repro.data import synth as jsynth
import repro_torch.core as tcore
from repro_torch.api import corpus_from_numpy
from repro_torch.core import histogram, lc, relaxations, wmd

F32_TOL = dict(rtol=1e-5, atol=1e-6)
#: A few float32 ulps of a sum of ~10 terms of order 1.
ULPS = dict(rtol=8 * 2.0**-23, atol=8 * 2.0**-23)
DIRECTIONAL = ["rwmd_dir", "omr_dir", "ict_dir", "act_dir"]
SYMMETRIC = ["rwmd", "omr", "ict", "act"]


def _pair(rng, hp, hq, overlap=True, ties=False):
    p = rng.uniform(0.1, 1.0, hp).astype(np.float32)
    q = rng.uniform(0.1, 1.0, hq).astype(np.float32)
    p, q = p / p.sum(), q / q.sum()
    C = (rng.integers(0, 4, size=(hp, hq)) / 4.0 if ties
         else rng.uniform(0.0, 2.0, size=(hp, hq))).astype(np.float32)
    if overlap:
        C[0, 1] = C[2 % hp, 0] = 0.0                   # overlapping bins
    return p, q, C


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("hp,hq", [(5, 6), (9, 3), (12, 12)])
@pytest.mark.parametrize("name", DIRECTIONAL + SYMMETRIC)
def test_relaxations_match_jax(rng, name, hp, hq, ties):
    p, q, C = _pair(rng, hp, hq, ties=ties)
    tfn, jfn = getattr(relaxations, name), getattr(jrel, name)
    iters_list = [0, 1, 3, hq + 2] if name.startswith("act") else [None]
    for iters in iters_list:
        kw = {} if iters is None else {"iters": iters}
        got = tfn(torch.tensor(p), torch.tensor(q), torch.tensor(C), **kw)
        want = jfn(jnp.asarray(p), jnp.asarray(q), jnp.asarray(C), **kw)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(got.item(), float(want), **ULPS)


@pytest.mark.parametrize("seed", range(6))
def test_theorem_2_chain(seed):
    rng = np.random.default_rng(seed)
    p, q, C = _pair(rng, 6, 7, overlap=seed % 2 == 0)
    P, Q, Cc = torch.tensor(p), torch.tensor(q), torch.tensor(C)
    chain = [relaxations.rwmd_dir(P, Q, Cc), relaxations.omr_dir(P, Q, Cc),
             relaxations.act_dir(P, Q, Cc, iters=1),
             relaxations.act_dir(P, Q, Cc, iters=3),
             relaxations.ict_dir(P, Q, Cc),
             torch.tensor(tcore.emd_exact(p, q, C))]
    vals = [float(x) for x in chain]
    for lo, hi in zip(vals, vals[1:]):
        assert lo <= hi * (1 + 1e-5) + 1e-7


@pytest.fixture(scope="module")
def corpora():
    c, labels = jsynth.make_text_like(n_docs=30, n_classes=3, vocab=64,
                                      m=4, doc_len=14, hmax=10, seed=7)
    ids, w, coords = (np.asarray(a) for a in (c.ids, c.w, c.coords))
    jc = jlc.Corpus(ids=jnp.asarray(ids), w=jnp.asarray(w),
                    coords=jnp.asarray(coords))
    return jc, corpus_from_numpy(ids, w, coords, "cpu"), labels


@pytest.mark.parametrize("use_kernels", [False, True])
def test_engines_equal_the_relaxation_of_each_pair(corpora, use_kernels):
    """Row u's score of query q under the single-query engine is the
    directional relaxation of the pair (u into q)."""
    _, tc, _ = corpora
    qrow = 4
    q_ids, q_w = tc.ids[qrow], tc.w[qrow]
    engines = {
        "rwmd": (lc.lc_rwmd_scores(tc, q_ids, q_w, use_kernels=use_kernels),
                 relaxations.rwmd_dir, {}),
        "omr": (lc.lc_omr_scores(tc, q_ids, q_w, use_kernels=use_kernels),
                relaxations.omr_dir, {}),
        "act": (lc.lc_act_scores(tc, q_ids, q_w, iters=3,
                                 use_kernels=use_kernels),
                relaxations.act_dir, {"iters": 3}),
        "ict": (lc.lc_ict_scores(tc, q_ids, q_w), relaxations.ict_dir, {}),
    }
    for name, (scores, fn, kw) in engines.items():
        for u in range(tc.n):
            p, q, C = histogram.pair_from_corpus(tc, u, qrow)
            keep_p, keep_q = p > 0, q > 0
            want = fn(p[keep_p], q[keep_q], C[keep_p][:, keep_q], **kw)
            torch.testing.assert_close(scores[u], want, **F32_TOL,
                                       msg=f"{name} row {u}")


@pytest.mark.parametrize("q_index,top_l", [(0, 3), (5, 4), (11, 2)])
def test_wmd_search_matches_jax(corpora, q_index, top_l):
    jc, tc, _ = corpora
    got_d, got_i = wmd.wmd_search(tc, q_index, top_l)
    want_d, want_i = jwmd.wmd_search(jc, q_index, top_l)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-6)
    assert q_index not in got_i.tolist()
    # exact distances never fall below the LC-RWMD bound of their rows
    lb = lc.lc_rwmd_scores(tc, tc.ids[q_index], tc.w[q_index]).numpy()
    assert (got_d >= lb[got_i] - 1e-6).all()


def test_wmd_all_pairs_precision_matches_jax(corpora):
    jc, tc, labels = corpora
    got = wmd.wmd_all_pairs_precision(tc, labels, 3, n_queries=5)
    want = jwmd.wmd_all_pairs_precision(jc, labels, 3, n_queries=5)
    assert got == pytest.approx(want, abs=1e-12)


def test_pair_from_corpus_self_pair_has_zero_diagonal(corpora):
    jc, tc, _ = corpora
    p, q, C = histogram.pair_from_corpus(tc, 3, 3)
    live = torch.nonzero(p > 0)[:, 0]
    assert (C[live, live] == 0).all()
    Cj = np.asarray(jhist.pair_from_corpus(jc, 3, 3)[2])
    np.testing.assert_allclose(C.numpy(), Cj, **F32_TOL)


def test_core_exports_what_the_quickstart_imports():
    """``repro_torch.core`` exports the JAX package's ``repro.core`` names
    but the two it has no counterpart for (the flow of the exact LP and
    the vmapped Sinkhorn, whose batch is the leading axes of
    ``sinkhorn_cost`` here)."""
    assert set(tcore.__all__) == set(jcore.__all__) - {"emd_exact_flow",
                                                       "sinkhorn_batch"}
    for name in tcore.__all__:
        assert callable(getattr(tcore, name)) or name == "Corpus"
