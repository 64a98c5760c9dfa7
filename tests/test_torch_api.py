"""The port's ``EmdIndex`` against the JAX package's, on the same numpy
corpus: ``backend="cuda"`` (run here through the kernels' plain versions on
an index built with ``device="cpu"``) against JAX ``backend="pallas"``, and
``backend="reference"`` against JAX ``reference``; plus the configuration
surface and input checks.

Scores: float32 rtol 1e-5 plus atol 1e-6, bfloat16 the 8e-3 absolute band,
held to JAX wherever JAX's two backends agree (see ``test_torch_lc.py`` and
ROADMAP Queue 3 for the queries with fewer valid bins than k where they do
not). Top-l indices: equal wherever JAX's ranking is separated by more than
the tolerance.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import EmdIndex as JIndex
from repro.api import EngineConfig as JConfig
from repro.data.synth import make_text_like
from repro_torch.api import EmdIndex, EngineConfig, corpus_from_numpy
from repro_torch.core import retrieval

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_ATOL = 8e-3


@pytest.fixture(scope="module")
def corpus():
    c, _ = make_text_like(n_docs=24, n_classes=4, vocab=128, m=8,
                          doc_len=10, hmax=16, seed=3)
    return c


def _queries(c):
    """Six corpus rows (self-matches); rows 1 and 2 cut to 1 and 2 valid
    bins, fewer than k."""
    ids = np.asarray(c.ids)[[0, 4, 7, 9, 15, 20]].copy()
    w = np.asarray(c.w)[[0, 4, 7, 9, 15, 20]].copy()
    for r, keep in ((1, 1), (2, 2)):
        w[r, keep:] = 0.0
        w[r] /= w[r].sum()
    return ids, w


def _tol(precision):
    return F32_TOL if precision == "f32" else dict(rtol=0, atol=BF16_ATOL)


def _port_index(c, **cfg):
    tc = corpus_from_numpy(c.ids, c.w, c.coords, "cpu")
    return EmdIndex.build(tc, EngineConfig(top_l=5, **cfg), device="cpu")


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("method,iters", [("act", 1), ("act", 7),
                                          ("rwmd", 0)])
@pytest.mark.parametrize("port_backend,jax_backend",
                         [("cuda", "pallas"), ("reference", "reference")])
def test_scores_and_search_match_jax(corpus, port_backend, jax_backend,
                                     method, iters, precision):
    q_ids, q_w = _queries(corpus)
    other = {"pallas": "reference", "reference": "pallas"}[jax_backend]
    jax = {b: JIndex.build(corpus, JConfig(method=method, iters=iters,
                                           backend=b, top_l=5,
                                           precision=precision))
           for b in (jax_backend, other)}
    index = _port_index(corpus, method=method, iters=iters,
                        backend=port_backend, precision=precision)
    tol = _tol(precision)

    got = index.scores(q_ids, q_w).numpy()
    want = np.asarray(jax[jax_backend].scores(q_ids, q_w))
    promised = np.isclose(want, np.asarray(jax[other].scores(q_ids, q_w)),
                          **tol) & (want < 1e3)
    assert promised.mean() >= 0.5
    np.testing.assert_allclose(got[promised], want[promised], **tol)
    assert got.shape == want.shape and got.max() < 1e3

    s, idx = index.search(q_ids, q_w)
    js, jidx = (np.asarray(a) for a in jax[jax_backend].search(q_ids, q_w))
    assert s.shape == idx.shape == (len(q_ids), 5)
    np.testing.assert_array_equal(s.numpy(), np.sort(got, axis=1)[:, :5])
    for r in range(len(q_ids)):
        ranked = np.sort(want[r])[:6]
        gaps = np.diff(ranked)
        if promised[r].all() and (gaps > 2 * (tol["atol"] + tol["rtol"]
                                              * ranked[1:])).all():
            np.testing.assert_array_equal(idx[r].numpy(), jidx[r])
            np.testing.assert_allclose(s[r].numpy(), js[r], **tol)
    # a self-match is its own nearest row, on both sides
    assert idx[[0, 3, 4, 5], 0].tolist() == [0, 9, 15, 20]


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_single_query_is_a_batch_of_one(corpus, backend):
    # A single query takes the single-query engine (query_scores), as in
    # the JAX package; it agrees with its row of the batch, and the scan
    # engine's batch is bitwise a loop of it.
    q_ids, q_w = _queries(corpus)
    index = _port_index(corpus, iters=3, backend=backend)
    batch = index.scores(q_ids, q_w)
    scan = index.with_config(batch_engine="scan").scores(q_ids, q_w)
    tc = index.corpus
    for r in (0, 3):
        one = index.scores(q_ids[r], q_w[r])
        assert one.shape == (corpus.ids.shape[0],)
        assert torch.equal(one, retrieval.query_scores(
            tc, torch.tensor(q_ids[r]), torch.tensor(q_w[r]),
            **index.config.score_kwargs()))
        assert torch.equal(one, scan[r])
        torch.testing.assert_close(one, batch[r], **F32_TOL)
        s, idx = index.search(q_ids[r], q_w[r])
        assert s.shape == idx.shape == (5,)
    # the JAX single-query engine agrees with the port's
    jax_one = np.asarray(JIndex.build(corpus, JConfig(iters=3)).scores(
        q_ids[0], q_w[0]))
    np.testing.assert_allclose(index.scores(q_ids[0], q_w[0]).numpy(),
                               jax_one, **F32_TOL)


def test_search_ties_go_to_the_lowest_index(corpus):
    """Duplicate rows score equal; like ``lax.top_k`` the lower index
    comes first."""
    ids = np.concatenate([np.asarray(corpus.ids)] * 2)
    w = np.concatenate([np.asarray(corpus.w)] * 2)
    n = corpus.ids.shape[0]
    tc = corpus_from_numpy(ids, w, corpus.coords, "cpu")
    index = EmdIndex.build(tc, EngineConfig(iters=2, top_l=6), device="cpu")
    s, idx = index.search(ids[:3], w[:3])
    assert (idx[:, 0] == torch.arange(3)).all()
    assert (idx[:, 1] == torch.arange(3) + n).all()
    assert torch.equal(s[:, 0], s[:, 1])
    jc = type(corpus)(ids=jnp.asarray(ids), w=jnp.asarray(w),
                      coords=jnp.asarray(corpus.coords))
    _, jidx = JIndex.build(jc, JConfig(iters=2, top_l=6)).search(ids[:3],
                                                                  w[:3])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(
        retrieval.search(tc, tc.ids[:3], tc.w[:3], 6, iters=2)[1].numpy(),
        idx.numpy())


def test_config_has_the_jax_fields():
    port = {f.name for f in dataclasses.fields(EngineConfig)}
    assert port == {f.name for f in dataclasses.fields(JConfig)}
    assert EngineConfig().backend == "cuda"


@pytest.mark.parametrize("field,value", [
    ("backend", "pallas"),
])
def test_unported_config_raises(field, value):
    with pytest.raises(ValueError, match=f"{field}.*not yet ported"):
        EngineConfig(**{field: value})


@pytest.mark.parametrize("field,value", [
    ("method", "omr"), ("method", "rwmd_rev"), ("method", "ict"),
    ("method", "bow"), ("method", "wcd"), ("cascade", "fast"),
    ("precision", "bf16_agg"), ("batch_engine", "scan"),
    ("autotune", "force"), ("autotune", "cached"), ("tune_cache", "t.json"),
    ("block_v", 128), ("block_h", 128), ("block_n", 16), ("rev_block", 64),
    ("backend", "distributed"), ("pad_multiple", 16),
])
def test_formerly_unported_config_values_build(field, value):
    assert getattr(EngineConfig(**{field: value}), field) == value


@pytest.mark.parametrize("field,value", [
    ("method", "nope"), ("backend", "tpu"), ("precision", "fp8"),
    ("iters", -1), ("top_l", 0), ("block_q", 0), ("batch_engine", "dist"),
    ("pad_multiple", 0),
])
def test_bad_config_raises(field, value):
    with pytest.raises(ValueError, match=field.replace("_", ".")):
        EngineConfig(**{field: value})


def test_build_without_device_raises_on_a_cpu_only_host(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = corpus_from_numpy(corpus.ids, corpus.w, corpus.coords, "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EmdIndex.build(tc)
    assert EmdIndex.build(tc, device="cpu").corpus.device.type == "cpu"


@pytest.mark.parametrize("case", ["shape", "rank", "range", "float_ids",
                                  "top_l"])
def test_bad_queries_raise(corpus, case):
    index = _port_index(corpus)
    q_ids, q_w = _queries(corpus)
    with pytest.raises(ValueError):
        if case == "shape":
            index.scores(q_ids, q_w[:, :3])
        elif case == "rank":
            index.scores(q_ids[None], q_w[None])
        elif case == "range":
            index.scores(q_ids + 1000, q_w)
        elif case == "float_ids":
            index.scores(q_ids.astype(np.float32), q_w)
        else:
            index.search(q_ids, q_w, top_l=corpus.ids.shape[0] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("method,iters", [("act", 7), ("rwmd", 0)])
def test_cuda_backend_matches_reference_on_the_card(corpus, method, iters):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only there")
    q_ids, q_w = _queries(corpus)
    tc = corpus_from_numpy(corpus.ids, corpus.w, corpus.coords, "cpu")
    cfg = dict(method=method, iters=iters, top_l=5)
    got = EmdIndex.build(tc, EngineConfig(**cfg)).scores(q_ids, q_w)
    want = EmdIndex.build(tc, EngineConfig(backend="reference", **cfg)
                          ).scores(q_ids, q_w)
    torch.testing.assert_close(got, want, **F32_TOL)
