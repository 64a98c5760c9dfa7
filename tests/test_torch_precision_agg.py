"""The ``bf16_agg`` precision policy (bfloat16 handoffs and matmul operands,
float32 accumulators) in the port against the JAX package's, on the same
numpy inputs.

The policy reaches the distances in two ways, in both packages: the plain
Phase 1 rounds only the cross term's operands to bfloat16 (the norms stay
float32), while the ``dist_topk`` kernel is given bfloat16 coordinates and
takes its norms from them too. So the two backends of one package differ
by more than under ``bf16``, and the parity bar is the reference's
measured 0.4 absolute band (``tests/test_precision.py``), not bitwise.
K1 on bfloat16 coordinates is held to the Pallas kernel on the same
coordinates more tightly: Z within float32 rounding, S equal except
between columns whose distances tie within it.

Against its own float32 scores the plain bf16_agg path holds that band
except on LC-OMR, in both packages: its overlap test (a nearest cost of
exactly 0) sees a word's bfloat16 residue distance to itself, which
float32 pins to 0, so a row that overlaps under one policy need not under
the other (here 5 of 1,200 scores move by up to 0.56 in the port, 5 in the
JAX package); every score beyond the band must be such a row.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import cascade as jcas
from repro.api import EmdIndex as JIndex
from repro.api import EngineConfig as JConfig
from repro.data.synth import make_clustered_text
from repro.kernels import ops as jops
from repro_torch import cascade as tcas
from repro_torch.api import EmdIndex, EngineConfig, corpus_from_numpy
from repro_torch.core import lc
from repro_torch.kernels import dist_topk
from repro_torch.kernels import ops as tops

AGG_ATOL = 0.4
METHODS = [("act", 1), ("act", 7), ("rwmd", 0), ("rwmd_rev", 0),
           ("omr", 0), ("ict", 0), ("bow", 0), ("wcd", 0)]


@pytest.fixture(scope="module")
def corpus():
    # Zipf lengths of at least 8 bins (k of act-7), where JAX's two act
    # paths agree (ROADMAP Queue 3).
    return make_clustered_text(200, n_topics=6, vocab=256, m=16, hmax=16,
                               min_len=8, seed=2)[0]


def _port(c, **cfg):
    tc = corpus_from_numpy(c.ids, c.w, c.coords, "cpu")
    return EmdIndex.build(tc, EngineConfig(top_l=5, **cfg), device="cpu")


def _zero_nearest(corpus, qi, qw, precision):
    """(nq, v): where the plain Phase 1's nearest cost is exactly 0."""
    z, _ = lc.phase1_batched(torch.tensor(np.asarray(corpus.coords)),
                             torch.tensor(qi), torch.tensor(qw), 2,
                             precision=precision)
    return z[..., 0].float().numpy() == 0


def _overlap_flips(corpus, zero_a, zero_b):
    """(nq, n): rows with a live slot at a cost that is exactly 0 under one
    Phase 1 and not under the other (LC-OMR's overlap test)."""
    ids, live = np.asarray(corpus.ids), np.asarray(corpus.w) > 0
    return ((zero_a[:, ids] != zero_b[:, ids]) & live[None]).any(axis=-1)


@pytest.mark.parametrize("backend,jax_backend", [("cuda", "pallas"),
                                                 ("reference", "reference")])
@pytest.mark.parametrize("method,iters", METHODS)
def test_bf16_agg_scores_match_jax(corpus, method, iters, backend,
                                   jax_backend):
    qi, qw = np.asarray(corpus.ids[:6]), np.asarray(corpus.w[:6])
    cfg = dict(method=method, iters=iters)
    got = _port(corpus, backend=backend, precision="bf16_agg",
                **cfg).scores(qi, qw).numpy()
    want = np.asarray(JIndex.build(corpus, JConfig(
        backend=jax_backend, precision="bf16_agg", **cfg)).scores(qi, qw))
    assert got.dtype == np.float32 and got.shape == want.shape
    f32 = _port(corpus, backend=backend, **cfg).scores(qi, qw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=AGG_ATOL)
    if method == "omr" and backend == "reference":
        flips = _overlap_flips(corpus,
                               _zero_nearest(corpus, qi, qw, "bf16_agg"),
                               _zero_nearest(corpus, qi, qw, "f32"))
        assert not ((np.abs(got - f32) > AGG_ATOL) & ~flips).any()
    else:
        np.testing.assert_allclose(got, f32, rtol=0, atol=AGG_ATOL)
    assert np.isfinite(got).all() and got.max() < 1e3


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("preset", ["chain", "tight", "fast"])
def test_bf16_agg_cascades_match_jax(corpus, preset, use_kernels):
    qi, qw = np.asarray(corpus.ids[:6]), np.asarray(corpus.w[:6])
    want = jcas.cascade_search(corpus, jnp.asarray(qi), jnp.asarray(qw),
                               preset, 5, precision="bf16_agg",
                               use_kernels=use_kernels)
    tcorp = corpus_from_numpy(corpus.ids, corpus.w, corpus.coords, "cpu")
    got = tcas.cascade_search(tcorp, torch.tensor(qi), torch.tensor(qw),
                              preset, 5, precision="bf16_agg",
                              use_kernels=use_kernels)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=AGG_ATOL)
    assert (got.indices[:, 0] == torch.arange(6)).all()      # self first
    f32 = tcas.cascade_search(tcorp, torch.tensor(qi), torch.tensor(qw),
                              preset, 5, use_kernels=use_kernels)
    overlap = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(
        got.indices.tolist(), f32.indices.tolist())])
    assert overlap >= 0.6


def test_kernel_dispatch_gives_k1_bf16_coordinates(corpus, monkeypatch):
    """Under bf16_agg the kernel path hands K1 bfloat16 coordinates (JAX
    casts coords and the query coordinates before its kernel); under bf16
    and f32 float32 ones."""
    tc = corpus_from_numpy(corpus.ids, corpus.w, corpus.coords, "cpu")
    seen = []
    real = tops.dist_topk_batched

    def spy(coords, qcs, qmask, k, **kw):
        seen.append((coords.dtype, qcs.dtype, kw["out_dtype"]))
        return real(coords, qcs, qmask, k, **kw)
    monkeypatch.setattr(tops, "dist_topk_batched", spy)
    for precision in ("f32", "bf16", "bf16_agg"):
        lc._phase1_batched_dispatch(tc, tc.ids[:3], tc.w[:3], 2, True,
                                    precision)
    f32, bf16 = torch.float32, torch.bfloat16
    assert seen == [(f32, f32, f32), (f32, f32, bf16), (bf16, bf16, bf16)]


@pytest.mark.parametrize("k", [1, 2, 8])
def test_k1_plain_on_bf16_coordinates_matches_pallas(rng, k):
    """K1's plain version on bfloat16 coordinates against the Pallas
    kernel on the same coordinates (interpret mode): both upcast to
    float32 and select in float32."""
    v, nq, h, m = 70, 3, 12, 16
    coords = rng.normal(size=(v, m)).astype(np.float32)
    qids = rng.integers(0, v, size=(nq, h))
    qmask = rng.uniform(size=(nq, h)) < 0.7
    qmask[1] = False
    cb = torch.tensor(coords).to(torch.bfloat16)
    zt, st = dist_topk.dist_topk_plain(cb, cb[qids].contiguous(),
                                       torch.tensor(qmask), k,
                                       qids=torch.tensor(qids))
    cj = jnp.asarray(coords).astype(jnp.bfloat16)
    zj, sj = jops.dist_topk_batched(cj, cj[jnp.asarray(qids)], k,
                                    qmask=jnp.asarray(qmask), block_v=32,
                                    block_h=16)
    zj, sj = np.asarray(zj), np.asarray(sj)
    np.testing.assert_allclose(zt.numpy(), zj, rtol=1e-5, atol=1e-5)
    diff = st.numpy() != sj
    assert diff.mean() < 0.02
    np.testing.assert_allclose(zt.numpy()[diff], zj[diff], rtol=1e-5,
                               atol=1e-5)
    # the same-id pairs read exactly 0 (a valid bin's own row)
    q, c = np.nonzero(qmask)
    np.testing.assert_array_equal(zt.numpy()[q, qids[q, c], 0], 0.0)


def test_k1_wrapper_takes_bf16_coordinates_only_in_pairs(rng):
    coords = torch.tensor(rng.normal(size=(20, 4)).astype(np.float32))
    qcs = coords[:6].reshape(2, 3, 4).contiguous()
    qmask = torch.ones(2, 3, dtype=torch.bool)
    with pytest.raises(ValueError, match="qcs"):
        tops.dist_topk_batched(coords.to(torch.bfloat16), qcs, qmask, 2)
    with pytest.raises(ValueError, match="coords"):
        tops.dist_topk_batched(coords.half(), qcs.half(), qmask, 2)
    z, s = tops.dist_topk_batched(coords.to(torch.bfloat16),
                                  qcs.to(torch.bfloat16), qmask, 2)
    assert z.dtype == torch.float32 and s.shape == (2, 20, 2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_k1_cuda_on_bf16_coordinates_matches_plain(rng, cuda, k, out_dtype):
    """The kernel on bfloat16 coordinates: Z within float32 rounding of the
    plain version (a few float32 ulps of the distance, ~22 here; one
    bfloat16 ulp on a bfloat16 store), S equal except at near-ties, exact
    zeros at the same-id pairs on both."""
    v, nq, h, m = 3000, 5, 40, 300
    coords = torch.tensor(rng.normal(size=(v, m)).astype(np.float32),
                          device=cuda).to(torch.bfloat16)
    qids = torch.tensor(rng.integers(0, v, size=(nq, h)), device=cuda)
    qmask = torch.tensor(rng.uniform(size=(nq, h)) < 0.5, device=cuda)
    qcs = coords[qids].contiguous()
    zk, sk = tops.dist_topk_batched(coords, qcs, qmask, k,
                                    out_dtype=out_dtype)
    zp, sp = dist_topk.dist_topk_plain(coords, qcs, qmask, k, out_dtype,
                                       qids)
    torch.cuda.synchronize()
    f32 = out_dtype == torch.float32
    torch.testing.assert_close(zk.float(), zp.float(),
                               rtol=8 * 2.0**-23 if f32 else 2.0**-7,
                               atol=1e-5 if f32 else 8e-3)
    assert (sk != sp).float().mean() < 0.01
    q, c = torch.nonzero(qmask, as_tuple=True)
    assert (zk[q, qids[q, c], 0] == 0).all()
    assert (zp[q, qids[q, c], 0] == 0).all()
