"""The port's candidate kernels and candidate engines against the JAX
package's.

* Each plain kernel version (``cand_pour``, ``cand_omr``, ``cand_rev_min``,
  ``cand_ict``, ``act_phase2_cand``) against the JAX wrapper
  (``repro.kernels.ops``, which runs the Pallas kernel in interpret mode
  here) and against its oracle in ``repro.kernels.ref``, across duplicate
  candidate ids, pad rows, b not a multiple of any block, nq=1, ICT cost
  ties and ICT rows whose remainder must go to the max finite cost.
* The gather, bitwise: the port's ``gather_rows`` against JAX's
  ``gather_per_query``, and one-slot probes whose score is the gathered
  value itself.
* Each ``lc_*_scores_cand`` engine, reference and kernel path, against
  JAX's, under f32 and bf16.
* The wrappers' dispatch (CPU tensors -> plain version, no launch) and
  their input checks; on a CUDA card only, each CUDA kernel against its
  plain version.

Tolerances. Plain version vs Pallas kernel or oracle: float32 rtol 1e-5
plus atol 1e-6 (the same formulas, summed in another order). Engines:
f32 rtol 1e-5 / atol 1e-6; bf16 the reference's 8e-3 absolute band
(``tests/test_cand_kernels.py``), since JAX and the port round their bf16
handoffs from float32 distances that already differ by ulps. act and rwmd
compare only where JAX's own two engines agree (ROADMAP Queue 3: the JAX
pour's one-ulp remainder at the sentinel); the corpora here have no query
with fewer valid bins than k, so that is every score.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lc as jlc
from repro.core.lc import PAD_DIST
from repro.data.synth import make_text_like
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.api import corpus_from_numpy
from repro_torch.core import lc
from repro_torch.core.precision import pad_dist_for
from repro_torch.kernels import act_phase2, cand_pour
from repro_torch.kernels import ops as tops

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_ATOL = 8e-3
CAND_METHODS = ("rwmd", "rwmd_rev", "omr", "act", "ict")


def _cand_inputs(rng, nq, b, hmax, v):
    idsg = rng.integers(0, v, (nq, b, hmax)).astype(np.int32)
    xg = (rng.uniform(size=(nq, b, hmax)) *
          (rng.uniform(size=(nq, b, hmax)) > 0.3)).astype(np.float32)
    return idsg, xg


def _handoff(rng, nq, v, k, width_w):
    Z = np.sort(rng.uniform(size=(nq, v, k)), axis=-1).astype(np.float32)
    W = (rng.uniform(size=(nq, v, width_w)) * 0.3).astype(np.float32)
    return Z, W


def _dist_handoff(rng, nq, v, h, ties=False):
    """A (nq, v, h) distance handoff and (nq, h) query weights with one
    padded query bin per query (sentinel cost, zero weight); ``ties``
    rounds the costs to one decimal so many entries tie."""
    Dq = rng.uniform(size=(nq, v, h))
    if ties:
        Dq = Dq.round(1)
    qw = rng.uniform(size=(nq, h))
    Dq[:, :, -1] = PAD_DIST
    qw[:, -1] = 0.0
    qw /= qw.sum(axis=1, keepdims=True)
    return Dq.astype(np.float32), qw.astype(np.float32)


# ------------------------------------------- plain versions vs the Pallas


@pytest.mark.parametrize("nq,b,hmax,v,iters", [
    (1, 9, 7, 37, 0), (3, 13, 7, 37, 3), (2, 8, 16, 128, 1),
    (4, 30, 5, 64, 7), (2, 21, 9, 40, 2),
])
def test_cand_pour_plain_matches_pallas(rng, nq, b, hmax, v, iters):
    idsg, xg = _cand_inputs(rng, nq, b, hmax, v)
    Z, W = _handoff(rng, nq, v, iters + 1, max(iters, 1))
    Wj = None if iters == 0 else jnp.asarray(W)
    want = np.asarray(jops.cand_pour(jnp.asarray(idsg), jnp.asarray(xg),
                                     jnp.asarray(Z), Wj, iters, block_n=8,
                                     block_v=16))
    oracle = np.asarray(jref.cand_pour_ref(jnp.asarray(idsg),
                                           jnp.asarray(xg), jnp.asarray(Z),
                                           Wj, iters))
    got = cand_pour.cand_pour_plain(torch.tensor(idsg), torch.tensor(xg), torch.tensor(Z),
                                    None if iters == 0 else torch.tensor(W), iters)
    assert got.shape == (nq, b) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    np.testing.assert_allclose(got.numpy(), oracle, **F32_TOL)


@pytest.mark.parametrize("nq,b,hmax,v", [(1, 9, 7, 37), (3, 13, 9, 64),
                                         (2, 17, 4, 20)])
def test_cand_omr_plain_matches_pallas(rng, nq, b, hmax, v):
    idsg, xg = _cand_inputs(rng, nq, b, hmax, v)
    Z, W = _handoff(rng, nq, v, 2, 1)
    Z[:, ::3, 0] = 0.0             # exact-zero nearest costs: overlap branch
    W0 = W[..., 0]
    args = (jnp.asarray(idsg), jnp.asarray(xg), jnp.asarray(Z),
            jnp.asarray(W0))
    got = cand_pour.cand_omr_plain(torch.tensor(idsg), torch.tensor(xg), torch.tensor(Z), torch.tensor(W0)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jops.cand_omr(*args, block_n=8, block_v=16)),
        **F32_TOL)
    np.testing.assert_allclose(got, np.asarray(jref.cand_omr_ref(*args)),
                               **F32_TOL)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("mode", ["rev_min", "ict"])
@pytest.mark.parametrize("nq,b,hmax,v,h", [(1, 9, 7, 37, 6),
                                           (3, 13, 5, 64, 10),
                                           (2, 19, 6, 30, 33)])
def test_cand_dist_plain_matches_pallas(rng, mode, nq, b, hmax, v, h, ties):
    idsg, xg = _cand_inputs(rng, nq, b, hmax, v)
    Dq, qw = _dist_handoff(rng, nq, v, h, ties=ties)
    args = tuple(jnp.asarray(a) for a in (idsg, xg, Dq, qw))
    op = jops.cand_rev_min if mode == "rev_min" else jops.cand_ict
    oracle = (jref.cand_rev_min_ref if mode == "rev_min"
              else jref.cand_ict_ref)
    plain = (cand_pour.cand_rev_min_plain if mode == "rev_min"
             else cand_pour.cand_ict_plain)
    got = plain(torch.tensor(idsg), torch.tensor(xg), torch.tensor(Dq), torch.tensor(qw)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(op(*args, block_n=8, block_v=16)), **F32_TOL)
    np.testing.assert_allclose(got, np.asarray(oracle(*args)), **F32_TOL)


def test_cand_ict_plain_pours_through_tied_costs():
    """Two query bins at the same cost: the pour fills both (in either
    order the tie group takes the same mass at the same cost) before the
    next cost, and the remainder-free row dumps nothing."""
    idsg = torch.zeros((1, 1, 1), dtype=torch.int32)
    xg = torch.tensor([[[0.5]]])
    Dq = torch.tensor([[[1.0, 1.0, 3.0]]])
    qw = torch.tensor([[0.1, 0.3, 0.6]])
    got = cand_pour.cand_ict_plain(idsg, xg, Dq, qw)
    # 0.1 then 0.3 at cost 1, 0.1 at cost 3
    np.testing.assert_allclose(got.numpy(), [[0.4 + 0.3]], rtol=1e-6)
    want = jops.cand_ict(jnp.asarray(idsg.numpy()), jnp.asarray(xg.numpy()),
                         jnp.asarray(Dq.numpy()), jnp.asarray(qw.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_cand_ict_plain_remainder_goes_to_the_max_finite_cost():
    """Total capacity 0.25 < x = 1: the 0.75 remainder is dumped at the
    max FINITE cost of the row (1.0), never at the sentinel."""
    idsg = torch.zeros((1, 1, 1), dtype=torch.int32)
    xg = torch.ones((1, 1, 1))
    Dq = torch.tensor([[[1.0, pad_dist_for(torch.float32)]]])
    qw = torch.tensor([[0.25, 0.0]])
    got = cand_pour.cand_ict_plain(idsg, xg, Dq, qw)
    np.testing.assert_allclose(got.numpy(), [[1.0]], rtol=1e-6)
    want = jops.cand_ict(jnp.asarray(idsg.numpy()), jnp.asarray(xg.numpy()),
                         jnp.asarray(Dq.numpy()), jnp.asarray(qw.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,b,hmax,iters", [(1, 10, 7, 1), (4, 33, 17, 3),
                                             (2, 5, 9, 7)])
def test_act_phase2_cand_plain_matches_pallas(rng, nq, b, hmax, iters,
                                              dtype):
    xg = (rng.uniform(size=(nq, b, hmax)) *
          (rng.uniform(size=(nq, b, hmax)) > 0.3)).astype(np.float32)
    zg = torch.tensor(np.sort(rng.uniform(size=(nq, b, hmax, iters + 1)),
                              -1), dtype=torch.float32).to(dtype)
    wg = torch.tensor(rng.uniform(size=(nq, b, hmax, iters)) * 0.3,
                      dtype=torch.float32).to(dtype)
    # Both sides read the same (possibly bf16-rounded) ladders.
    args = (jnp.asarray(xg), jnp.asarray(zg.float().numpy()),
            jnp.asarray(wg.float().numpy()))
    got = act_phase2.act_phase2_cand_plain(torch.tensor(xg), zg, wg)
    assert got.shape == (nq, b) and got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jops.act_phase2_cand(*args, block_n=16,
                                                     block_h=8)), **F32_TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jref.act_phase2_cand_ref(*args)),
                               **F32_TOL)


# ------------------------------------------------------------- the gather


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_is_bitwise(rng, dtype):
    nq, v, width, b, hmax = 3, 48, 5, 11, 6
    table = (rng.uniform(size=(nq, v, width)) *
             np.where(rng.uniform(size=(nq, v, width)) > 0.9, PAD_DIST, 1.0)
             ).astype(np.float32)
    idsg = rng.integers(0, v, (nq, b, hmax)).astype(np.int32)
    tt = torch.tensor(table).to(dtype)
    got = cand_pour.gather_rows(tt, torch.tensor(idsg))
    want = jlc.gather_per_query(jnp.asarray(tt.float().numpy()),
                                jnp.asarray(idsg))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want))


def _probe(rng, nq, b, hmax, v):
    """One slot per row with x = 1 at a random position, every other slot
    0: a pour with iters=0 then scores exactly the gathered Z0 value."""
    idsg = rng.integers(0, v, (nq, b, hmax)).astype(np.int32)
    xg = np.zeros((nq, b, hmax), np.float32)
    slot = rng.integers(0, hmax, (nq, b))
    np.put_along_axis(xg, slot[..., None], 1.0, axis=-1)
    return torch.tensor(idsg), torch.tensor(xg), torch.tensor(slot)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_probes_are_bitwise(rng, dtype):
    nq, b, hmax, v, h = 3, 14, 6, 40, 7
    idsg, xg, slot = _probe(rng, nq, b, hmax, v)
    ids_at = torch.gather(idsg, 2, slot[..., None])[..., 0].long()
    q = torch.arange(nq)[:, None]
    Z = torch.tensor(rng.uniform(size=(nq, v, 1)),
                     dtype=torch.float32).to(dtype)
    got = tops.cand_pour(idsg, xg, Z, None, 0)
    assert torch.equal(got, Z[q, ids_at, 0].float())
    Dq = torch.tensor(rng.uniform(size=(nq, v, h)),
                      dtype=torch.float32).to(dtype)
    col = rng.integers(0, h, nq)
    qw = torch.zeros((nq, h))
    qw[torch.arange(nq), torch.tensor(col)] = 1.0
    got = tops.cand_rev_min(idsg, xg, Dq, qw)
    assert torch.equal(got, Dq[q, ids_at, torch.tensor(col)[:, None]].float())


# ------------------------------------------------------ candidate engines


@pytest.fixture(scope="module")
def corpus():
    return make_text_like(n_docs=40, n_classes=4, vocab=128, m=8,
                          doc_len=10, hmax=16, seed=3)[0]


def _pad(c, rows):
    """Append zero-weight pad rows (id 0), as the distributed layouts do."""
    return type(c)(ids=jnp.pad(c.ids, ((0, rows), (0, 0))),
                   w=jnp.pad(c.w, ((0, rows), (0, 0))), coords=c.coords)


#: name: (nq, b, block_q, duplicate candidate ids, pad rows)
_CASES = {
    "batched": (5, 13, 2, False, 0),
    "nq1": (1, 9, 8, False, 0),
    "duplicate_cands": (4, 12, 8, True, 0),
    "pad_rows_in_cand": (3, 10, 2, False, 8),
    "b_not_block_multiple": (3, 21, 8, False, 0),
}


def _engine(method):
    return {"rwmd": "lc_rwmd_scores_cand", "rwmd_rev":
            "lc_rwmd_scores_rev_cand", "omr": "lc_omr_scores_cand",
            "act": "lc_act_scores_cand", "ict": "lc_ict_scores_cand"}[method]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("method", CAND_METHODS)
def test_cand_engines_match_jax(corpus, method, case, precision):
    nq, b, block_q, dup, pad_rows = _CASES[case]
    c = _pad(corpus, pad_rows) if pad_rows else corpus
    n = c.ids.shape[0]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    cand = np.stack([rng.choice(n, b, replace=dup) for _ in range(nq)])
    if pad_rows:
        cand[:, :2] = [n - 1, n - 2]           # pad rows inside the sets
    qi, qw = np.asarray(corpus.ids[:nq]), np.asarray(corpus.w[:nq])
    kw = {"iters": 3} if method == "act" else {}
    jfn, tfn = getattr(jlc, _engine(method)), getattr(lc, _engine(method))
    jargs = (c, jnp.asarray(qi), jnp.asarray(qw), jnp.asarray(cand,
                                                               jnp.int32))
    want = {uk: np.asarray(jfn(*jargs, use_kernels=uk, block_q=block_q,
                               block_n=8, block_v=32, precision=precision,
                               **kw)) for uk in (False, True)}
    tc = corpus_from_numpy(c.ids, c.w, c.coords, "cpu")
    tol = F32_TOL if precision == "f32" else dict(rtol=0, atol=BF16_ATOL)
    promised = np.isclose(want[False], want[True], **tol)
    assert promised.all()        # no query here has fewer than k bins
    for uk in (False, True):
        got = tfn(tc, torch.tensor(qi), torch.tensor(qw), torch.tensor(cand),
                  use_kernels=uk, block_q=block_q, precision=precision,
                  **kw)
        assert got.shape == (nq, b) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want[uk], **tol)
        np.testing.assert_allclose(got.numpy(), want[not uk], **tol)


@pytest.mark.parametrize("method", CAND_METHODS)
def test_cand_engines_match_the_full_engines(corpus, method):
    """Scores at the candidate rows equal the full-corpus engine's at
    those rows (the compaction changes which rows, not the arithmetic)."""
    tc = corpus_from_numpy(corpus.ids, corpus.w, corpus.coords, "cpu")
    qi, qw = tc.ids[:4], tc.w[:4]
    kw = {"iters": 2} if method == "act" else {}
    full = getattr(lc, {"rwmd": "lc_rwmd_scores_batched",
                        "rwmd_rev": "lc_rwmd_scores_rev_batched",
                        "omr": "lc_omr_scores_batched",
                        "act": "lc_act_scores_batched",
                        "ict": "lc_ict_scores_batched"}[method])(
        tc, qi, qw, **kw)
    cand = torch.tensor(np.random.default_rng(1).choice(tc.n, (4, 9)))
    got = getattr(lc, _engine(method))(tc, qi, qw, cand, **kw)
    torch.testing.assert_close(got, torch.gather(full, 1, cand), **F32_TOL)


def test_ict_engine_all_remainder_query_finite(corpus):
    """An unnormalized query whose capacities absorb a quarter of each
    row's mass: the engine's two paths agree with JAX and stay finite."""
    nq = 2
    tc = corpus_from_numpy(corpus.ids, corpus.w, corpus.coords, "cpu")
    qi, qw = np.asarray(corpus.ids[:nq]), np.asarray(corpus.w[:nq]) * 0.25
    cand = np.random.default_rng(0).choice(tc.n, (nq, 6))
    want = np.asarray(jlc.lc_ict_scores_cand(corpus, jnp.asarray(qi),
                                             jnp.asarray(qw),
                                             jnp.asarray(cand, jnp.int32)))
    for uk in (False, True):
        got = lc.lc_ict_scores_cand(tc, torch.tensor(qi), torch.tensor(qw),
                                    torch.tensor(cand), use_kernels=uk)
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
        assert float(got.abs().max()) < 1e6


def test_reduce_dist_rows_chunks_do_not_change_scores(corpus, monkeypatch):
    """The row chunks of the distance-handoff reductions are a memory
    bound only: one row per chunk scores bitwise like one chunk."""
    tc = corpus_from_numpy(corpus.ids, corpus.w, corpus.coords, "cpu")
    qi, qw = tc.ids[:3], tc.w[:3]
    cand = torch.tensor(np.random.default_rng(2).choice(tc.n, (3, 7)))
    whole = [lc.lc_ict_scores_cand(tc, qi, qw, cand),
             lc.lc_rwmd_scores_rev_cand(tc, qi, qw, cand)]
    monkeypatch.setattr(lc, "GATHER_ELEMS", 1)
    rows = [lc.lc_ict_scores_cand(tc, qi, qw, cand),
            lc.lc_rwmd_scores_rev_cand(tc, qi, qw, cand)]
    for a, b in zip(whole, rows):
        assert torch.equal(a, b)


# ------------------------------------------------------- the wrappers


def _small_set(rng):
    nq, b, hmax, v, h = 2, 5, 4, 20, 6
    idsg, xg = (torch.tensor(a) for a in _cand_inputs(rng, nq, b, hmax, v))
    Z, W = (torch.tensor(a) for a in _handoff(rng, nq, v, 4, 3))
    Dq, qw = (torch.tensor(a) for a in _dist_handoff(rng, nq, v, h))
    return idsg, xg, Z, W, Dq, qw


def test_wrappers_on_cpu_run_the_plain_versions(rng):
    idsg, xg, Z, W, Dq, qw = _small_set(rng)
    W0 = W[..., 0].contiguous()
    before = (dict(cand_pour.launches), act_phase2.cand_launches)
    assert torch.equal(tops.cand_pour(idsg, xg, Z, W, 3),
                       cand_pour.cand_pour_plain(idsg, xg, Z, W, 3))
    assert torch.equal(tops.cand_omr(idsg, xg, Z, W0),
                       cand_pour.cand_omr_plain(idsg, xg, Z, W0))
    assert torch.equal(tops.cand_rev_min(idsg, xg, Dq, qw),
                       cand_pour.cand_rev_min_plain(idsg, xg, Dq, qw))
    assert torch.equal(tops.cand_ict(idsg, xg, Dq, qw),
                       cand_pour.cand_ict_plain(idsg, xg, Dq, qw))
    zg = cand_pour.gather_rows(Z, idsg).contiguous()
    wg = cand_pour.gather_rows(W, idsg).contiguous()
    assert torch.equal(tops.act_phase2_cand(xg, zg, wg),
                       act_phase2.act_phase2_cand_plain(xg, zg, wg))
    assert (dict(cand_pour.launches), act_phase2.cand_launches) == before


@pytest.mark.parametrize("case", [
    "ids_i64", "x_f64", "x_shape", "z_narrow", "w_missing", "w_given_at_0",
    "w_dtype", "z_f16", "noncontiguous", "empty", "nq_mismatch",
    "meta_device",
])
def test_cand_pour_rejects(rng, case):
    idsg, xg, Z, W, _, _ = _small_set(rng)
    iters = 3
    if case == "ids_i64":
        idsg = idsg.long()
    elif case == "x_f64":
        xg = xg.double()
    elif case == "x_shape":
        xg = xg[:, :3].contiguous()
    elif case == "z_narrow":
        Z = Z[..., :3].contiguous()
    elif case == "w_missing":
        W = None
    elif case == "w_given_at_0":
        iters = 0
    elif case == "w_dtype":
        W = W.to(torch.bfloat16)
    elif case == "z_f16":
        Z, W = Z.half(), W.half()
    elif case == "noncontiguous":
        Z = Z.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "empty":
        idsg, xg = idsg[:, :0].contiguous(), xg[:, :0].contiguous()
    elif case == "nq_mismatch":
        Z, W = Z[:1].contiguous(), W[:1].contiguous()
    elif case == "meta_device":
        idsg, xg, Z, W = (t.to("meta") for t in (idsg, xg, Z, W))
    with pytest.raises(ValueError):
        tops.cand_pour(idsg, xg, Z, W, iters)


@pytest.mark.parametrize("case", ["z_width", "w0_rank", "w0_dtype",
                                  "w0_vocab"])
def test_cand_omr_rejects(rng, case):
    idsg, xg, Z, W, _, _ = _small_set(rng)
    W0 = W[..., 0].contiguous()
    if case == "z_width":
        Z = Z[..., :1].contiguous()
    elif case == "w0_rank":
        W0 = W
    elif case == "w0_dtype":
        W0 = W0.to(torch.bfloat16)
    elif case == "w0_vocab":
        W0 = W0[:, :7].contiguous()
    with pytest.raises(ValueError):
        tops.cand_omr(idsg, xg, Z, W0)


@pytest.mark.parametrize("op", ["rev_min", "ict"])
@pytest.mark.parametrize("case", ["dq_rank", "qw_shape", "qw_bf16",
                                  "h_too_wide", "noncontiguous", "mixed"])
def test_cand_dist_rejects(rng, op, case):
    idsg, xg, _, _, Dq, qw = _small_set(rng)
    if case == "dq_rank":
        Dq = Dq[..., 0].contiguous()
    elif case == "qw_shape":
        qw = qw[:, :3].contiguous()
    elif case == "qw_bf16":
        qw = qw.to(torch.bfloat16)
    elif case == "h_too_wide":
        Dq = torch.zeros(Dq.shape[:2] + (cand_pour.MAX_H + 1,))
        qw = torch.zeros((Dq.shape[0], cand_pour.MAX_H + 1))
    elif case == "noncontiguous":
        qw = torch.tensor(np.asfortranarray(qw.numpy()))
        assert not qw.is_contiguous()
    elif case == "mixed":
        qw = qw.to("meta")
    fn = tops.cand_rev_min if op == "rev_min" else tops.cand_ict
    with pytest.raises(ValueError):
        fn(idsg, xg, Dq, qw)


@pytest.mark.parametrize("case", ["iters_zero", "zg_depth", "dtype_mix",
                                  "x_shape"])
def test_act_phase2_cand_rejects(rng, case):
    idsg, xg, Z, W, _, _ = _small_set(rng)
    zg = cand_pour.gather_rows(Z, idsg).contiguous()
    wg = cand_pour.gather_rows(W, idsg).contiguous()
    if case == "iters_zero":
        zg, wg = zg[..., :1].contiguous(), wg[..., :0].contiguous()
    elif case == "zg_depth":
        zg = zg[..., :3].contiguous()
    elif case == "dtype_mix":
        wg = wg.to(torch.bfloat16)
    elif case == "x_shape":
        xg = xg[:1].contiguous()
    with pytest.raises(ValueError):
        tops.act_phase2_cand(xg, zg, wg)


# ------------------------------------------------------- on a CUDA card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,b,hmax,v,h", [(1, 9, 7, 37, 6),
                                           (3, 70, 40, 300, 33),
                                           (2, 300, 500, 2000, 500)])
def test_cand_kernels_cuda_match_plain(rng, cuda, nq, b, hmax, v, h, dtype):
    idsg, xg = (torch.tensor(a, device=cuda)
                for a in _cand_inputs(rng, nq, b, hmax, v))
    Z, W = (torch.tensor(a, device=cuda).to(dtype)
            for a in _handoff(rng, nq, v, 4, 3))
    Dq, qw = (torch.tensor(a, device=cuda)
              for a in _dist_handoff(rng, nq, v, h, ties=True))
    Dq = Dq.to(dtype)
    W0 = W[..., 0].contiguous()
    zg = cand_pour.gather_rows(Z, idsg).contiguous()
    wg = cand_pour.gather_rows(W, idsg).contiguous()
    before = dict(cand_pour.launches)
    pairs = [
        (tops.cand_pour(idsg, xg, Z[..., :1].contiguous(), None, 0),
         cand_pour.cand_pour_plain(idsg, xg, Z[..., :1], None, 0)),
        (tops.cand_pour(idsg, xg, Z, W, 3),
         cand_pour.cand_pour_plain(idsg, xg, Z, W, 3)),
        (tops.cand_omr(idsg, xg, Z, W0),
         cand_pour.cand_omr_plain(idsg, xg, Z, W0)),
        (tops.cand_rev_min(idsg, xg, Dq, qw),
         cand_pour.cand_rev_min_plain(idsg, xg, Dq, qw)),
        (tops.cand_ict(idsg, xg, Dq, qw),
         cand_pour.cand_ict_plain(idsg, xg, Dq, qw)),
        (tops.act_phase2_cand(xg, zg, wg),
         act_phase2.act_phase2_cand_plain(xg, zg, wg)),
    ]
    torch.cuda.synchronize()
    assert cand_pour.launches == {k: before[k] + n for k, n in
                                  dict(pour=1, pour0=1, omr=1, rev_min=1,
                                       ict=1).items()}
    for got, want in pairs:
        torch.testing.assert_close(got, want, **F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_probes_are_bitwise_on_the_card(rng, cuda, dtype):
    nq, b, hmax, v, h = 3, 200, 50, 500, 40
    idsg, xg, slot = (t.to(cuda) for t in _probe(rng, nq, b, hmax, v))
    ids_at = torch.gather(idsg, 2, slot[..., None])[..., 0].long()
    q = torch.arange(nq, device=cuda)[:, None]
    Z = torch.rand((nq, v, 1), device=cuda).to(dtype)
    assert torch.equal(tops.cand_pour(idsg, xg, Z, None, 0),
                       Z[q, ids_at, 0].float())
    Dq = torch.rand((nq, v, h), device=cuda).to(dtype)
    col = torch.tensor(rng.integers(0, h, nq), device=cuda)
    qw = torch.zeros((nq, h), device=cuda)
    qw[torch.arange(nq, device=cuda), col] = 1.0
    assert torch.equal(tops.cand_rev_min(idsg, xg, Dq, qw),
                       Dq[q, ids_at, col[:, None]].float())
