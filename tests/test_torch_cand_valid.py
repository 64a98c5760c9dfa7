"""K4 on the valid-bin distance handoff: ``lc.phase1_valid_dist`` and the
``cand_dist`` kernel's valid-bin entry (``ops.cand_rev_min_valid`` /
``ops.cand_ict_valid``), which the ``rwmd_rev`` and ``ict`` candidate
engines take under ``use_kernels``.

* The handoff against JAX's ``phase1_stacked_dist`` read at the valid
  bins, under f32 and bf16, on both sides of the dedup gate.
* The valid-bin entry against the stacked entry (``cand_rev_min_plain`` /
  ``cand_ict_plain``) on the same costs scattered back into (nq, v, h),
  with the sentinel and weight 0 at the invalid bins: prefix and
  non-prefix masks, tied costs, an empty query, an all-empty batch,
  candidate sets with duplicates and pad rows.
* The engines: on the valid route under ``use_kernels`` (the stacked
  handoff is never built) and against JAX's engines, also with an empty
  query.
* The all-rows form (cand None, every corpus row: the full-corpus
  ``rwmd_rev`` and ``ict`` engines) against the candidate form at every
  row, bitwise.
* The wrapper's rejects; on a CUDA card only, the kernel against its plain
  version and against the stacked kernel on the same costs, and its
  all-rows form against its plain version and its candidate form.
* ``pairwise_dist``, which now runs its passes in place, against the
  expanded formula, bitwise.

Tolerances. The handoff: f32 rtol 1e-5 / atol 1e-6 (JAX and the port run
the matmul over different column counts), bf16 the 8e-3 absolute band of
``tests/test_cand_kernels.py``. The valid-bin entry against the stacked
one: within rtol 1e-5 / atol 1e-6, not bitwise. Per entry both compute the
same values (the padded bins add exactly 0), but the sums over the query
bins run over len_q values on one side and over h on the other, and torch
(and the kernels' lane split) may add them in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lc as jlc
from repro.data.synth import make_text_like
from repro_torch.api import corpus_from_numpy
from repro_torch.core import geometry, lc
from repro_torch.core.precision import pad_dist_for
from repro_torch.kernels import cand_pour
from repro_torch.kernels import ops as tops

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_ATOL = 8e-3
MODES = ("rev_min", "ict")
_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _valid_cols(q_w):
    return np.flatnonzero(np.asarray(q_w).reshape(-1) > 0)


# ------------------------------------------------------------ the handoff


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("nq,h,v", [(5, 12, 64), (12, 16, 20)],
                         ids=["no_dedup", "dedup"])
def test_phase1_valid_dist_matches_jax(rng, nq, h, v, precision):
    coords = rng.normal(size=(v, 6)).astype(np.float32)
    q_ids = rng.integers(0, v, size=(nq, h)).astype(np.int32)
    q_w = (rng.uniform(size=(nq, h)) * (rng.uniform(size=(nq, h)) > 0.3)
           ).astype(np.float32)
    q_w[1] = 0.0                                  # an empty query
    q_w[2, : h // 2] = 0.0                        # valid bins not a prefix
    cols = _valid_cols(q_w)
    P = cols.size
    assert (P >= lc.DEDUP_STACK_RATIO * v) == (v == 20)
    Dv, qoff, qwv = lc.phase1_valid_dist(torch.tensor(coords),
                                         torch.tensor(q_ids),
                                         torch.tensor(q_w), precision)
    D = jlc.phase1_stacked_dist(jnp.asarray(coords), jnp.asarray(q_ids),
                                jnp.asarray(q_w), precision=precision)
    want = np.asarray(D, np.float32).reshape(v, nq * h)[:, cols]
    assert Dv.shape == (v, P) and Dv.dtype == _DTYPES[precision]
    assert Dv.stride(1) == 1 and Dv.stride(0) % 4 == 0
    if precision == "f32":
        np.testing.assert_allclose(Dv.numpy(), want, **F32_TOL)
    else:
        np.testing.assert_allclose(Dv.float().numpy(), want, rtol=0,
                                   atol=BF16_ATOL)
    counts = (q_w > 0).sum(axis=1)
    np.testing.assert_array_equal(qoff.numpy(),
                                  np.concatenate([[0], np.cumsum(counts)]))
    assert qoff.dtype == torch.int32
    np.testing.assert_array_equal(qwv.numpy(), q_w.reshape(-1)[cols])


def test_phase1_valid_dist_all_empty_batch(rng):
    coords = torch.tensor(rng.normal(size=(9, 3)).astype(np.float32))
    q_ids = torch.zeros((3, 5), dtype=torch.int32)
    Dv, qoff, qwv = lc.phase1_valid_dist(coords, q_ids, torch.zeros((3, 5)))
    assert Dv.shape == (9, 0) and qwv.shape == (0,)
    assert qoff.tolist() == [0, 0, 0, 0]


# -------------------------------------------- valid entry vs stacked entry


def _masks(rng, case, nq, h):
    """Query weights (nq, h) of one mask case."""
    qw = rng.uniform(0.1, 1.0, size=(nq, h))
    if case == "prefix":
        keep = np.arange(h)[None, :] < rng.integers(1, h + 1, (nq, 1))
    elif case == "all_empty":
        keep = np.zeros((nq, h), bool)
    elif case == "long":        # 3 bins, then queries of h bins unaligned
        keep = np.ones((nq, h), bool)
        keep[0, 3:] = False
    else:
        keep = rng.uniform(size=(nq, h)) > 0.4
        keep[:, 0] = True
        if case == "empty_query":
            keep[1] = False
    qw = np.where(keep, qw, 0.0)
    qw /= np.maximum(qw.sum(axis=1, keepdims=True), 1e-30)
    return qw.astype(np.float32)


def _store(dv, dtype, device="cpu"):
    """Dv (v, P) in ``dtype`` at a row stride padded to a multiple of 4,
    as phase1_valid_dist lays it out (``Tensor.to`` would drop the
    padding)."""
    v, P = dv.shape
    full = torch.zeros((v, P + (-P % 4)), dtype=dtype, device=device)
    full[:, :P] = torch.tensor(dv).to(dtype)
    return full[:, :P]


def _case(rng, case, dtype, nq=4, h=9, v=40, n=15, hmax=6, b=11,
          device="cpu"):
    """A corpus with zero slots and pad rows, candidates with duplicates
    and pad rows, a valid-bin handoff and its stacked twin, on
    ``device``."""
    ids = rng.integers(0, v, (n, hmax)).astype(np.int32)
    w = rng.uniform(size=(n, hmax)) * (rng.uniform(size=(n, hmax)) > 0.3)
    w[-2:] = 0.0                                   # pad rows
    w = (w / np.maximum(w.sum(axis=1, keepdims=True), 1e-30)).astype(
        np.float32)
    cand = rng.integers(0, n, (nq, b))
    cand[:, :3] = [n - 1, n - 2, cand[0, 3]]        # pad rows, a duplicate
    cand[:, 4] = cand[:, 3]
    qw = _masks(rng, case, nq, h)
    cols = _valid_cols(qw)
    dv = rng.uniform(0.2, 2.0, size=(v, cols.size))
    if case == "ties":
        dv = dv.round(1)
    dv = _store(dv.astype(np.float32), dtype, device)
    qoff = torch.tensor(np.concatenate([[0], np.cumsum((qw > 0).sum(1))]),
                        dtype=torch.int32, device=device)
    qwv = torch.tensor(qw.reshape(-1)[cols], device=device)
    dq = torch.full((v, nq * h), pad_dist_for(dtype), dtype=dtype,
                    device=device)
    dq[:, torch.tensor(cols, device=device)] = dv
    dq = dq.view(v, nq, h).movedim(1, 0).contiguous()
    ids_t, w_t, cand_t = (torch.tensor(a, device=device)
                          for a in (ids, w, cand))
    return ((ids_t, w_t, cand_t, dv, qoff, qwv),
            (ids_t[cand_t], w_t[cand_t], dq, torch.tensor(qw, device=device)))


_VALID = {"rev_min": (tops.cand_rev_min_valid,
                      cand_pour.cand_rev_min_valid_plain),
          "ict": (tops.cand_ict_valid, cand_pour.cand_ict_valid_plain)}
_STACKED = {"rev_min": cand_pour.cand_rev_min_plain,
            "ict": cand_pour.cand_ict_plain}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["prefix", "non_prefix", "ties",
                                  "empty_query", "all_empty"])
@pytest.mark.parametrize("mode", MODES)
def test_valid_entry_matches_the_stacked_entry(rng, mode, case, dtype):
    valid_args, stacked_args = _case(rng, case, _DTYPES[dtype])
    op, plain = _VALID[mode]
    before = dict(cand_pour.valid_launches)
    got = op(*valid_args)
    assert cand_pour.valid_launches == before      # CPU: no launch
    assert torch.equal(got, plain(*valid_args))
    want = _STACKED[mode](*stacked_args)
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, **F32_TOL)
    qoff = valid_args[4]
    empty = (qoff[1:] == qoff[:-1]).nonzero()[:, 0]
    assert (got[empty] == 0).all()                 # an empty query scores 0
    if case == "empty_query":
        assert empty.tolist() == [1]
    if mode == "rev_min":          # a pad row has no entry: sum big * qw
        full = (qoff[1:] > qoff[:-1])[:, None]
        assert bool(((got[:, :2] > 1e29) == full).all())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["prefix", "non_prefix", "ties",
                                  "empty_query", "all_empty"])
@pytest.mark.parametrize("mode", MODES)
def test_all_rows_form_is_the_candidate_form_at_every_row(rng, mode, case,
                                                          dtype):
    (ids, w, cand, dv, qoff, qwv), _ = _case(rng, case, _DTYPES[dtype])
    every = torch.arange(ids.shape[0]).expand(cand.shape[0], -1).contiguous()
    op, plain = _VALID[mode]
    got = op(ids, w, None, dv, qoff, qwv)
    assert got.shape == (cand.shape[0], ids.shape[0])
    assert torch.equal(got, plain(ids, w, None, dv, qoff, qwv))
    assert torch.equal(got, op(ids, w, every, dv, qoff, qwv))


def test_valid_entry_ict_remainder_goes_to_the_max_cost():
    """One query of capacity 0.25 < x = 1: the 0.75 remainder is dumped at
    the max cost of the entry's valid bins (1.0)."""
    ids = torch.zeros((1, 1), dtype=torch.int32)
    w = torch.ones((1, 1))
    dv = _store(np.array([[1.0, 0.5]], np.float32), torch.float32)
    qoff = torch.tensor([0, 2], dtype=torch.int32)
    qwv = torch.tensor([0.125, 0.125])
    got = tops.cand_ict_valid(ids, w, torch.zeros((1, 1), dtype=torch.int64),
                              dv, qoff, qwv)
    np.testing.assert_allclose(got.numpy(), [[0.125 * 0.5 + 0.125 + 0.75]],
                               rtol=1e-6)


def test_max_len_fits_the_lanes_at_every_alignment():
    """The kernel's 32 lanes hold 8 aligned quads each: a query of
    MAX_LEN columns must touch at most 256 quads wherever it starts."""
    for lo in range(4):
        last = lo + cand_pour.MAX_LEN - 1
        assert last // 4 - lo // 4 + 1 <= 32 * 8


# ------------------------------------------------------------ the engines


@pytest.fixture(scope="module")
def jcorpus():
    return make_text_like(n_docs=40, n_classes=4, vocab=128, m=8,
                          doc_len=10, hmax=16, seed=3)[0]


_ENGINES = {"rev_min": "lc_rwmd_scores_rev_cand",
            "ict": "lc_ict_scores_cand"}


@pytest.mark.parametrize("mode", MODES)
def test_engines_take_the_valid_route(jcorpus, mode, monkeypatch):
    """Under use_kernels the engine builds no stacked handoff and calls
    the valid-bin entry once for the batch; its scores are the stacked
    path's."""
    tc = corpus_from_numpy(jcorpus.ids, jcorpus.w, jcorpus.coords, "cpu")
    qi, qw = tc.ids[:5], tc.w[:5]
    cand = torch.tensor(np.random.default_rng(4).choice(tc.n, (5, 12)),
                        dtype=torch.int32)
    engine = getattr(lc, _ENGINES[mode])
    want = engine(tc, qi, qw, cand, use_kernels=False, block_q=2)
    calls = []
    entry = getattr(tops, f"cand_{mode}_valid")
    monkeypatch.setattr(tops, f"cand_{mode}_valid",
                        lambda *a, **k: calls.append(a) or entry(*a, **k))

    def stacked(*a, **k):
        raise AssertionError("the stacked handoff was built")
    monkeypatch.setattr(lc, "phase1_stacked_dist", stacked)
    got = engine(tc, qi, qw, cand, use_kernels=True, block_q=2)
    assert len(calls) == 1
    torch.testing.assert_close(got, want, **F32_TOL)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
def test_engines_with_an_empty_query_match_jax(jcorpus, mode, precision):
    nq = 4
    qi = np.asarray(jcorpus.ids[:nq])
    qw = np.asarray(jcorpus.w[:nq]).copy()
    qw[2] = 0.0
    cand = np.random.default_rng(5).choice(jcorpus.ids.shape[0], (nq, 9))
    jfn = getattr(jlc, _ENGINES[mode])
    want = np.asarray(jfn(jcorpus, jnp.asarray(qi), jnp.asarray(qw),
                          jnp.asarray(cand, jnp.int32),
                          precision=precision))
    tc = corpus_from_numpy(jcorpus.ids, jcorpus.w, jcorpus.coords, "cpu")
    got = getattr(lc, _ENGINES[mode])(tc, torch.tensor(qi), torch.tensor(qw),
                                      torch.tensor(cand), use_kernels=True,
                                      precision=precision)
    tol = F32_TOL if precision == "f32" else dict(rtol=0, atol=BF16_ATOL)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    assert (got[2] == 0).all()


# ------------------------------------------------------------ the wrapper


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", [
    "ids_i64", "w_shape", "cand_i32", "cand_range", "cand_negative",
    "cand_empty", "cand_noncontiguous", "dv_rank", "dv_f16", "dv_stride",
    "qoff_i64", "qoff_shape", "qoff_not_to_p", "qwv_shape", "too_long",
    "mixed"])
def test_cand_dist_valid_rejects(rng, mode, case):
    ids, w, cand, dv, qoff, qwv = _case(rng, "non_prefix",
                                        torch.float32)[0]
    if case == "ids_i64":
        ids = ids.long()
    elif case == "w_shape":
        w = w[:, :3].contiguous()
    elif case == "cand_i32":
        cand = cand.int()
    elif case == "cand_range":
        cand[0, 0] = ids.shape[0]
    elif case == "cand_negative":
        cand[1, 1] = -1
    elif case == "cand_empty":
        cand = cand[:, :0]
    elif case == "cand_noncontiguous":
        cand = cand.T.contiguous().T
    elif case == "dv_rank":
        dv = dv[None]
    elif case == "dv_f16":
        dv = _store(dv.numpy(), torch.float16)
    elif case == "dv_stride":
        extra = 1 if (dv.shape[1] + 1) % 4 else 2
        dv = torch.cat([dv, dv[:, :extra]], dim=1)[:, :-extra]
        assert dv.stride(0) % 4
    elif case == "qoff_i64":
        qoff = qoff.long()
    elif case == "qoff_shape":
        qoff = qoff[:-1].contiguous()
    elif case == "qoff_not_to_p":
        qoff[-1] -= 1
    elif case == "qwv_shape":
        qwv = qwv[:-1].contiguous()
    elif case == "too_long":
        P = cand_pour.MAX_LEN + 1
        dv = _store(np.ones((dv.shape[0], P), np.float32), torch.float32)
        qoff = torch.tensor([0] + [P] * cand.shape[0], dtype=torch.int32)
        qwv = torch.full((P,), 1.0 / P)
    elif case == "mixed":
        qwv = qwv.to("meta")
    fn = _VALID[mode][0]
    with pytest.raises(ValueError):
        fn(ids, w, cand, dv, qoff, qwv)


# ------------------------------------------------------- on a CUDA card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case,nq,h,v,n,hmax,b", [
    ("non_prefix", 4, 9, 40, 15, 6, 11),
    ("empty_query", 5, 40, 300, 60, 40, 70),
    ("ties", 3, 140, 500, 50, 100, 200),
    ("prefix", 2, 500, 2000, 40, 500, 300),
    ("all_empty", 3, 8, 20, 10, 5, 7),
    ("long", 2, cand_pour.MAX_LEN, 1500, 30, 200, 50),
])
def test_cand_dist_valid_cuda_matches_plain(rng, cuda, case, nq, h, v, n,
                                            hmax, b, dtype):
    valid_args, (ids_g, w_g, dq, qw) = _case(
        rng, case, _DTYPES[dtype], nq=nq, h=h, v=v, n=n, hmax=hmax, b=b,
        device=cuda)
    for mode in MODES:
        op, plain = _VALID[mode]
        before = dict(cand_pour.valid_launches)
        got = op(*valid_args)
        torch.cuda.synchronize()
        assert cand_pour.valid_launches[mode] == before[mode] + 1
        torch.testing.assert_close(got, plain(*valid_args), **F32_TOL)
        stacked = (tops.cand_rev_min if mode == "rev_min"
                   else tops.cand_ict)(ids_g, w_g, dq, qw)
        torch.testing.assert_close(got, stacked, **F32_TOL)


def test_pairwise_dist_in_place_is_the_expanded_formula(rng):
    """``pairwise_dist`` runs its passes in place; each value stays
    bitwise sqrt(snap(clamp(a2 + b2 - 2 a.b, 0))), exact zeros included."""
    a = torch.tensor(rng.normal(size=(300, 17)).astype(np.float32))
    b = torch.cat([torch.tensor(rng.normal(size=(40, 17)).astype(
        np.float32)), a[:5]])
    for snap in (geometry.ZERO_SNAP, 0.0):
        a2 = torch.sum(a * a, dim=-1, keepdim=True)
        b2 = torch.sum(b * b, dim=-1, keepdim=True).T
        d2 = torch.clamp_min(a2 + b2 - 2.0 * (a @ b.T), 0.0)
        if snap:
            d2 = torch.where(d2 < snap * snap * (a2 + b2), 0.0, d2)
        got = geometry.pairwise_dist(a, b, snap)
        assert torch.equal(got, torch.sqrt(d2))
    assert int((geometry.pairwise_dist(a, b) == 0).sum()) == 5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case,nq,h,v,n,hmax", [
    ("non_prefix", 4, 9, 40, 15, 6),
    ("empty_query", 5, 40, 300, 60, 40),
    ("prefix", 2, 500, 2000, 40, 500),
    ("long", 3, 784, 784, 30, 784),               # dense MNIST-shaped rows
    ("non_prefix", 64, 20, 784, 300, 70),         # many queries, many rows
])
def test_cand_dist_valid_all_rows_cuda_matches_plain(rng, cuda, case, nq, h,
                                                     v, n, hmax, dtype):
    (ids, w, _, dv, qoff, qwv), _ = _case(
        rng, case, _DTYPES[dtype], nq=nq, h=h, v=v, n=n, hmax=hmax, b=8,
        device=cuda)
    every = torch.arange(n, device=cuda).expand(nq, n).contiguous()
    for mode in MODES:
        op, plain = _VALID[mode]
        before = dict(cand_pour.valid_launches)
        got = op(ids, w, None, dv, qoff, qwv)
        torch.cuda.synchronize()
        assert cand_pour.valid_launches[f"all_{mode}"] == \
            before[f"all_{mode}"] + 1
        assert cand_pour.valid_launches[mode] == before[mode]
        assert got.shape == (nq, n)
        torch.testing.assert_close(got, plain(ids, w, None, dv, qoff, qwv),
                                   **F32_TOL)
        assert torch.equal(got, op(ids, w, every, dv, qoff, qwv))
