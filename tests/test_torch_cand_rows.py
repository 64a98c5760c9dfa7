"""K3 reading the corpus rows itself: ``ops.cand_pour_rows`` /
``ops.cand_omr_rows`` (candidate form, cand (nq, b); all-rows form,
cand None), which the LC-RWMD dump, LC-OMR and the candidate engines of
rwmd, act and omr take under ``use_kernels``.

* The candidate form's plain version against JAX ``repro.kernels.ops.
  cand_pour`` / ``cand_omr`` (the Pallas kernel, in interpret mode here) on
  ``ids[cand]``, ``w[cand]``: iters 0, 1 and 3 and omr, f32 and bf16
  ladders, with duplicate candidate rows, rows whose weights are all zero
  and a query with no valid bins (its ladders at the pad sentinel).
* The all-rows form against JAX's full-corpus reductions and engines
  (``lc.pour_blocked`` at iters=0, ``lc.omr_reduce_blocked``,
  ``lc.lc_rwmd_scores_batched`` and ``lc.lc_omr_scores_batched`` with
  ``use_kernels=True``).
* The three candidate engines (rwmd, act, omr) with ``use_kernels=True``:
  one call of the new entry per batch, no call of the old one, and the
  JAX engines' scores.
* The new entry against the old ``ops.cand_pour`` / ``ops.cand_omr`` on
  the same rows; the wrapper's rejects and its once-per-corpus id check;
  on a CUDA card only, the kernel against its plain version and the old
  kernel.

Tolerance: rtol 1e-5 / atol 1e-6 throughout, under bf16 ladders too: both
sides read the same bf16 values into float32 and do float32 arithmetic,
summed in another order. Where a test compares whole engines it hands both
packages the same Phase-1 ladders, or compares in f32, so that the two
Phase 1 implementations' bf16 rounding does not enter.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lc as jlc
from repro.data.synth import make_text_like
from repro.kernels import ops as jops
from repro_torch.api import corpus_from_numpy
from repro_torch.core import lc
from repro_torch.core.precision import pad_dist_for
from repro_torch.kernels import cand_pour
from repro_torch.kernels import ops as tops

F32_TOL = dict(rtol=1e-5, atol=1e-6)
_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
#: mode name -> iters (None: omr)
MODES = {"pour0": 0, "pour1": 1, "pour3": 3, "omr": None}
#: the modes of the all-rows form
ALL_ROWS_MODES = ("pour0", "omr")


def _corpus(rng, n, hmax, v):
    """A corpus with zero slots, two all-zero rows and a full row."""
    ids = rng.integers(0, v, (n, hmax)).astype(np.int32)
    w = rng.uniform(size=(n, hmax)) * (rng.uniform(size=(n, hmax)) > 0.3)
    w[1] = 0.0
    w[-1] = 0.0
    w[2] = rng.uniform(0.1, 1.0, hmax)
    w = (w / np.maximum(w.sum(axis=1, keepdims=True), 1e-30)).astype(
        np.float32)
    return ids, w


def _cands(rng, nq, b, n):
    """Candidate rows with duplicates and the all-zero rows."""
    cand = rng.integers(0, n, (nq, b))
    cand[:, 0] = 1
    cand[:, 1] = n - 1
    cand[:, 3] = cand[:, 2]
    return cand.astype(np.int64)


def _ladders(rng, nq, v, mode, dtype, empty_query=True):
    """Z (nq, v, k) ascending costs with exact zeros, W (nq, v, kw)
    capacities, rounded to ``dtype``; query 1 has no valid bins: every
    cost is the pad sentinel and every capacity 0."""
    iters = MODES[mode]
    k = 2 if iters is None else iters + 1
    Z = np.sort(rng.uniform(size=(nq, v, k)), axis=-1)
    Z[:, ::5, 0] = 0.0                    # overlaps (omr's first branch)
    W = rng.uniform(size=(nq, v, max(k - 1, 1))) * 0.3
    if empty_query:
        Z[1] = pad_dist_for(_DTYPES[dtype])
        W[1] = 0.0
    Z = torch.tensor(Z, dtype=torch.float32).to(_DTYPES[dtype])
    W = torch.tensor(W, dtype=torch.float32).to(_DTYPES[dtype])
    return Z, W


def _jax(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def _new(ids, w, cand, Z, W, mode):
    iters = MODES[mode]
    if iters is None:
        return tops.cand_omr_rows(ids, w, cand, Z, W[..., 0].contiguous())
    return tops.cand_pour_rows(ids, w, cand, Z, W if iters else None, iters)


def _old(idsg, xg, Z, W, mode):
    iters = MODES[mode]
    if iters is None:
        return tops.cand_omr(idsg, xg, Z, W[..., 0].contiguous())
    return tops.cand_pour(idsg, xg, Z, W if iters else None, iters)


# ----------------------------------------- the plain version vs the Pallas


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("nq,b,n,hmax,v", [(3, 11, 17, 7, 37),
                                           (2, 9, 12, 20, 64)])
def test_cand_form_plain_matches_pallas(rng, nq, b, n, hmax, v, mode, dtype):
    ids, w = _corpus(rng, n, hmax, v)
    cand = _cands(rng, nq, b, n)
    Z, W = _ladders(rng, nq, v, mode, dtype)
    iters = MODES[mode]
    args = (jnp.asarray(ids[cand]), jnp.asarray(w[cand]), _jax(Z))
    if iters is None:
        want = jops.cand_omr(*args, _jax(W[..., 0]), block_n=8, block_v=16)
    else:
        want = jops.cand_pour(*args, _jax(W) if iters else None, iters,
                              block_n=8, block_v=16)
    ids_t, w_t, cand_t = (torch.tensor(a) for a in (ids, w, cand))
    before = dict(cand_pour.rows_launches)
    got = _new(ids_t, w_t, cand_t, Z, W, mode)
    assert cand_pour.rows_launches == before            # CPU: no launch
    assert got.shape == (nq, b) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    assert (got[:, 0] == 0).all() and (got[:, 1] == 0).all()  # zero rows
    assert torch.equal(got[:, 2], got[:, 3])                  # duplicates
    assert float(got[1].max()) > 1e20     # the empty query: sentinel scale


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_new_entry_matches_the_old_entry(rng, mode, dtype):
    """The corpus-row entry on (ids, w, cand) against the old K3 entry on
    the pre-gathered ``ids[cand]``, ``w[cand]``; the all-rows form (pour0
    and omr) against the old entry on every row."""
    nq, b, n, hmax, v = 4, 13, 21, 9, 50
    ids, w, cand = (torch.tensor(a) for a in (*_corpus(rng, n, hmax, v),
                                              _cands(rng, nq, b, n)))
    Z, W = _ladders(rng, nq, v, mode, dtype)
    torch.testing.assert_close(_new(ids, w, cand, Z, W, mode),
                               _old(ids[cand], w[cand], Z, W, mode),
                               **F32_TOL)
    if mode not in ALL_ROWS_MODES:
        return
    every = torch.arange(n).expand(nq, n)
    torch.testing.assert_close(_new(ids, w, None, Z, W, mode),
                               _old(ids[every], w[every], Z, W, mode),
                               **F32_TOL)


def test_plain_blocks_do_not_change_scores(rng, monkeypatch):
    """The plain version's row chunks are a memory bound only."""
    ids, w = (torch.tensor(a) for a in _corpus(rng, 30, 8, 40))
    cand = torch.tensor(_cands(rng, 3, 10, 30))
    Z, W = _ladders(rng, 3, 40, "pour3", "f32")
    whole = [cand_pour.cand_pour_rows_plain(ids, w, c, Z, W, 3)
             for c in (cand, None)]
    monkeypatch.setattr(lc, "GATHER_ELEMS", 1)
    for c, want in zip((cand, None), whole):
        assert torch.equal(cand_pour.cand_pour_rows_plain(ids, w, c, Z, W, 3),
                           want)


# ------------------------------------------- the all-rows form vs JAX


@pytest.fixture(scope="module")
def jcorpus():
    return make_text_like(n_docs=40, n_classes=4, vocab=128, m=8,
                          doc_len=10, hmax=16, seed=3)[0]


@pytest.fixture(scope="module")
def tcorpus(jcorpus):
    return corpus_from_numpy(jcorpus.ids, jcorpus.w, jcorpus.coords, "cpu")


def _queries(jcorpus, nq=5):
    return np.asarray(jcorpus.ids[:nq]), np.asarray(jcorpus.w[:nq])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("method", ["rwmd", "omr"])
def test_all_rows_reductions_match_jax(jcorpus, tcorpus, method, precision):
    """The full-corpus reductions under ``use_kernels`` (the all-rows form)
    against JAX's on the same Phase-1 ladders (JAX's, in the storage
    dtype)."""
    qi, qw = _queries(jcorpus)
    k = 1 if method == "rwmd" else 2
    Zj, Wj = jlc.phase1_batched(jcorpus.coords, jnp.asarray(qi),
                                jnp.asarray(qw), k, precision=precision)
    Z = torch.tensor(np.asarray(Zj, np.float32)).to(_DTYPES[precision])
    W = torch.tensor(np.asarray(Wj, np.float32)).to(_DTYPES[precision])
    if method == "rwmd":
        want = jlc.pour_blocked(jcorpus, Zj, Wj, 0, block_q=2)
        got = lc.pour_blocked(tcorpus, Z, W, 0, block_q=2, use_kernels=True)
    else:
        want = jlc.omr_reduce_blocked(jcorpus, Zj, Wj[..., 0], 2)
        got = lc.omr_reduce_blocked(tcorpus, Z, W[..., 0], 2,
                                    use_kernels=True)
    assert got.shape == (5, tcorpus.n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("method", ["rwmd", "omr"])
def test_all_rows_engines_match_jax(jcorpus, tcorpus, method, monkeypatch):
    """``lc_rwmd_scores_batched`` / ``lc_omr_scores_batched`` with
    ``use_kernels=True`` against JAX's (Pallas K1 in interpret mode): the
    reduction is one call of the all-rows form."""
    qi, qw = _queries(jcorpus)
    name = f"lc_{method}_scores_batched"
    want = getattr(jlc, name)(jcorpus, jnp.asarray(qi), jnp.asarray(qw),
                              use_kernels=True, block_q=2)
    entry = "cand_pour_rows" if method == "rwmd" else "cand_omr_rows"
    calls = []
    real = getattr(tops, entry)
    monkeypatch.setattr(tops, entry,
                        lambda *a, **k: calls.append(a[2]) or real(*a, **k))
    got = getattr(lc, name)(tcorpus, torch.tensor(qi), torch.tensor(qw),
                            use_kernels=True, block_q=2)
    assert calls == [None]                 # one all-rows call for the batch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# ------------------------------------------- the candidate engines


_ENGINES = {"rwmd": ("lc_rwmd_scores_cand", {}, "cand_pour_rows"),
            "act": ("lc_act_scores_cand", {"iters": 3}, "cand_pour_rows"),
            "omr": ("lc_omr_scores_cand", {}, "cand_omr_rows")}


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("method", sorted(_ENGINES))
def test_cand_engines_take_the_row_entry(jcorpus, tcorpus, method, precision,
                                         monkeypatch):
    """Under use_kernels a candidate engine calls the corpus-row entry once
    for the batch, whatever block_q, gathers no candidate rows and never
    calls the old entry; its scores are JAX's kernel engine's on the same
    Phase-1 ladders (f32) and its own reference path's (both dtypes)."""
    name, kw, entry = _ENGINES[method]
    nq = 5
    qi, qw = _queries(jcorpus, nq)
    cand = _cands(np.random.default_rng(7), nq, 12, tcorpus.n)
    want_ref = getattr(lc, name)(tcorpus, torch.tensor(qi), torch.tensor(qw),
                                 torch.tensor(cand), block_q=2,
                                 precision=precision, **kw)
    calls = []
    real = getattr(tops, entry)
    monkeypatch.setattr(tops, entry,
                        lambda *a, **k: calls.append(a[2].shape)
                        or real(*a, **k))

    def old(*a, **k):
        raise AssertionError("the old K3 entry was called")
    monkeypatch.setattr(tops, "cand_pour", old)
    monkeypatch.setattr(tops, "cand_omr", old)
    got = getattr(lc, name)(tcorpus, torch.tensor(qi), torch.tensor(qw),
                            torch.tensor(cand, dtype=torch.int32), block_q=2,
                            use_kernels=True, precision=precision, **kw)
    assert calls == [(nq, 12)]
    torch.testing.assert_close(got, want_ref, **F32_TOL)
    if precision == "f32":
        want = getattr(jlc, name)(jcorpus, jnp.asarray(qi), jnp.asarray(qw),
                                  jnp.asarray(cand, jnp.int32),
                                  use_kernels=True, block_q=2, block_n=8,
                                  block_v=32, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("method", sorted(_ENGINES))
def test_cand_reductions_match_jax_on_shared_ladders(jcorpus, tcorpus,
                                                     method, precision):
    """The candidate reductions under ``use_kernels`` against JAX's kernel
    reductions on the same Phase-1 ladders, in both storage dtypes."""
    nq = 4
    qi, qw = _queries(jcorpus, nq)
    cand = _cands(np.random.default_rng(8), nq, 10, tcorpus.n)
    k = {"rwmd": 1, "act": 4, "omr": 2}[method]
    Zj, Wj = jlc.phase1_batched(jcorpus.coords, jnp.asarray(qi),
                                jnp.asarray(qw), k, precision=precision)
    Z = torch.tensor(np.asarray(Zj, np.float32)).to(_DTYPES[precision])
    W = torch.tensor(np.asarray(Wj, np.float32)).to(_DTYPES[precision])
    cj, ct = jnp.asarray(cand, jnp.int32), torch.tensor(cand)
    if method == "omr":
        want = jlc.omr_reduce_cand_blocked(jcorpus, Zj, Wj[..., 0], cj, 2,
                                           use_kernels=True, block_n=8,
                                           block_v=32)
        got = lc.omr_reduce_cand_blocked(tcorpus, Z, W[..., 0], ct, 2,
                                         use_kernels=True)
    else:
        want = jlc.pour_cand_blocked(jcorpus, Zj, Wj, cj, k - 1, 2,
                                     use_kernels=True, block_n=8,
                                     block_v=32)
        got = lc.pour_cand_blocked(tcorpus, Z, W, ct, k - 1, 2,
                                   use_kernels=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# ------------------------------------------------------------ the wrapper


def _small(rng):
    nq, b, n, hmax, v = 3, 6, 10, 5, 20
    ids, w, cand = (torch.tensor(a) for a in (*_corpus(rng, n, hmax, v),
                                              _cands(rng, nq, b, n)))
    Z, W = _ladders(rng, nq, v, "pour3", "f32", empty_query=False)
    return ids, w, cand, Z, W


_CAND_REJECTS = ("cand_i32", "cand_range", "cand_negative", "cand_empty",
                 "cand_nq", "cand_noncontiguous")
_REJECTS = ("ids_i64", "w_f64", "w_shape", "z_f16", "z_narrow", "w_dtype",
            "w_missing", "w_given_at_0", "w_shallow", "iters_too_many",
            "z_noncontiguous", "id_too_big", "id_negative", "mixed")
#: The all-rows form pours at iters=0 (W None); these cases apply there,
#: and ``pour_iters1`` / ``pour_iters3`` ask it for a pour it does not take.
_ALL_ROWS_REJECTS = ("ids_i64", "w_f64", "w_shape", "z_f16", "z_empty",
                     "w_given_at_0", "z_noncontiguous", "id_too_big",
                     "id_negative", "mixed", "pour_iters1", "pour_iters3")


@pytest.mark.parametrize("form,case", [
    *(("cand", c) for c in _CAND_REJECTS + _REJECTS),
    *(("all_rows", c) for c in _ALL_ROWS_REJECTS)])
def test_cand_pour_rows_rejects(rng, form, case):
    ids, w, cand, Z, W = _small(rng)
    iters = 3
    if form == "all_rows":
        cand = None
        if case in ("pour_iters1", "pour_iters3"):
            iters = int(case[-1])
        else:
            iters, Z, W = 0, Z[..., :1].contiguous(), None
    if case == "ids_i64":
        ids = ids.long()
    elif case == "w_f64":
        w = w.double()
    elif case == "w_shape":
        w = w[:, :3].contiguous()
    elif case == "cand_i32":
        cand = cand.int()
    elif case == "cand_range":
        cand[0, 0] = ids.shape[0]
    elif case == "cand_negative":
        cand[1, 1] = -1
    elif case == "cand_empty":
        cand = cand[:, :0].contiguous()
    elif case == "cand_nq":
        cand = cand[:2].contiguous()
    elif case == "cand_noncontiguous":
        cand = cand.T.contiguous().T
    elif case == "z_f16":
        Z, W = Z.half(), None if W is None else W.half()
    elif case == "z_empty":
        Z = Z[..., :0].contiguous()
    elif case == "z_narrow":
        Z = Z[..., :3].contiguous()
    elif case == "w_dtype":
        W = W.to(torch.bfloat16)
    elif case == "w_missing":
        W = None
    elif case == "w_given_at_0":
        iters, W = 0, W if W is not None else torch.zeros_like(Z)
    elif case == "w_shallow":
        W = W[..., :2].contiguous()
    elif case == "iters_too_many":
        iters = cand_pour.MAX_ITERS + 1
        Z = torch.zeros(Z.shape[:2] + (iters + 1,))
        W = torch.zeros(Z.shape[:2] + (iters,))
    elif case == "z_noncontiguous":
        Z = Z.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "id_too_big":
        ids = ids.clone()
        ids[3, 2] = Z.shape[1]
    elif case == "id_negative":
        ids = ids.clone()
        ids[0, 0] = -1
    elif case == "mixed":
        Z = Z.to("meta")
    with pytest.raises(ValueError):
        tops.cand_pour_rows(ids, w, cand, Z, W, iters)


_OMR_REJECTS = ("z_width", "w0_rank", "w0_dtype", "w0_vocab")


@pytest.mark.parametrize("form,case", [
    *(("cand", c) for c in _OMR_REJECTS + ("cand_range",)),
    *(("all_rows", c) for c in _OMR_REJECTS)])
def test_cand_omr_rows_rejects(rng, form, case):
    ids, w, cand, Z, W = _small(rng)
    if form == "all_rows":
        cand = None
    W0 = W[..., 0].contiguous()
    if case == "z_width":
        Z = Z[..., :1].contiguous()
    elif case == "w0_rank":
        W0 = W
    elif case == "w0_dtype":
        W0 = W0.to(torch.bfloat16)
    elif case == "w0_vocab":
        W0 = W0[:, :7].contiguous()
    elif case == "cand_range":
        cand[2, 3] = ids.shape[0] + 5
    with pytest.raises(ValueError):
        tops.cand_omr_rows(ids, w, cand, Z, W0)


def test_corpus_id_range_is_checked_once_per_corpus(rng, monkeypatch):
    """The corpus's id range is one pass the first time a corpus is seen;
    later calls look it up, and an in-place change is seen again."""
    ids, w, cand, Z, W = _small(rng)
    passes = []
    real = torch.aminmax
    monkeypatch.setattr(torch, "aminmax",
                        lambda t: passes.append(t is ids) or real(t))
    for _ in range(3):
        tops.cand_pour_rows(ids, w, None, Z, None, 0)
        tops.cand_pour_rows(ids, w, cand, Z, W, 3)
    assert passes.count(True) == 1         # the corpus, once
    assert passes.count(False) == 3        # cand, once per candidate call
    ids[0, 0] = Z.shape[1]                 # an in-place change
    with pytest.raises(ValueError):
        tops.cand_pour_rows(ids, w, None, Z, None, 0)


def test_fused_k2_shares_the_corpus_id_check(rng, monkeypatch):
    """The fused K2 (``act_phase2_gather``) and K3's corpus-row entry check
    one corpus's id range once between them, and K2 rejects a corpus that
    changed in place to an id out of range."""
    ids, w, cand, Z, W = _small(rng)
    passes = []
    real = torch.aminmax
    monkeypatch.setattr(torch, "aminmax",
                        lambda t: passes.append(t is ids) or real(t))
    want = cand_pour.cand_pour_rows_plain(ids, w, None, Z, W, 3)
    for _ in range(2):
        torch.testing.assert_close(tops.act_phase2_gather(w, ids, Z, W),
                                   want, **F32_TOL)
        tops.cand_pour_rows(ids, w, None, Z, None, 0)
    assert passes == [True]                # the corpus, once in all
    ids[2, 1] = -1
    with pytest.raises(ValueError):
        tops.act_phase2_gather(w, ids, Z, W)


# ------------------------------------------------------- on a CUDA card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("nq,b,n,hmax,v", [
    (1, 9, 17, 7, 37),          # one query, a short row
    (3, 70, 200, 300, 500),     # one 512-slot pass, part full
    (4, 30, 40, 600, 700),      # two passes: the queue is written twice
    (3, 20, 24, 1100, 2000),    # three passes
    (20, 40, 90, 50, 300),      # two query chunks in the all-rows form
    (16, 941, 2000, 500, 5000),
])
def test_cand_pour_rows_cuda_matches_plain(rng, cuda, nq, b, n, hmax, v,
                                           dtype):
    """The kernel against its plain version and the old K3 on the same
    rows. Row 2 is a full row (every slot live) and a candidate of every
    query, so at hmax > 512 both forms fill the queue on every pass."""
    ids, w, cand = (torch.tensor(a, device=cuda)
                    for a in (*_corpus(rng, n, hmax, v),
                              _cands(rng, nq, b, n)))
    cand[:, 4] = 2
    for mode in MODES:
        Z, W = (t.to(cuda) for t in _ladders(rng, nq, v, mode, dtype,
                                             empty_query=nq > 1))
        iters = MODES[mode]
        key = "omr" if iters is None else ("pour0" if iters == 0 else "pour")
        for c in (cand, None) if mode in ALL_ROWS_MODES else (cand,):
            before = dict(cand_pour.rows_launches)
            got = _new(ids, w, c, Z, W, mode)
            torch.cuda.synchronize()
            k = key if c is not None else f"all_{key}"
            assert cand_pour.rows_launches[k] == before[k] + 1
            Wp = None if iters == 0 else (W[..., 0] if iters is None else W)
            plain = (cand_pour.cand_omr_rows_plain(ids, w, c, Z, Wp)
                     if iters is None else
                     cand_pour.cand_pour_rows_plain(ids, w, c, Z, Wp, iters))
            torch.testing.assert_close(got, plain, **F32_TOL)
            rows = cand if c is not None else \
                torch.arange(n, device=cuda).expand(nq, n)
            torch.testing.assert_close(
                got, _old(ids[rows], w[rows], Z, W, mode), **F32_TOL)


@pytest.mark.cuda
def test_cand_pour_rows_cuda_deep_ladders(rng, cuda):
    """iters up to MAX_ITERS: every ladder column the kernel holds."""
    nq, b, n, hmax, v = 3, 50, 60, 40, 200
    ids, w, cand = (torch.tensor(a, device=cuda)
                    for a in (*_corpus(rng, n, hmax, v),
                              _cands(rng, nq, b, n)))
    for iters in (2, 7, cand_pour.MAX_ITERS):
        Z = torch.sort(torch.rand((nq, v, iters + 1), device=cuda),
                       dim=-1).values
        W = torch.rand((nq, v, iters), device=cuda) * 0.1
        torch.testing.assert_close(
            tops.cand_pour_rows(ids, w, cand, Z, W, iters),
            cand_pour.cand_pour_rows_plain(ids, w, cand, Z, W, iters),
            **F32_TOL)
