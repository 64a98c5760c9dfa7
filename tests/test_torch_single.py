"""The port's single-query engines, ``query_scores``, the scan engine and the
single-query kernel entries against the JAX package, on the same numpy
inputs.

* Each single-query engine (``METHODS[m].fn``) against JAX's, on the
  reference path and on the kernel path (JAX's Pallas kernels in interpret
  mode, the port's plain versions here), on full, padded and empty
  queries.
* ``query_scores(symmetric=True)``.
* ``batch_scores(engine="scan")``: bitwise a loop of the port's
  ``query_scores``, and within rtol 1e-5 of JAX's scan engine.
* ``EmdIndex``: a single query and a batch on both engines, search,
  all-pairs and the cascade's stage 1 through the scan engine.
* ``ops.dist_topk`` / ``ops.act_phase2``: the single-query views of the
  batched wrappers.
* The kernel path's route: K1 at nq=1, then the fused-gather K2 at nq=1
  (LC-ACT) or K3's all-rows form (LC-RWMD, LC-OMR), each reading the
  ladders at the corpus ids; no unfused K2 and no (n, hmax, k) gather.

Tolerances: float32 rtol 1e-5 plus atol 1e-6 (the frameworks sum in other
orders; a self-match scores ~1e-8 on one side and 0 on the other). Scores
are held to JAX where JAX's reference and kernel paths agree with each
other: on a query with fewer valid bins than k the JAX pour leaves a
remainder at the sentinel (ROADMAP Queue 3), and the port does not.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lc as jlc
from repro.core import retrieval as jr
from repro.data import synth as jsynth
from repro_torch.api import EmdIndex, EngineConfig, corpus_from_numpy
from repro_torch.core import lc
from repro_torch.core import retrieval as tr
from repro_torch.kernels import act_phase2, cand_pour, dist_topk
from repro_torch.kernels import ops as tops

F32_TOL = dict(rtol=1e-5, atol=1e-6)
#: (method, iters) of every single-query engine.
ENGINES = [("act", 1), ("act", 7), ("rwmd", 0), ("rwmd_rev", 0),
           ("omr", 0), ("ict", 0), ("bow", 0), ("wcd", 0)]


@functools.cache
def _corpora():
    """A JAX corpus and its port twin, from the same numpy arrays."""
    c, _ = jsynth.make_text_like(n_docs=24, n_classes=4, vocab=96, m=8,
                                 doc_len=30, hmax=16, seed=5)
    ids, w, coords = (np.asarray(a) for a in (c.ids, c.w, c.coords))
    jc = jlc.Corpus(ids=jnp.asarray(ids), w=jnp.asarray(w),
                    coords=jnp.asarray(coords))
    return jc, corpus_from_numpy(ids, w, coords, "cpu")


def _queries():
    """(kind, ids, w): a corpus row, the row cut to 2 valid bins (padded,
    fewer than k), and a query without a valid bin."""
    jc, _ = _corpora()
    ids, w = np.asarray(jc.ids)[6].copy(), np.asarray(jc.w)[6].copy()
    cut = w.copy()
    cut[2:] = 0.0
    cut /= cut.sum()
    return [("full", ids, w), ("padded", ids, cut),
            ("empty", ids, np.zeros_like(w))]


def _sane(a, b):
    return np.isclose(a, b, **F32_TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("method,iters", ENGINES)
def test_single_query_engines_match_jax(method, iters, use_kernels):
    jc, tc = _corpora()
    for kind, ids, w in _queries():
        kw = dict(method=method, iters=iters)
        got = tr.query_scores(tc, torch.tensor(ids), torch.tensor(w),
                              use_kernels=use_kernels, **kw).numpy()
        want = np.asarray(jr.query_scores(jc, jnp.asarray(ids),
                                          jnp.asarray(w),
                                          use_kernels=use_kernels, **kw))
        other = np.asarray(jr.query_scores(jc, jnp.asarray(ids),
                                           jnp.asarray(w),
                                           use_kernels=not use_kernels,
                                           **kw))
        assert got.shape == want.shape == (tc.n,) and got.dtype == np.float32
        promised = _sane(want, other)
        assert promised.mean() >= 0.5, kind
        np.testing.assert_allclose(got[promised], want[promised],
                                   **F32_TOL, err_msg=kind)
        if kind == "full" and method not in ("bow", "wcd"):
            assert got[6] <= 1e-6                     # its own row
        if kind == "empty" and method in ("rwmd_rev", "ict"):
            np.testing.assert_array_equal(got, 0.0)   # no mass to move


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("method", ["act", "rwmd", "omr", "ict"])
def test_single_query_kernel_and_reference_paths_agree(method, use_kernels):
    """The port's two single-query paths agree everywhere (its pour takes
    the remainder from the capacities, so no query is an exception)."""
    _, tc = _corpora()
    for _, ids, w in _queries():
        a = tr.query_scores(tc, torch.tensor(ids), torch.tensor(w),
                            method=method, iters=7, use_kernels=True)
        b = tr.query_scores(tc, torch.tensor(ids), torch.tensor(w),
                            method=method, iters=7, use_kernels=False)
        torch.testing.assert_close(a, b, **F32_TOL)


def test_single_query_ict_trims_padding_bins_as_jax_pours_them():
    """The port's single-query ICT drops the query's padding bins before
    the sort; on a query whose padding sits between valid bins the scores
    still equal JAX's full-width pour."""
    jc, tc = _corpora()
    ids, w = np.asarray(jc.ids)[3].copy(), np.asarray(jc.w)[3].copy()
    w[[1, 4]] = 0.0
    w /= w.sum()
    got = tr.query_scores(tc, torch.tensor(ids), torch.tensor(w),
                          method="ict").numpy()
    want = np.asarray(jr.query_scores(jc, jnp.asarray(ids), jnp.asarray(w),
                                      method="ict"))
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_single_query_ict_blocks_rows(monkeypatch):
    """Row blocks of any size give the same scores."""
    _, tc = _corpora()
    _, ids, w = _queries()[0]
    whole = lc.lc_ict_scores(tc, torch.tensor(ids), torch.tensor(w))
    monkeypatch.setattr(lc, "GATHER_ELEMS", 5 * tc.hmax * 16)
    torch.testing.assert_close(
        lc.lc_ict_scores(tc, torch.tensor(ids), torch.tensor(w)), whole,
        rtol=0, atol=0)


@pytest.mark.parametrize("block", [1, 5, 256])
def test_single_query_rwmd_rev_row_blocks(block):
    jc, tc = _corpora()
    _, ids, w = _queries()[1]
    got = lc.lc_rwmd_scores_rev(tc, torch.tensor(ids), torch.tensor(w),
                                block=block).numpy()
    want = np.asarray(jlc.lc_rwmd_scores_rev(jc, jnp.asarray(ids),
                                             jnp.asarray(w), block=block))
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("method", ["rwmd", "rwmd_rev", "bow"])
def test_query_scores_symmetric_matches_jax(method, use_kernels):
    jc, tc = _corpora()
    _, ids, w = _queries()[0]
    got = tr.query_scores(tc, torch.tensor(ids), torch.tensor(w),
                          method=method, symmetric=True,
                          use_kernels=use_kernels)
    want = np.asarray(jr.query_scores(jc, jnp.asarray(ids), jnp.asarray(w),
                                      method=method, symmetric=True,
                                      use_kernels=use_kernels))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    fwd = tr.query_scores(tc, torch.tensor(ids), torch.tensor(w),
                          method=method, use_kernels=use_kernels)
    assert (got >= fwd).all()


def test_query_scores_symmetric_needs_a_reverse():
    _, tc = _corpora()
    _, ids, w = _queries()[0]
    with pytest.raises(ValueError, match="reverse"):
        tr.query_scores(tc, torch.tensor(ids), torch.tensor(w),
                        method="act", symmetric=True)


def test_query_scores_ignores_the_precision_policy():
    """The single-query engines are the float32 oracle under every
    policy, as in the JAX package."""
    _, tc = _corpora()
    _, ids, w = _queries()[0]
    f32 = tr.query_scores(tc, torch.tensor(ids), torch.tensor(w), iters=3)
    for precision in ("bf16", "bf16_agg"):
        assert torch.equal(tr.query_scores(
            tc, torch.tensor(ids), torch.tensor(w), iters=3,
            precision=precision), f32)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("method,iters,symmetric", [
    ("act", 3, False), ("rwmd", 0, False), ("omr", 0, False),
    ("ict", 0, False), ("rwmd", 0, True)])
def test_scan_engine_is_a_loop_of_query_scores(method, iters, use_kernels,
                                               symmetric):
    jc, tc = _corpora()
    rows = [0, 6, 11, 17]
    kw = dict(method=method, iters=iters, use_kernels=use_kernels,
              symmetric=symmetric)
    scan = tr.batch_scores(tc, tc.ids[rows], tc.w[rows], engine="scan",
                           **kw)
    loop = torch.stack([tr.query_scores(tc, tc.ids[r], tc.w[r], **kw)
                        for r in rows])
    assert torch.equal(scan, loop)
    want = np.asarray(jr.batch_scores(jc, jc.ids[np.array(rows)],
                                      jc.w[np.array(rows)], engine="scan",
                                      **kw))
    np.testing.assert_allclose(scan.numpy(), want, **F32_TOL)
    batched = tr.batch_scores(tc, tc.ids[rows], tc.w[rows], **kw)
    torch.testing.assert_close(scan, batched, **F32_TOL)


def test_scan_engine_on_an_empty_batch():
    _, tc = _corpora()
    out = tr.batch_scores(tc, tc.ids[:0], tc.w[:0], engine="scan")
    assert out.shape == (0, tc.n)


@pytest.mark.parametrize("engine,match", [("nope", "unknown engine")])
def test_batch_scores_refuses_other_engines(engine, match):
    _, tc = _corpora()
    with pytest.raises(ValueError, match=match):
        tr.batch_scores(tc, tc.ids[:2], tc.w[:2], engine=engine)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["reference", "kernels"])
@pytest.mark.parametrize("method", sorted(tr.METHODS))
def test_dist_engine_on_a_1x1_mesh_is_batched(method, use_kernels):
    """The mesh engine on a 1 x 1 mesh (one rank, no process group) scores
    bitwise as the batched engine, and so it does without a mesh."""
    from repro_torch.launch.mesh import make_test_mesh
    _, tc = _corpora()
    kw = dict(method=method, iters=2, use_kernels=use_kernels)
    q = (tc.ids[:5], tc.w[:5])
    batched = tr.batch_scores(tc, *q, **kw)
    mesh = make_test_mesh(1, 1, backend="gloo", device="cpu")
    assert torch.equal(tr.batch_scores(tc, *q, engine="dist", mesh=mesh,
                                       **kw), batched)
    assert torch.equal(tr.batch_scores(tc, *q, engine="dist", **kw), batched)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("batch_engine", ["batched", "scan"])
def test_index_single_and_batch_shapes_on_both_engines(batch_engine,
                                                       backend):
    jc, tc = _corpora()
    index = EmdIndex.build(tc, EngineConfig(
        method="act", iters=3, top_l=5, backend=backend,
        batch_engine=batch_engine), device="cpu")
    q_ids, q_w = np.asarray(jc.ids)[:4], np.asarray(jc.w)[:4]
    batch = index.scores(q_ids, q_w)
    one = index.scores(q_ids[2], q_w[2])
    assert batch.shape == (4, tc.n) and one.shape == (tc.n,)
    s1, i1 = index.search(q_ids[2], q_w[2])
    sb, ib = index.search(q_ids, q_w)
    assert s1.shape == i1.shape == (5,) and sb.shape == ib.shape == (4, 5)
    if batch_engine == "scan":
        assert torch.equal(one, batch[2])
    torch.testing.assert_close(one, batch[2], **F32_TOL)
    assert (ib[:, 0] == torch.arange(4)).all() and i1[0] == 2
    jax_one = np.asarray(jr.query_scores(
        jc, jnp.asarray(q_ids[2]), jnp.asarray(q_w[2]), method="act",
        iters=3, use_kernels=backend == "cuda"))
    np.testing.assert_allclose(one.numpy(), jax_one, **F32_TOL)


def test_index_all_pairs_on_the_scan_engine():
    """``all_pairs`` threads the engine: the scan engine's matrix is the
    batched one within tolerance, and exactly symmetric."""
    _, tc = _corpora()
    index = EmdIndex.build(tc, EngineConfig(method="omr"), device="cpu")
    S = index.all_pairs()
    S_scan = index.with_config(batch_engine="scan").all_pairs()
    assert torch.equal(S_scan, S_scan.T)
    torch.testing.assert_close(S_scan, S, **F32_TOL)


@pytest.mark.parametrize("cascade", ["chain", "tight"])
def test_cascade_stage_one_on_the_scan_engine(cascade):
    jc, tc = _corpora()
    index = EmdIndex.build(tc, EngineConfig(top_l=4), device="cpu")
    q_ids, q_w = tc.ids[:5], tc.w[:5]
    s, i = index.search(q_ids, q_w, cascade=cascade)
    s2, i2 = index.with_config(batch_engine="scan").search(q_ids, q_w,
                                                           cascade=cascade)
    assert torch.equal(i, i2)
    torch.testing.assert_close(s, s2, **F32_TOL)


def test_single_query_search_ties_go_to_the_lowest_index():
    """Duplicate rows tie; as with ``lax.top_k`` the lower index comes
    first, through the single-query ``search``."""
    jc, _ = _corpora()
    ids = np.concatenate([np.asarray(jc.ids)] * 2)
    w = np.concatenate([np.asarray(jc.w)] * 2)
    n = ids.shape[0] // 2
    tc = corpus_from_numpy(ids, w, jc.coords, "cpu")
    s, idx = tr.search(tc, tc.ids[4], tc.w[4], 6, method="act", iters=2)
    assert s.shape == idx.shape == (6,)
    assert idx[:2].tolist() == [4, 4 + n] and s[0] == s[1]
    j2 = jlc.Corpus(ids=jnp.asarray(ids), w=jnp.asarray(w),
                    coords=jc.coords)
    js, jidx = jr.search(j2, jnp.asarray(ids[4]), jnp.asarray(w[4]), 6,
                         method="act", iters=2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **F32_TOL)


def test_single_kernel_entries_are_batches_of_one(rng):
    """``ops.dist_topk`` and ``ops.act_phase2`` (JAX's single-query
    entries): the batched wrappers at nq=1, with their checks."""
    v, h, m, n, hmax, iters = 30, 7, 5, 9, 6, 3
    coords = torch.tensor(rng.normal(size=(v, m)).astype(np.float32))
    qids = torch.tensor(rng.integers(0, v, size=h))
    qmask = torch.tensor(rng.uniform(size=h) < 0.7)
    z, s = tops.dist_topk(coords, coords[qids], qmask, 4, qids=qids)
    zb, sb = tops.dist_topk_batched(coords, coords[qids][None], qmask[None],
                                    4, qids=qids[None])
    assert torch.equal(z, zb[0]) and torch.equal(s, sb[0])
    x = torch.tensor(rng.uniform(size=(n, hmax)).astype(np.float32))
    zg = torch.tensor(np.sort(rng.uniform(size=(n, hmax, iters + 1)),
                              axis=-1).astype(np.float32))
    wg = torch.tensor(rng.uniform(size=(n, hmax, iters)).astype(np.float32))
    t = tops.act_phase2(x, zg, wg)
    assert t.shape == (n,)
    assert torch.equal(t, tops.act_phase2_batched(x, zg[None], wg[None])[0])
    with pytest.raises(ValueError):
        tops.act_phase2(x, zg[..., :1].contiguous(), wg[..., :0].contiguous())
    with pytest.raises(ValueError, match="qids"):
        tops.dist_topk(coords, coords[qids], qmask, 4, qids=qids[:3])


def _launch_counts():
    return (dist_topk.launches, act_phase2.launches,
            act_phase2.gather_launches, dict(cand_pour.rows_launches))


def test_single_query_kernel_path_counts_no_launch_on_the_cpu():
    """On the CPU the single-query kernel path runs the plain versions:
    K1, the unfused and the fused K2 and K3's corpus-row entry count no
    launch."""
    _, tc = _corpora()
    before = _launch_counts()
    for method, iters in (("act", 3), ("act", 7), ("rwmd", 0), ("omr", 0)):
        tr.query_scores(tc, tc.ids[0], tc.w[0], method=method, iters=iters,
                        use_kernels=True)
    assert _launch_counts() == before


#: The kernel wrappers a single query may reach, spied on below.
_SPIED = ("dist_topk", "act_phase2", "act_phase2_batched",
          "act_phase2_gather", "cand_pour_rows", "cand_omr_rows")


@pytest.mark.parametrize("method,iters,entry", [
    ("act", 1, "act_phase2_gather"), ("act", 7, "act_phase2_gather"),
    ("rwmd", 0, "cand_pour_rows"), ("omr", 0, "cand_omr_rows")])
def test_single_query_kernel_path_reads_the_ladders_at_the_ids(
        monkeypatch, method, iters, entry):
    """On the kernel path one query calls K1 once at nq=1 and then one
    entry that reads the (1, v, k) ladders at the corpus ids itself: the
    fused-gather K2 at nq=1 for LC-ACT (never the unfused K2), K3's
    corpus-row entry with cand=None for LC-RWMD and LC-OMR. The scores
    equal the reference path's within F32_TOL, and JAX's where JAX's two
    paths agree."""
    jc, tc = _corpora()
    calls = {name: [] for name in _SPIED}
    for name in _SPIED:
        def spy(*args, _name=name, _real=getattr(tops, name), **kw):
            calls[_name].append(args)
            return _real(*args, **kw)
        monkeypatch.setattr(tops, name, spy)
    for _, ids, w in _queries():
        for name in _SPIED:
            calls[name].clear()
        got = tr.query_scores(tc, torch.tensor(ids), torch.tensor(w),
                              method=method, iters=iters, use_kernels=True)
        assert {n: len(c) for n, c in calls.items() if c} == {
            "dist_topk": 1, entry: 1}
        args = calls[entry][0]
        k = iters + 1 if method == "act" else (2 if method == "omr" else 1)
        if method == "act":
            x, cids, Z, W = args
            assert W.shape == (1, tc.v, k)
        else:
            cids, x, cand, Z = args[:4]
            assert cand is None
        assert x is tc.w and cids is tc.ids and Z.shape == (1, tc.v, k)
        ref = tr.query_scores(tc, torch.tensor(ids), torch.tensor(w),
                              method=method, iters=iters, use_kernels=False)
        torch.testing.assert_close(got, ref, **F32_TOL)
        kw = dict(method=method, iters=iters)
        want, other = (np.asarray(jr.query_scores(
            jc, jnp.asarray(ids), jnp.asarray(w), use_kernels=uk, **kw))
            for uk in (True, False))
        promised = _sane(want, other)
        np.testing.assert_allclose(got.numpy()[promised], want[promised],
                                   **F32_TOL)


def test_row_lens_end_each_row_at_its_last_live_slot(rng):
    """``act_phase2.row_lens``: one past each row's last slot with x != 0,
    0 for an empty row; the wrapper keeps them per x tensor and computes
    them again after an in-place change."""
    x = torch.tensor([[0.1, 0.0, 0.2, 0.0], [0.0] * 4, [0.3, 0.1, 0.2, 0.4],
                      [0.0, 0.0, 0.0, 0.5]])
    lens = act_phase2.row_lens(x)
    assert lens.dtype == torch.int32 and lens.tolist() == [3, 0, 4, 4]
    assert tops._row_lens(x) is tops._row_lens(x)
    x[1, 2] = 0.7
    assert tops._row_lens(x).tolist() == [3, 3, 4, 4]
    r = rng.uniform(size=(50, 37)) * (rng.uniform(size=(50, 37)) < 0.3)
    want = [max((j + 1 for j in range(37) if row[j] != 0), default=0)
            for row in r]
    assert act_phase2.row_lens(torch.tensor(r)).tolist() == want


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("method,iters,k2", [("act", 7, 1), ("rwmd", 0, 0),
                                              ("omr", 0, 0)])
def test_single_query_kernel_path_on_the_card(cuda, method, iters, k2):
    """One query through the kernels: K1 once (at nq=1), then for LC-ACT
    the fused K2 once (``k2``) and the unfused K2 never, for LC-RWMD and
    LC-OMR K3's all-rows form once; the scores
    equal the plain path's within tolerance."""
    _, tc = _corpora()
    c = tc.to(cuda)
    before = _launch_counts()
    got = tr.query_scores(c, c.ids[6], c.w[6], method=method, iters=iters,
                          use_kernels=True)
    torch.cuda.synchronize()
    d, k, g, rows = (
        a - b if isinstance(a, int) else {m: a[m] - b[m] for m in a}
        for a, b in zip(_launch_counts(), before))
    assert (d, k, g) == (1, 0, k2)
    assert rows == {"pour": 0, "pour0": 0, "omr": 0,
                    "all_pour0": int(method == "rwmd"),
                    "all_omr": int(method == "omr")}
    want = tr.query_scores(tc, tc.ids[6], tc.w[6], method=method,
                           iters=iters, use_kernels=False)
    torch.testing.assert_close(got.cpu(), want, **F32_TOL)
