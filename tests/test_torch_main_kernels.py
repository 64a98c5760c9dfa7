"""The main path's two kernels as the engine calls them: ``dist_topk`` (K1)
on masks with empty, full and short queries, and ``act_phase2_gather`` (K2
with the gather fused in).

On the CPU the wrappers run the plain versions, which are held to the JAX
package on the same numpy inputs: K1's plain version to
``repro.kernels.ops.dist_topk_batched`` (the Pallas kernel in interpret
mode, as ``tests/test_torch_kernels.py`` runs it), the fused K2's to
``repro.core.lc.pour_blocked`` (jnp path) and to the Pallas
``act_phase2_batched`` (interpret mode) on the gathered ladders. On a CUDA
card the kernels are held to the plain versions, K1 split into query groups
bitwise to K1 on each query alone, and the fused K2 bitwise to the unfused
one.

Tolerances: float32 rtol 1e-5 plus atol 1e-6; a bfloat16 Z ladder within
one bf16 ulp of [1, 2) (2^-7 < 8e-3). Selection indices are compared
bitwise. The corpora and ladders here give every query at least k valid
bins wherever a JAX pour is the reference, so that JAX's two engines agree
(ROADMAP Queue 3: the JAX pour's one-ulp remainder).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lc as jlc
from repro.data import synth as jsynth
from repro.kernels import ops as jops
from repro_torch.api import corpus_from_numpy
from repro_torch.core import lc as tlc
from repro_torch.core.precision import pad_dist_for
from repro_torch.kernels import act_phase2, dist_topk
from repro_torch.kernels import ops as tops

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_ATOL = 8e-3

# ------------------------------------------------------------------- K1


def _edge_inputs(rng, nq, v, h, m, k):
    """Unit-norm embeddings; query 0 has no valid bin, query 1 all h,
    query 2 fewer than k (starting past column 0, so that the lowest
    invalid column is 0), the rest a random share."""
    coords = rng.normal(size=(v, m)).astype(np.float32)
    coords /= np.linalg.norm(coords, axis=-1, keepdims=True)
    qcs = rng.normal(size=(nq, h, m)).astype(np.float32)
    qcs /= np.linalg.norm(qcs, axis=-1, keepdims=True)
    qcs[:, 0] = coords[0]                          # an exact-zero distance
    qmask = rng.uniform(size=(nq, h)) < 0.5
    qmask[0] = False
    qmask[1] = True
    qmask[2] = False
    qmask[2, 1:1 + max(1, min(k - 1, h - 1))] = True
    return coords, qcs, qmask


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,v,h,m,k", [
    (3, 64, 12, 8, 4), (4, 50, 30, 16, 8), (5, 33, 7, 5, 16),
    (3, 40, 9, 300, 1), (4, 70, 20, 3, 2),
])
def test_dist_topk_plain_matches_pallas_on_edge_masks(rng, nq, v, h, m, k,
                                                      out_dtype):
    coords, qcs, qmask = _edge_inputs(rng, nq, v, h, m, k)
    zj, sj = jops.dist_topk_batched(
        jnp.asarray(coords), jnp.asarray(qcs), k,
        qmask=jnp.asarray(qmask, jnp.float32), block_v=32, block_h=512,
        out_dtype=out_dtype)
    zt, st = dist_topk.dist_topk_plain(torch.tensor(coords),
                                       torch.tensor(qcs), torch.tensor(qmask),
                                       k, getattr(torch, out_dtype))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    zt, zj = zt.float().numpy(), np.asarray(zj, np.float32)
    if out_dtype == "float32":
        np.testing.assert_allclose(zt, zj, **F32_TOL)
    else:
        np.testing.assert_allclose(zt, zj, rtol=0, atol=BF16_ATOL)
    big = pad_dist_for(out_dtype)
    # no valid bin: every slot the sentinel, every column the lowest (0)
    assert (zt[0] == big).all() and (st[0].numpy() == 0).all()
    # all bins valid: no sentinel among the min(k, h) slots
    assert (zt[1, :, :min(k, h)] < big).all()
    # fewer valid bins than k: the sentinel past them, S the lowest
    # invalid column (0: the bins start at column 1)
    n2 = int(qmask[2].sum())
    if n2 < k:
        assert (zt[2, :, n2:] == big).all()
        assert (st[2, :, n2:].numpy() == 0).all()


def test_dist_topk_plain_matches_pallas_all_slots_valid_across_h_blocks(rng):
    """All slots valid, h cut into Pallas blocks: the float32 ladders and
    picks agree across the block boundaries."""
    coords, qcs, _ = _edge_inputs(rng, 3, 64, 40, 16, 8)
    qmask = np.ones((3, 40), bool)
    zj, sj = jops.dist_topk_batched(
        jnp.asarray(coords), jnp.asarray(qcs), 8,
        qmask=jnp.asarray(qmask, jnp.float32), block_v=32, block_h=16)
    zt, st = dist_topk.dist_topk_plain(torch.tensor(coords),
                                       torch.tensor(qcs), torch.tensor(qmask),
                                       8)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), **F32_TOL)


# ----------------------------------------------------- K2, fused gather


@pytest.fixture(scope="module")
def corpus_pair():
    """A JAX corpus and its port twin, from the same numpy arrays; every
    document holds at least 9 words."""
    c, _ = jsynth.make_text_like(n_docs=13, n_classes=4, vocab=96, m=8,
                                 doc_len=30, hmax=16, seed=3)
    ids, w, coords = (np.asarray(a) for a in (c.ids, c.w, c.coords))
    assert ((w > 0).sum(axis=1) >= 9).all()
    jc = jlc.Corpus(ids=jnp.asarray(ids), w=jnp.asarray(w),
                    coords=jnp.asarray(coords))
    return jc, corpus_from_numpy(ids, w, coords, "cpu")


def _ladders(jc, iters, dtype):
    """Phase-1 ladders of five corpus rows (k = iters + 1 <= 9 valid bins
    each), numpy float32 as JAX computes them, and the port's copies in
    ``dtype`` with JAX's inputs their float32 values (both sides read the
    same, possibly bf16-rounded, ladders)."""
    q_ids, q_w = np.asarray(jc.ids)[:5], np.asarray(jc.w)[:5]
    zj, wj = jlc.phase1_batched(jc.coords, jnp.asarray(q_ids),
                                jnp.asarray(q_w), iters + 1)
    zt = torch.tensor(np.asarray(zj)).to(dtype)
    wt = torch.tensor(np.asarray(wj)).to(dtype)
    return zt, wt, jnp.asarray(zt.float().numpy()), jnp.asarray(
        wt.float().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("iters", [1, 3, 7])
def test_act_phase2_gather_plain_matches_jax_pour_blocked(corpus_pair, iters,
                                                          dtype):
    jc, tc = corpus_pair
    zt, wt, zj, wj = _ladders(jc, iters, dtype)
    got = act_phase2.act_phase2_gather_plain(tc.w, tc.ids, zt, wt)
    want = jlc.pour_blocked(jc, zj, wj, iters, block_q=2,
                            use_kernels=False)
    assert got.shape == (5, tc.n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("iters", [1, 3, 7])
def test_act_phase2_gather_plain_matches_pallas(corpus_pair, iters, dtype):
    jc, tc = corpus_pair
    zt, wt, zj, wj = _ladders(jc, iters, dtype)
    ids = np.asarray(jc.ids)
    want = jops.act_phase2_batched(jc.w, zj[:, ids], wj[:, ids, :iters],
                                   block_n=16, block_h=8)
    got = act_phase2.act_phase2_gather_plain(tc.w, tc.ids, zt, wt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def _gather_inputs(rng, nq, n, v, hmax, iters, wdepth, dtype):
    """Random sorted ladders over a vocabulary of v, random ids with x = 0
    padding slots (whose ids are 0, as the corpora's)."""
    x = (rng.uniform(size=(n, hmax)) * (rng.uniform(size=(n, hmax)) > 0.3)
         ).astype(np.float32)
    ids = np.where(x > 0, rng.integers(0, v, size=(n, hmax)), 0
                   ).astype(np.int32)
    Z = np.sort(rng.uniform(size=(nq, v, iters + 1)), axis=-1
                ).astype(np.float32)
    W = (rng.uniform(size=(nq, v, wdepth)) * 0.3).astype(np.float32)
    return (torch.tensor(x), torch.tensor(ids), torch.tensor(Z).to(dtype),
            torch.tensor(W).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,n,v,hmax,iters,wdepth", [
    (1, 10, 20, 7, 1, 1), (2, 33, 50, 17, 3, 4), (3, 9, 40, 40, 7, 8),
])
def test_act_phase2_gather_is_the_unfused_pour_on_gathered_ladders(
        rng, nq, n, v, hmax, iters, wdepth, dtype):
    """The CPU route of the fused entry is bitwise the unfused wrapper on
    the gathered ladders, and launches nothing."""
    x, ids, Z, W = _gather_inputs(rng, nq, n, v, hmax, iters, wdepth, dtype)
    before = (act_phase2.launches, act_phase2.gather_launches)
    got = tops.act_phase2_gather(x, ids, Z, W)
    want = tops.act_phase2_batched(x, Z[:, ids].contiguous(),
                                   W[:, ids, :iters].contiguous())
    assert got.shape == (nq, n) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert (act_phase2.launches, act_phase2.gather_launches) == before


@pytest.mark.parametrize("iters", [1, 4])
def test_pour_blocked_kernel_branch_matches_reference_branch(corpus_pair,
                                                             iters):
    """``pour_blocked`` under ``use_kernels`` (the fused entry's plain
    version here) against its reference branch, on the same ladders."""
    jc, tc = corpus_pair
    zt, wt, _, _ = _ladders(jc, iters, torch.float32)
    got = tlc.pour_blocked(tc, zt, wt, iters, block_q=2, use_kernels=True)
    want = tlc.pour_blocked(tc, zt, wt, iters, block_q=2, use_kernels=False)
    torch.testing.assert_close(got, want, **F32_TOL)


@pytest.mark.parametrize("case", [
    "x_f64", "ids_i64", "ids_shape", "z_depth", "w_shallow", "w_rows",
    "dtype_mix", "ladder_f16", "id_negative", "id_too_big", "noncontiguous",
    "meta_device", "empty",
])
def test_act_phase2_gather_rejects(rng, case):
    x, ids, Z, W = _gather_inputs(rng, 2, 9, 30, 6, 3, 4, torch.float32)
    if case == "x_f64":
        x = x.double()
    elif case == "ids_i64":
        ids = ids.long()
    elif case == "ids_shape":
        ids = ids[:, :5].contiguous()
    elif case == "z_depth":
        Z = Z[..., :1].contiguous()
    elif case == "w_shallow":
        W = W[..., :2].contiguous()
    elif case == "w_rows":
        W = W[:, :29].contiguous()
    elif case == "dtype_mix":
        W = W.to(torch.bfloat16)
    elif case == "ladder_f16":
        Z, W = Z.half(), W.half()
    elif case == "id_negative":
        ids[3, 2] = -1
    elif case == "id_too_big":
        ids[0, 0] = Z.shape[1]
    elif case == "noncontiguous":
        Z = Z.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "meta_device":
        x, ids, Z, W = (t.to("meta") for t in (x, ids, Z, W))
    elif case == "empty":
        x, ids = x[:0].contiguous(), ids[:0].contiguous()
    with pytest.raises(ValueError):
        tops.act_phase2_gather(x, ids, Z, W)


def test_act_phase2_gather_plain_blocks_change_no_value(corpus_pair,
                                                       monkeypatch):
    """The plain fused-gather version gathers a few queries at a time;
    any block size gives the same scores, bitwise."""
    jc, tc = corpus_pair
    zt, wt, _, _ = _ladders(jc, 3, torch.float32)
    want = act_phase2.act_phase2_plain(tc.w, zt[:, tc.ids],
                                       wt[:, tc.ids, :3])
    for block in (1, 2, 8):
        monkeypatch.setattr(act_phase2, "PLAIN_BLOCK_Q", block)
        assert torch.equal(
            act_phase2.act_phase2_gather_plain(tc.w, tc.ids, zt, wt), want)


# ------------------------------------------------------- on a CUDA card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,v,h,m,k", [
    (3, 300, 70, 33, 8), (5, 1000, 500, 300, 8), (4, 129, 64, 16, 1),
    (6, 257, 130, 7, 16), (3, 50, 3, 4, 5), (8, 200, 9, 12, 2),
])
def test_dist_topk_cuda_matches_plain_on_edge_masks(rng, cuda, nq, v, h, m,
                                                    k, out_dtype):
    coords, qcs, qmask = (torch.tensor(a, device=cuda) for a in
                          _edge_inputs(rng, nq, v, h, m, k))
    before = dist_topk.launches
    zk, sk = tops.dist_topk_batched(coords, qcs, qmask, k,
                                    out_dtype=out_dtype)
    zp, sp = dist_topk.dist_topk_plain(coords, qcs, qmask, k, out_dtype)
    torch.cuda.synchronize()
    assert dist_topk.launches == before + 1
    assert torch.equal(sk, sp)
    atol = 1e-5 if out_dtype == torch.float32 else BF16_ATOL
    torch.testing.assert_close(zk.float(), zp.float(), rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,v,h,m,k", [
    (200, 784, 60, 2, 8),           # MNIST width: 7 tiles, 4 queries a group
    (9, 60_000, 70, 33, 1),         # 469 tiles fill the card: one group
    (9, 300, 70, 33, 1), (64, 129, 16, 2, 16),
])
def test_dist_topk_cuda_query_groups_give_the_same_output(rng, cuda, nq, v,
                                                          h, m, k):
    """K1 splits the queries into groups when the vocabulary tiles alone
    do not fill the card; a query's slots do not depend on its group: a
    query launched alone (one group) or in the batch's first half gives
    bitwise its rows of the whole batch's launch."""
    coords, qcs, qmask = (torch.tensor(a, device=cuda) for a in
                          _edge_inputs(rng, nq, v, h, m, k))
    z, s = dist_topk.dist_topk_cuda(coords, qcs, qmask, k)
    half = nq // 2 + 1
    zh, sh = dist_topk.dist_topk_cuda(coords, qcs[:half], qmask[:half], k)
    assert torch.equal(zh, z[:half]) and torch.equal(sh, s[:half])
    for q in range(nq):
        zq, sq = dist_topk.dist_topk_cuda(coords, qcs[q:q + 1],
                                          qmask[q:q + 1], k)
        assert torch.equal(zq[0], z[q]) and torch.equal(sq[0], s[q]), q


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,n,v,hmax,iters,wdepth", [
    (1, 10, 20, 7, 1, 1), (3, 333, 1000, 500, 7, 8), (8, 65, 300, 33, 15, 16),
    (2, 50, 100, 40, 1, 2), (2, 50, 100, 40, 3, 4), (2, 50, 100, 40, 5, 7),
])
def test_act_phase2_gather_cuda_is_bitwise_the_unfused_kernel(
        rng, cuda, nq, n, v, hmax, iters, wdepth, dtype):
    x, ids, Z, W = (t.to(cuda) for t in _gather_inputs(
        rng, nq, n, v, hmax, iters, wdepth, dtype))
    before = (act_phase2.launches, act_phase2.gather_launches)
    got = tops.act_phase2_gather(x, ids, Z, W)
    unfused = tops.act_phase2_batched(x, Z[:, ids].contiguous(),
                                      W[:, ids, :iters].contiguous())
    want = act_phase2.act_phase2_gather_plain(x, ids, Z, W)
    torch.cuda.synchronize()
    assert (act_phase2.launches, act_phase2.gather_launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got, unfused)
    torch.testing.assert_close(got, want, **F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq", [1, 3])
@pytest.mark.parametrize("n,v,hmax,iters,wdepth", [
    (10, 20, 7, 1, 2), (333, 1000, 500, 7, 8), (65, 300, 33, 15, 16),
    (50, 100, 40, 3, 4), (50, 100, 784, 2, 3), (40, 100, 130, 5, 7),
    (40, 100, 300, 1, 1),
])
def test_act_phase2_gather_row_stop_is_bitwise_the_whole_row(
        rng, cuda, nq, n, v, hmax, iters, wdepth, dtype):
    """The fused K2 walks each row only up to its last live slot
    (``row_lens``): bitwise the same kernel walking every row to hmax and
    the unfused kernel, on rows whose lengths run from 0 to hmax, with
    zero slots inside them too (vector rows at k = 2, 4, 8, 16; any k
    value by value)."""
    x, ids, Z, W = _gather_inputs(rng, nq, n, v, hmax, iters, wdepth, dtype)
    cut = rng.integers(0, hmax + 1, size=n)
    cut[:2] = (0, hmax)
    x[torch.arange(hmax)[None, :] >= torch.tensor(cut)[:, None]] = 0.0
    x, ids, Z, W = (t.to(cuda) for t in (x, ids, Z, W))
    lens = act_phase2.row_lens(x)
    assert lens.tolist() == [max((j + 1 for j in range(hmax) if r[j] != 0),
                                 default=0) for r in x.tolist()]
    whole = torch.full_like(lens, hmax)
    before = (act_phase2.launches, act_phase2.gather_launches)
    got = tops.act_phase2_gather(x, ids, Z, W)
    entry = act_phase2.act_phase2_gather_cuda(x, ids, whole, Z, W)
    unfused = tops.act_phase2_batched(x, Z[:, ids].contiguous(),
                                      W[:, ids, :iters].contiguous())
    want = act_phase2.act_phase2_gather_plain(x, ids, Z, W)
    torch.cuda.synchronize()
    assert (act_phase2.launches, act_phase2.gather_launches) == (
        before[0] + 1, before[1] + 2)
    assert torch.equal(got, entry) and torch.equal(got, unfused)
    torch.testing.assert_close(got, want, **F32_TOL)
