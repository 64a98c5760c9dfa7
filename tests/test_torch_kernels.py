"""The port's kernels: plain versions against the JAX package's Pallas
kernels (``repro.kernels.ops`` in interpret mode, as ``tests/test_kernels.py``
runs them), the wrappers' checks and dispatch, and -- on a CUDA card only --
each CUDA kernel against its plain version.

Tolerances: float32 rtol 1e-5 plus atol 1e-6; a bfloat16 Z ladder within
one bf16 ulp of [1, 2) (2^-7 < 8e-3). Selection indices are compared
bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core.precision import pad_dist_for
from repro_torch.kernels import act_phase2, dist_topk
from repro_torch.kernels import ops as tops

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_ATOL = 8e-3


def _dist_topk_inputs(rng, nq, v, h, m, valid_frac=0.6):
    """Unit-norm embeddings (as the corpora's), so distances lie in [0, 2]
    where one bf16 ulp is at most 2^-7."""
    coords = rng.normal(size=(v, m)).astype(np.float32)
    coords /= np.linalg.norm(coords, axis=-1, keepdims=True)
    qcs = rng.normal(size=(nq, h, m)).astype(np.float32)
    qcs /= np.linalg.norm(qcs, axis=-1, keepdims=True)
    qcs[:, 0] = coords[0]                          # an exact-zero distance
    qmask = rng.uniform(size=(nq, h)) < valid_frac
    qmask[:, 0] = True
    qmask[0, 3:] = False                           # 3 valid bins < k
    return coords, qcs, qmask


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_h", [16, 512])
@pytest.mark.parametrize("nq,v,h,m,k", [
    (1, 64, 32, 8, 4), (3, 100, 50, 16, 8), (2, 70, 33, 3, 2),
    (2, 40, 12, 300, 1), (2, 31, 20, 5, 16),
])
def test_dist_topk_plain_matches_pallas(rng, nq, v, h, m, k, block_h,
                                        out_dtype):
    coords, qcs, qmask = _dist_topk_inputs(rng, nq, v, h, m)
    zj, sj = jops.dist_topk_batched(
        jnp.asarray(coords), jnp.asarray(qcs), k,
        qmask=jnp.asarray(qmask, jnp.float32), block_v=32, block_h=block_h,
        out_dtype=out_dtype)
    zt, st = dist_topk.dist_topk_plain(torch.tensor(coords),
                                       torch.tensor(qcs), torch.tensor(qmask),
                                       k, getattr(torch, out_dtype))
    assert zt.dtype == getattr(torch, out_dtype) and st.dtype == torch.int32
    st, sj = st.numpy(), np.asarray(sj)
    if out_dtype == "bfloat16" and block_h < h:
        # The Pallas kernel carries its running top-k between h blocks in
        # the bf16 output, so across a block boundary it compares rounded
        # values; the port selects in float32 throughout (ROADMAP Queue 3).
        # The picks may then differ only between columns whose float32
        # distances lie within the bf16 band.
        q, i, _ = np.nonzero(st != sj)
        d = lambda s: np.linalg.norm(coords[i] - qcs[q, s[st != sj]], axis=-1)
        assert (np.abs(d(st) - d(sj)) <= BF16_ATOL).all()
    else:
        np.testing.assert_array_equal(st, sj)
    zt, zj = zt.float().numpy(), np.asarray(zj, np.float32)
    if out_dtype == "float32":
        np.testing.assert_allclose(zt, zj, **F32_TOL)
    else:
        np.testing.assert_allclose(zt, zj, rtol=0, atol=BF16_ATOL)
    assert (zt[:, 0, 0] == 0.0).all()              # snapped exact zero
    # the degenerate row's slots past its 3 valid bins: sentinel, exactly
    assert (zt[0, :, 3:] == pad_dist_for(out_dtype)).all()


def _pour_inputs(rng, nq, n, hmax, iters, dtype):
    x = (rng.uniform(size=(n, hmax)) * (rng.uniform(size=(n, hmax)) > 0.3)
         ).astype(np.float32)
    zg = np.sort(rng.uniform(size=(nq, n, hmax, iters + 1)), axis=-1
                 ).astype(np.float32)
    wg = (rng.uniform(size=(nq, n, hmax, iters)) * 0.3).astype(np.float32)
    zt = torch.tensor(zg).to(dtype)
    wt = torch.tensor(wg).to(dtype)
    return x, zt, wt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,n,hmax,iters", [
    (1, 10, 7, 1), (2, 64, 32, 3), (3, 33, 17, 7), (2, 5, 9, 15),
])
def test_act_phase2_plain_matches_pallas(rng, nq, n, hmax, iters, dtype):
    x, zg, wg = _pour_inputs(rng, nq, n, hmax, iters, dtype)
    # Both sides read the same (possibly bf16-rounded) ladders.
    want = jops.act_phase2_batched(
        jnp.asarray(x), jnp.asarray(zg.float().numpy()),
        jnp.asarray(wg.float().numpy()), block_n=16, block_h=8)
    got = act_phase2.act_phase2_plain(torch.tensor(x), zg, wg)
    assert got.shape == (nq, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_wrappers_on_cpu_run_the_plain_versions(rng):
    coords, qcs, qmask = (torch.tensor(a) for a in
                          _dist_topk_inputs(rng, 2, 40, 12, 5))
    x, zg, wg = _pour_inputs(rng, 2, 9, 6, 3, torch.float32)
    x = torch.tensor(x)
    before = (dist_topk.launches, act_phase2.launches)
    for dtype in (torch.float32, torch.bfloat16):
        for got, want in zip(
                tops.dist_topk_batched(coords, qcs, qmask, 4, out_dtype=dtype),
                dist_topk.dist_topk_plain(coords, qcs, qmask, 4, dtype)):
            assert torch.equal(got, want)
    assert torch.equal(tops.act_phase2_batched(x, zg, wg),
                       act_phase2.act_phase2_plain(x, zg, wg))
    assert (dist_topk.launches, act_phase2.launches) == before


@pytest.mark.parametrize("case", [
    "coords_f64", "qcs_width", "mask_float", "mask_shape", "k_zero",
    "k_too_big", "out_f16", "noncontiguous", "empty", "meta_device",
])
def test_dist_topk_batched_rejects(rng, case):
    coords, qcs, qmask = (torch.tensor(a) for a in
                          _dist_topk_inputs(rng, 2, 40, 12, 5))
    k, kw = 4, {}
    if case == "coords_f64":
        coords = coords.double()
    elif case == "qcs_width":
        qcs = qcs[..., :4].contiguous()
    elif case == "mask_float":
        qmask = qmask.float()
    elif case == "mask_shape":
        qmask = qmask[:, :5].contiguous()
    elif case == "k_zero":
        k = 0
    elif case == "k_too_big":
        k = dist_topk.MAX_K + 1
    elif case == "out_f16":
        kw = {"out_dtype": torch.float16}
    elif case == "noncontiguous":
        coords = torch.tensor(np.asfortranarray(coords.numpy()))
        assert not coords.is_contiguous()
    elif case == "empty":
        qcs, qmask = qcs[:, :0].contiguous(), qmask[:, :0].contiguous()
    elif case == "meta_device":
        coords, qcs, qmask = (t.to("meta") for t in (coords, qcs, qmask))
    with pytest.raises(ValueError):
        tops.dist_topk_batched(coords, qcs, qmask, k, **kw)


@pytest.mark.parametrize("case", [
    "iters_zero", "zg_depth", "dtype_mix", "ladder_f16", "x_f64",
    "noncontiguous", "rows",
])
def test_act_phase2_batched_rejects(rng, case):
    x, zg, wg = _pour_inputs(rng, 2, 9, 6, 3, torch.float32)
    x = torch.tensor(x)
    if case == "iters_zero":
        zg, wg = zg[..., :1].contiguous(), wg[..., :0].contiguous()
    elif case == "zg_depth":
        zg = zg[..., :3].contiguous()
    elif case == "dtype_mix":
        wg = wg.to(torch.bfloat16)
    elif case == "ladder_f16":
        zg, wg = zg.half(), wg.half()
    elif case == "x_f64":
        x = x.double()
    elif case == "noncontiguous":
        zg = zg.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "rows":
        x = x[:5].contiguous()
    with pytest.raises(ValueError):
        tops.act_phase2_batched(x, zg, wg)


# ------------------------------------------------------- on a CUDA card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,v,h,m,k", [
    (2, 300, 70, 33, 8), (3, 1000, 500, 300, 8), (1, 129, 64, 16, 1),
    (2, 257, 130, 7, 16), (2, 50, 3, 4, 5),
])
def test_dist_topk_cuda_matches_plain(rng, cuda, nq, v, h, m, k, out_dtype):
    coords, qcs, qmask = (torch.tensor(a, device=cuda) for a in
                          _dist_topk_inputs(rng, nq, v, h, m))
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,n,hmax,iters", [
    (1, 10, 7, 1), (3, 333, 500, 7), (2, 65, 33, 15),
])
def test_act_phase2_cuda_matches_plain(rng, cuda, nq, n, hmax, iters, dtype):
    x, zg, wg = _pour_inputs(rng, nq, n, hmax, iters, dtype)
    x, zg, wg = torch.tensor(x, device=cuda), zg.to(cuda), wg.to(cuda)
    before = act_phase2.launches
    got = tops.act_phase2_batched(x, zg, wg)
    want = act_phase2.act_phase2_plain(x, zg, wg)
    torch.cuda.synchronize()
    assert act_phase2.launches == before + 1
    torch.testing.assert_close(got, want, **F32_TOL)
