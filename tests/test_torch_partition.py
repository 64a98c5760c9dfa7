"""The mesh's kernel shims (``repro_torch.kernels.partition``) and its
shard-blocked top-k, against the unsharded kernels and the JAX package.

* K1 on a vocabulary slice (``ops.dist_topk_batched(..., row0=)``, the
  plain version here): bitwise the slice's rows of the whole-vocabulary
  K1, with a real exact 0 at every query bin's own row, which lies at an
  offset in the slice. The coordinates span many orders of magnitude
  (``exp(3 N(0, 1))`` at m=300), where the expansion leaves some
  self-distances above the zero snap, so only the pin at the right rows
  gives the zeros: without the offset the slice pins other pairs.
* On a 2 x 2 gloo mesh (one spawn, ``torch_mesh_ranks.shims_suite``):
  ``dist_topk_sharded`` (f32 and bf16 ladders, the bf16 ones crossing as
  16-bit words at half the bytes) bitwise the unsharded K1 and capacity
  gather; the fused K2 on the rank's row shard (the engine's call, which
  needs no shim) bitwise the unsharded launch's rows of the shard;
  the candidate exchange moving one float32 score a slot from each other
  model rank, and nothing else; each candidate engine through it bitwise
  its single-process call;
  ``topk_smallest`` on each rank's column block bitwise JAX's blocked
  top-k of the whole matrix, ties included.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro import cascade as jc
from repro.data.synth import make_text_like
from repro_torch.kernels import dist_topk, ops
from repro_torch.launch.local import run_local

V, M, STEP, NQ, K = 1200, 300, 3, 4, 4
KS = (1, 3, 8, 20)


@functools.cache
def _wide():
    """Coordinates over many orders of magnitude and NQ queries of every
    STEP-th word (100 bins each)."""
    coords = np.exp(3 * np.random.default_rng(0).standard_normal(
        (V, M))).astype(np.float32)
    qids = np.arange(0, V, STEP).reshape(NQ, -1)
    return torch.tensor(coords), torch.tensor(qids)


def _k1(coords, qids, rows, row0):
    c = coords[rows]
    return ops.dist_topk_batched(c, coords[qids], torch.ones_like(
        qids, dtype=torch.bool), K, qids=qids, row0=row0)


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_k1_on_a_vocabulary_slice_keeps_its_exact_zeros(parts):
    coords, qids = _wide()
    zf, sf = _k1(coords, qids, slice(0, V), 0)
    step = V // parts
    lost = 0
    for p in range(parts):
        v0 = p * step
        rows = slice(v0, v0 + step)
        z, s = _k1(coords, qids, rows, v0)
        assert torch.equal(z, zf[:, rows]) and torch.equal(s, sf[:, rows])
        q, c = torch.nonzero((qids >= v0) & (qids < v0 + step),
                             as_tuple=True)
        assert len(q) and (z[q, qids[q, c] - v0, 0] == 0).all()
        # The pin at the wrong rows (no offset) loses the slice's zeros.
        z0, _ = _k1(coords, qids, rows, 0)
        lost += int((z0[q, qids[q, c] - v0, 0] != 0).sum())
    assert lost > 0


def test_k1_slice_offset_of_the_plain_version():
    """``row0`` pins bin j at row qids[j] - row0 of the slice and nowhere
    else: a slice that holds none of the bins pins nothing."""
    coords, qids = _wide()
    qids = qids[:, :5] % 50                        # every bin in rows 0..49
    mask = torch.ones_like(qids, dtype=torch.bool)
    far = dist_topk.dist_topk_plain(coords[100:200], coords[qids], mask, 2,
                                    qids=qids, row0=100)
    plain = dist_topk.dist_topk_plain(coords[100:200], coords[qids], mask,
                                      2)
    assert torch.equal(far[0], plain[0]) and torch.equal(far[1], plain[1])


@functools.cache
def _corpus():
    return make_text_like(n_docs=48, n_classes=4, vocab=96, m=8,
                          doc_len=10, hmax=16, seed=11)[0]


@functools.cache
def _scores():
    rng = np.random.default_rng(5)
    return rng.integers(0, 6, size=(6, 40)).astype(np.float32) / 6


@functools.cache
def _shims():
    c = _corpus()
    arrays = (np.asarray(c.ids), np.asarray(c.w), np.asarray(c.coords))
    rows = np.array([0, 5, 13, 22, 31, 40])
    cand = np.random.default_rng(3).integers(0, c.n, size=(6, 9))
    return run_local(ranks.shims_suite, 2, 2,
                     args=(arrays, arrays[0][rows], arrays[1][rows], cand,
                           3, _scores(), KS), timeout=240)


@pytest.mark.parametrize("key", ["k1:torch.float32", "k1:torch.bfloat16",
                                 "k2", "exchange"])
def test_shims_are_bitwise_the_unsharded_kernels(key):
    for res in _shims():
        assert res[key] is True


def test_bf16_ladders_cross_at_half_the_bytes():
    for res in _shims():
        f32 = res["ladder_bytes:torch.float32"]
        assert f32 > 0 and res["ladder_bytes:torch.bfloat16"] * 2 == f32


@pytest.mark.parametrize("method", ["act", "rwmd", "omr", "rwmd_rev", "ict"])
def test_candidate_engines_through_the_exchange(method):
    for res in _shims():
        got, want = res[f"cand:{method}"]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", KS)
def test_topk_on_the_mesh_matches_jax(k):
    s = _scores()
    jv, ji = jc.topk_smallest(jnp.asarray(s), k, 2)
    seen = set()
    for res in _shims():
        q0, v, i = res[f"topk:{k}"]
        np.testing.assert_array_equal(v, np.asarray(jv)[q0:q0 + len(v)])
        np.testing.assert_array_equal(i, np.asarray(ji)[q0:q0 + len(i)])
        seen.add(q0)
    assert seen == {0, 3}
