"""Phase-1 kernel ``dist_topk``: fused Euclidean distance + row-top-k over a
query batch, without the (nq, v, h) distance tensor ever reaching memory.

Counterpart of the JAX package's ``kernels/dist_topk.py::dist_topk_pallas``.
The CUDA kernel is ``csrc/dist_topk.cu``; :func:`dist_topk_plain` is the
same function in plain PyTorch, which the CPU path runs and the card is
checked against. Contract (both versions):

* d = sqrt(snap(max(|a|^2 + |b|^2 - 2 a.b, 0))) in float32, where snap
  zeroes values below 1e-6 (|a|^2 + |b|^2); the coordinates come in
  float32 or bfloat16 (the ``bf16_agg`` policy), both upcast to float32,
  so the norms and products are float32 on the rounded values;
* identical coordinates give exactly 0: the kernel by summing the norms
  and the products in one FMA order, the plain version by pinning the
  pairs of the same vocabulary id (``qids``) to 0;
* invalid query bins (``qmask`` false) read ``pad_dist_for(out_dtype)``;
* per vocabulary row the k smallest, ascending, ties to the lowest column,
  selected in float32. On a row with fewer than k valid bins the slots past
  them hold the sentinel and S = the lowest column that is invalid or
  already taken (the JAX kernel's masked-min rule);
* Z (nq, v, k) in ``out_dtype`` (cast on the store only), S (nq, v, k) int32.

The CUDA kernel computes the distances of the valid bins only (it packs
them across the batch first); the plain version computes every slot and
masks the invalid ones.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.geometry import pairwise_dist
from repro_torch.core.precision import pad_dist_for
from repro_torch.kernels import _build

#: Largest k the kernel takes (its selection registers are sized at build).
MAX_K = 16

#: Kernel launches since the count was last set to 0.
launches = 0


def dist_topk_plain(coords: torch.Tensor, qcs: torch.Tensor,
                    qmask: torch.Tensor, k: int,
                    out_dtype: torch.dtype = torch.float32,
                    qids: torch.Tensor | None = None, row0: int = 0):
    """Plain PyTorch version of the kernel: materialize the (v, nq, h)
    distances, then k rounds of masked min-extraction with the
    ``out_dtype`` sentinel. coords (v, m), qcs (nq, h, m) float32 or
    bfloat16, qmask (nq, h) bool -> Z (nq, v, k) ``out_dtype``, S (nq, v,
    k) int32. ``qids`` (nq, h): the vocabulary ids of the query bins
    (qcs = coords[qids]); their distances to their own rows are pinned to
    0, where the kernel's FMA order gives 0 by itself. ``row0``: the
    vocabulary id of coords' first row, when coords is a slice of the
    vocabulary (row i is id row0 + i; the mesh's vocabulary shards)."""
    v, _ = coords.shape
    nq, h, m = qcs.shape
    big = pad_dist_for(out_dtype)
    d = pairwise_dist(coords.float(), qcs.reshape(nq * h, m).float())
    if qids is not None:
        # The same-id pin (``pairwise_dist``'s), at the rows this slice
        # holds: bin j's own row is qids[j] - row0.
        rel = qids.reshape(-1).long() - row0
        col = torch.nonzero((rel >= 0) & (rel < v))[:, 0]
        d[rel[col], col] = 0.0
    d = d.reshape(v, nq, h)
    work = torch.where(qmask[None], d, big)
    col = torch.arange(h, dtype=torch.int32, device=coords.device)
    zs, ss = [], []
    for _ in range(k):
        mv = work.amin(dim=-1, keepdim=True)
        mi = torch.where(work == mv, col, 2**31 - 1).amin(dim=-1,
                                                          keepdim=True)
        work = torch.where(col == mi, big, work)
        zs.append(mv)
        ss.append(mi)
    Z = torch.cat(zs, dim=-1).movedim(1, 0).to(out_dtype).contiguous()
    S = torch.cat(ss, dim=-1).movedim(1, 0).to(torch.int32).contiguous()
    return Z, S


def dist_topk_cuda(coords: torch.Tensor, qcs: torch.Tensor,
                   qmask: torch.Tensor, k: int,
                   out_dtype: torch.dtype = torch.float32, variant=()):
    """Launch the CUDA kernel on the current stream: a compaction of the
    valid bins, then the distances and selection over those bins only, in
    blocks of vocabulary rows by groups of queries (the kernel picks the
    groups; a query's output does not depend on its group). The
    caller (``ops.dist_topk_batched``) has checked devices, dtypes, shapes
    and contiguity, and picked the tile ``variant`` (``ops.variant``: its
    ``-D`` defines; () for the default tile)."""
    global launches
    v, m = coords.shape
    nq, h, _ = qcs.shape
    if nq * h >= 2**31:
        raise ValueError(f"nq * h must be below 2^31, got {nq} * {h}")
    lib = _lib(variant)
    z = torch.empty((nq, v, k), dtype=out_dtype, device=coords.device)
    s = torch.empty((nq, v, k), dtype=torch.int32, device=coords.device)
    # Scratch: the flat indices q*h + c of the valid bins, their count and
    # their squared norms.
    packed = torch.empty(nq * h, dtype=torch.int32, device=coords.device)
    count = torch.empty(1, dtype=torch.int32, device=coords.device)
    bnorm = torch.empty(nq * h, dtype=torch.float32, device=coords.device)
    err = lib.dist_topk_launch(
        coords.data_ptr(), qcs.data_ptr(), qmask.data_ptr(),
        packed.data_ptr(), count.data_ptr(), bnorm.data_ptr(), z.data_ptr(),
        s.data_ptr(), nq, v, h, m, k, pad_dist_for(out_dtype),
        int(coords.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(coords.device).cuda_stream)
    if err:
        raise _build.KernelError(f"dist_topk kernel launch failed: "
                           f"{lib.dist_topk_error(err).decode()}")
    launches += 1
    return z, s


def attrs(k: int, in_dtype: torch.dtype = torch.float32,
          out_dtype: torch.dtype = torch.float32, variant=()) -> dict:
    """The compiler's figures (``_build.ATTR_KEYS``) for the kernel that a
    launch at this k and these dtypes runs, in the tile ``variant``."""
    lib = _lib(variant)
    return _build.func_attrs(lib.dist_topk_attrs, k,
                             int(in_dtype == torch.bfloat16),
                             int(out_dtype == torch.bfloat16))


@functools.cache
def _lib(variant=()) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/dist_topk.cu`` with the tile
    ``variant``'s defines."""
    lib = _build.load("dist_topk", dict(variant))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dist_topk_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                     ctypes.c_float, i, i, p]
    lib.dist_topk_launch.restype = i
    lib.dist_topk_attrs.argtypes = [i, i, i, p]
    lib.dist_topk_attrs.restype = i
    lib.dist_topk_error.argtypes = [i]
    lib.dist_topk_error.restype = ctypes.c_char_p
    return lib
