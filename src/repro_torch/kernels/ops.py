"""Public wrappers around the port's kernels.

Each wrapper checks device, dtype, shape and contiguity and raises on what
the kernel does not take. A tensor on the CPU goes to the kernel's plain
PyTorch version; a tensor on a CUDA device launches the CUDA kernel on the
current stream (and raises if the build or the launch fails). There is no
other path.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import act_phase2 as act_k
from repro_torch.kernels import dist_topk as dist_k
from repro_torch.kernels import cand_pour as cand_k

_LADDER_DTYPES = (torch.float32, torch.bfloat16)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors, False for CUDA ones; raises on a mix or on any
    other device."""
    devices = {t.device for t in tensors}
    _require(len(devices) == 1, f"tensors on different devices: {devices}")
    device = devices.pop()
    _require(device.type in ("cpu", "cuda"),
             f"unsupported device {device}; cpu or cuda")
    return device.type == "cpu"


#: Facts of a corpus tensor that the entries reading the corpus rows (the
#: fused K2, K3 on the corpus rows) compute once and keep while it is
#: unchanged: tensor -> {fact: (its version counter then, the value)}. An
#: in-place change bumps the version and so computes them again.
_CORPUS_FACTS = WeakIdKeyDictionary()


def _corpus_fact(t: torch.Tensor, fact: str, compute):
    """``compute(t)``, computed the first time ``t`` is seen (and after it
    changes), looked up after that."""
    facts = _CORPUS_FACTS.get(t)
    if facts is None:
        facts = _CORPUS_FACTS[t] = {}
    seen = facts.get(fact)
    if seen is None or seen[0] != t._version:
        seen = facts[fact] = (t._version, compute(t))
    return seen[1]


def _check_ids_range(ids: torch.Tensor, v: int) -> None:
    """ids must lie in [0, v): a pass and a sync the first time a corpus
    is seen (and after it changes), a lookup after that."""
    lo, hi = _corpus_fact(ids, "range", lambda t: tuple(
        int(e) for e in torch.aminmax(t)))
    _require(0 <= lo and hi < v, f"ids must lie in [0, {v}), got [{lo}, {hi}]")


def _row_lens(x: torch.Tensor) -> torch.Tensor:
    """``act_phase2.row_lens(x)``, kept per corpus weight tensor."""
    return _corpus_fact(x, "row_lens", act_k.row_lens)


def dist_topk_batched(coords: torch.Tensor, qcs: torch.Tensor,
                      qmask: torch.Tensor, k: int, *,
                      out_dtype: torch.dtype = torch.float32,
                      qids: torch.Tensor | None = None, row0: int = 0,
                      block_v: int | None = None,
                      block_h: int | None = None):
    """Fused distance + row-top-k for a query batch in one launch.

    coords (v, m) and qcs (nq, h, m), both float32 or both bfloat16 (the
    ``bf16_agg`` policy's coordinates, upcast to float32 inside), qmask
    (nq, h) bool (true = real query bin) -> Z (nq, v, k) ``out_dtype``
    (float32 or bfloat16), S (nq, v, k) int32. ``1 <= k <= 16``.

    ``qids`` (nq, h) integer, optional: the vocabulary ids of the query
    bins, when qcs = coords[qids]. The plain version pins each bin's
    distance to its own vocabulary row to exactly 0; the kernel gives that
    0 by its FMA order and does not read qids. ``row0``: the vocabulary id
    of coords' first row when coords is a slice of the vocabulary (a mesh's
    vocabulary shard), so that the plain version pins the right pairs.

    ``block_v`` / ``block_h``: the kernel's tile (vocabulary rows a block,
    valid bins a tile; None: the default tile). Every admitted tile gives
    the same bits; the plain version ignores them.
    """
    _require(coords.dim() == 2 and coords.dtype in _LADDER_DTYPES,
             f"coords must be (v, m) float32 or bfloat16, got "
             f"{tuple(coords.shape)} {coords.dtype}")
    _require(qcs.dim() == 3 and qcs.dtype == coords.dtype
             and qcs.shape[2] == coords.shape[1],
             f"qcs must be (nq, h, {coords.shape[1]}) {coords.dtype}, got "
             f"{tuple(qcs.shape)} {qcs.dtype}")
    _require(qmask.dtype == torch.bool and qmask.shape == qcs.shape[:2],
             f"qmask must be {tuple(qcs.shape[:2])} bool, got "
             f"{tuple(qmask.shape)} {qmask.dtype}")
    _require(qids is None or (qids.shape == qmask.shape
                              and not qids.dtype.is_floating_point
                              and qids.dtype != torch.bool),
             f"qids must be {tuple(qmask.shape)} integer ids, got "
             f"{None if qids is None else (tuple(qids.shape), qids.dtype)}")
    _require(min(coords.shape) >= 1 and min(qcs.shape) >= 1,
             "coords and qcs must be non-empty")
    _require(1 <= k <= dist_k.MAX_K,
             f"k must be in [1, {dist_k.MAX_K}], got {k}")
    _require(qcs.shape[0] <= 65535, f"at most 65535 queries, got "
             f"{qcs.shape[0]}")
    _require(out_dtype in _LADDER_DTYPES,
             f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    _require(all(t.is_contiguous() for t in (coords, qcs, qmask)),
             "coords, qcs and qmask must be contiguous")
    var = variant("dist_topk", block_v=block_v, block_h=block_h)
    tensors = (coords, qcs, qmask) + (() if qids is None else (qids,))
    if _on_cpu(*tensors):
        return dist_k.dist_topk_plain(coords, qcs, qmask, k, out_dtype,
                                      qids, row0)
    return dist_k.dist_topk_cuda(coords, qcs, qmask, k, out_dtype, var)


def dist_topk(coords: torch.Tensor, qc: torch.Tensor, qmask: torch.Tensor,
              k: int, *, out_dtype: torch.dtype = torch.float32,
              qids: torch.Tensor | None = None, block_v: int | None = None,
              block_h: int | None = None):
    """Fused distance + row-top-k for one query: coords (v, m), qc (h, m),
    qmask (h,) bool, qids (h,) optional -> Z (v, k), S (v, k). The
    single-query view of :func:`dist_topk_batched` (a batch of one, one
    launch), with its checks."""
    z, s = dist_topk_batched(coords, qc[None], qmask[None], k,
                             out_dtype=out_dtype,
                             qids=None if qids is None else qids[None],
                             block_v=block_v, block_h=block_h)
    return z[0], s[0]


def act_phase2_batched(x: torch.Tensor, zg: torch.Tensor,
                       wg: torch.Tensor) -> torch.Tensor:
    """Fused Phase-2/3 pour for a query batch in one launch.

    x (n, hmax) float32 shared residual weights; zg (nq, n, hmax, iters+1)
    and wg (nq, n, hmax, iters) per-query ladders, both float32 or both
    bfloat16, ``iters >= 1`` -> t (nq, n) float32. Padding slots carry
    zero weight and contribute exactly 0.
    """
    _require(x.dim() == 2 and x.dtype == torch.float32,
             f"x must be (n, hmax) float32, got {tuple(x.shape)} {x.dtype}")
    _require(wg.dim() == 4 and wg.shape[1:3] == x.shape and wg.shape[3] >= 1,
             f"wg must be (nq, {x.shape[0]}, {x.shape[1]}, iters>=1), got "
             f"{tuple(wg.shape)}")
    _require(zg.shape == wg.shape[:3] + (wg.shape[3] + 1,),
             f"zg must be {tuple(wg.shape[:3]) + (wg.shape[3] + 1,)}, got "
             f"{tuple(zg.shape)}")
    _require(zg.dtype == wg.dtype and zg.dtype in _LADDER_DTYPES,
             f"zg and wg must both be float32 or both bfloat16, got "
             f"{zg.dtype} / {wg.dtype}")
    _require(all(t.is_contiguous() for t in (x, zg, wg)),
             "x, zg and wg must be contiguous")
    fn = (act_k.act_phase2_plain if _on_cpu(x, zg, wg)
          else act_k.act_phase2_cuda)
    return fn(x, zg, wg)


def act_phase2(x: torch.Tensor, zg: torch.Tensor,
               wg: torch.Tensor) -> torch.Tensor:
    """Fused Phase-2/3 pour for one query: x (n, hmax), zg (n, hmax,
    iters+1), wg (n, hmax, iters) -> t (n,). The single-query view of
    :func:`act_phase2_batched` (a batch of one, one launch), with its
    checks."""
    return act_phase2_batched(x, zg[None], wg[None])[0]


def act_phase2_gather(x: torch.Tensor, ids: torch.Tensor, Z: torch.Tensor,
                      W: torch.Tensor, *,
                      block_n: int | None = None) -> torch.Tensor:
    """K2 with the gather fused in: the pour of :func:`act_phase2_batched`
    on ``Z[:, ids]`` and ``W[:, ids, :iters]``, without either tensor.

    x (n, hmax) float32 shared residual weights; ids (n, hmax) int32 in
    [0, v); Z (nq, v, iters+1) and W (nq, v, >= iters) Phase-1 ladders,
    both float32 or both bfloat16, ``iters >= 1`` -> t (nq, n) float32.
    ``block_n``: rows (warps) a block (None: the default tile); every
    admitted tile gives the same bits, the plain version ignores it.

    On the card the kernel walks each row only up to its last slot with
    x != 0 (the row lengths are computed once per x tensor and kept while
    it is unchanged), which gives the same bits.
    """
    _require(x.dim() == 2 and x.dtype == torch.float32,
             f"x must be (n, hmax) float32, got {tuple(x.shape)} {x.dtype}")
    _require(ids.shape == x.shape and ids.dtype == torch.int32,
             f"ids must be {tuple(x.shape)} int32, got {tuple(ids.shape)} "
             f"{ids.dtype}")
    _require(Z.dim() == 3 and Z.shape[2] >= 2,
             f"Z must be (nq, v, iters+1) with iters >= 1, got "
             f"{tuple(Z.shape)}")
    _require(W.dim() == 3 and W.shape[:2] == Z.shape[:2]
             and W.shape[2] >= Z.shape[2] - 1,
             f"W must be ({Z.shape[0]}, {Z.shape[1]}, >={Z.shape[2] - 1}), "
             f"got {tuple(W.shape)}")
    _require(Z.dtype == W.dtype and Z.dtype in _LADDER_DTYPES,
             f"Z and W must both be float32 or both bfloat16, got "
             f"{Z.dtype} / {W.dtype}")
    _require(min(x.shape) >= 1 and min(Z.shape[:2]) >= 1,
             "x, ids, Z and W must be non-empty")
    _require(all(t.is_contiguous() for t in (x, ids, Z, W)),
             "x, ids, Z and W must be contiguous")
    var = variant("act_phase2", block_n=block_n)
    on_cpu = _on_cpu(x, ids, Z, W)
    _check_ids_range(ids, Z.shape[1])
    if on_cpu:
        return act_k.act_phase2_gather_plain(x, ids, Z, W)
    return act_k.act_phase2_gather_cuda(x, ids, _row_lens(x), Z, W, var)


def act_phase2_cand(xg: torch.Tensor, zg: torch.Tensor,
                    wg: torch.Tensor) -> torch.Tensor:
    """Candidate-grid Phase-2/3 pour (K5): K2's pour with per-query
    residual weights, on pre-gathered ladders.

    xg (nq, b, hmax) float32; zg (nq, b, hmax, iters+1) and
    wg (nq, b, hmax, iters), both float32 or both bfloat16, ``iters >= 1``
    -> t (nq, b) float32.
    """
    _require(xg.dim() == 3 and xg.dtype == torch.float32,
             f"xg must be (nq, b, hmax) float32, got {tuple(xg.shape)} "
             f"{xg.dtype}")
    _require(wg.dim() == 4 and wg.shape[:3] == xg.shape and wg.shape[3] >= 1,
             f"wg must be {tuple(xg.shape) + ('iters>=1',)}, got "
             f"{tuple(wg.shape)}")
    _require(zg.shape == wg.shape[:3] + (wg.shape[3] + 1,),
             f"zg must be {tuple(wg.shape[:3]) + (wg.shape[3] + 1,)}, got "
             f"{tuple(zg.shape)}")
    _require(zg.dtype == wg.dtype and zg.dtype in _LADDER_DTYPES,
             f"zg and wg must both be float32 or both bfloat16, got "
             f"{zg.dtype} / {wg.dtype}")
    _require(all(t.is_contiguous() for t in (xg, zg, wg)),
             "xg, zg and wg must be contiguous")
    fn = (act_k.act_phase2_cand_plain if _on_cpu(xg, zg, wg)
          else act_k.act_phase2_cand_cuda)
    return fn(xg, zg, wg)


# ------------------------------------------------------ candidate kernels
#
# idsg (nq, b, hmax) int32 and xg (nq, b, hmax) float32 are each query's
# candidate sub-corpus (``corpus.ids[cand]`` / ``corpus.w[cand]``). The ids
# must lie in [0, v): the kernels load at them unchecked, as torch indexing
# would assert.


def _check_cand(idsg: torch.Tensor, xg: torch.Tensor) -> None:
    _require(idsg.dim() == 3 and idsg.dtype == torch.int32,
             f"idsg must be (nq, b, hmax) int32, got {tuple(idsg.shape)} "
             f"{idsg.dtype}")
    _require(xg.shape == idsg.shape and xg.dtype == torch.float32,
             f"xg must be {tuple(idsg.shape)} float32, got "
             f"{tuple(xg.shape)} {xg.dtype}")
    _require(min(idsg.shape) >= 1, "idsg must be non-empty")


def _check_table(name: str, table: torch.Tensor, idsg: torch.Tensor,
                 ndim: int, width: int = 1) -> None:
    nq = idsg.shape[0]
    want = f"({nq}, v)" if ndim == 2 else f"({nq}, v, >={width})"
    _require(table.dim() == ndim and table.shape[0] == nq
             and table.shape[1] >= 1 and (ndim == 2 or
                                          table.shape[2] >= width),
             f"{name} must be {want}, got {tuple(table.shape)}")
    _require(table.dtype in _LADDER_DTYPES,
             f"{name} must be float32 or bfloat16, got {table.dtype}")


def cand_pour(idsg: torch.Tensor, xg: torch.Tensor, Z: torch.Tensor,
              W: torch.Tensor | None, iters: int) -> torch.Tensor:
    """Fused candidate gather + pour (K3, mode ``pour``): LC-ACT
    (``iters >= 1``) and the LC-RWMD nearest-cost dump (``iters == 0``) in
    one launch.

    Z (nq, v, >= iters+1) cost ladder; W (nq, v, >= iters) capacity ladder
    of Z's dtype (``None`` when iters == 0), both float32 or bfloat16
    -> (nq, b) float32 scores at the candidate rows.
    """
    _check_cand(idsg, xg)
    _require(iters >= 0, f"iters must be >= 0, got {iters}")
    _check_table("Z", Z, idsg, 3, iters + 1)
    _require((W is None) == (iters == 0),
             "W must be None exactly when iters == 0")
    tensors = (idsg, xg, Z)
    if W is not None:
        _check_table("W", W, idsg, 3, iters)
        _require(W.shape[1] == Z.shape[1] and W.dtype == Z.dtype,
                 f"W must match Z's vocabulary and dtype, got "
                 f"{tuple(W.shape)} {W.dtype} vs {tuple(Z.shape)} {Z.dtype}")
        tensors += (W,)
    _require(all(t.is_contiguous() for t in tensors),
             "idsg, xg, Z and W must be contiguous")
    if _on_cpu(*tensors):
        return cand_k.cand_pour_plain(idsg, xg, Z, W, iters)
    return cand_k.cand_pour_cuda(idsg, xg, Z, W, iters)


def cand_omr(idsg: torch.Tensor, xg: torch.Tensor, Z: torch.Tensor,
             W0: torch.Tensor) -> torch.Tensor:
    """Fused candidate gather + LC-OMR Algorithm-1 reduction (K3, mode
    ``omr``). Z (nq, v, >= 2) top-2 costs; W0 (nq, v) first capacities of
    Z's dtype -> (nq, b) float32."""
    _check_cand(idsg, xg)
    _check_table("Z", Z, idsg, 3, 2)
    _check_table("W0", W0, idsg, 2)
    _require(W0.shape[1] == Z.shape[1] and W0.dtype == Z.dtype,
             f"W0 must be (nq, {Z.shape[1]}) {Z.dtype}, got "
             f"{tuple(W0.shape)} {W0.dtype}")
    _require(all(t.is_contiguous() for t in (idsg, xg, Z, W0)),
             "idsg, xg, Z and W0 must be contiguous")
    if _on_cpu(idsg, xg, Z, W0):
        return cand_k.cand_omr_plain(idsg, xg, Z, W0)
    return cand_k.cand_pour_cuda(idsg, xg, Z, W0, 1, mode="omr")


def _cand_dist(idsg, xg, Dq, qw, mode, plain):
    _check_cand(idsg, xg)
    _check_table("Dq", Dq, idsg, 3)
    h = Dq.shape[2]
    _require(1 <= h <= cand_k.MAX_H,
             f"Dq's query width must be in [1, {cand_k.MAX_H}], got {h}")
    _require(qw.shape == (idsg.shape[0], h) and qw.dtype == torch.float32,
             f"qw must be ({idsg.shape[0]}, {h}) float32, got "
             f"{tuple(qw.shape)} {qw.dtype}")
    _require(all(t.is_contiguous() for t in (idsg, xg, Dq, qw)),
             "idsg, xg, Dq and qw must be contiguous")
    if _on_cpu(idsg, xg, Dq, qw):
        return plain(idsg, xg, Dq, qw)
    return cand_k.cand_dist_cuda(idsg, xg, Dq, qw, mode)


def cand_rev_min(idsg: torch.Tensor, xg: torch.Tensor, Dq: torch.Tensor,
                 qw: torch.Tensor) -> torch.Tensor:
    """Fused candidate gather + reverse-RWMD masked (min,+) reduction (K4,
    mode ``rev_min``). Dq (nq, v, h) distance handoff, float32 or
    bfloat16; qw (nq, h) float32 query weights -> (nq, b) float32; slots
    with x = 0 mask to the float32 sentinel."""
    return _cand_dist(idsg, xg, Dq, qw, "rev_min",
                      cand_k.cand_rev_min_plain)


def cand_ict(idsg: torch.Tensor, xg: torch.Tensor, Dq: torch.Tensor,
             qw: torch.Tensor) -> torch.Tensor:
    """Fused candidate gather + LC-ICT full-ladder pour (K4, mode
    ``ict``). Dq (nq, v, h), qw (nq, h) as for :func:`cand_rev_min`
    -> (nq, b) float32; the remainder goes to the max finite cost."""
    return _cand_dist(idsg, xg, Dq, qw, "ict", cand_k.cand_ict_plain)


# ------------------------------------- K4 on the valid-bin distance handoff
#
# ids (n, hmax) int32 and w (n, hmax) float32 are the corpus, cand (nq, b)
# int64 each query's candidate rows (``csrc/cand_dist_valid.cu``), or None
# for every row (the all-rows form of the full-corpus engines,
# ``csrc/cand_dist_all.cu``); Dv (v, P), qoff (nq+1,) and qwv (P,) the
# handoff of ``core.lc.phase1_valid_dist``. The ids must lie in
# [0, v): the kernel loads at them unchecked, as the stacked entries do.


def _cand_dist_valid(ids, w, cand, dv, qoff, qwv, mode, plain, block_n):
    var = variant("cand_dist", block_n=block_n)
    _require(ids.dim() == 2 and ids.dtype == torch.int32
             and min(ids.shape) >= 1,
             f"ids must be non-empty (n, hmax) int32, got "
             f"{tuple(ids.shape)} {ids.dtype}")
    _require(w.shape == ids.shape and w.dtype == torch.float32,
             f"w must be {tuple(ids.shape)} float32, got {tuple(w.shape)} "
             f"{w.dtype}")
    _require(qoff.dim() == 1 and qoff.shape[0] >= 2
             and qoff.dtype == torch.int32,
             f"qoff must be (nq+1,) int32 with nq >= 1, got "
             f"{tuple(qoff.shape)} {qoff.dtype}")
    nq = qoff.shape[0] - 1
    if cand is not None:
        _require(cand.dim() == 2 and cand.dtype == torch.int64
                 and cand.shape[0] == nq and cand.shape[1] >= 1,
                 f"cand must be non-empty ({nq}, b) int64, got "
                 f"{tuple(cand.shape)} {cand.dtype}")
    _require(dv.dim() == 2 and dv.shape[0] >= 1 and dv.dtype in _LADDER_DTYPES,
             f"Dv must be (v, P) float32 or bfloat16, got {tuple(dv.shape)} "
             f"{dv.dtype}")
    P = dv.shape[1]
    _require(qwv.shape == (P,) and qwv.dtype == torch.float32,
             f"qwv must be ({P},) float32, got {tuple(qwv.shape)} "
             f"{qwv.dtype}")
    _require(P == 0 or (dv.stride(1) == 1 and dv.stride(0) % 4 == 0
                        and dv.data_ptr() % 16 == 0),
             "Dv's rows must be contiguous, 16-byte aligned, at a row stride "
             f"that is a multiple of 4 (phase1_valid_dist pads it), got "
             f"strides {dv.stride()}")
    tensors = (ids, w, qoff, qwv) + (() if cand is None else (cand,))
    _require(all(t.is_contiguous() for t in tensors),
             "ids, w, cand, qoff and qwv must be contiguous")
    on_cpu = _on_cpu(*tensors, dv)
    if cand is None:
        bounds = qoff.tolist()                                      # a sync
    else:
        *bounds, lo, hi = torch.cat([qoff.long(), torch.stack(      # a sync
            torch.aminmax(cand))]).tolist()
        _require(0 <= lo and hi < ids.shape[0],
                 f"cand must lie in [0, {ids.shape[0]}), got [{lo}, {hi}]")
    lens = [b - a for a, b in zip(bounds, bounds[1:])]
    _require(bounds[0] == 0 and bounds[-1] == P and min(lens) >= 0,
             f"qoff must rise from 0 to {P}, got {bounds}")
    _require(max(lens) <= cand_k.MAX_LEN,
             f"a query has {max(lens)} valid bins; the valid-bin K4 takes "
             f"at most {cand_k.MAX_LEN}")
    if on_cpu:
        return plain(ids, w, cand, dv, qoff, qwv)
    if cand is None:
        return cand_k.cand_dist_all_cuda(
            ids, w, dv, qoff, qwv, mode,
            cand_k.all_rows_plan(bounds, w.device), var)
    return cand_k.cand_dist_valid_cuda(ids, w, cand, dv, qoff, qwv, mode,
                                       var)


def cand_rev_min_valid(ids: torch.Tensor, w: torch.Tensor,
                       cand: torch.Tensor | None, dv: torch.Tensor,
                       qoff: torch.Tensor, qwv: torch.Tensor, *,
                       block_n: int | None = None) -> torch.Tensor:
    """K4 mode ``rev_min`` on the valid-bin handoff: the reverse-RWMD
    masked (min,+) reduction of :func:`cand_rev_min` at the candidate rows
    cand, reading each query's valid bins only -> (nq, b) float32; with
    cand None, at every corpus row -> (nq, n), bitwise the candidate form
    at cand[q] = every row. An empty query scores 0. ``block_n``: rows a
    block (None: the default tile)."""
    return _cand_dist_valid(ids, w, cand, dv, qoff, qwv, "rev_min",
                            cand_k.cand_rev_min_valid_plain, block_n)


def cand_ict_valid(ids: torch.Tensor, w: torch.Tensor,
                   cand: torch.Tensor | None, dv: torch.Tensor,
                   qoff: torch.Tensor, qwv: torch.Tensor, *,
                   block_n: int | None = None) -> torch.Tensor:
    """K4 mode ``ict`` on the valid-bin handoff: the LC-ICT full-ladder
    pour of :func:`cand_ict` at the candidate rows cand -> (nq, b)
    float32; with cand None, at every corpus row -> (nq, n), bitwise the
    candidate form at cand[q] = every row. An empty query scores 0.
    ``block_n``: rows a block (None: the default tile)."""
    return _cand_dist_valid(ids, w, cand, dv, qoff, qwv, "ict",
                            cand_k.cand_ict_valid_plain, block_n)


# ------------------------------------------- K3 on the corpus rows
#
# ids (n, hmax) int32 and w (n, hmax) float32 are the corpus; cand (nq, b)
# int64 each query's candidate rows, or None for every row. The ladders are
# those of ``cand_pour`` / ``cand_omr``.

def _check_rows(ids, w, cand, tables):
    _require(ids.dim() == 2 and ids.dtype == torch.int32
             and min(ids.shape) >= 1,
             f"ids must be non-empty (n, hmax) int32, got "
             f"{tuple(ids.shape)} {ids.dtype}")
    _require(w.shape == ids.shape and w.dtype == torch.float32,
             f"w must be {tuple(ids.shape)} float32, got {tuple(w.shape)} "
             f"{w.dtype}")
    nq = tables[0].shape[0]
    if cand is not None:
        _require(cand.dim() == 2 and cand.dtype == torch.int64
                 and cand.shape[0] == nq and cand.shape[1] >= 1,
                 f"cand must be non-empty ({nq}, b) int64, got "
                 f"{tuple(cand.shape)} {cand.dtype}")
    tensors = (ids, w) + tuple(tables) + (() if cand is None else (cand,))
    _require(all(t.is_contiguous() for t in tensors),
             "ids, w, cand and the ladders must be contiguous")
    on_cpu = _on_cpu(*tensors)
    if cand is not None:
        lo, hi = (int(e) for e in torch.aminmax(cand))   # a pass and a sync
        _require(0 <= lo and hi < ids.shape[0],
                 f"cand must lie in [0, {ids.shape[0]}), got [{lo}, {hi}]")
    _check_ids_range(ids, tables[0].shape[1])
    return on_cpu


def cand_pour_rows(ids: torch.Tensor, w: torch.Tensor,
                   cand: torch.Tensor | None, Z: torch.Tensor,
                   W: torch.Tensor | None, iters: int, *,
                   block_n: int | None = None) -> torch.Tensor:
    """K3 mode ``pour`` reading the candidate rows from the corpus: the
    value of :func:`cand_pour` on ``ids[cand]``, ``w[cand]``, in one launch
    and without either tensor; with cand None, on every corpus row at
    iters=0 only (the full-corpus LC-RWMD dump; ``act_phase2_gather``
    pours every row at iters >= 1).

    Z (nq, v, >= iters+1) cost ladder; W (nq, v, >= iters) capacity ladder
    of Z's dtype (``None`` when iters == 0), both float32 or bfloat16,
    ``0 <= iters <= cand_pour.MAX_ITERS`` -> (nq, b) float32, or (nq, n)
    when cand is None. ``block_n``: rows (warps) a block (None: the
    default tile); every admitted tile gives the same bits.
    """
    var = variant("cand_pour", block_n=block_n)
    _require(0 <= iters <= cand_k.MAX_ITERS,
             f"iters must be in [0, {cand_k.MAX_ITERS}], got {iters}")
    _require(Z.dim() == 3 and min(Z.shape[:2]) >= 1
             and Z.shape[2] >= iters + 1 and Z.dtype in _LADDER_DTYPES,
             f"Z must be non-empty (nq, v, >={iters + 1}) float32 or "
             f"bfloat16, got {tuple(Z.shape)} {Z.dtype}")
    _require((W is None) == (iters == 0),
             "W must be None exactly when iters == 0")
    _require(cand is not None or iters == 0,
             "the all-rows form (cand None) pours at iters == 0 only; "
             "act_phase2_gather pours every row at iters >= 1")
    tables = (Z,)
    if W is not None:
        _require(W.dim() == 3 and W.shape[:2] == Z.shape[:2]
                 and W.shape[2] >= iters and W.dtype == Z.dtype,
                 f"W must be ({Z.shape[0]}, {Z.shape[1]}, >={iters}) "
                 f"{Z.dtype}, got {tuple(W.shape)} {W.dtype}")
        tables += (W,)
    if _check_rows(ids, w, cand, tables):
        return cand_k.cand_pour_rows_plain(ids, w, cand, Z, W, iters)
    return cand_k.cand_pour_rows_cuda(ids, w, cand, Z, W, iters,
                                      variant=var)


def cand_omr_rows(ids: torch.Tensor, w: torch.Tensor,
                  cand: torch.Tensor | None, Z: torch.Tensor,
                  W0: torch.Tensor, *,
                  block_n: int | None = None) -> torch.Tensor:
    """K3 mode ``omr`` reading the candidate rows from the corpus: the
    value of :func:`cand_omr` on ``ids[cand]``, ``w[cand]``; with cand
    None, on every corpus row (full-corpus LC-OMR). Z (nq, v, >= 2) top-2
    costs; W0 (nq, v) first capacities of Z's dtype -> (nq, b) float32, or
    (nq, n) when cand is None. ``block_n`` as for :func:`cand_pour_rows`.
    """
    var = variant("cand_pour", block_n=block_n)
    _require(Z.dim() == 3 and min(Z.shape[:2]) >= 1 and Z.shape[2] >= 2
             and Z.dtype in _LADDER_DTYPES,
             f"Z must be non-empty (nq, v, >=2) float32 or bfloat16, got "
             f"{tuple(Z.shape)} {Z.dtype}")
    _require(W0.shape == Z.shape[:2] and W0.dtype == Z.dtype,
             f"W0 must be {tuple(Z.shape[:2])} {Z.dtype}, got "
             f"{tuple(W0.shape)} {W0.dtype}")
    if _check_rows(ids, w, cand, (Z, W0)):
        return cand_k.cand_omr_rows_plain(ids, w, cand, Z, W0)
    return cand_k.cand_pour_rows_cuda(ids, w, cand, Z, W0, 1, mode="omr",
                                      variant=var)


# ------------------------------------------------------ the launch model
#
# Each kernel family's launch as DATA, evaluated without launching: the
# grid, the threads a block, the shared memory a block holds (by the same
# arithmetic as the kernel's ``Smem`` struct or ``__shared__`` arrays) and
# the ``__launch_bounds__`` it is compiled under. ``repro_torch.analysis.smem``
# turns a layout into sm_90's budget (bytes, registers, threads, blocks on
# an SM), and the tile autotuner (``kernels/autotune``) times only variants
# it admits. A change to a kernel's tiles or shared arrays MUST be
# mirrored here: ``chip_smoke.py`` holds every variant's bytes to
# ``cudaFuncGetAttributes`` on the card.

#: SMs of an H100 SXM: K1 sizes its query groups by the card's count at
#: launch; the model uses this one.
SMS = 132

#: Per family: the entry the engines launch and its source, the tile knobs
#: it takes (``EngineConfig`` knob -> the source's ``-D`` macro) and its
#: default tile (the values the source has without defines). A knob absent
#: from a family has no safe meaning there: a tile may only change which
#: thread or block computes an output, never the order of a float sum.
#:
#: * ``dist_topk`` (K1): vocabulary rows (= threads) per block and packed
#:   valid bins per tile. The per-thread FMA chain over the dimension and
#:   the packed-order selection do not see tile edges.
#: * ``act_phase2``: the fused-gather entry ``act_phase2_gather``; rows
#:   (warps) per block. The 32-lane stride over hmax orders the row's sum,
#:   so ``block_h`` is not a knob here.
#: * ``act_phase2_cand`` (K5): no knob; no engine launches it.
#: * ``cand_pour``: K3's corpus-row entry ``cand_pour_rows``; rows (warps)
#:   per block. Its slots per pass (CH) and queries per warp (QB_ALL)
#:   decide which lane sums which entries. ``block_v`` (the TPU kernel's
#:   one-hot vocabulary slab) has no counterpart: the card loads directly.
#: * ``cand_dist``: K4's valid-bin entry ``cand_dist_valid``; rows per
#:   block (warps in the candidate form; warps, at most 4, each taking
#:   rows on its own, in the all-rows form ``csrc/cand_dist_all.cu``, the
#:   same macro). Its quads per lane (QPL) and slots per pass (CH) order
#:   its sums, which the all-rows form replays; that form's column groups
#:   (GQ, QG) and ring are constants; ``block_v`` as for ``cand_pour``.
FAMILY_ENTRIES = {
    "dist_topk": ("dist_topk_batched", "dist_topk"),
    "act_phase2": ("act_phase2_gather", "act_phase2"),
    "act_phase2_cand": ("act_phase2_cand", "act_phase2"),
    "cand_pour": ("cand_pour_rows", "cand_pour_rows"),
    "cand_dist": ("cand_dist_valid", "cand_dist_valid"),
}


def family_source(family: str, form: str = "cand") -> str:
    """The ``csrc`` source of ``family``'s launch in ``form``: K4's all-rows
    form (``form="all"``) is a kernel of its own, built from the family's
    macros."""
    if (family, form) == ("cand_dist", "all"):
        return "cand_dist_all"
    return FAMILY_ENTRIES[family][1]


TILE_MACROS = {
    "dist_topk": {"block_v": "DIST_TOPK_BV", "block_h": "DIST_TOPK_BH"},
    "act_phase2": {"block_n": "ACT_PHASE2_GATHER_WARPS"},
    "act_phase2_cand": {},
    "cand_pour": {"block_n": "CAND_POUR_ROWS_WARPS"},
    "cand_dist": {"block_n": "CAND_DIST_VALID_WARPS"},
}
DEFAULT_TILES = {
    "dist_topk": {"block_v": 128, "block_h": 64},
    "act_phase2": {"block_n": 8},
    "act_phase2_cand": {},
    "cand_pour": {"block_n": 4},
    "cand_dist": {"block_n": 4},
}

#: Kernels that keep fixed tiles, with the reason: none is on a path the
#: tile knobs reach.
FIXED_TILES = {
    "act_phase2 (csrc/act_phase2.cu act_phase2_kernel, K2 unfused)":
        "256 threads; off the path since the single-query LC-ACT pours "
        "through the fused-gather entry at nq=1",
    "act_phase2_cand (csrc/act_phase2.cu, K5)":
        "256 threads; no engine launches it, in either package",
    "cand_pour (csrc/cand_pour.cu, stacked K3)":
        "256 threads; off the path since K3 reads the corpus rows",
    "cand_dist (csrc/cand_dist.cu, stacked K4)":
        "256 threads; off the path since K4 reads the valid-bin handoff",
}

_DTYPE_BYTES = {"float64": 8, "float32": 4, "int32": 4, "bfloat16": 2}


@dataclasses.dataclass(frozen=True)
class BlockBuffer:
    """One shared-memory array of a block: ``static`` (a ``__shared__``
    array, at most 48 KB in all) or ``dynamic`` (``extern __shared__``,
    requested at launch)."""
    name: str
    shape: tuple[int, ...]
    dtype: str = "float32"
    role: str = "static"

    def __post_init__(self) -> None:
        assert self.role in ("static", "dynamic"), self.role
        assert self.dtype in _DTYPE_BYTES, self.dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * _DTYPE_BYTES[self.dtype]


@dataclasses.dataclass(frozen=True)
class KernelBlocks:
    """Static description of one kernel launch: grid, block, shared
    arrays, ``__launch_bounds__(threads, min_blocks)`` and the registers
    a thread's accumulator tile takes at least (``acc_regs``)."""
    family: str
    kernel: str
    grid: tuple[int, ...]
    threads: int
    buffers: tuple[BlockBuffer, ...]
    min_blocks: int = 1
    acc_regs: int = 0

    @property
    def static_bytes(self) -> int:
        return sum(b.nbytes for b in self.buffers if b.role == "static")

    @property
    def dynamic_bytes(self) -> int:
        return sum(b.nbytes for b in self.buffers if b.role == "dynamic")

    @property
    def smem_bytes(self) -> int:
        """Shared memory a block holds: static plus requested dynamic."""
        return self.static_bytes + self.dynamic_bytes


def _positive(**dims) -> None:
    bad = {k: v for k, v in dims.items() if v < 1}
    if bad:
        raise ValueError(f"kernel dims must be >= 1, got {bad}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tile(family: str, knob: str, value) -> int:
    return DEFAULT_TILES[family][knob] if value is None else value


def _warps(family: str, block_n) -> int:
    warps = _tile(family, "block_n", block_n)
    if not 1 <= warps <= 32:
        raise ValueError(f"{family}: block_n (warps a block) must be in "
                         f"[1, 32], got {warps}")
    return warps


def _dist_topk_layout(*, nq: int, v: int, h: int, m: int, k: int,
                      block_v: int | None = None,
                      block_h: int | None = None) -> KernelBlocks:
    _positive(nq=nq, v=v, h=h, m=m, k=k)
    bv = _tile("dist_topk", "block_v", block_v)
    bh = _tile("dist_topk", "block_h", block_h)
    if bv % 32 or not 32 <= bv <= 1024:
        raise ValueError(f"dist_topk: block_v (threads a block) must be a "
                         f"multiple of 32 in [32, 1024], got {bv}")
    if bh % 32 or bh < 32:
        raise ValueError(f"dist_topk: block_h must be a multiple of 32 "
                         f"(float4 column groups), got {bh}")
    if 8 * bh % bv:
        raise ValueError(f"dist_topk: 8 * block_h must be a multiple of "
                         f"block_v (each thread stages whole columns), got "
                         f"{bh} and {bv}")
    if not 1 <= k <= dist_k.MAX_K:
        raise ValueError(f"dist_topk: k must be in [1, {dist_k.MAX_K}]")
    min_blocks = max(1, 384 // bv)
    gx = _cdiv(v, bv)
    groups = min(nq, max(1, _cdiv(min_blocks * SMS, gx)))
    qpb = _cdiv(nq, groups)
    stages, bk = 4, 8
    return KernelBlocks(
        family="dist_topk", kernel="dist_topk_kernel",
        grid=(gx, _cdiv(nq, qpb)), threads=bv, min_blocks=min_blocks,
        # the 8 x block_h/8 float32 accumulator of a thread
        acc_regs=bh,
        buffers=(
            BlockBuffer("a", (stages, bk, bv + 4), role="dynamic"),
            BlockBuffer("b", (stages, bk, bh + 4), role="dynamic"),
            BlockBuffer("d", (bv, bh + 1), role="dynamic"),
            BlockBuffer("sa2", (bv,), role="dynamic"),
            BlockBuffer("sb2", (bh,), role="dynamic"),
            BlockBuffer("tq", (bh,), "int32", "dynamic"),
            BlockBuffer("tc", (bh,), "int32", "dynamic"),
        ))


def _act_phase2_layout(*, nq: int, n: int, h: int, iters: int,
                       block_n: int | None = None,
                       per_query_x: bool = False) -> KernelBlocks:
    _positive(nq=nq, n=n, h=h)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if per_query_x:
        if block_n is not None:
            raise ValueError("act_phase2_cand (K5) keeps its fixed tile; "
                             "it takes no block_n")
        family, kernel, warps = "act_phase2_cand", "act_phase2_kernel", 8
    else:
        family, kernel = "act_phase2", "act_phase2_gather_kernel"
        warps = _warps("act_phase2", block_n)
    return KernelBlocks(family=family, kernel=kernel,
                        grid=(_cdiv(nq * n, warps),), threads=32 * warps,
                        buffers=())


#: K3's corpus-row entry: slots a lane reads per pass, queries a warp
#: pours in the all-rows form (csrc/cand_pour_rows.cu CH, QB_ALL).
_ROWS_CH, _ROWS_QB = 16, 16
#: K4's valid-bin entry: slots a lane reads per pass (cand_dist_valid CH).
_VALID_CH = 8
#: K4's all-rows form (csrc/cand_dist_all.cu WARPS, STAGES, BATCH of ict):
#: most warps a block, entries in flight a warp (the cp.async ring),
#: entries an ict step.
_ALL_WARPS, _ALL_STAGES, _ALL_BATCH = 4, 4, 2


def _cand_pour_layout(*, nq: int, b: int, h: int, iters: int,
                      mode: str = "pour", form: str = "cand",
                      block_n: int | None = None) -> KernelBlocks:
    """K3's corpus-row entry: ``form="cand"`` at b candidate rows a query,
    ``form="all"`` at every one of b = n corpus rows."""
    _positive(nq=nq, b=b, h=h)
    if mode not in ("pour", "omr") or form not in ("cand", "all"):
        raise ValueError(f"cand_pour: mode must be pour or omr and form "
                         f"cand or all, got {mode!r}, {form!r}")
    if not 0 <= iters <= cand_k.MAX_ITERS:
        raise ValueError(f"cand_pour: iters must be in [0, "
                         f"{cand_k.MAX_ITERS}], got {iters}")
    if form == "all" and mode == "pour" and iters:
        raise ValueError("cand_pour: the all-rows form pours at iters 0")
    warps = _warps("cand_pour", block_n)
    chunks = _cdiv(nq, _ROWS_QB) if form == "all" else nq
    return KernelBlocks(
        family="cand_pour", kernel="cand_pour_rows_kernel",
        grid=(_cdiv(chunks * b, warps),), threads=32 * warps,
        buffers=(BlockBuffer("sx", (warps, 32 * _ROWS_CH)),
                 BlockBuffer("sid", (warps, 32 * _ROWS_CH), "int32")))


def _cand_dist_layout(*, nq: int, b: int, h: int, mode: str = "rev_min",
                      block_n: int | None = None, form: str = "cand",
                      quads: int | None = None,
                      bf16: bool = False) -> KernelBlocks:
    """K4's valid-bin entry: ``form="cand"`` at b candidate rows a query
    (``cand_dist_valid.cu``), ``form="all"`` at every one of b = n corpus
    rows (``cand_dist_all.cu``), whose shared memory follows the launch's
    widest column group, ``quads`` aligned quads (None: the widest nq
    queries of h bins can make, at most GROUP_QUADS), and its cost type
    (``bf16``)."""
    _positive(nq=nq, b=b, h=h)
    if mode not in ("rev_min", "ict") or form not in ("cand", "all"):
        raise ValueError(f"cand_dist: mode must be rev_min or ict and form "
                         f"cand or all, got {mode!r}, {form!r}")
    rows = _warps("cand_dist", block_n)
    ict = mode == "ict"
    if form == "all":
        if quads is None:
            quads = min(cand_k.GROUP_QUADS, nq * (_cdiv(h, 4) + 1))
        if not 0 <= quads <= cand_k.GROUP_QUADS:
            raise ValueError(f"cand_dist: a column group spans at most "
                             f"{cand_k.GROUP_QUADS} quads, got {quads}")
        groups = _cdiv(nq, cand_k.GROUP_QUERIES)   # the fewest a plan makes
        warps, batch = min(rows, _ALL_WARPS), _ALL_BATCH
        qg = cand_k.GROUP_QUERIES
        parts = (warps, batch, 32)        # (entry, chunk) partials
        top2 = parts + (2,)               # their two least costs, columns
        # csrc/cand_dist_all.cu's Layout, in its order; all dynamic, every
        # array a warp's own.
        dyn = functools.partial(BlockBuffer, role="dynamic")
        ring = dyn("ring", (warps, _ALL_STAGES, 4 * quads),
                   "bfloat16" if bf16 else "float32")
        table = (dyn("table", (warps, 4 * qg + 4), "int32"),
                 dyn("sid", (warps, 32 * _VALID_CH), "int32"))
        buffers = ((dyn("accs", (warps, qg, 32), "float64"),
                    dyn("cont", (warps, batch, qg), "float64"), ring,
                    *table, dyn("sx", (warps, 32 * _VALID_CH)),
                    dyn("pbest", top2), dyn("parg", top2, "int32"),
                    dyn("pmax", parts)) if ict else (ring, *table))
        # One warp a (group, row) work item; the launch caps the grid at
        # the blocks the card holds at once.
        return KernelBlocks(
            family="cand_dist", kernel="cand_dist_all_kernel",
            grid=(_cdiv(groups * b, warps),), threads=32 * warps,
            buffers=buffers)
    # The queue's weights are read by the ict pour only: in rev_min the
    # compiler drops sx.
    queue = (BlockBuffer("sx", (rows, 32 * _VALID_CH)),) * ict
    return KernelBlocks(
        family="cand_dist", kernel="cand_dist_valid_kernel",
        grid=(_cdiv(nq * b, rows),), threads=32 * rows,
        buffers=queue + (BlockBuffer("sid", (rows, 32 * _VALID_CH),
                                     "int32"),))


#: family name -> layout function: the surface ``analysis.smem`` and the
#: autotuner iterate (the JAX package's five family names).
KERNEL_FAMILIES = {
    "dist_topk": _dist_topk_layout,
    "act_phase2": _act_phase2_layout,
    "act_phase2_cand": functools.partial(_act_phase2_layout,
                                         per_query_x=True),
    "cand_pour": _cand_pour_layout,
    "cand_dist": _cand_dist_layout,
}


def block_layout(family: str, **dims) -> KernelBlocks:
    """Static launch layout of one kernel launch (see
    :data:`KERNEL_FAMILIES` for the per-family dim kwargs)."""
    if family not in KERNEL_FAMILIES:
        raise ValueError(f"unknown kernel family {family!r}; "
                         f"one of {sorted(KERNEL_FAMILIES)}")
    return KERNEL_FAMILIES[family](**dims)


@functools.cache
def _admitted(family: str, tiles: tuple) -> None:
    from repro_torch.analysis import smem
    bad = smem.check_tiles(family, dict(tiles))
    if bad:
        raise ValueError(f"{family} tile {dict(tiles)} is not admitted: "
                         + "; ".join(v.message for v in bad))


def variant(family: str, **tiles) -> tuple:
    """The ``-D`` defines of ``family``'s variant at ``tiles`` (None or
    the default: the default variant, no defines), as a hashable tuple of
    (macro, value); raises ``ValueError`` if the budget model
    (``analysis.smem``) does not admit the tile, so such a variant is
    never built."""
    macros = TILE_MACROS[family]
    unknown = set(tiles) - set(macros)
    if unknown:
        raise ValueError(f"{family} takes the tile knobs {sorted(macros)}, "
                         f"not {sorted(unknown)}")
    picked = tuple(sorted((k, v) for k, v in tiles.items()
                          if v is not None and v != DEFAULT_TILES[family][k]))
    if not picked:
        return ()
    _admitted(family, picked)
    return tuple(sorted((macros[k], v) for k, v in picked))
