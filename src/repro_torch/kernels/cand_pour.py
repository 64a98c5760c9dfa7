"""Candidate kernels of the cascade: a per-query gather at each candidate
row's entry ids fused with its Phase-2/3 reduction, for a query batch.

Counterparts of the JAX package's ``kernels/cand_pour.py``:

* ``cand_pour`` (K3, ``cand_pour_pallas``; CUDA ``csrc/cand_pour.cu``)
  gathers rows of the per-query Phase-1 ladders Z (nq, v, >=k) and
  W (nq, v, >=iters), two tensors with their own row widths, and runs
  mode ``pour`` (``lc.pour``; at iters=0 the nearest-cost dump
  sum x * Z0) or mode ``omr`` (the Algorithm-1 top-2 reduction).
* ``cand_dist`` (K4, ``cand_dist_pallas``; CUDA ``csrc/cand_dist.cu``)
  gathers (hmax, h) cost rows of the query-major distance handoff
  Dq (nq, v, h) and runs mode ``rev_min`` (masked min over hmax, then a
  multiply by q_w and a sum over h) or mode ``ict`` (``lc.ict_pour``: the
  full sorted ladder, ties to the lower query bin, the remainder dumped
  at the max finite cost).
* ``cand_dist_valid`` (K4 on the valid-bin handoff; CUDA
  ``csrc/cand_dist_valid.cu``) is the same function as ``cand_dist`` on
  the layout ``core.lc.phase1_valid_dist`` writes: Dv (v, P) holds only
  the batch's P valid query bins, query q owning columns
  [qoff[q], qoff[q+1]), with their weights qwv (P,). It reads the
  candidate rows from the corpus (ids, w) at cand (nq, b) itself. When
  cand is None (the all-rows form, (nq, n) out: the full-corpus
  ``rwmd_rev`` and ``ict`` engines) the card runs ``csrc/cand_dist_all.cu``
  instead, which reads each corpus row once for a column group of
  queries (:func:`column_groups`) and gives the candidate kernel's bits at
  cand[q] = every row. An empty query scores 0, as its padded bins add
  exactly 0 on the stacked handoff. This is the entry the engines call.
* ``cand_pour_rows`` (K3 reading the corpus rows itself; CUDA
  ``csrc/cand_pour_rows.cu``) is ``cand_pour`` on the corpus (ids, w) at
  the candidate rows cand (nq, b), or at every row when cand is None (the
  all-rows form, (nq, n) out, at iters=0 and in mode omr only: the
  full-corpus LC-RWMD dump and LC-OMR).
  This is the entry the engines call.

idsg (nq, b, hmax) int32 and xg (nq, b, hmax) float32 are the candidates'
sub-corpus (``corpus.ids[cand]``, ``corpus.w[cand]``); padding slots carry
weight 0 and contribute exactly 0. Ladders and handoffs are float32 or
bfloat16 and are read into float32; the output (nq, b) is float32.

The ``*_plain`` functions are the same functions in plain PyTorch, built
from the engines' own reductions in ``core.lc`` as the JAX kernels are;
the CPU path runs them and the card is checked against them. The gather
here is a plain index: the TPU kernels' one-hot matmul gather is a TPU
idiom that the CUDA kernels replace with direct loads.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import lc
from repro_torch.core.precision import pad_dist_for
from repro_torch.kernels import _build

#: Kernel launches by mode since the counts were last set to 0: ``pour``
#: (iters >= 1), ``pour0`` (mode pour at iters=0, the LC-RWMD dump) and
#: ``omr`` launch K3, ``rev_min`` and ``ict`` launch K4.
launches = {"pour": 0, "pour0": 0, "omr": 0, "rev_min": 0, "ict": 0}

#: Largest query width h that K4 takes: each lane of a warp holds h/32
#: costs of an entry in registers, at most 32.
MAX_H = 1024

#: Launches of K4's valid-bin entry since the counts were last set to 0:
#: the candidate form by mode and the all-rows form (``all_rev_min``,
#: ``all_ict``).
valid_launches = {"rev_min": 0, "ict": 0, "all_rev_min": 0, "all_ict": 0}

#: Most valid bins a query may have on the valid-bin K4: a lane holds 8
#: aligned quads of an entry's costs, and 1,020 columns touch at most 256
#: quads, 8 for each of 32 lanes, whatever their alignment.
MAX_LEN = 1020

#: K4's all-rows form (``csrc/cand_dist_all.cu`` GQ, QG): the aligned quads
#: a column group spans at most (1,024 columns, so a query of MAX_LEN
#: columns fits alone at any alignment) and the queries it holds at most.
GROUP_QUADS = 256
GROUP_QUERIES = 16

#: Launches of K3's corpus-row entry since the counts were last set to 0:
#: the candidate form by mode (``pour``, ``pour0`` = pour at iters=0,
#: ``omr``) and the all-rows form (``all_pour0``, ``all_omr``; it takes no
#: pour at iters >= 1, which the engines send to the fused K2).
rows_launches = {"pour": 0, "pour0": 0, "omr": 0, "all_pour0": 0,
                 "all_omr": 0}

#: Most pour rounds K3's corpus-row entry takes: a lane holds an entry's
#: iters+1 costs and iters capacities in registers, at most 16 and 15 (K1
#: selects at most 16 per row).
MAX_ITERS = 15

_MODES = {"pour": 0, "omr": 1, "rev_min": 0, "ict": 1}


def gather_rows(A: torch.Tensor, idsg: torch.Tensor) -> torch.Tensor:
    """A (nq, v, ...) at each query's own ids idsg (nq, b, hmax)
    -> (nq, b, hmax, ...), bitwise (a plain index)."""
    return lc.gather_per_query(A, idsg)


def cand_pour_plain(idsg: torch.Tensor, xg: torch.Tensor, Z: torch.Tensor,
                    W: torch.Tensor | None, iters: int) -> torch.Tensor:
    """Plain PyTorch version of K3, mode ``pour``: ``lc.pour`` on the
    float32 upcast of the gathered ladders (at iters=0, sum x * Z0)."""
    zg = gather_rows(Z, idsg)[..., :iters + 1].float()
    if iters == 0:
        return torch.sum(xg * zg[..., 0], dim=-1)
    wg = gather_rows(W, idsg)[..., :iters].float()
    return lc.pour(xg, zg, wg, iters)


def cand_omr_plain(idsg: torch.Tensor, xg: torch.Tensor, Z: torch.Tensor,
                   W0: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3, mode ``omr``."""
    zg = gather_rows(Z, idsg)[..., :2].float()
    return lc.omr_entries(xg, zg, gather_rows(W0, idsg).float())


def cand_rev_min_plain(idsg: torch.Tensor, xg: torch.Tensor,
                       dq: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4, mode ``rev_min``, one query at a time
    and in row chunks of at most ``lc.GATHER_ELEMS`` gathered costs."""
    return lc.reduce_dist_rows(lc.rev_min_sum, dq, qw, idsg, xg, 1)


def cand_ict_plain(idsg: torch.Tensor, xg: torch.Tensor, dq: torch.Tensor,
                   qw: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4, mode ``ict``, one query at a time and
    in row chunks of at most ``lc.GATHER_ELEMS`` gathered costs (the sort
    of a whole 20 Newsgroups-width block does not fit the card)."""
    return lc.reduce_dist_rows(lc.ict_reduce, dq, qw, idsg, xg, 1)


def _reduce_valid(reduce, ids, w, cand, dv, qoff, qwv):
    """``lc.reduce_dist_rows(reduce, ...)`` one query at a time on the
    query's (v, len_q) slice of Dv and its weights, at its candidate rows
    (every row when cand is None); an empty query scores 0."""
    bounds = qoff.tolist()
    nq = len(bounds) - 1
    out = torch.zeros((nq, ids.shape[0] if cand is None else cand.shape[1]),
                      dtype=torch.float32, device=w.device)
    for q, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        if hi > lo:
            idsg, xg = ((ids[None], w[None]) if cand is None
                        else (ids[cand[q:q + 1]], w[cand[q:q + 1]]))
            out[q] = lc.reduce_dist_rows(reduce, dv[None, :, lo:hi],
                                         qwv[None, lo:hi], idsg, xg, 1)[0]
    return out


def cand_rev_min_valid_plain(ids: torch.Tensor, w: torch.Tensor,
                             cand: torch.Tensor, dv: torch.Tensor,
                             qoff: torch.Tensor,
                             qwv: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the valid-bin K4, mode ``rev_min``: the
    reduction of :func:`cand_rev_min_plain` on each query's valid bins."""
    return _reduce_valid(lc.rev_min_sum, ids, w, cand, dv, qoff, qwv)


def cand_ict_valid_plain(ids: torch.Tensor, w: torch.Tensor,
                         cand: torch.Tensor, dv: torch.Tensor,
                         qoff: torch.Tensor,
                         qwv: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the valid-bin K4, mode ``ict``: the
    reduction of :func:`cand_ict_plain` on each query's valid bins."""
    return _reduce_valid(lc.ict_reduce, ids, w, cand, dv, qoff, qwv)


def column_groups(bounds) -> tuple[list[int], int]:
    """Plan K4's all-rows launch from qoff's values ``bounds`` (nq + 1
    ints): runs of whole queries, in order, of at most GROUP_QUERIES
    queries whose valid columns span at most GROUP_QUADS aligned quads,
    from the first non-empty query's first quad to the last one's last.
    An empty query takes no column. Returns (the first query of each group
    followed by nq, the quads of the widest group)."""
    nq = len(bounds) - 1
    starts, widest = [0], 0
    first = last = None                        # the open group's quads
    for q in range(nq):
        lo, hi = bounds[q], bounds[q + 1]
        full = q - starts[-1] == GROUP_QUERIES or (
            hi > lo and first is not None
            and (hi - 1) // 4 - first + 1 > GROUP_QUADS)
        if full:
            widest = max(widest, 0 if first is None else last - first + 1)
            starts.append(q)
            first = last = None
        if hi > lo:
            first = lo // 4 if first is None else first
            last = (hi - 1) // 4
    widest = max(widest, 0 if first is None else last - first + 1)
    return starts + [nq], widest


def _rows_blocks(fn, ids, w, cand, tables, width):
    """``fn(idsg, xg, *tables)`` one query at a time on the query's rows of
    the corpus (every row when cand is None), in row chunks of at most
    ``lc.GATHER_ELEMS`` gathered ladder values -> (nq, b or n) float32."""
    nq = tables[0].shape[0]
    b = ids.shape[0] if cand is None else cand.shape[1]
    rows = max(1, lc.GATHER_ELEMS // (ids.shape[1] * width))
    out = torch.empty((nq, b), dtype=torch.float32, device=w.device)
    for q in range(nq):
        tq = [t[q:q + 1] for t in tables]
        for r in range(0, b, rows):
            sel = (slice(r, r + rows) if cand is None
                   else cand[q, r:r + rows])
            out[q, r:r + rows] = fn(ids[sel][None], w[sel][None], *tq)[0]
    return out


def cand_pour_rows_plain(ids: torch.Tensor, w: torch.Tensor,
                         cand: torch.Tensor | None, Z: torch.Tensor,
                         W: torch.Tensor | None, iters: int) -> torch.Tensor:
    """Plain PyTorch version of K3's corpus-row entry, mode ``pour``:
    :func:`cand_pour_plain` on ``ids[cand]``, ``w[cand]`` (every row when
    cand is None), gathered in blocks."""
    tables = (Z,) if W is None else (Z, W)
    return _rows_blocks(
        lambda idsg, xg, z, wt=None: cand_pour_plain(idsg, xg, z, wt, iters),
        ids, w, cand, tables, 2 * iters + 1)


def cand_omr_rows_plain(ids: torch.Tensor, w: torch.Tensor,
                        cand: torch.Tensor | None, Z: torch.Tensor,
                        W0: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3's corpus-row entry, mode ``omr``:
    :func:`cand_omr_plain` on ``ids[cand]``, ``w[cand]`` (every row when
    cand is None), gathered in blocks."""
    return _rows_blocks(cand_omr_plain, ids, w, cand, (Z, W0), 3)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def cand_pour_cuda(idsg: torch.Tensor, xg: torch.Tensor, Z: torch.Tensor,
                   W: torch.Tensor | None, iters: int,
                   mode: str = "pour") -> torch.Tensor:
    """Launch K3 on the current stream. ``mode="omr"`` takes W = W0
    (nq, v). The caller (``ops.cand_pour`` / ``ops.cand_omr``) has checked
    devices, dtypes, shapes and contiguity."""
    lib = _lib("cand_pour")
    nq, b, hmax = idsg.shape
    v, kz = Z.shape[1], Z.shape[2]
    kw = 0 if W is None else (1 if W.dim() == 2 else W.shape[2])
    t = torch.empty((nq, b), dtype=torch.float32, device=xg.device)
    err = lib.cand_pour_launch(
        idsg.data_ptr(), xg.data_ptr(), Z.data_ptr(),
        0 if W is None else W.data_ptr(), t.data_ptr(), nq, b, hmax, v, kz,
        kw, iters, _MODES[mode], int(Z.dtype == torch.bfloat16), _stream(xg))
    if err:
        raise _build.KernelError(f"cand_pour kernel launch failed: "
                           f"{lib.cand_pour_error(err).decode()}")
    launches["pour0" if mode == "pour" and iters == 0 else mode] += 1
    return t


def cand_dist_cuda(idsg: torch.Tensor, xg: torch.Tensor, dq: torch.Tensor,
                   qw: torch.Tensor, mode: str) -> torch.Tensor:
    """Launch K4 on the current stream. The caller (``ops.cand_rev_min`` /
    ``ops.cand_ict``) has checked devices, dtypes, shapes and
    contiguity."""
    lib = _lib("cand_dist")
    nq, b, hmax = idsg.shape
    v, h = dq.shape[1], dq.shape[2]
    t = torch.empty((nq, b), dtype=torch.float32, device=xg.device)
    err = lib.cand_dist_launch(
        idsg.data_ptr(), xg.data_ptr(), dq.data_ptr(), qw.data_ptr(),
        t.data_ptr(), nq, b, hmax, v, h, pad_dist_for(torch.float32),
        _MODES[mode], int(dq.dtype == torch.bfloat16), _stream(xg))
    if err:
        raise _build.KernelError(f"cand_dist kernel launch failed: "
                           f"{lib.cand_dist_error(err).decode()}")
    launches[mode] += 1
    return t


def cand_dist_valid_cuda(ids: torch.Tensor, w: torch.Tensor,
                         cand: torch.Tensor, dv: torch.Tensor,
                         qoff: torch.Tensor, qwv: torch.Tensor,
                         mode: str, variant=()) -> torch.Tensor:
    """Launch the valid-bin K4 on the current stream at the candidate rows
    cand. The caller (``ops.cand_rev_min_valid`` / ``ops.cand_ict_valid``)
    has checked devices, dtypes, shapes, strides, the range of cand and
    qoff, and that no query has more than MAX_LEN valid bins, and picked
    the tile ``variant`` (``ops.variant``; () for the default tile)."""
    lib = _lib("cand_dist_valid", variant)
    nq, b = cand.shape
    t = torch.empty((nq, b), dtype=torch.float32, device=w.device)
    err = lib.cand_dist_valid_launch(
        ids.data_ptr(), w.data_ptr(), cand.data_ptr(), dv.data_ptr(),
        qoff.data_ptr(), qwv.data_ptr(), t.data_ptr(), nq, b, ids.shape[1],
        dv.stride(0), pad_dist_for(torch.float32), _MODES[mode],
        int(dv.dtype == torch.bfloat16), _stream(w))
    if err:
        raise _build.KernelError(f"cand_dist_valid kernel launch failed: "
                           f"{lib.cand_dist_valid_error(err).decode()}")
    valid_launches[mode] += 1
    return t


def all_rows_plan(bounds, device) -> tuple[torch.Tensor, int]:
    """:func:`column_groups` of qoff's values ``bounds`` as the all-rows
    kernel takes it: (the groups' first queries, nq and the kernel's two
    work counters (0; the kernel leaves them 0, so a plan serves any
    number of launches in stream order), int32 on ``device``; the quads
    of the widest group)."""
    starts, widest = column_groups(bounds)
    return (torch.tensor(starts + [0, 0], dtype=torch.int32, device=device),
            widest)


def cand_dist_all_cuda(ids: torch.Tensor, w: torch.Tensor, dv: torch.Tensor,
                       qoff: torch.Tensor, qwv: torch.Tensor, mode: str,
                       plan, variant=()) -> torch.Tensor:
    """Launch K4's all-rows form (``csrc/cand_dist_all.cu``) on the current
    stream: every corpus row against the batch -> (nq, n) float32, bitwise
    the candidate kernel at cand[q] = every row. ``plan``: the launch's
    :func:`all_rows_plan`. The caller (``ops.cand_rev_min_valid`` /
    ``ops.cand_ict_valid`` with cand None) has checked devices, dtypes,
    shapes, strides, qoff, and that no query has more than MAX_LEN valid
    bins, and picked the tile ``variant`` (``ops.variant``; () for the
    default tile)."""
    lib = _lib("cand_dist_all", variant)
    groups, widest = plan
    nq, (n, hmax) = qoff.shape[0] - 1, ids.shape
    t = torch.empty((nq, n), dtype=torch.float32, device=w.device)
    err = lib.cand_dist_all_launch(
        ids.data_ptr(), w.data_ptr(), dv.data_ptr(), qoff.data_ptr(),
        qwv.data_ptr(), groups.data_ptr(), t.data_ptr(), n, hmax,
        dv.stride(0), groups.shape[0] - 3, widest,
        pad_dist_for(torch.float32), _MODES[mode],
        int(dv.dtype == torch.bfloat16), _stream(w))
    if err:
        raise _build.KernelError(f"cand_dist_all kernel launch failed: "
                           f"{lib.cand_dist_all_error(err).decode()}")
    valid_launches[f"all_{mode}"] += 1
    return t


def cand_pour_rows_cuda(ids: torch.Tensor, w: torch.Tensor,
                        cand: torch.Tensor | None, Z: torch.Tensor,
                        W: torch.Tensor | None, iters: int,
                        mode: str = "pour", variant=()) -> torch.Tensor:
    """Launch K3's corpus-row entry on the current stream. ``mode="omr"``
    takes W = W0 (nq, v). The all-rows form reads the ladders from a
    vocabulary-major (v, nq, k) copy made here: one id's values for the
    whole batch are adjacent, so one load instruction reads them for 16
    queries (on the H100 this beat reading the query-major ladders as
    given, PERF.md); the candidate form reads them as given. The caller
    (``ops.cand_pour_rows`` / ``ops.cand_omr_rows``) has checked devices,
    dtypes, shapes, contiguity, the ranges of ids and cand, and that the
    all-rows form gets no pour at iters >= 1, and picked the tile
    ``variant`` (``ops.variant``; () for the default tile)."""
    lib = _lib("cand_pour_rows", variant)
    omr = mode == "omr"
    nq, n, hmax = Z.shape[0], ids.shape[0], ids.shape[1]
    # The kernel reads element (q, id, l) at q * stride(0) + id * stride(1)
    # + l of these (nq, v, k) views.
    zk = Z[..., :2 if omr else iters + 1]
    wk = None if W is None else (W[..., None] if omr else W[..., :iters])
    if cand is None:
        zk, wk = (None if t is None else
                  t.transpose(0, 1).contiguous().transpose(0, 1)
                  for t in (zk, wk))
    cols = n if cand is None else cand.shape[1]
    t = torch.empty((nq, cols), dtype=torch.float32, device=w.device)
    err = lib.cand_pour_rows_launch(
        ids.data_ptr(), w.data_ptr(), 0 if cand is None else cand.data_ptr(),
        zk.data_ptr(), 0 if wk is None else wk.data_ptr(), zk.stride(0),
        zk.stride(1), 0 if wk is None else wk.stride(0),
        0 if wk is None else wk.stride(1), t.data_ptr(), nq, cols, hmax,
        iters, _MODES[mode], int(Z.dtype == torch.bfloat16), _stream(w))
    if err:
        raise _build.KernelError(f"cand_pour_rows kernel launch failed: "
                           f"{lib.cand_pour_rows_error(err).decode()}")
    key = "pour0" if mode == "pour" and iters == 0 else mode
    rows_launches[key if cand is not None else f"all_{key}"] += 1
    return t


def rows_attrs(mode: str, iters: int, all_rows: bool,
               dtype: torch.dtype = torch.float32, variant=()) -> dict:
    """The compiler's figures (``_build.ATTR_KEYS``) for the kernel that
    K3's corpus-row entry runs in this mode at this iters, in the
    candidate or the all-rows form, in the tile ``variant``."""
    lib = _lib("cand_pour_rows", variant)
    return _build.func_attrs(lib.cand_pour_rows_attrs, _MODES[mode], iters,
                             int(all_rows), int(dtype == torch.bfloat16))


def valid_attrs(mode: str, dtype: torch.dtype = torch.float32,
                variant=()) -> dict:
    """The compiler's figures (``_build.ATTR_KEYS``) for the kernel that
    K4's valid-bin entry runs in this mode, in the tile ``variant``."""
    lib = _lib("cand_dist_valid", variant)
    return _build.func_attrs(lib.cand_dist_valid_attrs, _MODES[mode],
                             int(dtype == torch.bfloat16))


def all_attrs(mode: str, widest: int, dtype: torch.dtype = torch.float32,
              variant=()) -> dict:
    """The compiler's figures (``_build.ATTR_KEYS``) for the kernel that
    K4's all-rows form runs in this mode, its dynamic shared bytes at a
    widest column group of ``widest`` quads, in the tile ``variant``."""
    lib = _lib("cand_dist_all", variant)
    return _build.func_attrs(lib.cand_dist_all_attrs, _MODES[mode],
                             int(dtype == torch.bfloat16), widest)


@functools.cache
def _lib(name: str, variant=()) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<name>.cu`` with the tile
    ``variant``'s defines."""
    lib = _build.load(name, dict(variant))
    p, i = ctypes.c_void_p, ctypes.c_int
    launch, error = getattr(lib, f"{name}_launch"), getattr(lib,
                                                            f"{name}_error")
    if name == "cand_pour":
        launch.argtypes = [p, p, p, p, p] + [i] * 9 + [p]
    elif name == "cand_dist_valid":
        launch.argtypes = [p] * 7 + [i] * 4 + [ctypes.c_float, i, i, p]
    elif name == "cand_pour_rows":
        launch.argtypes = [p] * 5 + [ctypes.c_longlong] * 4 + [p] + [i] * 6 \
            + [p]
    elif name == "cand_dist_all":
        launch.argtypes = [p] * 7 + [i] * 5 + [ctypes.c_float, i, i, p]
    else:
        launch.argtypes = [p, p, p, p, p] + [i] * 5 + [ctypes.c_float, i, i,
                                                       p]
    launch.restype = i
    if name == "cand_pour_rows":
        lib.cand_pour_rows_attrs.argtypes = [i, i, i, i, p]
        lib.cand_pour_rows_attrs.restype = i
    elif name == "cand_dist_valid":
        lib.cand_dist_valid_attrs.argtypes = [i, i, p]
        lib.cand_dist_valid_attrs.restype = i
    elif name == "cand_dist_all":
        lib.cand_dist_all_attrs.argtypes = [i, i, i, p]
        lib.cand_dist_all_attrs.restype = i
    error.argtypes = [i]
    error.restype = ctypes.c_char_p
    return lib

