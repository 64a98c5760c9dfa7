"""Phase-2/3 kernel ``act_phase2``: the LC-ACT water-filling pour over
pre-gathered (cost, capacity) ladders, for a query batch.

Counterpart of the JAX package's
``kernels/act_phase2.py::act_phase2_pallas``. The CUDA kernel is
``csrc/act_phase2.cu``; :func:`act_phase2_plain` is the same function in
plain PyTorch (the per-entry rounds of the JAX kernel's
``pour_entry_costs``), which the CPU path runs and the card is checked
against. x (n, hmax) float32 is shared by all queries; zg (nq, n, hmax,
iters+1) and wg (nq, n, hmax, iters) are float32 or bfloat16 and are read
into float32; t (nq, n) is float32.

``act_phase2_cand`` (K5) is the same pour with a per-query x: the
counterpart of ``act_phase2_cand_pallas``, the unfused candidate pour over
pre-gathered ladders xg (nq, b, hmax), zg (nq, b, hmax, iters+1),
wg (nq, b, hmax, iters) -> t (nq, b). No engine calls it, in the JAX
package or here: the candidate engines use the fused ``cand_pour`` kernel.
It is the same CUDA kernel with x indexed per (query, row).

``act_phase2_gather`` is K2 with the gather fused in, the entry the engine
calls: x (n, hmax), ids (n, hmax) int32 and the Phase-1 ladders
Z (nq, v, iters+1), W (nq, v, >= iters) -> t (nq, n), the value of K2 on
``Z[:, ids]`` and ``W[:, ids, :iters]``. The kernel reads the ladder rows at
the ids itself, so the (nq, n, hmax, k) tensors that the JAX engine
materializes for its TPU kernel never exist; :func:`act_phase2_gather_plain`
is that gather followed by :func:`act_phase2_plain`. The kernel walks each
row only up to its length (:func:`row_lens`: one past its last slot with
x != 0), which changes no bit: the pour skips a slot with x == 0.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

#: K2 launches since the count was last set to 0.
launches = 0

#: K5 (``act_phase2_cand``) launches since the count was last set to 0.
cand_launches = 0

#: Fused-gather K2 (``act_phase2_gather``) launches since the count was
#: last set to 0.
gather_launches = 0

#: Queries whose ladders the plain fused-gather version gathers at once:
#: it bounds the (bq, n, hmax, 2*iters+1) copies as the engines' block_q
#: does.
PLAIN_BLOCK_Q = 8


def act_phase2_plain(x: torch.Tensor, zg: torch.Tensor,
                     wg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the exclusive-prefix pour,
    r_l = clip(x - sum_{u<l} w_u, 0, w_l), round by round, plus the
    remainder max(x - sum_l w_l, 0) at the last cost, summed over hmax in
    float32 (see ``core.lc.pour`` for why the remainder is taken from the
    capacities)."""
    iters = wg.shape[-1]
    acc = torch.zeros(zg.shape[:-1], dtype=torch.float32, device=x.device)
    prefix = torch.zeros_like(acc)
    for l in range(iters):
        w_l = wg[..., l].float()
        r = torch.minimum(torch.clamp_min(x - prefix, 0.0), w_l)
        acc = acc + r * zg[..., l].float()
        prefix = prefix + w_l
    remainder = torch.clamp_min(x - prefix, 0.0)
    return torch.sum(acc + remainder * zg[..., iters].float(), dim=-1)


def act_phase2_cuda(x: torch.Tensor, zg: torch.Tensor,
                    wg: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. The caller
    (``ops.act_phase2_batched``) has checked devices, dtypes, shapes and
    contiguity."""
    global launches
    lib = _lib()
    nq, n, hmax, iters = wg.shape
    t = torch.empty((nq, n), dtype=torch.float32, device=x.device)
    err = lib.act_phase2_launch(
        x.data_ptr(), zg.data_ptr(), wg.data_ptr(), t.data_ptr(), nq, n,
        hmax, iters, int(zg.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise _build.KernelError(f"act_phase2 kernel launch failed: "
                           f"{lib.act_phase2_error(err).decode()}")
    launches += 1
    return t


def act_phase2_cand_plain(xg: torch.Tensor, zg: torch.Tensor,
                          wg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5: the rounds of :func:`act_phase2_plain`
    with a per-query xg (nq, b, hmax), which they broadcast over."""
    return act_phase2_plain(xg, zg, wg)


def act_phase2_cand_cuda(xg: torch.Tensor, zg: torch.Tensor,
                         wg: torch.Tensor) -> torch.Tensor:
    """Launch K5 on the current stream. The caller
    (``ops.act_phase2_cand``) has checked devices, dtypes, shapes and
    contiguity."""
    global cand_launches
    lib = _lib()
    nq, b, hmax, iters = wg.shape
    t = torch.empty((nq, b), dtype=torch.float32, device=xg.device)
    err = lib.act_phase2_cand_launch(
        xg.data_ptr(), zg.data_ptr(), wg.data_ptr(), t.data_ptr(), nq, b,
        hmax, iters, int(zg.dtype == torch.bfloat16),
        torch.cuda.current_stream(xg.device).cuda_stream)
    if err:
        raise _build.KernelError(f"act_phase2_cand kernel launch failed: "
                           f"{lib.act_phase2_error(err).decode()}")
    cand_launches += 1
    return t


def act_phase2_gather_plain(x: torch.Tensor, ids: torch.Tensor,
                            Z: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the fused entry: gather the ladders at the
    ids, then :func:`act_phase2_plain`, ``PLAIN_BLOCK_Q`` queries at a
    time (each query's pour is independent, so the blocks change no
    value)."""
    iters = Z.shape[-1] - 1
    return torch.cat([act_phase2_plain(x, Zb[:, ids], Wb[:, ids, :iters])
                      for Zb, Wb in zip(Z.split(PLAIN_BLOCK_Q),
                                        W.split(PLAIN_BLOCK_Q))])


def row_lens(x: torch.Tensor) -> torch.Tensor:
    """(n,) int32: one past the last slot of each row of x (n, hmax) with
    x != 0, 0 for a row without one."""
    slot = torch.arange(1, x.shape[1] + 1, dtype=torch.int32,
                        device=x.device)
    return torch.where(x != 0, slot, 0).amax(dim=1).to(torch.int32)


def act_phase2_gather_cuda(x: torch.Tensor, ids: torch.Tensor,
                           lens: torch.Tensor, Z: torch.Tensor,
                           W: torch.Tensor, variant=()) -> torch.Tensor:
    """Launch the fused-gather kernel on the current stream; each row is
    walked up to ``lens`` ((n,) int32 in [0, hmax], every slot of x past it
    0: :func:`row_lens`, or hmax for the whole row). The caller
    (``ops.act_phase2_gather``) has checked devices, dtypes, shapes, the
    range of the ids and contiguity, and picked the tile ``variant``
    (``ops.variant``; () for the default tile)."""
    global gather_launches
    lib = _lib(variant)
    n, hmax = x.shape
    nq, v, k = Z.shape
    t = torch.empty((nq, n), dtype=torch.float32, device=x.device)
    assert lens.shape == (n,) and lens.dtype == torch.int32
    err = lib.act_phase2_gather_launch(
        x.data_ptr(), ids.data_ptr(), lens.data_ptr(), Z.data_ptr(),
        W.data_ptr(), t.data_ptr(), nq, n, v, hmax, k - 1, W.shape[2],
        int(Z.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise _build.KernelError(f"act_phase2_gather kernel launch failed: "
                           f"{lib.act_phase2_error(err).decode()}")
    gather_launches += 1
    return t


def gather_attrs(k: int, ws: int, dtype: torch.dtype = torch.float32,
                 variant=()) -> dict:
    """The compiler's figures (``_build.ATTR_KEYS``) for the fused-gather
    kernel a launch with Z rows k = iters + 1 wide and W rows ws wide
    runs, in the tile ``variant``."""
    lib = _lib(variant)
    return _build.func_attrs(lib.act_phase2_gather_attrs, k, ws,
                             int(dtype == torch.bfloat16))


@functools.cache
def _lib(variant=()) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/act_phase2.cu`` with the tile
    ``variant``'s defines."""
    lib = _build.load("act_phase2", dict(variant))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.act_phase2_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.act_phase2_launch.restype = i
    lib.act_phase2_cand_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.act_phase2_cand_launch.restype = i
    lib.act_phase2_gather_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                             i, i, p]
    lib.act_phase2_gather_launch.restype = i
    lib.act_phase2_gather_attrs.argtypes = [i, i, i, p]
    lib.act_phase2_gather_attrs.restype = i
    lib.act_phase2_error.argtypes = [i]
    lib.act_phase2_error.restype = ctypes.c_char_p
    return lib
