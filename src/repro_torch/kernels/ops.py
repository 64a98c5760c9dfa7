"""Public wrappers around the port's kernels.

Each wrapper checks device, dtype, shape and contiguity and raises on what
the kernel does not take. A tensor on the CPU goes to the kernel's plain
PyTorch version; a tensor on a CUDA device launches the CUDA kernel on the
current stream (and raises if the build or the launch fails). There is no
other path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import act_phase2, dist_topk

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


def dist_topk_batched(coords: torch.Tensor, qcs: torch.Tensor,
                      qmask: torch.Tensor, k: int, *,
                      out_dtype: torch.dtype = torch.float32):
    """Fused distance + row-top-k for a query batch in one launch.

    coords (v, m) float32, qcs (nq, h, m) float32, qmask (nq, h) bool (true
    = real query bin) -> Z (nq, v, k) ``out_dtype`` (float32 or bfloat16),
    S (nq, v, k) int32. ``1 <= k <= 16``.
    """
    _require(coords.dim() == 2 and coords.dtype == torch.float32,
             f"coords must be (v, m) float32, got {tuple(coords.shape)} "
             f"{coords.dtype}")
    _require(qcs.dim() == 3 and qcs.dtype == torch.float32
             and qcs.shape[2] == coords.shape[1],
             f"qcs must be (nq, h, {coords.shape[1]}) float32, got "
             f"{tuple(qcs.shape)} {qcs.dtype}")
    _require(qmask.dtype == torch.bool and qmask.shape == qcs.shape[:2],
             f"qmask must be {tuple(qcs.shape[:2])} bool, got "
             f"{tuple(qmask.shape)} {qmask.dtype}")
    _require(min(coords.shape) >= 1 and min(qcs.shape) >= 1,
             "coords and qcs must be non-empty")
    _require(1 <= k <= dist_topk.MAX_K,
             f"k must be in [1, {dist_topk.MAX_K}], got {k}")
    _require(qcs.shape[0] <= 65535, f"at most 65535 queries, got "
             f"{qcs.shape[0]}")
    _require(out_dtype in _LADDER_DTYPES,
             f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    _require(all(t.is_contiguous() for t in (coords, qcs, qmask)),
             "coords, qcs and qmask must be contiguous")
    fn = (dist_topk.dist_topk_plain if _on_cpu(coords, qcs, qmask)
          else dist_topk.dist_topk_cuda)
    return fn(coords, qcs, qmask, k, out_dtype)


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
    fn = (act_phase2.act_phase2_plain if _on_cpu(x, zg, wg)
          else act_phase2.act_phase2_cuda)
    return fn(x, zg, wg)
