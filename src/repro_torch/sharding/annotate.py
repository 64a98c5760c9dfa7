"""The mesh's collectives: the EMD half of the JAX package's
``sharding/annotate.py``.

In JAX these are layout pins (``with_sharding_constraint``) that XLA's SPMD
partitioner turns into collectives. Here each one IS the collective, over
the mesh's explicit process groups (``launch.mesh.Mesh``):

* :func:`emd_ladder` - the Phase-1 -> Phase-2 handoff, query-major ((nq/dp,
  v/mp, k) ladders, or any array whose axis 1 is the vocabulary), gathered
  over ``model`` along the vocabulary: every model rank then holds its
  queries' whole ladders;
* :func:`emd_shard_topk` - the per-shard winners of the shard-blocked
  top-budget, gathered over ``model`` along their last axis;
* :func:`gather_blocks` - a rank's block of a result, gathered over the
  axes that split it, so every rank holds the whole result;
* :func:`all_reduce_sum` - the candidate scores' exchange (each slot has
  one owner, every other rank adds zeros), and with :func:`all_reduce_max`
  the int8-compressed gradient reduce (``optim/grad_utils.py``).

JAX's ``emd_stacked_dist`` pins the (v, nq, h) tensor that each device
computes its own tile of: no byte crosses there, so it has no counterpart.

An all-gather moves its array as raw bytes (``view(torch.uint8)``), as
JAX's bitcast fence moves a bf16 handoff as 16-bit words: neither backend
rounds or widens a bfloat16 ladder, and gloo, which has no bfloat16 and no
int16, needs none. Over gloo a CUDA tensor is staged through the host,
because the backend is gloo (its CUDA support varies between builds),
never because a call failed.

Every collective adds the bytes it brings to this rank (its output less the
rank's own part) to :data:`TRAFFIC` under its label; :func:`reset_traffic`
sets the counts to 0. A group of one rank moves nothing and is skipped.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

#: Bytes brought to this rank by each collective label since the last
#: :func:`reset_traffic`.
TRAFFIC: collections.Counter = collections.Counter()


def reset_traffic() -> None:
    TRAFFIC.clear()


def traffic() -> dict[str, int]:
    """Bytes brought to this rank by each label since the last reset."""
    return dict(TRAFFIC)


def staged(mesh, x: torch.Tensor) -> bool:
    """True when a collective on ``x`` goes through the host: gloo on a
    CUDA tensor."""
    return mesh.backend == "gloo" and x.device.type == "cuda"


def _wire(mesh, x: torch.Tensor) -> torch.Tensor:
    """``x``'s raw bytes, flat uint8, on the device the collective runs
    on."""
    w = x.contiguous().reshape(-1).view(torch.uint8)
    return w.cpu() if staged(mesh, x) else w


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int,
               label: str) -> torch.Tensor:
    """Concatenate along ``dim`` the ``x`` of every rank of this rank's
    ``axis`` group, in mesh order. Every rank must pass the same shape."""
    size = mesh.size(axis)
    if size == 1:
        return x
    dim = dim % x.dim()
    moved = x.movedim(dim, 0)
    w = _wire(mesh, moved)
    parts = [torch.empty_like(w) for _ in range(size)]
    dist.all_gather(parts, w, group=mesh.group(axis))
    TRAFFIC[label] += (size - 1) * w.nbytes
    out = torch.cat(parts).to(x.device).view(x.dtype).reshape(
        (size * moved.shape[0],) + tuple(moved.shape[1:]))
    return out.movedim(0, dim).contiguous()


def _all_reduce(x: torch.Tensor, mesh, axis: str, label: str,
                op) -> torch.Tensor:
    size = mesh.size(axis)
    if size == 1:
        return x
    w = x.contiguous().cpu() if staged(mesh, x) else x.clone()
    dist.all_reduce(w, op=op, group=mesh.group(axis))
    TRAFFIC[label] += (size - 1) * w.nbytes
    return w.to(x.device)


def all_reduce_sum(x: torch.Tensor, mesh, axis: str,
                   label: str) -> torch.Tensor:
    """The sum of ``x`` over this rank's ``axis`` group (a new tensor)."""
    return _all_reduce(x, mesh, axis, label, dist.ReduceOp.SUM)


def all_reduce_max(x: torch.Tensor, mesh, axis: str,
                   label: str) -> torch.Tensor:
    """The elementwise max of ``x`` over this rank's ``axis`` group (a new
    tensor)."""
    return _all_reduce(x, mesh, axis, label, dist.ReduceOp.MAX)


def emd_ladder(x: torch.Tensor, mesh) -> torch.Tensor:
    """The handoff all-gather over ``model``: a query-major (nq/dp, v/mp,
    ...) array of this rank's vocabulary slice -> (nq/dp, v, ...)."""
    return all_gather(x, mesh, "model", 1, "emd_ladder")


def emd_shard_topk(x: torch.Tensor, mesh) -> torch.Tensor:
    """The shard-blocked top-budget's winners (nq/dp, b) of this model
    shard -> (nq/dp, mp * b), in model order."""
    return all_gather(x, mesh, "model", -1, "shard_topk")


def gather_blocks(x: torch.Tensor, mesh, dims: dict[str, int],
                  label: str) -> torch.Tensor:
    """This rank's block of a result split along ``dims`` ({axis: tensor
    dim}) -> the whole result, on every rank."""
    for axis in ("model", "data"):
        if axis in dims:
            x = all_gather(x, mesh, axis, dims[axis], label)
    return x
