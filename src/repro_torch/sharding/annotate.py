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

The LM mesh's train step (``launch/steps.py``) crosses autograd with
these, each under its own label:

* :func:`fsdp_gather` (``fsdp_gather``, ``grad_reduce``) - a parameter's
  block gathered on use into the whole leaf over the axes its spec names;
  in backward, the whole leaf's gradient summed over the axes that split
  the batch (label ``grad_reduce``) and cut back to the block. Ranks along
  an axis that replicates the batch compute the same gradient and are not
  summed;
* :func:`moe_in` and :func:`moe_out` - Megatron's conjugate pair around
  the expert-parallel MoE (``models.layers.moe_apply_shard_map``): *f*,
  the identity in forward and a sum over ``model`` in backward (label
  ``moe_in``), for the replicated input; *g*, a sum over ``model`` in
  forward (label ``moe_out``) and the identity in backward, for the
  partial outputs. *g* is an operator of its own,
  ``torch.ops.repro_torch.moe_out``, so that remat's ``dots`` policy can
  save its output and no recomputation sums again (JAX's
  ``checkpoint_name(y, "moe_out")``);
* :func:`gather_to_leader` (``ckpt_gather``) - a leaf's blocks gathered
  to the mesh's leader alone, for a checkpoint.

The mesh prefill and decode steps (``launch/steps.py``, Megatron TP over
the rules' blocks) run outside autograd and add, each under its own label:

* :func:`tp_reduce` (``tp_reduce``) - the row-parallel sum over ``model``
  of the partial outputs of ``wo`` and ``w_down``;
* :func:`vocab_embed` (``vocab_embed``) - the vocab-parallel lookup's sum
  over ``model``: each rank contributes the rows of the ids in its range;
* :func:`sp_max` and :func:`sp_sum` (``sp_combine``) - the running max,
  then the exp-sums and weighted values, of a softmax whose keys are split
  over the sequence-parallel axes;
* :func:`ssm_heads` (``ssm_heads``) - the SSM heads' outputs gathered
  over ``model`` before the gated norm;
* :func:`cache_handoff` (``cache_handoff``) - a sequence-parallel
  prefill cache gathered along the sequence, to be cut into the decode
  cache's blocks.

``fsdp_gather`` keeps its meaning there: on a leaf that the step computes
as its TP block it gathers over ``data`` only.

Every collective adds the bytes it brings to this rank (its output less the
rank's own part) to :data:`TRAFFIC` under its label; :func:`reset_traffic`
sets the counts to 0. A group of one rank moves nothing and is skipped.
"""
from __future__ import annotations

import collections
import math
import weakref

import torch
import torch.distributed as dist

from repro_torch.sharding import rules

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


# ----------------------------------------------------------------------------
# The LM mesh's collectives under autograd
# ----------------------------------------------------------------------------

#: Labels of the LM train step's collectives.
FSDP_GATHER, GRAD_REDUCE = "fsdp_gather", "grad_reduce"
MOE_IN, MOE_OUT = "moe_in", "moe_out"
CKPT_GATHER = "ckpt_gather"


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, mesh, spec, batch_axes):
        ctx.mesh, ctx.spec, ctx.batch_axes = mesh, spec, batch_axes
        x = block
        for dim, ax in enumerate(spec):
            for axis in reversed(rules.axes_of(ax)):     # minor axis first
                x = all_gather(x, mesh, axis, dim, FSDP_GATHER)
        return x

    @staticmethod
    def backward(ctx, grad):
        for axis in ctx.batch_axes:
            grad = all_reduce_sum(grad, ctx.mesh, axis, GRAD_REDUCE)
        block = grad[rules.block_slices(grad.shape, ctx.spec, ctx.mesh)]
        return block.contiguous(), None, None, None


def fsdp_gather(block: torch.Tensor, mesh, spec, batch_axes) -> torch.Tensor:
    """This rank's ``block`` of a leaf split by ``spec`` -> the whole leaf,
    gathered over every axis ``spec`` names (``rules.block_slices``'s
    layout). Backward: the whole leaf's gradient summed over
    ``batch_axes`` (the axes whose ranks computed different batch rows),
    then this rank's block of it."""
    return _GatherLeaf.apply(block, mesh, tuple(spec), tuple(batch_axes))


class _MoeIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.mesh, "model", MOE_IN), None


def moe_in(x: torch.Tensor, mesh) -> torch.Tensor:
    """Megatron's *f* over ``model``: ``x`` as it is in forward; its
    gradient summed over ``model`` in backward."""
    return _MoeIn.apply(x, mesh)


#: The meshes that ``moe_out`` operators run over, by the key the operator
#: takes (an operator takes no Python object).
_MOE_MESHES: weakref.WeakValueDictionary = weakref.WeakValueDictionary()


@torch.library.custom_op("repro_torch::moe_out", mutates_args=())
def _moe_out(x: torch.Tensor, mesh_key: str) -> torch.Tensor:
    out = all_reduce_sum(x, _MOE_MESHES[mesh_key], "model", MOE_OUT)
    return out.clone() if out is x else out


_moe_out.register_autograd(lambda ctx, grad: (grad, None))

#: The operator of :func:`moe_out`, which remat's ``dots`` policy saves.
MOE_OUT_OP = torch.ops.repro_torch.moe_out.default


def moe_out(x: torch.Tensor, mesh) -> torch.Tensor:
    """Megatron's *g* over ``model``: the sum of every model rank's
    partial ``x`` in forward (a new tensor), the gradient as it is in
    backward."""
    key = str(id(mesh))
    _MOE_MESHES[key] = mesh
    return torch.ops.repro_torch.moe_out(x, key)


def gather_to_leader(block: torch.Tensor, mesh, spec) -> torch.Tensor | None:
    """This rank's ``block`` of a leaf split by ``spec`` -> the whole leaf
    on the CPU of the mesh's leader (data 0, model 0), None elsewhere:
    gathered over ``model`` to each row's first rank, then those over
    ``data`` to the leader (label ``ckpt_gather``, the leader's bytes)."""
    spec = tuple(spec) + (None,) * (block.dim() - len(spec))
    whole = tuple(n * math.prod(mesh.size(a) for a in rules.axes_of(ax))
                  for n, ax in zip(block.shape, spec))
    w = block.detach().contiguous().reshape(-1).view(torch.uint8)
    w = w.cpu() if mesh.backend == "gloo" else w
    parts = [w]
    n_data, n_model = mesh.size("data"), mesh.size("model")
    if n_model > 1:
        row = mesh.grid[mesh.index("data")]
        got = ([torch.empty_like(w) for _ in range(n_model)]
               if mesh.index("model") == 0 else None)
        dist.gather(w, got, dst=row[0], group=mesh.group("model"))
        if got is None:
            return None
        parts = got
        TRAFFIC[CKPT_GATHER] += (n_model - 1) * w.nbytes
    if n_data > 1:
        mine = torch.cat(parts)
        got = ([torch.empty_like(mine) for _ in range(n_data)]
               if mesh.index("data") == 0 else None)
        dist.gather(mine, got, dst=mesh.leader, group=mesh.group("data"))
        if got is None:
            return None
        parts = [p for row in got for p in row.chunk(n_model)]
        TRAFFIC[CKPT_GATHER] += (n_data - 1) * mine.nbytes
    out = torch.empty(whole, dtype=block.dtype)
    for i, part in enumerate(parts):
        coords = {"data": i // n_model, "model": i % n_model}
        out[rules.block_slices(whole, spec, mesh, coords)] = \
            part.cpu().view(block.dtype).reshape(block.shape)
    return out


# ----------------------------------------------------------------------------
# The LM mesh's serving collectives (no autograd)
# ----------------------------------------------------------------------------

#: Labels of the mesh prefill and decode steps' collectives.
TP_REDUCE, VOCAB_EMBED, SP_COMBINE = "tp_reduce", "vocab_embed", "sp_combine"
SSM_HEADS, CACHE_HANDOFF = "ssm_heads", "cache_handoff"


def tp_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """Megatron's row-parallel sum over ``model`` of the partial outputs
    of this rank's heads or ``d_ff`` columns."""
    return all_reduce_sum(x, mesh, "model", TP_REDUCE)


def vocab_embed(x: torch.Tensor, mesh) -> torch.Tensor:
    """The vocab-parallel lookup's sum over ``model``: every id's row comes
    from the one rank whose vocabulary block holds it, zeros elsewhere."""
    return all_reduce_sum(x, mesh, "model", VOCAB_EMBED)


def sp_max(x: torch.Tensor, mesh, axes: tuple[str, ...]) -> torch.Tensor:
    """The max of ``x`` over the sequence-parallel ``axes``."""
    for axis in axes:
        x = all_reduce_max(x, mesh, axis, SP_COMBINE)
    return x


def sp_sum(x: torch.Tensor, mesh, axes: tuple[str, ...]) -> torch.Tensor:
    """The sum of ``x`` over the sequence-parallel ``axes``."""
    for axis in axes:
        x = all_reduce_sum(x, mesh, axis, SP_COMBINE)
    return x


def ssm_heads(y: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """This rank's SSM heads' outputs -> every head's, along ``dim``."""
    return all_gather(y, mesh, "model", dim, SSM_HEADS)


def cache_handoff(x: torch.Tensor, mesh, axes: tuple[str, ...],
                  dim: int) -> torch.Tensor:
    """A cache block split along ``dim`` over ``axes`` (major first) ->
    the whole of that dim."""
    for axis in reversed(axes):                         # minor axis first
        x = all_gather(x, mesh, axis, dim, CACHE_HANDOFF)
    return x
