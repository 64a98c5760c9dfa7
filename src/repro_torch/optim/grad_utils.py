"""Gradient accumulation over microbatches and int8 stochastic-rounding
gradient compression (the JAX package's ``optim/grad_utils.py``).
"""
from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.optim.adamw import tree_map
from repro_torch.sharding import annotate

#: ``annotate.TRAFFIC``'s label for the compressed reduce's bytes (the
#: shared scales and the int32 payloads).
LABEL = "grad_int8"


def _grads(loss: torch.Tensor, params: dict) -> dict:
    """d loss / d each parameter (zeros for one the loss does not reach,
    as JAX's gradient is)."""
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {name: torch.zeros_like(p) if g is None else g
            for (name, p), g in zip(params.items(), gs)}


def accumulate_grads(loss_fn: Callable, params: dict, batch: dict,
                     n_micro: int) -> tuple[torch.Tensor, dict]:
    """(loss, grads) of ``loss_fn(batch)`` with respect to ``params``
    ({name: tensor} that the loss reads), over ``n_micro`` microbatches.

    The batch splits into ``n_micro`` slices along dim 0 (which must
    divide), one backward each, the gradients summed in float32 buffers
    and scaled by 1 / n_micro, as is the loss: activation memory is that of
    one microbatch. With ``n_micro <= 1`` it is one backward and the
    gradients keep each parameter's dtype, as ``jax.value_and_grad``
    returns them. (Torch's ``.grad`` would accumulate in the parameter's
    dtype, bfloat16 for the full configs; JAX's sum is float32.)
    """
    if n_micro <= 1:
        loss = loss_fn(batch)
        return loss.detach(), _grads(loss, params)
    micro = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if v.shape[0] % n_micro:
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not a "
                             f"multiple of n_micro={n_micro}")
        micro[k] = v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
    loss_sum = None
    gacc = {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for name, p in params.items()}
    for i in range(n_micro):
        loss = loss_fn({k: v[i] for k, v in micro.items()})
        for name, g in _grads(loss, params).items():
            gacc[name] += g.float()
        loss = loss.detach().float()
        loss_sum = loss if loss_sum is None else loss_sum + loss
    inv = 1.0 / n_micro
    return loss_sum * inv, {name: g * inv for name, g in gacc.items()}


# ----------------------------------------------------------------------------
# int8 stochastic-rounding compression (the cross-pod gradient reduce)
# ----------------------------------------------------------------------------

def compress_int8(x: torch.Tensor, generator: torch.Generator,
                  scale: torch.Tensor | None = None):
    """x -> (int8 payload, float32 per-tensor scale). Stochastic rounding
    keeps the quantizer unbiased, so accumulated compressed reduces do not
    drift: each value rounds up with probability equal to its fraction,
    the uniforms drawn from ``generator`` (on ``x``'s device; its bits are
    not ``jax.random``'s, so only values on the int8 grid round as JAX's
    do). ``scale`` may be given (a scale shared over a mesh axis)."""
    xf = x.float()
    if scale is None:
        scale = torch.clamp_min(torch.max(torch.abs(xf)), 1e-12) / 127.0
    scaled = xf / scale
    low = torch.floor(scaled)
    p_up = scaled - low
    rnd = torch.rand(x.shape, generator=generator, device=x.device)
    q = low + (rnd < p_up).float()
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compressed_psum_tree(grads, generator: torch.Generator, mesh,
                         axis: str):
    """Compress -> sum over this rank's ``axis`` group of ``mesh`` ->
    decompress, leaf by leaf (a tree of dicts): one max-reduce of the
    leaf's scale first, so that every rank quantizes on the same grid and
    the int8 payloads add exactly as int32. Each leaf comes back in its
    dtype; the bytes count under ``LABEL``."""
    def leaf(x):
        local_max = torch.clamp_min(torch.max(torch.abs(x.float())), 1e-12)
        scale = annotate.all_reduce_max(local_max, mesh, axis, LABEL) / 127.0
        q, _ = compress_int8(x, generator, scale=scale)
        total = annotate.all_reduce_sum(q.to(torch.int32), mesh, axis, LABEL)
        return (total.float() * scale).to(x.dtype)
    return tree_map(leaf, grads)
