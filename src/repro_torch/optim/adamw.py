"""AdamW + warm-up cosine schedule on torch tensors (the JAX package's
``optim/adamw.py``).

A tree here is a dict (nested or flat) whose leaves are tensors: the JAX
package's parameter tree, or the port's parameters keyed by name
(``dict(model.named_parameters())``). Leaves are visited in sorted key
order, as ``jax.tree.leaves`` visits a dict. The state is
``{"m": tree, "v": tree, "step": int32 0-d tensor}``, the moments in the
config's ``opt_state_dtype``; ``models/convert.py`` carries it to JAX's
layout and back.

The arithmetic is JAX's, op for op, in float32: the schedule, the bias
corrections ``1 - b ** step`` (a float32 power, not Python's float64),
the moments, and the update, which computes in float32 and casts back to
each leaf's dtype (bfloat16 parameters, float32 moments for olmo-1b).
Python-level constants fold in float64 first exactly where the JAX
expressions fold them (``0.5 * (peak_lr - min_lr)``, ``1 - b1``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_map(fn, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and of the trees of its structure
    in ``rest``; a dict stays a dict (an empty one stays empty)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """The leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warm-up then cosine decay to min_lr; a float32 0-d tensor
    on ``step``'s device."""
    step = _f32(step)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: Tree, dtype: str = "float32") -> dict:
    """Zero moments of ``params``' shapes in ``dtype``, step 0 (int32),
    on the parameters' device."""
    dt = getattr(torch, dtype)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads: Tree, max_norm: float,
                        norm: torch.Tensor | None = None):
    """(grads scaled by min(1, max_norm / max(norm, 1e-12)) in float32 and
    cast back to each gradient's dtype, the norm before scaling). ``norm``:
    the global norm when ``grads`` are blocks of a larger tree (a mesh
    rank's), else ``global_norm(grads)``."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def update(grads: Tree, state: dict, params: Tree, cfg: AdamWConfig,
           norm: torch.Tensor | None = None) -> tuple[Tree, dict, dict]:
    """One AdamW step. Returns (new_params, new_state, metrics
    {"grad_norm", "lr"}); nothing is changed in place. ``norm``: as
    ``clip_by_global_norm``'s."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, norm)
    step = state["step"] + 1
    lr = schedule(step, cfg)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=step.device), _f32(step))
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=step.device), _f32(step))

    def upd(p, g, m, v):
        gf = g.float()
        m2 = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        v2 = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
        mhat = m2 / b1c
        vhat = v2 / b2c
        delta = (mhat / (torch.sqrt(vhat) + cfg.eps)
                 + cfg.weight_decay * p.float())
        return ((p.float() - lr * delta).to(p.dtype), m2.to(m.dtype),
                v2.to(v.dtype))

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new = [_split(out, i) for i in range(3)]
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new[0], {"m": new[1], "v": new[2], "step": step}, metrics


def _split(tree, i: int):
    """The i-th member of every (param, m, v) leaf of ``update``'s map."""
    if isinstance(tree, dict):
        return {k: _split(v, i) for k, v in tree.items()}
    return tree[i]
