"""Deterministic sharded synthetic token pipeline.

Every (step, shard) microbatch is a pure function of (seed, step, shard) —
stateless, so ANY replica can recompute ANY microbatch. This is the property
the straggler-mitigation and elastic-rescale paths rely on (the JAX package's
``runtime/fault.py``): no data-loader state needs to move when work is
re-assigned. numpy only: the same ``DataConfig`` gives the JAX package's
arrays bitwise.

The stream is a Zipf-ish unigram mix with short-range repetition structure so
the training loss has signal (a pure-uniform stream has no learnable
structure and makes convergence tests vacuous).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1


def _rng_for(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]))


def shard_batch(cfg: DataConfig, step: int, shard: int) -> dict:
    """One shard's slice of the global batch at ``step``: tokens + labels."""
    assert cfg.global_batch % cfg.n_shards == 0
    b = cfg.global_batch // cfg.n_shards
    rng = _rng_for(cfg, step, shard)
    # Zipf unigram distribution over the vocab.
    ranks = np.arange(1, cfg.vocab + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(cfg.vocab, size=(b, cfg.seq_len + 1), p=probs)
    # Inject copy structure: with p=0.5 each position repeats t-2's token.
    rep = rng.uniform(size=(b, cfg.seq_len + 1)) < 0.5
    toks[:, 2:] = np.where(rep[:, 2:], toks[:, :-2], toks[:, 2:])
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def global_batch(cfg: DataConfig, step: int) -> dict:
    """Assembled global batch (host-side; drivers normally keep shards)."""
    shards = [shard_batch(cfg, step, s) for s in range(cfg.n_shards)]
    return {k: np.concatenate([s[k] for s in shards], axis=0)
            for k in shards[0]}
