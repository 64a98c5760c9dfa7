"""Serving policy: deadlines, retries, and the graceful-degradation ladder.

The bound hierarchy the repo validates statically (RWMD <= OMR <= ACT <=
ICT <= EMD, ``cascade/spec.py``) is what makes degradation *honest*: every
rung of the ladder is a real retrieval configuration with a known quality
relationship to the primary tier, so under overload or partial failure the
server steps DOWN the ladder and labels the response with the tier it
actually served (plus that tier's recall expectation) instead of timing
out or silently serving garbage. Load-shedding (fast-fail with
:class:`ServerOverloaded`) is the final rung.

A ladder rung is one of:

* ``"primary"`` — the index's own configured search (its cascade if the
  ``EngineConfig`` carries one, else full-corpus scoring with its method);
* a cascade preset name (``repro_torch.cascade.CASCADES``) or an explicit
  ``CascadeSpec`` — served through the prune-and-rescore ladder;
* a method name (``repro_torch.core.retrieval.METHODS``) — a full-corpus
  scan with that (cheap) measure, e.g. the ``"wcd"`` centroid-only rung.

The whole ladder is validated against the index configuration BEFORE the
server takes traffic (:func:`validate_ladder`): unknown rungs, cascade
specs whose budgets cannot resolve on the corpus and symmetric-scoring
conflicts all fail at construction, never at the moment a fallback is
needed.

The port's copy of the JAX package's ``serving/policy.py``; the labels of
:data:`TIER_RECALL` are the JAX package's, so a tier reads the same in
both.
"""
from __future__ import annotations

import dataclasses

from repro_torch.cascade.spec import CASCADES, CascadeSpec, resolve_spec
from repro_torch.core.retrieval import METHODS


class ServerOverloaded(RuntimeError):
    """The final rung: every tier of the ladder failed (or was shed);
    the request fast-fails instead of hanging past its deadline."""


#: Documented recall expectation (vs the primary tier's own top-l) that a
#: degraded response carries. Admissible cascade presets guarantee exact
#: top-l whenever budgets cover the true neighbors' stage ranks => 1.0;
#: ``fast`` is non-admissible and its number is the JAX package's measured
#: floor (``benchmarks/bench_cascade.py``: >= 0.95 recall@16 at its budgets
#: on its text-like workload; not a guarantee on another corpus). Method
#: rungs have no cascade guarantee at all — ``None`` means "measured only",
#: and the server's ``stats.tier_served`` reports the served-tier mix so
#: the quality cost of degradation is always visible.
TIER_RECALL: dict[str, float | None] = {
    "primary": 1.0,
    "exact": 1.0,
    "tight": 1.0,
    "chain": 1.0,
    "fast": 0.95,
}


@dataclasses.dataclass(frozen=True)
class ServingTier:
    """One resolved rung: either a cascade (``cascade`` set) or a plain
    full-corpus method scan (``method`` set) — exactly one of the two,
    except the primary rung, which may be a plain-method primary with
    neither when the index has no cascade configured."""
    name: str
    cascade: CascadeSpec | None = None
    method: str | None = None
    expected_recall: float | None = None

    def __post_init__(self) -> None:
        if self.cascade is not None and self.method is not None:
            raise ValueError(f"tier {self.name!r} sets both cascade and "
                             "method")


def resolve_tier(rung: str | CascadeSpec | ServingTier) -> ServingTier:
    """Rung -> :class:`ServingTier`. Strings resolve against the cascade
    presets first, then the method registry; ``"primary"`` is returned as
    a sentinel tier for the server to bind to the index config."""
    if isinstance(rung, ServingTier):
        return rung
    if isinstance(rung, CascadeSpec):
        return ServingTier(name=rung.describe(), cascade=rung,
                           expected_recall=1.0 if rung.admissible else None)
    if rung == "primary":
        return ServingTier(name="primary", expected_recall=1.0)
    if rung in CASCADES:
        return ServingTier(name=rung, cascade=CASCADES[rung],
                           expected_recall=TIER_RECALL.get(rung))
    if rung in METHODS:
        return ServingTier(name=rung, method=rung,
                           expected_recall=TIER_RECALL.get(rung))
    raise ValueError(
        f"unknown ladder rung {rung!r}: not 'primary', a cascade preset "
        f"({sorted(CASCADES)}), or a method ({sorted(METHODS)})")


@dataclasses.dataclass(frozen=True)
class ServingPolicy:
    """Frozen per-server policy knobs.

    ladder:      degradation rungs, best quality first (see module doc).
                 The first rung is what healthy traffic is served with.
    flush_ms:    deadline trigger of the micro-batch queue — a batch is
                 launched when the OLDEST queued request has waited this
                 long, even if the batch is not full.
    max_batch:   size trigger — a batch launches immediately at this many
                 queued requests. Also the top padding bucket.
    deadline_ms: default per-request deadline; on flush, a request whose
                 remaining budget no longer fits the current tier's
                 latency estimate pulls the whole batch down-ladder
                 (deadline pressure — the batch shares one launch).
    max_retries: device-launch retries (with backoff) per tier before the
                 batch steps down to the next rung.
    backoff_ms:  base of the exponential retry backoff
                 (``backoff_ms * 2**attempt``). Tests set 0.
    headroom:    safety factor on the latency estimate: a tier is
                 considered to fit when ``est * headroom <= remaining``.
    """
    ladder: tuple[str | CascadeSpec | ServingTier, ...] = (
        "primary", "fast", "wcd")
    flush_ms: float = 2.0
    max_batch: int = 32
    deadline_ms: float = 200.0
    max_retries: int = 2
    backoff_ms: float = 1.0
    headroom: float = 1.5

    def __post_init__(self) -> None:
        if not self.ladder:
            raise ValueError("the degradation ladder needs >= 1 rung")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if min(self.flush_ms, self.deadline_ms, self.backoff_ms) < 0:
            raise ValueError("flush_ms/deadline_ms/backoff_ms must be >= 0")
        if self.headroom <= 0:
            raise ValueError(f"headroom must be > 0, got {self.headroom}")

    def resolved_ladder(self) -> tuple[ServingTier, ...]:
        return tuple(resolve_tier(r) for r in self.ladder)


def validate_ladder(policy: ServingPolicy, config, n: int,
                    top_l: int) -> tuple[ServingTier, ...]:
    """Resolve and validate every rung of ``policy.ladder`` against an
    index built with ``config`` over ``n`` corpus rows; returns the
    resolved tiers. Raises ``ValueError`` on the first rung that could
    not actually serve — the whole ladder must be servable up front.
    """
    tiers = policy.resolved_ladder()
    names = [t.name for t in tiers]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate ladder rungs: {names}")
    for tier in tiers:
        try:
            _check_tier(tier, config, n, top_l)
        except ValueError as e:
            raise ValueError(
                f"ladder rung {tier.name!r} cannot serve this index: "
                f"{e}") from e
    return tiers


def _check_tier(tier: ServingTier, config, n: int, top_l: int) -> None:
    if tier.cascade is not None:
        if config.symmetric:
            raise ValueError("cascade rungs score directionally but the "
                             "index is configured symmetric=True")
        resolve_spec(tier.cascade).check_servable(n, top_l)
    elif tier.method is not None:
        # Method rungs serve the DIRECTIONAL score regardless of the
        # index's symmetric flag (wcd/bow have no reverse direction);
        # that quality change is exactly what the tier label reports.
        if tier.method not in METHODS:
            raise ValueError(f"unknown method {tier.method!r}")
    elif tier.name == "primary":
        if top_l > n:
            raise ValueError(f"top_l={top_l} exceeds corpus size {n}")
    else:
        raise ValueError("tier resolves to neither a cascade nor a method")
