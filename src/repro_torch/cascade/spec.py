"""Cascade specifications: typed stage ladders with admissibility checking.

A cascade is a prune-and-rescore pipeline: stage 1 scores the full corpus
with a cheap measure and keeps its ``budget`` best candidates per query;
every later stage scores ONLY the survivors of the previous stage
(gather-compacted, see ``core/lc``'s candidate engines); the final
``rescorer`` scores the last survivor set and the top-l is taken from its
scores. This is the serving pattern Theorem 2's bound hierarchy
(RWMD <= OMR <= ACT-k <= ICT <= EMD) exists to enable.

Admissibility is validated STATICALLY against the bound table below: a
cascade is *admissible* when every stage is a provable lower bound of the
final rescorer. An admissible cascade preserves the exact top-l of
full-corpus rescoring whenever the stage budgets exceed the stage-score
rank of every true top-l neighbor (each true neighbor then survives every
prune); a non-admissible cascade — e.g. the fast ``wcd`` prefetch, whose
bound only holds against exact EMD — is still servable, but its agreement
with full scoring is an empirical recall number, which the API surfaces
(the JAX package's ``EmdIndex.recall_at_l`` and
``benchmarks/bench_cascade.py``; here ``cascade.topk_recall``).

This is the port's own copy of the JAX package's ``cascade/spec.py``,
validated against the port's ``METHODS``, rescorers and candidate sources
(``repro_torch.candidates``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.candidates import SourceSpec, resolve_source
from repro_torch.core.retrieval import METHODS

#: The paper's directional bound chain, loosest to tightest (Theorem 2:
#: RWMD <= OMR <= ACT-k <= ICT <= EMD). Public: the static registry lint
#: (``repro.analysis.registry_lint`` in the JAX package) proves
#: :func:`is_lower_bound` is a partial order consistent with exactly this
#: chain.
BOUND_CHAIN = ("rwmd", "omr", "act", "ict")

#: Chain position of each directional measure in Theorem 2's hierarchy.
#: Tightness keys are (position, iters): a stage lower-bounds a rescorer
#: iff its key is <= the rescorer's. ``act`` with iters=0 degenerates to
#: RWMD (position 0); iters only discriminates act-vs-act.
_CHAIN_POS = {m: i for i, m in enumerate(BOUND_CHAIN)}

#: Final measures every EMD lower bound PROVABLY sits below: exact EMD
#: only. The Sinkhorn rescorer is deliberately absent — a converged
#: entropic plan's cost upper-bounds EMD, but the fixed-iteration,
#: mass-renormalized plan ``rescore.sinkhorn_cand`` computes is not
#: exactly feasible and can dip below the optimum, so cascades rescored
#: by it report measured recall rather than claiming exactness.
_AT_LEAST_EMD = ("emd",)

#: Methods that provably lower-bound exact EMD without being comparable
#: inside the directional chain: ``wcd`` (Jensen: the centroid distance
#: under a Euclidean ground metric is below any transport cost) and
#: ``rwmd_rev`` (the chain's opposite direction). Public for the same
#: reason as :data:`BOUND_CHAIN`.
EMD_ONLY_BOUNDS = ("wcd", "rwmd_rev")
_EMD_ONLY_BOUNDS = EMD_ONLY_BOUNDS


def _tightness(method: str, iters: int) -> tuple[int, int] | None:
    """(chain position, iters) tightness key, or None outside the chain."""
    if method not in _CHAIN_POS:
        return None
    if method == "act":
        return (0, 0) if iters == 0 else (_CHAIN_POS["act"], iters)
    return (_CHAIN_POS[method], 0)


def is_lower_bound(method: str, iters: int, rescorer: str,
                   rescorer_iters: int) -> bool:
    """True when ``method`` is a PROVABLE lower bound of ``rescorer``
    (the per-stage admissibility predicate)."""
    if method == rescorer and (method != "act" or iters <= rescorer_iters):
        return True                         # any measure bounds itself
    if rescorer in _AT_LEAST_EMD:
        return method in _CHAIN_POS or method in _EMD_ONLY_BOUNDS
    a = _tightness(method, iters)
    b = _tightness(rescorer, rescorer_iters)
    if a is None or b is None:
        return False
    if a[0] != b[0]:
        return a[0] < b[0]
    return a[1] <= b[1]                     # act-vs-act: fewer rounds


@dataclasses.dataclass(frozen=True)
class CascadeStage:
    """One pruning stage: score the surviving candidates with ``method``
    and keep the ``budget`` best per query.

    budget: int = absolute rows kept; float in (0, 1] = fraction of the
            corpus, resolved at search time (and clamped to [top_l, n]).
    iters:  LC-ACT Phase-2 rounds (ignored by other methods).
    """
    method: str
    budget: int | float
    iters: int = 1

    def __post_init__(self) -> None:
        if self.method not in METHODS:
            raise ValueError(f"unknown cascade stage method {self.method!r};"
                             f" registered: {sorted(METHODS)}")
        b = self.budget
        if isinstance(b, bool) or b <= 0 or \
                (isinstance(b, float) and b > 1.0):
            raise ValueError(
                f"stage budget must be a positive row count or a fraction "
                f"in (0, 1], got {b!r}")
        if self.iters < 0:
            raise ValueError(f"stage iters must be >= 0, got {self.iters}")


@dataclasses.dataclass(frozen=True)
class CascadeSpec:
    """Frozen description of a prune-and-rescore cascade.

    stages:         pruning ladder, cheapest first; stage 1 scores the
                    full corpus, later stages the previous survivors.
                    Stage methods (after the first) need a registered
                    candidate scorer (``MethodSpec.cand_fn``).
    rescorer:       final measure scoring the last survivor set — any
                    method with a ``cand_fn`` (``act``, ``ict``, ...) or
                    one of the cascade-only rescorers in
                    ``repro_torch.cascade.rescore`` (``sinkhorn``, exact
                    ``emd``; the latter runs host-side).
    rescorer_iters: LC-ACT rounds when the rescorer is ``act``.
    source:         where stage 1's candidates come from: ``None`` or a
                    full-scan source = the whole corpus (the O(n) path,
                    bitwise unchanged); a sublinear ``SourceSpec``
                    (``repro_torch.candidates``; registered names like
                    ``"centroid_lsh"`` resolve with their defaults) =
                    stage 1 scores only the rows the built index emits,
                    which forces measured-recall reporting.

    Hashable, so it rides inside ``repro_torch.api.EngineConfig``.
    """
    stages: tuple[CascadeStage, ...]
    rescorer: str = "act"
    rescorer_iters: int = 1
    source: SourceSpec | str | None = None

    def __post_init__(self) -> None:
        from repro_torch.cascade import rescore  # late: avoids import cycle
        if self.source is not None:
            object.__setattr__(self, "source", resolve_source(self.source))
        if not self.stages:
            raise ValueError("a cascade needs at least one pruning stage")
        # Stage 1 scores the full corpus through batch_scores; only the
        # later stages run candidate-compacted, unless a sublinear source
        # feeds stage 1, which then compacts too.
        sourced = self.sourced
        for s in self.stages[1:] if not sourced else self.stages:
            if METHODS[s.method].cand_fn is None:
                raise ValueError(
                    f"stage method {s.method!r} has no candidate-compacted "
                    "scorer (MethodSpec.cand_fn); it cannot prune "
                    + ("sourced candidates (a sublinear source makes "
                       "EVERY stage candidate-compacted)" if sourced else
                       "survivors (only the first stage scores "
                       "full-corpus)"))
        rescore.resolve(self.rescorer)         # raises on unknown rescorer
        if self.rescorer_iters < 0:
            raise ValueError("rescorer_iters must be >= 0, "
                             f"got {self.rescorer_iters}")
        fracs = [s.budget for s in self.stages
                 if isinstance(s.budget, float)]
        ints = [s.budget for s in self.stages if isinstance(s.budget, int)]
        for seq in (fracs, ints):
            if any(b > a for a, b in zip(seq, seq[1:], strict=False)):
                raise ValueError(
                    "stage budgets must be non-increasing (each stage "
                    f"prunes), got {[s.budget for s in self.stages]}")

    @property
    def sourced(self) -> bool:
        """True when stage 1 consumes a sublinear candidate source
        instead of scanning the corpus."""
        return self.source is not None and not self.source.full_scan

    @property
    def admissible(self) -> bool:
        """True when EVERY stage provably lower-bounds the rescorer —
        the precondition for the exact-top-l guarantee (budgets
        permitting); False means recall must be measured, not assumed.
        A sublinear source can drop a true neighbour before any stage
        scores it, so only full-scan (or unsourced) cascades can be
        admissible."""
        if self.source is not None and not self.source.admissible:
            return False
        return all(is_lower_bound(s.method, s.iters, self.rescorer,
                                  self.rescorer_iters)
                   for s in self.stages)

    def resolve_budgets(self, n: int, top_l: int) -> tuple[int, ...]:
        """Concrete per-stage survivor counts for a corpus of ``n`` real
        rows: fractions scale by n and everything clamps into
        [top_l, n]. A resolved budget larger than its predecessor's (only
        possible when mixing absolute and fractional budgets — same-kind
        ladders are validated at construction) is an error, not a silent
        clamp: the spec does not actually prune on this corpus."""
        if top_l > n:
            raise ValueError(f"top_l={top_l} exceeds corpus size {n}")
        out = []
        prev = n
        for s in self.stages:
            b = int(round(s.budget * n)) if isinstance(s.budget, float) \
                else int(s.budget)
            b = min(b, n)
            if b > prev:
                raise ValueError(
                    f"stage budgets resolve non-monotonically on n={n}: "
                    f"{s.budget!r} -> {b} rows after a {prev}-row stage "
                    f"({self.describe()})")
            b = max(b, top_l)
            out.append(b)
            prev = b
        return tuple(out)

    def check_servable(self, n: int, top_l: int, *,
                       require_jittable: bool = False) -> None:
        """Raise ``ValueError`` unless this spec can serve an index of
        ``n`` rows at ``top_l`` neighbors: the budgets resolve
        monotonically on this corpus size (``resolve_budgets`` raises
        otherwise) and, with ``require_jittable``, the rescorer runs on
        the device (the JAX package's word: inside the jitted program),
        not host-side exact EMD.
        """
        if require_jittable:
            from repro_torch.cascade import rescore  # late: import cycle
            if not rescore.resolve(self.rescorer).jittable:
                raise ValueError(
                    f"cascade rescorer {self.rescorer!r} runs on the host; "
                    "this serving configuration needs a jittable rescorer "
                    f"({self.describe()})")
        self.resolve_budgets(n, top_l)

    def describe(self) -> str:
        """``wcd(20%) -> rwmd(5%) -> act-3`` style one-liner; sourced
        cascades prefix the source, e.g. ``centroid_lsh[...] ~> ...``."""
        def fmt(b):
            return f"{100 * b:g}%" if isinstance(b, float) else str(b)
        parts = [f"{s.method}({fmt(s.budget)})" for s in self.stages]
        final = self.rescorer + (f"-{self.rescorer_iters}"
                                 if self.rescorer == "act" else "")
        chain = " -> ".join(parts + [final])
        if self.sourced:
            return f"{self.source.describe()} ~> {chain}"
        return chain


#: Named cascade presets (``EngineConfig.cascade`` accepts these keys).
CASCADES: dict[str, CascadeSpec] = {
    # The serving default: cheap centroid prefetch, RWMD prune, ACT
    # rescore. NOT admissible (wcd only bounds exact EMD), so its recall
    # vs full ACT is measured (the 8x wcd headroom is what the centroid
    # heuristic needs).
    "fast": CascadeSpec(stages=(CascadeStage("wcd", 0.4),
                                CascadeStage("rwmd", 0.05)),
                        rescorer="act", rescorer_iters=3),
    # Admissible ladder inside the Theorem-2 chain: exact top-l whenever
    # budgets cover the true neighbors' stage ranks.
    "chain": CascadeSpec(stages=(CascadeStage("rwmd", 0.2),
                                 CascadeStage("omr", 0.05)),
                         rescorer="act", rescorer_iters=3),
    # Tightest linear-complexity answer: ACT prune, full-ladder ICT
    # rescore (admissible).
    "tight": CascadeSpec(stages=(CascadeStage("rwmd", 0.2),
                                 CascadeStage("act", 0.05, iters=3)),
                         rescorer="ict"),
    # Ground truth at the top: every stage is a provable EMD lower bound
    # (admissible); the exact LP runs host-side on the final survivors.
    "exact": CascadeSpec(stages=(CascadeStage("wcd", 0.2),
                                 CascadeStage("rwmd", 0.1),
                                 CascadeStage("act", 0.02, iters=3)),
                         rescorer="emd"),
}


#: Declared admissibility of every preset — the documentation claim each
#: preset's comment makes, as data (the JAX package's registry lint
#: recomputes ``CASCADES[name].admissible`` against it; the port's tests
#: do the same).
PRESET_ADMISSIBLE: dict[str, bool] = {
    "fast": False,      # wcd bounds exact EMD only, not the act rescorer
    "chain": True,
    "tight": True,
    "exact": True,
}


def resolve_spec(spec: CascadeSpec | str) -> CascadeSpec:
    """A CascadeSpec passes through; a string resolves in :data:`CASCADES`."""
    if isinstance(spec, CascadeSpec):
        return spec
    if spec in CASCADES:
        return CASCADES[spec]
    raise ValueError(f"unknown cascade preset {spec!r}; "
                     f"one of {sorted(CASCADES)}")
