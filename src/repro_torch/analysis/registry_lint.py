"""Registry/spec consistency lint — the bound table and method registry
as checkable mathematical objects.

Three families of invariants, all pure Python (no tracing, no devices):

* **Bound-table order** — ``cascade.spec.is_lower_bound`` must be a
  partial order on (method, iters) pairs consistent with Theorem 2's
  chain RWMD <= OMR <= ACT-k <= ICT <= EMD: reflexive, transitive,
  antisymmetric up to the known degeneracy (ACT with 0 Phase-2 rounds IS
  RWMD), with every chain member and every EMD-only bound below exact
  EMD, and the EMD-only bounds (wcd, rwmd_rev) below NOTHING else in the
  chain. A bad edit to the tightness table silently breaks cascade
  admissibility — this pass turns that into a CI failure.
* **MethodSpec coherence** — reverse links symmetric, kernel support
  only on methods with a batched engine, ``dist_out`` layouts
  well-formed, symmetric measures reverse-free, iterated methods
  cascade-rescorable. (The JAX package's ``dist_fn`` check has no
  counterpart: the port's mesh engine is the batched engine on a rank's
  shards and registers no scorer of its own.)
* **Cascade presets** — every ``CASCADES`` entry constructs, resolves
  budgets on a reference corpus, and its COMPUTED admissibility matches
  the DECLARED ``PRESET_ADMISSIBLE`` claim; ``EngineConfig`` constructs
  for every (method x backend).

The bound-table relation is injectable (``rel=``) so the seeded-violation
test can prove the checker actually rejects an inconsistent table. A port
of the JAX package's ``analysis/registry_lint.py`` over the port's
registries.
"""
from __future__ import annotations

import itertools
from collections.abc import Callable

from repro_torch.analysis.violations import Violation
from repro_torch.cascade import rescore
from repro_torch.cascade import spec as cspec
from repro_torch.core.retrieval import METHODS

#: iters values the order proof quantifies over — 0 exercises the
#: ACT->RWMD degeneracy, 3 is the serving default, the rest the gaps.
_ITERS_DOMAIN = (0, 1, 2, 3)

#: The single legitimate antisymmetry degeneracy: ACT with zero Phase-2
#: rounds computes exactly the RWMD relaxation, so the two compare equal
#: in both directions without being the same registry entry.
_DEGENERATE = frozenset({frozenset({("act", 0), ("rwmd", 0)})})


def _order_domain() -> list[tuple[str, int]]:
    chain = [(m, i) for m in cspec.BOUND_CHAIN for i in _ITERS_DOMAIN
             if m == "act" or i == 0]
    extras = [(m, 0) for m in cspec.EMD_ONLY_BOUNDS] + [("emd", 0)]
    return chain + extras


def check_bound_table(rel: Callable[[str, int, str, int], bool] | None = None,
                      ) -> list[Violation]:
    """Prove the admissibility relation is the partial order the paper
    claims. ``rel(method, iters, rescorer, rescorer_iters)`` defaults to
    the real :func:`repro_torch.cascade.spec.is_lower_bound`."""
    rel = cspec.is_lower_bound if rel is None else rel
    out: list[Violation] = []
    dom = _order_domain()

    def R(a, b):
        return bool(rel(a[0], a[1], b[0], b[1]))

    for x in dom:
        if not R(x, x):
            out.append(Violation("registry", f"{x[0]}-{x[1]}",
                                 "bound relation is not reflexive"))
    for x, y, z in itertools.product(dom, repeat=3):
        if R(x, y) and R(y, z) and not R(x, z):
            out.append(Violation(
                "registry", f"{x}<={y}<={z}",
                "bound relation is not transitive"))
    for x, y in itertools.combinations(dom, 2):
        if R(x, y) and R(y, x) and frozenset({x, y}) not in _DEGENERATE:
            out.append(Violation(
                "registry", f"{x}~{y}",
                "bound relation is not antisymmetric (mutual bounds on "
                "distinct measures outside the ACT-0 == RWMD degeneracy)"))
    # Chain consistency: each chain member bounds its successor and EMD.
    chain = cspec.BOUND_CHAIN
    for lo, hi in zip(chain, chain[1:], strict=False):
        if not R((lo, 1 if lo == "act" else 0), (hi, 1 if hi == "act" else 0)):
            out.append(Violation(
                "registry", f"{lo}<={hi}",
                "Theorem-2 chain edge missing from the bound table"))
    for m in (*chain, *cspec.EMD_ONLY_BOUNDS):
        if not R((m, 1), ("emd", 0)):
            out.append(Violation(
                "registry", f"{m}<=emd",
                "every registered lower bound must sit below exact EMD"))
    # EMD-only bounds must NOT claim chain membership (wcd's Jensen bound
    # holds against EMD alone — admitting it under an act rescorer would
    # wrongly mark the 'fast' preset exact).
    for m in cspec.EMD_ONLY_BOUNDS:
        for hi in chain:
            if m != hi and R((m, 0), (hi, 3)):
                out.append(Violation(
                    "registry", f"{m}<={hi}",
                    "EMD-only bound admitted inside the directional "
                    "chain"))
    return out


def check_method_specs(methods=None) -> list[Violation]:
    """Structural coherence of every :class:`MethodSpec`."""
    methods = METHODS if methods is None else methods
    out: list[Violation] = []
    for name, spec in sorted(methods.items()):
        if spec.name != name:
            out.append(Violation("registry", name,
                                 f"registry key != spec.name {spec.name!r}"))
        if spec.reverse is not None:
            rev = methods.get(spec.reverse)
            if rev is None:
                out.append(Violation(
                    "registry", name,
                    f"reverse {spec.reverse!r} is not registered"))
            elif rev.reverse != name:
                out.append(Violation(
                    "registry", name,
                    f"reverse link not symmetric: {spec.reverse} points "
                    f"back to {rev.reverse!r}"))
        if spec.symmetric and spec.reverse is not None:
            out.append(Violation(
                "registry", name,
                "a symmetric measure needs no reverse direction"))
        if spec.symmetric_batch_fn is not None and spec.reverse is None \
                and not spec.symmetric:
            out.append(Violation(
                "registry", name,
                "symmetric_batch_fn on a directional method with no "
                "reverse is unreachable"))
        if spec.supports_kernels and spec.batch_fn is None:
            out.append(Violation(
                "registry", name,
                "supports_kernels on a method without a batched engine "
                "(the kernel paths live in the batch pipelines)"))
        bad_axes = [ax for ax in spec.dist_out
                    if ax not in ("data", "model", None)]
        if bad_axes:
            out.append(Violation(
                "registry", name, f"dist_out has unknown axes {bad_axes}"))
        if spec.uses_iters and spec.cand_fn is None:
            out.append(Violation(
                "registry", name,
                "iterated methods must be cascade-rescorable (cand_fn)"))
    return out


def check_cascade_presets(cascades=None, declared=None) -> list[Violation]:
    """Every preset constructs, resolves, and matches its declared
    admissibility; the rescorer registry covers it."""
    cascades = cspec.CASCADES if cascades is None else cascades
    declared = cspec.PRESET_ADMISSIBLE if declared is None else declared
    out: list[Violation] = []
    if set(cascades) != set(declared):
        out.append(Violation(
            "registry", "CASCADES",
            f"PRESET_ADMISSIBLE keys {sorted(declared)} out of sync with "
            f"presets {sorted(cascades)}"))
    for name, spec in sorted(cascades.items()):
        try:
            rescore.resolve(spec.rescorer)
            spec.resolve_budgets(n=4096, top_l=16)
        except (ValueError, KeyError) as e:
            out.append(Violation("registry", f"cascade:{name}", str(e)))
            continue
        if name in declared and spec.admissible != declared[name]:
            out.append(Violation(
                "registry", f"cascade:{name}",
                f"computed admissible={spec.admissible} contradicts the "
                f"declared claim {declared[name]} — the bound table and "
                "the preset's documentation have diverged"))
    return out


def check_api_config() -> list[Violation]:
    """``EngineConfig`` constructs for every (method x backend)."""
    from repro_torch.api import config as api_config
    out: list[Violation] = []
    for method in sorted(METHODS):
        for backend in api_config.BACKENDS:
            try:
                api_config.EngineConfig(method=method, backend=backend)
            except ValueError as e:
                out.append(Violation(
                    "registry", f"EngineConfig({method}, {backend})",
                    str(e)))
    return out


def run(rel=None) -> tuple[list[Violation], int]:
    """All registry-lint checks; returns (violations, subjects checked)."""
    out = (check_bound_table(rel) + check_method_specs()
           + check_cascade_presets() + check_api_config())
    checked = (len(_order_domain()) + len(METHODS) + len(cspec.CASCADES)
               + 1)
    return out, checked
