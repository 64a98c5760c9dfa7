"""Static contract checker of the port: one CLI over its pre-run
invariants.

    PYTHONPATH=src python -m repro_torch.analysis.check [--passes ...]

Each pass is a module in this package returning
:class:`~repro_torch.analysis.violations.Violation` records; the CLI
renders a per-pass report and exits non-zero if any violation survives:

* ``registry`` -- bound-table partial order, MethodSpec coherence,
  cascade-preset admissibility claims (``registry_lint``). Pure Python.
* ``smem``     -- every kernel launch of ``chip_smoke.py``'s shapes against
  sm_90's shared-memory, register and thread budget, from the kernels'
  launch layouts (``smem``). Pure arithmetic.
* ``collectives`` -- every registry step (``launch.search.step_cases``) on
  a local 2 x 4 gloo mesh: its collective bytes against the manifest, and
  the scale-guarded steps flat in the corpus size (``collectives_check``).
  Spawns 8 CPU ranks; ``--update-manifests`` rewrites the manifest.

The JAX package's other passes are not yet ported: ``hazards`` and
``precision`` trace the JAX steps (ROADMAP Queue 1 item 7) and ``bench``
reads the benches' artifacts (item 1).
"""
from __future__ import annotations

import argparse
import importlib
import sys

from repro_torch.analysis.violations import render

#: Pass name -> module.
PASSES = {
    "registry": "repro_torch.analysis.registry_lint",
    "smem": "repro_torch.analysis.smem",
    "collectives": "repro_torch.analysis.collectives_check",
}

#: The JAX package's passes the port does not have yet -> ROADMAP item.
UNPORTED = {"hazards": 7, "precision": 7, "bench": 1}


def _parse(argv):
    p = argparse.ArgumentParser(
        prog="repro_torch.analysis.check",
        description="static registry, sm_90 kernel-budget and mesh "
                    "collective checks")
    p.add_argument("--passes", nargs="+", default=None,
                   help=f"passes to run, space- or comma-separated, from "
                        f"{', '.join(PASSES)} (default: all)")
    p.add_argument("--smem-budget-kb", type=float, default=227.0,
                   help="shared memory a block may hold, in KB (default: "
                        "sm_90's 227)")
    p.add_argument("--update-manifests", action="store_true",
                   help="collectives: rewrite the manifest from this run")
    return p.parse_args(argv)


def _selected(arg) -> list[str]:
    if arg is None:
        return list(PASSES)
    names = [s.strip() for a in arg for s in a.split(",") if s.strip()]
    for name in names:
        if name in UNPORTED:
            raise SystemExit(f"pass {name!r} is not yet ported: ROADMAP "
                             f"Queue 1 item {UNPORTED[name]}")
        if name not in PASSES:
            raise SystemExit(f"unknown pass {name!r}; one of "
                             f"{list(PASSES)}")
    return names


def main(argv=None) -> int:
    args = _parse(sys.argv[1:] if argv is None else argv)
    selected = _selected(args.passes)
    failures = 0
    for name in selected:
        mod = importlib.import_module(PASSES[name])
        kwargs = {}
        if name == "smem":
            kwargs["budget"] = mod.Budget(
                smem_per_block=int(args.smem_budget_kb * 1024))
        if name == "collectives":
            kwargs["update_manifests"] = args.update_manifests
        violations, checked = mod.run(**kwargs)
        print(render(violations, checked=checked, passname=name))
        failures += len(violations)
    print(f"\n{'FAIL' if failures else 'OK'}: {len(selected)} pass(es), "
          f"{failures} violation(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
