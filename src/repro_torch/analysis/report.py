"""Render markdown roofline tables from the dry-run's JSONL results.

The records are JSON lines of the JAX package's dry-run
(``repro/launch/dryrun.py``, default output ``results/dryrun.jsonl``),
each with ``arch``, ``shape``, ``mesh``, ``t_compute``, ``t_memory``,
``t_collective``, ``bottleneck``, ``hlo_flops``, ``model_flops`` and
``useful_flops_ratio``; this module only formats them and imports
nothing of JAX. Prints one markdown table per mesh; keeps the LAST record
per (arch, shape, mesh) so re-runs supersede earlier rows. A port of the
JAX package's ``analysis/report.py``; the port has no dry-run of its own
yet (``launch/dryrun.py``, ROADMAP Queue 1 item 8b, is still to port).

Usage:
    PYTHONPATH=src python -m repro_torch.analysis.report [results/dryrun.jsonl]
"""
from __future__ import annotations

import json
import os
import sys


def load(path: str) -> dict:
    if not os.path.exists(path):
        raise SystemExit(
            f"no dry-run results at {path!r} — generate them first with "
            "the JAX package's dry-run, `PYTHONPATH=src python -m "
            "repro.launch.dryrun --all` (or pass the JSONL path as the "
            "first argument)")
    recs = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            r = json.loads(line)
            recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-4:
        return f"{x*1e6:.1f}us"
    if x < 0.1:
        return f"{x*1e3:.2f}ms"
    return f"{x:.3f}s"


def fmt_e(x: float) -> str:
    return f"{x:.2e}"


def table(recs: dict, mesh: str) -> str:
    rows = [r for (_a, _s, m), r in sorted(recs.items()) if m == mesh]
    out = ["| arch | shape | t_compute | t_memory | t_collective | "
           "bottleneck | HLO FLOPs | model FLOPs | useful | "
           "roofline frac |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        dom = max(r["t_compute"], r["t_memory"], r["t_collective"])
        frac = r["t_compute"] / dom if dom else 0.0
        useful = r.get("useful_flops_ratio", 0.0)
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['t_compute'])} "
            f"| {fmt_s(r['t_memory'])} | {fmt_s(r['t_collective'])} "
            f"| {r['bottleneck']} | {fmt_e(r['hlo_flops'])} "
            f"| {fmt_e(r['model_flops'])} | {useful:.2f} | {frac:.3f} |")
    return "\n".join(out)


def summary(recs: dict, mesh: str) -> str:
    rows = [r for (_a, _s, m), r in sorted(recs.items()) if m == mesh]
    worst = min(rows, key=lambda r: (
        r["t_compute"] / max(r["t_compute"], r["t_memory"],
                             r["t_collective"], 1e-30)))
    most_coll = max(rows, key=lambda r: r["t_collective"]
                    / max(r["t_compute"] + r["t_memory"], 1e-30))
    return (f"worst roofline fraction: {worst['arch']} x {worst['shape']}; "
            f"most collective-bound: {most_coll['arch']} x "
            f"{most_coll['shape']}")


def main() -> None:
    path = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun.jsonl"
    recs = load(path)
    meshes = sorted({m for (_, _, m) in recs})
    for mesh in meshes:
        n = sum(1 for k in recs if k[2] == mesh)
        print(f"\n### Mesh {mesh} ({n} cells)\n")
        print(table(recs, mesh))
        print("\n" + summary(recs, mesh))


if __name__ == "__main__":
    main()
