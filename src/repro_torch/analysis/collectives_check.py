"""Collective-contract checker: run every registry step on a gloo CPU mesh
and hold the bytes its collectives move to a manifest.

Counterpart of the JAX package's ``analysis/collectives_check.py``. For
each ``launch.search.step_cases()`` entry the pass builds the step
(``launch.search.build_step``), runs it once on every rank of a local
2 data x 4 model gloo mesh (``launch.local.run_local``) over JAX's tiny
tracing workload, and reads the bytes each collective label brought to
each rank (``sharding.annotate.traffic()``), summed over the ranks. There
is no counterpart of JAX's ``hlo_collectives.py``: JAX reads its
collectives out of the compiled HLO, while the port's collectives are
calls of ``sharding/annotate.py``, which count their own bytes. Two
contracts:

* **manifest pin**: each case's bytes per label equal the checked-in
  manifest (``manifests/collectives.json``) exactly. The counts follow
  from the shapes alone, whatever the torch version, so the pin never
  relaxes to a warning (JAX's does across jax versions, whose partitioner
  output may change). ``--update-manifests`` regenerates it.
* **scaling guard**: every ``scale_guarded`` case runs again at two
  larger corpora (``SCALE_N_DBS``) and must move the same bytes in every
  label at both: the (nq, n) score matrix never crosses the mesh. A scores
  step's own result gather (label ``scores``: every rank gets the whole
  matrix) is exempt; nothing else is.
"""
from __future__ import annotations

import json
import os

import torch

from repro_torch.analysis.violations import Violation
from repro_torch.configs.emd_20news import EMDWorkload
from repro_torch.launch import search as S

#: Mesh the contract is pinned on: 2 data x 4 model gloo ranks (JAX's).
N_DATA, N_MODEL = 2, 4

#: The tiny workload (JAX's) and its row padding. Dims are multiples of
#: the mesh axes.
CHECK_PAD_MULTIPLE = 8
_BASE = dict(vocab=96, dim=8, hmax=16, iters=2, queries=16)
#: Rows of each synthetic document, and the seed of the corpus.
DOC_LEN, SEED = 10, 0

#: Corpus rows of the manifest run and of the scaling probe. The probe
#: starts at 128: the pinned ladder's shard-local stage is
#: ``blocks * min(budget, n / blocks)`` wide, so its bytes grow until every
#: shard holds the stage budget (n >= 4 * 24 = 96) and are flat after.
CHECK_N_DB = 64
SCALE_N_DBS = (128, 256)

#: The label a scores step's result gather counts under.
RESULT_LABEL = "scores"

#: Seconds the mesh run may take.
TIMEOUT = 600.0

MANIFEST_PATH = os.path.join(os.path.dirname(__file__), "manifests",
                             "collectives.json")


def check_workload(n_db: int = CHECK_N_DB) -> EMDWorkload:
    return EMDWorkload(name="chk", n_db=n_db, **_BASE)


def workload_data(workload: EMDWorkload):
    """The workload's corpus and queries (its first rows), from SEED."""
    from repro_torch.data.synth import make_text_like
    corpus, _ = make_text_like(
        n_docs=workload.n_db, vocab=workload.vocab, m=workload.dim,
        doc_len=DOC_LEN, hmax=workload.hmax, seed=SEED)
    return corpus, corpus.ids[:workload.queries], corpus.w[:workload.queries]


def registry_jobs(cases=None) -> list[tuple]:
    """(case, n_db) of each run the pass needs: every case at
    CHECK_N_DB, each guarded one at SCALE_N_DBS too."""
    cases = S.step_cases() if cases is None else cases
    jobs = [(c, CHECK_N_DB) for c in cases]
    jobs += [(c, n) for c in cases if c.scale_guarded for n in SCALE_N_DBS]
    return jobs


def _rank_traffic(mesh, jobs, step_fn):
    """One rank: each job's step run once, its bytes by label."""
    from repro_torch.sharding import annotate
    data, out = {}, []
    for case, n_db in jobs:
        w = check_workload(n_db)
        if n_db not in data:
            data[n_db] = workload_data(w)
        corpus, q_ids, q_w = data[n_db]
        ops = S.case_operands(case, corpus, q_ids, q_w, mesh,
                              pad_multiple=CHECK_PAD_MULTIPLE)
        step = S.build_step(case, w, mesh) if step_fn is None \
            else step_fn(case, w, mesh)
        annotate.reset_traffic()
        step(*ops)
        out.append(annotate.traffic())
    return out


def measure(jobs, *, step_fn=None) -> dict:
    """{(case name, n_db): {label: bytes, summed over the ranks}} of each
    (case, n_db) job, on one local 2 x 4 gloo mesh. ``step_fn(case,
    workload, mesh)`` builds the steps instead of ``build_step`` (a seeded
    violation; a module-level function, since the ranks import it)."""
    from repro_torch.launch.local import run_local
    ranks = run_local(_rank_traffic, N_DATA, N_MODEL, backend="gloo",
                      device="cpu", args=(list(jobs), step_fn),
                      timeout=TIMEOUT)
    out = {}
    for j, (case, n_db) in enumerate(jobs):
        total = {}
        for rank in ranks:
            for label, n in rank[j].items():
                total[label] = total.get(label, 0) + n
        out[(case.name, n_db)] = dict(sorted(total.items()))
    return out


def build_manifest(traffic: dict, cases=None) -> dict:
    cases = S.step_cases() if cases is None else cases
    return {
        "torch": torch.__version__,
        "backend": "gloo",
        "mesh": [N_DATA, N_MODEL],
        "workload": dict(n_db=CHECK_N_DB, **_BASE),
        "pad_multiple": CHECK_PAD_MULTIPLE,
        "steps": {c.name: traffic[(c.name, CHECK_N_DB)] for c in cases},
    }


def load_manifest(path: str = MANIFEST_PATH) -> dict | None:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def write_manifest(manifest: dict, path: str = MANIFEST_PATH) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


def check_scaling(case: S.StepCase, small: dict,
                  big: dict) -> list[Violation]:
    """A guarded case's bytes at the two SCALE_N_DBS sizes: every label
    equal (a scores step's result gather apart)."""
    n0, n1 = SCALE_N_DBS
    exempt = {RESULT_LABEL} if case.kind == "scores" else set()
    grown = {label: (small.get(label, 0), big.get(label, 0))
             for label in sorted((set(small) | set(big)) - exempt)
             if small.get(label, 0) != big.get(label, 0)}
    if not grown:
        return []
    return [Violation(
        "collectives", case.name,
        f"collective bytes scale with the corpus: {label} {a} at n={n0} "
        f"-> {b} at n={n1}; an array sized by the database rows is "
        "crossing the mesh (the shard-local top-budget / emd_ladder "
        "contract is broken)") for label, (a, b) in grown.items()]


def check(traffic: dict, manifest: dict | None,
          cases=None) -> list[Violation]:
    """The manifest pin and the scaling guard over ``traffic``
    (:func:`measure` of :func:`registry_jobs`)."""
    cases = S.step_cases() if cases is None else cases
    out: list[Violation] = []
    if manifest is None:
        out.append(Violation(
            "collectives", "manifest",
            f"no manifest at {MANIFEST_PATH}; run the CLI with "
            "--update-manifests and commit the result"))
        pinned = {}
    else:
        pinned = manifest.get("steps", {})
        if manifest.get("mesh") != [N_DATA, N_MODEL] or \
                manifest.get("workload") != dict(n_db=CHECK_N_DB, **_BASE):
            out.append(Violation(
                "collectives", "manifest",
                f"pinned on mesh {manifest.get('mesh')} and workload "
                f"{manifest.get('workload')}, the pass runs "
                f"{[N_DATA, N_MODEL]} and {dict(n_db=CHECK_N_DB, **_BASE)}"))
    for case in cases:
        got = traffic[(case.name, CHECK_N_DB)]
        want = pinned.get(case.name)
        if want is None:
            if manifest is not None:
                out.append(Violation(
                    "collectives", case.name,
                    "step missing from the manifest: rerun with "
                    "--update-manifests and review the new profile"))
        elif got != want:
            out.append(Violation(
                "collectives", case.name,
                f"collective bytes drifted from the manifest: got {got}, "
                f"pinned {want}"))
        if case.scale_guarded:
            out += check_scaling(case, *(traffic[(case.name, n)]
                                         for n in SCALE_N_DBS))
    for name in sorted(set(pinned) - {c.name for c in cases}):
        out.append(Violation(
            "collectives", name,
            "the manifest pins a step the registry no longer enumerates: "
            "rerun with --update-manifests"))
    return out


def run(*, update_manifests: bool = False,
        manifest_path: str = MANIFEST_PATH) -> tuple[list[Violation], int]:
    """Manifest pin + scaling guard over every registry case."""
    cases = S.step_cases()
    traffic = measure(registry_jobs(cases))
    if update_manifests:
        write_manifest(build_manifest(traffic, cases), manifest_path)
    return check(traffic, load_manifest(manifest_path), cases), len(cases)
