"""The port's static checks (``repro_torch.analysis``): each pass runs clean
on the repo as it stands and rejects a seeded violation of exactly the
invariant it guards.

Counterparts of ``tests/test_analysis.py``'s registry tests (the port's
registries; the JAX package's ``dist_fn`` check belongs to its mesh engine
and is replaced by the kernel-support check), of its ``test_vmem_*`` and
``test_block_layout_*`` tests where they mean something on sm_90 (the
budget is shared memory, registers and threads, not VMEM), and of its CLI
tests. Parity with the JAX package: the registry lint gives JAX's verdicts
on the same (seeded) relations and presets, and the report renders the
same tables. The collectives pass (``collectives_check``) runs the step
registry once on its 2 x 4 gloo mesh, shared by its tests: clean against
the manifest, a changed manifest entry caught, the guarded steps flat and
a seeded score-matrix gather flagged.
"""
import copy
import dataclasses
import functools
import json

import pytest

import torch_mesh_ranks as ranks

from repro.analysis import registry_lint as jlint
from repro.analysis import report as jreport
from repro.cascade import spec as jspec
from repro_torch.analysis import (check, collectives_check, registry_lint,
                                  report, smem)
from repro_torch.analysis.violations import Violation, render
from repro_torch.cascade import spec as cspec
from repro_torch.core.retrieval import METHODS
from repro_torch.kernels import ops
from repro_torch.launch import search as dsearch

# ---------------------------------------------------------------- registry


def test_registry_lint_clean():
    violations, checked = registry_lint.run()
    assert violations == []
    assert checked > 0


def _seeded(is_lower_bound, kind):
    """A seeded bad relation of ``kind`` over a package's own table."""
    def rel(m, i, r, ri):
        if kind == "reflexive" and (m, i) == (r, ri) == ("ict", 0):
            return False
        if kind == "chain" and (m, r) == ("omr", "rwmd"):
            return True
        if kind == "emd_only" and m == "wcd" and r == "act":
            return True
        return is_lower_bound(m, i, r, ri)
    return rel


def test_bound_table_rejects_missing_reflexivity():
    out = registry_lint.check_bound_table(
        _seeded(cspec.is_lower_bound, "reflexive"))
    assert any("reflexive" in v.message for v in out)


def test_bound_table_rejects_inconsistent_chain_edge():
    # The inverted edge OMR <= RWMD: with RWMD <= OMR still present the
    # pair becomes mutually bounding (antisymmetry breaks).
    out = registry_lint.check_bound_table(
        _seeded(cspec.is_lower_bound, "chain"))
    assert any("antisymmetric" in v.message for v in out)


def test_bound_table_rejects_emd_only_bound_in_chain():
    # wcd admitted under an act rescorer would wrongly mark 'fast' exact.
    out = registry_lint.check_bound_table(
        _seeded(cspec.is_lower_bound, "emd_only"))
    assert any("EMD-only" in v.message for v in out)


def test_method_specs_reject_asymmetric_reverse_link():
    methods = dict(METHODS)
    methods["rwmd"] = dataclasses.replace(METHODS["rwmd"], reverse="omr")
    out = registry_lint.check_method_specs(methods)
    assert any("not symmetric" in v.message for v in out)


def test_method_specs_reject_kernels_without_a_batched_engine():
    methods = dict(METHODS)
    methods["bow"] = dataclasses.replace(METHODS["bow"],
                                         supports_kernels=True,
                                         batch_fn=None)
    out = registry_lint.check_method_specs(methods)
    assert any("without a batched engine" in v.message for v in out)


@pytest.mark.parametrize("layout,bad", [
    (("data", "pod"), ["pod"]),
    (("rows", None), ["rows"]),
    ((None, "vocab"), ["vocab"]),
    (("pod", "rows"), ["pod", "rows"]),
])
def test_method_specs_reject_unknown_dist_out_axes(layout, bad):
    methods = dict(METHODS)
    methods["act"] = dataclasses.replace(METHODS["act"], dist_out=layout)
    out = registry_lint.check_method_specs(methods)
    assert [v.message for v in out if v.subject == "act"] == \
        [f"dist_out has unknown axes {bad}"]


def test_method_specs_mesh_checks_give_jax_verdicts():
    """The seeded dist_out registrations get the same verdicts from both
    packages' lints."""
    from repro.core.retrieval import METHODS as JMETHODS

    def seeded(methods):
        m = dict(methods)
        m["act"] = dataclasses.replace(m["act"], dist_out=("data", "pod"))
        m["wcd"] = dataclasses.replace(m["wcd"], dist_out=("rows", None))
        return m

    def verdicts(out):
        return sorted((v.subject, v.message) for v in out)
    assert verdicts(registry_lint.check_method_specs(seeded(METHODS))) == \
        verdicts(jlint.check_method_specs(seeded(JMETHODS)))


def test_presets_reject_admissibility_drift():
    declared = dict(cspec.PRESET_ADMISSIBLE, fast=True)   # wcd stage lies
    out = registry_lint.check_cascade_presets(declared=declared)
    assert any("contradicts" in v.message for v in out)


def test_presets_reject_key_drift():
    declared = dict(cspec.PRESET_ADMISSIBLE)
    declared.pop("tight")
    out = registry_lint.check_cascade_presets(declared=declared)
    assert any("out of sync" in v.message for v in out)


@pytest.mark.parametrize("kind", [None, "reflexive", "chain", "emd_only"])
def test_registry_lint_gives_jax_verdicts(kind):
    """The same seeded relation over each package's own bound table gives
    the same violations, and so do the presets with a seeded claim."""
    ours = (cspec.is_lower_bound if kind is None
            else _seeded(cspec.is_lower_bound, kind))
    theirs = (jspec.is_lower_bound if kind is None
              else _seeded(jspec.is_lower_bound, kind))

    def verdicts(out):
        return sorted((v.subject, v.message) for v in out)
    assert verdicts(registry_lint.check_bound_table(ours)) \
        == verdicts(jlint.check_bound_table(theirs))
    for declared in (None, dict(cspec.PRESET_ADMISSIBLE, fast=True)):
        assert verdicts(registry_lint.check_cascade_presets(
            declared=declared)) == verdicts(jlint.check_cascade_presets(
                declared=declared))


# -------------------------------------------------------------------- smem


def test_smem_clean_on_checked_profiles():
    violations, checked = smem.run()
    assert violations == []
    assert checked == len(smem.check_configs())


def test_smem_rejects_over_budget_blocks():
    out = smem.check_launch("seeded", "dist_topk",
                            dict(nq=16, v=69_682, h=500, m=300, k=8,
                                 block_v=512, block_h=128))
    assert any("exceeds the 232448 B budget" in v.message for v in out)
    out = smem.check_launch("seeded", "cand_pour",
                            dict(nq=16, b=941, h=500, iters=3, block_n=16))
    assert any("static limit" in v.message for v in out)
    out = smem.check_launch("seeded", "dist_topk",
                            dict(nq=1, v=64, h=8, m=4, k=1, block_v=32,
                                 block_h=256))
    assert any("accumulator" in v.message for v in out)


def test_smem_rejects_invalid_config():
    out = smem.check_launch("seeded", "dist_topk",
                            dict(nq=8, v=0, h=64, m=32, k=8))
    assert any("invalid launch config" in v.message for v in out)
    out = smem.check_launch("seeded", "nope", dict())
    assert any("invalid launch config" in v.message for v in out)
    out = smem.check_launch("seeded", "act_phase2_cand",
                            dict(nq=2, n=8, h=4, iters=1, block_n=4))
    assert any("fixed tile" in v.message for v in out)


def test_smem_budget_is_configurable():
    label, family, dims = smem.check_configs()[0]
    assert smem.check_launch(label, family, dims) == []
    out = smem.check_launch(label, family, dims,
                            budget=smem.Budget(smem_per_block=1024))
    assert any("exceeds" in v.message for v in out)
    # an SM budget below one block's bytes and reservation fits no block
    out = smem.check_launch(label, family, dims,
                            budget=smem.Budget(smem_per_sm=60_000))
    assert any("no block fits" in v.message for v in out)


def test_smem_rejects_degenerate_grid(monkeypatch):
    dims = dict(nq=1, b=1, h=1)
    assert smem.check_launch("seeded", "cand_dist", dims) == []
    bad = dataclasses.replace(ops.block_layout("cand_dist", **dims),
                              grid=(0,))
    monkeypatch.setitem(ops.KERNEL_FAMILIES, "cand_dist", lambda **_: bad)
    out = smem.check_launch("seeded", "cand_dist", dims)
    assert any("degenerate grid" in v.message for v in out)


def test_block_layout_dist_topk_by_hand():
    """K1's ``Smem`` struct counted by hand at the default tile: the
    coords ring 4 x 8 x 132, the bins ring 4 x 8 x 68, the (128, 65)
    distance tile, 128 + 64 norms, 2 x 64 column tags, four bytes each:
    60,160 B, all dynamic."""
    layout = ops.block_layout("dist_topk", nq=16, v=69_682, h=500, m=300,
                              k=8)
    by_hand = 4 * (4 * 8 * 132 + 4 * 8 * 68 + 128 * 65 + 128 + 64 + 64
                   + 64)
    assert by_hand == 60_160 == layout.smem_bytes == layout.dynamic_bytes
    assert layout.static_bytes == 0
    assert layout.threads == 128 and layout.min_blocks == 3
    assert smem.reg_cap(layout) == 168 and smem.blocks_per_sm(layout) == 3
    # 545 vocabulary tiles fill a wave alone: one query group
    assert layout.grid == (545, 1)
    # at MNIST width 7 tiles do not: the queries split into groups
    small = ops.block_layout("dist_topk", nq=256, v=784, h=784, m=2, k=8)
    assert small.grid == (7, 52)


def test_block_layout_warp_per_row_families():
    act = ops.block_layout("act_phase2", nq=16, n=18_828, h=500, iters=7)
    assert act.threads == 256 and act.grid == (-(-16 * 18_828 // 8),)
    assert act.smem_bytes == 0
    rows = ops.block_layout("cand_pour", nq=16, b=18_828, h=500, iters=0,
                            form="all")
    assert rows.grid == (18_828 // 4,)            # one 16-query chunk
    assert rows.static_bytes == 4 * 32 * 16 * 8 == 16_384
    valid = ops.block_layout("cand_dist", nq=16, b=941, h=500, mode="ict",
                             block_n=16)
    assert valid.static_bytes == 16 * 32 * 8 * 8
    # rev_min reads no queued weight: the compiler drops that array
    assert ops.block_layout("cand_dist", nq=16, b=941, h=500,
                            mode="rev_min").static_bytes == 4 * 32 * 8 * 4
    # but a variant's library holds both modes' kernels
    assert smem.check_launch("t", "cand_dist", dict(
        nq=16, b=941, h=500, mode="rev_min", block_n=32)) == []
    assert smem.check_tiles("cand_dist", {"block_n": 32})
    assert smem.reg_cap(valid) == 128                 # 512 threads
    k5 = ops.block_layout("act_phase2_cand", nq=16, n=941, h=500, iters=3)
    assert k5.threads == 256 and k5.family == "act_phase2_cand"


@pytest.mark.parametrize("threads,min_blocks,cap", [
    (128, 3, 168), (64, 6, 168), (256, 1, 255), (512, 1, 128),
    (1024, 1, 64), (32, 12, 168)])
def test_reg_cap_follows_launch_bounds(threads, min_blocks, cap):
    layout = ops.KernelBlocks(family="x", kernel="x", grid=(1,),
                              threads=threads, buffers=(),
                              min_blocks=min_blocks)
    assert smem.reg_cap(layout) == cap
    assert smem.blocks_per_sm(layout) >= min_blocks or threads > 1024


def test_fixed_tile_kernels_are_listed():
    assert set(ops.KERNEL_FAMILIES) == {"dist_topk", "act_phase2",
                                        "act_phase2_cand", "cand_pour",
                                        "cand_dist"}
    assert any("stacked K3" in k for k in ops.FIXED_TILES)
    assert any("stacked K4" in k for k in ops.FIXED_TILES)
    assert any("K5" in k for k in ops.FIXED_TILES)
    assert ops.TILE_MACROS["act_phase2_cand"] == {}


# ----------------------------------------------------------- the report


def test_report_renders_the_jax_tables(tmp_path, capsys):
    path = tmp_path / "dryrun.jsonl"
    recs = [dict(arch=a, shape=s, mesh=m, t_compute=tc, t_memory=tm,
                 t_collective=tl, bottleneck="compute", hlo_flops=1e12,
                 model_flops=9e11, useful_flops_ratio=0.9)
            for a, s, m, tc, tm, tl in (("emd", "20news", "1x1", 2e-3,
                                         1e-3, 0.0),
                                        ("emd", "mnist", "1x1", 5e-5, 1e-4,
                                         0.0),
                                        ("emd", "20news", "2x4", 1e-3,
                                         1e-3, 2e-4))]
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    ours, theirs = report.load(str(path)), jreport.load(str(path))
    assert ours == theirs
    for mesh in ("1x1", "2x4"):
        assert report.table(ours, mesh) == jreport.table(theirs, mesh)
        assert report.summary(ours, mesh) == jreport.summary(theirs, mesh)
    with pytest.raises(SystemExit, match="no dry-run results"):
        report.load(str(tmp_path / "none.jsonl"))


def test_render_matches_the_jax_format():
    from repro.analysis.violations import Violation as JViolation
    from repro.analysis.violations import render as jrender
    v = [Violation("smem", "k1", "too big")]
    jv = [JViolation("smem", "k1", "too big")]
    assert render(v, checked=3, passname="smem") \
        == jrender(jv, checked=3, passname="smem")
    assert render([], checked=3, passname="smem") \
        == jrender([], checked=3, passname="smem")


# -------------------------------------------------------------------- CLI


def test_cli_runs_registry_and_smem_clean(capsys):
    rc = check.main(["--passes", "registry", "smem"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "PASS registry" in out and "PASS smem" in out
    assert check.main(["--passes", "registry,smem"]) == 0
    assert check.main([]) == 0
    assert "PASS collectives" in capsys.readouterr().out


def test_cli_collectives_pass_runs_clean(capsys, monkeypatch):
    """``--passes collectives`` on the shared measurement (the run of the
    whole CLI above spawns its own)."""
    data = _collectives()
    monkeypatch.setattr(collectives_check, "measure",
                        lambda jobs: {(c.name, n): data[(c.name, n)]
                                      for c, n in jobs})
    assert check.main(["--passes", "collectives"]) == 0
    assert "PASS collectives: 31 subject(s) clean" in \
        capsys.readouterr().out


def test_cli_rejects_unknown_pass():
    with pytest.raises(SystemExit):
        check.main(["--passes", "nope"])


@pytest.mark.parametrize("name,item", [("hazards", 7), ("precision", 7),
                                       ("bench", 1)])
def test_cli_unported_passes_name_their_roadmap_item(name, item):
    with pytest.raises(SystemExit, match=f"not yet ported.*item {item}"):
        check.main(["--passes", name])


def test_cli_fails_on_a_seeded_over_budget_launch(capsys):
    rc = check.main(["--passes", "smem", "--smem-budget-kb", "32"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "FAIL smem" in out and "dist_topk" in out


# ------------------------------------------------------------ collectives


@functools.cache
def _collectives():
    """The registry's jobs and the seeded step's, on one mesh each."""
    out = collectives_check.measure(collectives_check.registry_jobs())
    pinned = _case("cascade:pinned:dist")
    seeded = collectives_check.measure(
        [(pinned, n) for n in collectives_check.SCALE_N_DBS],
        step_fn=ranks.seeded_step)
    out.update({("seeded", n): t for (_, n), t in seeded.items()})
    return out


def _case(name):
    return next(c for c in dsearch.step_cases() if c.name == name)


def test_collectives_clean_against_the_manifest():
    manifest = collectives_check.load_manifest()
    assert collectives_check.check(_collectives(), manifest) == []
    assert manifest["mesh"] == [2, 4] and manifest["backend"] == "gloo"
    assert "torch" in manifest
    assert set(manifest["steps"]) == {c.name for c in dsearch.step_cases()}


def test_collectives_pin_fails_on_one_changed_entry():
    manifest = copy.deepcopy(collectives_check.load_manifest())
    manifest["steps"]["cascade:pinned:dist"]["shard_topk"] += 4
    violations = collectives_check.check(_collectives(), manifest)
    assert [v.subject for v in violations] == ["cascade:pinned:dist"]
    assert "drifted from the manifest" in violations[0].message
    del manifest["steps"]["search:act:dist"]
    manifest["steps"]["scores:gone:dist"] = {}
    subjects = {v.subject for v in
                collectives_check.check(_collectives(), manifest)}
    assert {"search:act:dist", "scores:gone:dist"} <= subjects


@pytest.mark.parametrize("name", ["cascade:pinned:dist",
                                  "cascade:pinned:dist:kernels",
                                  "cascade:sourced:lsh:dist",
                                  "cascade:sourced:lsh:dist:kernels",
                                  "cascade:sourced:tree:dist",
                                  "search:act:dist"])
def test_collectives_guarded_steps_stay_flat(name):
    case = _case(name)
    small, big = (_collectives()[(name, n)]
                  for n in collectives_check.SCALE_N_DBS)
    assert case.scale_guarded and small == big and "scores" not in small
    assert collectives_check.check_scaling(case, small, big) == []


def test_collectives_guard_flags_a_seeded_score_matrix_gather():
    small, big = (_collectives()[("seeded", n)]
                  for n in collectives_check.SCALE_N_DBS)
    violations = collectives_check.check_scaling(
        _case("cascade:pinned:dist"), small, big)
    assert len(violations) == 1
    assert "scale with the corpus" in violations[0].message
    assert violations[0].message.startswith("collective bytes scale with "
                                            "the corpus: scores")
