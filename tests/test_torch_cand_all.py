"""K4's all-rows form (``csrc/cand_dist_all.cu``): the full-corpus rwmd_rev,
symmetric LC-RWMD and LC-ICT reductions, reached through
``ops.cand_rev_min_valid`` / ``ops.cand_ict_valid`` with cand None.

* Its column groups (``cand_pour.column_groups``): every query in exactly
  one group, in order; each group within GROUP_QUERIES queries and
  GROUP_QUADS aligned quads; a query of MAX_LEN columns fits alone at
  every alignment; empty queries take no column; the greedy rule against a
  plain re-statement of it.
* Its launch layout (``ops.block_layout("cand_dist", form="all")``) by
  hand, the static checks' entries for it, and that every tile the family
  admits fits its library whatever the group's width.
* On a CUDA card only: the kernel bitwise the candidate form
  (``csrc/cand_dist_valid.cu``) at cand[q] = every row and within rtol
  1e-5 / atol 1e-6 of the plain version, under f32 and bf16 costs, at 256
  queries over several column groups, a MAX_LEN-column query, rows with no
  live entry, rows of more than 256 live slots and an empty query; its
  compiler figures against the launch model.

Tolerance against the plain version: the kernel sums in its lanes' order
(float32 for rev_min, float64 then one rounding for ict), torch in its
own, so rtol 1e-5 / atol 1e-6 as for the candidate form.
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis import smem
from repro_torch.kernels import cand_pour, ops

F32_TOL = dict(rtol=1e-5, atol=1e-6)
MODES = ("rev_min", "ict")
_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
_OPS = {"rev_min": (ops.cand_rev_min_valid,
                    cand_pour.cand_rev_min_valid_plain),
        "ict": (ops.cand_ict_valid, cand_pour.cand_ict_valid_plain)}


def _span(bounds, a, b):
    """Aligned quads spanned by the non-empty queries a..b-1."""
    full = [q for q in range(a, b) if bounds[q + 1] > bounds[q]]
    if not full:
        return 0
    return (bounds[full[-1] + 1] - 1) // 4 - bounds[full[0]] // 4 + 1


def _bounds(lens):
    return [0] + np.cumsum(lens).tolist()


def _check_plan(bounds):
    nq = len(bounds) - 1
    starts, widest = cand_pour.column_groups(bounds)
    assert starts[0] == 0 and starts[-1] == nq
    assert all(a < b for a, b in zip(starts, starts[1:]))   # in order, once
    spans = [_span(bounds, a, b) for a, b in zip(starts, starts[1:])]
    for (a, b), span in zip(zip(starts, starts[1:]), spans):
        assert b - a <= cand_pour.GROUP_QUERIES
        assert span <= cand_pour.GROUP_QUADS
        # greedy: the next query would not have fitted
        if b < nq and b - a < cand_pour.GROUP_QUERIES:
            assert _span(bounds, a, b + 1) > cand_pour.GROUP_QUADS
    assert widest == max(spans)
    return starts, widest


# ------------------------------------------------------ the column groups


@pytest.mark.parametrize("seed", range(8))
def test_column_groups_cover_every_query_in_order(seed):
    rng = np.random.default_rng(seed)
    nq = int(rng.integers(1, 300))
    lens = rng.integers(0, 140, nq) * (rng.uniform(size=nq) > 0.1)
    _check_plan(_bounds(lens))


@pytest.mark.parametrize("lead", range(4))
def test_max_len_query_fits_alone_at_every_alignment(lead):
    """A query of MAX_LEN columns from column 4k + lead spans at most
    GROUP_QUADS quads: after a wide query it opens a group, which holds
    it whole."""
    bounds = _bounds([200 + lead, cand_pour.MAX_LEN, 3])
    starts, widest = _check_plan(bounds)
    assert starts[:2] == [0, 1]
    assert _span(bounds, 1, 2) <= widest <= cand_pour.GROUP_QUADS


@pytest.mark.parametrize("lens,starts,widest", [
    ([0, 0, 0], [0, 3], 0),                       # every query empty
    ([0] * 40, [0, 16, 32, 40], 0),               # by the query count
    ([0, 5, 0, 7, 0], [0, 5], 3),                 # empties take no column
    ([4] * 17, [0, 16, 17], 16),
    ([1020, 0, 4], [0, 3], 256),                  # 256 quads exactly
    ([600, 400, 30], [0, 2, 3], 250),
    ([1020, 1020, 8], [0, 1, 2, 3], 255),         # 257 quads: one more
])
def test_column_groups_by_hand(lens, starts, widest):
    assert cand_pour.column_groups(_bounds(lens)) == (starts, widest)
    _check_plan(_bounds(lens))


# ---------------------------------------------------- the launch model


def _all_bytes(mode, quads, tbytes=4, warps=4):
    """cand_dist_all.cu's Layout counted by hand, for each warp: a ring of
    4 entries, its group's table, the queue; for ict the
    (query, group) sums, the pours of a step's 2 x 16 pairs, the queue's
    weights and 2 x 32 partials (one a chunk) of 5 numbers (two least
    costs, their columns, the max finite cost)."""
    qg, parts = cand_pour.GROUP_QUERIES, 32
    ict = mode == "ict"
    return warps * (
        4 * 4 * quads * tbytes + (4 * qg + 4) * 4 + 256 * 4
        + ict * (qg * 32 * 8 + 2 * qg * 8 + 256 * 4 + 5 * 2 * parts * 4))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nq,n,h,quads", [
    (16, 18_828, 500, 142), (256, 18_828, 500, 256), (1, 18_828, 500, 34),
    (256, 60_000, 784, 197)])
@pytest.mark.parametrize("block_n", [None, 1, 8])
def test_all_rows_layout_by_hand(mode, nq, n, h, quads, block_n):
    warps = min(4 if block_n is None else block_n, 4)
    for bf16 in (False, True):
        lay = ops.block_layout("cand_dist", nq=nq, b=n, h=h, mode=mode,
                               form="all", quads=quads, bf16=bf16,
                               block_n=block_n)
        assert lay.kernel == "cand_dist_all_kernel"
        assert lay.threads == 32 * warps    # a warp takes rows on its own
        assert lay.static_bytes == 0
        assert lay.dynamic_bytes == _all_bytes(mode, quads, 2 if bf16 else 4,
                                               warps)
        groups = -(-nq // cand_pour.GROUP_QUERIES)
        assert lay.grid == (-(-groups * n // warps),)
        assert smem.check_launch("t", "cand_dist", dict(
            nq=nq, b=n, h=h, mode=mode, form="all", quads=quads, bf16=bf16,
            block_n=block_n)) == []


def test_all_rows_layout_defaults_to_the_widest_group():
    lay = ops.block_layout("cand_dist", nq=16, b=941, h=500, mode="ict",
                           form="all")
    assert lay.dynamic_bytes == _all_bytes("ict", cand_pour.GROUP_QUADS)
    one = ops.block_layout("cand_dist", nq=1, b=941, h=20, mode="rev_min",
                           form="all")
    assert one.dynamic_bytes == _all_bytes("rev_min", 6)
    with pytest.raises(ValueError, match="257"):
        ops.block_layout("cand_dist", nq=1, b=1, h=1, form="all", quads=257)
    with pytest.raises(ValueError, match="form"):
        ops.block_layout("cand_dist", nq=1, b=1, h=1, form="rows")


def test_check_configs_hold_the_all_rows_form():
    entries = {label: dims for label, family, dims in smem.check_configs()
               if family == "cand_dist" and ":all_" in label}
    assert set(entries) == {f"{p}:cand_dist:all_{m}" for m in MODES
                            for p in ("news16", "news256",
                                      "mnist_sparse256", "mnist_dense256",
                                      "nq1")}
    assert all(d["form"] == "all" for d in entries.values())
    violations, _ = smem.run(configs=[(k, "cand_dist", d)
                                      for k, d in entries.items()])
    assert violations == []


@pytest.mark.parametrize("block_n", [1, 2, 4, 8, 16])
def test_every_admitted_tile_fits_the_all_rows_library(block_n):
    """block_n is one macro of two libraries: a tile the family admits
    fits the all-rows kernel at its widest column group too."""
    assert smem.check_tiles("cand_dist", {"block_n": block_n}) == []
    for mode in MODES:
        lay = ops.block_layout("cand_dist", nq=1, b=1, h=1, mode=mode,
                               form="all", quads=cand_pour.GROUP_QUADS,
                               block_n=block_n)
        assert smem.blocks_per_sm(lay) >= 1


def test_the_all_rows_form_has_its_own_source():
    assert ops.family_source("cand_dist", "all") == "cand_dist_all"
    assert ops.family_source("cand_dist") == "cand_dist_valid"
    assert ops.family_source("cand_pour", "all") == "cand_pour_rows"
    assert "cand_dist_all" in cand_pour._build.SOURCES


# ------------------------------------------------------- on a CUDA card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only there")
    return torch.device("cuda")


def _inputs(rng, lens, n, hmax, v, dtype, device, empty_rows=2):
    """A corpus of n rows (the last ``empty_rows`` with no live entry), a
    valid-bin handoff of queries of ``lens`` valid bins (Dv at a row stride
    padded to a multiple of 4, as phase1_valid_dist lays it out)."""
    ids = rng.integers(0, v, (n, hmax)).astype(np.int32)
    w = rng.uniform(size=(n, hmax)) * (rng.uniform(size=(n, hmax)) > 0.3)
    if empty_rows:
        w[-empty_rows:] = 0.0
    w = (w / np.maximum(w.sum(axis=1, keepdims=True), 1e-30)).astype(
        np.float32)
    bounds = _bounds(lens)
    P = bounds[-1]
    qwv = np.zeros(P, np.float32)
    for a, b in zip(bounds, bounds[1:]):
        x = rng.uniform(0.1, 1.0, b - a)
        qwv[a:b] = x / max(x.sum(), 1e-30)
    full = torch.zeros((v, P + (-P % 4)), dtype=dtype, device=device)
    full[:, :P] = torch.tensor(rng.uniform(0.2, 2.0, (v, P)).astype(
        np.float32)).to(dtype)
    return (torch.tensor(ids, device=device), torch.tensor(w, device=device),
            full[:, :P], torch.tensor(bounds, dtype=torch.int32,
                                      device=device),
            torch.tensor(qwv, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case,lens,n,hmax,v", [
    # 256 queries over several column groups, one of them empty
    ("groups", [int(x) for x in np.random.default_rng(1).integers(
        0, 120, 256)], 300, 60, 2000),
    ("max_len", [3, cand_pour.MAX_LEN, 0, 17], 40, 50, 1500),
    ("empty_query", [12, 0, 40, 5], 50, 30, 300),
    ("long_rows", [60, 200, 9], 12, 784, 784),   # > 256 live slots a row
    ("short", [1, 2, 3, 4, 5], 70, 8, 40),
])
def test_cand_dist_all_is_the_candidate_form_at_every_row(rng, cuda, case,
                                                          lens, n, hmax, v,
                                                          dtype):
    ids, w, dv, qoff, qwv = _inputs(rng, lens, n, hmax, v, _DTYPES[dtype],
                                    cuda)
    nq = len(lens)
    if case == "long_rows":
        assert int((w > 0).sum(dim=1).max()) > 256
    if case == "groups":
        assert len(cand_pour.column_groups(qoff.tolist())[0]) > 3
    every = torch.arange(n, device=cuda).expand(nq, n).contiguous()
    for mode in MODES:
        op, plain = _OPS[mode]
        before = dict(cand_pour.valid_launches)
        got = op(ids, w, None, dv, qoff, qwv)
        torch.cuda.synchronize()
        assert cand_pour.valid_launches[f"all_{mode}"] \
            == before[f"all_{mode}"] + 1
        assert cand_pour.valid_launches[mode] == before[mode]
        assert got.shape == (nq, n)
        assert torch.equal(got, op(ids, w, every, dv, qoff, qwv))
        torch.testing.assert_close(got, plain(ids, w, None, dv, qoff, qwv),
                                   **F32_TOL)
        empty = [q for q, k in enumerate(lens) if k == 0]
        assert bool((got[empty] == 0).all())
        if mode == "rev_min":      # a row with no entry: sum(big * qw)
            full = torch.tensor([k > 0 for k in lens], device=cuda)
            assert bool(((got[:, -1] > 1e29) == full).all())
        else:
            assert bool((got[:, -2:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("block_n", [None, 1, 8])
def test_cand_dist_all_figures_match_the_model(rng, cuda, dtype, block_n):
    """The compiler's shared bytes equal the model's at the launch's widest
    group; registers under the cap; every tile bitwise the default."""
    lens = [int(x) for x in rng.integers(1, 90, 40)]
    ids, w, dv, qoff, qwv = _inputs(rng, lens, 60, 40, 500, _DTYPES[dtype],
                                    cuda)
    _, widest = cand_pour.column_groups(qoff.tolist())
    var = ops.variant("cand_dist", block_n=block_n)
    for mode in MODES:
        op, _ = _OPS[mode]
        assert torch.equal(op(ids, w, None, dv, qoff, qwv, block_n=block_n),
                           op(ids, w, None, dv, qoff, qwv))
        a = cand_pour.all_attrs(mode, widest, _DTYPES[dtype], var)
        lay = ops.block_layout("cand_dist", nq=len(lens), b=60, h=90,
                               mode=mode, form="all", quads=widest,
                               bf16=dtype == "bf16", block_n=block_n)
        assert a["static_bytes"] + a["dynamic_bytes"] == lay.smem_bytes
        assert a["regs"] <= smem.reg_cap(lay)
        assert a["max_threads"] >= lay.threads
