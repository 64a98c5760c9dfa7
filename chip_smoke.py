#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Needs one CUDA device and ``nvcc`` (``/usr/local/cuda``). Phases:

0. the card: ``nvidia-smi`` name and power limit, the device name;
1. build: the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once), with the compiler's register report;
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and on its inputs: ``dist_topk`` (K1) at nq=16, v=69682,
   h=500, m=300 for k in {8, 2, 1} x {float32, bfloat16} on three masks
   (the batch's, all 8000 slots valid, and the batch with query 0 emptied
   and query 1 filled); ``act_phase2`` (K2) at 8 queries x 18828 rows x
   hmax 500, iters=7, on the gathered ladders, and its fused-gather entry
   ``act_phase2_gather`` on the Phase-1 ladders of all 16 queries (one
   launch, as the engine makes it), bitwise against K2 on the first 8 and
   within tolerance of the plain version, under float32 and bfloat16;
3. the main path end to end: a 20 Newsgroups-shaped corpus (n=18828,
   v=69682, m=300, hmax=500, seed 0), ``EmdIndex(backend="cuda").search``
   for 16 corpus rows with LC-ACT (iters=7, top_l=16), with LC-RWMD and
   with LC-OMR (the two full-corpus users of K3's all-rows form), each
   held against ``backend="reference"`` on the same card, with the
   kernels' launch counts set to 0 before each and read after;
4. times (CUDA events after warm-up): each kernel, its plain version, its
   bound and, for K1, one library call (``torch.cdist`` + ``torch.topk``)
   as a yardstick the port never calls, on the valid work and at full
   width; K1 again with all slots valid; seconds per 16-query search; peak
   device memory above the resident index;
5. the candidate kernels against their plain versions on the card, on the
   inputs the cascade gives them at that width, under float32 and bfloat16
   handoffs: ``cand_pour`` (K3) mode ``omr`` at b=3766 candidates per
   query and mode ``pour`` at iters 0 and 3 (b=941), K3's corpus-row
   entry ``cand_pour_rows`` (the engines' K3) in the same modes and in its
   all-rows form (the LC-RWMD dump and LC-OMR over all 18828 rows), also
   against the old K3 on the same rows, ``cand_dist`` (K4)
   modes ``ict`` and ``rev_min`` (b=941) on the stacked handoff and on the
   valid-bin handoff (``cand_dist_valid``, the entry the engines call),
   the latter also against the stacked K4 on the same costs,
   ``act_phase2_cand`` (K5) on pre-gathered ladders; one-slot probes show
   the gathers are bitwise;
6. the cascade end to end: ``EmdIndex(backend="cuda").search(...,
   cascade=p)`` for p in ``chain``, ``tight``, ``fast`` and a custom
   ``rwmd -> rwmd_rev -> act-3`` ladder (K4's ``rev_min`` through the
   engine), 16 queries, top-16, each against ``backend="reference"`` on the
   card, with every launch count set to 0 before each search and read
   after (``tight`` and the rwmd_rev ladder must launch K4's valid-bin
   entry and never the stacked one); for the admissible presets, every
   true top-16 row of full-corpus rescoring that survives the pruning must
   be in the result (exactness wherever the budgets keep the true
   neighbours), and the recall and the number pruned by the budgets are
   printed; the recall of ``fast`` and of the rwmd_rev ladder against
   full-corpus act-3 must be the same on both backends; every search
   launches K3's corpus-row entry once per stage and batch and the old K3
   never;
7. times: each candidate kernel, its plain version, its bound and, where
   one PyTorch call computes the same function, that call (for the
   all-rows iters=0 form an ``embedding_bag`` over the whole corpus); K3's
   corpus-row entry as the bare launch, in a CUDA graph of 20 launches (its
   device time) and through its wrapper; the valid-bin
   handoff against the stacked one, with its host sync apart; seconds per
   16-query cascaded search and peak device memory for each ladder
   (under 1 GiB above the resident index for ``tight`` and the rwmd_rev
   ladder, which no longer build the stacked handoff).

Any failed check exits non-zero before the last line. The last lines are the
card's name and power limit, a JSON line of the kernels and
``{"ok": true, "device": {...}}``.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.api import EmdIndex, EngineConfig  # noqa: E402
from repro_torch.cascade import (CascadeSpec, CascadeStage,  # noqa: E402
                                 resolve_spec, topk_recall, topk_smallest)
from repro_torch.cascade import search as cascade_search  # noqa: E402
from repro_torch.core import lc, retrieval  # noqa: E402
from repro_torch.core.precision import pad_dist_for  # noqa: E402
from repro_torch.data.synth import make_clustered_text  # noqa: E402
from repro_torch.kernels import (_build, act_phase2, cand_pour,  # noqa: E402
                                 dist_topk, ops)

# 20 Newsgroups width: the JAX package's configs/emd_20news.py.
N_DOCS, VOCAB, DIM, HMAX, ITERS = 18_828, 69_682, 300, 500, 7
NQ, TOP_L, BLOCK_Q, SEED = 16, 16, 8, 0

# Published H100 SXM peaks (the bound of a kernel is the larger of bytes over
# the memory rate and operations over the float32 SIMT rate).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# K1 vs plain: Z within these (float32: the kernel's FMA order against
# cuBLAS's, on distances ~1.4; bfloat16: one bf16 ulp in [1, 2) is 2^-7).
# S may differ only between two valid columns whose float64 distances to the
# row differ by at most K1_TIE_TOL; at sentinel slots S must be equal.
K1_Z_ATOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
K1_TIE_TOL = 1e-5
# K2 vs plain and end-to-end cuda vs reference scores: rtol plus an atol,
# since a self-match scores ~1e-8 on one path and 0.0 on the other.
RTOL, ATOL = 1e-5, 1e-6


# Slice 2, the cascade. The presets' act-3 rescorer and stages; the
# candidate budgets of the presets at n=18828: 20% = 3766, 5% = 941.
ACT3 = 3
B_WIDE, B_NARROW = 3766, 941
#: A ladder with an rwmd_rev stage, so that K4's rev_min runs in a search.
REV_SPEC = CascadeSpec(stages=(CascadeStage("rwmd", 0.2),
                               CascadeStage("rwmd_rev", 0.05)),
                       rescorer="act", rescorer_iters=ACT3)
CASCADES = {"chain": "chain", "tight": "tight", "fast": "fast",
            "rwmd_rev": REV_SPEC}
#: Peak device memory above the resident index allowed to the searches
#: that take the valid-bin handoff (the stacked one took 6.24 GiB).
VALID_PEAK_GIB = 1.0
#: The candidate kernels of the JSON line: name -> (source, TPU kernel).
CAND_KERNELS = {
    "cand_pour.pour": ("cand_pour", "src/repro/kernels/cand_pour.py:176"),
    "cand_pour.pour_iters0": ("cand_pour",
                              "src/repro/kernels/cand_pour.py:176"),
    "cand_pour.omr": ("cand_pour", "src/repro/kernels/cand_pour.py:176"),
    "cand_dist.ict": ("cand_dist", "src/repro/kernels/cand_pour.py:214"),
    "cand_dist.rev_min": ("cand_dist",
                          "src/repro/kernels/cand_pour.py:214"),
    "cand_dist_valid.ict": ("cand_dist_valid",
                            "src/repro/kernels/cand_pour.py:214"),
    "cand_dist_valid.rev_min": ("cand_dist_valid",
                                "src/repro/kernels/cand_pour.py:214"),
    "act_phase2_cand": ("act_phase2", "src/repro/kernels/act_phase2.py:110"),
    **{f"cand_pour_rows.{m}": ("cand_pour_rows",
                               "src/repro/kernels/cand_pour.py:176")
       for m in ("pour", "pour_iters0", "omr", "all_pour_iters0",
                 "all_omr")},
}
#: K3's corpus-row entry: JSON name -> its key in ``rows_launches``.
ROWS_KEYS = {"pour": "pour", "pour_iters0": "pour0", "omr": "omr",
             "all_pour_iters0": "all_pour0", "all_omr": "all_omr"}
#: Launches of K3's corpus-row entry each search must make (one per stage
#: and batch), and the old K3 none.
ROWS_EXPECTED = {
    "chain": {"all_pour_iters0": 1, "omr": 1, "pour": 1},
    "tight": {"all_pour_iters0": 1, "pour": 1},
    "fast": {"pour_iters0": 1, "pour": 1},
    "rwmd_rev": {"all_pour_iters0": 1, "pour": 1},
}


def check(cond, msg):
    if not cond:
        print(f"FAIL: {msg}", flush=True)
        sys.exit(1)


def cuda_ms(fn, reps=5, warmup=2):
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timings."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_dist_topk(coords, qcs, qmask, k, dtype):
    """K1 against its plain version; returns max |Z - Z_plain|."""
    zk, sk = ops.dist_topk_batched(coords, qcs, qmask, k, out_dtype=dtype)
    zp, sp = dist_topk.dist_topk_plain(coords, qcs, qmask, k, dtype)
    torch.cuda.synchronize()
    err = (zk.float() - zp.float()).abs().max().item()
    check(err <= K1_Z_ATOL[dtype],
          f"dist_topk k={k} {dtype}: max |dZ| {err} > {K1_Z_ATOL[dtype]}")
    sentinel = zp.float() >= pad_dist_for(dtype)
    check(bool((sk == sp)[sentinel].all()),
          f"dist_topk k={k} {dtype}: S differs at a sentinel slot")
    q, i, _ = torch.nonzero(sk != sp, as_tuple=True)
    ck, cp = sk[sk != sp].long(), sp[sk != sp].long()
    a = coords[i].double()
    dk = (a - qcs[q, ck].double()).norm(dim=-1)
    dp = (a - qcs[q, cp].double()).norm(dim=-1)
    gap = (dk - dp).abs().max().item() if len(q) else 0.0
    check(bool(qmask[q, ck].all()) and gap <= K1_TIE_TOL,
          f"dist_topk k={k} {dtype}: S differs beyond a tie (gap {gap})")
    print(f"  K1 k={k} {str(dtype):14s} max|dZ|={err:.3g} "
          f"S differs at {len(q)} near-tie positions (max gap {gap:.3g})",
          flush=True)
    return err


def zero_counts():
    dist_topk.launches = act_phase2.launches = act_phase2.cand_launches = 0
    act_phase2.gather_launches = 0
    for mode in cand_pour.launches:
        cand_pour.launches[mode] = 0
    for mode in cand_pour.valid_launches:
        cand_pour.valid_launches[mode] = 0
    for mode in cand_pour.rows_launches:
        cand_pour.rows_launches[mode] = 0


def read_counts():
    """Launches since :func:`zero_counts`, by kernel and mode."""
    c = cand_pour.launches
    return {"dist_topk": dist_topk.launches,
            "act_phase2": act_phase2.launches,
            "act_phase2_gather": act_phase2.gather_launches,
            "cand_pour.pour": c["pour"], "cand_pour.pour_iters0": c["pour0"],
            "cand_pour.omr": c["omr"],
            "cand_dist.rev_min": c["rev_min"], "cand_dist.ict": c["ict"],
            "cand_dist_valid.rev_min": cand_pour.valid_launches["rev_min"],
            "cand_dist_valid.ict": cand_pour.valid_launches["ict"],
            "act_phase2_cand": act_phase2.cand_launches,
            **{f"cand_pour_rows.{name}": cand_pour.rows_launches[key]
               for name, key in ROWS_KEYS.items()}}


def rows_of(counts):
    """The launches of K3's corpus-row entry in ``counts``, by mode."""
    return {name: counts[f"cand_pour_rows.{name}"] for name in ROWS_KEYS}


def firm_ranks(s_ref, next_ref):
    """Ranks of the reference top-l separated from both neighbours by more
    than twice the score tolerance (next_ref: the score after the last)."""
    tol = 2 * (ATOL + RTOL * s_ref.abs())
    gap_prev = torch.cat([torch.full_like(s_ref[:, :1], np.inf),
                          s_ref[:, 1:] - s_ref[:, :-1]], dim=1)
    gap_next = torch.cat([s_ref[:, 1:], next_ref[:, None]], dim=1) - s_ref
    return (gap_prev > tol) & (gap_next > tol)


def cand_cases(corpus, q_ids, q_w, wide, narrow, precision):
    """The candidate kernels on the cascade's inputs: name -> (kernel call,
    plain call, bytes, operations). ``wide``/``narrow``: (nq, b) candidate
    row ids. Bytes count each input once: the weights of every slot, the
    ids of the slots with x > 0 and the ladder or cost row of each distinct
    (query, id) they name, plus the output; operations are those of the
    entries with x > 0."""
    nq, h = q_ids.shape
    v = corpus.v
    Z4, W4 = lc._phase1_batched_dispatch(corpus, q_ids, q_w, ACT3 + 1, True,
                                         precision)
    Z2, W2 = lc._phase1_batched_dispatch(corpus, q_ids, q_w, 2, True,
                                         precision)
    Z1, _ = lc._phase1_batched_dispatch(corpus, q_ids, q_w, 1, True,
                                        precision)
    Dq = lc._rev_handoff(lc.phase1_stacked_dist(corpus.coords, q_ids, q_w,
                                                precision))
    valid = lc.phase1_valid_dist(corpus.coords, q_ids, q_w, precision)
    W0 = W2[..., 0].contiguous()
    ids_w, x_w = corpus.ids[wide], corpus.w[wide]
    ids_n, x_n = corpus.ids[narrow], corpus.w[narrow]
    zg = cand_pour.gather_rows(Z4, ids_n).contiguous()
    wg = cand_pour.gather_rows(W4[..., :ACT3], ids_n).contiguous()
    esz = Z4.element_size()

    def work(ids, x, row_values, ops_per_entry, extra=0):
        live = x > 0
        nnz = int(live.sum())
        qid = (torch.arange(nq, device=ids.device)[:, None, None] * v
               + ids.long())[live]
        rows = int(torch.unique(qid).numel())
        nbytes = 4 * x.numel() + 4 * nnz + rows * row_values * esz \
            + 4 * x.shape[0] * x.shape[1] + extra
        return nbytes, ops_per_entry * nnz

    def valid_work(cand, ops_per_bin, row_ops_per_bin):
        """The valid-bin entry reads cand, the weights of each distinct
        candidate row, the ids of their slots with x > 0, len_q costs of
        each distinct (query, id) those name, qoff and qwv, and writes t;
        it does ops_per_bin operations per valid bin of each entry and
        row_ops_per_bin per valid bin of each (query, row)."""
        qoff = valid[1]
        lens = (qoff[1:] - qoff[:-1]).long()
        rows_u = torch.unique(cand)
        live_u = corpus.w[rows_u] > 0
        live = corpus.w[cand] > 0                       # (nq, b, hmax)
        qid = (torch.arange(nq, device=cand.device)[:, None, None] * v
               + corpus.ids[cand].long())[live]
        pairs = torch.unique(qid)
        nbytes = 8 * cand.numel() + 4 * live_u.numel() \
            + 4 * int(live_u.sum()) + esz * int(lens[pairs // v].sum()) \
            + 4 * qoff.numel() + 4 * valid[2].numel() + 4 * cand.numel()
        entry_bins = int((live.sum(dim=(1, 2)) * lens).sum())
        row_bins = cand.shape[1] * int(lens.sum())
        return nbytes, ops_per_bin * entry_bins + row_ops_per_bin * row_bins

    def rows_work(cand, width, ops_per_entry):
        """K3's corpus-row entry reads cand, the weights of each distinct
        row it names (every row when cand is None), the ids of their slots
        with x > 0 and the ``width`` ladder values of each distinct
        (query, id) those name, and writes t; it does ops_per_entry
        operations per (query, entry with x > 0)."""
        rows_u = (torch.arange(corpus.n, device=q_ids.device)
                  if cand is None else torch.unique(cand))
        live_u = corpus.w[rows_u] > 0
        if cand is None:
            entries = nq * int(live_u.sum())
            pairs = nq * int(torch.unique(corpus.ids[live_u]).numel())
            nbytes, cols = 0, corpus.n
        else:
            live = corpus.w[cand] > 0                   # (nq, b, hmax)
            entries = int(live.sum())
            pairs = int(torch.unique(
                (torch.arange(nq, device=cand.device)[:, None, None] * v
                 + corpus.ids[cand].long())[live]).numel())
            nbytes, cols = 8 * cand.numel(), cand.shape[1]
        nbytes += 4 * live_u.numel() + 4 * int(live_u.sum()) \
            + esz * width * pairs + 4 * nq * cols
        return nbytes, ops_per_entry * entries

    ids, w = corpus.ids, corpus.w
    nb = x_n.shape[0] * x_n.shape[1]
    return {
        "cand_pour.pour": (
            lambda: ops.cand_pour(ids_n, x_n, Z4, W4, ACT3),
            lambda: cand_pour.cand_pour_plain(ids_n, x_n, Z4, W4, ACT3),
            *work(ids_n, x_n, 2 * ACT3 + 1, 5 * (ACT3 + 1))),
        "cand_pour.pour_iters0": (
            lambda: ops.cand_pour(ids_n, x_n, Z1, None, 0),
            lambda: cand_pour.cand_pour_plain(ids_n, x_n, Z1, None, 0),
            *work(ids_n, x_n, 1, 2)),
        "cand_pour.omr": (
            lambda: ops.cand_omr(ids_w, x_w, Z2, W0),
            lambda: cand_pour.cand_omr_plain(ids_w, x_w, Z2, W0),
            *work(ids_w, x_w, 3, 4)),
        "cand_dist.ict": (
            lambda: ops.cand_ict(ids_n, x_n, Dq, q_w),
            lambda: cand_pour.cand_ict_plain(ids_n, x_n, Dq, q_w),
            # a max scan and one selection pass over the h costs
            *work(ids_n, x_n, h, 2 * h, 4 * q_w.numel())),
        "cand_dist.rev_min": (
            lambda: ops.cand_rev_min(ids_n, x_n, Dq, q_w),
            lambda: cand_pour.cand_rev_min_plain(ids_n, x_n, Dq, q_w),
            # a min per cost, then h products and sums per row
            *(lambda nbytes, flops: (nbytes, flops + 2 * h * nb))(
                *work(ids_n, x_n, h, h, 4 * q_w.numel()))),
        "cand_dist_valid.ict": (
            lambda: ops.cand_ict_valid(corpus.ids, corpus.w, narrow, *valid),
            lambda: cand_pour.cand_ict_valid_plain(corpus.ids, corpus.w,
                                                   narrow, *valid),
            # a max scan and one selection pass over the len_q costs
            *valid_work(narrow, 2, 0)),
        "cand_dist_valid.rev_min": (
            lambda: ops.cand_rev_min_valid(corpus.ids, corpus.w, narrow,
                                           *valid),
            lambda: cand_pour.cand_rev_min_valid_plain(corpus.ids, corpus.w,
                                                       narrow, *valid),
            # a min per cost, then len_q products and sums per row
            *valid_work(narrow, 1, 2)),
        "act_phase2_cand": (
            lambda: ops.act_phase2_cand(x_n, zg, wg),
            lambda: act_phase2.act_phase2_cand_plain(x_n, zg, wg),
            # pre-gathered ladders: each entry with x > 0 is its own input
            4 * x_n.numel() + int((x_n > 0).sum()) * (2 * ACT3 + 1) * esz
            + 4 * nb, 5 * (ACT3 + 1) * int((x_n > 0).sum())),
        "cand_pour_rows.pour": (
            lambda: ops.cand_pour_rows(ids, w, narrow, Z4, W4, ACT3),
            lambda: cand_pour.cand_pour_rows_plain(ids, w, narrow, Z4, W4,
                                                   ACT3),
            *rows_work(narrow, 2 * ACT3 + 1, 5 * (ACT3 + 1))),
        "cand_pour_rows.pour_iters0": (
            lambda: ops.cand_pour_rows(ids, w, narrow, Z1, None, 0),
            lambda: cand_pour.cand_pour_rows_plain(ids, w, narrow, Z1, None,
                                                   0),
            *rows_work(narrow, 1, 2)),
        "cand_pour_rows.omr": (
            lambda: ops.cand_omr_rows(ids, w, wide, Z2, W0),
            lambda: cand_pour.cand_omr_rows_plain(ids, w, wide, Z2, W0),
            *rows_work(wide, 3, 4)),
        "cand_pour_rows.all_pour_iters0": (
            lambda: ops.cand_pour_rows(ids, w, None, Z1, None, 0),
            lambda: cand_pour.cand_pour_rows_plain(ids, w, None, Z1, None,
                                                   0),
            *rows_work(None, 1, 2)),
        "cand_pour_rows.all_omr": (
            lambda: ops.cand_omr_rows(ids, w, None, Z2, W0),
            lambda: cand_pour.cand_omr_rows_plain(ids, w, None, Z2, W0),
            *rows_work(None, 3, 4)),
    }, (Z1, Dq, ids_n, valid, Z2, W0)


def check_cand_kernels(corpus, q_ids, q_w, wide, narrow):
    """Phase 5: each candidate kernel against its plain version under both
    handoff dtypes, and the bitwise gather probes. Returns the float32
    cases (for the times) and their max |kernel - plain|."""
    nq = q_ids.shape[0]
    qrow = torch.arange(nq, device=q_ids.device)[:, None]
    errs = {}
    for precision in ("f32", "bf16"):
        cases, (Z1, Dq, ids_n, valid, Z2, W0) = cand_cases(
            corpus, q_ids, q_w, wide, narrow, precision)
        for name, (kern, plain, _, _) in cases.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            # rtol/atol: the kernels sum a row's entries lane by lane and
            # then across the warp, the plain versions in torch's order;
            # a self-match scores ~1e-8 on one side and 0 on the other.
            check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
                  f"{name} {precision}: max |d| {err} beyond rtol {RTOL} "
                  f"atol {ATOL}")
            check(bool(torch.isfinite(got).all()) and got.max().item() < 1e3,
                  f"{name} {precision}: a score reached the sentinel scale")
            if precision == "f32":
                errs[name] = err
            print(f"  {name:22s} {precision}: b={got.shape[1]} "
                  f"max|d|={err:.3g}", flush=True)
        # The valid-bin entry against the stacked K4 on the same costs: Dv
        # scattered back into (nq, v, h), the sentinel and weight 0 at the
        # invalid bins (which add exactly 0; the sums run in another order).
        same_costs(corpus, q_ids, q_w, narrow, valid, precision)
        same_rows(corpus, cases, Z1, Z2, W0, precision)
        # The gathers, bitwise: one slot per row with x = 1 and the rest 0.
        # A pour at iters=0 then scores exactly Z1[q, id]; rev_min with a
        # one-hot q_w at a valid bin c scores exactly Dq[q, id, c].
        gen = torch.Generator(device=ids_n.device).manual_seed(SEED)
        slot = torch.randint(0, HMAX, ids_n.shape[:2], device=ids_n.device,
                             generator=gen)
        xp = torch.zeros(ids_n.shape, device=ids_n.device)
        xp.scatter_(2, slot[..., None], 1.0)
        at = torch.gather(ids_n, 2, slot[..., None])[..., 0].long()
        check(torch.equal(ops.cand_pour(ids_n, xp, Z1, None, 0),
                          Z1[qrow, at, 0].float()),
              f"cand_pour {precision}: the gather is not bitwise")
        col = (q_w > 0).int().argmax(dim=1)
        qw1 = torch.zeros_like(q_w)
        qw1[torch.arange(nq), col] = 1.0
        check(torch.equal(ops.cand_rev_min(ids_n, xp, Dq, qw1),
                          Dq[qrow, at, col[:, None]].float()),
              f"cand_dist {precision}: the gather is not bitwise")
        # The corpus-row entry's all-rows form, one slot per corpus row with
        # x = 1: it scores exactly Z1[q, id].
        slot_r = torch.randint(0, HMAX, (corpus.n,), device=ids_n.device,
                               generator=gen)
        xr = torch.zeros_like(corpus.w)
        xr.scatter_(1, slot_r[:, None], 1.0)
        at_r = torch.gather(corpus.ids, 1, slot_r[:, None])[:, 0].long()
        check(torch.equal(ops.cand_pour_rows(corpus.ids, xr, None, Z1, None,
                                             0), Z1[:, at_r, 0].float()),
              f"cand_pour_rows {precision}: the gather is not bitwise")
        print(f"  gathers {precision}: bitwise at {at.numel()} probes each "
              f"(cand_pour, cand_dist), {nq * corpus.n} (cand_pour_rows, "
              "all rows)", flush=True)
        if precision == "f32":
            f32_cases = cases
    return f32_cases, errs


def same_costs(corpus, q_ids, q_w, cand, valid, precision):
    """Phase 5: K4's valid-bin entry against the stacked K4 on the same
    costs, both modes."""
    Dv, qoff, qwv = valid
    nq, h = q_ids.shape
    cols = torch.nonzero((q_w > 0).reshape(-1))[:, 0]
    Dq = torch.full((corpus.v, nq * h), pad_dist_for(Dv.dtype),
                    dtype=Dv.dtype, device=Dv.device)
    Dq[:, cols] = Dv
    Dq = lc._rev_handoff(Dq.view(corpus.v, nq, h))
    ids_g, x_g = corpus.ids[cand], corpus.w[cand]
    for mode, new, old in (
            ("ict", ops.cand_ict_valid, ops.cand_ict),
            ("rev_min", ops.cand_rev_min_valid, ops.cand_rev_min)):
        got = new(corpus.ids, corpus.w, cand, Dv, qoff, qwv)
        want = old(ids_g, x_g, Dq, q_w)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
              f"cand_dist_valid.{mode} {precision}: max |d| {err} from the "
              f"stacked K4 on the same costs, beyond rtol {RTOL} atol {ATOL}")
        print(f"  cand_dist_valid.{mode} {precision}: against the stacked "
              f"K4 on the same costs max|d|={err:.3g} ({int(cols.numel())} "
              f"valid bins of {nq * h})", flush=True)
    del Dq


def same_rows(corpus, cases, Z1, Z2, W0, precision):
    """Phase 5: K3's corpus-row entry against the old K3 on the same rows:
    the candidate form against the old K3 on the gathered candidate rows,
    the all-rows form against the old K3 on every row of the corpus."""
    nq = Z1.shape[0]
    every = (corpus.ids.expand(nq, -1, -1).contiguous(),
             corpus.w.expand(nq, -1, -1).contiguous())
    old = {"pour": cases["cand_pour.pour"][0],
           "pour_iters0": cases["cand_pour.pour_iters0"][0],
           "omr": cases["cand_pour.omr"][0],
           "all_pour_iters0": lambda: ops.cand_pour(*every, Z1, None, 0),
           "all_omr": lambda: ops.cand_omr(*every, Z2, W0)}
    for name, want_fn in old.items():
        got, want = cases[f"cand_pour_rows.{name}"][0](), want_fn()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
              f"cand_pour_rows.{name} {precision}: max |d| {err} from the "
              f"old K3 on the same rows, beyond rtol {RTOL} atol {ATOL}")
        print(f"  cand_pour_rows.{name} {precision}: against the old K3 on "
              f"the same rows max|d|={err:.3g} ({got.shape[1]} rows per "
              "query)", flush=True)
    del every


def admissible_recall(spec, corpus, q_ids, q_w, i_c, full):
    """An admissible ladder returns the exact top-l of full-corpus
    rescoring wherever its budgets keep the true neighbours: every row of
    the full-corpus top-l of the rescorer (scores ``full``, cuda path) that
    survives the pruning must be in the cascade's top-l ``i_c``; and, by
    Theorem 2, every stage scores each row at most as the rescorer does.
    Rows within the score tolerance of the top-l's edge are exempt from the
    first check. Prints each stage's largest excess over the rescorer and
    the stage ranks of the true neighbours the budgets pruned. Returns the
    recall and the number pruned."""
    spec = resolve_spec(spec)
    s_top, full_top = topk_smallest(full, TOP_L + 1)
    # A true neighbour within the score tolerance of the first row past the
    # top-l may trade places with it between the rescore and full scoring.
    edge = s_top[:, TOP_L:]
    firm = edge - s_top[:, :TOP_L] > 2 * (ATOL + RTOL * edge.abs())
    full_top = full_top[:, :TOP_L]
    surv = cascade_search._prune(corpus, q_ids, q_w, spec,
                                 spec.resolve_budgets(corpus.n, TOP_L),
                                 n_valid=None, topk_blocks=1,
                                 use_kernels=True, block_q=BLOCK_Q,
                                 precision="f32")
    kept = (full_top[..., None] == surv[:, None, :]).any(-1)
    found = (full_top[..., None] == i_c[:, None, :]).any(-1)
    check(bool((found | ~kept | ~firm).all()), f"cascade "
          f"{spec.describe()}: a true top-{TOP_L} row survived the pruning "
          "but is not in the result")
    lost = full_top[~kept]
    lost_q = torch.nonzero(~kept)[:, 0]
    for stage in spec.stages:
        st = retrieval.batch_scores(corpus, q_ids, q_w, method=stage.method,
                                    iters=stage.iters, use_kernels=True)
        excess = (st - full).max().item()
        check(bool((st <= full + ATOL + RTOL * full.abs()).all()),
              f"cascade {spec.describe()}: {stage.method} exceeds the "
              f"{spec.rescorer} rescorer by {excess}")
        rank = torch.argsort(torch.argsort(st, dim=1, stable=True), dim=1)
        print(f"  {stage.method}-{stage.iters} vs {spec.rescorer}: largest "
              f"excess {excess:.3g}; full-corpus {stage.method} ranks of the "
              f"pruned true neighbours {rank[lost_q, lost].tolist()} "
              f"(queries {lost_q.tolist()})", flush=True)
    return topk_recall(i_c, full_top), int((~kept).sum())


def check_cascade(name, spec, cuda_index, ref_index, q_ids, q_w, rows,
                  full):
    """Phase 6 for one ladder: the cuda search against the reference one
    on the card. ``full``: full-corpus scores of the rescorer (cuda path)
    for an admissible ladder, else None. Returns the launch counts, the
    recall and the two top-l index sets."""
    zero_counts()
    s_c, i_c = cuda_index.search(q_ids, q_w, cascade=spec)
    torch.cuda.synchronize()
    counts = read_counts()
    s_r, i_r = ref_index.search(q_ids, q_w, top_l=TOP_L + 1, cascade=spec)
    torch.cuda.synchronize()
    next_r, s_r, i_r = s_r[:, TOP_L], s_r[:, :TOP_L], i_r[:, :TOP_L]
    err = (s_c - s_r).abs().max().item()
    check(s_c.shape == (NQ, TOP_L) and i_c.shape == (NQ, TOP_L),
          f"cascade {name}: shapes {tuple(s_c.shape)}")
    check(torch.allclose(s_c, s_r, rtol=RTOL, atol=ATOL),
          f"cascade {name}: cuda vs reference scores max |d| {err}")
    check(bool(torch.isfinite(s_c).all()) and s_c.max().item() < 1e3,
          f"cascade {name}: a score reached the sentinel scale")
    firm = firm_ranks(s_r, next_r)
    check(bool((i_c == i_r)[firm].all()),
          f"cascade {name}: top-{TOP_L} indices differ where the gap "
          "exceeds the tolerance")
    self_hit = (i_c[:, 0].cpu().numpy() == rows).mean()
    check(self_hit == 1.0, f"cascade {name}: self at rank 0 for only "
          f"{self_hit:.3f} of queries")
    recall, pruned = (None, None) if full is None else \
        admissible_recall(spec, cuda_index.corpus, q_ids, q_w, i_c, full)
    print(f"phase 6: {name} ({resolve_spec(spec).describe()}): "
          f"cuda vs reference max|d|={err:.3g}, top-{TOP_L} equal at "
          f"{int(firm.sum())} separated ranks of {firm.numel()} "
          f"({int((i_c == i_r).sum())} equal in all), self at rank 0 for "
          f"all; recall@{TOP_L} vs full-corpus rescoring {recall} "
          f"(true neighbours pruned by the budgets: {pruned}); launches "
          f"{counts}", flush=True)
    return counts, recall, i_c, i_r


def back_to_back_ms(fn, n=20):
    """Milliseconds per call of ``fn()`` in a run of ``n`` calls between two
    CUDA events: the host's launch time then overlaps the card's work,
    which a single timed call includes."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def host_ms(fn, reps=5):
    """Median host milliseconds of ``fn()`` between two synchronizes, after
    a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def time_valid_handoff(corpus, q_ids, q_w, cand):
    """Phase 7: the valid-bin handoff against the stacked one (time, peak
    memory), its host sync apart, and K4's valid-bin entry as the wrapper
    (checks and their sync included) and as the bare launch."""
    gib = 2**30

    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - base) / gib

    def stacked():
        return lc._rev_handoff(lc.phase1_stacked_dist(corpus.coords, q_ids,
                                                      q_w))

    def valid():
        return lc.phase1_valid_dist(corpus.coords, q_ids, q_w)
    (Dv, qoff, qwv), valid_gib = peak(valid)
    _, stacked_gib = peak(stacked)
    sync_ms = host_ms(lambda: torch.nonzero((q_w > 0).reshape(-1)))
    qc = corpus.coords[q_ids[q_w > 0]]
    product_ms = host_ms(lambda: corpus.coords @ qc.T)
    print(f"phase 7: handoff for {NQ} queries: valid-bin "
          f"{host_ms(valid):.4f} ms ({Dv.shape[1]} columns, peak "
          f"{valid_gib:.3f} GiB), of which sizing P (its host sync) "
          f"{sync_ms:.4f} ms and the f32 product alone {product_ms:.4f} ms; "
          f"stacked {host_ms(stacked, reps=3):.4f} ms (peak "
          f"{stacked_gib:.3f} GiB)", flush=True)
    args = (corpus.ids, corpus.w, cand, Dv, qoff, qwv)
    bare = {}
    for mode, wrapper in (("ict", ops.cand_ict_valid),
                          ("rev_min", ops.cand_rev_min_valid)):
        name = f"cand_dist_valid.{mode}"

        def launch():
            return cand_pour.cand_dist_valid_cuda(*args, mode)
        bare[name] = cuda_ms(launch, reps=20)
        wrapped = host_ms(lambda: wrapper(*args), reps=20)
        print(f"phase 7: {name} the bare launch {bare[name]:.4f} ms (the "
              f"kernel's time below; {back_to_back_ms(launch):.4f} ms each "
              f"in a run of 20), the wrapper with its checks and their host "
              f"sync {wrapped:.4f} ms", flush=True)
    return bare


def graph_ms(fn, n=20):
    """Milliseconds per call of ``fn()`` on the device alone: ``n`` calls
    captured in one CUDA graph and replayed, so no host time enters."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    ms = cuda_ms(graph.replay, reps=5, warmup=1) / n
    del graph
    return ms


def time_rows_entry(corpus, q_ids, q_w, wide, narrow):
    """Phase 7: K3's corpus-row entry (f32 ladders) as the bare launch (one
    launch between two events, the host's launch time included), in a CUDA
    graph of 20 launches (the device's time alone) and through its wrapper
    (its checks and, for the candidate form, the host sync of cand's
    range); the all-rows form's times include its vocabulary-major copy of
    the ladders. Returns {name: {key: ms}}."""
    ids, w = corpus.ids, corpus.w
    Z4, W4 = lc._phase1_batched_dispatch(corpus, q_ids, q_w, ACT3 + 1, True)
    Z2, W2 = lc._phase1_batched_dispatch(corpus, q_ids, q_w, 2, True)
    Z1, _ = lc._phase1_batched_dispatch(corpus, q_ids, q_w, 1, True)
    W0 = W2[..., 0].contiguous()
    calls = {
        "pour": (narrow, Z4, W4, ACT3, "pour", ops.cand_pour_rows),
        "pour_iters0": (narrow, Z1, None, 0, "pour", ops.cand_pour_rows),
        "omr": (wide, Z2, W0, 1, "omr", ops.cand_omr_rows),
        "all_pour_iters0": (None, Z1, None, 0, "pour", ops.cand_pour_rows),
        "all_omr": (None, Z2, W0, 1, "omr", ops.cand_omr_rows),
    }
    out = {}
    for name, (cand, Z, W, iters, mode, wrapper) in calls.items():
        def launch():
            return cand_pour.cand_pour_rows_cuda(ids, w, cand, Z, W, iters,
                                                 mode)
        t = {"ms": cuda_ms(launch, reps=20), "ms_graph": graph_ms(launch)}
        args = (ids, w, cand, Z) + ((W,) if mode == "omr" else (W, iters))
        t["wrapper_ms"] = host_ms(lambda: wrapper(*args), reps=20)
        out[f"cand_pour_rows.{name}"] = t
        print(f"phase 7: cand_pour_rows.{name}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
              + f" (ms: one launch between two events; ms_graph: per launch "
              f"in a CUDA graph of 20; wrapper_ms: host clock around the "
              f"wrapper and a sync)", flush=True)
    return out


def search_seconds(search):
    """Median host seconds of three searches after a warm-up each, and the
    peak device memory above what was resident before them."""
    secs, peak = [], []
    for _ in range(3):
        search()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        search()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        peak.append(torch.cuda.max_memory_allocated() - base)
    return statistics.median(secs), max(peak)


def main():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")

    # Phase 0: the card.
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 0: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    # The reference path's matmul must run in full float32 (no TF32).
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")

    # Phase 1: build.
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"phase 1: built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # Set-up: the corpus and the query batch.
    t0 = time.perf_counter()
    host_corpus, _ = make_clustered_text(N_DOCS, vocab=VOCAB, m=DIM,
                                         hmax=HMAX, seed=SEED,
                                         shard_docs=1024)
    dev = torch.device("cuda")
    corpus = host_corpus.to(dev)
    rows = np.sort(np.random.default_rng(SEED).choice(N_DOCS, NQ,
                                                      replace=False))
    q_ids, q_w = corpus.ids[rows].contiguous(), corpus.w[rows].contiguous()
    n_valid = (q_w > 0).sum(dim=1)
    print(f"set-up: corpus n={corpus.n} v={corpus.v} m={corpus.m} "
          f"hmax={corpus.hmax} in {time.perf_counter() - t0:.1f} s; "
          f"query rows {rows.tolist()} with valid bins "
          f"{n_valid.tolist()}", flush=True)

    # Phase 2: each kernel against its plain version, on the main path's
    # inputs. (These launches are not the main path's; counts reset below.)
    coords, qcs, qmask = corpus.coords, corpus.coords[q_ids], q_w > 0
    edge = qmask.clone()
    edge[0], edge[1] = False, True        # a query with none, one with all
    masks = {"batch": qmask, "all-valid": torch.ones_like(qmask),
             "edge": edge}
    k1_err = None
    for mask_name, mask in masks.items():
        print(f"  K1 mask {mask_name}: valid bins per query "
              f"{mask.sum(dim=1).tolist()}", flush=True)
        for k in (ITERS + 1, 2, 1):
            for dtype in (torch.float32, torch.bfloat16):
                err = check_dist_topk(coords, qcs, mask, k, dtype)
                if (mask_name == "batch" and k == ITERS + 1
                        and dtype == torch.float32):
                    k1_err = err
    Z, W = lc._phase1_batched_dispatch(corpus, q_ids, q_w, ITERS + 1, True)
    x, ids = corpus.w, corpus.ids
    zg = Z[:BLOCK_Q][:, ids]
    wg = W[:BLOCK_Q][:, ids, :ITERS]
    tk = ops.act_phase2_batched(x, zg, wg)
    tp = act_phase2.act_phase2_plain(x, zg, wg)
    torch.cuda.synchronize()
    k2_err = (tk - tp).abs().max().item()
    check(torch.allclose(tk, tp, rtol=RTOL, atol=ATOL),
          f"act_phase2: max |dt| {k2_err} beyond rtol {RTOL} atol {ATOL}")
    check(bool(torch.isfinite(tk).all()) and tk.max().item() < 1e3,
          "act_phase2: a score reached the sentinel scale")
    print(f"phase 2: K2 bq={BLOCK_Q} n={corpus.n} hmax={HMAX} iters={ITERS} "
          f"max|dt|={k2_err:.3g}", flush=True)
    # The fused gather over the whole batch, as the engine launches it:
    # bitwise K2 on the first block's gathered ladders, under both handoff
    # dtypes (the bf16 ladders are the f32 ones rounded).
    for dtype in (torch.float32, torch.bfloat16):
        Zd, Wd = Z.to(dtype), W.to(dtype)
        tf = ops.act_phase2_gather(x, ids, Zd, Wd)
        tu = tk if dtype == torch.float32 else ops.act_phase2_batched(
            x, Zd[:BLOCK_Q][:, ids], Wd[:BLOCK_Q][:, ids, :ITERS])
        tpd = act_phase2.act_phase2_gather_plain(x, ids, Zd, Wd)
        torch.cuda.synchronize()
        err = (tf - tpd).abs().max().item()
        check(torch.equal(tf[:BLOCK_Q], tu),
              f"act_phase2_gather {dtype}: not bitwise K2 on the gathered "
              f"ladders (max |d| {(tf[:BLOCK_Q] - tu).abs().max().item()})")
        check(torch.allclose(tf, tpd, rtol=RTOL, atol=ATOL),
              f"act_phase2_gather {dtype}: max |dt| {err} beyond rtol "
              f"{RTOL} atol {ATOL}")
        check(bool(torch.isfinite(tf).all()) and tf.max().item() < 1e3,
              f"act_phase2_gather {dtype}: a score reached the sentinel "
              "scale")
        if dtype == torch.float32:
            kg_err = err
        print(f"phase 2: K2 fused gather {dtype}, nq={NQ}: bitwise equal to "
              f"K2 on the first {BLOCK_Q} queries' gathered ladders, max|dt| "
              f"vs plain={err:.3g}", flush=True)
        del Zd, Wd, tf, tu, tpd

    # Phase 3: the main path end to end, cuda against reference.
    launches = {}
    results = {}
    for method in ("act", "rwmd", "omr"):
        cfg = dict(method=method, iters=ITERS, top_l=TOP_L, block_q=BLOCK_Q)
        cuda_index = EmdIndex.build(host_corpus, EngineConfig(**cfg),
                                    device=dev)
        ref_index = EmdIndex.build(host_corpus,
                                   EngineConfig(backend="reference", **cfg),
                                   device=dev)
        zero_counts()
        s_c, i_c = cuda_index.search(q_ids, q_w)
        torch.cuda.synchronize()
        launches[method] = read_counts()
        s_r, i_r = ref_index.search(q_ids, q_w)
        torch.cuda.synchronize()
        full_c = cuda_index.scores(q_ids, q_w)
        full_r = ref_index.scores(q_ids, q_w)
        err = (full_c - full_r).abs().max().item()
        check(torch.allclose(full_c, full_r, rtol=RTOL, atol=ATOL),
              f"{method}: cuda vs reference scores max |d| {err}")
        check(bool(torch.isfinite(full_c).all()) and
              full_c.max().item() < 1e3,
              f"{method}: a score reached the sentinel scale")
        check(s_c.shape == (NQ, TOP_L) and i_c.shape == (NQ, TOP_L),
              f"{method}: search shapes {tuple(s_c.shape)}")
        # Indices must agree wherever the reference ranking is separated
        # from its neighbours by more than the score tolerance on each side.
        tol = 2 * (ATOL + RTOL * s_r.abs())
        gap_prev = torch.cat([torch.full_like(s_r[:, :1], np.inf),
                              s_r[:, 1:] - s_r[:, :-1]], dim=1)
        next_r = full_r.sort(dim=1).values[:, 1:TOP_L + 1]
        gap_next = next_r - s_r
        firm = (gap_prev > tol) & (gap_next > tol)
        check(bool((i_c == i_r)[firm].all()),
              f"{method}: top-{TOP_L} indices differ where the gap exceeds "
              "the tolerance")
        self_hit = (i_c[:, 0].cpu().numpy() == rows).mean()
        print(f"phase 3: {method} cuda vs reference max|d|={err:.3g}, "
              f"top-{TOP_L} equal at {int(firm.sum())} separated ranks of "
              f"{firm.numel()} ({int((i_c == i_r).sum())} equal in all), "
              f"self at rank 0 for {self_hit:.3f} of queries; launches "
              f"K1={launches[method]['dist_topk']} K2 fused gather="
              f"{launches[method]['act_phase2_gather']} K2 unfused="
              f"{launches[method]['act_phase2']} K3 rows "
              f"{rows_of(launches[method])}", flush=True)
        results[method] = (cuda_index, ref_index)
    check(launches["act"]["dist_topk"] > 0
          and launches["act"]["act_phase2_gather"] > 0,
          f"act main path launched {launches['act']}")
    check(launches["rwmd"]["dist_topk"] > 0,
          "rwmd main path never launched K1")
    check(launches["rwmd"]["cand_pour_rows.all_pour_iters0"] == 1
          and launches["omr"]["cand_pour_rows.all_omr"] == 1
          and sum(rows_of(launches["act"]).values()) == 0,
          f"LC-RWMD's dump and LC-OMR did not launch K3's all-rows form "
          f"once each: {launches}")

    # Phase 4: times.
    k = ITERS + 1
    k1_ms = cuda_ms(lambda: ops.dist_topk_batched(coords, qcs, qmask, k))
    all_valid = masks["all-valid"]
    k1_all_ms = cuda_ms(lambda: ops.dist_topk_batched(coords, qcs, all_valid,
                                                      k))
    k1_plain = cuda_ms(lambda: dist_topk.dist_topk_plain(coords, qcs, qmask,
                                                         k), reps=3)
    big = 1e30

    def library_k1(qc, mask):
        d = torch.cdist(coords.expand(NQ, -1, -1), qc)   # (nq, v, h)
        return d.masked_fill_(~mask[:, None, :], big).topk(k, dim=-1,
                                                           largest=False)
    # The library on the valid work: each query's valid bins first, padded
    # to the widest query (outside the timed call).
    nv_max = int(n_valid.max())
    order = torch.argsort((~qmask).int(), dim=1, stable=True)[:, :nv_max]
    qcs_v = torch.gather(qcs, 1, order[..., None].expand(-1, -1, DIM))
    mask_v = torch.gather(qmask, 1, order)
    k1_lib = cuda_ms(lambda: library_k1(qcs_v, mask_v), reps=5)
    k1_lib_full = cuda_ms(lambda: library_k1(qcs, qmask), reps=3)
    nv = int(n_valid.sum())
    k1_bytes = 4 * (coords.numel() + qcs.numel()) + qmask.numel() \
        + 8 * NQ * corpus.v * k                       # Z f32 + S int32 out
    k1_bound, k1_by = bound_ms(k1_bytes, 2.0 * corpus.v * DIM * nv)
    k1_all_bound, _ = bound_ms(k1_bytes, 2.0 * corpus.v * DIM * NQ * HMAX)
    k2_ms = cuda_ms(lambda: ops.act_phase2_batched(x, zg, wg))
    k2_plain = cuda_ms(lambda: act_phase2.act_phase2_plain(x, zg, wg), reps=3)
    # K2 must read x once and the ladders of the entries with x > 0 (an
    # entry with x == 0 contributes exactly 0); it writes t.
    live = x > 0
    nnz = int(live.sum())
    k2_bytes = 4 * x.numel() + 4 * BLOCK_Q * nnz * (2 * ITERS + 1) \
        + 4 * BLOCK_Q * corpus.n
    k2_flops = 5.0 * BLOCK_Q * nnz * (ITERS + 1)
    k2_bound, k2_by = bound_ms(k2_bytes, k2_flops)
    # The fused gather, on the whole batch as the engine launches it, reads
    # x once, the ids of the entries with x > 0 and the ladder rows
    # (iters+1 costs, iters capacities) of each distinct (query, id) they
    # name, once; it writes t.
    n_ids = int(torch.unique(ids[live]).numel())
    kg_bytes = 4 * x.numel() + 4 * nnz \
        + NQ * n_ids * (2 * ITERS + 1) * Z.element_size() + 4 * NQ * corpus.n
    kg_bound, kg_by = bound_ms(kg_bytes, 5.0 * NQ * nnz * (ITERS + 1))
    kg_ms = cuda_ms(lambda: ops.act_phase2_gather(x, ids, Z, W), reps=20)
    kg_plain = cuda_ms(lambda: act_phase2.act_phase2_gather_plain(x, ids, Z,
                                                                  W), reps=3)
    print(f"phase 4: K1 {k1_ms:.4f} ms on the batch ({nv} valid bins of "
          f"{NQ * HMAX}, the only ones it computes; bound {k1_bound:.4f} by "
          f"{k1_by}), {k1_all_ms:.4f} ms with all {NQ * HMAX} valid (bound "
          f"{k1_all_bound:.4f}); plain {k1_plain:.3f}; library (cdist + "
          f"topk) {k1_lib:.3f} on the valid work ({nv_max} wide), "
          f"{k1_lib_full:.3f} at full width", flush=True)
    print(f"phase 4: K2 {k2_ms:.4f} ms on gathered ladders (plain "
          f"{k2_plain:.3f}, bound {k2_bound:.4f} by {k2_by}: {nnz} of "
          f"{x.numel()} entries, {BLOCK_Q} queries); fused gather over all "
          f"{NQ} queries {kg_ms:.4f} ms (plain, gather + pour, "
          f"{kg_plain:.3f}, bound {kg_bound:.4f} by {kg_by}: "
          f"{kg_bytes / 1e6:.1f} MB, {n_ids} distinct ids)", flush=True)
    for method, (cuda_index, ref_index) in results.items():
        secs, peak = [], []
        for index in (cuda_index, ref_index) * 3:
            index.search(q_ids, q_w)                   # warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            index.search(q_ids, q_w)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            peak.append(torch.cuda.max_memory_allocated())
        gib = 2**30
        print(f"phase 4: {method} search of {NQ} queries: cuda "
              f"{statistics.median(secs[0::2]):.4f} s, reference "
              f"{statistics.median(secs[1::2]):.4f} s (median of 3 each); "
              f"torch.cuda.max_memory_allocated during a search: cuda "
              f"{max(peak[0::2]) / gib:.2f} GiB, reference "
              f"{max(peak[1::2]) / gib:.2f} GiB, of which "
              f"{base / gib:.2f} GiB resident before it; above the "
              f"resident: cuda {(max(peak[0::2]) - base) / gib:.3f} GiB, "
              f"reference {(max(peak[1::2]) - base) / gib:.3f} GiB",
              flush=True)

    del zg, wg, results                     # 4.5 GB of gathered ladders

    # Phase 5: the candidate kernels against their plain versions, on the
    # cascade's inputs: the 20% and 5% survivors of the rwmd stage.
    s1 = retrieval.batch_scores(corpus, q_ids, q_w, method="rwmd",
                                use_kernels=True)
    _, wide = topk_smallest(s1, B_WIDE)
    wide = wide.contiguous()
    narrow = wide[:, :B_NARROW].contiguous()
    print(f"phase 5: candidates per query {B_WIDE} and {B_NARROW}",
          flush=True)
    cases, cand_errs = check_cand_kernels(corpus, q_ids, q_w, wide, narrow)

    # Phase 6: the cascade end to end, cuda against reference.
    cfg = dict(top_l=TOP_L, block_q=BLOCK_Q)
    cuda_index = EmdIndex.build(host_corpus, EngineConfig(**cfg),
                                device=dev)
    ref_index = EmdIndex.build(host_corpus,
                               EngineConfig(backend="reference", **cfg),
                               device=dev)
    all_rows = torch.arange(corpus.n, device=dev).expand(NQ, corpus.n)
    full_act = retrieval.batch_scores(corpus, q_ids, q_w, method="act",
                                      iters=ACT3, use_kernels=True)
    full_ict = retrieval.cand_scores(corpus, q_ids, q_w, all_rows,
                                     method="ict", use_kernels=True)
    full = {"chain": full_act, "tight": full_ict}
    cascade_counts, cascade_idx = {}, {}
    for name, spec in CASCADES.items():
        counts, recall, i_c, i_r = check_cascade(
            name, spec, cuda_index, ref_index, q_ids, q_w, rows,
            full.get(name))
        cascade_counts[name] = counts
        cascade_idx[name] = (i_c, i_r)
    c = cascade_counts
    # Every search takes K3's corpus-row entry once per stage and batch,
    # and the old K3 never.
    for name, want in ROWS_EXPECTED.items():
        got = rows_of(c[name])
        check(got == {k: want.get(k, 0) for k in ROWS_KEYS},
              f"cascade {name}: K3's corpus-row entry launched {got}, not "
              f"once per stage and batch ({want})")
        check(c[name]["cand_pour.pour"] + c[name]["cand_pour.pour_iters0"]
              + c[name]["cand_pour.omr"] == 0,
              f"cascade {name} launched the old K3: {c[name]}")
    # tight and the rwmd_rev ladder take K4's valid-bin entry, never the
    # stacked one.
    check(c["tight"]["cand_dist_valid.ict"] > 0
          and c["tight"]["cand_dist.ict"] == 0,
          f"cascade tight launched cand_dist {c['tight']}")
    check(c["rwmd_rev"]["cand_dist_valid.rev_min"] > 0
          and c["rwmd_rev"]["cand_dist.rev_min"] == 0,
          f"the rwmd_rev ladder launched cand_dist {c['rwmd_rev']}")
    # fast and the rwmd_rev ladder are not admissible: their recall
    # against full act-3 is measured, and must be the same on both
    # backends.
    ref_act = retrieval.batch_scores(corpus, q_ids, q_w, method="act",
                                     iters=ACT3)
    for name in ("fast", "rwmd_rev"):
        rec_c = topk_recall(cascade_idx[name][0],
                            topk_smallest(full_act, TOP_L)[1])
        rec_r = topk_recall(cascade_idx[name][1],
                            topk_smallest(ref_act, TOP_L)[1])
        print(f"phase 6: {name} recall@{TOP_L} against full-corpus "
              f"act-{ACT3}: cuda {rec_c}, reference {rec_r}", flush=True)
        check(rec_c == rec_r, f"{name} recall differs: cuda {rec_c}, "
              f"reference {rec_r}")
    del full, full_act, full_ict, ref_act, all_rows

    # Phase 7: times of the candidate kernels and of the cascaded searches.
    # The library yardstick of the iters=0 pour: one embedding_bag over the
    # (nq*v, 1) table with per-slot weights, the (q, id) rows flattened to
    # q*v + id beforehand (outside the timed call).
    ids_n, x_n = corpus.ids[narrow], corpus.w[narrow]
    Z1, _ = lc._phase1_batched_dispatch(corpus, q_ids, q_w, 1, True)
    flat = (ids_n.long() + torch.arange(NQ, device=dev)[:, None, None]
            * corpus.v).reshape(-1, HMAX)
    table, bag_w = Z1.reshape(-1, 1), x_n.reshape(-1, HMAX)

    def library_pour0():
        return torch.nn.functional.embedding_bag(
            flat, table, per_sample_weights=bag_w, mode="sum")
    lib = library_pour0().reshape(NQ, B_NARROW)
    check(torch.allclose(lib, cases["cand_pour.pour_iters0"][0](),
                         rtol=RTOL, atol=ATOL),
          "the embedding_bag yardstick disagrees with cand_pour")
    # The same over the whole corpus: the yardstick of the all-rows dump.
    flat_all = (corpus.ids.long()[None] + torch.arange(NQ, device=dev)[
        :, None, None] * corpus.v).reshape(-1, HMAX)
    bag_all_w = corpus.w.expand(NQ, -1, -1).reshape(-1, HMAX)

    def library_all_pour0():
        return torch.nn.functional.embedding_bag(
            flat_all, table, per_sample_weights=bag_all_w, mode="sum")
    check(torch.allclose(library_all_pour0().reshape(NQ, corpus.n),
                         cases["cand_pour_rows.all_pour_iters0"][0](),
                         rtol=RTOL, atol=ATOL),
          "the embedding_bag yardstick disagrees with cand_pour_rows")
    library = {"cand_pour.pour_iters0": library_pour0,
               "cand_pour_rows.pour_iters0": library_pour0,
               "cand_pour_rows.all_pour_iters0": library_all_pour0}
    # K4's valid-bin entry and K3's corpus-row entry are timed as the bare
    # launch, their wrappers apart.
    bare_ms = time_valid_handoff(corpus, q_ids, q_w, narrow)
    rows_ms = time_rows_entry(corpus, q_ids, q_w, wide, narrow)
    bare_ms.update({name: t["ms"] for name, t in rows_ms.items()})
    cand_times = {}
    for name, (kern, plain, nbytes, flops) in cases.items():
        k_ms = bare_ms[name] if name in bare_ms else cuda_ms(kern)
        p_ms = cuda_ms(plain, reps=3, warmup=1)
        b_ms, b_by = bound_ms(nbytes, flops)
        l_ms = cuda_ms(library[name]) if name in library else None
        cand_times[name] = (k_ms, p_ms, b_ms, b_by, l_ms)
        print(f"phase 7: {name:22s} {k_ms:.4f} ms (plain {p_ms:.3f}, "
              f"bound {b_ms:.4f} by {b_by}: {nbytes / 1e9:.3f} GB, "
              f"{flops / 1e9:.3f} GFLOP; library "
              f"{'none' if l_ms is None else f'{l_ms:.4f}'})", flush=True)
    del flat_all, bag_all_w
    gib = 2**30
    for name, spec in CASCADES.items():
        t_c, m_c = search_seconds(
            lambda: cuda_index.search(q_ids, q_w, cascade=spec))
        t_r, m_r = search_seconds(
            lambda: ref_index.search(q_ids, q_w, cascade=spec))
        print(f"phase 7: cascade {name} search of {NQ} queries: cuda "
              f"{t_c:.4f} s, reference {t_r:.4f} s (median of 3 each); "
              f"peak device memory above the resident: cuda "
              f"{m_c / gib:.3f} GiB, reference {m_r / gib:.3f} GiB",
              flush=True)
        if name in ("tight", "rwmd_rev"):
            check(m_c < VALID_PEAK_GIB * gib,
                  f"cascade {name}: peak {m_c / gib:.3f} GiB above the "
                  f"resident, not under {VALID_PEAK_GIB} GiB")

    kernels = [
        {"name": "dist_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/dist_topk.cu",
         "replaces": "src/repro/kernels/dist_topk.py:121",
         "launches": launches["act"]["dist_topk"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": k1_lib,
         "ms_all_valid": k1_all_ms, "bound_ms_all_valid": k1_all_bound,
         "library_full_width_ms": k1_lib_full},
        {"name": "act_phase2", "route": "cuda",
         "source": "src/repro_torch/csrc/act_phase2.cu",
         "replaces": "src/repro/kernels/act_phase2.py:73",
         "launches": launches["act"]["act_phase2"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
        {"name": "act_phase2_gather", "route": "cuda",
         "source": "src/repro_torch/csrc/act_phase2.cu",
         "replaces": "src/repro/kernels/act_phase2.py:73",
         "launches": launches["act"]["act_phase2_gather"],
         "max_abs_err": kg_err, "ms": kg_ms, "plain_ms": kg_plain,
         "bound_ms": kg_bound, "bound_by": kg_by, "library_ms": None},
    ]
    # The main path's runs: the phase-3 searches and the cascades.
    runs = {**launches, **cascade_counts}
    for name, (k_ms, p_ms, b_ms, b_by, l_ms) in cand_times.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{CAND_KERNELS[name][0]}.cu",
            "replaces": CAND_KERNELS[name][1],
            "launches": sum(c[name] for c in runs.values()),
            "launches_by_search": {p: c[name] for p, c in runs.items()},
            "max_abs_err": cand_errs[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
            **{k: t for k, t in rows_ms.get(name, {}).items() if k != "ms"}})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
