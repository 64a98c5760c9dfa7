#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Needs one CUDA device and ``nvcc`` (``/usr/local/cuda``). Phases:

0. the card: ``nvidia-smi`` name and power limit, the device name;
1. build: the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once), with the compiler's register report;
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and on its inputs: ``dist_topk`` (K1) at nq=16, v=69682,
   h=500, m=300 for k in {8, 2, 1} x {float32, bfloat16}, ``act_phase2``
   (K2) at 8 queries x 18828 rows x hmax 500, iters=7;
3. the main path end to end: a 20 Newsgroups-shaped corpus (n=18828,
   v=69682, m=300, hmax=500, seed 0), ``EmdIndex(backend="cuda").search``
   for 16 corpus rows with LC-ACT (iters=7, top_l=16) and with LC-RWMD,
   each held against ``backend="reference"`` on the same card, with the
   kernels' launch counts set to 0 before each and read after;
4. times (CUDA events after warm-up): each kernel, its plain version, its
   bound and, for K1, one library call (``torch.cdist`` + ``torch.topk``)
   as a yardstick the port never calls; seconds per 16-query search; peak
   device memory.

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
from repro_torch.core import lc  # noqa: E402
from repro_torch.core.precision import pad_dist_for  # noqa: E402
from repro_torch.data.synth import make_clustered_text  # noqa: E402
from repro_torch.kernels import _build, act_phase2, dist_topk, ops  # noqa: E402

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
    k1_err = None
    for k in (ITERS + 1, 2, 1):
        for dtype in (torch.float32, torch.bfloat16):
            err = check_dist_topk(coords, qcs, qmask, k, dtype)
            if k == ITERS + 1 and dtype == torch.float32:
                k1_err = err
    # The same bins all marked valid: every row sees all h = 500 columns.
    for dtype in (torch.float32, torch.bfloat16):
        check_dist_topk(coords, qcs, torch.ones_like(qmask), ITERS + 1, dtype)
    Z, W = lc._phase1_batched_dispatch(corpus, q_ids, q_w, ITERS + 1, True)
    x = corpus.w
    zg = Z[:BLOCK_Q][:, corpus.ids]
    wg = W[:BLOCK_Q, :, :ITERS][:, corpus.ids]
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

    # Phase 3: the main path end to end, cuda against reference.
    launches = {}
    results = {}
    for method in ("act", "rwmd"):
        cfg = dict(method=method, iters=ITERS, top_l=TOP_L, block_q=BLOCK_Q)
        cuda_index = EmdIndex.build(host_corpus, EngineConfig(**cfg),
                                    device=dev)
        ref_index = EmdIndex.build(host_corpus,
                                   EngineConfig(backend="reference", **cfg),
                                   device=dev)
        dist_topk.launches = act_phase2.launches = 0
        s_c, i_c = cuda_index.search(q_ids, q_w)
        torch.cuda.synchronize()
        launches[method] = (dist_topk.launches, act_phase2.launches)
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
              f"K1={launches[method][0]} K2={launches[method][1]}",
              flush=True)
        results[method] = (cuda_index, ref_index)
    check(launches["act"][0] > 0 and launches["act"][1] > 0,
          f"act main path launched K1/K2 {launches['act']} times")
    check(launches["rwmd"][0] > 0, "rwmd main path never launched K1")

    # Phase 4: times.
    k = ITERS + 1
    k1_ms = cuda_ms(lambda: ops.dist_topk_batched(coords, qcs, qmask, k))
    k1_plain = cuda_ms(lambda: dist_topk.dist_topk_plain(coords, qcs, qmask,
                                                         k), reps=3)
    big = 1e30

    def library_k1():
        d = torch.cdist(coords.expand(NQ, -1, -1), qcs)   # (nq, v, h)
        return d.masked_fill_(~qmask[:, None, :], big).topk(k, dim=-1,
                                                            largest=False)
    k1_lib = cuda_ms(library_k1, reps=3)
    nv = int(n_valid.sum())
    k1_bytes = 4 * (coords.numel() + qcs.numel()) + qmask.numel() \
        + 8 * NQ * corpus.v * k                       # Z f32 + S int32 out
    k1_bound, k1_by = bound_ms(k1_bytes, 2.0 * corpus.v * DIM * nv)
    k2_ms = cuda_ms(lambda: ops.act_phase2_batched(x, zg, wg))
    k2_plain = cuda_ms(lambda: act_phase2.act_phase2_plain(x, zg, wg), reps=3)
    # K2 must read x once and the ladders of the entries with x > 0 (an
    # entry with x == 0 contributes exactly 0); it writes t.
    nnz = int((x > 0).sum())
    k2_bytes = 4 * x.numel() + 4 * BLOCK_Q * nnz * (2 * ITERS + 1) \
        + 4 * BLOCK_Q * corpus.n
    k2_bound, k2_by = bound_ms(k2_bytes, 5.0 * BLOCK_Q * nnz * (ITERS + 1))
    print(f"phase 4: K1 {k1_ms:.3f} ms (plain {k1_plain:.3f}, library "
          f"{k1_lib:.3f}, bound {k1_bound:.4f} by {k1_by}: {nv} valid bins "
          f"of {NQ * HMAX}); K2 {k2_ms:.3f} ms (plain {k2_plain:.3f}, bound "
          f"{k2_bound:.4f} by {k2_by}: {nnz} of {x.numel()} entries)",
          flush=True)
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
              f"{base / gib:.2f} GiB resident before it", flush=True)

    kernels = [
        {"name": "dist_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/dist_topk.cu",
         "replaces": "src/repro/kernels/dist_topk.py:121",
         "launches": launches["act"][0], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": k1_lib},
        {"name": "act_phase2", "route": "cuda",
         "source": "src/repro_torch/csrc/act_phase2.cu",
         "replaces": "src/repro/kernels/act_phase2.py:73",
         "launches": launches["act"][1], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
