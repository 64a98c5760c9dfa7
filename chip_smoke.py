#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Needs one CUDA device and ``nvcc`` (``/usr/local/cuda``); phases 12, 15
and 16 start up to four processes on it and stop them. Phases:

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
   width; K1 again with all slots valid; the fused K2 also walking every
   row to hmax (no row stop); seconds per 16-query search; peak
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
   ladder, which no longer build the stacked handoff);
8. the paper's evaluation path: all-pairs LC-RWMD, LC-OMR and LC-ACT-7 with
   precision@1/4/16 over the 20News-shaped corpus and 60,000 sparse /
   10,000 dense MNIST-shaped images, each against the reference backend
   (a 2,000-row prefix whole, its diagonal exactly 0 for LC-RWMD on both
   backends), the symmetric LC-RWMD search, the full-corpus rwmd_rev and
   ict searches, K4's all-rows form (``csrc/cand_dist_all.cu``) bitwise
   the candidate form at every row under float32 and bfloat16 costs and
   timed beside it (the old design's yardstick), and each chunk kernel's
   time, bound and library yardstick at a 256-row chunk;
9. the single-query engines (each method's 16 queries one at a time
   through ``EmdIndex.scores``: K1 at nq=1, then for LC-ACT the fused K2
   at nq=1 and for LC-RWMD and LC-OMR K3's all-rows form, with no
   (n, hmax, k) gather), against the batched rows and the reference
   backend, with search times and peaks beside the parent's route (the
   gather and the unfused K2) and, for act, the fused K2 walking every row
   to hmax (no row stop); K1 at nq=1 (k = 1, 2, 8), the fused K2 at nq=1
   (with and without the row stop) and the unfused K2 at nq=1 timed and
   held to their plain versions and bitwise to each other; the scan engine
   (bitwise a loop of single queries; all-pairs on the prefix);
   ``bf16_agg`` searches (act-7, rwmd, omr, chain, tight) on both backends
   against f32 and K1 on bfloat16 coordinates; the prefix's rwmd and
   rwmd_rev self-distances exactly 0 on both backends; the per-pair
   relaxations and the exact LP against the engines, and ``wmd_search``;
10. the serving path: (a) cascades fed by candidate sources (a k-means
   LSH and a cluster tree, ~> rwmd(256) -> act-3, and the LSH ~> rwmd(256)
   -> act(64, 3) -> ict) built at 20 Newsgroups width, on both backends:
   build seconds and host peak, width, dropped rows, the candidate step's
   time, search times and peaks, recall@16 against the full-scan ladder
   wcd(1024) -> rwmd(256) -> act-3 and against ``chain``, the source's
   (ids, mask) equal on both backends, cuda's top-16 the reference's where
   separated, a full_scan-sourced ``chain`` bitwise the unsourced one;
   (b) ``EmdServer`` over act-7 under seeded open-loop traffic (256
   requests at 200 and 800 requests/s, bench_serve's policy), no launch
   failure, every primary answer bitwise the batched search's row and
   within tolerance of the one-query search; (c) a seeded chaos schedule
   replayed twice, identical, every launch bitwise its tier's own index on
   the same padded batch; (d) append, delete, snapshot and restore,
   bitwise, the fallback past a corrupt snapshot, and an LSH-sourced
   primary restored without a refit;
11. the tiles: (a) every variant of K1, the fused K2 (on the batch and at
   nq=1), K3's corpus-row entry and the valid-bin K4 (both its libraries:
   the candidate form and the all-rows form) that
   ``analysis/smem.check_launch`` admits
   (at most ``autotune.MAX_VARIANTS`` a family, in the tuner's order),
   built together and launched at the shapes of phases 2-8 under float32
   and bfloat16 ladders: bitwise the default tile's output, the model's
   shared-memory bytes exactly ``cudaFuncGetAttributes``' static plus the
   launch's dynamic bytes, its registers under the model's cap; each
   variant's median ms of 20 launches, its bound and ``ptxas``' spills;
   (b) ``EmdIndex.build(autotune="force")`` then ``"cached"`` on one tune
   cache file for act-7 and ``tight``: the cached build times nothing and
   picks the same tiles, and both search bitwise like the default config;
   (c) ``python -m repro_torch.analysis.check --passes registry smem
   collectives`` clean (the last on 8 gloo ranks on the host's CPU); (d)
   the phase's seconds;
12. the mesh: ``EmdIndex(backend="distributed")`` on (a) a 1x1 mesh over
   NCCL, (b) a 2x2 and (c) a 1x4 mesh over gloo whose four ranks share the
   card (``repro_torch.launch.local``; the corpus written once with
   ``np.save``, memory-mapped by the ranks, which load phase 1's
   libraries), at 20News width: act-7, rwmd, omr, rwmd_rev, ict and
   symmetric rwmd (scores and top-16), the ``chain``, ``tight``, ``fast``
   and phase 10's LSH-sourced ladders, and act-7 all-pairs on the 1,000-row
   prefix under f32 and bf16; each against the single-card cuda index (act,
   rwmd, omr and ``chain`` bitwise, the rest within rtol / atol, top-16
   equal where separated; ``fast`` and the LSH ladder by their recall of
   the single card's top-16), every rank's result the same, the launches
   per rank by kernel (each run's kernels above 0), the bytes each
   collective brought, seconds per search (contended where ranks share the
   card), K1 and the fused K2 alone on each rank's shards. Then each mesh
   serves (``EmdServer`` on the mesh: the leader queues, the other ranks
   follow): on every mesh a burst of 16 requests that the ``fast`` rung
   serves (the primary's launches failed by a hook on the leader), bitwise
   the single card's ``fast``; (a) phase 10's open-loop traffic at 200 and
   800 requests/s over act-7 (p50 / p99, every primary answer bitwise the
   single card's batched row); (b) 64 requests over act-7, bitwise, then
   append 64 and delete 32 (bitwise a single-card index of the mutated
   corpus), reshards 2x2 -> 1x2 -> 2x2 (one generation each, bitwise), a
   snapshot, then ``runtime.elastic.reshard_live`` on its own moving the
   act-7 tables 2x2 -> 1x2 -> 2x2 (each rank's bitwise a fresh build's);
   (c) ``restore_server(mesh=)`` of (b)'s snapshot and of an LSH-sourced
   ``tight``-shaped primary (K4 valid on the served path), bitwise (b) and
   the single card. Each served run's launches per rank by kernel are
   equal across the ranks in its mesh, with the bytes of each label
   (``control``: the leader's commands, ``reshard``: the tables
   ``reshard_live`` moved);
13. the LM serving path (``repro_torch.models``, plain PyTorch: the JAX
   package's LM stack reaches no Pallas kernel): (a) each of the ten
   architectures at ``smoke_config`` under float32, weights drawn on the
   CPU from a seed and carried to the card, ``forward`` (logits, aux),
   ``prefill`` (logits, compact caches) and 4 ``decode_step``s (logits,
   caches) on the card against the CPU within atol / rtol 1e-4; (b)
   olmo-1b at full width (16 layers, d_model 2048, vocab 50,304; bfloat16
   weights from a ``torch.Generator`` on the card, seed 0): 4 prompts of
   2,048 tokens from ``data.tokens.global_batch`` (seed 7), ``prefill``
   (the chunked attention), prefill of the first 1,792 handed to a float32
   decode cache and the last 256 decoded token by token, 32 greedy tokens
   twice from copies of that cache (bitwise the same tokens and logits),
   every logit finite; a float32 copy of the weights the same way, decoded
   at each of the last 256 prompt positions within 2e-2 of its
   ``forward`` over the whole prompt (the chunked attention); prefill seconds, decode ms a token at batch 4, peak memory
   and the bfloat16 greedy tokens' agreement with the float32 copy's; (c)
   the same for zamba2-2.7b (54 Mamba2 layers, the shared attention block
   every 6) at 1,024-token prompts (the last 256 decoded); (d) the
   retrieval stage: (b)'s prompts
   and continuations, modulo v, as queries (``docs_to_corpus`` on phase
   3's coordinates, hmax 500) searched by ``EmdIndex(backend="cuda")``
   act-2 top-3 against the reference backend, K1 and the fused K2 each
   launched (counts set to 0 just before the search, read just after);
14. LM training (``models.model.train_loss`` with remat, ``optim``,
   ``launch.steps.make_train_step``, ``runtime.fault``; plain PyTorch, as
   the JAX package's training path reaches no Pallas kernel): (a) each of
   the ten architectures at ``smoke_config`` under float32, one train step
   on the card against the CPU on the same weights and batch (loss, grad
   norm, every parameter and both moments within atol / rtol 1e-4), and
   ``train_loss`` with remat off, ``full`` and ``dots`` agreeing on the
   card (loss within 1e-6, gradients 1e-5); smoke olmo under full remat
   at 1 x 1,536 tokens (the chunked attention, its backward and its
   recomputation), global and with a window of 1,024, one train step on
   the card against the CPU the same way; 30 smoke olmo steps under
   ``FaultTolerantRunner`` with failures injected at steps 7 and 18,
   bitwise the failure-free run on the card; (b) olmo-1b at full width
   (1.18 B parameters, bfloat16 weights, float32 moments, remat full as
   its config says): 4 x 4,096 tokens of ``data.tokens.global_batch``
   (seed 0; train_4k's rows, cut from 256 to 4 for time and memory), 1
   warm-up and 8 timed steps of AdamW (peak_lr 3e-4, warm-up 2, 8 steps):
   every loss finite, step 1's within 1.0 of ln 50,304, the last below
   the first; the next batch's step at n_micro=2 and at 1 from the same
   parameters (loss within 1e-2, grad norm within 1 %); seconds a step,
   tokens a second, 6ND TFLOP/s, peak GiB above the resident weights and
   moments under remat full and under ``dots``; one more step traced
   with ``torch.profiler`` (its own wall ms, the card's busy ms and idle
   share of it, its matmul kernels' ms, the kernels of most device time);
15. LM training on a (data, model) mesh (``sharding.rules``,
   ``launch.steps.make_mesh_train_step``, ``runtime.elastic``; plain
   PyTorch and collectives, no kernel): (a) olmo-1b whole on a 1x1 NCCL
   mesh, mode tp, 4 x 4,096 tokens: a warm-up and 2 timed mesh steps, the
   warm-up's loss, grad norm and parameters against phase 14's
   single-card step from the same weights (parameters within 1 bf16 ulp;
   bitwise on the card); (b) a 2x2 gloo world whose four ranks share the
   card, olmo-1b at full width with its depth cut to ``P15_LAYERS``
   (printed), modes tp and fsdp: step 1 against a 1x1 step at that depth
   and batch, then 2 timed, each rank's resident and peak GiB, seconds
   and bytes a step by label; a checkpoint of the fsdp state, the world
   re-planned 1x4, ``restore_on_mesh`` and a step against the 2x2
   continuation; (c) mixtral at smoke width with ``moe_shard_map`` on
   that 1x4 mesh (one expert row a rank) under remat dots and full, with
   and without torch's early stop of the recomputation, against the
   plain path, and the ``moe_out`` bytes;
16. LM prefill and decode on a (data, model) mesh
   (``launch.steps.make_mesh_prefill_step`` / ``make_mesh_decode_step``,
   ``MeshServeState``, ``sharding.rules.serve_plan``; plain PyTorch and
   collectives, no kernel): (a) olmo-1b whole, bf16, on a 1x1 NCCL mesh:
   the prefill of phase 13's 4 x 2,048 prompts and ``P16_STEPS`` greedy
   decode steps, bitwise the single card's (logits, caches, tokens; no
   byte crossing); (b) olmo-1b at full width with its depth cut to
   ``P16_LAYERS`` on a 2x2 gloo world sharing the card (attention on the
   rank's heads, d_ff and the vocabulary split over ``model``, each TP
   block gathered over ``data`` only): the same prompts and steps fed the
   single card's greedy tokens at that depth, the logits no farther from
   a float32 copy's than the single card's are plus ``P16_LOGITS_ATOL``,
   and the tokens equal where the float32 top-2 margin exceeds twice that
   bar; each rank's bytes by label (exactly
   the layout's), resident and peak GiB, seconds for the prefill and a
   decode step; (c) smoke gemma3 at batch 1 on a 1x4 gloo world, its
   cache's sequence split over ``model`` (SP; the window across a block
   boundary), within 1e-4 of the single card in float32.

Any failed check exits non-zero before the last line. The last lines are the
card's name and power limit, a JSON line of the kernels and
``{"ok": true, "device": {...}}``.
"""
import asyncio
import collections
import copy
import dataclasses
import functools
import gc
import hashlib
import json
import math
import os
import re
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import tracemalloc

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.api import EmdIndex, EngineConfig  # noqa: E402
from repro_torch.candidates import (CentroidLSHSpec,  # noqa: E402
                                    ClusterTreeSpec)
from repro_torch.cascade import (CascadeSpec, CascadeStage,  # noqa: E402
                                 resolve_spec, stage_rows, topk_recall,
                                 topk_smallest)
from repro_torch.cascade import search as cascade_search  # noqa: E402
from repro_torch.core import (histogram, lc, relaxations,  # noqa: E402
                              retrieval, wmd)
from repro_torch.configs.emd_20news import CONFIG as NEWS  # noqa: E402
from repro_torch.configs.emd_mnist import CONFIG as MNIST  # noqa: E402
from repro_torch.core.emd import emd_exact  # noqa: E402
from repro_torch.core.lc import Corpus  # noqa: E402
from repro_torch.core.precision import pad_dist_for  # noqa: E402
from repro_torch.data.synth import (make_clustered_text,  # noqa: E402
                                    make_image_like)
from repro_torch.analysis import check as static_check  # noqa: E402
from repro_torch.analysis import smem  # noqa: E402
from repro_torch.kernels import (_build, act_phase2, autotune,  # noqa: E402
                                 cand_pour, dist_topk, ops, timing)
from repro_torch.launch.local import run_local  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_config,  # noqa: E402
                                 smoke_config)
from repro_torch.data.tokens import DataConfig, global_batch  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import model as lm  # noqa: E402
from repro_torch.models import parity as lm_parity  # noqa: E402
from repro_torch.serving import (ChaosInjector, ChaosSchedule,  # noqa: E402
                                 EmdServer, ServerOverloaded, ServeResult,
                                 ServingPolicy, corrupt_checkpoint,
                                 restore_latest, restore_server, snapshot)

# 20 Newsgroups width: the port's configs/emd_20news.py.
N_DOCS, VOCAB, DIM, HMAX, ITERS = (NEWS.n_db, NEWS.vocab, NEWS.dim,
                                   NEWS.hmax, NEWS.iters)
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
    "cand_dist_valid.all_ict": ("cand_dist_all",
                                "src/repro/kernels/cand_pour.py:214"),
    "cand_dist_valid.all_rev_min": ("cand_dist_all",
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


# Slice 6, the paper's evaluation path (phase 8): corpus-as-queries
# all-pairs precision. The methods of each all-pairs run with their iters,
# and the precision depths.
EVAL_METHODS = {"rwmd": 0, "omr": 0, "act": ITERS}
EVAL_L = (1, 4, 16)
#: Rows of the prefix whose whole matrix is held against the reference.
PREFIX = 2_000
#: Seeded rows of each directional matrix held against the reference.
CHECK_ROWS = 32
#: The dense MNIST-shaped corpus is cut from 60,000 rows to this many for
#: the time limit (depth only: v = 784 and hmax = 784 are kept).
DENSE_N = 10_000
#: Queries of an all-pairs chunk that K1 also runs alone (seeded, and the
#: chunk's last), each held bitwise to its rows of the chunk's launch.
K1_ALONE = 7
#: Corpus rows over which K4's all-rows form at a dense MNIST-shaped chunk
#: is held against its plain version (every (query, row) pair there costs
#: 784 x 784 cost reads, and the plain version sorts each entry's 784), and
#: over which, at every chunk, both are held against the plain version's
#: float64 value.
K4_F64_ROWS = 64
#: The MNIST-shaped corpora: the port's configs/emd_mnist.py (v = 28 x 28
#: pixels, m = 2), ten classes.
SIDE, N_CLASSES = 28, 10
#: Precision at chance on the dense corpus: within this of the label
#: distribution's sum of squared frequencies.
CHANCE_TOL = 0.03


# Slice 7 (phase 9): the single-query engines, the scan engine, bf16_agg
# and the oracles. Every method with its iters, scored one query at a time.
SINGLE_METHODS = {"act": ITERS, "rwmd": 0, "rwmd_rev": 0, "omr": 0,
                  "ict": 0, "bow": 0, "wcd": 0}
#: The single-query engines that launch K1, with its k.
SINGLE_K = {"act": ITERS + 1, "omr": 2, "rwmd": 1}
#: What each of them launches after K1 at nq=1: LC-ACT the fused K2,
#: LC-RWMD and LC-OMR K3's all-rows form; once a query.
SINGLE_ROUTE = {"act": ("act_phase2_gather",),
                "rwmd": ("cand_pour_rows.all_pour_iters0",),
                "omr": ("cand_pour_rows.all_omr",)}
#: Interleaved rounds in which phase 9 (a) times one LC-ACT query with
#: and without the fused K2's row stop.
ROUTE_PAIRS = 40
#: bf16_agg against f32: the reference's measured band
#: (tests/test_precision.py), and the searches held to it.
AGG_ATOL = 0.4
AGG_SEARCHES = ("act", "rwmd", "omr", "chain", "tight")
#: The oracles: queries and their act-7 top rows held to the per-pair
#: relaxations and the exact LP; wmd_search's queries and top_l.
ORACLE_QUERIES, ORACLE_TOP, WMD_QUERIES, WMD_TOP = 4, 4, 2, 4
ORACLE_RTOL = 1e-5


# Slice 8 (phase 10): the serving path. The sourced cascades follow
# benchmarks/bench_cascade.py's sizing at n=18,828: ~12 % of the buckets
# probed, caps ~2x the mean occupancy (147 rows a bucket, 74 a leaf), and a
# refine equal to the reference ladder's wcd budget.
LSH_SPEC = CentroidLSHSpec(n_buckets=128, probes=16, bucket_cap=320,
                           refine=1024)
TREE_SPEC = ClusterTreeSpec(branching=16, depth=2, beam=16, probes=16,
                            leaf_cap=160, refine=1024)
SOURCED = {
    "lsh": CascadeSpec(stages=(CascadeStage("rwmd", 256),), rescorer="act",
                       rescorer_iters=ACT3, source=LSH_SPEC),
    "tree": CascadeSpec(stages=(CascadeStage("rwmd", 256),),
                        rescorer="act", rescorer_iters=ACT3,
                        source=TREE_SPEC),
    # tight-shaped: reaches K4 through its ict rescorer
    "lsh_tight": CascadeSpec(stages=(CascadeStage("rwmd", 256),
                                     CascadeStage("act", 64, iters=ACT3)),
                             rescorer="ict", source=LSH_SPEC),
}
#: bench_cascade's full-scan reference ladder at this n.
FULL_SCAN_SPEC = CascadeSpec(stages=(CascadeStage("wcd", 1024),
                                     CascadeStage("rwmd", 256)),
                             rescorer="act", rescorer_iters=ACT3)
#: Serving traffic: requests (seeded corpus rows), the open-loop loads in
#: requests/s, the chaos replay's concurrent group; the lifecycle's
#: mutations.
SERVE_REQUESTS, SERVE_LOADS, CHAOS_GROUP = 256, (200.0, 800.0), 2
LIFE_APPEND, LIFE_DELETE = 64, 32


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


def check_dist_topk(coords, qcs, qmask, k, dtype, qids=None):
    """K1 against its plain version (coordinates float32 or bfloat16; with
    ``qids`` the plain version pins the same-id pairs to 0, which the
    kernel gives by itself); returns max |Z - Z_plain|."""
    zk, sk = ops.dist_topk_batched(coords, qcs, qmask, k, out_dtype=dtype)
    zp, sp = dist_topk.dist_topk_plain(coords, qcs, qmask, k, dtype, qids)
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
    if qids is not None:
        vq, vc = torch.nonzero(qmask, as_tuple=True)
        own = qids[vq, vc].long()
        check(bool((zk[vq, own, 0] == 0).all()
                   and (zp[vq, own, 0] == 0).all()),
              f"dist_topk k={k} {dtype}: a valid bin's distance to its own "
              "row is not exactly 0")
    print(f"  K1 k={k} {str(dtype):14s} coords {str(coords.dtype):14s} "
          f"max|dZ|={err:.3g} "
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
            **{f"cand_dist_valid.{mode}": c
               for mode, c in cand_pour.valid_launches.items()},
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
            lambda **t: ops.cand_ict_valid(corpus.ids, corpus.w, narrow,
                                           *valid, **t),
            lambda: cand_pour.cand_ict_valid_plain(corpus.ids, corpus.w,
                                                   narrow, *valid),
            # a max scan and one selection pass over the len_q costs
            *valid_work(narrow, 2, 0)),
        "cand_dist_valid.rev_min": (
            lambda **t: ops.cand_rev_min_valid(corpus.ids, corpus.w, narrow,
                                               *valid, **t),
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
            lambda **t: ops.cand_pour_rows(ids, w, narrow, Z4, W4, ACT3,
                                           **t),
            lambda: cand_pour.cand_pour_rows_plain(ids, w, narrow, Z4, W4,
                                                   ACT3),
            *rows_work(narrow, 2 * ACT3 + 1, 5 * (ACT3 + 1))),
        "cand_pour_rows.pour_iters0": (
            lambda **t: ops.cand_pour_rows(ids, w, narrow, Z1, None, 0,
                                           **t),
            lambda: cand_pour.cand_pour_rows_plain(ids, w, narrow, Z1, None,
                                                   0),
            *rows_work(narrow, 1, 2)),
        "cand_pour_rows.omr": (
            lambda **t: ops.cand_omr_rows(ids, w, wide, Z2, W0, **t),
            lambda: cand_pour.cand_omr_rows_plain(ids, w, wide, Z2, W0),
            *rows_work(wide, 3, 4)),
        "cand_pour_rows.all_pour_iters0": (
            lambda **t: ops.cand_pour_rows(ids, w, None, Z1, None, 0, **t),
            lambda: cand_pour.cand_pour_rows_plain(ids, w, None, Z1, None,
                                                   0),
            *rows_work(None, 1, 2)),
        "cand_pour_rows.all_omr": (
            lambda **t: ops.cand_omr_rows(ids, w, None, Z2, W0, **t),
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
    surv, _ = cascade_search._prune(corpus, q_ids, q_w, spec,
                                 spec.resolve_budgets(corpus.n, TOP_L),
                                 n_valid=None, topk_blocks=1,
                                 engine="batched", use_kernels=True,
                                 block_q=BLOCK_Q,
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


def prefix_corpus(host, rows):
    """The first ``rows`` rows of a host corpus, at the same width."""
    return Corpus(ids=host.ids[:rows], w=host.w[:rows], coords=host.coords)


def timed(fn):
    """(fn(), host seconds around the call and a synchronize, the peak
    device memory above what was allocated before it in GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            (torch.cuda.max_memory_allocated() - base) / 2**30)


def sum_band(S, live, live_cols=None):
    """The tolerance of each entry of an all-pairs matrix (or of its rows
    ``live``, columns ``live_cols``) held against another backend's: ATOL
    plus the larger of RTOL and the float32 bound for two orders of
    summation, (L - 1) 2^-24, relative, where L is the number of live
    entries the score sums (the larger row of the pair; 784 on dense
    images, where RTOL alone is below the bound)."""
    cols = live if live_cols is None else live_cols
    L = torch.maximum(live[:, None], cols[None, :]).float()
    return ATOL + torch.clamp_min((L - 1) * 2.0**-24, RTOL) * S.abs()


def off_diagonal(S):
    return ~torch.eye(S.shape[0], dtype=torch.bool, device=S.device)


def excess(got, want, band=None):
    """Where ``got`` exceeds the band around ``want`` (default rtol/atol)
    most: a description for a failed check (count, place, both values)."""
    band = ATOL + RTOL * want.abs() if band is None else band
    over = (got - want).abs() - band
    i = int(over.argmax())
    at = np.unravel_index(i, tuple(over.shape))
    return (f"{int((over > 0).sum())} entries beyond the band; worst at "
            f"{tuple(int(a) for a in at)}: {got.flatten()[i].item()!r} vs "
            f"{want.flatten()[i].item()!r}")


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def off_diagonal_zero(S):
    nz = torch.nonzero(S)
    return bool((nz[:, 0] == nz[:, 1]).all())


def chance_level(labels):
    """Precision@l of a ranking blind to the labels: the sum of the
    squared label frequencies."""
    freq = np.bincount(labels) / len(labels)
    return float((freq ** 2).sum())


def near_ties_only(S_c, S_r, top_l):
    """The number of rows whose top-l sets (self excluded) differ between
    the cuda and the reference matrices, and whether each of them has a
    near-tie at the reference's l-th place (its l-th and (l+1)-th scores
    within twice the tolerance): the only way two matrices within
    tolerance of each other can rank differently."""
    i_c = retrieval.top_l_rows(S_c, top_l, exclude_self=True)
    i_r = retrieval.top_l_rows(S_r, top_l, exclude_self=True)
    rows = torch.nonzero((i_c.sort(dim=1).values
                          != i_r.sort(dim=1).values).any(dim=1))[:, 0]
    if rows.numel() == 0:
        return 0, True
    m = S_r[rows].clone()
    m[torch.arange(rows.numel(), device=m.device), rows] = float("inf")
    v = m.sort(dim=1).values[:, top_l - 1:top_l + 1]
    gap = v[:, 1] - v[:, 0]
    return int(rows.numel()), bool(
        (gap <= 2 * (ATOL + RTOL * v[:, 1].abs())).all())


def eval_corpus(name, host, labels, dev, runs, keep_rows=None):
    """Phase 8 (a)-(c) on one corpus: ``EmdIndex.all_pairs`` and
    ``precision_at_l`` with LC-RWMD, LC-OMR and LC-ACT-7 on the cuda
    backend, the launch counts set to 0 before each all-pairs and read
    after (into ``runs``). Each matrix must be finite and exactly
    symmetric; at CHECK_ROWS seeded rows the directional scores must agree
    with the reference backend's, the matrix must not fall below them, and
    the rows' block of the matrix must be max(D, D^T) of the reference.
    Returns {method: numbers}, the recall@16 of rwmd and omr against act
    and the rows ``keep_rows`` of the rwmd matrix."""
    index = EmdIndex.build(host, EngineConfig(top_l=TOP_L), device=dev)
    n = index.n
    check_rows = torch.tensor(np.sort(np.random.default_rng(SEED).choice(
        n, CHECK_ROWS, replace=False)), device=dev)
    qi, qw = index.corpus.ids[check_rows], index.corpus.w[check_rows]
    out, idx, kept = {}, {}, None
    for method, iters in EVAL_METHODS.items():
        ix = index.with_config(method=method, iters=iters)
        zero_counts()
        S, secs, peak = timed(ix.all_pairs)
        runs[f"all_pairs.{name}.{method}"] = counts = read_counts()
        prec, prec_secs, _ = timed(lambda: {
            f"p@{l}": ix.precision_at_l(labels, l, scores=S)
            for l in EVAL_L})
        check(bool(torch.isfinite(S).all()) and S.max().item() < 1e3,
              f"{name} {method}: a score is not finite or reached the "
              "sentinel scale")
        check(torch.equal(S, S.T), f"{name} {method}: the all-pairs matrix "
              "is not exactly symmetric")
        d_c = ix.scores(qi, qw)
        d_r = ix.with_config(backend="reference").scores(qi, qw)
        err = (d_c - d_r).abs().max().item()
        check(torch.allclose(d_c, d_r, rtol=RTOL, atol=ATOL),
              f"{name} {method}: directional rows cuda vs reference max "
              f"|d| {err}")
        rows_s = S[check_rows]
        check(bool((rows_s >= d_r - (ATOL + RTOL * d_r.abs())).all()),
              f"{name} {method}: a symmetric score is below its "
              "directional reference")
        block = rows_s[:, check_rows]
        want = torch.maximum(d_r[:, check_rows], d_r[:, check_rows].T)
        block_err = (block - want).abs().max().item()
        check(torch.allclose(block, want, rtol=RTOL, atol=ATOL),
              f"{name} {method}: the seeded rows' block of the matrix is "
              f"{block_err} from max(D, D^T) of the reference")
        idx[method] = retrieval.top_l_rows(S, TOP_L, exclude_self=True)
        zero = off_diagonal_zero(S)
        if method == "rwmd" and keep_rows is not None:
            kept = S[keep_rows].clone()
        del S
        out[method] = dict(seconds=secs, peak_gib=peak,
                           precision_seconds=prec_secs, **prec,
                           rows_err=err, block_err=block_err,
                           zero_off_diagonal=zero)
        print(f"phase 8: {name} all-pairs {method}-{iters} n={n}: "
              f"{secs:.3f} s, peak above the resident {peak:.3f} GiB "
              f"(the matrix alone {4 * n * n / 2**30:.3f}); precision@"
              + "/".join(map(str, EVAL_L)) + " " + " ".join(
                  f"{prec[f'p@{l}']:.6f}" for l in EVAL_L)
              + f" ({prec_secs:.3f} s for the three); exactly symmetric; "
              f"{CHECK_ROWS} seeded directional rows cuda vs reference "
              f"max|d|={err:.3g}, their block vs max(D, D^T) "
              f"{block_err:.3g}; zero off the diagonal: {zero}; launches "
              f"{nonzero(counts)}", flush=True)
    recall = {m: retrieval.topl_overlap(idx[m], idx["act"])
              for m in ("rwmd", "omr")}
    print(f"phase 8: {name} recall@{TOP_L} against act-{ITERS}: "
          + ", ".join(f"{m} {r:.6f}" for m, r in recall.items()),
          flush=True)
    return out, recall, kept


def eval_prefix(name, host, labels, dev):
    """Phase 8: the whole matrix and the precisions of a PREFIX-row prefix
    (at the same width) on the cuda backend against the reference
    backend. Returns {method: cuda matrix} and {method: numbers}."""
    lab = labels[:PREFIX]
    index = EmdIndex.build(prefix_corpus(host, PREFIX),
                           EngineConfig(top_l=TOP_L), device=dev)
    live = (index.corpus.w > 0).sum(dim=1)
    off = off_diagonal(torch.empty(index.n, index.n, device=dev))
    mats, out = {}, {}
    for method, iters in EVAL_METHODS.items():
        c = index.with_config(method=method, iters=iters)
        r = c.with_config(backend="reference")
        S_c, secs_c, _ = timed(c.all_pairs)
        S_r, secs_r, _ = timed(r.all_pairs)
        # A row's distance to itself is exactly 0 on both backends: K1 by
        # its FMA order, the reference's float32 product by the same-id pin
        # of pairwise_dist.
        band = sum_band(S_r, live)
        d = (S_c - S_r).abs()
        err = d[off].max().item()
        diag = d.diagonal().max().item()
        check(bool((d <= band).all()),
              f"{name} prefix {method}: cuda vs reference max |d| {err} off "
              f"the diagonal, {diag} on it; {excess(S_c, S_r, band)}")
        zero_diag = (bool((S_c.diagonal() == 0).all()),
                     bool((S_r.diagonal() == 0).all()))
        check(method != "rwmd" or all(zero_diag),
              f"{name} prefix rwmd: a row's distance to itself is not "
              f"exactly 0 (cuda, reference): {zero_diag}")
        row = dict(seconds=secs_c, reference_seconds=secs_r, max_abs_err=err,
                   diagonal_err=diag, zero_diagonal=zero_diag)
        for l in EVAL_L:
            p_c = c.precision_at_l(lab, l, scores=S_c)
            p_r = r.precision_at_l(lab, l, scores=S_r)
            differ, ties = near_ties_only(S_c, S_r, l)
            check(p_c == p_r or ties, f"{name} prefix {method} p@{l}: cuda "
                  f"{p_c} vs reference {p_r} with {differ} rows whose top-"
                  f"{l} differs beyond a near-tie")
            row[f"p@{l}"], row[f"ref_p@{l}"] = p_c, p_r
            row[f"rows_differ@{l}"] = differ
        row["zero_off_diagonal"] = (off_diagonal_zero(S_c),
                                    off_diagonal_zero(S_r))
        out[method] = row
        mats[method] = S_c
        del S_r
        print(f"phase 8: {name} prefix n={PREFIX} {method}-{iters}: cuda "
              f"{secs_c:.3f} s, reference {secs_r:.3f} s, max|d|={err:.3g} "
              f"off the diagonal ({diag:.3g} on it); "
              "precision cuda/reference " + " ".join(
                  f"@{l} {row[f'p@{l}']:.6f}/{row[f'ref_p@{l}']:.6f} "
                  f"({row[f'rows_differ@{l}']} rows differ)" for l in EVAL_L)
              + "; zero off the diagonal (cuda, reference): "
              f"{row['zero_off_diagonal']}; diagonal exactly 0: "
              f"{zero_diag}", flush=True)
    return mats, out


def chunk_kernel_times(name, host, dev):
    """Phase 8: K1 (k=8), the fused K2 (iters 7) and K3's all-rows form
    (the dump and omr) at the first all-pairs chunk of a corpus, its first
    ALL_PAIRS_QUERIES rows as queries against every row, with their
    bounds. K1's operations are 2m + 1 per (vocabulary row, valid bin):
    the products and a comparison of the selection."""
    corpus = host.to(dev)
    nq = retrieval.ALL_PAIRS_QUERIES
    q_ids, q_w = corpus.ids[:nq].contiguous(), corpus.w[:nq].contiguous()
    v, m, n = corpus.v, corpus.m, corpus.n
    x, ids = corpus.w, corpus.ids
    live = x > 0
    nnz = int(live.sum())
    n_ids = int(torch.unique(ids[live]).numel())
    nv = int((q_w > 0).sum())
    qcs, qmask = corpus.coords[q_ids], q_w > 0
    k = ITERS + 1
    Z, W = lc._phase1_batched_dispatch(corpus, q_ids, q_w, k, True)
    Z1, _ = lc._phase1_batched_dispatch(corpus, q_ids, q_w, 1, True)
    Z2, W2 = lc._phase1_batched_dispatch(corpus, q_ids, q_w, 2, True)
    W0 = W2[..., 0].contiguous()

    # The fused K2 reads x only up to each row's length, and the lengths.
    x_to_lens = 4 * int(act_phase2.row_lens(x).sum()) + 4 * n

    def rows_bytes(width, x_bytes=4 * x.numel()):
        """x once (``x_bytes``), the ids of its live slots, ``width``
        ladder values of each distinct (query, id) they name; t out."""
        return x_bytes + 4 * nnz + 4 * width * nq * n_ids + 4 * nq * n
    cases = {
        "dist_topk": (lambda: ops.dist_topk_batched(corpus.coords, qcs,
                                                    qmask, k),
                      4 * (corpus.coords.numel() + qcs.numel())
                      + qmask.numel() + 8 * nq * v * k,
                      (2 * m + 1) * v * nv),
        "act_phase2_gather": (lambda: ops.act_phase2_gather(x, ids, Z, W),
                              rows_bytes(2 * ITERS + 1, x_to_lens),
                              5 * nq * nnz * (ITERS + 1)),
        "cand_pour_rows.all_pour_iters0": (
            lambda: ops.cand_pour_rows(ids, x, None, Z1, None, 0),
            rows_bytes(1), 2 * nq * nnz),
        "cand_pour_rows.all_omr": (
            lambda: ops.cand_omr_rows(ids, x, None, Z2, W0),
            rows_bytes(3), 4 * nq * nnz),
    }
    library = {
        "dist_topk": lambda: k1_library_ms(corpus.coords, qcs, qmask, k),
        "cand_pour_rows.all_pour_iters0": lambda: dump_library_ms(
            ids, x, Z1, cases["cand_pour_rows.all_pour_iters0"][0]()),
    }
    out = {}
    for kname, (fn, nbytes, flops) in cases.items():
        ms = cuda_ms(fn, reps=5)
        b_ms, b_by = bound_ms(nbytes, flops)
        lib_ms = library[kname]() if kname in library else None
        out[kname] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by,
                          library_ms=lib_ms)
        print(f"phase 8: {name} chunk nq={nq} n={n} v={v} m={m} "
              f"hmax={corpus.hmax} ({nv} valid query bins): {kname} "
              f"{ms:.4f} ms, bound {b_ms:.4f} by {b_by} "
              f"({nbytes / 1e9:.3f} GB, {flops / 1e9:.3f} GFLOP); library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f}'}",
              flush=True)
    # K1 splits the chunk's queries into groups where its vocabulary tiles
    # do not fill the card; a query launched alone is one group, and its
    # output must be bitwise its rows of the chunk's. And, where its plain
    # version fits the card, K1 against that (exact zeros of integer pixel
    # coordinates included).
    zk, sk = ops.dist_topk_batched(corpus.coords, qcs, qmask, k)
    alone = torch.randperm(nq, generator=torch.Generator().manual_seed(SEED))
    alone = alone[:K1_ALONE].tolist() + [nq - 1]
    for q in alone:
        z1, s1 = ops.dist_topk_batched(corpus.coords, qcs[q:q + 1],
                                       qmask[q:q + 1], k)
        check(torch.equal(z1[0], zk[q]) and torch.equal(s1[0], sk[q]),
              f"{name}: K1 on query {q} alone differs from its rows of the "
              "chunk's launch")
    if v * corpus.hmax * nq < 2**28:
        check_dist_topk(corpus.coords, qcs, qmask, k, torch.float32)
        zp, _ = dist_topk.dist_topk_plain(corpus.coords, qcs, qmask, k)
        check(torch.equal(zk == 0, zp == 0),
              f"{name}: K1's exact zeros differ from its plain version's")
    print(f"phase 8: {name} chunk: K1 on {len(alone)} queries launched "
          "alone, bitwise their rows of the chunk's launch", flush=True)
    return out


#: Most elements of one group of a library yardstick at an all-pairs chunk
#: (cdist's (group, v, width) distances; embedding_bag's indices).
LIB_ELEMS = 1 << 29


def k1_library_ms(coords, qcs, qmask, k):
    """K1's library yardstick at a chunk: ``torch.cdist`` + ``torch.topk``
    over each query's valid bins (gathered first and padded to the widest
    query, outside the timed calls), in groups of queries whose (group, v,
    width) distances stay within LIB_ELEMS floats; the sum of the groups'
    median times (ms)."""
    nq, _, m = qcs.shape
    width = int(qmask.sum(dim=1).max())
    order = torch.argsort((~qmask).int(), dim=1, stable=True)[:, :width]
    qv = torch.gather(qcs, 1, order[..., None].expand(-1, -1, m))
    mv = torch.gather(qmask, 1, order)
    group = max(1, min(nq, LIB_ELEMS // (coords.shape[0] * width)))
    total = 0.0
    for s in range(0, nq, group):
        qg, mg = qv[s:s + group], mv[s:s + group]

        def call():
            d = torch.cdist(coords.expand(qg.shape[0], -1, -1), qg)
            return d.masked_fill_(~mg[:, None, :], 1e30).topk(
                k, dim=-1, largest=False)
        total += cuda_ms(call, reps=3, warmup=1)
    return total


def dump_library_ms(ids, x, Z1, want):
    """The LC-RWMD dump's library yardstick at a chunk (K3's all-rows form
    at iters 0): ``embedding_bag`` over the (nq v, 1) table of nearest costs
    with per-slot weights, every row for every query, in groups of queries
    whose int32 indices (built outside the timed calls) stay within
    LIB_ELEMS; the sum of the groups' median times (ms). Each group's
    result is held to the kernel's (``want``)."""
    nq, v, _ = Z1.shape
    hmax = ids.shape[1]
    table = Z1.reshape(-1, 1)
    group = max(1, min(nq, LIB_ELEMS // ids.numel()))
    total = 0.0
    for s in range(0, nq, group):
        e = min(nq, s + group)
        offs = torch.arange(s, e, device=ids.device, dtype=torch.int32) * v
        flat = (ids[None] + offs[:, None, None]).reshape(-1, hmax)
        wts = x.expand(e - s, -1, -1).reshape(-1, hmax)

        def call():
            return torch.nn.functional.embedding_bag(
                flat, table, per_sample_weights=wts, mode="sum")
        got = call().reshape(e - s, -1)
        check(torch.allclose(got, want[s:e], rtol=RTOL, atol=ATOL),
              "the embedding_bag yardstick disagrees with cand_pour_rows at "
              "a chunk")
        total += cuda_ms(call, reps=3, warmup=1)
        del flat, wts, got
    return total


def valid_rows_work(corpus, valid, ops_per_bin, row_ops_per_bin):
    """Bytes and operations of K4's all-rows form: it reads the weights of
    every row, the ids of their slots with x > 0, len_q costs of each
    distinct (query, id) those name, qoff and qwv, and writes t (nq, n);
    it does ops_per_bin operations per valid bin of each (query, entry)
    and row_ops_per_bin per valid bin of each (query, row)."""
    _, qoff, qwv = valid
    lens = (qoff[1:] - qoff[:-1]).long()
    live = corpus.w > 0
    nnz = int(live.sum())
    ids_u = int(torch.unique(corpus.ids[live]).numel())
    bins = int(lens.sum())
    nbytes = 4 * corpus.w.numel() + 4 * nnz \
        + valid[0].element_size() * ids_u * bins + 4 * qoff.numel() \
        + 4 * qwv.numel() + 4 * lens.numel() * corpus.n
    return nbytes, (ops_per_bin * nnz + row_ops_per_bin * corpus.n) * bins


def group_quads(bounds, starts):
    """Aligned quads of each column group of K4's all-rows plan (the
    columns every live entry's gather copies for the group)."""
    out = []
    for a, b in zip(starts, starts[1:]):
        full = [q for q in range(a, b) if bounds[q + 1] > bounds[q]]
        out.append((bounds[full[-1] + 1] - 1) // 4 - bounds[full[0]] // 4 + 1
                   if full else 0)
    return out


def check_all_rows_k4(corpus, q_ids, q_w):
    """Phase 8 (e): K4's all-rows form (``csrc/cand_dist_all.cu``), both
    modes, on the 16-query batch over every corpus row, under float32 and
    bfloat16 costs: bitwise the candidate form (``csrc/cand_dist_valid.cu``)
    at cand = every row, and (f32) against its plain version. Times, in
    turns (the candidate form, the kernel, the kernel, the candidate form):
    the bare launch of each, the candidate form being the old design's
    yardstick; then the wrapper, the plain version (one call), the bound,
    the compiler's registers and blocks an SM, and the costs the kernel
    gathers from the L2 (every live entry's quads of its column group) over
    its time."""
    every = torch.arange(corpus.n, device=corpus.w.device).expand(
        NQ, corpus.n).contiguous()
    nnz = int((corpus.w > 0).sum())
    out = {}
    for precision in ("f32", "bf16"):
        dt = torch.float32 if precision == "f32" else torch.bfloat16
        valid = lc.phase1_valid_dist(corpus.coords, q_ids, q_w, precision)
        Dv, qoff, qwv = valid
        bounds = qoff.tolist()
        plan = cand_pour.all_rows_plan(bounds, Dv.device)
        quads = group_quads(bounds, cand_pour.column_groups(bounds)[0])
        gathered = nnz * 4 * sum(quads) * Dv.element_size()
        args = (corpus.ids, corpus.w, None) + tuple(valid)
        for mode, op, plain, per_bin, per_row in (
                ("rev_min", ops.cand_rev_min_valid,
                 cand_pour.cand_rev_min_valid_plain, 1, 2),
                ("ict", ops.cand_ict_valid, cand_pour.cand_ict_valid_plain,
                 2, 0)):
            name = f"cand_dist_valid.all_{mode}"
            got = op(*args)

            def new():
                return cand_pour.cand_dist_all_cuda(corpus.ids, corpus.w, Dv,
                                                    qoff, qwv, mode, plan)

            def old():
                return cand_pour.cand_dist_valid_cuda(
                    corpus.ids, corpus.w, every, Dv, qoff, qwv, mode)
            same = old()
            check(torch.equal(got, same) and torch.equal(new(), got),
                  f"{name} {precision}: not bitwise the candidate form at "
                  f"every row ({int((got != same).sum())} of {got.numel()} "
                  "differ)")
            old_ms = [cuda_ms(old, reps=10)]
            new_ms = [cuda_ms(new, reps=20), cuda_ms(new, reps=20)]
            old_ms.append(cuda_ms(old, reps=10))
            a = cand_pour.all_attrs(mode, plan[1], dt)
            layout = ops.block_layout("cand_dist", nq=NQ, b=corpus.n, h=HMAX,
                                      mode=mode, form="all", quads=plan[1],
                                      bf16=precision == "bf16")
            per_sm = smem.blocks_per_sm(layout, regs=a["regs"])
            ms = min(new_ms)
            row = dict(ms=ms, old_design_ms=min(old_ms), regs=a["regs"],
                       blocks_per_sm=per_sm, gathered_gb=gathered / 1e9,
                       gathered_gbps=gathered / 1e6 / ms)
            note = ""
            if precision == "f32":
                want, plain_s, _ = timed(lambda: plain(*args))
                err = (got - want).abs().max().item()
                check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
                      f"{name}: max |d| {err} from its plain version beyond "
                      f"rtol {RTOL} atol {ATOL}")
                check(bool(torch.isfinite(got).all())
                      and got.max().item() < 1e3,
                      f"{name}: a score reached the sentinel scale")
                wrapped = host_ms(lambda: op(*args), reps=5)
                nbytes, flops = valid_rows_work(corpus, valid, per_bin,
                                                per_row)
                b_ms, b_by = bound_ms(nbytes, flops)
                out[name] = dict(max_abs_err=err, plain_ms=1e3 * plain_s,
                                 bound_ms=b_ms, bound_by=b_by,
                                 wrapper_ms=wrapped, **row)
                note = (f"; max|d| vs plain {err:.3g}, the wrapper "
                        f"{wrapped:.4f} ms, plain {1e3 * plain_s:.1f} ms "
                        f"(one call); bound {b_ms:.4f} by {b_by} "
                        f"({nbytes / 1e9:.3f} GB, {flops / 1e9:.3f} GFLOP)")
            else:
                out[name].update({f"{k}_bf16": v for k, v in row.items()})
            print(f"phase 8: {name} {precision} nq={NQ} n={corpus.n} "
                  f"({Dv.shape[1]} valid bins, column groups of "
                  f"{quads} quads): bitwise the candidate form at every "
                  f"row; the bare launch {new_ms[0]:.4f} / {new_ms[1]:.4f} "
                  f"ms, the old design (the candidate form at cand = every "
                  f"row) {old_ms[0]:.4f} / {old_ms[1]:.4f} ms; "
                  f"{a['regs']} registers, {layout.smem_bytes} B shared, "
                  f"{per_sm} blocks/SM; gathers {gathered / 1e9:.3f} GB of "
                  f"costs, {gathered / 1e6 / ms:.0f} GB/s{note}", flush=True)
    return out


def full_corpus_rev(host_corpus, q_ids, q_w, dev, runs):
    """Phase 8 (e): the full-corpus rwmd_rev and ict searches of the
    16-query batch on the cuda backend, each one all-rows K4 launch (the
    stacked handoff these engines built before took 23.3 ms and 4.68 GiB
    for rwmd_rev on an H100 80GB HBM3 at 700 W); rwmd_rev also against the
    reference backend."""
    out = {}
    for method, mode in (("rwmd_rev", "rev_min"), ("ict", "ict")):
        index = EmdIndex.build(host_corpus, EngineConfig(method=method,
                                                         top_l=TOP_L),
                               device=dev)
        zero_counts()
        s_c = index.scores(q_ids, q_w)
        torch.cuda.synchronize()
        runs[f"search.{method}"] = counts = read_counts()
        check(counts[f"cand_dist_valid.all_{mode}"] == 1
              and counts["cand_dist.rev_min"] + counts["cand_dist.ict"] == 0,
              f"full-corpus {method} did not launch K4's all-rows form "
              f"once: {nonzero(counts)}")
        secs, peak = search_seconds(lambda: index.search(q_ids, q_w))
        row = dict(seconds=secs, peak_gib=peak / 2**30)
        note = ""
        if method == "rwmd_rev":
            s_r = index.with_config(backend="reference").scores(q_ids, q_w)
            row["max_abs_err"] = err = (s_c - s_r).abs().max().item()
            check(torch.allclose(s_c, s_r, rtol=RTOL, atol=ATOL),
                  f"full-corpus rwmd_rev: cuda vs reference max |d| {err}")
            note = f"; cuda vs reference max|d|={err:.3g}"
        out[method] = row
        print(f"phase 8: full-corpus {method} search of {NQ} queries: cuda "
              f"{secs:.4f} s, peak above the resident "
              f"{peak / 2**30:.3f} GiB; launches {nonzero(counts)}{note}",
              flush=True)
    return out


def symmetric_search(host_corpus, q_ids, q_w, rows_sym, dev, runs):
    """Phase 8 (d): symmetric LC-RWMD search of the 16-query batch, cuda
    against reference; each row equal to the matching row of the
    20 Newsgroups all-pairs matrix (``rows_sym``)."""
    index = EmdIndex.build(host_corpus, EngineConfig(
        method="rwmd", symmetric=True, top_l=TOP_L), device=dev)
    ref = index.with_config(backend="reference")
    zero_counts()
    _, i_c = index.search(q_ids, q_w)
    torch.cuda.synchronize()
    runs["search.rwmd_symmetric"] = counts = read_counts()
    check(counts["dist_topk"] == 1
          and counts["cand_pour_rows.all_pour_iters0"] == 1
          and counts["cand_dist_valid.all_rev_min"] == 1,
          "symmetric rwmd did not launch K1, K3's all-rows dump and K4's "
          f"all-rows rev_min once each: {nonzero(counts)}")
    full_c = index.scores(q_ids, q_w)
    full_r, ref_secs, ref_peak = timed(lambda: ref.scores(q_ids, q_w))
    err = (full_c - full_r).abs().max().item()
    check(torch.allclose(full_c, full_r, rtol=RTOL, atol=ATOL),
          f"symmetric rwmd: cuda vs reference max |d| {err}")
    rows_err = (full_c - rows_sym).abs().max().item()
    check(torch.allclose(full_c, rows_sym, rtol=RTOL, atol=ATOL),
          f"symmetric rwmd: the search's rows are {rows_err} from the "
          "all-pairs matrix's")
    s_r, i_r = retrieval.top_l_smallest(full_r, TOP_L + 1)
    firm = firm_ranks(s_r[:, :TOP_L], s_r[:, TOP_L])
    check(bool((i_c == i_r[:, :TOP_L])[firm].all()),
          f"symmetric rwmd: top-{TOP_L} indices differ where the gap "
          "exceeds the tolerance")
    secs, peak = search_seconds(lambda: index.search(q_ids, q_w))
    print(f"phase 8: symmetric rwmd search of {NQ} queries: cuda "
          f"{secs:.4f} s, peak above the resident {peak / 2**30:.3f} GiB; "
          f"reference {ref_secs:.3f} s (one call, peak {ref_peak:.3f} GiB); "
          f"cuda vs reference max|d|={err:.3g}, vs the all-pairs rows "
          f"max|d|={rows_err:.3g}; top-{TOP_L} equal at {int(firm.sum())} "
          f"separated ranks of {firm.numel()}; launches {nonzero(counts)}",
          flush=True)
    return dict(seconds=secs, peak_gib=peak / 2**30, max_abs_err=err,
                rows_err=rows_err, reference_seconds=ref_secs)


def rev_all_pairs_prefix(name, host, prefix_mats, dev, runs):
    """Phase 8 (e): all-pairs of rwmd_rev and ict on a corpus's prefix, one
    all-rows K4 launch per chunk (on the MNIST-shaped corpus the chunk's
    valid bins outnumber 4v, so the valid-bin handoff takes its dedup
    branch). max(D, D^T) of rwmd_rev is that of rwmd (rwmd_rev(a, b) =
    rwmd(b, a)); ICT bounds ACT-7 from above (Theorem 2), so its matrix
    must not fall below act's."""
    index = EmdIndex.build(prefix_corpus(host, PREFIX),
                           EngineConfig(top_l=TOP_L), device=dev)
    live = (index.corpus.w > 0).sum(dim=1)
    chunks = -(-PREFIX // retrieval.ALL_PAIRS_QUERIES)
    first = live[:retrieval.ALL_PAIRS_QUERIES].sum().item()
    dedup = first >= lc.DEDUP_STACK_RATIO * index.corpus.v
    out = {}
    for method, mode, other in (("rwmd_rev", "rev_min", "rwmd"),
                                ("ict", "ict", "act")):
        ix = index.with_config(method=method)
        zero_counts()
        S, secs, peak = timed(ix.all_pairs)
        runs[f"all_pairs.{name}_prefix.{method}"] = counts = read_counts()
        got = counts[f"cand_dist_valid.all_{mode}"]
        check(got == chunks, f"all-pairs {method}: {got} all-rows K4 "
              f"launches, not one per chunk ({chunks})")
        ref = prefix_mats[other]
        tol = sum_band(ref, live)
        off = off_diagonal(S)
        if method == "rwmd_rev":
            # The diagonal too: the valid-bin handoff pins a word's
            # distance to itself to 0 (see eval_prefix).
            err = (S - ref).abs().max().item()
            check(bool(((S - ref).abs() <= tol).all()),
                  f"all-pairs rwmd_rev vs rwmd: max |d| {err}; "
                  f"{excess(S, ref, tol)}")
            check(bool((S.diagonal() == 0).all()),
                  f"{name} prefix all-pairs rwmd_rev: a row's distance to "
                  "itself is not exactly 0")
            note = (f"vs rwmd's matrix max|d|={err:.3g}; diagonal exactly "
                    "0")
        else:
            err = (ref - S)[off].max().item()
            check(bool((S >= ref - tol)[off].all()),
                  f"all-pairs ict falls below act-{ITERS} by {err}")
            note = (f"act-{ITERS}'s matrix minus it at most {err:.3g} off "
                    "the diagonal")
        check(torch.equal(S, S.T), f"all-pairs {method}: not symmetric")
        out[method] = dict(seconds=secs, peak_gib=peak, launches=got,
                           against=err, dedup=dedup)
        print(f"phase 8: {name} prefix n={PREFIX} all-pairs {method}: "
              f"{secs:.3f} s, peak {peak:.3f} GiB, {got} all-rows K4 "
              f"launches (one per chunk of {retrieval.ALL_PAIRS_QUERIES}; "
              f"the first chunk's {first} valid bins "
              f"{'take' if dedup else 'do not take'} the handoff's dedup "
              f"branch); {note}", flush=True)
        del S
    out["chunk"] = check_chunk_k4(name, index.corpus, PREFIX)
    return out


def check_chunk_k4(name, corpus, rows):
    """Phase 8 (e): K4's all-rows form, both modes, at one all-pairs chunk
    (the corpus's first ALL_PAIRS_QUERIES rows as queries, through the
    valid-bin handoff that the engines build for it, with its dedup branch
    where the chunk's valid bins reach DEDUP_STACK_RATIO v) against its
    plain version on the same inputs over the corpus's first ``rows`` rows,
    both ways, within the all-pairs band (:func:`sum_band`: RTOL / ATOL,
    or the float32 bound of two orders of a sum of 784 dense entries).
    Over the first K4_F64_ROWS rows both are also held, within that band,
    to the plain version's value in float64."""
    nq = retrieval.ALL_PAIRS_QUERIES
    valid = lc.phase1_valid_dist(corpus.coords, corpus.ids[:nq].contiguous(),
                                 corpus.w[:nq].contiguous())
    nbins = valid[0].shape[1]
    dedup = nbins >= lc.DEDUP_STACK_RATIO * corpus.v
    live = (corpus.w > 0).sum(dim=1)
    r64 = min(rows, K4_F64_ROWS)
    # The costs stay the float32 inputs; the weights in float64 carry the
    # plain version's arithmetic into float64.
    args64 = (corpus.ids[:r64], corpus.w[:r64].double(), None, valid[0],
              valid[1], valid[2].double())
    out = {}
    for mode, op, plain in (
            ("rev_min", ops.cand_rev_min_valid,
             cand_pour.cand_rev_min_valid_plain),
            ("ict", ops.cand_ict_valid, cand_pour.cand_ict_valid_plain)):
        got = op(corpus.ids[:rows], corpus.w[:rows], None, *valid)
        want = plain(corpus.ids[:rows], corpus.w[:rows], None, *valid)
        band = sum_band(want, live[:nq], live[:rows])
        exact = plain(*args64)
        band64 = band[:, :r64]
        row = dict(max_abs_err=(got - want).abs().max().item(),
                   band_share=((got - want).abs() / band).max().item(),
                   f64_err=(got[:, :r64] - exact).abs().max().item(),
                   plain_f64_err=(want[:, :r64] - exact).abs().max().item())
        out[mode] = row
        check(bool(((got - want).abs() <= band).all()),
              f"{name} chunk: cand_dist_valid.all_{mode} beyond the band of "
              f"its plain version: {excess(got, want, band)}")
        check(bool(((got[:, :r64] - exact).abs() <= band64).all()),
              f"{name} chunk: cand_dist_valid.all_{mode} beyond the band of "
              f"the float64 value: {excess(got[:, :r64], exact, band64)}")
        print(f"phase 8: {name} chunk nq={nq} ({nbins} valid query bins, "
              f"{'through' if dedup else 'not through'} the handoff's dedup "
              f"branch): K4's all-rows form {mode} over {rows} rows vs its "
              f"plain version max|d| {row['max_abs_err']:.3g} (at most "
              f"{row['band_share']:.3g} of the band); over {r64} rows vs the "
              f"float64 value "
              f"max|d| {row['f64_err']:.3g}, the plain version's "
              f"{row['plain_f64_err']:.3g}", flush=True)
    return out


def check_chunk_stacked_k4(name, corpus, rows):
    """Phase 8 (e): the stacked K4 (``csrc/cand_dist.cu``, mode ict, off
    the path since PR 16) at the chunk of :func:`check_chunk_k4`, each
    query against the corpus's first ``rows`` rows through the stacked
    (nq, v, h) handoff, against its plain version and the plain version's
    float64 value, within the all-pairs band that the valid-bin K4 is held
    to there. Its pour and sums run in float32."""
    nq = retrieval.ALL_PAIRS_QUERIES
    q_ids, q_w = corpus.ids[:nq].contiguous(), corpus.w[:nq].contiguous()
    dq = lc._rev_handoff(lc.phase1_stacked_dist(corpus.coords, q_ids, q_w))
    idsg = corpus.ids[:rows][None].expand(nq, -1, -1).contiguous()
    xg = corpus.w[:rows][None].expand(nq, -1, -1).contiguous()
    got = ops.cand_ict(idsg, xg, dq, q_w)
    want = cand_pour.cand_ict_plain(idsg, xg, dq, q_w)
    exact = cand_pour.cand_ict_plain(idsg, xg.double(), dq, q_w.double())
    live = (corpus.w > 0).sum(dim=1)
    band = sum_band(want, live[:nq], live[:rows])
    row = dict(max_abs_err=(got - want).abs().max().item(),
               band_share=((got - want).abs() / band).max().item(),
               f64_err=(got - exact).abs().max().item(),
               f64_band_share=((got - exact).abs() / band).max().item(),
               plain_f64_err=(want - exact).abs().max().item())
    check(bool(((got - want).abs() <= band).all()),
          f"{name} chunk: the stacked cand_dist.ict beyond the band of its "
          f"plain version: {excess(got, want, band)}")
    check(bool(((got - exact).abs() <= band).all()),
          f"{name} chunk: the stacked cand_dist.ict beyond the band of the "
          f"float64 value: {excess(got, exact.float(), band)}")
    print(f"phase 8: {name} chunk nq={nq}: the stacked K4 ict (float32 "
          f"pour) over {rows} rows vs its plain version max|d| "
          f"{row['max_abs_err']:.3g} ({row['band_share']:.3g} of the band), "
          f"vs the float64 value {row['f64_err']:.3g} "
          f"({row['f64_band_share']:.3g} of the band), the plain version's "
          f"{row['plain_f64_err']:.3g}", flush=True)
    del dq, idsg, xg
    return row


def phase8(host_corpus, labels, corpus, q_ids, q_w, rows, dev):
    """Phase 8, the paper's evaluation path. Returns its numbers, those of
    K4's all-rows form for the kernels line, and the launch counts of its
    runs."""
    t_start = time.perf_counter()
    runs = {}
    sparse, sparse_labels = make_image_like(MNIST.n_db, n_classes=N_CLASSES,
                                            side=SIDE, seed=SEED)
    dense, dense_labels = make_image_like(DENSE_N, n_classes=N_CLASSES,
                                          side=SIDE, include_background=True,
                                          seed=SEED)
    check(sparse.v == MNIST.vocab and sparse.m == MNIST.dim
          and dense.hmax == MNIST.hmax, "the MNIST-shaped corpora do not "
          "have configs/emd_mnist.py's shape")
    nbins = (sparse.w > 0).sum(dim=1).float()
    print(f"phase 8: set-up: MNIST-shaped corpora in "
          f"{time.perf_counter() - t_start:.1f} s: sparse n={sparse.n} "
          f"hmax={sparse.hmax} (valid bins per image: mean "
          f"{nbins.mean():.1f}), dense n={dense.n} hmax={dense.hmax} (cut "
          f"from {MNIST.n_db} rows for the time limit)", flush=True)
    corpora = {"20news": (host_corpus, labels),
               "mnist_sparse": (sparse, sparse_labels),
               "mnist_dense": (dense, dense_labels)}
    results = {}
    for name, (host, lab) in corpora.items():
        full, recall, kept = eval_corpus(
            name, host, lab, dev, runs,
            keep_rows=torch.as_tensor(rows, device=dev)
            if name == "20news" else None)
        if kept is not None:
            rows_sym = kept
        mats, prefix = eval_prefix(name, host, lab, dev)
        if name != "mnist_dense":
            results[f"rev_prefix.{name}"] = rev_all_pairs_prefix(
                name, host, mats, dev, runs)
        else:
            # No dense all-pairs of rwmd_rev / ict: each pair costs 784 x
            # 784 cost reads. K4's all-rows form is held at one chunk.
            chunk = prefix_corpus(host, retrieval.ALL_PAIRS_QUERIES).to(dev)
            results[f"rev_chunk.{name}"] = check_chunk_k4(name, chunk,
                                                         K4_F64_ROWS)
            results[f"stacked_ict_chunk.{name}"] = check_chunk_stacked_k4(
                name, chunk, K4_F64_ROWS)
            del chunk
        del mats
        results[name] = dict(full=full, recall=recall, prefix=prefix,
                             chunk=chunk_kernel_times(name, host, dev))
    # (c): the RWMD collapse on dense histograms.
    d = results["mnist_dense"]
    chance = chance_level(dense_labels)
    chance_pre = chance_level(dense_labels[:PREFIX])
    check(d["full"]["rwmd"]["zero_off_diagonal"]
          and all(d["prefix"]["rwmd"]["zero_off_diagonal"]),
          "dense LC-RWMD is not exactly 0 off the diagonal")
    for l in EVAL_L:
        p_full = d["full"]["rwmd"][f"p@{l}"]
        p_c = d["prefix"]["rwmd"][f"p@{l}"]
        p_r = d["prefix"]["rwmd"][f"ref_p@{l}"]
        check(abs(p_full - chance) <= CHANCE_TOL and p_c == p_r
              and abs(p_c - chance_pre) <= CHANCE_TOL,
              f"dense LC-RWMD p@{l} {p_full} / prefix {p_c}, {p_r} is not "
              f"at chance ({chance:.4f} / {chance_pre:.4f})")
        check(d["full"]["act"][f"p@{l}"] > p_full,
              f"dense LC-ACT-{ITERS} p@{l} does not beat LC-RWMD")
    print(f"phase 8: dense MNIST-shaped: LC-RWMD exactly 0 off the diagonal "
          f"on both backends, precision at chance ({chance:.4f}); "
          f"LC-ACT-{ITERS} " + " ".join(
              f"p@{l} {d['full']['act'][f'p@{l}']:.6f}" for l in EVAL_L),
          flush=True)
    results["symmetric"] = symmetric_search(host_corpus, q_ids, q_w,
                                            rows_sym, dev, runs)
    results["full_rev"] = full_corpus_rev(host_corpus, q_ids, q_w, dev, runs)
    k4 = check_all_rows_k4(corpus, q_ids, q_w)
    print(f"phase 8: done in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    return results, k4, runs


# --------------------------------------------------------------- phase 9


def parent_single_scores(corpus, q_ids, q_w, method, iters):
    """One query's scores by the parent tree's single-query route, the
    yardstick of phase 9 (a): K1 at nq=1, then the (n, hmax, k) ladders
    gathered at the corpus ids by plain indexing and poured by the unfused
    K2 (LC-ACT), dumped (LC-RWMD) or reduced (LC-OMR) in plain PyTorch."""
    Z, S = ops.dist_topk(corpus.coords, corpus.coords[q_ids], q_w > 0,
                         SINGLE_K[method], qids=q_ids)
    W = q_w[S.long()]
    Zg = Z[corpus.ids]                                   # (n, hmax, k)
    if method == "rwmd":
        return torch.sum(corpus.w * Zg[..., 0], dim=-1)
    if method == "omr":
        return lc.omr_entries(corpus.w, Zg, W[:, 0][corpus.ids])
    return ops.act_phase2(corpus.w, Zg, W[:, :iters][corpus.ids])


def act_route_scores(corpus, q_ids, q_w, iters, lens):
    """One LC-ACT query's scores by the single-query engine's kernel
    route, the fused K2 walking each row up to ``lens``: with
    ``act_phase2.row_lens`` the engine's own, with hmax everywhere the same
    kernel without its row stop (phase 9 (a)'s yardstick for it)."""
    Z, S = ops.dist_topk(corpus.coords, corpus.coords[q_ids], q_w > 0,
                         iters + 1, qids=q_ids)
    W = q_w[S.long()]
    return act_phase2.act_phase2_gather_cuda(corpus.w, corpus.ids, lens,
                                             Z[None], W[None])[0]


def paired_seconds(fns, rounds=ROUTE_PAIRS):
    """Host seconds of one call of each of ``fns`` and a synchronize,
    interleaved over ``rounds`` rounds after a warm-up, the order reversed
    every other round: (first quartile, median, third quartile) each."""
    secs = [[] for _ in fns]
    for f in fns:
        f()
    torch.cuda.synchronize()
    for r in range(rounds):
        for i in (range(len(fns)) if r % 2 == 0
                  else reversed(range(len(fns)))):
            t0 = time.perf_counter()
            fns[i]()
            torch.cuda.synchronize()
            secs[i].append(time.perf_counter() - t0)
    return [tuple(statistics.quantiles(t, n=4)) for t in secs]


def phase9_single(index, q_ids, q_w, runs):
    """Phase 9 (a): each method's 16 queries scored one at a time through
    ``EmdIndex.scores`` (the single-query engines) on the cuda backend,
    the counts set to 0 before and read after; held against the batched
    row and the reference backend's single queries; top-16 equal where the
    reference is separated; search seconds (one query, median of 3) and
    the peak above the resident, for act, rwmd and omr beside the parent's
    route (:func:`parent_single_scores`, which LC-ACT equals bitwise);
    symmetric LC-RWMD on one query."""
    gib = 2**30
    out, rows_of_method = {}, {}
    for method, iters in SINGLE_METHODS.items():
        ix = index.with_config(method=method, iters=iters)
        ref = ix.with_config(backend="reference")
        zero_counts()
        one, _, peak = timed(lambda: torch.stack(
            [ix.scores(q_ids[i], q_w[i]) for i in range(NQ)]))
        runs[f"single.{method}"] = counts = read_counts()
        want = {name: NQ for name in SINGLE_ROUTE.get(method, ())}
        if method in SINGLE_K:
            want["dist_topk"] = NQ
        check(nonzero(counts) == want,
              f"single {method}: launches {nonzero(counts)}, not "
              f"{nonzero(want)}")
        batch = ix.scores(q_ids, q_w)
        one_r = torch.stack([ref.scores(q_ids[i], q_w[i])
                             for i in range(NQ)])
        err_b = (one - batch).abs().max().item()
        err_r = (one - one_r).abs().max().item()
        check(torch.allclose(one, batch, rtol=RTOL, atol=ATOL),
              f"single {method}: vs the batched rows max |d| {err_b}")
        check(torch.allclose(one, one_r, rtol=RTOL, atol=ATOL),
              f"single {method}: cuda vs reference max |d| {err_r}")
        check(bool(torch.isfinite(one).all()) and one.max().item() < 1e3,
              f"single {method}: a score is not finite or reached the "
              "sentinel scale")
        s_r, i_r = retrieval.top_l_smallest(one_r, TOP_L + 1)
        firm = firm_ranks(s_r[:, :TOP_L], s_r[:, TOP_L])
        _, i_c = retrieval.top_l_smallest(one, TOP_L)
        check(bool((i_c == i_r[:, :TOP_L])[firm].all()),
              f"single {method}: top-{TOP_L} indices differ where the "
              "reference is separated")
        secs, search_peak = search_seconds(
            lambda: ix.search(q_ids[0], q_w[0]))
        ref_secs, _ = search_seconds(lambda: ref.search(q_ids[0], q_w[0]))
        out[method] = dict(search_seconds=secs, reference_seconds=ref_secs,
                           peak_gib=max(peak, search_peak / gib),
                           search_peak_gib=search_peak / gib,
                           batched_err=err_b, reference_err=err_r,
                           firm=int(firm.sum()), launches=nonzero(counts))
        parent = ""
        if method in SINGLE_ROUTE:
            old = torch.stack([parent_single_scores(
                index.corpus, q_ids[i], q_w[i], method, iters)
                for i in range(NQ)])
            err_p = (one - old).abs().max().item()
            check(torch.equal(one, old) if method == "act" else
                  torch.allclose(one, old, rtol=RTOL, atol=ATOL),
                  f"single {method}: vs the parent's route max |d| {err_p}")
            p_secs, p_peak = search_seconds(
                lambda: retrieval.top_l_smallest(parent_single_scores(
                    index.corpus, q_ids[0], q_w[0], method, iters), TOP_L))
            out[method].update(parent_seconds=p_secs,
                               parent_peak_gib=p_peak / gib,
                               parent_err=err_p)
            parent = (f"; the parent's route (the (n, hmax, k) gather"
                      f"{', the unfused K2' if method == 'act' else ''}) "
                      f"{p_secs:.5f} s, peak {p_peak / gib:.3f} GiB, vs it "
                      f"max|d|={err_p:.3g}"
                      f"{' (bitwise)' if err_p == 0 else ''}")
        if method == "act":
            check(search_peak / gib < 0.1, f"single act: one query's peak "
                  f"above the resident {search_peak / gib:.3f} GiB")
            c = index.corpus
            lens = act_phase2.row_lens(c.w)
            whole = torch.full_like(lens, c.w.shape[1])
            check(torch.equal(act_route_scores(c, q_ids[0], q_w[0], iters,
                                               lens), one[0]),
                  "single act: the kernel route is not bitwise the engine")
            stop, no_stop = paired_seconds([
                lambda lens=l: retrieval.top_l_smallest(act_route_scores(
                    c, q_ids[0], q_w[0], iters, lens), TOP_L)
                for l in (lens, whole)])
            out[method].update(route_seconds_quartiles=stop,
                               no_stop_seconds_quartiles=no_stop)
            parent += (f"; the kernel route ({ROUTE_PAIRS} interleaved "
                       f"rounds, quartiles) {stop[0]:.6f} / {stop[1]:.6f} / "
                       f"{stop[2]:.6f} s, without the fused K2's row stop "
                       f"{no_stop[0]:.6f} / {no_stop[1]:.6f} / "
                       f"{no_stop[2]:.6f} s")
        rows_of_method[method] = one
        print(f"phase 9: single {method}-{iters}: {NQ} queries one at a "
              f"time, vs the batched rows max|d|={err_b:.3g}, vs the "
              f"reference's single queries max|d|={err_r:.3g}; top-{TOP_L} "
              f"equal at {int(firm.sum())} separated ranks of "
              f"{firm.numel()}; search of one query cuda {secs:.5f} s, "
              f"peak above the resident {search_peak / gib:.4f} GiB, "
              f"reference {ref_secs:.4f} s (median of 3){parent}; the "
              f"{NQ} queries' peak {out[method]['peak_gib']:.3f} GiB; "
              f"launches {nonzero(counts)}", flush=True)
    sym = index.with_config(method="rwmd", symmetric=True)
    zero_counts()
    s1 = sym.scores(q_ids[0], q_w[0])
    runs["single.rwmd_symmetric"] = counts = read_counts()
    err = (s1 - sym.scores(q_ids, q_w)[0]).abs().max().item()
    check(torch.allclose(s1, sym.scores(q_ids, q_w)[0], rtol=RTOL,
                         atol=ATOL)
          and torch.equal(s1, torch.maximum(rows_of_method["rwmd"][0],
                                            rows_of_method["rwmd_rev"][0])),
          f"single symmetric rwmd: vs the batched row max |d| {err}, or not "
          "the max of the two directions")
    out["rwmd_symmetric"] = dict(batched_err=err, launches=nonzero(counts))
    print(f"phase 9: single symmetric rwmd: the max of both directions, vs "
          f"the batched symmetric row max|d|={err:.3g}; launches "
          f"{nonzero(counts)}", flush=True)
    return out


def phase9_kernels(corpus, q_ids, q_w):
    """Phase 9 (b): K1 at nq=1 (k = 1, 2, 8), the fused K2 at nq=1 (as the
    single-query engine launches it, and walking every row to hmax: no
    row stop) and the unfused K2 at nq=1 on the first query:
    against their plain versions and bitwise against each other, times,
    bounds and, for K1, the library yardstick (cdist + topk over the
    query's valid bins)."""
    coords, x, ids = corpus.coords, corpus.w, corpus.ids
    v, m = coords.shape
    qi, qw = q_ids[0], q_w[0]
    qc, qmask = coords[qi], qw > 0
    nv = int(qmask.sum())
    out = {}
    for k in (1, 2, ITERS + 1):
        err = check_dist_topk(coords, qc[None], qmask[None], k,
                              torch.float32, qi[None])
        ms = cuda_ms(lambda: ops.dist_topk(coords, qc, qmask, k), reps=20)
        plain = cuda_ms(lambda: dist_topk.dist_topk_plain(
            coords, qc[None], qmask[None], k, qids=qi[None]), reps=3)
        # The library on the valid bins, padded with masked ones to k.
        cols = torch.argsort((~qmask).int(), stable=True)[:max(nv, k)]
        qv, mv = qc[cols], qmask[cols]
        lib = cuda_ms(lambda: torch.cdist(coords, qv).masked_fill_(
            ~mv[None], 1e30).topk(k, dim=-1, largest=False), reps=5)
        nbytes = 4 * (coords.numel() + qc.numel()) + qmask.numel() \
            + 8 * v * k
        b_ms, b_by = bound_ms(nbytes, 2.0 * v * m * nv)
        out[f"dist_topk.nq1.k{k}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib)
        print(f"phase 9: K1 nq=1 k={k} ({nv} valid bins of query row "
              f"0 of the batch): {ms:.4f} ms, plain {plain:.3f}, library "
              f"(cdist + topk) {lib:.4f}, bound "
              f"{b_ms:.4f} by {b_by}", flush=True)
    Z, S = ops.dist_topk(coords, qc, qmask, ITERS + 1, qids=qi)
    W = qw[S.long()]
    Z1, W1 = Z[None], W[None]                    # the engine's (1, v, k)
    zg, wg = Z[ids], W[:, :ITERS][ids]
    lens = act_phase2.row_lens(x)
    whole = torch.full_like(lens, x.shape[1])    # no row stop
    t = ops.act_phase2(x, zg, wg)
    tf = ops.act_phase2_gather(x, ids, Z1, W1)[0]
    tw = act_phase2.act_phase2_gather_cuda(x, ids, whole, Z1, W1)[0]
    tp = act_phase2.act_phase2_plain(x, zg[None], wg[None])[0]
    tgp = act_phase2.act_phase2_gather_plain(x, ids, Z1, W1)[0]
    torch.cuda.synchronize()
    err = (t - tp).abs().max().item()
    err_g = (tf - tgp).abs().max().item()
    check(torch.equal(t, tf) and torch.equal(tw, tf),
          "K2 nq=1: the unfused K2, the fused K2 and the fused K2 walking "
          f"every row to hmax are not bitwise equal (max |d| "
          f"{(t - tf).abs().max().item()}, {(tw - tf).abs().max().item()})")
    check(torch.allclose(t, tp, rtol=RTOL, atol=ATOL)
          and torch.allclose(tf, tgp, rtol=RTOL, atol=ATOL),
          f"K2 nq=1: max |dt| {err}, fused {err_g} from the plain versions")
    ms = cuda_ms(lambda: ops.act_phase2(x, zg, wg), reps=20)
    ms_graph = graph_ms(lambda: act_phase2.act_phase2_cuda(x, zg[None],
                                                           wg[None]))
    plain = cuda_ms(lambda: act_phase2.act_phase2_plain(x, zg[None],
                                                        wg[None]), reps=3)
    live = x > 0
    nnz = int(live.sum())
    b_ms, b_by = bound_ms(4 * x.numel() + 4 * nnz * (2 * ITERS + 1)
                          + 4 * corpus.n, 5.0 * nnz * (ITERS + 1))
    out["act_phase2.nq1"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                 bound_ms=b_ms, bound_by=b_by,
                                 library_ms=None, ms_graph=ms_graph)
    print(f"phase 9: K2 nq=1 iters={ITERS} on the gathered ladders: bitwise "
          f"the fused K2 at nq=1, max|dt| vs plain {err:.3g}; {ms:.4f} ms "
          f"(device {ms_graph:.4f}), plain {plain:.3f}, bound {b_ms:.4f} by "
          f"{b_by}", flush=True)
    # The fused K2 at nq=1, by the fused row's rule: x up to each row's
    # length and the lengths, the ids of the live entries, the ladder rows
    # of each distinct id once; t written.
    slots = int(lens.sum())
    n_ids = int(torch.unique(ids[live]).numel())
    g_bytes = 4 * slots + 4 * corpus.n + 4 * nnz \
        + n_ids * (2 * ITERS + 1) * Z.element_size() + 4 * corpus.n
    gb_ms, gb_by = bound_ms(g_bytes, 5.0 * nnz * (ITERS + 1))
    # "ms": one launch through the wrapper between two events, its host
    # time (the checks, the cached row lengths) included; "ms_graph": a
    # launch of the bare kernel in a CUDA graph of 20, the device alone.
    g_ms = cuda_ms(lambda: ops.act_phase2_gather(x, ids, Z1, W1), reps=20)
    g_graph = graph_ms(lambda: act_phase2.act_phase2_gather_cuda(
        x, ids, lens, Z1, W1))
    w_graph = graph_ms(lambda: act_phase2.act_phase2_gather_cuda(
        x, ids, whole, Z1, W1))
    g_plain = cuda_ms(lambda: act_phase2.act_phase2_gather_plain(
        x, ids, Z1, W1), reps=3)
    lens_ms = graph_ms(lambda: act_phase2.row_lens(x))
    attrs = act_phase2.gather_attrs(ITERS + 1, ITERS + 1)
    out["act_phase2_gather.nq1"] = dict(
        max_abs_err=err_g, ms=g_ms, plain_ms=g_plain, bound_ms=gb_ms,
        bound_by=gb_by, library_ms=None, ms_graph=g_graph,
        whole_rows_ms_graph=w_graph, row_lens_ms_graph=lens_ms,
        slots_read=slots, registers=attrs["regs"],
        spill_bytes=attrs["local_bytes"])
    print(f"phase 9: K2 fused nq=1 iters={ITERS}: {g_ms:.4f} ms through the "
          f"wrapper, {g_graph:.4f} on the device (every row walked to hmax, "
          f"no row stop: {w_graph:.4f}), bitwise each other and the unfused "
          f"K2, max|dt| vs plain {err_g:.3g}; plain {g_plain:.3f}, bound "
          f"{gb_ms:.4f} by {gb_by} ({g_bytes / 1e6:.1f} MB: x to the rows' "
          f"lengths, {slots} of {x.numel()} slots, {nnz} live; "
          f"{n_ids} distinct ids); the rows' lengths, once per corpus, "
          f"{lens_ms:.4f} ms on the device; {attrs['regs']} registers, "
          f"{attrs['local_bytes']} B spilled", flush=True)
    return out


def phase9_scan(host_corpus, corpus, q_ids, q_w, dev, runs):
    """Phase 9 (c): the scan engine, bitwise a loop of query_scores and
    within tolerance of the batched engine on the 16 queries; all-pairs
    LC-ACT-7 through it on the PREFIX-row prefix against the batched
    matrix within the all-pairs band."""
    kw = dict(method="act", iters=ITERS, use_kernels=True)
    zero_counts()
    scan = retrieval.batch_scores(corpus, q_ids, q_w, engine="scan", **kw)
    runs["scan.act"] = counts = read_counts()
    check(nonzero(counts) == {"dist_topk": NQ, "act_phase2_gather": NQ},
          f"scan engine: launches {nonzero(counts)}")
    loop = torch.stack([retrieval.query_scores(corpus, q_ids[i], q_w[i],
                                               **kw) for i in range(NQ)])
    batched = retrieval.batch_scores(corpus, q_ids, q_w, **kw)
    err = (scan - batched).abs().max().item()
    check(torch.equal(scan, loop), "scan engine: not bitwise the loop of "
          "query_scores")
    check(torch.allclose(scan, batched, rtol=RTOL, atol=ATOL),
          f"scan engine: vs the batched engine max |d| {err}")
    index = EmdIndex.build(prefix_corpus(host_corpus, PREFIX),
                           EngineConfig(method="act", iters=ITERS),
                           device=dev)
    live = (index.corpus.w > 0).sum(dim=1)
    S_b, secs_b, _ = timed(index.all_pairs)
    zero_counts()
    S_s, secs_s, peak = timed(index.with_config(
        batch_engine="scan").all_pairs)
    runs["all_pairs.scan_prefix.act"] = ap_counts = read_counts()
    ap_err = (S_s - S_b).abs().max().item()
    band = sum_band(S_b, live)
    check(bool(((S_s - S_b).abs() <= band).all()),
          f"all-pairs scan vs batched: {excess(S_s, S_b, band)}")
    print(f"phase 9: scan engine act-{ITERS}, {NQ} queries: bitwise the "
          f"loop of query_scores, vs batched max|d|={err:.3g}; launches "
          f"{nonzero(counts)}; all-pairs prefix n={PREFIX} scan "
          f"{secs_s:.3f} s (batched {secs_b:.3f} s), vs the batched matrix "
          f"max|d|={ap_err:.3g}, peak {peak:.3f} GiB; launches "
          f"{nonzero(ap_counts)}", flush=True)
    return dict(batched_err=err, all_pairs_err=ap_err,
                all_pairs_seconds=secs_s, batched_all_pairs_seconds=secs_b)


def omr_overlap_flips(corpus, q_ids, q_w):
    """(nq, n): rows with a live slot whose nearest cost is exactly 0 under
    the plain f32 Phase 1 and not under bf16_agg's, or the other way round:
    LC-OMR's overlap test (float32 pins a word's distance to itself to 0,
    bf16_agg's bfloat16 operands leave a residue there)."""
    zero = [lc.phase1_batched(corpus.coords, q_ids, q_w, 2, precision=p)[0]
            [..., 0] == 0 for p in ("f32", "bf16_agg")]
    flip = (zero[0] != zero[1])[:, corpus.ids]          # (nq, n, hmax)
    return (flip & (corpus.w > 0)).any(dim=-1)


def phase9_agg(index, corpus, q_ids, q_w, runs):
    """Phase 9 (d): bf16_agg searches (act-7, rwmd, omr, chain, tight) on
    both backends against the f32 ones: scores within AGG_ATOL (plain
    LC-OMR: beyond it only where the overlap test flips), the top-16
    overlap, times and the peak above the resident; and K1 on bfloat16
    coordinates against its plain version on the batch."""
    gib = 2**30
    out = {}
    for name in AGG_SEARCHES:
        cascade = name in CASCADES
        cfg = ({} if cascade else
               dict(method=name, iters=ITERS if name == "act" else 0))
        for backend in ("cuda", "reference"):
            f32 = index.with_config(backend=backend, **cfg)
            agg = f32.with_config(precision="bf16_agg")
            kw = dict(cascade=name) if cascade else {}
            zero_counts()
            s_a, i_a = agg.search(q_ids, q_w, **kw)
            torch.cuda.synchronize()
            counts = read_counts()
            if backend == "cuda":
                runs[f"bf16_agg.{name}"] = counts
                check(counts["dist_topk"] > 0, f"bf16_agg {name}: K1 was "
                      "not launched")
            s_f, i_f = f32.search(q_ids, q_w, **kw)
            if cascade:
                got, want = s_a, s_f
            else:
                got, want = agg.scores(q_ids, q_w), f32.scores(q_ids, q_w)
            beyond = (got - want).abs() > AGG_ATOL
            if name == "omr" and backend == "reference":
                beyond &= ~omr_overlap_flips(corpus, q_ids, q_w)
            err = (got - want).abs().max().item()
            check(not bool(beyond.any()), f"bf16_agg {name} {backend}: "
                  f"max |d| {err} from f32 beyond {AGG_ATOL}")
            overlap = retrieval.topl_overlap(i_a, i_f)
            secs, peak = search_seconds(lambda: agg.search(q_ids, q_w, **kw))
            out[f"{name}.{backend}"] = dict(
                max_abs_err=err, topl_overlap=overlap, seconds=secs,
                peak_gib=peak / gib, launches=nonzero(counts))
            print(f"phase 9: bf16_agg {name} {backend}: vs f32 max|d|="
                  f"{err:.3g}, top-{TOP_L} overlap {overlap:.4f}; search "
                  f"{secs:.4f} s, peak above the resident {peak / gib:.3f} "
                  f"GiB; launches {nonzero(counts)}", flush=True)
    cb = corpus.coords.to(torch.bfloat16)
    qcs, qmask = cb[q_ids], q_w > 0
    err = max(check_dist_topk(cb, qcs, qmask, k, dtype, q_ids)
              for k in (ITERS + 1, 2, 1)
              for dtype in (torch.float32, torch.bfloat16))
    k = ITERS + 1
    ms = cuda_ms(lambda: ops.dist_topk_batched(cb, qcs, qmask, k))
    plain = cuda_ms(lambda: dist_topk.dist_topk_plain(cb, qcs, qmask, k,
                                                      qids=q_ids), reps=3)
    nv = int(qmask.sum())
    b_ms, b_by = bound_ms(2 * (cb.numel() + qcs.numel()) + qmask.numel()
                          + 8 * NQ * corpus.v * k,
                          2.0 * corpus.v * corpus.m * nv)
    out["dist_topk.bf16_coords"] = dict(max_abs_err=err, ms=ms,
                                        plain_ms=plain, bound_ms=b_ms,
                                        bound_by=b_by, library_ms=None)
    print(f"phase 9: K1 on bfloat16 coordinates k={k}, the batch: {ms:.4f} "
          f"ms, plain {plain:.3f}, bound {b_ms:.4f} by {b_by}", flush=True)
    return out


def phase9_zeros(host_corpus, dev):
    """Phase 9 (e): the PREFIX-row prefix's diagonal for rwmd and rwmd_rev
    on both backends, a row's distance to itself, through the candidate
    engines with each row as its own candidate (phase 8 holds the
    all-pairs matrices' diagonals): exactly 0."""
    pre = prefix_corpus(host_corpus, PREFIX).to(dev)
    out = {}
    for backend, use_kernels in (("cuda", True), ("reference", False)):
        chunk = retrieval.all_pairs_chunk(pre, use_kernels)
        for method in ("rwmd", "rwmd_rev"):
            d = torch.cat([retrieval.cand_scores(
                pre, pre.ids[s:s + chunk], pre.w[s:s + chunk],
                torch.arange(s, min(s + chunk, PREFIX), device=dev)[:, None],
                method=method, use_kernels=use_kernels)[:, 0]
                for s in range(0, PREFIX, chunk)])
            nz = int((d != 0).sum())
            check(nz == 0, f"prefix {method} {backend}: {nz} rows at a "
                  f"non-zero distance to themselves (max {d.max().item()})")
            out[f"{method}.{backend}"] = nz
    print(f"phase 9: the {PREFIX}-row prefix: every row's rwmd and rwmd_rev "
          "distance to itself exactly 0 on both backends", flush=True)
    return out


def phase9_oracles(corpus, q_ids, q_w, rows, runs):
    """Phase 9 (f): the ORACLE_QUERIES queries with the fewest valid bins
    (the exact LP's size grows with the product of the two lengths) and
    their act-7 top ORACLE_TOP rows: per pair rwmd_dir <= omr_dir <=
    act_dir(7) <= ict_dir <= emd_exact, each within ORACLE_RTOL, and each
    relaxation equal to the single-query engine's score of the pair; then
    wmd_search for WMD_QUERIES of them at top_l=WMD_TOP, whose exact
    distances must not fall below the act-7 bound."""
    n_valid = (q_w > 0).sum(dim=1)
    picks = torch.argsort(n_valid, stable=True)[:ORACLE_QUERIES].tolist()
    fns = (("rwmd", relaxations.rwmd_dir, {}),
           ("omr", relaxations.omr_dir, {}),
           ("act", relaxations.act_dir, {"iters": ITERS}),
           ("ict", relaxations.ict_dir, {}))
    pairs, worst, lp_secs = 0, 0.0, 0.0             # worst: max |d|
    act_rows = {}
    for qn in picks:
        qi, qw = q_ids[qn], q_w[qn]
        eng = {"rwmd": lc.lc_rwmd_scores(corpus, qi, qw, use_kernels=True),
               "omr": lc.lc_omr_scores(corpus, qi, qw, use_kernels=True),
               "act": lc.lc_act_scores(corpus, qi, qw, ITERS,
                                       use_kernels=True),
               "ict": lc.lc_ict_scores(corpus, qi, qw)}
        act_rows[qn] = eng["act"]
        top = retrieval.top_l_smallest(eng["act"], ORACLE_TOP)[1].tolist()
        for u in top:
            p, q, C = histogram.pair_from_corpus(corpus, u, int(rows[qn]))
            kp, kq = p > 0, q > 0
            p, q, C = p[kp], q[kq], C[kp][:, kq]
            vals = [float(fn(p, q, C, **kw)) for _, fn, kw in fns]
            t0 = time.perf_counter()
            vals.append(emd_exact(p.cpu(), q.cpu(), C.cpu()))
            lp_secs += time.perf_counter() - t0
            for lo, hi in zip(vals, vals[1:]):
                check(lo <= hi * (1 + ORACLE_RTOL) + ATOL,
                      f"oracles query {qn} row {u}: the chain breaks, "
                      f"{vals}")
            for (name, _, _), val in zip(fns, vals):
                e = float(eng[name][u])
                worst = max(worst, abs(val - e))
                check(abs(val - e) <= ORACLE_RTOL * abs(e) + ATOL,
                      f"oracles query {qn} row {u}: {name}_dir {val} vs the "
                      f"engine's {e}")
            pairs += 1
    wmd_out = []
    zero_counts()
    for qn in picks[:WMD_QUERIES]:
        t0 = time.perf_counter()
        d, i = wmd.wmd_search(corpus, int(rows[qn]), WMD_TOP)
        secs = time.perf_counter() - t0
        bound = act_rows[qn][torch.as_tensor(i, device=corpus.device)]
        check(bool((torch.as_tensor(d, device=corpus.device,
                                    dtype=torch.float32)
                    >= bound * (1 - ORACLE_RTOL) - ATOL).all()),
              f"wmd_search query {qn}: an exact distance below its act-"
              f"{ITERS} bound")
        wmd_out.append(dict(query=int(rows[qn]), seconds=secs,
                            ids=i.tolist(), exact=d.tolist()))
        print(f"phase 9: wmd_search of row {int(rows[qn])} top-{WMD_TOP}: "
              f"{secs:.3f} s, rows {i.tolist()}, exact {np.round(d, 6)}",
              flush=True)
    runs["wmd"] = read_counts()
    print(f"phase 9: oracles on {pairs} pairs ({ORACLE_QUERIES} queries with "
          f"{n_valid[picks].tolist()} valid bins, their act-{ITERS} top "
          f"{ORACLE_TOP}): rwmd <= omr <= act-{ITERS} <= ict <= emd each "
          f"within {ORACLE_RTOL}; each relaxation vs the engine's score "
          f"max|d|={worst:.3g}; the {pairs} LPs {lp_secs:.2f} s",
          flush=True)
    return dict(pairs=pairs, max_abs_err=worst, lp_seconds=lp_secs,
                wmd=wmd_out)


def phase9(host_corpus, corpus, q_ids, q_w, rows, dev):
    """Phase 9: the single-query engines, the scan engine, bf16_agg, the
    exact zeros and the oracles. Returns its numbers, those of the kernels
    it times and the launch counts of its runs."""
    t_start = time.perf_counter()
    runs = {}
    index = EmdIndex.build(corpus, EngineConfig(top_l=TOP_L), device=dev)
    results = {}
    results["single"] = phase9_single(index, q_ids, q_w, runs)
    kernels = phase9_kernels(corpus, q_ids, q_w)
    results["scan"] = phase9_scan(host_corpus, corpus, q_ids, q_w, dev, runs)
    agg = phase9_agg(index, corpus, q_ids, q_w, runs)
    kernels["dist_topk.bf16_coords"] = agg.pop("dist_topk.bf16_coords")
    results["bf16_agg"] = agg
    results["zeros"] = phase9_zeros(host_corpus, dev)
    results["oracles"] = phase9_oracles(corpus, q_ids, q_w, rows, runs)
    results["seconds"] = time.perf_counter() - t_start
    print(f"phase 9: done in {results['seconds']:.1f} s", flush=True)
    return results, kernels, runs


# -------------------------------------------------------------- phase 10


def sourced_build(host_corpus, spec, dev):
    """An index whose cascade ``spec`` is sourced, built on the card: host
    seconds of the build (the source's fit on the host and the placement),
    the host's peak numpy allocation during it (tracemalloc) and the
    process's peak RSS after it."""
    tracemalloc.start()
    t0 = time.perf_counter()
    index = EmdIndex.build(host_corpus, EngineConfig(
        cascade=spec, top_l=TOP_L, block_q=BLOCK_Q), device=dev)
    secs = time.perf_counter() - t0
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return index, dict(build_s=secs, host_peak_gib=peak / 2**30,
                       max_rss_gib=rss / 2**30)


def phase10_sourced(host_corpus, corpus, q_ids, q_w, rows, dev, runs):
    """Phase 10 (a): the sourced cascades on both backends, the counts set
    to 0 before each cuda search and read after."""
    gib = 2**30
    out, indexes = {}, {}
    cuda_index = EmdIndex.build(host_corpus, EngineConfig(
        top_l=TOP_L, block_q=BLOCK_Q), device=dev)
    _, ref_scan = cuda_index.search(q_ids, q_w, cascade=FULL_SCAN_SPEC)
    _, ref_chain = cuda_index.search(q_ids, q_w, cascade="chain")
    for name, spec in SOURCED.items():
        if spec.source in indexes:         # the same spec: reuse its fit
            index = indexes[spec.source].with_config(cascade=spec)
            build = dict(build_s=0.0, reused=True)
        else:
            index, build = sourced_build(host_corpus, spec, dev)
            indexes[spec.source] = index
        ref = index.with_config(backend="reference")
        src = index.source
        check(ref.source.leaves()[0] is src.leaves()[0],
              f"sourced {name}: the reference index refit the source")
        cand_c = src.candidates(index.corpus, q_ids, q_w)
        cand_r = ref.source.candidates(ref.corpus, q_ids, q_w)
        check(all(torch.equal(a, b) for a, b in zip(cand_c, cand_r)),
              f"sourced {name}: the source's (ids, mask) differ between "
              "the backends")
        live = cand_c[1].sum(dim=1)
        step_ms = cuda_ms(lambda: src.candidates(index.corpus, q_ids, q_w))
        zero_counts()
        s_c, i_c = index.search(q_ids, q_w)
        torch.cuda.synchronize()
        runs[f"sourced.{name}"] = counts = read_counts()
        want = ["dist_topk", "cand_pour_rows.pour_iters0",
                "cand_pour_rows.pour"] + (["cand_dist_valid.ict"]
                                          if spec.rescorer == "ict" else [])
        check(all(counts[k] > 0 for k in want)
              and sum(rows_of(counts).values()) == sum(
                  counts[f"cand_pour_rows.{k}"] for k in
                  ("pour", "pour_iters0")),
              f"sourced {name}: launches {nonzero(counts)}, wanted {want}")
        zero_counts()
        s_r, i_r = ref.search(q_ids, q_w, top_l=TOP_L + 1)
        torch.cuda.synchronize()
        check(not nonzero(read_counts()),
              f"sourced {name}: the reference backend launched "
              f"{nonzero(read_counts())}")
        next_r, s_r, i_r = s_r[:, TOP_L], s_r[:, :TOP_L], i_r[:, :TOP_L]
        err = (s_c - s_r).abs().max().item()
        check(torch.allclose(s_c, s_r, rtol=RTOL, atol=ATOL),
              f"sourced {name}: cuda vs reference max |d| {err}")
        check(bool(torch.isfinite(s_c).all()) and s_c.max().item() < 1e3,
              f"sourced {name}: a score reached the sentinel scale")
        firm = firm_ranks(s_r, next_r)
        check(bool((i_c == i_r)[firm].all()),
              f"sourced {name}: top-{TOP_L} indices differ where the "
              "reference is separated")
        rec_scan = topk_recall(i_c, ref_scan)
        rec_chain = topk_recall(i_c, ref_chain)
        t_c, m_c = search_seconds(lambda: index.search(q_ids, q_w))
        t_r, m_r = search_seconds(lambda: ref.search(q_ids, q_w))
        stage = stage_rows(spec, corpus.n, TOP_L)
        out[name] = dict(
            spec=spec.describe(), **build, width=src.width,
            dropped_rows=src.dropped_rows, live_min=int(live.min()),
            stage_rows=stage, candidate_step_ms=step_ms, search_s=dict(
                cuda=t_c, reference=t_r), peak_gib=dict(
                cuda=m_c / gib, reference=m_r / gib),
            recall_vs_full_scan=rec_scan, recall_vs_chain=rec_chain,
            max_abs_err=err, firm=int(firm.sum()),
            launches=nonzero(counts))
        print(f"phase 10: sourced {spec.describe()}: build "
              f"{build['build_s']:.2f} s"
              + ("" if build.get("reused") else
                 f" (host peak {build['host_peak_gib']:.3f} GiB numpy, "
                 f"max RSS {build['max_rss_gib']:.2f} GiB)")
              + f"; width {src.width}, dropped rows {src.dropped_rows}, "
              f"live candidates per query >= {int(live.min())}; stage rows "
              f"{stage}; candidate step {step_ms:.4f} ms; search cuda "
              f"{t_c:.4f} s, reference {t_r:.4f} s; peak above the "
              f"resident cuda {m_c / gib:.3f} GiB, reference "
              f"{m_r / gib:.3f} GiB; cuda vs reference max|d|={err:.3g}, "
              f"top-{TOP_L} equal at {int(firm.sum())} separated ranks of "
              f"{firm.numel()}; recall@{TOP_L} vs {FULL_SCAN_SPEC.describe()} "
              f"{rec_scan}, vs chain {rec_chain}; launches {nonzero(counts)}",
              flush=True)
    # A full_scan-sourced chain is the unsourced chain, bitwise.
    chain = resolve_spec("chain")
    full = dataclasses.replace(chain, source="full_scan")
    a = cuda_index.search(q_ids, q_w, cascade=chain)
    b = cuda_index.search(q_ids, q_w, cascade=full)
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
          "a full_scan-sourced chain is not bitwise the unsourced chain")
    print("phase 10: a full_scan-sourced chain is bitwise the unsourced "
          "chain on cuda", flush=True)
    return out, indexes[SOURCED["lsh"].source]


def serve_policy():
    """bench_serve's policy (``benchmarks/bench_serve.py:54-56``)."""
    return ServingPolicy(ladder=("primary", "fast", "wcd"), max_batch=16,
                         flush_ms=2.0, deadline_ms=500.0, max_retries=1,
                         backoff_ms=0.5)


async def open_loop(server, host_ids, host_w, req_rows, qps, seed):
    """Seeded open-loop arrivals at ``qps``: each request is sent at its
    arrival time whatever the server does, and its latency runs from that
    time. Returns the results (ServeResult or ServerOverloaded) and the
    latencies in ms."""
    gaps = np.random.default_rng(seed).exponential(1.0 / qps, len(req_rows))
    at = np.cumsum(gaps)
    lat = np.zeros(len(req_rows))
    t0 = time.perf_counter()

    async def one(k):
        await asyncio.sleep(max(0.0, t0 + at[k] - time.perf_counter()))
        row = int(req_rows[k])
        try:
            res = await server.search(host_ids[row], host_w[row])
        except ServerOverloaded as e:
            res = e
        lat[k] = 1e3 * (time.perf_counter() - t0 - at[k])
        return res

    results = await asyncio.gather(*[one(k) for k in range(len(req_rows))])
    return results, lat


def gc_timer(pauses):
    """A ``gc.callbacks`` entry appending each collection's pause in ms to
    ``pauses``."""
    start = []

    def callback(phase, info):
        if phase == "start":
            start.append(time.perf_counter())
        elif start:
            pauses.append(1e3 * (time.perf_counter() - start.pop()))
    return callback


def batched_rows(index, host_ids, host_w, rows):
    """Each row's top-l from a batched ``index.search`` of the rows, 16 a
    batch: {row: (scores, indices)} as numpy."""
    out = {}
    for s in range(0, len(rows), NQ):
        chunk = rows[s:s + NQ]
        sc, ix = index.search(host_ids[chunk], host_w[chunk])
        for r, a, b in zip(chunk, sc.cpu().numpy(), ix.cpu().numpy()):
            out[int(r)] = (a, b)
    return out


def phase10_serve(host_corpus, dev, runs):
    """Phase 10 (b): EmdServer over act-7 on the card under open-loop
    traffic at each load of SERVE_LOADS, no hook; every primary answer
    bitwise the batched search's row and within tolerance of the one-query
    search."""
    index = EmdIndex.build(host_corpus, EngineConfig(
        method="act", iters=ITERS, top_l=TOP_L, block_q=BLOCK_Q), device=dev)
    host_ids, host_w = host_corpus.ids.numpy(), host_corpus.w.numpy()
    req_rows = np.random.default_rng(SEED + 10).integers(0, N_DOCS,
                                                         SERVE_REQUESTS)
    uniq = np.unique(req_rows)
    batched = batched_rows(index, host_ids, host_w, uniq)
    single = {int(r): tuple(t.cpu().numpy() for t in index.search(
        host_ids[r], host_w[r])) for r in uniq}
    for b in (1, 2, 4, 8, 16):              # every bucket's shape, once
        index.search(host_ids[:b], host_w[:b])
    out = {}
    for qps in SERVE_LOADS:
        server = EmdServer(index, serve_policy())

        async def go():
            async with server:
                return await open_loop(server, host_ids, host_w, req_rows,
                                       qps, SEED + int(qps))
        # The earlier phases' garbage is collected before the load, and the
        # collector's pauses during it are recorded: they stall the event
        # loop like a launch does.
        gc.collect()
        pauses = []
        gc.callbacks.append(gc_timer(pauses))
        zero_counts()
        try:
            results, lat = asyncio.run(go())
        finally:
            gc.callbacks.pop()
        torch.cuda.synchronize()
        runs[f"serve.{int(qps)}"] = counts = read_counts()
        st = server.stats
        check(st.launch_failures == 0 and st.device_faults == 0,
              f"serve {qps}/s: {st.launch_failures} launch failures without "
              "a hook")
        check(counts["dist_topk"] > 0 and counts["act_phase2_gather"] > 0,
              f"serve {qps}/s: launches {nonzero(counts)}")
        served = [r for r in results if isinstance(r, ServeResult)]
        bitwise_single = 0
        for row, res in zip(req_rows, results):
            if not isinstance(res, ServeResult):
                continue
            check(res.tier == "primary" or res.degraded,
                  f"serve {qps}/s: an unlabelled {res.tier} answer")
            if res.tier != "primary":
                continue
            b_s, b_i = batched[int(row)]
            check(np.array_equal(res.scores, b_s)
                  and np.array_equal(res.indices, b_i),
                  f"serve {qps}/s: row {row}'s answer is not bitwise the "
                  "batched search's row")
            s_s, s_i = single[int(row)]
            check(np.allclose(res.scores, s_s, rtol=RTOL, atol=ATOL),
                  f"serve {qps}/s: row {row} beyond tolerance of its one-"
                  f"query search (max |d| {np.abs(res.scores - s_s).max()})")
            bitwise_single += int(np.array_equal(res.scores, s_s)
                                  and np.array_equal(res.indices, s_i))
        mix = {}
        for r in served:
            mix[r.tier] = mix.get(r.tier, 0) + 1
        n_primary = mix.get("primary", 0)
        # In the server: enqueue to answer. Before it: the event loop was
        # busy (a launch, a collection) when the request was due.
        in_server = np.array([r.latency_ms for r in results
                              if isinstance(r, ServeResult)])
        late = lat[[isinstance(r, ServeResult) for r in results]] - in_server
        out[f"{int(qps)}"] = dict(
            p50_ms=float(np.percentile(lat, 50)),
            p99_ms=float(np.percentile(lat, 99)), launches=st.launches,
            flushes=st.flushes, buckets=dict(sorted(
                st.bucket_launches.items())), tier_mix=mix, shed=st.shed,
            primary_bitwise_batched=n_primary,
            primary_bitwise_single=bitwise_single,
            in_server_p99_ms=float(np.percentile(in_server, 99)),
            enqueue_delay_max_ms=float(late.max()),
            gc_pauses=len(pauses), gc_max_ms=max(pauses, default=0.0),
            kernel_launches=nonzero(counts))
        print(f"phase 10: serve {SERVE_REQUESTS} requests open-loop at "
              f"{qps:g}/s: latency p50 {np.percentile(lat, 50):.3f} ms, "
              f"p99 {np.percentile(lat, 99):.3f} ms (in the server: p99 "
              f"{np.percentile(in_server, 99):.3f} ms; enqueued late by up "
              f"to {late.max():.3f} ms); launches {st.launches}, "
              f"flushes {st.flushes}, buckets "
              f"{dict(sorted(st.bucket_launches.items()))}, tiers {mix}, "
              f"shed {st.shed}; {len(pauses)} garbage-collector pauses, the "
              f"longest {max(pauses, default=0.0):.3f} ms; the {n_primary} "
              "primary answers bitwise the "
              f"batched search's rows, {bitwise_single} of them bitwise "
              f"the one-query search too (all within rtol {RTOL} atol "
              f"{ATOL}); kernel launches {nonzero(counts)}", flush=True)
    return out, index


class LaunchRecorder:
    """A launch hook around another (the chaos injector): records each
    launch that returns, with its tier, padded batch and result."""

    def __init__(self, inner):
        self.inner, self.launches = inner, []

    def __call__(self, launch_fn, tier, q_ids, q_w):
        out = self.inner(launch_fn, tier, q_ids, q_w)
        self.launches.append((tier.name, q_ids.copy(), q_w.copy(), out))
        return out


def phase10_chaos(index, host_corpus, runs):
    """Phase 10 (c): the seeded schedule replayed twice on the same
    deterministic traffic (groups of CHAOS_GROUP concurrent requests, one
    group at a time): the same tiers and the same bits; every launch's
    rows bitwise its tier's own index on the same padded batch."""
    host_ids, host_w = host_corpus.ids.numpy(), host_corpus.w.numpy()
    req_rows = np.random.default_rng(SEED + 10).integers(0, N_DOCS,
                                                         SERVE_REQUESTS)
    schedule = ChaosSchedule.from_seed(0, horizon=512, p_fail=0.1)
    replays = []
    for rep in range(2):
        chaos = ChaosInjector(schedule)
        hook = LaunchRecorder(chaos)
        server = EmdServer(index, serve_policy(), launch_hook=hook)

        async def go():
            async with server:
                res = []
                for s in range(0, len(req_rows), CHAOS_GROUP):
                    res += await asyncio.gather(*[
                        server.search(host_ids[r], host_w[r])
                        for r in req_rows[s:s + CHAOS_GROUP]],
                        return_exceptions=True)
                return res
        zero_counts()
        results = asyncio.run(go())
        torch.cuda.synchronize()
        runs[f"chaos.{rep}"] = counts = read_counts()
        replays.append((results, chaos.log, hook.launches, server))
    (res_a, log_a, launches, server), (res_b, log_b, _, _) = replays
    check(log_a == log_b, "chaos: the two replays' attempt logs differ")
    tiers = []
    for a, b in zip(res_a, res_b):
        check(type(a) is type(b), "chaos: a request served once, shed once")
        if isinstance(a, ServeResult):
            check(a.tier == b.tier and np.array_equal(a.scores, b.scores)
                  and np.array_equal(a.indices, b.indices),
                  "chaos: the two replays answered a request differently")
            tiers.append(a.tier)
        else:
            check(isinstance(a, ServerOverloaded), f"chaos: {a!r}")
            tiers.append("SHED")
    own = {b.tier.name: b.index for b in server._gen.tiers}
    for name, q_ids, q_w, (scores, idx) in launches:
        s, i = own[name].search(q_ids, q_w)
        check(np.array_equal(scores, s.cpu().numpy())
              and np.array_equal(idx, i.cpu().numpy()),
              f"chaos: a {name} launch is not bitwise its tier's own index "
              "on the same padded batch")
    mix = {t: tiers.count(t) for t in sorted(set(tiers))}
    st = server.stats
    counts = runs["chaos.0"]
    check(counts["dist_topk"] > 0 and counts["act_phase2_gather"] > 0,
          f"chaos: launches {nonzero(counts)}")
    if "fast" in mix:
        check(counts["cand_pour_rows.pour_iters0"] > 0
              and counts["cand_pour_rows.pour"] > 0,
              f"chaos: the fast tier's launches {nonzero(counts)}")
    injected = sum(1 for e in log_a if e[2] == "fail")
    print(f"phase 10: chaos from_seed(0, horizon=512, p_fail=0.1), "
          f"{len(req_rows)} requests in groups of {CHAOS_GROUP}, twice: "
          f"identical tiers and bits; tiers {mix}; {injected} injected "
          f"failures, {st.launch_failures} launch failures, {st.launches} "
          f"launches, shed {st.shed}; every one of the {len(launches)} "
          f"launches bitwise its tier's own index on the same batch; "
          f"kernel launches {nonzero(counts)}", flush=True)
    return dict(tier_mix=mix, injected=injected,
                launch_failures=st.launch_failures, launches=st.launches,
                shed=st.shed, deterministic=True)


def serve_queries(server, q_host_ids, q_host_w):
    """The 16 queries through a fresh run of ``server``, one batch."""
    async def go():
        async with server:
            return await asyncio.gather(*[
                server.search(a, b) for a, b in zip(q_host_ids, q_host_w)])
    return asyncio.run(go())


def same_answers(a, b):
    return all(x.generation == y.generation and x.tier == y.tier
               and np.array_equal(x.scores, y.scores)
               and np.array_equal(x.indices, y.indices)
               for x, y in zip(a, b, strict=True))


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def phase10_lifecycle(index, lsh_index, host_corpus, rows, dev, runs):
    """Phase 10 (d): mutations, snapshot and restore on the card; a
    corrupt newest snapshot falls back; a sourced primary restores its
    tables bitwise without a refit."""
    host_ids, host_w = host_corpus.ids.numpy(), host_corpus.w.numpy()
    qi, qw = host_ids[rows], host_w[rows]
    rng = np.random.default_rng(SEED + 20)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        server = EmdServer(index, serve_policy())
        add = rng.choice(N_DOCS, LIFE_APPEND, replace=False)
        new_ids = server.append(host_ids[add], host_w[add])
        p1 = snapshot(server, d)                               # gen 1
        drop = rng.choice(np.concatenate([np.arange(N_DOCS), new_ids]),
                          LIFE_DELETE, replace=False)
        check(server.delete(drop) == LIFE_DELETE, "delete miscounted")
        t0 = time.perf_counter()
        p2 = snapshot(server, d)                               # gen 2
        save_s = time.perf_counter() - t0
        zero_counts()
        before = serve_queries(server, qi, qw)
        torch.cuda.synchronize()
        runs["lifecycle"] = counts = read_counts()
        check(counts["dist_topk"] > 0 and counts["act_phase2_gather"] > 0,
              f"lifecycle: launches {nonzero(counts)}")
        t0 = time.perf_counter()
        restored = restore_server(d, serve_policy(), device=dev)
        restore_s = time.perf_counter() - t0
        check(restored.generation == server.generation == 2
              and np.array_equal(restored.doc_ids, server.doc_ids),
              "lifecycle: the restored server's generation or ids differ")
        after = serve_queries(restored, qi, qw)
        check(same_answers(before, after),
              "lifecycle: the restored server's answers are not bitwise")
        corrupt_checkpoint(p2, leaves=("ids",), seed=1)
        fallback = restore_latest(d)
        check(fallback.generation == 1
              and fallback.corpus.n == N_DOCS + LIFE_APPEND,
              f"lifecycle: a corrupt newest snapshot fell back to "
              f"generation {fallback.generation}")
        out.update(snapshot_bytes=dir_bytes(p2), save_s=save_s,
                   restore_s=restore_s, generation=2, fallback=1)
        del p1
        # A sourced primary: its tables restore bitwise, with no refit.
        lsh_server = EmdServer(lsh_index, serve_policy())
        d2 = os.path.join(d, "lsh")
        t0 = time.perf_counter()
        p = snapshot(lsh_server, d2)
        lsh_save = time.perf_counter() - t0
        lsh_before = serve_queries(lsh_server, qi, qw)
        spec_cls = type(lsh_index.source.spec)
        fit = spec_cls.build

        def refit(*a, **kw):
            raise AssertionError("restore refit the candidate source")
        spec_cls.build = refit
        try:
            t0 = time.perf_counter()
            lsh_restored = restore_server(d2, serve_policy(), device=dev)
            lsh_restore = time.perf_counter() - t0
        finally:
            spec_cls.build = fit
        src = lsh_restored._gen.tiers[0].index.source
        check(all(torch.equal(a, b) for a, b in zip(
            src.leaves(), lsh_index.source.leaves(), strict=True)),
              "lifecycle: the restored source's tables are not bitwise")
        check(same_answers(lsh_before, serve_queries(lsh_restored, qi, qw)),
              "lifecycle: the restored sourced server's answers differ")
        out["lsh"] = dict(snapshot_bytes=dir_bytes(p), save_s=lsh_save,
                          restore_s=lsh_restore,
                          source_leaves=len(src.leaves()))
    print(f"phase 10: lifecycle: appended {LIFE_APPEND}, deleted "
          f"{LIFE_DELETE} by external id; snapshot of generation 2 "
          f"{out['snapshot_bytes'] / 1e6:.1f} MB in {save_s:.3f} s, "
          f"restore_server {restore_s:.3f} s, the {NQ} queries bitwise the "
          "same at the same generation; the newest snapshot corrupted, "
          "restore_latest fell back to generation 1; the LSH-sourced "
          f"primary: snapshot {out['lsh']['snapshot_bytes'] / 1e6:.1f} MB "
          f"in {lsh_save:.3f} s, restore {lsh_restore:.3f} s with no refit, "
          f"its {out['lsh']['source_leaves']} tables bitwise, answers "
          "bitwise", flush=True)
    return out


def phase10(host_corpus, corpus, q_ids, q_w, rows, dev):
    """Phase 10: the serving path: sourced cascades, EmdServer under load
    and under chaos, snapshots. Returns its numbers and the launch counts
    of its runs."""
    t_start = time.perf_counter()
    runs, results = {}, {}
    results["sourced"], lsh_index = phase10_sourced(
        host_corpus, corpus, q_ids, q_w, rows, dev, runs)
    results["serve"], index = phase10_serve(host_corpus, dev, runs)
    results["chaos"] = phase10_chaos(index, host_corpus, runs)
    results["lifecycle"] = phase10_lifecycle(index, lsh_index, host_corpus,
                                             rows, dev, runs)
    results["seconds"] = time.perf_counter() - t_start
    print(f"phase 10: done in {results['seconds']:.1f} s", flush=True)
    return results, runs, lsh_index


# -------------------------------------------------------------- phase 11
# Slice 9: the kernels' tile variants, the autotuner, the static checks.

#: Launches timed between CUDA events for each variant.
TILE_REPS = 20
#: K3's corpus-row cases: name -> (mode, iters, all-rows form).
ROWS_CASES = {"cand_pour_rows.pour": ("pour", ACT3, False),
              "cand_pour_rows.pour_iters0": ("pour", 0, False),
              "cand_pour_rows.omr": ("omr", 1, False),
              "cand_pour_rows.all_pour_iters0": ("pour", 0, True),
              "cand_pour_rows.all_omr": ("omr", 1, True)}
#: The configs of (b): act-7 (the main path) and the tight cascade.
TUNED_CONFIGS = {"act7": dict(method="act", iters=ITERS),
                 "tight": dict(cascade="tight")}


def spill_bytes(log):
    """ptxas' spill stores of a library, bytes summed over its kernels
    (None when it was not compiled in this run)."""
    if log is None:
        return None
    return sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", log))


def tile_cases(corpus, q_ids, q_w, wide, narrow, precision):
    """The tiled families' launches of phases 2-8 under ``precision``:
    family -> {case: (call(**tiles), attrs(variant), dims)}, ``dims`` the
    case's launch for the model (``ops.block_layout``)."""
    dt = torch.float32 if precision == "f32" else torch.bfloat16
    n, v = corpus.n, corpus.v
    coords, qcs, qmask = corpus.coords, corpus.coords[q_ids], q_w > 0
    Z, W = lc._phase1_batched_dispatch(corpus, q_ids, q_w, ITERS + 1, True,
                                       precision)
    cases, (_, _, _, valid, _, _) = cand_cases(corpus, q_ids, q_w, wide,
                                               narrow, precision)
    ids, w = corpus.ids, corpus.w
    out = {"dist_topk": {
        f"dist_topk.k{k}": (
            lambda k=k, **t: ops.dist_topk_batched(coords, qcs, qmask, k,
                                                   out_dtype=dt, **t),
            lambda var, k=k: dist_topk.attrs(k, torch.float32, dt, var),
            dict(nq=NQ, v=v, h=HMAX, m=DIM, k=k)) for k in (ITERS + 1, 2, 1)}}
    out["act_phase2"] = {name: (
        lambda nq=nq, **t: ops.act_phase2_gather(w, ids, Z[:nq], W[:nq], **t),
        lambda var: act_phase2.gather_attrs(ITERS + 1, W.shape[2], dt, var),
        dict(nq=nq, n=n, h=HMAX, iters=ITERS))
        for name, nq in (("act_phase2_gather", NQ),
                         ("act_phase2_gather.nq1", 1))}
    out["cand_pour"] = {
        name: (cases[name][0],
               lambda var, m=m, it=it, a=a: cand_pour.rows_attrs(m, it, a, dt,
                                                                var),
               dict(nq=NQ, b=n if a else (B_WIDE if m == "omr" else B_NARROW),
                    h=HMAX, iters=it, mode=m, form="all" if a else "cand"))
        for name, (m, it, a) in ROWS_CASES.items()}
    out["cand_dist"] = {}
    widest = cand_pour.column_groups(valid[1].tolist())[1]
    for mode, op in (("ict", ops.cand_ict_valid),
                     ("rev_min", ops.cand_rev_min_valid)):
        out["cand_dist"][f"cand_dist_valid.{mode}"] = (
            lambda op=op, **t: op(ids, w, narrow, *valid, **t),
            lambda var, mode=mode: cand_pour.valid_attrs(mode, dt, var),
            dict(nq=NQ, b=B_NARROW, h=HMAX, mode=mode))
        out["cand_dist"][f"cand_dist_valid.all_{mode}"] = (
            lambda op=op, **t: op(ids, w, None, *valid, **t),
            lambda var, mode=mode: cand_pour.all_attrs(mode, widest, dt,
                                                       var),
            dict(nq=NQ, b=n, h=HMAX, mode=mode, form="all", quads=widest,
                 bf16=precision == "bf16"))
    return out


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def phase11_variants(corpus, q_ids, q_w, wide, narrow, logs, bounds):
    """Phase 11 (a): every admitted variant of the four tiled families at
    the shapes of phases 2-8, built at once, bitwise the default under
    float32 and bfloat16 ladders, its compiler figures held to the model,
    timed. Returns {case: [variant rows]}."""
    dims = {"dist_topk": dict(nq=NQ, v=corpus.v, h=HMAX, m=DIM,
                              k=ITERS + 1),
            "act_phase2": dict(nq=NQ, n=corpus.n, h=HMAX, iters=ITERS),
            "cand_pour": dict(nq=NQ, b=B_NARROW, h=HMAX, iters=ACT3,
                              mode="pour"),
            "cand_dist": dict(nq=NQ, b=B_NARROW, h=HMAX, mode="ict")}
    configs = {f: autotune.admissible_configs(f, d)[:autotune.MAX_VARIANTS]
               for f, d in dims.items()}
    t0 = time.perf_counter()
    # K4's all-rows form is a library of its own on the family's macro.
    sources = {f: [ops.family_source(f, form) for form in (
        ("cand", "all") if f == "cand_dist" else ("cand",))]
        for f in configs}
    vlogs = _build.build_variants([
        (src, dict(ops.variant(f, **c)))
        for f, cfgs in configs.items() for c in cfgs for src in sources[f]])
    build_s = time.perf_counter() - t0
    print(f"phase 11: built {len(vlogs)} variants of "
          f"{ {f: len(c) for f, c in configs.items()} } in {build_s:.1f} s "
          f"(one nvcc each, at once)", flush=True)
    rows = {}
    for precision in ("f32", "bf16"):
        for family, cases in tile_cases(corpus, q_ids, q_w, wide, narrow,
                                        precision).items():
            for name, (call, attrs, cdims) in cases.items():
                source = ops.family_source(family, cdims.get("form", "cand"))
                want = as_tuple(call())
                for cfg in configs[family]:
                    got = as_tuple(call(**cfg))
                    check(all(torch.equal(g, x) for g, x in zip(
                        got, want, strict=True)),
                        f"{name} {precision} tile {cfg}: not bitwise the "
                        "default tile's output")
                    if precision != "f32":
                        continue
                    var = ops.variant(family, **cfg)
                    a = attrs(var)
                    layout = ops.block_layout(family, **cdims, **cfg)
                    cap = smem.reg_cap(layout)
                    check(a["static_bytes"] + a["dynamic_bytes"]
                          == layout.smem_bytes,
                          f"{name} tile {cfg}: the model's {layout.smem_bytes}"
                          f" B of shared memory, the compiler's {a}")
                    check(a["regs"] <= cap, f"{name} tile {cfg}: "
                          f"{a['regs']} registers above the model's cap "
                          f"{cap}")
                    ms = cuda_ms(lambda: call(**cfg), reps=TILE_REPS)
                    log = (vlogs.get((source, var)) if var
                           else logs.get(source))
                    rows.setdefault(name, []).append(dict(
                        tiles=cfg, ms=ms, bound_ms=bounds.get(name),
                        smem_bytes=layout.smem_bytes,
                        static_bytes=a["static_bytes"],
                        dynamic_bytes=a["dynamic_bytes"], regs=a["regs"],
                        reg_cap=cap, local_bytes=a["local_bytes"],
                        blocks_per_sm=smem.blocks_per_sm(layout,
                                                         regs=a["regs"]),
                        spill_bytes=spill_bytes(log)))
        torch.cuda.synchronize()
    for name, vrows in rows.items():
        for r in vrows:
            b = r["bound_ms"]
            print(f"phase 11: {name} {r['tiles']}: {r['ms']:.4f} ms "
                  f"(bound {'n/a' if b is None else f'{b:.4f}'}), shared "
                  f"{r['smem_bytes']} B = the compiler's "
                  f"{r['static_bytes']} + {r['dynamic_bytes']}, "
                  f"{r['regs']} registers (cap {r['reg_cap']}), "
                  f"{r['blocks_per_sm']} blocks/SM, spill stores "
                  f"{r['spill_bytes']} B, local {r['local_bytes']} B; "
                  f"bitwise the default under f32 and bf16", flush=True)
    return rows, build_s


def phase11_tuner(host_corpus, q_ids, q_w, dev):
    """Phase 11 (b): ``autotune="force"`` then ``"cached"`` on one tune
    cache file, for each of TUNED_CONFIGS: the cached build times nothing
    and picks what the forced one picked; both search bitwise like the
    default config."""
    path = os.path.join(tempfile.mkdtemp(prefix="tune-"), "tune.json")
    out = {}
    for name, cfg in TUNED_CONFIGS.items():
        base = dict(top_l=TOP_L, block_q=BLOCK_Q, **cfg)
        timing.calls = 0
        t0 = time.perf_counter()
        forced = EmdIndex.build(host_corpus, EngineConfig(
            **base, autotune="force", tune_cache=path), device=dev)
        force_s, bouts = time.perf_counter() - t0, timing.calls
        check(bouts > 0, f"{name}: autotune='force' timed nothing")
        timing.calls = 0
        cached = EmdIndex.build(host_corpus, EngineConfig(
            **base, autotune="cached", tune_cache=path), device=dev)
        check(timing.calls == 0, f"{name}: the cached build timed "
              f"{timing.calls} bouts")
        check(cached.tuned_blocks == forced.tuned_blocks
              and dataclasses.replace(cached.config, autotune="force")
              == forced.config,
              f"{name}: cached picks {cached.tuned_blocks} / "
              f"{cached.config}, forced {forced.tuned_blocks} / "
              f"{forced.config}")
        default = EmdIndex.build(host_corpus, EngineConfig(**base),
                                 device=dev)
        s_d, i_d = default.search(q_ids, q_w)
        for label, index in (("forced", forced), ("cached", cached)):
            s, i = index.search(q_ids, q_w)
            check(torch.equal(s, s_d) and torch.equal(i, i_d),
                  f"{name}: the {label} tiles' search is not bitwise the "
                  "default config's")
        t_d, _ = search_seconds(lambda: default.search(q_ids, q_w))
        t_c, _ = search_seconds(lambda: cached.search(q_ids, q_w))
        out[name] = dict(picks=cached.tuned_blocks, force_s=force_s,
                         bouts=bouts, search_s_default=t_d,
                         search_s_tuned=t_c)
        print(f"phase 11: {name}: force build {force_s:.1f} s ({bouts} "
              f"paired bouts), picks {cached.tuned_blocks}; the cached build "
              f"timed nothing and picked the same; scores and top-{TOP_L} "
              f"ids bitwise the default config's; search {t_c:.4f} s tuned, "
              f"{t_d:.4f} s default (median of 3)", flush=True)
    return out


def phase11(corpus, host_corpus, q_ids, q_w, wide, narrow, logs, bounds,
            dev):
    """Phase 11: tile variants, the tuner's round trip, the static
    checks."""
    t_start = time.perf_counter()
    variants, build_s = phase11_variants(corpus, q_ids, q_w, wide, narrow,
                                         logs, bounds)
    tuned = phase11_tuner(host_corpus, q_ids, q_w, dev)
    rc = static_check.main(["--passes", "registry", "smem", "collectives"])
    check(rc == 0, "python -m repro_torch.analysis.check --passes registry "
          "smem collectives found violations")
    secs = time.perf_counter() - t_start
    print(f"phase 11: done in {secs:.1f} s ({build_s:.1f} s of builds)",
          flush=True)
    return dict(variants=variants, tuned=tuned, build_s=build_s,
                seconds=secs)


# -------------------------------------------------------------- phase 12
# Slice 10: the mesh. EmdIndex(backend="distributed") over a (data, model)
# torch.distributed mesh on the one card: a 1x1 mesh over NCCL, and 2x2 and
# 1x4 meshes whose ranks share the card and exchange over gloo (their times
# are contended: no scale-out figure). The ranks load the libraries phase 1
# built; the parent writes the corpus once and the ranks memory-map it.

#: mesh name -> (data ranks, model ranks, collective backend).
MESHES = {"1x1-nccl": (1, 1, "nccl"), "2x2-gloo": (2, 2, "gloo"),
          "1x4-gloo": (1, 4, "gloo")}
#: The full-corpus searches of each mesh: name -> EngineConfig fields.
P12_METHODS = {"act": dict(method="act", iters=ITERS),
               "rwmd": dict(method="rwmd"), "omr": dict(method="omr"),
               "rwmd_rev": dict(method="rwmd_rev"), "ict": dict(method="ict"),
               "rwmd_sym": dict(method="rwmd", symmetric=True)}
P12_CASCADES = ("chain", "tight", "fast", "lsh")
#: The all-pairs runs on the prefix: name -> precision policy.
P12_ALL_PAIRS = {"all_pairs.act.f32": "f32", "all_pairs.act.bf16": "bf16"}
#: Bitwise the single-card cuda index at every mesh shape: every kernel on
#: their path computes a row, or a (query, row) pair, whatever the shard
#: shapes, and the merges are exact. The ladders led by a batched product
#: over the query slice (wcd's centroids, the LSH source's query
#: centroids) are held bitwise too, as they have run; a mesh that rounds
#: them otherwise fails here.
P12_BITWISE = ("scores.act", "scores.rwmd", "scores.omr", "search.act",
               "search.rwmd", "search.omr", "cascade.chain", "cascade.fast",
               "cascade.lsh", "all_pairs.act.f32", "all_pairs.act.bf16")
#: Within RTOL / ATOL, top-16 equal where separated: the valid-bin handoff
#: is one cuBLAS product whose rounding may follow the query slice's shape.
P12_TOL = ("scores.rwmd_rev", "scores.ict", "scores.rwmd_sym",
           "search.rwmd_rev", "search.ict", "search.rwmd_sym",
           "cascade.tight")
#: Kernels each run must launch on every rank (count > 0).
P12_EXPECT = {
    "scores.act": ("dist_topk", "act_phase2_gather"),
    "scores.rwmd": ("dist_topk", "cand_pour_rows.all_pour_iters0"),
    "scores.omr": ("dist_topk", "cand_pour_rows.all_omr"),
    "scores.rwmd_rev": ("cand_dist_valid.all_rev_min",),
    "scores.ict": ("cand_dist_valid.all_ict",),
    "scores.rwmd_sym": ("dist_topk", "cand_pour_rows.all_pour_iters0",
                        "cand_dist_valid.all_rev_min"),
    "cascade.chain": ("dist_topk", "cand_pour_rows.all_pour_iters0",
                      "cand_pour_rows.omr", "cand_pour_rows.pour"),
    "cascade.tight": ("dist_topk", "cand_pour_rows.all_pour_iters0",
                      "cand_pour_rows.pour", "cand_dist_valid.ict"),
    "cascade.fast": ("dist_topk", "cand_pour_rows.pour_iters0",
                     "cand_pour_rows.pour"),
    "cascade.lsh": ("dist_topk", "cand_pour_rows.pour_iters0",
                    "cand_pour_rows.pour"),
    "all_pairs.act.f32": ("dist_topk", "act_phase2_gather"),
    "all_pairs.act.bf16": ("dist_topk", "act_phase2_gather"),
}
#: Seconds a mesh's ranks may take, start-up included.
P12_TIMEOUT = 360
#: Rows of the all-pairs prefix on the mesh (phase 8's is PREFIX; cut for
#: the script's time limit).
P12_PREFIX = 500
#: Requests of the 2x2 mesh's served run, sent 16 at once.
P12_SERVE_REQUESTS = 64
#: The kernels each served run must launch on every rank of its mesh.
P12_SERVED_EXPECT = {
    "open": ("dist_topk", "act_phase2_gather"),
    "fast": ("dist_topk", "cand_pour_rows.pour_iters0",
             "cand_pour_rows.pour"),
    "primary": ("dist_topk", "act_phase2_gather"),
    "lsh_tight": ("dist_topk", "cand_pour_rows.pour_iters0",
                  "cand_pour_rows.pour", "cand_dist_valid.ict"),
}


def p12_searches(host, q_ids, q_w, source_leaves, build):
    """The phase's runs as name -> callable, over indexes made by
    ``build(corpus, **config fields)`` (the cuda index of one card, or the
    distributed one of a rank)."""
    runs = {}
    for name, cfg in P12_METHODS.items():
        index = build(host, **cfg)
        runs[f"scores.{name}"] = functools.partial(index.scores, q_ids, q_w)
        runs[f"search.{name}"] = functools.partial(index.search, q_ids, q_w)
    index = build(host, method="act", iters=ACT3)
    for name in P12_CASCADES[:-1]:
        runs[f"cascade.{name}"] = functools.partial(index.search, q_ids, q_w,
                                                    cascade=name)
    lsh = build(host, cascade=SOURCED["lsh"],
                source=LSH_SPEC.wrap(source_leaves))
    runs["cascade.lsh"] = functools.partial(lsh.search, q_ids, q_w)
    prefix = prefix_corpus(host, P12_PREFIX)
    for name, precision in P12_ALL_PAIRS.items():
        runs[name] = build(prefix, method="act", iters=ITERS,
                           precision=precision).all_pairs
    return runs


def p12_host(x):
    return (tuple(t.cpu().numpy() for t in x) if isinstance(x, tuple)
            else x.cpu().numpy())


def phase12_rank(mesh, paths, rows, source_leaves, mesh_name, serve):
    """One rank of a phase-12 mesh: every run warmed once, then counted
    (launch counts and collective bytes set to 0 just before it) and timed
    between barriers; then K1 and the fused K2 alone on this rank's
    shards (ranks sharing the card time them at once: contended); then the
    mesh's served runs (``p12_served``)."""
    import warnings

    import torch.distributed as dist

    from repro_torch.kernels import partition
    from repro_torch.sharding import annotate
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # read-only memory maps
        host = Corpus(*(torch.from_numpy(np.load(p, mmap_mode="r"))
                        for p in paths))
    dev = mesh.device
    q_ids, q_w = (x[rows].to(dev) for x in (host.ids, host.w))

    def build(corpus, source=None, **cfg):
        cfg = dict(dict(top_l=TOP_L, block_q=BLOCK_Q), **cfg)
        return EmdIndex.build(corpus, EngineConfig(backend="distributed",
                                                   **cfg),
                              mesh=mesh, source=source)
    out = {"results": {}, "launches": {}, "bytes": {}, "seconds": {}}
    for name, run in p12_searches(host, q_ids, q_w, source_leaves,
                                  build).items():
        run()
        torch.cuda.synchronize()
        dist.barrier()
        zero_counts()
        annotate.reset_traffic()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
        out["launches"][name] = nonzero(read_counts())
        out["bytes"][name] = annotate.traffic()
        res = p12_host(res)
        if name.startswith("all_pairs"):      # every rank: a digest
            out["results"][name] = hashlib.sha256(res.tobytes()).hexdigest()
            if mesh.index("data") == mesh.index("model") == 0:
                out["results"][name + ".matrix"] = res
        else:
            out["results"][name] = res
    # K1 and the fused K2 alone on this rank's shards, as the act-7 search
    # launches them.
    q0, q1 = partition.axis_slice(mesh, "data", len(rows))
    qi, qw, nq_l = q_ids[q0:q1], q_w[q0:q1], q1 - q0
    coords = host.coords.to(dev)
    v0, v1 = 0, host.v
    if mesh.size("model") > 1 and partition.vocab_shardable(mesh, host.v):
        v0, v1 = partition.axis_slice(mesh, "model", host.v)
    cs, qcs, qm = coords[v0:v1].contiguous(), coords[qi], qw > 0
    index = build(host, method="act", iters=ITERS)
    local = index._local
    Z, W = lc._phase1_batched_dispatch(local, qi, qw, ITERS + 1, True,
                                       mesh=mesh)
    dist.barrier()
    k1 = cuda_ms(lambda: ops.dist_topk_batched(cs, qcs, qm, ITERS + 1),
                 reps=10)
    dist.barrier()
    k2 = cuda_ms(lambda: ops.act_phase2_gather(local.w, local.ids, Z, W),
                 reps=10)
    out["shards"] = dict(k1_ms=k1, k1_shape=[nq_l, v1 - v0], k2_ms=k2,
                         k2_shape=[nq_l, local.n],
                         staged=annotate.staged(mesh, q_ids))
    del index, local, Z, W
    out["served"] = p12_served(mesh, mesh_name, host, rows, build, serve)
    return out


def p12_session(server, fn):
    """``fn(server)`` (a coroutine function) in a run of the server on the
    mesh's leader, its result; ``follow()`` on every other rank (None)."""
    if not server.is_leader:
        server.follow()
        return None

    async def go():
        async with server:
            return await fn(server)
    return asyncio.run(go())


def p12_counted(runs, name, fn):
    """``fn()`` with this rank's launch counts and collective bytes set to
    0 just before it and read just after: runs[name]."""
    from repro_torch.sharding import annotate
    torch.cuda.synchronize()
    zero_counts()
    annotate.reset_traffic()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    runs[name] = dict(launches=nonzero(read_counts()),
                      bytes=annotate.traffic(),
                      seconds=time.perf_counter() - t0)
    return res


def p12_answers(results):
    """Served answers as (tier, generation, scores, indices); a shed
    request as its message."""
    return [(r.tier, r.generation, r.scores, r.indices)
            if isinstance(r, ServeResult) else repr(r) for r in results]


async def p12_ask(server, host_ids, host_w, rows):
    """The rows' queries sent at once (one launch of up to 16)."""
    return p12_answers(await asyncio.gather(
        *[server.search(host_ids[r], host_w[r]) for r in rows],
        return_exceptions=True))


def p12_served(mesh, mesh_name, host, rows, build, serve):
    """This rank's served runs on ``mesh`` (module docstring, phase 12):
    {"runs": name -> launches, bytes and seconds on this rank, "answers":
    the leader's answers, "stats": numbers}."""
    from repro_torch.launch.mesh import plan_mesh
    leader = mesh.index("data") == mesh.index("model") == 0
    host_ids, host_w = host.ids.numpy(), host.w.numpy()
    runs, answers, stats = {}, {}, {}
    policy = dataclasses.replace(serve_policy(), deadline_ms=60_000.0)

    def ask(rows_):
        return lambda s: p12_ask(s, host_ids, host_w, rows_)
    if mesh_name != "1x4-gloo":
        index = build(host, method="act", iters=ITERS)
        # The fast rung: the leader's hook fails the primary's two attempts.
        hook = ChaosInjector(ChaosSchedule(fail_launches=frozenset({0, 1})))
        server = EmdServer(index, policy, launch_hook=hook if leader
                           else None)
        answers["fast"] = p12_counted(runs, "served.fast", lambda: p12_session(
            server, ask(rows)))
    if mesh_name == "1x1-nccl":
        for b in (1, 2, 4, 8, 16):          # every bucket's shape, once
            index.search(host_ids[:b], host_w[:b])
        for qps in SERVE_LOADS:
            server = EmdServer(index, serve_policy())

            async def go(s, qps=qps):
                return await open_loop(s, host_ids, host_w,
                                       serve["req_rows"], qps,
                                       SEED + int(qps))
            results, lat = p12_counted(runs, f"served.open.{int(qps)}",
                                       lambda: p12_session(server, go))
            st = server.stats
            check(st.launch_failures == 0 and st.device_faults == 0,
                  f"phase 12 served {qps}/s: {st.launch_failures} launch "
                  "failures without a hook")
            mix = {}
            for r in results:
                t = r.tier if isinstance(r, ServeResult) else "SHED"
                mix[t] = mix.get(t, 0) + 1
            answers[f"open.{int(qps)}"] = p12_answers(results)
            stats[f"open.{int(qps)}"] = dict(
                p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)), launches=st.launches,
                flushes=st.flushes, tier_mix=mix, shed=st.shed,
                buckets=dict(sorted(st.bucket_launches.items())))
    if mesh_name == "2x2-gloo":
        server = EmdServer(index, policy)
        req = serve["req_rows"][:P12_SERVE_REQUESTS]

        async def burst(s):
            out = []
            for g in range(0, len(req), NQ):
                out += await p12_ask(s, host_ids, host_w, req[g:g + NQ])
            return out
        answers["primary"] = p12_counted(runs, "served.primary",
                                         lambda: p12_session(server, burst))
        stats["primary_launches"] = server.stats.launches

        async def mutate(s):
            new_ids = s.append(host_ids[serve["append"]],
                               host_w[serve["append"]])
            removed = s.delete(serve["delete"])
            return (new_ids, removed,
                    await p12_ask(s, host_ids, host_w, rows))
        res = p12_counted(runs, "served.mutated",
                          lambda: p12_session(server, mutate))
        if res is not None:
            new_ids, stats["removed"], answers["mutated"] = res
            stats["appended"] = len(new_ids)
        stats["mutate_s"] = runs["served.mutated"]["seconds"]

        async def reshards(s):
            out, secs = [], []
            dev = mesh.device.type
            for plan in (plan_mesh(1, 2, ranks=(0, 1), backend="gloo",
                                   device=dev),
                         plan_mesh(2, 2, backend="gloo", device=dev)):
                t0 = time.perf_counter()
                s.reshard(plan)
                secs.append(time.perf_counter() - t0)
                out.append(await p12_ask(s, host_ids, host_w, rows))
            return out, secs
        res = p12_counted(runs, "served.reshard",
                          lambda: p12_session(server, reshards))
        if res is not None:
            answers["reshard"], stats["reshard_s"] = res
        stats["generation"] = server.generation
        t0 = time.perf_counter()
        snapshot(server, serve["snap_dir"])
        stats["snapshot_s"] = time.perf_counter() - t0
        stats["live"] = p12_reshard_live(mesh, host, index)
    if mesh_name == "1x4-gloo":
        for name, path in (("primary", serve["snap_dir"]),
                           ("lsh_tight", serve["lsh_dir"])):
            t0 = time.perf_counter()
            server = restore_server(path, policy, mesh=mesh)
            stats[f"restore_{name}_s"] = time.perf_counter() - t0
            stats[f"restore_{name}_generation"] = server.generation
            answers[f"restored.{name}"] = p12_counted(
                runs, f"served.restored.{name}",
                lambda: p12_session(server, ask(rows)))
        # The fast rung over the restored LSH primary's corpus (the
        # original rows, as on the other meshes).
        hook = ChaosInjector(ChaosSchedule(fail_launches=frozenset({0, 1})))
        server = EmdServer(server._gen.tiers[0].index, policy,
                           launch_hook=hook if leader else None)
        answers["fast"] = p12_counted(runs, "served.fast", lambda: (
            p12_session(server, ask(rows))))
    return dict(runs=runs, answers=answers if leader else {}, stats=stats)


def p12_reshard_live(mesh, host, index):
    """``runtime.elastic.reshard_live`` on its own: ``index``'s tables
    2x2 -> 1x2 -> 2x2, as a server's would move were its rows not on every
    rank. Each move's seconds, the bytes this rank received and whether
    its tables are bitwise a fresh build's on the new mesh (None outside
    it)."""
    from repro_torch.launch.mesh import join_mesh, plan_mesh, world_group
    from repro_torch.launch.search import SEARCH_PLAN
    from repro_torch.runtime import elastic
    from repro_torch.sharding import annotate
    plan = {"ids": SEARCH_PLAN["corpus_ids"], "w": SEARCH_PLAN["corpus_w"],
            "coords": SEARCH_PLAN["coords"]}
    group = world_group(mesh.timeout)
    tables, old, out = {k: getattr(index._local, k) for k in plan}, mesh, {}
    for name, (n_data, n_model, ranks) in (("down", (1, 2, (0, 1))),
                                           ("up", (2, 2, None))):
        new = join_mesh(plan_mesh(n_data, n_model, ranks=ranks,
                                  backend="gloo", device=mesh.device.type))
        torch.cuda.synchronize()
        annotate.reset_traffic()
        t0 = time.perf_counter()
        tables = elastic.reshard_live(tables, new, plan, mesh=old,
                                      group=group)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        same = None
        if new is not None:
            fresh = EmdIndex.build(host, index.config, mesh=new)._local
            same = all(torch.equal(tables[k], getattr(fresh, k))
                       for k in plan)
        out[name] = dict(seconds=secs, bitwise=same,
                         bytes=annotate.traffic().get(elastic.LABEL, 0))
        old = new
    return out


def p12_compare(name, got, want, next_want):
    """(max |d|, bitwise, top-16 agreement) of one run against the single
    card; checks it by its class (P12_BITWISE / P12_TOL)."""
    if name.startswith("scores"):
        d = float(np.abs(got - want).max())
        bitwise = bool(np.array_equal(got, want))
        if name in P12_BITWISE:
            check(bitwise, f"phase 12 {name}: not bitwise (max |d| {d})")
        else:
            check(np.allclose(got, want, rtol=RTOL, atol=ATOL),
                  f"phase 12 {name}: max |d| {d} beyond rtol {RTOL} atol "
                  f"{ATOL}")
        return d, bitwise, None
    (v, i), (wv, wi) = got, want
    bitwise = bool(np.array_equal(v, wv) and np.array_equal(i, wi))
    d = float(np.abs(v - wv).max())
    if name in P12_BITWISE:
        check(bitwise, f"phase 12 {name}: not bitwise (max |d| {d})")
    firm = firm_ranks(torch.from_numpy(wv), torch.from_numpy(next_want))
    firm = firm.numpy()
    check(np.allclose(v, wv, rtol=RTOL, atol=ATOL)
          and np.array_equal(i[firm], wi[firm]),
          f"phase 12 {name}: max |d| {d}, top-{TOP_L} ids differ at a "
          "separated rank")
    return d, bitwise, float(firm.mean())


def phase12(host_corpus, lsh_index, rows, q_ids, q_w, dev, p4):
    """Phase 12: each mesh of MESHES against the single-card cuda index on
    the same runs. ``p4``: phase 4's single-card K1 and fused K2 ms."""
    t_start = time.perf_counter()
    leaves = [t.cpu().numpy() for t in lsh_index.source.leaves()]

    def build(corpus, source=None, **cfg):
        cfg = dict(dict(top_l=TOP_L, block_q=BLOCK_Q), **cfg)
        return EmdIndex.build(corpus, EngineConfig(**cfg), device=dev,
                              source=source)
    want = {}
    runs = p12_searches(host_corpus, q_ids, q_w, leaves, build)
    for name, run in runs.items():
        want[name] = p12_host(run())
    # The score after the 16th of each full-corpus search (ranks 16 of the
    # scores), and +inf for a cascade (its 17th is not rescored).
    nxt = {}
    for name in want:
        if name.startswith("search"):
            s = np.sort(want["scores" + name[6:]], axis=1)
            nxt[name] = s[:, TOP_L]
        elif name.startswith("cascade"):
            nxt[name] = np.full(NQ, np.inf, np.float32)
    del runs
    serve, served_want = p12_serve_setup(host_corpus, leaves, q_ids, q_w,
                                         build)
    # The ranks share the card with this process: release its allocator's
    # cached blocks first (phases 8-11 leave tens of GB reserved and free
    # in the cache).
    gc.collect()
    torch.cuda.empty_cache()
    gib = 2**30
    print(f"phase 12: this process holds "
          f"{torch.cuda.memory_allocated() / gib:.2f} GiB on the card "
          f"({torch.cuda.memory_reserved() / gib:.2f} GiB reserved) while "
          "the ranks run", flush=True)
    tmp = tempfile.mkdtemp(prefix="mesh-corpus-")
    paths = []
    for field in ("ids", "w", "coords"):
        paths.append(os.path.join(tmp, f"{field}.npy"))
        np.save(paths[-1], getattr(host_corpus, field).numpy())
    out = {}
    for mesh_name, (n_data, n_model, backend) in MESHES.items():
        t0 = time.perf_counter()
        ranks = run_local(phase12_rank, n_data, n_model, backend=backend,
                          device="cuda",
                          args=(paths, rows, leaves, mesh_name, serve),
                          timeout=P12_TIMEOUT)
        wall = time.perf_counter() - t0
        shared = n_data * n_model > 1
        label = (f"{n_data * n_model} ranks share the card, contended"
                 if shared else "one rank")
        if ranks[0]["shards"]["staged"]:
            print(f"phase 12: {mesh_name}: gloo's collectives on CUDA "
                  "tensors are staged through the host (the backend is "
                  "gloo)", flush=True)
        first = ranks[0]["results"]
        for r, rank in enumerate(ranks[1:], 1):
            for name, res in rank["results"].items():
                ok = all(np.array_equal(a, b) for a, b in zip(
                    *(x if isinstance(x, tuple) else (x,)
                      for x in (res, first[name]))))
                check(ok, f"phase 12 {mesh_name}: rank {r}'s {name} is not "
                      "rank 0's")
        summary = {}
        for name in want:
            launches = [rk["launches"][name] for rk in ranks]
            for r, c in enumerate(launches):
                for kname in P12_EXPECT.get(name, ()):
                    check(c.get(kname, 0) > 0,
                          f"phase 12 {mesh_name}: rank {r}'s {name} never "
                          f"launched {kname}: {c}")
            if name.startswith("all_pairs"):
                got = first[name + ".matrix"]
                d = float(np.abs(got - want[name]).max())
                bitwise = bool(np.array_equal(got, want[name]))
                check(np.array_equal(got, got.T),
                      f"phase 12 {mesh_name} {name}: not symmetric")
                check(bitwise, f"phase 12 {mesh_name} {name}: not bitwise "
                      f"(max |d| {d})")
                agree = None
            else:
                d, bitwise, agree = p12_compare(name, first[name],
                                                want[name], nxt.get(name))
            secs = [rk["seconds"][name] for rk in ranks]
            summary[name] = dict(max_abs_diff=d, bitwise=bitwise,
                                 agreement=agree, launches=launches,
                                 bytes=[rk["bytes"][name] for rk in ranks],
                                 seconds=secs)
            agreement = ("" if agree is None
                         else f", top-{TOP_L} agreement {agree:.3f}")
            print(f"phase 12: {mesh_name} ({label}) {name}: vs the single "
                  f"card max|d|={d:.3g} "
                  f"{'bitwise' if bitwise else 'not bitwise'}{agreement}"
                  f"; launches rank 0 {launches[0]}; bytes rank 0 "
                  f"{ranks[0]['bytes'][name]}; s per search "
                  f"{max(secs):.4f} (slowest rank)", flush=True)
        shards = [rk["shards"] for rk in ranks]
        for r, sh in enumerate(shards):
            print(f"phase 12: {mesh_name} rank {r}: K1 {sh['k1_ms']:.4f} ms "
                  f"on its {sh['k1_shape'][0]} queries x "
                  f"{sh['k1_shape'][1]} words, fused K2 {sh['k2_ms']:.4f} "
                  f"ms on {sh['k2_shape'][0]} queries x {sh['k2_shape'][1]} "
                  f"rows ({label}); one card, phase 4: K1 {p4['k1_ms']:.4f}"
                  f" ms, fused K2 {p4['kg_ms']:.4f} ms on {NQ} queries",
                  flush=True)
        served = p12_check_served(mesh_name, ranks, served_want, serve,
                                  label)
        for name, run in served["runs"].items():
            summary[name] = run
        out[mesh_name] = dict(shape=[n_data, n_model], backend=backend,
                              contended=shared, wall_s=wall, runs=summary,
                              shards=shards, served=served["stats"])
        print(f"phase 12: {mesh_name} done in {wall:.1f} s", flush=True)
    shutil.rmtree(serve["dir"])
    out["seconds"] = time.perf_counter() - t_start
    print(f"phase 12: done in {out['seconds']:.1f} s", flush=True)
    return out


def p12_serve_setup(host_corpus, leaves, q_ids, q_w, build):
    """The served runs' inputs (``serve``, to every rank) and the single
    card's answers they are held to: phase 10's requests and their batched
    rows on act-7, the 16 queries on the ``fast`` rung, on act-7 over the
    mutated corpus and on the LSH-sourced ``tight``-shaped primary; and
    that primary's snapshot under the distributed backend, which the 1x4
    mesh restores."""
    from repro_torch.serving.policy import resolve_tier
    from repro_torch.serving.server import _tier_config
    host_ids, host_w = host_corpus.ids.numpy(), host_corpus.w.numpy()
    req_rows = np.random.default_rng(SEED + 10).integers(0, N_DOCS,
                                                         SERVE_REQUESTS)
    rng = np.random.default_rng(SEED + 20)
    append = rng.choice(N_DOCS, LIFE_APPEND, replace=False)
    delete = rng.choice(N_DOCS + LIFE_APPEND, LIFE_DELETE, replace=False)
    tmp = tempfile.mkdtemp(prefix="mesh-serve-")
    serve = dict(req_rows=req_rows, append=append, delete=delete, dir=tmp,
                 snap_dir=os.path.join(tmp, "act7"),
                 lsh_dir=os.path.join(tmp, "lsh_tight"))
    act7 = build(host_corpus, method="act", iters=ITERS)
    want = dict(batched=batched_rows(act7, host_ids, host_w,
                                     np.unique(req_rows)))
    fast = EmdIndex.build(host_corpus, _tier_config(
        act7.config, resolve_tier("fast")), device=act7.device)
    want["fast"] = p12_host(fast.search(q_ids, q_w))
    keep = ~np.isin(np.arange(N_DOCS + LIFE_APPEND), delete)
    doc_ids = np.arange(N_DOCS + LIFE_APPEND)[keep]
    mutated = Corpus(*(torch.cat([x, x[torch.from_numpy(append)]])[
        torch.from_numpy(keep)] for x in (host_corpus.ids, host_corpus.w)),
        host_corpus.coords)
    s, i = p12_host(build(mutated, method="act", iters=ITERS).search(
        q_ids, q_w))
    want["mutated"] = (s, doc_ids[i])
    source = LSH_SPEC.wrap(leaves)
    want["lsh_tight"] = p12_host(build(
        host_corpus, cascade=SOURCED["lsh_tight"], source=source).search(
            q_ids, q_w))
    # The same primary under the distributed backend (a 1x1 mesh with no
    # process group, here), snapshotted for the 1x4 mesh's restore.
    dist_lsh = EmdIndex.build(host_corpus, EngineConfig(
        backend="distributed", cascade=SOURCED["lsh_tight"], top_l=TOP_L,
        block_q=BLOCK_Q), device=act7.device, source=source)
    snapshot(EmdServer(dist_lsh, ServingPolicy(ladder=("primary",))),
             serve["lsh_dir"])
    return serve, want


def p12_check_served(mesh_name, ranks, want, serve, label):
    """Hold one mesh's served runs to the single card, their launches to
    each other across the ranks of the run's mesh, and print them.
    Returns {"runs": name -> run summary, "stats": the leader's
    numbers}."""
    ans = ranks[0]["served"]["answers"]
    st = ranks[0]["served"]["stats"]

    def bitwise(got, want_s, want_i, name):
        for k, a in enumerate(got):
            check(not isinstance(a, str), f"phase 12 {mesh_name} {name}: "
                  f"request {k} failed: {a}")
            check(np.array_equal(a[2], want_s[k])
                  and np.array_equal(a[3], want_i[k]),
                  f"phase 12 {mesh_name} {name}: request {k} is not bitwise "
                  "the single card's")

    def tiers(got):
        return {t: sum(1 for a in got if a[0] == t)
                for t in sorted({a[0] for a in got})}
    fs, fi = want["fast"]
    check(tiers(ans["fast"]) == {"fast": NQ}, f"phase 12 {mesh_name}: the "
          f"fast burst's tiers {tiers(ans['fast'])}")
    bitwise(ans["fast"], fs, fi, "fast rung")
    lines = [f"the fast rung served {NQ} requests bitwise the single card's "
             "fast ladder"]
    if mesh_name == "1x1-nccl":
        for qps in SERVE_LOADS:
            name = f"open.{int(qps)}"
            got, o = ans[name], st[name]
            n = 0
            for row, a in zip(serve["req_rows"], got):
                if a[0] != "primary":
                    continue
                b_s, b_i = want["batched"][int(row)]
                check(np.array_equal(a[2], b_s) and np.array_equal(a[3], b_i),
                      f"phase 12 served {qps}/s: row {row} is not bitwise the "
                      "single card's batched row")
                n += 1
            lines.append(
                f"open-loop {SERVE_REQUESTS} requests at {qps:g}/s: latency "
                f"p50 {o['p50_ms']:.3f} ms, p99 {o['p99_ms']:.3f} ms; "
                f"launches {o['launches']}, flushes {o['flushes']}, buckets "
                f"{o['buckets']}, tiers {o['tier_mix']}, shed {o['shed']}; "
                f"the {n} primary answers bitwise the single card's batched "
                "rows")
    if mesh_name == "2x2-gloo":
        req = serve["req_rows"][:P12_SERVE_REQUESTS]
        got = ans["primary"]
        check(tiers(got) == {"primary": len(req)},
              f"phase 12 2x2 served tiers {tiers(got)}")
        bitwise(got, [want["batched"][int(r)][0] for r in req],
                [want["batched"][int(r)][1] for r in req], "primary")
        check(st["removed"] == LIFE_DELETE and st["appended"] == LIFE_APPEND,
              "phase 12 2x2: the mutations miscounted")
        bitwise(ans["mutated"], *want["mutated"], "mutated")
        gens = [{a[1] for a in x} for x in (ans["mutated"],
                                            *ans["reshard"])]
        check(gens == [{2}, {3}, {4}] and st["generation"] == 4,
              f"phase 12 2x2: generations {gens} across the reshards")
        for x in ans["reshard"]:
            bitwise(x, *want["mutated"], "reshard")
        lines += [
            f"{len(req)} requests over act-7 in groups of {NQ}: every answer "
            "primary and bitwise the single card's batched row",
            f"appended {LIFE_APPEND}, deleted {LIFE_DELETE} in "
            f"{st['mutate_s']:.3f} s: the {NQ} queries bitwise a single-card"
            " index of the mutated corpus",
            f"reshard 2x2 -> 1x2 in {st['reshard_s'][0]:.3f} s, 1x2 -> 2x2 in "
            f"{st['reshard_s'][1]:.3f} s: generations 2 -> 3 -> 4, answers "
            f"bitwise; snapshot in {st['snapshot_s']:.3f} s"]
        for move, label in (("down", "2x2 -> 1x2"), ("up", "1x2 -> 2x2")):
            per = [rk["served"]["stats"]["live"][move] for rk in ranks]
            inside = [r for r, x in enumerate(per) if x["bitwise"] is not None]
            check(all(per[r]["bitwise"] for r in inside)
                  and inside == ([0, 1] if move == "down" else [0, 1, 2, 3]),
                  f"phase 12 2x2: reshard_live {label}: the tables are not "
                  f"bitwise a fresh build's on ranks {inside}")
            lines.append(
                f"reshard_live {label} in "
                f"{max(x['seconds'] for x in per):.3f} s: the tables of ranks "
                f"{inside} bitwise a fresh build's; bytes received per rank "
                f"{[x['bytes'] for x in per]}")
    if mesh_name == "1x4-gloo":
        got = ans["restored.primary"]
        check(st["restore_primary_generation"] == 4
              and {a[1] for a in got} == {4},
              "phase 12 1x4: the restored generation")
        bitwise(got, *want["mutated"], "restored act-7")
        ls, li = want["lsh_tight"]
        got = ans["restored.lsh_tight"]
        check(tiers(got) == {"primary": NQ}, "phase 12 1x4: the restored "
              f"lsh_tight's tiers {tiers(got)}")
        gs = np.stack([a[2] for a in got])
        gi = np.stack([a[3] for a in got])
        d = float(np.abs(gs - ls).max())
        check(np.array_equal(gs, ls) and np.array_equal(gi, li),
              f"phase 12 1x4: the restored lsh_tight is not bitwise the "
              f"single card's (max |d| {d})")
        lines += [
            "restore_server(mesh=) of the 2x2 snapshot (generation 4) in "
            + ", ".join(f"{rk['served']['stats']['restore_primary_s']:.3f}"
                        for rk in ranks)
            + " s per rank: the 16 queries bitwise the 2x2 answers and the "
            "single card's",
            "restore_server(mesh=) of the LSH-sourced tight-shaped primary, "
            "no refit, in "
            + ", ".join(f"{rk['served']['stats']['restore_lsh_tight_s']:.3f}"
                        for rk in ranks)
            + " s per rank: the 16 queries bitwise the single card's"]
    runs = {}
    names = ranks[0]["served"]["runs"]
    members = {"served.reshard": [(0, 1), (2, 3)]}
    for name in names:
        per = [rk["served"]["runs"][name] for rk in ranks]
        launches = [r["launches"] for r in per]
        for group in members.get(name, [range(len(ranks))]):
            check(all(launches[r] == launches[group[0]] for r in group),
                  f"phase 12 {mesh_name} {name}: launches differ across "
                  f"ranks {list(group)}: {launches}")
        key = name.split(".", 1)[1]
        key = ("open" if key.startswith("open") else
               "lsh_tight" if key.endswith("lsh_tight") else
               "fast" if key == "fast" else "primary")
        for r, c in enumerate(launches):
            for kname in P12_SERVED_EXPECT[key]:
                check(c.get(kname, 0) > 0, f"phase 12 {mesh_name} {name}: "
                      f"rank {r} never launched {kname}: {c}")
        runs[name] = dict(launches=launches,
                          bytes=[r["bytes"] for r in per],
                          seconds=[r["seconds"] for r in per])
        print(f"phase 12: {mesh_name} ({label}) {name}: launches rank 0 "
              f"{launches[0]}, equal on the ranks of its mesh; bytes rank 0 "
              f"{per[0]['bytes']}, last rank {per[-1]['bytes']}; "
              f"{max(r['seconds'] for r in per):.3f} s", flush=True)
    for line in lines:
        print(f"phase 12: {mesh_name} served: {line}", flush=True)
    return dict(runs=runs, stats=st)



# -------------------------------------------------------------- phase 13
# Slice 12: the LM serving path. (a) every architecture at smoke width under
# float32, the card against the port's own CPU run on the same weights; (b)
# olmo-1b and (c) zamba2-2.7b at full width, bfloat16 weights drawn on the
# card from a seeded torch.Generator; (d) the EMD retrieval stage on phase
# 3's corpus. No kernel of the model is written by hand (the JAX package's
# LM stack reaches no pallas_call): its matmuls are cuBLAS's, in full float32
# under float32 (phase 0 checks the matmul precision; the SSM's convolution
# is elementwise).
#: The full-width runs: prompt tokens of each of the LM_BATCH prompts
#: (olmo-1b's past layers.FLASH_THRESHOLD: prefill and the float32 forward
#: run the chunked attention).
LM_FULL = {"olmo-1b": 2048, "zamba2-2.7b": 1024}
LM_BATCH, LM_GEN = 4, 32
#: The prompt positions decoded token by token: the last LM_TAIL, after
#: prefill of the rest hands its caches to the decode cache (the host-bound
#: token-by-token passes were most of the phase's time over whole prompts;
#: cut for the script's time limit).
LM_TAIL = 256
#: decode_step against forward under float32: the JAX package's own bar
#: (tests/test_models.py:71).
LM_F32_TOL = 2e-2
#: The retrieval stage: act-2, top-3 (the serving example's).
LM_RETRIEVE = dict(method="act", iters=2, top_l=3)


def clone_tree(tree):
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def phase13_smoke(dev):
    """(a) Each architecture at smoke_config: weights drawn on the CPU, the
    same weights on the card, forward, prefill and 4 decode steps on both
    within 1e-4 (``parity.card_vs_cpu``); name -> max |card - CPU|."""
    errs = {}
    for name in ARCH_IDS:
        try:
            err = lm_parity.card_vs_cpu(smoke_config(name), dev)
        except AssertionError as e:
            check(False, f"phase 13 {name} smoke f32, card vs CPU: {e}")
        errs[name] = err
        print(f"phase 13: {name} smoke f32: card vs CPU max|d| forward "
              f"{err['forward']:.3g}, prefill {err['prefill']:.3g}, "
              f"{lm_parity.STEPS} decode steps {err['decode']:.3g}",
              flush=True)
    return errs


def p13_step(model, tokens, t, cache):
    return lm.decode_step(model, {"tokens": tokens, "cache_index": t}, cache)


def p13_decode_cache(model, prompts, upto, cap):
    """A float32 decode cache for ``cap`` past tokens holding ``prefill``'s
    caches of the first ``upto`` prompt tokens: the attention's K and V in
    slots 0 .. upto-1, the SSM state and conv window after token upto-1."""
    cfg = model.cfg
    _, caches = lm.prefill(model, {"tokens": prompts[:, :upto]})
    ssm, kv = {"ssm": (caches, None), "hybrid": caches}.get(
        cfg.family, (None, caches))
    cache = lm.init_decode_cache(cfg, prompts.shape[0], cap, torch.float32,
                                 device=prompts.device)
    with torch.no_grad():
        for name, t in (kv or {}).items():
            cache["attn"][name][..., :upto, :, :].copy_(t)
        for name, t in (ssm or {}).items():
            cache["ssm"][name].copy_(t)
    return cache


def p13_greedy(model, logits, cache, start):
    """LM_GEN greedy steps after ``start`` prompt tokens: (tokens (B, GEN),
    logits (GEN, B, vocab), ms a step at batch LM_BATCH)."""
    tok = logits[:, -1].argmax(dim=-1)[:, None]
    toks, outs = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(start, start + LM_GEN):
        toks.append(tok)
        logits, cache = p13_step(model, tok, t, cache)
        outs.append(logits[:, -1])
        tok = logits[:, -1].argmax(dim=-1)[:, None]
    torch.cuda.synchronize()
    return (torch.cat(toks, dim=1), torch.stack(outs),
            1e3 * (time.perf_counter() - t0) / LM_GEN)


#: Decode steps traced with torch.profiler for the device's share of a step.
LM_TRACED = 8


def p13_device_time(model, logits, cache, start):
    """LM_TRACED greedy steps after ``start`` under torch.profiler: (device
    ms a step, the union of the card's kernel, copy and set intervals;
    device operations a step). (None, None) where the trace holds no
    device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        for t in range(start, start + LM_TRACED):
            logits, cache = p13_step(model, tok, t, cache)
            tok = logits[:, -1].argmax(dim=-1)[:, None]
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return None, None
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3 / LM_TRACED, len(spans) / LM_TRACED


def phase13_full(name, dev):
    """(b), (c) One architecture at full width: bfloat16 weights from a
    torch.Generator on the card (seed 0), LM_BATCH prompts of LM_FULL[name]
    tokens; prefill, then prefill of all but the last LM_TAIL prompt tokens
    handed to a float32 decode cache and those LM_TAIL decoded token by
    token, LM_GEN greedy tokens twice from copies of that cache (bitwise),
    then a float32 copy of the weights the same way: decode_step against
    forward at each of the last LM_TAIL prompt positions, and its greedy
    tokens against the bfloat16 run's. Returns (figures, the bfloat16 run's
    prompts + continuations)."""
    P = LM_FULL[name]
    H = P - LM_TAIL
    cfg = get_config(name)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = lm.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.as_tensor(global_batch(DataConfig(
        vocab=cfg.vocab, seq_len=P, global_batch=LM_BATCH, seed=7),
        0)["tokens"], device=dev)
    batch = {"tokens": prompts}
    lm.prefill(model, batch)                              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits_p, caches = lm.prefill(model, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(bool(torch.isfinite(logits_p).all()),
          f"phase 13 {name}: non-finite prefill logits")
    peak_prefill = torch.cuda.max_memory_allocated() - base
    del caches
    cache = p13_decode_cache(model, prompts, H, P + LM_GEN)
    torch.cuda.reset_peak_memory_stats()
    finite = torch.ones((), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(H, P):
        logits, cache = p13_step(model, prompts[:, t:t + 1], t, cache)
        finite &= torch.isfinite(logits).all()
    torch.cuda.synchronize()
    prompt_ms = 1e3 * (time.perf_counter() - t0) / LM_TAIL
    # The last prompt position, decoded against prefill's (bfloat16: shown).
    last_d = float((logits[:, -1].float() - logits_p[:, -1].float()).abs()
                   .max())
    snap = clone_tree(cache)
    toks, outs, decode_ms = p13_greedy(model, logits, cache, P)
    toks2, outs2, _ = p13_greedy(model, logits, clone_tree(snap), P)
    finite &= torch.isfinite(outs).all()
    check(bool(finite), f"phase 13 {name}: a non-finite logit")
    check(torch.equal(toks, toks2) and torch.equal(outs, outs2),
          f"phase 13 {name}: a second greedy run from a copy of the cache "
          f"differs (tokens equal {torch.equal(toks, toks2)})")
    peak_decode = torch.cuda.max_memory_allocated() - base
    device_ms, device_ops = p13_device_time(model, logits, clone_tree(snap),
                                            P)
    del cache, snap, outs, outs2, toks2
    # A float32 copy of the same weights.
    model32 = copy.deepcopy(model).float()
    del model
    full32, _, _ = lm.forward(model32, batch)
    cache32 = p13_decode_cache(model32, prompts, H, P + LM_GEN)
    err = torch.zeros((), device=dev)
    for t in range(H, P):
        dl, cache32 = p13_step(model32, prompts[:, t:t + 1], t, cache32)
        err = torch.maximum(err, (dl[:, 0] - full32[:, t]).abs().max())
    err = float(err)
    del full32
    toks32, _, _ = p13_greedy(model32, dl, cache32, P)
    agree = float((toks == toks32).float().mean())
    check(err < LM_F32_TOL, f"phase 13 {name}: float32 decode_step vs "
          f"forward max |d| {err} not under {LM_F32_TOL}")
    del model32, cache32
    gib = 2**30
    out = dict(layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab,
               params=cfg.param_count(), prompt_len=P,
               prompt_decoded=LM_TAIL, batch=LM_BATCH,
               gen=LM_GEN, init_s=init_s, prefill_s=prefill_s,
               prompt_decode_ms_per_token=prompt_ms,
               decode_ms_per_token=decode_ms,
               decode_device_ms_per_step=device_ms,
               decode_device_ops_per_step=device_ops,
               peak_prefill_gib=peak_prefill / gib,
               peak_decode_gib=peak_decode / gib,
               last_prompt_vs_prefill_bf16=last_d, f32_decode_vs_forward=err,
               greedy_agreement_f32=agree, bitwise_repeat=True)
    print(f"phase 13: {name} full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.param_count() / 1e9:.2f} B params, bf16): "
          f"init {init_s:.2f} s; prefill {LM_BATCH} x {P} tokens "
          f"{prefill_s:.3f} s; prefill of the first {H} handed to the "
          f"decode cache, the last {LM_TAIL} token by token "
          f"{prompt_ms:.2f} ms a step; greedy decode {decode_ms:.2f} ms a "
          f"token at batch {LM_BATCH}, bitwise on a second run; the "
          f"card busy {device_ms} ms a step over {device_ops} device "
          f"operations a step ({LM_TRACED} steps traced); peak "
          f"above the {base / gib:.2f} GiB resident (weights included) "
          f"{peak_prefill / gib:.2f} GiB in prefill, "
          f"{peak_decode / gib:.2f} GiB in decode (the float32 cache, its "
          f"copy and the copy's copy); "
          f"last prompt logits vs prefill's max|d| {last_d:.3g} (bf16); "
          f"f32 copy: decode vs forward max|d| {err:.3g} over the last "
          f"{LM_TAIL} of {P} positions (bar {LM_F32_TOL}), greedy tokens agree with bf16 at "
          f"{agree:.3f}", flush=True)
    return out, torch.cat([prompts, toks], dim=1)


def phase13_retrieval(host_corpus, seqs, dev):
    """(d) The decoded sequences, modulo v, as EMD queries over phase 3's
    corpus: ``EmdIndex(backend="cuda")`` act-2 top-3 against the reference
    backend on the card, the launch counts set to 0 just before the search
    and read just after."""
    q = histogram.docs_to_corpus(list(seqs.cpu().numpy() % host_corpus.v),
                                 host_corpus.coords.numpy(), HMAX)
    qi, qw = q.ids.to(dev), q.w.to(dev)
    cuda_index = EmdIndex.build(host_corpus, EngineConfig(**LM_RETRIEVE),
                                device=dev)
    ref_index = EmdIndex.build(host_corpus, EngineConfig(
        backend="reference", **LM_RETRIEVE), device=dev)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_c, i_c = cuda_index.search(qi, qw)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    counts = read_counts()
    s_r, i_r = ref_index.search(qi, qw)
    full_c, full_r = cuda_index.scores(qi, qw), ref_index.scores(qi, qw)
    err = float((full_c - full_r).abs().max())
    check(torch.allclose(full_c, full_r, rtol=RTOL, atol=ATOL),
          f"phase 13 retrieval: cuda vs reference max |d| {err}")
    top = LM_RETRIEVE["top_l"]
    firm = firm_ranks(s_r, full_r.sort(dim=1).values[:, top])
    check(bool((i_c == i_r)[firm].all()),
          "phase 13 retrieval: top-3 ids differ at a separated rank")
    check(counts["dist_topk"] > 0 and counts["act_phase2_gather"] > 0,
          f"phase 13 retrieval launched {nonzero(counts)}")
    nbins = (qw > 0).sum(dim=1).tolist()
    print(f"phase 13: retrieval of {len(seqs)} decoded sequences "
          f"({seqs.shape[1]} tokens; {nbins} bins) over n={host_corpus.n}: "
          f"cuda vs reference max|d|={err:.3g}, top-{top} equal at "
          f"{int(firm.sum())} separated ranks of {firm.numel()}; "
          f"{search_s:.4f} s (first search of this index); launches "
          f"{nonzero(counts)}; neighbours {i_c.tolist()}", flush=True)
    return dict(max_abs_err=err, search_s=search_s, bins=nbins,
                launches=nonzero(counts), neighbours=i_c.tolist())


def phase13(host_corpus, dev):
    t_start = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls may use TF32")
    out = {"smoke": phase13_smoke(dev)}
    seqs = None
    for name in LM_FULL:
        out[name], s = phase13_full(name, dev)
        seqs = s if seqs is None else seqs
    out["retrieval"] = phase13_retrieval(host_corpus, seqs, dev)
    out["seconds"] = time.perf_counter() - t_start
    print(f"phase 13: done in {out['seconds']:.1f} s", flush=True)
    return out


# -------------------------------------------------------------- phase 14
# Slice 13: LM training on one card. (a) every architecture at smoke width
# under float32: one train step on the card against the port's CPU run on
# the same weights and batch (and smoke olmo at 1,536 tokens under full
# remat), the three remat settings on the card, and a
# FaultTolerantRunner run through two injected failures bitwise the
# failure-free one; (b) olmo-1b at full width with its config's bfloat16
# weights, float32 moments and full remat. Plain PyTorch again: the JAX
# package's training path is autodiff of the same LM stack (no custom_vjp,
# no pallas_call in models/ or optim/).
#: (b)'s batch: train_4k's 4,096-token rows, 4 of them (train_4k has 256).
TRAIN_SEQ, TRAIN_ROWS, TRAIN_ROWS_CELL = 4096, 4, 256
#: (b)'s warm-up and timed steps and their schedule.
TRAIN_TIMED = 8
TRAIN_OPT = dict(peak_lr=3e-4, warmup_steps=2, total_steps=TRAIN_TIMED)
#: (b)'s first loss within this of ln(vocab); n_micro=2 against 1: the
#: loss within TRAIN_MICRO_ATOL, the grad norm within TRAIN_MICRO_RTOL.
TRAIN_INIT_ATOL, TRAIN_MICRO_ATOL, TRAIN_MICRO_RTOL = 1.0, 1e-2, 1e-2
#: (a)'s replay: steps, and the steps whose first attempt fails.
TRAIN_REPLAY_STEPS, TRAIN_REPLAY_FAILS = 30, (7, 18)


def phase14_smoke(dev):
    """(a) name -> the largest |card - CPU| of one train step, and the
    remat settings' spread on the card; then the replay through failures.
    """
    out = {}
    for name in ARCH_IDS:
        cfg = smoke_config(name)
        try:
            err = lm_parity.train_card_vs_cpu(cfg, dev)
        except AssertionError as e:
            check(False, f"phase 14 {name} smoke f32 train step, card vs "
                  f"CPU: {e}")
        spread = lm_parity.remat_spread(cfg, dev)
        check(spread["full_loss"] < 1e-6 and spread["dots_loss"] < 1e-6
              and spread["full_grads"] < 1e-5
              and spread["dots_grads"] < 1e-5,
              f"phase 14 {name}: remat off / full / dots disagree on the "
              f"card: {spread}")
        out[name] = {"card_vs_cpu": err, "remat": spread}
        print(f"phase 14: {name} smoke f32 train step: card vs CPU max|d| "
              f"loss {err['loss']:.3g}, grad norm {err['grad_norm']:.3g}, "
              f"params {err['params']:.3g}, moments {err['moments']:.3g}; "
              f"remat full / dots vs off on the card: loss "
              f"{spread['full_loss']:.3g} / {spread['dots_loss']:.3g}, "
              f"grads {spread['full_grads']:.3g} / "
              f"{spread['dots_grads']:.3g}", flush=True)
    for label, window in lm_parity.LONG_WINDOWS.items():
        try:
            err = lm_parity.train_card_vs_cpu(
                lm_parity.long_config(window), dev, lm_parity.LONG_SEQ,
                lm_parity.LONG_BATCH)
        except AssertionError as e:
            check(False, f"phase 14 olmo-1b smoke f32 train step at "
                  f"{lm_parity.LONG_SEQ} tokens ({label}), card vs CPU: {e}")
        out[f"long_{label}"] = err
        print(f"phase 14: olmo-1b smoke f32 train step, {lm_parity.LONG_BATCH}"
              f" x {lm_parity.LONG_SEQ} tokens (the chunked attention), "
              f"remat full, {label} (window {window}): card vs CPU max|d| "
              f"loss {err['loss']:.3g}, grad norm {err['grad_norm']:.3g}, "
              f"params {err['params']:.3g}, moments {err['moments']:.3g}",
              flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_replay_") as tmp:
        try:
            restarts, losses = lm_parity.replay_bitwise(
                smoke_config("olmo-1b"), dev, tmp, TRAIN_REPLAY_STEPS,
                TRAIN_REPLAY_FAILS)
        except AssertionError as e:
            check(False, f"phase 14 replay: {e}")
    secs = time.perf_counter() - t0
    out["replay"] = dict(steps=TRAIN_REPLAY_STEPS, restarts=restarts,
                         bitwise=True, first_loss=losses[0],
                         last_loss=losses[-1], seconds=secs)
    print(f"phase 14: olmo-1b smoke, {TRAIN_REPLAY_STEPS} steps under "
          f"FaultTolerantRunner with failures at steps "
          f"{list(TRAIN_REPLAY_FAILS)}: {restarts} restarts, bitwise the "
          f"failure-free run on the card (params, moments, step); loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; both runs {secs:.1f} s",
          flush=True)
    return out


def p14_step(step, model, opt, batch):
    """One timed train step: (opt, metrics, seconds, host floats)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, opt, metrics = step(model, opt, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return opt, {k: float(v) for k, v in metrics.items()}, secs


#: Kernel-name fragments of the card's matmuls (cuBLAS, its Hopper
#: ``nvjet`` kernels, CUTLASS).
MATMUL_KERNELS = ("gemm", "Gemm", "cutlass", "xmma", "cublas", "nvjet")
#: Kernels of most device time that the traced step names.
TRACE_TOP = 8


def p14_trace(step, model, opt, batch):
    """One train step under torch.profiler: (opt, a dict of the traced
    step's own wall ms (host clock, synchronized, the profiler's overhead
    included), the card's busy ms (the union of its kernel, copy and set
    intervals), its matmul kernels' ms, device operations and the
    TRACE_TOP kernels of most device time as (name, ms)); the device keys
    are None where the trace holds no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, opt, _ = step(model, opt, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return opt, dict(wall_ms=wall_ms, busy_ms=None, matmul_ms=None,
                         device_ops=None, top=None)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name = collections.Counter()
    for e in events:
        by_name[e.name] += e.time_range.end - e.time_range.start
    matmul = sum(t for n, t in by_name.items()
                 if any(f in n for f in MATMUL_KERNELS))
    top = [(n[:100], t / 1e3) for n, t in by_name.most_common(TRACE_TOP)]
    return opt, dict(wall_ms=wall_ms, busy_ms=busy / 1e3,
                     matmul_ms=matmul / 1e3, device_ops=len(events), top=top)


def phase14_full(dev):
    """(b) olmo-1b at full width: 1 warm-up and TRAIN_TIMED timed steps of
    TRAIN_ROWS x TRAIN_SEQ tokens, then the next batch's step at
    n_micro=2 and at 1 from the same parameters, then one step under
    remat_policy="dots" for its peak."""
    from repro_torch.launch import steps as train_steps
    from repro_torch.models.config import InputShape
    from repro_torch.optim import adamw
    cfg = get_config("olmo-1b")
    check(cfg.remat and cfg.remat_policy == "full"
          and cfg.param_dtype == "bfloat16"
          and cfg.opt_state_dtype == "float32",
          f"phase 14: olmo-1b's config is not bf16 / f32 moments / full "
          f"remat: {cfg}")
    gc.collect()
    torch.cuda.empty_cache()
    base0 = torch.cuda.memory_allocated()
    model = lm.init(cfg, seed=0, device=dev)
    params = dict(model.named_parameters())
    opt = adamw.init(params, cfg.opt_state_dtype)
    n_params = sum(p.numel() for p in params.values())
    check(n_params == cfg.param_count(),
          f"phase 14: {n_params} parameters, config says "
          f"{cfg.param_count()}")
    shape = InputShape("train_4k", TRAIN_SEQ, TRAIN_ROWS, "train")
    opt_cfg = adamw.AdamWConfig(**TRAIN_OPT)
    step1 = train_steps.make_train_step(shape, opt_cfg, n_micro=1)
    step2 = train_steps.make_train_step(shape, opt_cfg, n_micro=2)
    dc = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                    global_batch=TRAIN_ROWS, seed=0)

    def batch(i):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in global_batch(dc, i).items()}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, secs, norms = [], [], []
    for i in range(1 + TRAIN_TIMED):
        b = batch(i)
        opt, m, dt = p14_step(step1, model, opt, b)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        secs.append(dt)
    peak_full = torch.cuda.max_memory_allocated() - resident
    ln_v = float(np.log(cfg.vocab))
    check(all(np.isfinite(losses)), f"phase 14: a non-finite loss {losses}")
    check(abs(losses[0] - ln_v) < TRAIN_INIT_ATOL,
          f"phase 14: step 1's loss {losses[0]} not within "
          f"{TRAIN_INIT_ATOL} of ln {cfg.vocab} = {ln_v}")
    check(losses[-1] < losses[0],
          f"phase 14: the loss did not fall: {losses}")
    # The next batch from the same parameters at n_micro=2, then 1.
    b = batch(1 + TRAIN_TIMED)
    snap = {k: p.detach().clone() for k, p in params.items()}
    opt, m2, dt2 = p14_step(step2, model, opt, b)
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(snap[k])
    del snap
    opt, m1, dt1 = p14_step(step1, model, opt, b)
    check(abs(m2["loss"] - m1["loss"]) < TRAIN_MICRO_ATOL
          and abs(m2["grad_norm"] - m1["grad_norm"])
          < TRAIN_MICRO_RTOL * m1["grad_norm"],
          f"phase 14: n_micro=2 loss {m2['loss']} grad norm "
          f"{m2['grad_norm']} against n_micro=1 {m1['loss']} "
          f"{m1['grad_norm']}")
    # One step under remat_policy="dots" (saving the projections).
    model.cfg = dataclasses.replace(cfg, remat_policy="dots")
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    opt, md, dtd = p14_step(step1, model, opt, batch(2 + TRAIN_TIMED))
    peak_dots = torch.cuda.max_memory_allocated() - resident
    check(np.isfinite(md["loss"]), f"phase 14: dots loss {md['loss']}")
    model.cfg = cfg
    # One more step (remat full) traced: where the card's time goes.
    opt, trace = p14_trace(step1, model, opt, batch(3 + TRAIN_TIMED))
    if trace["busy_ms"] is not None:
        trace["idle_share"] = 1.0 - trace["busy_ms"] / trace["wall_ms"]
    gib = 2**30
    step_s = statistics.median(secs[1:])
    tokens = TRAIN_ROWS * TRAIN_SEQ
    flop = 6.0 * cfg.param_count() * tokens
    out = dict(params=n_params, rows=TRAIN_ROWS, seq=TRAIN_SEQ,
               rows_cut_from=TRAIN_ROWS_CELL, opt=TRAIN_OPT, losses=losses,
               grad_norms=norms, seconds=secs, step_s_median=step_s,
               tokens_per_s=tokens / step_s, flop_6nd_per_step=flop,
               tflops_6nd=flop / step_s / 1e12,
               resident_gib=(resident - base0) / gib,
               peak_above_resident_gib=peak_full / gib,
               n_micro2=dict(loss=m2["loss"], grad_norm=m2["grad_norm"],
                             s=dt2),
               n_micro1=dict(loss=m1["loss"], grad_norm=m1["grad_norm"],
                             s=dt1),
               dots=dict(loss=md["loss"], s=dtd,
                         peak_above_resident_gib=peak_dots / gib),
               trace=trace)
    print(f"phase 14: olmo-1b full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n_params / 1e9:.3f} B params, bf16 weights, "
          f"f32 moments, remat full): batch {TRAIN_ROWS} x {TRAIN_SEQ} "
          f"tokens of train_4k (rows cut from {TRAIN_ROWS_CELL} to "
          f"{TRAIN_ROWS} for time and memory), AdamW {TRAIN_OPT}", flush=True)
    print(f"phase 14: losses {[round(x, 4) for x in losses]} (ln V = "
          f"{ln_v:.4f}); step seconds {[round(x, 3) for x in secs]} "
          f"(first is the warm-up); median {step_s:.3f} s a step, "
          f"{tokens / step_s:.0f} tokens/s, 6ND = {flop / 1e12:.1f} TFLOP "
          f"a step -> {flop / step_s / 1e12:.1f} TFLOP/s; resident "
          f"{(resident - base0) / gib:.2f} GiB (weights, moments), peak "
          f"above it {peak_full / gib:.2f} GiB (remat full), "
          f"{peak_dots / gib:.2f} GiB (remat dots, {dtd:.3f} s)", flush=True)
    print(f"phase 14: n_micro=2 loss {m2['loss']:.5f} grad norm "
          f"{m2['grad_norm']:.5f} ({dt2:.3f} s) against n_micro=1 "
          f"{m1['loss']:.5f} {m1['grad_norm']:.5f} ({dt1:.3f} s)",
          flush=True)
    print(f"phase 14: a traced step (remat full): {trace['wall_ms']:.1f} "
          f"ms on the host clock (under the profiler), the card busy "
          f"{trace['busy_ms']} ms of it over {trace['device_ops']} device "
          f"operations (idle share {trace.get('idle_share')}), "
          f"{trace['matmul_ms']} ms in matmul kernels; most device time: "
          f"{trace['top']}", flush=True)
    del model, opt, params
    return out


def phase14(dev):
    t_start = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls may use TF32")
    out = {"smoke": phase14_smoke(dev), "olmo-1b": phase14_full(dev)}
    out["seconds"] = time.perf_counter() - t_start
    print(f"phase 14: done in {out['seconds']:.1f} s", flush=True)
    return out


# ----------------------------------------------------------------------------
# Phase 15: LM training on a (data, model) mesh
# ----------------------------------------------------------------------------
# (a) olmo-1b whole (16 layers) on a 1x1 NCCL mesh, the mesh step against
# phase 14's single-card step; (b) a 2x2 gloo world whose four ranks share
# the card, olmo-1b at full width with its depth cut to P15_LAYERS, modes
# tp and fsdp against a 1x1 step, then re-planned 1x4 and restored from the
# 2x2 checkpoint; (c) mixtral at smoke width, expert-parallel over the 1x4
# mesh against the plain path. No kernel of its own (the kernels line is
# phases 2-13's): the mesh step is plain PyTorch and collectives.
#: (b)'s depth: cut from olmo-1b's 16 layers so that the whole script,
#: phases 1-14 and 16 included, runs within 1,200 s (a 16-layer 2x2 step
#: moves eight times the bytes through gloo's host staging, and its
#: checkpoint is 11.8 GB).
P15_LAYERS = 2
#: (b)'s steps a mode: b0 held to the 1x1 step, then P15_TIMED timed.
P15_TIMED = 2
#: Bars against a 1x1 step on bfloat16 weights (test_torch_train's
#: BF16_LOSS_ATOL: two orders of bf16 summation, here split batch rows,
#: round the loss apart by up to ~3e-3); a parameter after one AdamW step
#: moves by about lr x sign(g), so a gradient near 0 whose sign flips
#: between two summation orders moves it by up to 2 lr: the bar is that
#: plus one bfloat16 ulp.
P15_LOSS_ATOL, P15_LR_FLIPS = 2e-2, 2.0
#: The grad norm against a 1x1 step's: each rank's whole-leaf gradient is
#: a bfloat16 partial over its rows (the embedding's accumulates its
#: token rows in bfloat16), summed in bfloat16 over the batch ranks;
#: twice test_torch_train's bfloat16 norm bar (1e-2).
P15_NORM_RTOL = 2e-2
#: (c): smoke mixtral's batch, and its bars against the plain path
#: (test_torch_mesh_train's: float32).
P15_EP_ROWS, P15_EP_SEQ, P15_EP_RTOL, P15_EP_LR_FRACTION = 4, 64, 1e-4, 0.25
#: (c)'s runs: name -> (remat policy, torch's checkpoint early stop). With
#: the early stop (torch's default) the recomputation ends before a
#: block's last all-reduce; without it, "full" sums the partial outputs
#: again and "dots" does not (it saves ``moe_out``).
P15_EP = {"dots": ("dots", True), "full": ("full", True),
          "dots, no early stop": ("dots", False),
          "full, no early stop": ("full", False)}
P15_TIMEOUT = 900.0


def p15_batches(cfg, n, rows=TRAIN_ROWS, seq=TRAIN_SEQ):
    dc = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=rows, seed=0)
    return [{k: torch.as_tensor(v) for k, v in global_batch(dc, i).items()}
            for i in range(n)]


def p15_timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


#: A float dtype's bits as an integer dtype, and the mask of its magnitude.
FLOAT_BITS = {torch.bfloat16: (torch.int16, 0x7FFF),
              torch.float32: (torch.int32, 0x7FFFFFFF)}


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units in the last place of their (bfloat16 or float32)
    dtype, element by element (+0 and -0 equal)."""
    it, mag = FLOAT_BITS[a.dtype]

    def ordered(x):
        i = x.contiguous().view(it).long()
        return torch.where(i < 0, -(i & mag), i)
    return (ordered(a) - ordered(b)).abs()


def ulp_at(w: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of ``w``'s dtype at |w|, in float32."""
    it, mag = FLOAT_BITS[w.dtype]
    i = w.contiguous().view(it) & mag
    return (i + 1).view(w.dtype).float() - i.view(w.dtype).float()


def p15_compare(got: dict, want: dict, lr: float) -> dict:
    """Parameters {name: tensor} against the reference's: the largest
    ulps apart, the share bitwise equal, the share more than 1 ulp apart,
    and the largest |d| over the bar P15_LR_FLIPS * lr + 1 ulp at the
    larger magnitude (must be <= 1)."""
    worst_ulps, same, far, n, over = 0, 0, 0, 0, 0.0
    for name, w in want.items():
        g, w = got[name].detach(), w.detach()
        u = ulps(g, w)
        worst_ulps = max(worst_ulps, int(u.max()))
        same += int((u == 0).sum())
        far += int((u > 1).sum())
        n += u.numel()
        bar = P15_LR_FLIPS * lr + ulp_at(torch.maximum(g.abs(), w.abs()))
        over = max(over, float(((g.float() - w.float()).abs() / bar).max()))
    return dict(max_ulps=worst_ulps, bitwise_share=same / n,
                beyond_1ulp_share=far / n, of_bar=over)


def phase15_one(mesh):
    """(a) One rank of a 1x1 NCCL mesh: olmo-1b whole, the mesh step
    (1 warm-up, P15_TIMED timed) from seed 0, and phase 14's single-card
    step from the same parameters on the warm-up's batch: loss, grad norm
    and every parameter after it."""
    from repro_torch.launch import steps as St
    from repro_torch.models.config import InputShape
    from repro_torch.optim import adamw
    from repro_torch.sharding import annotate
    cfg = get_config("olmo-1b")
    shape = InputShape("train_4k", TRAIN_SEQ, TRAIN_ROWS, "train")
    opt_cfg = adamw.AdamWConfig(**TRAIN_OPT)
    batches = p15_batches(cfg, 1 + P15_TIMED)
    model = lm.init(cfg, seed=0, device=mesh.device)
    state = St.MeshTrainState.from_model(model, mesh, "tp")
    opt = adamw.init(dict(model.named_parameters()), cfg.opt_state_dtype)
    mesh_step = St.make_mesh_train_step(shape, mesh, opt_cfg=opt_cfg,
                                        n_micro=1)
    one_step = St.make_train_step(shape, opt_cfg, n_micro=1)
    annotate.reset_traffic()
    _, warm = p15_timed(lambda: mesh_step(state, batches[0]))
    got = {k: float(v) for k, v in state.metrics.items()}
    (_, opt, m), single = p15_timed(lambda: one_step(model, opt, batches[0]))
    want = {k: float(v) for k, v in m.items()}
    cmp = p15_compare(state.blocks, dict(model.named_parameters()),
                      want["lr"])
    loss_bitwise = bool(torch.equal(state.metrics["loss"], m["loss"]))
    secs = []
    for b in batches[1:]:
        _, dt = p15_timed(lambda b=b: mesh_step(state, b))
        secs.append(dt)
    (_, opt, _), single2 = p15_timed(lambda: one_step(model, opt,
                                                      batches[1]))
    return dict(mesh=got, single=want, loss_bitwise=loss_bitwise,
                params=cmp, warm_s=warm, mesh_s=secs,
                single_s=[single, single2], traffic=annotate.traffic(),
                losses=[got["loss"], float(state.metrics["loss"])])


def p15_mode(mesh, cfg, mode, ref_dir, batches, ckpt_dir=None):
    """One mode of (b) on this rank: the state from seed 0, step b0
    against the 1x1 reference (its parameters' blocks read from
    ``ref_dir``), P15_TIMED timed steps with each one's bytes by label;
    resident and peak GiB. With ``ckpt_dir``: a checkpoint at the step
    reached, then the next batch's step (the 2x2 continuation); returns
    the state too."""
    from repro_torch.launch import steps as St
    from repro_torch.models.config import InputShape
    from repro_torch.optim import adamw
    from repro_torch.runtime import elastic
    from repro_torch.sharding import annotate
    shape = InputShape("train_4k", TRAIN_SEQ, TRAIN_ROWS, "train")
    step = St.make_mesh_train_step(shape, mesh, mode=mode,
                                   opt_cfg=adamw.AdamWConfig(**TRAIN_OPT),
                                   n_micro=1)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = St.MeshTrainState.init(cfg, mesh, mode, seed=0)
    gc.collect()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    _, first = p15_timed(lambda: step(state, batches[0]))
    ref = elastic.restore_on_mesh(ref_dir, 1, state.layout, mesh, mode)
    out = dict(first_s=first, first_loss=float(state.metrics["loss"]),
               first_norm=float(state.metrics["grad_norm"]),
               vs_ref=p15_compare(state.blocks, ref,
                                  float(state.metrics["lr"])),
               resident_gib=resident / 2**30, seconds=[], bytes=[],
               losses=[float(state.metrics["loss"])])
    del ref
    for b in batches[1:1 + P15_TIMED]:
        annotate.reset_traffic()
        _, dt = p15_timed(lambda b=b: step(state, b))
        out["seconds"].append(dt)
        out["bytes"].append(annotate.traffic())
        out["losses"].append(float(state.metrics["loss"]))
    out["peak_above_gib"] = (torch.cuda.max_memory_allocated() - base
                             - resident) / 2**30
    out["blocks"] = sum(b.numel() for b in state.blocks.values())
    if ckpt_dir is None:
        del state
        return out
    at = 1 + P15_TIMED
    annotate.reset_traffic()
    _, out["save_s"] = p15_timed(lambda: state.save(ckpt_dir, at))
    out["save_bytes"] = annotate.traffic()
    step(state, batches[at])
    out["continuation_loss"] = float(state.metrics["loss"])
    return out, state


def p15_ep(mesh, policy, early_stop):
    """(c) on this rank of the 1x4 mesh: smoke mixtral with moe_shard_map,
    remat ``policy`` (torch's recomputation stopping early or not), one
    mesh step against the plain path's single-card step from the same
    weights; this rank's blocks against the plain step's slices; the
    ``moe_out`` and ``moe_in`` bytes."""
    from repro_torch.launch import steps as St
    from repro_torch.models.config import InputShape
    from repro_torch.optim import adamw
    from repro_torch.sharding import annotate, rules
    from torch.utils import checkpoint as remat_ckpt
    cfg = dataclasses.replace(smoke_config("mixtral-8x22b"),
                              moe_shard_map=True, remat=True,
                              remat_policy=policy)
    shape = InputShape("t", P15_EP_SEQ, P15_EP_ROWS, "train")
    opt_cfg = adamw.AdamWConfig(**TRAIN_OPT)
    b = p15_batches(cfg, 1, P15_EP_ROWS, P15_EP_SEQ)[0]
    model = lm.init(cfg, seed=0, device=mesh.device)
    opt = adamw.init(dict(model.named_parameters()), cfg.opt_state_dtype)
    _, _, want = St.make_train_step(shape, opt_cfg, n_micro=1)(model, opt, b)
    state = St.MeshTrainState.init(cfg, mesh, "tp", seed=0)
    check(all(m.ep_mesh is mesh for m in state.model.modules()
              if isinstance(m, lm_layers.MoE)),
          "phase 15 (c): a MoE layer without the expert-parallel path")
    step = St.make_mesh_train_step(shape, mesh, opt_cfg=opt_cfg, n_micro=1)
    annotate.reset_traffic()
    with remat_ckpt.set_checkpoint_early_stop(early_stop):
        step(state, b)
    moved = annotate.traffic()
    lr = float(want["lr"])
    worst = 0.0
    for name, p in model.named_parameters():
        sl = rules.block_slices(p.shape, state.specs[name], mesh)
        d = (state.blocks[name].detach() - p.detach()[sl]).abs().max()
        worst = max(worst, float(d) / (P15_EP_LR_FRACTION * lr))
    return dict(loss=float(state.metrics["loss"]), want_loss=float(
        want["loss"]), norm=float(state.metrics["grad_norm"]),
        want_norm=float(want["grad_norm"]), params_of_bar=worst,
        expert_rows=int(state.blocks["blocks.0.moe.w_up"].shape[0]),
        moe_out=moved.get("moe_out", 0), moe_in=moved.get("moe_in", 0),
        bytes=moved)


def phase15_world(mesh, ref_dir, ckpt_dir):
    """(b) and (c) on one rank of a 2x2 gloo world sharing the card."""
    from repro_torch.launch.mesh import join_mesh, plan_mesh
    from repro_torch.launch import steps as St
    from repro_torch.models.config import InputShape
    from repro_torch.optim import adamw
    from repro_torch.runtime import elastic
    cfg = dataclasses.replace(get_config("olmo-1b"), n_layers=P15_LAYERS)
    batches = p15_batches(cfg, 2 + P15_TIMED)
    out = {"coords": {a: mesh.index(a) for a in ("data", "model")},
           "tp": p15_mode(mesh, cfg, "tp", ref_dir, batches)}
    out["fsdp"], state = p15_mode(mesh, cfg, "fsdp", ref_dir, batches,
                                  ckpt_dir)
    # The same world re-planned as 1x4: the 2x2 checkpoint's blocks.
    wide = join_mesh(plan_mesh(1, 4, backend="gloo", device=mesh.device))
    at = 1 + P15_TIMED
    (restored, restore_s) = p15_timed(lambda: elastic.restore_on_mesh(
        ckpt_dir, at, state, wide, "fsdp"))
    del state
    step = St.make_mesh_train_step(
        InputShape("train_4k", TRAIN_SEQ, TRAIN_ROWS, "train"), wide,
        mode="fsdp", opt_cfg=adamw.AdamWConfig(**TRAIN_OPT), n_micro=1)
    counter = int(restored.opt["step"])
    _, dt = p15_timed(lambda: step(restored, batches[at]))
    out["restore_1x4"] = dict(restore_s=restore_s, step_s=dt,
                              loss=float(restored.metrics["loss"]),
                              step=counter)
    del restored, step
    gc.collect()
    torch.cuda.empty_cache()
    out["ep"] = {name: p15_ep(wide, *run) for name, run in P15_EP.items()}
    return out


def p15_predict(cfg, mode, n_layers):
    """GiB a rank of a 2x2 mesh holds in ``mode`` at ``n_layers`` by the
    rules: its blocks of the bfloat16 weights and the two float32
    moments."""
    from repro_torch.launch.mesh import plan_mesh
    from repro_torch.sharding import rules
    layout = lm.init(dataclasses.replace(cfg, n_layers=n_layers),
                     device="meta")
    plan = plan_mesh(2, 2)
    specs = rules.model_specs(layout, plan, mode)
    moment = torch.empty((), dtype=getattr(torch, cfg.opt_state_dtype))
    total = 0
    for name, p in layout.named_parameters():
        parts = math.prod(plan.size(a) for a in rules.spec_axes(specs[name]))
        total += p.numel() // parts * (p.element_size()
                                       + 2 * moment.element_size())
    return total / 2**30


def phase15(dev, smi):
    """Phase 15: (a) on a 1x1 NCCL mesh, (b) and (c) on a 2x2 gloo world
    (module comment above P15_LAYERS)."""
    from repro_torch.checkpoint import store
    from repro_torch.launch import steps as train_steps
    from repro_torch.models import convert
    from repro_torch.models.config import InputShape
    from repro_torch.optim import adamw
    t_start = time.perf_counter()
    tag = f"[{smi}]"
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    # (a) olmo-1b whole on a 1x1 NCCL mesh against the single-card step.
    t0 = time.perf_counter()
    a, = run_local(phase15_one, 1, 1, backend="nccl", device="cuda",
                   timeout=P15_TIMEOUT)
    a["wall_s"] = time.perf_counter() - t0
    out["1x1"] = a
    d_loss = abs(a["mesh"]["loss"] - a["single"]["loss"])
    check(d_loss <= P15_LOSS_ATOL and a["params"]["max_ulps"] <= 1
          and abs(a["mesh"]["grad_norm"] - a["single"]["grad_norm"])
          <= TRAIN_MICRO_RTOL * a["single"]["grad_norm"]
          and all(np.isfinite(a["losses"])),
          f"phase 15 (a): the 1x1 mesh step against the single-card step: "
          f"{a}")
    check(not a["traffic"], f"phase 15 (a): bytes crossed a one-rank mesh: "
          f"{a['traffic']}")
    print(f"phase 15: (a) olmo-1b whole ({get_config('olmo-1b').n_layers} "
          f"layers, d_model 2048, vocab 50,304, bf16 weights, f32 moments, "
          f"remat full), {TRAIN_ROWS} x {TRAIN_SEQ} tokens, mode tp, on a "
          f"1x1 NCCL mesh (one rank: no collective moves a byte): loss "
          f"{a['mesh']['loss']:.6f} against the single-card step's "
          f"{a['single']['loss']:.6f} ({'bitwise' if a['loss_bitwise'] else f'|d| {d_loss:.3g}'}), "
          f"grad norm {a['mesh']['grad_norm']:.6f} / "
          f"{a['single']['grad_norm']:.6f}; parameters after it "
          f"{a['params']['max_ulps']} bf16 ulp apart at most, "
          f"{100 * a['params']['bitwise_share']:.4f} % bitwise; seconds a "
          f"step: mesh warm-up {a['warm_s']:.3f}, timed "
          f"{[round(x, 3) for x in a['mesh_s']]}, single card "
          f"{[round(x, 3) for x in a['single_s']]} {tag}", flush=True)
    # (b)'s reference: a 1x1 step at (b)'s depth and batch, on this card.
    cfg = dataclasses.replace(get_config("olmo-1b"), n_layers=P15_LAYERS)
    batch = p15_batches(cfg, 1)[0]
    model = lm.init(cfg, seed=0, device=dev)
    opt = adamw.init(dict(model.named_parameters()), cfg.opt_state_dtype)
    step = train_steps.make_train_step(
        InputShape("train_4k", TRAIN_SEQ, TRAIN_ROWS, "train"),
        adamw.AdamWConfig(**TRAIN_OPT), n_micro=1)
    (_, _, m), ref_s = p15_timed(lambda: step(model, opt, batch))
    ref = {k: float(v) for k, v in m.items()}
    ref_dir = tempfile.mkdtemp(prefix="chip_smoke_p15_ref_")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_p15_ckpt_")
    store.save(ref_dir, 1, convert.to_tree(
        model, {n: p.detach() for n, p in model.named_parameters()}))
    del model, opt, m, step
    gc.collect()
    torch.cuda.empty_cache()
    predicted = {mode: {"cut": p15_predict(cfg, mode, P15_LAYERS),
                        "whole": p15_predict(cfg, mode, 16)}
                 for mode in ("tp", "fsdp")}
    print(f"phase 15: (b) olmo-1b at full width, depth cut from 16 to "
          f"{P15_LAYERS} layers (a 2x2 step stages every gathered leaf and "
          f"gradient through the host for four ranks on one card, and the "
          f"whole model's checkpoint is 11.8 GB: the script must end within "
          f"1,200 s, phases 1-14 included); the 1x1 step at that depth: "
          f"loss {ref['loss']:.6f}, grad norm {ref['grad_norm']:.6f}, "
          f"{ref_s:.3f} s {tag}", flush=True)
    t0 = time.perf_counter()
    try:
        world = run_local(phase15_world, 2, 2, backend="gloo", device="cuda",
                          args=(ref_dir, ckpt_dir), timeout=P15_TIMEOUT)
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    wall = time.perf_counter() - t0
    for mode in ("tp", "fsdp"):
        runs = [r[mode] for r in world]
        check(all(r["losses"] == runs[0]["losses"] for r in runs),
              f"phase 15 (b) {mode}: the ranks' losses differ")
        r0 = runs[0]
        check(abs(r0["first_loss"] - ref["loss"]) <= P15_LOSS_ATOL
              and abs(r0["first_norm"] - ref["grad_norm"])
              <= P15_NORM_RTOL * ref["grad_norm"]
              and all(r["vs_ref"]["of_bar"] <= 1.0 for r in runs)
              and all(np.isfinite(r0["losses"])),
              f"phase 15 (b) {mode} against the 1x1 step: {runs}")
        print(f"phase 15: (b) 2x2 gloo ({mode}, the four ranks share the "
              f"card, gloo staging through the host): step 1 loss "
              f"{r0['first_loss']:.6f} (1x1 {ref['loss']:.6f}, |d| "
              f"{abs(r0['first_loss'] - ref['loss']):.3g}), grad norm "
              f"{r0['first_norm']:.6f} (|d| "
              f"{abs(r0['first_norm'] - ref['grad_norm']) / ref['grad_norm']:.3g}"
              f" of it); parameters against the 1x1 step's: "
              f"{100 * min(r['vs_ref']['bitwise_share'] for r in runs):.4f} % "
              f"bitwise, {100 * max(r['vs_ref']['beyond_1ulp_share'] for r in runs):.4f} % "
              f"more than 1 bf16 ulp apart, the largest "
              f"{max(r['vs_ref']['of_bar'] for r in runs):.3g} of "
              f"{P15_LR_FLIPS:g} lr + 1 ulp; losses "
              f"{[round(x, 5) for x in r0['losses']]}; "
              f"predicted resident {predicted[mode]['cut']:.3f} GiB a rank "
              f"({predicted[mode]['whole']:.3f} at 16 layers) {tag}",
              flush=True)
        for r, run in enumerate(runs):
            per_step = {k: int(np.mean([b.get(k, 0) for b in run["bytes"]]))
                        for k in sorted(set().union(*run["bytes"]))}
            print(f"phase 15: (b) {mode} rank {r} {world[r]['coords']}: "
                  f"resident {run['resident_gib']:.3f} GiB, peak "
                  f"{run['peak_above_gib']:.3f} GiB above it, seconds a "
                  f"step {[round(x, 3) for x in run['seconds']]} (step 1 "
                  f"{run['first_s']:.3f}), bytes received a step {per_step} "
                  f"{tag}", flush=True)
    fs = [r["fsdp"] for r in world]
    rs = [r["restore_1x4"] for r in world]
    at = 1 + P15_TIMED
    check(all(abs(x["loss"] - f["continuation_loss"]) <= P15_LOSS_ATOL
              and x["step"] == at for x, f in zip(rs, fs)),
          f"phase 15 (b) restore on 1x4: {rs} against {fs}")
    print(f"phase 15: (b) checkpoint of the 2x2 fsdp state at step {at}: "
          f"{fs[0]['save_s']:.2f} s (the leader receives "
          f"{fs[0]['save_bytes']} bytes); the world re-planned 1x4 "
          f"(plan_mesh / join_mesh), restore_on_mesh {rs[0]['restore_s']:.2f}"
          f" s a rank, the next step's loss {rs[0]['loss']:.6f} against the "
          f"2x2 continuation's {fs[0]['continuation_loss']:.6f} (|d| "
          f"{abs(rs[0]['loss'] - fs[0]['continuation_loss']):.3g}), "
          f"{rs[0]['step_s']:.3f} s {tag}", flush=True)
    layer_bytes = 3 * P15_EP_ROWS * P15_EP_SEQ * 4 * smoke_config(
        "mixtral-8x22b").d_model * smoke_config("mixtral-8x22b").n_layers
    for policy, (_, early) in P15_EP.items():
        eps = [r["ep"][policy] for r in world]
        e0 = eps[0]
        check(all(abs(e["loss"] - e["want_loss"]) <= P15_EP_RTOL
                  * abs(e["want_loss"])
                  and abs(e["norm"] - e["want_norm"]) <= P15_EP_RTOL
                  * e["want_norm"] and e["params_of_bar"] <= 1.0
                  and e["expert_rows"] == 1
                  and e["moe_out"] == layer_bytes * (
                      2 if policy == "full, no early stop" else 1)
                  for e in eps),
              f"phase 15 (c) {policy}: the expert-parallel step against the "
              f"plain path: {eps}")
        print(f"phase 15: (c) mixtral smoke (4 experts over model = 4, one "
              f"packed row a rank) moe_shard_map, remat {policy}, 1x4 gloo "
              f"on the card: loss {e0['loss']:.6f} against the plain path's "
              f"{e0['want_loss']:.6f}, grad norm {e0['norm']:.6f} / "
              f"{e0['want_norm']:.6f}, parameters at most "
              f"{max(e['params_of_bar'] for e in eps):.3g} of "
              f"{P15_EP_LR_FRACTION} lr; moe_out {e0['moe_out']} bytes "
              f"({e0['moe_out'] / layer_bytes:g} all-reduce a layer), moe_in "
              f"{e0['moe_in']} a rank a step {tag}", flush=True)
    out["2x2"] = dict(reference=ref, reference_s=ref_s, predicted=predicted,
                      layers=P15_LAYERS, wall_s=wall, ranks=world)
    out["seconds"] = time.perf_counter() - t_start
    print(f"phase 15: done in {out['seconds']:.1f} s {tag}", flush=True)
    return out


# ----------------------------------------------------------------------------
# Phase 16: LM prefill and decode on a (data, model) mesh
# ----------------------------------------------------------------------------
# (a) olmo-1b whole on a 1x1 NCCL mesh against the single card, bitwise;
# (b) olmo-1b at full width with its depth cut to P16_LAYERS on a 2x2 gloo
# world sharing the card (Megatron TP over the rules' heads, ffn and
# vocabulary, the rank's heads of the cache) against the single card at
# that depth; (c) the sequence-parallel cache at smoke width on a 1x4 gloo
# world at batch 1. No kernel of its own: plain PyTorch and collectives.
#: (b)'s depth: cut from olmo-1b's 16 layers (as phase 15 (b)): a decode
#: step gathers each TP block over ``data`` through gloo's host staging.
P16_LAYERS = 4
#: Greedy decode steps after the prompt (phase 13's 4 prompts of 2,048).
P16_STEPS = 16
#: (b)'s bar: its logits no farther from those of a float32 copy of the
#: weights than the single card's bfloat16 logits are, plus 2e-2
#: (test_torch_mesh_train's bf16 loss bar, as phase 15 (b)). Two bfloat16
#: runs that round in another order (the mesh's ranks take 2 rows and half
#: the heads: other GEMM shapes, and partial sums over ``model``) differ by
#: that band, not by 2e-2: 0.057 at most between the single card and its
#: float32 copy at this width and depth in a CPU rehearsal.
P16_LOGITS_ATOL = 2e-2
#: (c): smoke gemma3 (2 KV heads, which 4 model ranks do not divide: the
#: cache splits its sequence), one row of 156 prompt tokens and 16 steps,
#: so its window of 8 crosses the decode cache's block boundary (slot
#: 167 of 668); float32, the single card's bar.
P16_SP_NAME, P16_SP_PROMPT, P16_SP_TOL = "gemma3-27b", 156, 1e-4
P16_TIMEOUT = 600.0


def p16_prompts(cfg, dev):
    """Phase 13's prompts: LM_BATCH rows of LM_FULL["olmo-1b"] tokens."""
    return torch.as_tensor(global_batch(DataConfig(
        vocab=cfg.vocab, seq_len=LM_FULL["olmo-1b"], global_batch=LM_BATCH,
        seed=7), 0)["tokens"], device=dev)


def p16_cache_dtype(cfg):
    """The decode cache's K / V dtype: the weights' (bfloat16 at full
    width, as JAX's ``abstract_cache``; float32 at smoke width)."""
    return getattr(torch, cfg.param_dtype)


def p16_single(model, prompts, steps, forced=None):
    """The single card: prefill, its caches copied into a decode cache of
    seq_len + CACHE_PAD slots (``p16_cache_dtype``), ``steps`` greedy decode steps (or
    ``forced`` tokens (B, steps) fed). Returns (prefill logits, prefill
    caches, [step logits], tokens (B, steps), the decode cache)."""
    from repro_torch.launch import steps as St
    cfg, (B, P) = model.cfg, prompts.shape
    logits, caches = lm.prefill(model, {"tokens": prompts})
    cache = lm.init_decode_cache(cfg, B, P + St.CACHE_PAD - 1,
                                 p16_cache_dtype(cfg), device=prompts.device)
    with torch.no_grad():
        for name, t in caches.items():
            cache["attn"][name][..., :P, :, :].copy_(t)
    outs, toks = [], []
    last = logits
    for t in range(steps):
        tok = (last[:, -1].argmax(dim=-1)[:, None] if forced is None
               else forced[:, t:t + 1])
        toks.append(tok)
        last, cache = lm.decode_step(
            model, {"tokens": tok, "cache_index": P + t}, cache)
        outs.append(last)
    return logits, caches, outs, torch.cat(toks, dim=1), cache


def p16_mesh(state, cfg, mesh, prompts, forced=None):
    """The mesh steps: prefill, handoff into a decode cache, P16_STEPS
    decode steps, greedy where the logits are whole (one rank) or fed
    ``forced`` (B, steps). Returns (prefill logits, prefill caches, [step
    logits], tokens, the decode cache, prefill s, [step s], bytes of the
    prefill, [bytes of each step])."""
    from repro_torch.launch import steps as St
    from repro_torch.models.config import InputShape
    from repro_torch.sharding import annotate
    B, P = prompts.shape[:2]
    steps = P16_STEPS if forced is None else forced.shape[1]
    prompt = InputShape("prefill", P, B, "prefill")
    decode = InputShape("decode", P, B, "decode")
    prefill_step, _ = St.make_mesh_prefill_step(cfg, prompt, mesh)
    decode_step, _ = St.make_mesh_decode_step(cfg, decode, mesh)
    annotate.reset_traffic()
    (logits, caches), prefill_s = p15_timed(
        lambda: prefill_step(state, {"tokens": prompts}))
    prefill_bytes = annotate.traffic()
    cache = St.init_mesh_decode_cache(cfg, decode, mesh,
                                      p16_cache_dtype(cfg))
    St.handoff_prefill(caches, cache, cfg, mesh, prompt, decode)
    outs, toks, secs, moved = [], [], [], []
    last = logits
    for t in range(steps):
        tok = (last[:, -1].argmax(dim=-1)[:, None] if forced is None
               else forced[:, t:t + 1])
        toks.append(tok)
        annotate.reset_traffic()
        (last, cache), dt = p15_timed(lambda tok=tok, t=t: decode_step(
            state, {"tokens": tok, "cache_index": P + t}, cache))
        secs.append(dt)
        moved.append(annotate.traffic())
        outs.append(last)
    return (logits, caches, outs, torch.cat(toks, dim=1), cache, prefill_s,
            secs, prefill_bytes, moved)


def p16_equal(a, b) -> bool:
    """Two trees (dicts, tuples, lists, tensors) bitwise equal."""
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(p16_equal(a[k], b[k])
                                              for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(p16_equal(x, y)
                                        for x, y in zip(a, b))
    return torch.equal(a, b)


def phase16_one(mesh):
    """(a) One rank of a 1x1 NCCL mesh: olmo-1b whole, bfloat16, the mesh
    prefill of phase 13's prompts and P16_STEPS greedy decode steps,
    against the single card's from the same weights."""
    from repro_torch.launch import steps as St
    cfg = get_config("olmo-1b")
    prompts = p16_prompts(cfg, mesh.device)
    model = lm.init(cfg, seed=0, device=mesh.device)
    state = St.MeshServeState.from_model(model, mesh)
    p16_mesh(state, cfg, mesh, prompts)                    # warm-up
    got = p16_mesh(state, cfg, mesh, prompts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = p16_single(model, prompts, P16_STEPS)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    names = ("prefill logits", "prefill caches", "step logits", "tokens",
             "decode cache")
    same = {n: p16_equal(g, w) for n, g, w in zip(names, got, want)}
    d = max(float((g.float() - w.float()).abs().max())
            for g, w in zip([got[0], *got[2]], [want[0], *want[2]]))
    finite = all(bool(torch.isfinite(x).all()) for x in [got[0], *got[2]])
    return dict(bitwise=same, max_abs_d=d, finite=finite,
                prefill_s=got[5], step_s=got[6], single_s=single_s,
                prefill_bytes=got[7], step_bytes=got[8],
                tokens=got[3].cpu().tolist())


def phase16_world(mesh, forced):
    """(b) One rank of the 2x2 gloo world on the card: olmo-1b at
    P16_LAYERS from seed 0, cut to its blocks; the prefill (a warm-up,
    then timed) and P16_STEPS decode steps fed ``forced`` (the single
    card's greedy tokens); this rank's logits blocks, seconds, bytes and
    resident / peak GiB."""
    from repro_torch.launch import steps as St
    cfg = dataclasses.replace(get_config("olmo-1b"), n_layers=P16_LAYERS)
    prompts = p16_prompts(cfg, mesh.device)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = St.MeshServeState.init(cfg, mesh, seed=0)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    forced = forced.to(mesh.device)
    _, warm_s = p15_timed(lambda: p16_mesh(state, cfg, mesh, prompts,
                                           forced[:, :1]))
    run = p16_mesh(state, cfg, mesh, prompts, forced)
    peak = torch.cuda.max_memory_allocated() - base - resident
    cache = sum(t.numel() * t.element_size()
                for t in run[4]["attn"].values())
    return dict(coords={a: mesh.index(a) for a in ("data", "model")},
                plan=state.plan,
                logits=[run[0].float().cpu()] + [x.float().cpu()
                                                 for x in run[2]],
                prefill_s=run[5], step_s=run[6], warm_s=warm_s,
                prefill_bytes=run[7], step_bytes=run[8],
                resident_gib=resident / 2**30, cache_gib=cache / 2**30,
                peak_above_gib=peak / 2**30)


def phase16_sp(mesh):
    """(c) One rank of a 1x4 gloo world on the card: smoke gemma3 (f32) at
    batch 1, its cache's sequence split over ``model``; the mesh prefill
    and P16_STEPS decode steps fed the prompt's continuation against the
    single card's (on this rank), logits blocks and cache blocks."""
    from repro_torch.launch import steps as St
    from repro_torch.sharding import rules
    cfg = smoke_config(P16_SP_NAME)
    n = P16_SP_PROMPT + P16_STEPS
    tokens = torch.as_tensor(np.random.default_rng(16).integers(
        0, cfg.vocab, (1, n)), device=mesh.device)
    model = lm.init(cfg, seed=0, device=mesh.device)
    state = St.MeshServeState.from_model(model, mesh)
    prompts, forced = tokens[:, :P16_SP_PROMPT], tokens[:, P16_SP_PROMPT:n]
    got = p16_mesh(state, cfg, mesh, prompts, forced)
    want = p16_single(model, prompts, P16_STEPS, forced)
    spec = rules.logits_spec(mesh, 1, cfg.vocab)
    err = 0.0
    for g, w in zip([got[0], *got[2]], [want[0], *want[2]]):
        w = w[rules.block_slices(tuple(w.shape), spec, mesh)]
        err = max(err, float((g - w).abs().max()))
    w_cache = St.cache_blocks({"attn": {k: v.float() for k, v in
                                        want[4]["attn"].items()}}, cfg, mesh)
    cache_err = max(float((got[4]["attn"][k] - w_cache["attn"][k]).abs()
                          .max()) for k in ("k", "v"))
    return dict(coords={a: mesh.index(a) for a in ("data", "model")},
                plan=sorted(set(map(str, state.plan.values()))),
                max_abs_d=err, cache_d=cache_err,
                block=tuple(got[4]["attn"]["k"].shape),
                step_bytes=got[8], prefill_bytes=got[7])


def p16_predict(cfg, n_layers, rows, seq, m=2, dp=2):
    """Bytes a rank of a dp x m mesh receives in one step of ``rows`` x
    ``seq`` tokens by the layout (bfloat16): every TP block gathered over
    ``data`` (the embedding twice: the lookup and the tied head), the
    partial outputs of each layer's attention and MLP summed over
    ``model``, the lookup's sum; and the resident bytes of the blocks."""
    emb = cfg.vocab * cfg.d_model
    layer = (4 * cfg.d_model * cfg.n_heads * cfg.head_dim
             + 3 * cfg.d_model * cfg.d_ff)
    act = rows // dp * seq * cfg.d_model * 2
    return dict(fsdp_gather=(dp - 1) * 2 * (2 * emb + n_layers * layer)
                // (dp * m),
                tp_reduce=n_layers * 2 * (m - 1) * act,
                vocab_embed=(m - 1) * act,
                resident=2 * (emb + n_layers * layer) // (dp * m))


def phase16(dev, smi):
    """Phase 16: (a) on a 1x1 NCCL mesh, (b) on a 2x2 and (c) on a 1x4
    gloo world sharing the card (module comment above P16_LAYERS)."""
    t_start = time.perf_counter()
    tag = f"[{smi}]"
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    cfg = get_config("olmo-1b")
    P = LM_FULL["olmo-1b"]
    # (a) olmo-1b whole on a 1x1 NCCL mesh against the single card.
    t0 = time.perf_counter()
    a, = run_local(phase16_one, 1, 1, backend="nccl", device="cuda",
                   timeout=P16_TIMEOUT)
    a["wall_s"] = time.perf_counter() - t0
    out["1x1"] = a
    check(all(a["bitwise"].values()) and a["finite"],
          f"phase 16 (a): the 1x1 mesh against the single card: "
          f"{a['bitwise']}, max |d| {a['max_abs_d']}")
    check(not a["prefill_bytes"] and not any(a["step_bytes"]),
          f"phase 16 (a): bytes crossed a one-rank mesh: {a}")
    print(f"phase 16: (a) olmo-1b whole ({cfg.n_layers} layers, bf16), "
          f"{LM_BATCH} x {P} prompt tokens, {P16_STEPS} greedy steps on a "
          f"1x1 NCCL mesh: prefill logits and caches, every step's logits, "
          f"the tokens and the decode cache bitwise the single card's "
          f"(no byte crossed); prefill {a['prefill_s']:.3f} s, a decode "
          f"step {1e3 * statistics.median(a['step_s']):.2f} ms (median; "
          f"{1e3 * min(a['step_s']):.2f}-{1e3 * max(a['step_s']):.2f}); "
          f"the single card's prefill and {P16_STEPS} steps "
          f"{a['single_s']:.3f} s {tag}", flush=True)
    # (b)'s references: the single card at (b)'s depth, greedy, and a
    # float32 copy of its weights fed the same tokens.
    cfg4 = dataclasses.replace(cfg, n_layers=P16_LAYERS)
    model = lm.init(cfg4, seed=0, device=dev)
    prompts = p16_prompts(cfg4, dev)
    (ref_l, _, ref_steps, ref_toks, _), ref_s = p15_timed(
        lambda: p16_single(model, prompts, P16_STEPS))
    ref = torch.stack([ref_l[:, -1]] + [x[:, -1] for x in ref_steps]
                      ).float().cpu()                        # (1+T, B, V)
    del ref_l, ref_steps
    model = model.float()
    f_l, _, f_steps, _, _ = p16_single(model, prompts, P16_STEPS, ref_toks)
    f32 = torch.stack([f_l[:, -1]] + [x[:, -1] for x in f_steps]).cpu()
    ref_toks = ref_toks.cpu()
    del model, f_l, f_steps
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    world = run_local(phase16_world, 2, 2, backend="gloo", device="cuda",
                      args=(ref_toks,), timeout=P16_TIMEOUT)
    wall = time.perf_counter() - t0
    from repro_torch.launch.mesh import plan_mesh
    from repro_torch.sharding import rules
    grid = plan_mesh(2, 2)
    spec = rules.logits_spec(grid, LM_BATCH, cfg.vocab)
    got = torch.full_like(ref, float("nan"))
    for r in world:
        for i, blk in enumerate(r["logits"]):
            sl = rules.block_slices((LM_BATCH, cfg.vocab), (spec[0], spec[2]),
                                    grid, r["coords"])
            got[i][sl] = blk[:, -1]
    diff = (got - ref).abs()
    d = float(diff.max())
    band = float((ref - f32).abs().max())          # the single card's
    mesh_band = float((got - f32).abs().max())
    top2 = f32.topk(2, dim=-1).values
    firm = (top2[..., 0] - top2[..., 1]) > 2 * (band + P16_LOGITS_ATOL)
    same = got.argmax(dim=-1) == ref.argmax(dim=-1)
    check(bool(torch.isfinite(got).all())
          and mesh_band <= band + P16_LOGITS_ATOL
          and bool(same[firm].all()),
          f"phase 16 (b): the 2x2 logits {mesh_band} from the float32 "
          f"copy's, the single card's {band} (bar: + {P16_LOGITS_ATOL}); "
          f"greedy tokens differ at {int((~same & firm).sum())} separated "
          f"positions")
    predicted = {k: p16_predict(cfg4, P16_LAYERS, LM_BATCH, s)
                 for k, s in (("prefill", P), ("step", 1))}
    r0 = world[0]
    check(all(r["plan"] == r0["plan"] for r in world)
          and set(r0["plan"].values()) == {"heads", "tp", "vocab"},
          f"phase 16 (b): plans {[r['plan'] for r in world]}")
    for r in world:
        for k in ("fsdp_gather", "tp_reduce", "vocab_embed"):
            check(r["prefill_bytes"].get(k) == predicted["prefill"][k]
                  and all(b.get(k) == predicted["step"][k]
                          for b in r["step_bytes"]),
                  f"phase 16 (b) {r['coords']}: {k} bytes "
                  f"{r['prefill_bytes']}, {r['step_bytes'][0]} against the "
                  f"layout's {predicted}")
    print(f"phase 16: (b) olmo-1b at full width, depth cut from 16 to "
          f"{P16_LAYERS} layers, on a 2x2 gloo world sharing the card "
          f"(plan: attention on the rank's {cfg.n_heads // 2} heads, d_ff "
          f"and the "
          f"vocabulary over model, every TP block gathered over data "
          f"only): {LM_BATCH} x {P} prompt tokens and {P16_STEPS} decode "
          f"steps fed the single card's greedy tokens; logits max |d| "
          f"{mesh_band:.4g} from a float32 copy's, the single card's "
          f"{band:.4g} (bar: + {P16_LOGITS_ATOL}); from the single card's "
          f"max |d| {d:.4g}, mean {float(diff.mean()):.3g}, "
          f"{100 * float((diff == 0).float().mean()):.2f} % bitwise; greedy "
          f"tokens equal the single card's at {int(same.sum())} of "
          f"{same.numel()} positions, at all {int(firm.sum())} whose "
          f"float32 top-2 margin exceeds twice the bar; the single card "
          f"{ref_s:.3f} s for it; the world {wall:.1f} s {tag}", flush=True)
    for r in world:
        print(f"phase 16: (b) rank {r['coords']}: resident "
              f"{r['resident_gib']:.4f} GiB of blocks (predicted "
              f"{predicted['step']['resident'] / 2**30:.4f}), its decode "
              f"cache {r['cache_gib']:.4f} GiB, peak {r['peak_above_gib']:.3f}"
              f" GiB above the blocks; prefill {r['prefill_s']:.3f} s "
              f"(warm-up prefill and a step {r['warm_s']:.3f}), a decode "
              f"step {statistics.median(r['step_s']):.3f} s (median; "
              f"{min(r['step_s']):.3f}-{max(r['step_s']):.3f}); bytes "
              f"received: prefill {r['prefill_bytes']}, a decode step "
              f"{r['step_bytes'][0]} {tag}", flush=True)
    out["2x2"] = dict(layers=P16_LAYERS, max_abs_d=d, band_single=band,
                      band_mesh=mesh_band,
                      bitwise_share=float((diff == 0).float().mean()),
                      greedy_equal=int(same.sum()),
                      positions=same.numel(), separated=int(firm.sum()),
                      reference_s=ref_s, wall_s=wall, predicted=predicted,
                      ranks=[{k: v for k, v in r.items() if k != "logits"}
                             for r in world])
    del world, got, ref, f32
    # (c) the SP branch at smoke width.
    t0 = time.perf_counter()
    sp = run_local(phase16_sp, 1, 4, backend="gloo", device="cuda",
                   timeout=P16_TIMEOUT)
    wall = time.perf_counter() - t0
    check(all(s["max_abs_d"] <= P16_SP_TOL and s["cache_d"] <= P16_SP_TOL
              and s["plan"] == ["('seq', ('model',))", "tp", "vocab"]
              and all(b.get("sp_combine") for b in s["step_bytes"])
              for s in sp),
          f"phase 16 (c): the SP cache against the single card: {sp}")
    print(f"phase 16: (c) {P16_SP_NAME} smoke f32 (2 KV heads over model = "
          f"4: the cache's sequence split, {sp[0]['block'][2]} slots a "
          f"rank), batch 1, {P16_SP_PROMPT} prompt tokens and "
          f"{P16_STEPS} decode steps (the window of 8 across the block "
          f"boundary), 1x4 gloo on the card: logits max |d| "
          f"{max(s['max_abs_d'] for s in sp):.3g}, cache blocks "
          f"{max(s['cache_d'] for s in sp):.3g} against the single card "
          f"(bar {P16_SP_TOL}); sp_combine {sp[0]['step_bytes'][0]['sp_combine']}"
          f" bytes a rank a step; {wall:.1f} s {tag}", flush=True)
    out["1x4_sp"] = dict(wall_s=wall, ranks=sp)
    out["seconds"] = time.perf_counter() - t_start
    print(f"phase 16: done in {out['seconds']:.1f} s {tag}", flush=True)
    return out


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
    host_corpus, labels = make_clustered_text(N_DOCS, vocab=VOCAB, m=DIM,
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
                err = check_dist_topk(coords, qcs, mask, k, dtype, q_ids)
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
    # x once up to each row's length and the lengths, the ids of the
    # entries with x > 0 and the ladder rows (iters+1 costs, iters
    # capacities) of each distinct (query, id) they name, once; it writes
    # t.
    n_ids = int(torch.unique(ids[live]).numel())
    lens = act_phase2.row_lens(x)
    kg_bytes = 4 * int(lens.sum()) + 4 * corpus.n + 4 * nnz \
        + NQ * n_ids * (2 * ITERS + 1) * Z.element_size() + 4 * NQ * corpus.n
    kg_bound, kg_by = bound_ms(kg_bytes, 5.0 * NQ * nnz * (ITERS + 1))
    kg_ms = cuda_ms(lambda: ops.act_phase2_gather(x, ids, Z, W), reps=20)
    # The same kernel walking every row to hmax (no row stop), bitwise.
    whole = torch.full_like(lens, x.shape[1])
    check(torch.equal(act_phase2.act_phase2_gather_cuda(x, ids, whole, Z, W),
                      ops.act_phase2_gather(x, ids, Z, W)),
          "act_phase2_gather: the row stop changed a bit")
    kg_stop_ms, kg_whole_ms = (
        cuda_ms(lambda l=l: act_phase2.act_phase2_gather_cuda(
            x, ids, l, Z, W), reps=20) for l in (lens, whole))
    kg_plain = cuda_ms(lambda: act_phase2.act_phase2_gather_plain(x, ids, Z,
                                                                  W), reps=3)
    print(f"phase 4: K1 {k1_ms:.4f} ms on the batch ({nv} valid bins of "
          f"{NQ * HMAX}, the only ones it computes; bound {k1_bound:.4f} by "
          f"{k1_by}), {k1_all_ms:.4f} ms with all {NQ * HMAX} valid (bound "
          f"{k1_all_bound:.4f}); plain {k1_plain:.3f}; library "
          f"(cdist + topk) {k1_lib:.3f} on the valid work ({nv_max} wide), "
          f"{k1_lib_full:.3f} at full width", flush=True)
    print(f"phase 4: K2 {k2_ms:.4f} ms on gathered ladders (plain "
          f"{k2_plain:.3f}, bound {k2_bound:.4f} by {k2_by}: {nnz} of "
          f"{x.numel()} entries, {BLOCK_Q} queries); fused gather over all "
          f"{NQ} queries {kg_ms:.4f} ms (plain, gather + pour, "
          f"{kg_plain:.3f}, bound {kg_bound:.4f} by {kg_by}: "
          f"{kg_bytes / 1e6:.1f} MB, {n_ids} distinct ids; the bare kernel "
          f"{kg_stop_ms:.4f}, walking every row to hmax {kg_whole_ms:.4f})",
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
    rows_times = time_rows_entry(corpus, q_ids, q_w, wide, narrow)
    bare_ms.update({name: t["ms"] for name, t in rows_times.items()})
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

    # Phase 8: the paper's evaluation path.
    del cases, bare_ms
    p8, k4_rows, p8_runs = phase8(host_corpus, labels, corpus, q_ids, q_w,
                                  rows, dev)

    # Phase 9: the single-query engines, the scan engine and bf16_agg.
    p9, p9_kernels, p9_runs = phase9(host_corpus, corpus, q_ids, q_w, rows,
                                     dev)

    # Phase 10: the serving path.
    p10, p10_runs, lsh_index = phase10(host_corpus, corpus, q_ids, q_w,
                                       rows, dev)

    # Phase 11: the tiles (launches compared there are not the main
    # path's; its tuned builds search outside the counted runs).
    bounds = {f"dist_topk.k{ITERS + 1}": k1_bound,
              "act_phase2_gather": kg_bound,
              "act_phase2_gather.nq1":
                  p9_kernels["act_phase2_gather.nq1"]["bound_ms"],
              **{name: t[2] for name, t in cand_times.items()},
              **{name: t["bound_ms"] for name, t in k4_rows.items()}}
    p11 = phase11(corpus, host_corpus, q_ids, q_w, wide, narrow, logs,
                  bounds, dev)
    variants = p11["variants"]

    # Phase 12: the mesh (its runs' launches are counted on each rank).
    p12 = phase12(host_corpus, lsh_index, rows, q_ids, q_w, dev,
                  dict(k1_ms=k1_ms, kg_ms=kg_ms))

    # Phase 13: the LM serving path and its retrieval stage (K1 and the
    # fused K2 counted around the retrieval search).
    p13 = phase13(host_corpus, dev)
    p13_launches = p13["retrieval"]["launches"]

    # Phase 14: LM training (no kernel of its own; the JSON line of the
    # kernels is phases 2-13's).
    p14 = phase14(dev)

    # Phase 15: LM training on a mesh (no kernel of its own either).
    p15 = phase15(dev, smi)
    p16 = phase16(dev, smi)

    def p10_launches(kname):
        """The kernel's launches in each run of phase 10 that made any."""
        return {r: c[kname] for r, c in p10_runs.items() if c[kname]}

    def chunk_times(kname):
        """The kernel's times at the first all-pairs chunk of each
        corpus."""
        return {c: p8[c]["chunk"][kname]
                for c in ("20news", "mnist_sparse", "mnist_dense")}

    kernels = [
        {"name": "dist_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/dist_topk.cu",
         "replaces": "src/repro/kernels/dist_topk.py:121",
         "launches": launches["act"]["dist_topk"]
         + sum(p10_launches("dist_topk").values())
         + p13_launches["dist_topk"],
         "launches_phase10": p10_launches("dist_topk"),
         "launches_phase13": p13_launches["dist_topk"],
         "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": k1_lib,
         "ms_all_valid": k1_all_ms, "bound_ms_all_valid": k1_all_bound,
         "library_full_width_ms": k1_lib_full,
         "all_pairs_chunk": chunk_times("dist_topk"),
         "variants": {k: variants[k] for k in variants
                      if k.startswith("dist_topk.")}},
        {"name": "act_phase2", "route": "cuda",
         "source": "src/repro_torch/csrc/act_phase2.cu",
         "replaces": "src/repro/kernels/act_phase2.py:73",
         "launches": sum(c["act_phase2"] for c in (*launches.values(),
                                                   *p9_runs.values())),
         "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
        {"name": "act_phase2_gather", "route": "cuda",
         "source": "src/repro_torch/csrc/act_phase2.cu",
         "replaces": "src/repro/kernels/act_phase2.py:73",
         "launches": launches["act"]["act_phase2_gather"]
         + sum(p10_launches("act_phase2_gather").values())
         + p13_launches["act_phase2_gather"],
         "launches_phase10": p10_launches("act_phase2_gather"),
         "launches_phase13": p13_launches["act_phase2_gather"],
         "max_abs_err": kg_err, "ms": kg_ms, "plain_ms": kg_plain,
         "bound_ms": kg_bound, "bound_by": kg_by, "library_ms": None,
         "bare_ms": kg_stop_ms, "whole_rows_ms": kg_whole_ms,
         "all_pairs_chunk": chunk_times("act_phase2_gather"),
         "variants": variants["act_phase2_gather"]},
    ]
    # The main path's runs: the phase-3 searches, the cascades, the
    # phase-8 all-pairs and searches, phase 9's (the single queries among
    # them) and the phase-10 serving path.
    runs = {**launches, **cascade_counts, **p8_runs, **p9_runs, **p10_runs}
    for name, (k_ms, p_ms, b_ms, b_by, l_ms) in cand_times.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{CAND_KERNELS[name][0]}.cu",
            "replaces": CAND_KERNELS[name][1],
            "launches": sum(c[name] for c in runs.values()),
            "launches_by_search": {p: c[name] for p, c in runs.items()},
            "max_abs_err": cand_errs[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
            **{k: t for k, t in rows_times.get(name, {}).items()
               if k != "ms"},
            **({"all_pairs_chunk": chunk_times(name)}
               if name in p8["20news"]["chunk"] else {}),
            **({"variants": variants[name]} if name in variants else {})})
    for name, t in k4_rows.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{CAND_KERNELS[name][0]}.cu",
            "replaces": CAND_KERNELS[name][1],
            "launches": sum(c[name] for c in runs.values()),
            "launches_by_search": {p: c[name] for p, c in runs.items()
                                   if c[name]},
            "library_ms": None, **t,
            **({"variants": variants[name]} if name in variants else {})})
    # Phase 9's kernels: K1 and the fused K2 at nq=1 on the single-query
    # path, the unfused K2 at nq=1 (off the path since the fused K2 took
    # it: 0 launches, like K5), and K1 on bfloat16 coordinates under
    # bf16_agg.
    p9_launches = {
        "dist_topk.nq1.k1": p9_runs["single.rwmd"]["dist_topk"],
        "dist_topk.nq1.k2": p9_runs["single.omr"]["dist_topk"],
        f"dist_topk.nq1.k{ITERS + 1}": p9_runs["single.act"]["dist_topk"],
        "act_phase2_gather.nq1": sum(
            p9_runs[r]["act_phase2_gather"]
            for r in ("single.act", "scan.act")),
        "act_phase2.nq1": p9_runs["single.act"]["act_phase2"],
        "dist_topk.bf16_coords": sum(p9_runs[f"bf16_agg.{name}"]["dist_topk"]
                                     for name in AGG_SEARCHES),
    }
    for name, t in p9_kernels.items():
        base = name.split(".")[0]
        check(p9_launches[name] > 0 or name == "act_phase2.nq1",
              f"{name} was never launched on its path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": ("src/repro_torch/csrc/dist_topk.cu"
                       if base == "dist_topk"
                       else "src/repro_torch/csrc/act_phase2.cu"),
            "replaces": ("src/repro/kernels/dist_topk.py:121"
                         if base == "dist_topk"
                         else "src/repro/kernels/act_phase2.py:73"),
            "launches": p9_launches[name], **t,
            **({"variants": variants[name]} if name in variants else {})})
    print(json.dumps({"phase8": p8}))
    print(json.dumps({"phase9": p9}))
    print(json.dumps({"phase10": p10}))
    print(json.dumps({"phase11": {k: p11[k] for k in ("tuned", "build_s",
                                                      "seconds")}}))
    # Every kernel's launches in phase 12, by mesh: summed over the ranks
    # and the runs (a kernel of phase 9's nq=1 and bf16_agg paths, which
    # the mesh does not take, reads 0).
    for entry in kernels:
        entry["launches_phase12"] = {
            m: sum(c.get(entry["name"], 0) for run in p12[m]["runs"].values()
                   for c in run["launches"])
            for m in MESHES}
    print(json.dumps({"phase12": p12}))
    print(json.dumps({"phase13": p13}))
    print(json.dumps({"phase14": p14}))
    print(json.dumps({"phase15": p15}))
    print(json.dumps({"phase16": p16}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
