"""sm_90 shared-memory and register budget of every kernel launch.

The counterpart of the JAX package's ``analysis/vmem.py``, whose budget
(16 MiB of VMEM a core, in/out blocks counted twice) has no meaning on the
card. Every kernel family publishes its launch as data
(``kernels.ops.KERNEL_FAMILIES`` / ``ops.block_layout``: grid, threads,
shared arrays, ``__launch_bounds__``); this pass holds each launch to
what decides on an H100 (sm_90) whether it runs and how many of its
blocks share an SM:

* a block's shared memory: at most 227 KB (232,448 B), of which at most
  48 KB static (``__shared__`` arrays; more only as dynamic shared memory
  after ``cudaFuncSetAttribute``);
* an SM's: 228 KB (233,472 B), with 1 KB reserved for every block on it;
* registers: 65,536 an SM, at most 255 a thread; a kernel compiled under
  ``__launch_bounds__(threads, min_blocks)`` gets at most what
  ``min_blocks`` blocks leave a thread (:func:`reg_cap`), and a thread's
  accumulator tile must fit under that cap;
* threads: at most 1,024 a block and 2,048 an SM; at most 32 blocks an
  SM.

A launch that fits fewer than one block on an SM, or whose grid is
degenerate, is a violation. The profiles are the shapes ``chip_smoke.py``
launches; ``kernels.autotune.admissible_configs`` enumerates only tiles
:func:`check_launch` admits, and the wrappers build no variant it
rejects (``ops.variant``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.analysis.violations import Violation
from repro_torch.kernels import cand_pour, ops

#: sm_90's limits (NVIDIA's CUDA programming guide, compute capability
#: 9.0).
SMEM_PER_BLOCK = 232_448          # 227 KB, dynamic above STATIC_SMEM_LIMIT
STATIC_SMEM_LIMIT = 49_152        # 48 KB of __shared__ arrays
SMEM_PER_SM = 233_472             # 228 KB
SMEM_RESERVED_PER_BLOCK = 1_024
REGS_PER_SM = 65_536
MAX_REGS_PER_THREAD = 255
REG_ALLOC_UNIT = 256              # registers a warp is given at a time
THREADS_PER_BLOCK = 1_024
THREADS_PER_SM = 2_048
BLOCKS_PER_SM = 32


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def reg_cap(layout: ops.KernelBlocks) -> int:
    """Registers a thread may use under the kernel's
    ``__launch_bounds__(threads, min_blocks)``: what ``min_blocks`` blocks
    leave each of their warps, in whole allocation units, at most 255."""
    warps = layout.min_blocks * _cdiv(layout.threads, 32)
    per_warp = REGS_PER_SM // warps // REG_ALLOC_UNIT * REG_ALLOC_UNIT
    return min(MAX_REGS_PER_THREAD, per_warp // 32)


def blocks_per_sm(layout: ops.KernelBlocks, regs: int | None = None,
                  smem_per_sm: int = SMEM_PER_SM) -> int:
    """Blocks of the launch an SM holds at once, the least of what shared
    memory, registers (``regs`` a thread, default the cap) and threads
    allow."""
    regs = reg_cap(layout) if regs is None else regs
    warps = _cdiv(layout.threads, 32)
    reg_unit = _cdiv(regs * 32, REG_ALLOC_UNIT) * REG_ALLOC_UNIT
    by_regs = REGS_PER_SM // (warps * reg_unit) if regs else BLOCKS_PER_SM
    by_smem = smem_per_sm // (layout.smem_bytes + SMEM_RESERVED_PER_BLOCK)
    by_threads = THREADS_PER_SM // layout.threads
    return min(BLOCKS_PER_SM, by_regs, by_smem, by_threads)


def footprint(family: str, **dims) -> tuple[ops.KernelBlocks, int]:
    """(layout, shared-memory bytes a block) of one kernel launch: the
    static cost model the tile autotuner sweeps."""
    layout = ops.block_layout(family, **dims)
    return layout, layout.smem_bytes


@dataclasses.dataclass(frozen=True)
class Budget:
    """The per-block and per-SM limits a launch is held to (sm_90's by
    default; lower ones check headroom or seed a failing launch)."""
    smem_per_block: int = SMEM_PER_BLOCK
    smem_per_sm: int = SMEM_PER_SM


def check_launch(label: str, family: str, dims: dict, *,
                 budget: Budget = Budget()) -> list[Violation]:
    """Validate one launch: its layout builds, its grid is well formed,
    its block fits sm_90 and at least one block fits on an SM."""
    try:
        layout = ops.block_layout(family, **dims)
    except (ValueError, TypeError) as e:
        return [Violation("smem", label, f"invalid launch config: {e}")]
    out: list[Violation] = []

    def bad(msg):
        out.append(Violation("smem", label, msg))

    if not layout.grid or any(g < 1 for g in layout.grid):
        bad(f"degenerate grid {layout.grid}")
    elif layout.grid[0] >= 2**31 or any(g > 65_535 for g in layout.grid[1:]):
        bad(f"grid {layout.grid} beyond the card's grid limits")
    if layout.threads > THREADS_PER_BLOCK:
        bad(f"{layout.threads} threads a block exceed {THREADS_PER_BLOCK}")
    if layout.static_bytes > STATIC_SMEM_LIMIT:
        bad(f"static shared memory {layout.static_bytes} B exceeds the "
            f"{STATIC_SMEM_LIMIT} B static limit")
    if layout.smem_bytes > budget.smem_per_block:
        bad(f"shared memory {layout.smem_bytes} B a block exceeds the "
            f"{budget.smem_per_block} B budget (grid {layout.grid}; shrink "
            f"the tile)")
    cap = reg_cap(layout)
    if layout.acc_regs > cap:
        bad(f"the accumulator tile takes {layout.acc_regs} registers a "
            f"thread, above the cap of {cap} that __launch_bounds__("
            f"{layout.threads}, {layout.min_blocks}) leaves")
    if not out and blocks_per_sm(layout,
                                 smem_per_sm=budget.smem_per_sm) < 1:
        bad(f"no block fits on an SM ({layout.smem_bytes} B shared, "
            f"{layout.threads} threads at {cap} registers)")
    return out


#: Nominal dims of each family's kernels: the shape-independent checks of
#: a tile (:func:`check_tiles`) build its layouts at these. A variant's
#: library holds every mode's kernel, so the mode with the most shared
#: memory decides (K4's ict keeps its queue's weights, rev_min does not);
#: K4's all-rows form is a library of its own on the same macro, checked
#: at its widest column group of float32 costs.
_NOMINAL = {
    "dist_topk": (dict(nq=1, v=1, h=1, m=1, k=1),),
    "act_phase2": (dict(nq=1, n=1, h=1, iters=1),),
    "act_phase2_cand": (dict(nq=1, n=1, h=1, iters=1),),
    "cand_pour": (dict(nq=1, b=1, h=1, iters=1),),
    "cand_dist": (dict(nq=1, b=1, h=1, mode="ict"),
                  dict(nq=1, b=1, h=1, mode="ict", form="all",
                       quads=cand_pour.GROUP_QUADS)),
}


def check_tiles(family: str, tiles: dict, *,
                budget: Budget = Budget()) -> list[Violation]:
    """Whether ``family``'s libraries can be built with the tile ``tiles``
    and each of their kernels launched, whatever the shape: every check of
    :func:`check_launch` but the grid's."""
    out: list[Violation] = []
    for dims in _NOMINAL[family]:
        out += check_launch(f"{family}:{tiles}", family, {**dims, **tiles},
                            budget=budget)
    return out


def check_configs() -> list[tuple[str, str, dict]]:
    """(profile:family label, family, dims) for every checked launch: the
    shapes ``chip_smoke.py`` launches, at the default tiles."""
    from repro_torch.configs.emd_20news import CONFIG as NEWS
    from repro_torch.configs.emd_mnist import CONFIG as MNIST

    out: list[tuple[str, str, dict]] = []
    # (profile, queries, corpus config, n, the k of each method)
    profiles = (("news16", 16, NEWS, NEWS.n_db),
                ("news256", 256, NEWS, NEWS.n_db),
                ("mnist_sparse256", 256, MNIST, MNIST.n_db),
                ("mnist_dense256", 256, MNIST, 10_000),
                ("nq1", 1, NEWS, NEWS.n_db))
    for name, nq, cfg, n in profiles:
        for k in (1, 2, cfg.iters + 1):
            out.append((f"{name}:dist_topk:k{k}", "dist_topk",
                        dict(nq=nq, v=cfg.vocab, h=cfg.hmax, m=cfg.dim,
                             k=k)))
        out.append((f"{name}:act_phase2", "act_phase2",
                    dict(nq=nq, n=n, h=cfg.hmax, iters=cfg.iters)))
        for mode, iters in (("pour", 0), ("omr", 1)):
            out.append((f"{name}:cand_pour:all_{mode}{iters}", "cand_pour",
                        dict(nq=nq, b=n, h=cfg.hmax, iters=iters, mode=mode,
                             form="all")))
        for mode in ("rev_min", "ict"):
            out.append((f"{name}:cand_dist:all_{mode}", "cand_dist",
                        dict(nq=nq, b=n, h=cfg.hmax, mode=mode, form="all")))
    # The cascade's candidate stages: 5 % and 20 % of the 20News corpus.
    for b in (941, 3766):
        for mode, iters in (("pour", 0), ("pour", 3), ("omr", 1)):
            out.append((f"news16:cand_pour:{mode}{iters}:b{b}", "cand_pour",
                        dict(nq=16, b=b, h=NEWS.hmax, iters=iters,
                             mode=mode)))
        for mode in ("rev_min", "ict"):
            out.append((f"news16:cand_dist:{mode}:b{b}", "cand_dist",
                        dict(nq=16, b=b, h=NEWS.hmax, mode=mode)))
    out.append(("news16:act_phase2_cand", "act_phase2_cand",
                dict(nq=16, n=941, h=NEWS.hmax, iters=3)))
    return out


def run(*, budget: Budget = Budget(),
        configs=None) -> tuple[list[Violation], int]:
    """Check every profiled launch; returns (violations, launches)."""
    configs = check_configs() if configs is None else configs
    out: list[Violation] = []
    for label, family, dims in configs:
        out += check_launch(label, family, dims, budget=budget)
    return out, len(configs)
