"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, compiled for ``sm_90a`` at first use into ``build/kernels/`` at
the root of the checkout (git-ignored), under a name keyed by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is reused. Nothing here includes PyTorch's headers, so a build takes
seconds. :func:`build` compiles several sources at once, one ``nvcc``
process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: Every kernel source of the port (``csrc/<name>.cu``).
SOURCES = ("dist_topk", "act_phase2", "cand_pour", "cand_dist",
           "cand_dist_valid", "cand_pour_rows")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelError(RuntimeError):
    """A kernel failed to build (``nvcc``) or to launch. Typed so callers
    that retry other errors (the serving runtime) can tell a fault of the
    program from a transient one."""


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise KernelError("nvcc not found on PATH or in /usr/local/cuda; "
                           "the CUDA kernels are built at first use")
    return nvcc


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built to: keyed by source and flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every source of ``names`` not yet built, with one ``nvcc``
    process per source, all started together. Returns {name: compiler
    output} for the sources compiled now (``-Xptxas -v`` reports each
    kernel's registers, shared memory and spills). Raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)    # atomic: concurrent builds agree
    if failed:
        raise KernelError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built first if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))

