"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, compiled for ``sm_90a`` at first use into ``build/kernels/`` at
the root of the checkout (git-ignored), under a name keyed by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is reused. Nothing here includes PyTorch's headers, so a build takes
seconds. :func:`build` compiles several libraries at once, one ``nvcc``
process each.

A tile variant of a kernel is the same source built with ``-D`` defines
(``{"DIST_TOPK_BV": 256}``): its own library, keyed by the source and all
its flags. No defines is the default variant, the library the source
always built.
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
           "cand_dist_valid", "cand_dist_all", "cand_pour_rows")

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


def define_flags(defines=None) -> tuple[str, ...]:
    """``-DNAME=VALUE`` flags of a variant, sorted by name."""
    return tuple(f"-D{k}={int(v)}" for k, v in sorted((defines or {}).items()))


def library_path(name: str, defines=None) -> Path:
    """Where ``csrc/<name>.cu`` is built to with ``defines``: keyed by the
    source and every flag."""
    flags = NVCC_FLAGS + define_flags(defines)
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_variants(variants) -> dict[tuple, str]:
    """Compile every ``(name, defines)`` of ``variants`` not yet built,
    with one ``nvcc`` process each, all started together. Returns
    {(name, sorted define items): compiler output} for the libraries
    compiled now (``-Xptxas -v`` reports each kernel's registers, shared
    memory and spills). Raises :class:`KernelError` with the compiler's
    output if any build fails; nothing falls back to another variant."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, defines in variants:
        key = (name, tuple(sorted((defines or {}).items())))
        out = library_path(name, defines)
        if key in procs or out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[key] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *define_flags(defines), "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for key, (out, tmp, proc) in procs.items():
        logs[key] = proc.communicate()[0]
        if proc.returncode:
            failed.append(key)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)    # atomic: concurrent builds agree
    if failed:
        raise KernelError("nvcc failed for " + ", ".join(
            f"{n}{dict(d) or ''}" for n, d in failed) + ":\n"
            + "\n".join(logs[k] for k in failed))
    return logs


def build(names=SOURCES, defines=None) -> dict[str, str]:
    """Compile every source of ``names`` not yet built, with ``defines``
    (none: the default variants). Returns {name: compiler output} for the
    sources compiled now; raises :class:`KernelError` if any build
    fails."""
    logs = build_variants([(name, defines) for name in names])
    return {name: log for (name, _), log in logs.items()}


def load(name: str, defines=None) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu`` with ``defines``, built
    first if needed."""
    build_variants([(name, defines)])
    return ctypes.CDLL(str(library_path(name, defines)))


#: The figures a kernel's ``<name>_attrs`` C function reports, in order:
#: ``cudaFuncGetAttributes``' static shared bytes, the dynamic shared bytes
#: the launch requests, registers a thread, local (spill) bytes a thread
#: and most threads a block.
ATTR_KEYS = ("static_bytes", "dynamic_bytes", "regs", "local_bytes",
             "max_threads")


def func_attrs(fn, *args) -> dict[str, int]:
    """Call a kernel library's ``<name>_attrs(*args, int out[5])`` and
    return its figures by :data:`ATTR_KEYS`."""
    out = (ctypes.c_int * len(ATTR_KEYS))()
    err = fn(*args, out)
    if err:
        raise KernelError(f"cudaFuncGetAttributes failed with error {err}")
    return dict(zip(ATTR_KEYS, out))
