"""Run one function on every rank of a local (data, model) mesh.

    results = run_local(fn, 2, 2, backend="gloo", device="cpu", args=(x,))

starts ``n_data * n_model`` processes (``spawn``), joins them into one
process group through a file store in a temporary directory (no TCP port,
so concurrent launches never collide), builds the mesh on each
(``launch.mesh.make_test_mesh``) and calls ``fn(mesh, *args)`` there.
``fn`` must be importable by name (a module-level function) and return
something picklable (tensors on the CPU). The results come back in rank
order; a rank's exception is raised again here, with the rank's traceback.

Every wait has a limit: ``timeout`` seconds for the process group's and
the mesh's collectives and for the whole run. A rank that does not finish in time
fails the run, and every rank still alive is killed.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import tempfile
import time
import traceback

#: Seconds a local run may take by default, start-up included.
DEFAULT_TIMEOUT = 300.0


class RankError(RuntimeError):
    """A rank of a local run failed; the message holds its traceback."""


def _rank_main(fn, rank, n_data, n_model, backend, device, tmp, args,
               timeout):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    out = os.path.join(tmp, f"rank{rank}.pkl")
    world = n_data * n_model
    # Ranks share the host's cores.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(tmp, 'store')}",
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        mesh = make_test_mesh(n_data, n_model, backend=backend,
                              device=device, timeout=timeout)
        result = fn(mesh, *args)
        dist.barrier()
        record = ("ok", result)
    except BaseException as e:                 # noqa: BLE001 - re-raised
        tb = traceback.format_exc()
        try:
            pickle.dumps(e)
        except Exception:                      # noqa: BLE001
            e = None
        record = ("err", e, tb)
    with open(out + ".tmp", "wb") as f:
        pickle.dump(record, f)
    os.replace(out + ".tmp", out)
    if dist.is_initialized():
        dist.destroy_process_group()
    os._exit(0 if record[0] == "ok" else 1)


def run_local(fn, n_data: int, n_model: int, *, backend: str = "gloo",
              device="cpu", args: tuple = (),
              timeout: float = DEFAULT_TIMEOUT) -> list:
    """``fn(mesh, *args)`` on each rank of a local (n_data, n_model) mesh;
    returns the results by rank. Raises the first failed rank's exception
    (:class:`RankError` with its traceback when it cannot be pickled), and
    ``TimeoutError`` when the ranks are not done within ``timeout``
    seconds."""
    world = n_data * n_model
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, n_data, n_model, backend,
                                   str(device), tmp, args, timeout),
                             daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            # A rank that fails leaves the others waiting in a collective:
            # stop them at once.
            while any(p.is_alive() for p in procs) \
                    and time.monotonic() < deadline \
                    and not any(p.exitcode for p in procs):
                time.sleep(0.05)
            failed = any(p.exitcode for p in procs)
            late = [] if failed else [r for r, p in enumerate(procs)
                                      if p.is_alive()]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        records = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                records.append(None)
                continue
            with open(path, "rb") as f:
                records.append(pickle.load(f))
    for r, rec in enumerate(records):
        if rec is not None and rec[0] == "err":
            _, exc, tb = rec
            if exc is None:
                raise RankError(f"rank {r} of {world} failed:\n{tb}")
            raise exc from RankError(f"rank {r} of {world} failed:\n{tb}")
    if late:
        raise TimeoutError(f"ranks {late} of {world} were not done within "
                           f"{timeout} s and were killed")
    missing = [r for r, rec in enumerate(records) if rec is None]
    if missing:
        codes = [procs[r].exitcode for r in missing]
        raise RankError(f"ranks {missing} of {world} exited ({codes}) "
                        "without a result")
    return [rec[1] for rec in records]
