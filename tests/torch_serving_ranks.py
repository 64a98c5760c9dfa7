"""Rank bodies of the port's served-mesh tests (``test_torch_mesh_serving.py``).

``repro_torch.launch.local.run_local`` runs each world function on every
rank of a local gloo mesh on the CPU. They import only the port (never
JAX), take numpy arrays and return numpy arrays and counts; the test
process holds them to the JAX package and to the port's single-process
index. On every rank the server is built from the same index; the leader
runs each session's requests (``session``) while the others follow.
"""
import asyncio
import dataclasses
import time

import numpy as np

from repro_torch.api import EmdIndex, EngineConfig, corpus_from_numpy
from repro_torch.candidates import CentroidLSHSpec
from repro_torch.cascade import CascadeSpec, CascadeStage
from repro_torch.core.lc import Corpus
from repro_torch.kernels._build import KernelError
from repro_torch.launch.mesh import join_mesh, plan_mesh, world_group
from repro_torch.launch.search import SEARCH_PLAN
from repro_torch.runtime import elastic
from repro_torch.serving import (ChaosInjector, ChaosSchedule, EmdServer,
                                 ServerOverloaded, ServingPolicy,
                                 corrupt_checkpoint, restore_server,
                                 snapshot)
from repro_torch.sharding import annotate

#: The primary of every world: JAX's mesh-serving test's config.
CONFIG = dict(method="act", iters=2, top_l=4, backend="distributed",
              pad_multiple=8)
#: An LSH-sourced primary.
LSH = CascadeSpec(stages=(CascadeStage("rwmd", 8),), rescorer="act",
                  rescorer_iters=2,
                  source=CentroidLSHSpec(n_buckets=4, probes=2,
                                         bucket_cap=12))
#: bench_serve's ladder.
LADDER = ("primary", "fast", "wcd")
#: Seconds a collective of the follower-fault mesh waits.
FAULT_TIMEOUT = 3.0
#: Seconds a collective of the idle server's mesh waits, and the seconds
#: the server stays idle between two requests (more than twice that).
IDLE_MESH_TIMEOUT, IDLE_S = 3.0, 6.5
#: A built index's tables under the search step's plan: the plan
#: ``reshard_live`` moves them by (JAX's test takes its target shardings
#: from the step's too).
TABLES_PLAN = {"ids": SEARCH_PLAN["corpus_ids"], "w": SEARCH_PLAN["corpus_w"],
               "coords": SEARCH_PLAN["coords"]}
#: The chaos schedule's seed and the requests of its traffic.
CHAOS_SEED, CHAOS_GROUPS = 0, 4


def policy(**kw):
    kw = dict(dict(ladder=LADDER, max_batch=8, flush_ms=50.0, backoff_ms=0.0,
                   max_retries=1, deadline_ms=60_000.0), **kw)
    return ServingPolicy(**kw)


def session(server, fn):
    """``fn(server)`` (a coroutine function) in a run of the server on the
    leader; ``follow()`` on the other ranks. The leader's result, None
    elsewhere."""
    if not server.is_leader:
        server.follow()
        return None

    async def go():
        async with server:
            return await fn(server)
    return asyncio.run(go())


async def ask(server, queries, rows):
    """The rows' queries at once (one launch when they fit a batch)."""
    ids, w = queries
    res = await asyncio.gather(*[server.search(ids[r], w[r]) for r in rows],
                               return_exceptions=True)
    return [r if isinstance(r, BaseException) else
            (r.tier, r.generation, r.scores, r.indices) for r in res]


class Recorder:
    """A launch hook around another (or none): each launch that returns,
    with its tier, padded batch and (on the leader) result."""

    def __init__(self, inner=None):
        self.inner, self.launches = inner, []

    def __call__(self, launch_fn, tier, q_ids, q_w):
        out = (launch_fn(tier, q_ids, q_w) if self.inner is None
               else self.inner(launch_fn, tier, q_ids, q_w))
        self.launches.append((tier.name, q_ids.copy(), q_w.copy(), out))
        return out


class FailFirst:
    """A follower's hook: its first launch raises a kernel error."""

    def __init__(self):
        self.calls = 0

    def __call__(self, launch_fn, tier, q_ids, q_w):
        self.calls += 1
        if self.calls == 1:
            raise KernelError("injected on a follower")
        return launch_fn(tier, q_ids, q_w)


def _np(x):
    return None if x is None else x.cpu().numpy()


def _tables(t):
    return None if t is None else {k: _np(v) for k, v in t.items()}


def _index_tables(index):
    """This rank's tables of a built mesh index."""
    c = index._local
    return {"ids": c.ids, "w": c.w, "coords": c.coords}


def _with_tables(index, tables):
    """``index`` with its tables swapped for ``tables``, as JAX's test
    swaps its ``_padded_corpus``."""
    return dataclasses.replace(index, _local=Corpus(**tables))


def world_2x2(mesh, arrays, queries, rows, mutation, dirs):
    """The 2 x 2 world: the repaired tiers, coalescing, the wcd rung,
    mutations, reshards 2x2 -> 1x2 -> 2x2, snapshots, the chaos replay,
    ``reshard_live`` 2x2 -> 1x2 -> 2x2, an idle spell and a follower's
    fault."""
    corpus = corpus_from_numpy(*arrays, "cpu")
    index = EmdIndex.build(corpus, EngineConfig(**CONFIG), mesh=mesh)
    out = {"rank": mesh.index("data") * 2 + mesh.index("model")}

    # The repaired build: every tier on the mesh; a coalesced launch.
    rec = Recorder()
    server = EmdServer(index, policy(), launch_hook=rec)
    out["tier_meshes"] = [b.index.mesh is mesh for b in server._gen.tiers]
    out["coalesce"] = session(server, lambda s: ask(s, queries, rows[:5]))
    out["coalesce_launches"] = server.stats.launches
    out["coalesce_buckets"] = dict(server.stats.bucket_launches)
    out["coalesce_batches"] = [(n, q, w) for n, q, w, _ in rec.launches]

    # The wcd rung: primary and fast fail twice each on the leader.
    down = ChaosInjector(ChaosSchedule(fail_launches=frozenset(range(4))))
    server = EmdServer(index, policy(),
                       launch_hook=down if mesh.index("model") ==
                       mesh.index("data") == 0 else None)
    out["wcd"] = session(server, lambda s: ask(s, queries, rows[:3]))
    out["wcd_launches"] = server.stats.launches

    # A batch in flight across a mutation: its first attempt fails on the
    # leader, and while it backs off an append makes generation 1; its
    # retry still launches generation 0 on every rank.
    fail = ChaosInjector(ChaosSchedule(fail_launches=frozenset({0})))
    server = EmdServer(index, policy(flush_ms=1.0, backoff_ms=300.0),
                       launch_hook=fail if out["rank"] == 0 else None)

    async def inflight(s):
        first = asyncio.ensure_future(ask(s, queries, rows[:1]))
        await asyncio.sleep(0.1)
        s.append(*(x[:1] for x in mutation["append"]))
        return (await first)[0], (await ask(s, queries, rows[:1]))[0]
    out["inflight"] = session(server, inflight)

    # Mutations, then reshards onto half the world and back, on one server.
    server = EmdServer(index, policy())

    async def mutate(s):
        new_ids = s.append(*mutation["append"])
        removed = s.delete(mutation["delete"])
        return new_ids, removed, await ask(s, queries, rows)
    out["mutate"] = session(server, mutate)
    snapshot(server, dirs["snap"])                       # gen 2
    out["mutate_gen"] = server.generation

    async def reshards(s):
        res = [await ask(s, queries, rows)]
        annotate.reset_traffic()
        s.reshard(plan_mesh(1, 2, ranks=(0, 1)))
        res.append(await ask(s, queries, rows))
        s.reshard(plan_mesh(2, 2))
        res.append(await ask(s, queries, rows))
        return res
    out["reshard"] = session(server, reshards)
    out["reshard_traffic"] = annotate.traffic()
    out["reshard_gen"] = server.generation
    out["reshard_mesh"] = server.mesh.shape
    out["snap_path"] = snapshot(server, dirs["snap"])   # gen 4

    # An LSH-sourced primary and its snapshot.
    lsh = EmdIndex.build(corpus, EngineConfig(**dict(CONFIG, cascade=LSH)),
                         mesh=mesh)
    server = EmdServer(lsh, policy(ladder=("primary", "wcd")))
    out["lsh"] = session(server, lambda s: ask(s, queries, rows))
    out["lsh_leaves"] = [_np(t) for t in lsh.source.leaves()]
    snapshot(server, dirs["lsh"])

    # The chaos schedule, twice: the leader's launches recorded through
    # the injector, the followers' as they run them; then every launch
    # replayed on its tier's own mesh index.
    out["chaos"] = []
    for _ in range(2):
        leader = mesh.index("data") == mesh.index("model") == 0
        inj = ChaosInjector(ChaosSchedule.from_seed(CHAOS_SEED, horizon=64,
                                                    p_fail=0.3))
        rec = Recorder(inj if leader else None)
        server = EmdServer(index, policy(), launch_hook=rec)

        async def traffic(s):
            res = []
            for g in range(CHAOS_GROUPS):
                res += await ask(s, queries, rows[g::CHAOS_GROUPS])
            return [("SHED",) if isinstance(r, ServerOverloaded) else r
                    for r in res]
        res = session(server, traffic)
        own = {b.tier.name: b.index for b in server._gen.tiers}
        replay = []
        for name, q, w, got in rec.launches:
            s, i = own[name].search(q, w)
            replay.append(None if got is None else
                          (np.array_equal(got[0], _np(s))
                           and np.array_equal(got[1], _np(i))))
        out["chaos"].append(dict(
            results=res, log=inj.log if leader else None,
            launches=[n for n, *_ in rec.launches], replay=replay,
            failures=server.stats.launch_failures))

    # reshard_live: the built tables 2x2 -> 1x2 -> 2x2, each bitwise a
    # fresh build's, and serving.
    cfg = EngineConfig(**CONFIG)
    q = tuple(x[rows] for x in queries)
    want = index.search(*q)
    group = world_group(mesh.timeout)
    annotate.reset_traffic()
    half = join_mesh(plan_mesh(1, 2, ranks=(0, 1)))
    t12 = elastic.reshard_live(_index_tables(index), half, TABLES_PLAN,
                               mesh=mesh, group=group)
    out["live_traffic_down"] = annotate.traffic()
    out["live_down"] = _tables(t12)
    if half is not None:
        fresh = EmdIndex.build(corpus, cfg, mesh=half)
        out["live_down_fresh"] = _tables(_index_tables(fresh))
        got = _with_tables(fresh, t12).search(*q)
        out["live_down_search"] = (_np(got[0]), _np(got[1]))
    annotate.reset_traffic()
    full = join_mesh(plan_mesh(2, 2))
    t22 = elastic.reshard_live(t12, full, TABLES_PLAN, mesh=half,
                               group=group)
    out["live_up_traffic"] = annotate.traffic()
    out["live_up"] = _tables(t22)
    out["live_up_first"] = _tables(_index_tables(index))
    got = _with_tables(EmdIndex.build(corpus, cfg, mesh=full),
                       t22).search(*q)
    out["live_up_search"] = (_np(got[0]), _np(got[1]))
    out["live_want"] = (_np(want[0]), _np(want[1]))

    # An idle spell longer than twice the mesh's timeout between two
    # requests: the followers wait for the next command, then serve it.
    quick = join_mesh(plan_mesh(2, 2, timeout=IDLE_MESH_TIMEOUT))
    server = EmdServer(EmdIndex.build(corpus, cfg, mesh=quick),
                       policy(ladder=("primary",)))

    async def idle(s):
        first = await ask(s, queries, rows[:1])
        await asyncio.sleep(IDLE_S)
        return first, await ask(s, queries, rows[:1])
    out["idle"] = session(server, idle)
    out["idle_launches"] = server.stats.launches

    # A follower's kernel error: a device fault on the leader, no hang.
    short = join_mesh(plan_mesh(2, 2, timeout=FAULT_TIMEOUT))
    faulty = EmdIndex.build(corpus, cfg, mesh=short)
    server = EmdServer(faulty, policy(ladder=("primary", "wcd")),
                       launch_hook=FailFirst() if out["rank"] == 1
                       else None)

    async def fault(s):
        t0 = time.perf_counter()
        first = await ask(s, queries, rows[:1])
        secs = time.perf_counter() - t0
        later = await ask(s, queries, rows[1:2])
        return ([repr(x) for x in first], secs, [repr(x) for x in later],
                s.stats.device_faults, s.stats.launches)
    out["fault"] = session(server, fault)
    out["fault_follower"] = (server.stats.device_faults,
                             server.stats.launch_failures)
    return out


def world_1x4(mesh, arrays, queries, rows, dirs):
    """The 1 x 4 world: a reshard 1x4 -> 2x2, then ``restore_server(mesh=)``
    of the 2 x 2 world's snapshots: the newest, the fallback past a
    corrupt newest, and the LSH-sourced primary without a refit."""
    corpus = corpus_from_numpy(*arrays, "cpu")
    index = EmdIndex.build(corpus, EngineConfig(**CONFIG), mesh=mesh)
    out = {"rank": mesh.index("model")}
    server = EmdServer(index, policy())

    async def reshard(s):
        before = await ask(s, queries, rows)
        annotate.reset_traffic()
        s.reshard(plan_mesh(2, 2))
        return before, await ask(s, queries, rows)
    out["reshard"] = session(server, reshard)
    out["reshard_traffic"] = annotate.traffic()
    out["reshard_gen"] = server.generation
    out["reshard_mesh"] = server.mesh.shape
    out["reshard_launches"] = server.stats.launches

    def restore(path, **kw):
        t0 = time.perf_counter()
        s = restore_server(path, policy(**kw), mesh=mesh)
        return s, time.perf_counter() - t0

    server, out["restore_s"] = restore(dirs["snap"])
    out["restored_gen"] = server.generation
    out["restored_doc_ids"] = server.doc_ids
    out["restored"] = session(server, lambda s: ask(s, queries, rows))

    import torch.distributed as dist
    if out["rank"] == 0:
        corrupt_checkpoint(dirs["newest"], leaves=("ids",), seed=1)
    dist.barrier()
    server, _ = restore(dirs["snap"])
    out["fallback_gen"] = server.generation
    out["fallback"] = session(server, lambda s: ask(s, queries, rows))

    fit = CentroidLSHSpec.build

    def refit(*a, **kw):
        raise AssertionError("restore refit the candidate source")
    CentroidLSHSpec.build = refit
    try:
        server, _ = restore(dirs["lsh"], ladder=("primary", "wcd"))
    finally:
        CentroidLSHSpec.build = fit
    out["lsh_leaves"] = [_np(t) for t in
                         server._gen.tiers[0].index.source.leaves()]
    out["lsh"] = session(server, lambda s: ask(s, queries, rows))
    return out
