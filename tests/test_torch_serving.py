"""The port's serving runtime (``repro_torch.serving``): micro-batching,
degradation, chaos, lifecycle, against the JAX package's.

Each of the 19 cases of ``tests/test_serving.py`` has its counterpart here,
on the JAX suite's own fixture through the port's ``EmdIndex`` on the CPU
(the kernels' plain versions). The bit-identity bar is JAX's: a request
served at the primary tier is bitwise ``index.search`` of that query alone
(``(h,)``, the single-query engine), although the server launches it in a
padded batch; on the CPU the port's batched and single-query engines agree
bitwise on this fixture. Beyond the JAX suite: a request's answer does not
depend on its bucket or on the other requests of its launch;
``ChaosSchedule.from_seed`` is JAX's; the same requests under the same
schedule give JAX's tier sequence, and answers within rtol 1e-5 / atol
1e-6 of JAX's (indices equal where the scores are separated); a
JAX-written snapshot restores in the port and a port-written one in JAX,
a candidate source's tables included; a device fault (a CUDA error, a
kernel's build or launch error) is not retried or degraded.
"""
import asyncio
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.api import EmdIndex as JIndex
from repro.api import EngineConfig as JConfig
from repro.candidates import CentroidLSHSpec as JLSHSpec
from repro.cascade import CascadeSpec as JCascadeSpec
from repro.cascade import CascadeStage as JStage
from repro.data.synth import make_text_like
from repro_torch.api import EmdIndex, EngineConfig, corpus_from_numpy
from repro_torch.candidates import CentroidLSHSpec
from repro_torch.cascade import CascadeSpec, CascadeStage
from repro_torch.cascade.spec import CASCADES
from repro_torch.checkpoint.store import CheckpointCorrupt
from repro_torch.kernels._build import KernelError
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.serving import (TIER_RECALL, ChaosInjector, ChaosSchedule,
                                 EmdServer, ServerOverloaded, ServingPolicy,
                                 ServingTier, corrupt_checkpoint,
                                 resolve_tier, restore_latest,
                                 restore_server, snapshot, validate_ladder)
from repro_torch.serving import lifecycle
from repro_torch.serving.server import _tier_config

pytestmark = pytest.mark.chaos

F32_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jcorpus():
    return make_text_like(n_docs=24, vocab=48, m=8, doc_len=12, hmax=12)[0]


@pytest.fixture(scope="module")
def corpus(jcorpus):
    return corpus_from_numpy(jcorpus.ids, jcorpus.w, jcorpus.coords, "cpu")


@pytest.fixture(scope="module")
def config():
    return EngineConfig(method="act", iters=2, top_l=4)


@pytest.fixture(scope="module")
def index(corpus, config):
    return EmdIndex.build(corpus, config, device="cpu")


def q(corpus, k):
    """Row ``k`` of the corpus as one ``(h,)`` query, numpy."""
    return corpus.ids[k].numpy(), corpus.w[k].numpy()


def policy(**kw):
    kw.setdefault("ladder", ("primary", "wcd"))
    kw.setdefault("max_batch", 4)
    kw.setdefault("flush_ms", 20.0)
    kw.setdefault("backoff_ms", 0.0)
    kw.setdefault("max_retries", 1)
    kw.setdefault("deadline_ms", 10_000.0)
    return ServingPolicy(**kw)


def jpolicy(**kw):
    return jserving.ServingPolicy(**dataclasses.asdict(policy(**kw)))


def run(coro):
    return asyncio.run(coro)


def assert_direct(res, index, corpus, k):
    s, i = index.search(*q(corpus, k))
    np.testing.assert_array_equal(res.scores, s.numpy())
    np.testing.assert_array_equal(res.indices, i.numpy())


def tier_index(corpus, config, name):
    return EmdIndex.build(corpus, _tier_config(config, resolve_tier(name)),
                          device="cpu")


# --------------------------------------------------------------- parity
def test_single_query_bit_identical_to_direct_search(index, corpus):
    async def go():
        async with EmdServer(index, policy()) as server:
            return await server.search(*q(corpus, 0))
    res = run(go())
    assert_direct(res, index, corpus, 0)
    assert res.tier == "primary" and not res.degraded
    assert res.expected_recall == 1.0 and res.generation == 0


def test_microbatch_coalesces_and_pads_to_bucket(index, corpus):
    async def go():
        async with EmdServer(index, policy()) as server:
            outs = await asyncio.gather(*[
                server.search(*q(corpus, k)) for k in range(3)])
            return outs, server.stats
    outs, stats = run(go())
    assert stats.launches == 1 and stats.flushes == 1
    assert stats.bucket_launches == {4: 1}
    assert stats.tier_served == {"primary": 3}
    for k, o in enumerate(outs):
        assert_direct(o, index, corpus, k)


def test_bucket_is_next_pow2_capped_at_max_batch(index):
    async def go():
        async with EmdServer(index, policy(max_batch=8)) as server:
            return [server._bucket(n) for n in (1, 2, 3, 5, 8, 9)]
    assert run(go()) == [1, 2, 4, 8, 8, 8]


def test_requires_running_server_and_single_query(index, corpus):
    server = EmdServer(index, policy())

    async def not_running():
        with pytest.raises(RuntimeError, match="not running"):
            await server.search(*q(corpus, 0))

    async def batched_query():
        async with EmdServer(index, policy()) as srv:
            with pytest.raises(ValueError, match=r"one \(h,\) query"):
                await srv.search(corpus.ids[:2].numpy(),
                                 corpus.w[:2].numpy())
    run(not_running())
    run(batched_query())


# --------------------------------------------------- chaos: degradation
def test_injected_failures_degrade_with_correct_labeled_results(
        index, corpus, config):
    chaos = ChaosInjector(ChaosSchedule(fail_launches=frozenset({1, 2})))

    async def go():
        async with EmdServer(index, policy(),
                             launch_hook=chaos) as server:
            a = await server.search(*q(corpus, 0))
            b = await server.search(*q(corpus, 1))
            return a, b, server.stats
    a, b, stats = run(go())
    assert a.tier == "primary" and not a.degraded
    assert b.tier == "wcd" and b.degraded and b.retries == 2
    assert [e[2] for e in chaos.log] == ["ok", "fail", "fail", "ok"]
    assert stats.launch_failures == 2 and stats.device_faults == 0
    assert_direct(b, tier_index(corpus, config, "wcd"), corpus, 1)


def test_retry_with_backoff_recovers_without_degrading(index, corpus):
    chaos = ChaosInjector(ChaosSchedule(fail_launches=frozenset({0})))

    async def go():
        async with EmdServer(index, policy(max_retries=2),
                             launch_hook=chaos) as server:
            return await server.search(*q(corpus, 0))
    res = run(go())
    assert res.tier == "primary" and not res.degraded and res.retries == 1
    assert_direct(res, index, corpus, 0)


def test_ladder_exhaustion_sheds_with_fast_fail(index, corpus):
    chaos = ChaosInjector(ChaosSchedule(
        fail_launches=frozenset(range(16))))

    async def go():
        async with EmdServer(index, policy(),
                             launch_hook=chaos) as server:
            with pytest.raises(ServerOverloaded, match="ladder"):
                await server.search(*q(corpus, 0))
            return server.stats
    stats = run(go())
    assert stats.shed == 1
    assert stats.launch_failures == 4      # 2 tiers x (1 + max_retries)


def test_all_requests_complete_under_random_faults(index, corpus, config):
    sched = ChaosSchedule.from_seed(7, horizon=64, p_fail=0.3)
    chaos = ChaosInjector(sched)
    n_req = 12

    async def go():
        async with EmdServer(index, policy(max_batch=2),
                             launch_hook=chaos) as server:
            return await asyncio.gather(
                *[server.search(*q(corpus, k % corpus.n))
                  for k in range(n_req)], return_exceptions=True)
    outs = run(go())
    assert len(outs) == n_req
    direct = {"primary": index}
    for k, o in enumerate(outs):
        if isinstance(o, ServerOverloaded):
            continue                        # shed = completed, fast-failed
        assert not isinstance(o, BaseException), o
        if o.tier not in direct:
            direct[o.tier] = tier_index(corpus, config, o.tier)
        assert_direct(o, direct[o.tier], corpus, k % corpus.n)
        assert o.degraded == (o.tier != "primary")


def _mix(index, corpus, seed):
    chaos = ChaosInjector(ChaosSchedule.from_seed(seed, horizon=32,
                                                  p_fail=0.4))

    async def go():
        async with EmdServer(index, policy(),
                             launch_hook=chaos) as server:
            outs = []
            for k in range(6):
                try:
                    outs.append(await server.search(*q(corpus, k)))
                except ServerOverloaded:
                    outs.append("SHED")
            return outs, chaos.log
    return run(go())


def test_chaos_schedule_deterministic_under_seed(index, corpus):
    outs_a, log_a = _mix(index, corpus, 3)
    outs_b, log_b = _mix(index, corpus, 3)
    tiers = [getattr(o, "tier", o) for o in outs_a]
    assert tiers == [getattr(o, "tier", o) for o in outs_b]
    assert log_a == log_b
    for a, b in zip(outs_a, outs_b, strict=True):
        if a != "SHED":
            np.testing.assert_array_equal(a.scores, b.scores)
            np.testing.assert_array_equal(a.indices, b.indices)
    assert ChaosSchedule.from_seed(3, 32, p_fail=0.4) == \
        ChaosSchedule.from_seed(3, 32, p_fail=0.4)


def test_deadline_pressure_starts_batch_down_ladder(index, corpus):
    async def go():
        async with EmdServer(index, policy(headroom=1.0)) as server:
            server.stats.tier_latency_ms["primary"] = 1000.0
            return await server.search(*q(corpus, 0), deadline_ms=50.0)
    res = run(go())
    assert res.tier == "wcd" and res.degraded


# ----------------------------------------------------- ladder validation
def test_ladder_validated_before_traffic(index, corpus, config):
    with pytest.raises(ValueError, match="unknown ladder rung"):
        EmdServer(index, policy(ladder=("primary", "nope")))
    with pytest.raises(ValueError, match="duplicate"):
        EmdServer(index, policy(ladder=("primary", "wcd", "wcd")))
    with pytest.raises(ValueError, match="cannot serve"):
        validate_ladder(policy(ladder=("primary", "fast")), config,
                        n=2, top_l=4)


def test_resolve_tier_covers_presets_methods_and_specs():
    assert resolve_tier("primary").name == "primary"
    fast = resolve_tier("fast")
    assert fast.cascade is CASCADES["fast"]
    assert fast.expected_recall == 0.95
    wcd = resolve_tier("wcd")
    assert wcd.method == "wcd" and wcd.cascade is None
    spec_tier = resolve_tier(CASCADES["chain"])
    assert spec_tier.cascade is CASCADES["chain"]
    assert spec_tier.expected_recall == 1.0
    with pytest.raises(ValueError, match="both cascade and method"):
        ServingTier(name="bad", cascade=CASCADES["fast"], method="wcd")
    assert TIER_RECALL == jserving.TIER_RECALL


def test_cascade_preset_rung_serves_through_cascade(index, corpus, config):
    chaos = ChaosInjector(ChaosSchedule(fail_launches=frozenset({0, 1})))

    async def go():
        async with EmdServer(index, policy(ladder=("primary", "chain")),
                             launch_hook=chaos) as server:
            return await server.search(*q(corpus, 2))
    res = run(go())
    assert res.tier == "chain" and res.degraded
    assert res.expected_recall == 1.0
    chain = EmdIndex.build(
        corpus, dataclasses.replace(config, cascade=CASCADES["chain"]),
        device="cpu")
    assert_direct(res, chain, corpus, 2)


# ----------------------------------------------------- corpus mutation
def test_append_and_delete_keep_external_ids_stable(index, corpus):
    async def go():
        async with EmdServer(index, policy()) as server:
            new_ids = server.append(corpus.ids[:3].numpy(),
                                    corpus.w[:3].numpy())
            assert new_ids.tolist() == [24, 25, 26]
            assert server.generation == 1 and server.corpus.n == 27
            r = await server.search(*q(corpus, 0))
            assert {0, 24} <= set(r.indices.tolist())
            assert r.generation == 1
            removed = server.delete([24, 26])
            assert removed == 2 and server.generation == 2
            assert server.corpus.n == 25
            assert 25 in server.doc_ids.tolist()
            r2 = await server.search(*q(corpus, 1))
            assert {1, 25} <= set(r2.indices.tolist())
            with pytest.raises(KeyError, match="unknown doc ids"):
                server.delete([24])
            with pytest.raises(ValueError, match="top_l"):
                server.delete(server.doc_ids[:-2].tolist())
            with pytest.raises(ValueError, match="rows"):
                server.append(np.zeros((2, 5), np.int32),
                              np.zeros((2, 5), np.float32))
            with pytest.raises(ValueError, match="vocabulary"):
                server.append(np.full((1, 12), 48, np.int32),
                              np.zeros((1, 12), np.float32))
    run(go())


def test_inflight_batch_finishes_on_old_generation(index, corpus):
    async def go():
        async with EmdServer(index, policy(flush_ms=50.0)) as server:
            fut = asyncio.ensure_future(server.search(*q(corpus, 0)))
            await asyncio.sleep(0)
            server.append(corpus.ids[:1].numpy(), corpus.w[:1].numpy())
            res = await fut
            assert res.generation in (0, 1)
            if res.generation == 0:
                assert_direct(res, index, corpus, 0)
    run(go())


# ------------------------------------------------- snapshot / restore
def test_snapshot_kill_restore_parity(index, corpus, tmp_path):
    d = str(tmp_path / "snap")

    async def serve_and_snapshot():
        async with EmdServer(index, policy()) as server:
            server.append(corpus.ids[:2].numpy(), corpus.w[:2].numpy())
            server.delete([24])
            res = await server.search(*q(corpus, 0))
            snapshot(server, d)
            return res

    async def restore_and_serve():
        server = restore_server(d, policy(), device="cpu")
        async with server:
            assert server.generation == 2
            assert server.corpus.n == 25
            assert 25 in server.doc_ids.tolist()
            res = await server.search(*q(corpus, 0))
            assert server.append(corpus.ids[:1].numpy(),
                                 corpus.w[:1].numpy()).tolist() == [26]
            return res

    before = run(serve_and_snapshot())
    after = run(restore_and_serve())
    np.testing.assert_array_equal(before.scores, after.scores)
    np.testing.assert_array_equal(before.indices, after.indices)


def test_corrupt_newest_snapshot_falls_back_to_previous(
        index, corpus, tmp_path):
    d = str(tmp_path / "snap")

    async def go():
        async with EmdServer(index, policy()) as server:
            p0 = snapshot(server, d)
            server.append(corpus.ids[:1].numpy(), corpus.w[:1].numpy())
            p1 = snapshot(server, d)
            return p0, p1
    _, p1 = run(go())
    corrupt_checkpoint(p1, leaves=("ids",), seed=1)
    with pytest.raises(CheckpointCorrupt):
        restore_server(d, policy(), generation=1, device="cpu")
    snap = restore_latest(d)
    assert snap.generation == 0 and snap.corpus.n == 24

    async def verify():
        server = restore_server(d, policy(), device="cpu")
        async with server:
            assert server.generation == 0
            res = await server.search(*q(corpus, 0))
            assert_direct(res, index, corpus, 0)
    run(verify())


def test_every_snapshot_corrupt_is_a_typed_failure(index, tmp_path):
    d = str(tmp_path / "snap")

    async def go():
        async with EmdServer(index, policy()) as server:
            return snapshot(server, d)
    p = run(go())
    corrupt_checkpoint(p, seed=2)
    with pytest.raises(CheckpointCorrupt, match="no intact"):
        restore_latest(d)


def test_stop_drains_queued_requests(index, corpus):
    async def go():
        server = EmdServer(index, policy(flush_ms=1000.0, max_batch=8))
        await server.start()
        futs = [asyncio.ensure_future(server.search(*q(corpus, k)))
                for k in range(2)]
        await asyncio.sleep(0)
        await server.stop()
        return await asyncio.gather(*futs)
    outs = run(go())
    assert all(o.tier == "primary" for o in outs)


# --------------------------------------------------- beyond the JAX suite
class Recorder:
    """A launch hook that records each launch's padded batch and result
    and injects nothing."""

    def __init__(self):
        self.launches = []

    def __call__(self, launch_fn, tier, q_ids, q_w):
        out = launch_fn(tier, q_ids, q_w)
        self.launches.append((tier.name, q_ids.copy(), q_w.copy(), out))
        return out


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_answer_is_batch_invariant(corpus, config, backend):
    """One request alone (bucket 1), in a bucket of 4 with a padded slot,
    and among 3 others (bucket 4, full) gets the same bits; and every
    launch's rows are the index's search of that padded batch."""
    index = EmdIndex.build(corpus, dataclasses.replace(config,
                                                       backend=backend),
                           device="cpu")
    rec = Recorder()

    async def go():
        async with EmdServer(index, policy(), launch_hook=rec) as server:
            alone = await server.search(*q(corpus, 5))
            three = await asyncio.gather(*[server.search(*q(corpus, k))
                                           for k in (5, 9, 13)])
            four = await asyncio.gather(*[server.search(*q(corpus, k))
                                          for k in (17, 5, 2, 20)])
            return alone, three[0], four[1], server.stats
    alone, in_three, in_four, stats = run(go())
    assert stats.bucket_launches == {1: 1, 4: 2}
    for other in (in_three, in_four):
        np.testing.assert_array_equal(alone.scores, other.scores)
        np.testing.assert_array_equal(alone.indices, other.indices)
    assert_direct(alone, index, corpus, 5)
    for _, q_ids, q_w, (scores, idx) in rec.launches:
        s, i = index.search(q_ids, q_w)
        np.testing.assert_array_equal(scores, s.numpy())
        np.testing.assert_array_equal(idx, i.numpy())


@pytest.mark.parametrize("seed,horizon,p_fail,p_delay", [
    (0, 512, 0.1, 0.0), (3, 32, 0.4, 0.0), (7, 64, 0.3, 0.2),
    (17, 256, 0.25, 0.1)])
def test_chaos_schedule_equals_jax(seed, horizon, p_fail, p_delay):
    got = ChaosSchedule.from_seed(seed, horizon, p_fail=p_fail,
                                  p_delay=p_delay)
    want = jserving.ChaosSchedule.from_seed(seed, horizon, p_fail=p_fail,
                                            p_delay=p_delay)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _assert_within(got, want):
    """Scores within rtol 1e-5 / atol 1e-6; indices equal where JAX's
    scores are separated by twice that from both neighbours (the last rank
    against its predecessor only)."""
    ws = np.asarray(want.scores)
    np.testing.assert_allclose(got.scores, ws, **F32_TOL)
    tol = 2 * (F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(ws))
    gap = np.diff(ws)
    firm = np.ones(ws.shape, bool)
    firm[1:] &= gap > tol[1:]
    firm[:-1] &= gap > tol[:-1]
    assert (got.indices == np.asarray(want.indices))[firm].all()


def test_same_schedule_gives_jax_tier_mix(jcorpus, index, corpus):
    """The same sequential requests under the same seeded schedule: the
    port's server takes JAX's tiers, retries and sheds, request by
    request, with answers within the parity bars."""
    jindex = JIndex.build(jcorpus, JConfig(method="act", iters=2, top_l=4))
    sched = ChaosSchedule.from_seed(11, horizon=128, p_fail=0.35)
    jsched = jserving.ChaosSchedule.from_seed(11, horizon=128, p_fail=0.35)
    assert dataclasses.asdict(sched) == dataclasses.asdict(jsched)

    async def drive(server_cls, idx, pol, hook, overloaded):
        async with server_cls(idx, pol, launch_hook=hook) as server:
            outs = []
            for k in range(10):
                try:
                    outs.append(await server.search(
                        np.asarray(jcorpus.ids[k]), np.asarray(jcorpus.w[k])))
                except overloaded:
                    outs.append(None)
            return outs, server.stats
    ladder = ("primary", "chain", "wcd")
    got, stats = run(drive(EmdServer, index, policy(ladder=ladder),
                           ChaosInjector(sched), ServerOverloaded))
    want, jstats = run(drive(jserving.EmdServer, jindex,
                             jpolicy(ladder=ladder),
                             jserving.ChaosInjector(jsched),
                             jserving.ServerOverloaded))
    assert [None if g is None else (g.tier, g.retries) for g in got] == \
        [None if w is None else (w.tier, w.retries) for w in want]
    assert (stats.launches, stats.launch_failures, stats.shed) == \
        (jstats.launches, jstats.launch_failures, jstats.shed)
    assert stats.tier_served == jstats.tier_served
    assert len({g.tier for g in got if g is not None}) > 1
    for g, w in zip(got, want, strict=True):
        if g is not None:
            _assert_within(g, w)


LSH = dict(n_buckets=4, probes=2, bucket_cap=12)


def _sourced_configs():
    stages = ((("rwmd", 8, 1),), "act", 2)
    port = EngineConfig(
        method="act", iters=2, top_l=4, backend="reference",
        cascade=CascadeSpec(stages=tuple(CascadeStage(*s)
                                         for s in stages[0]),
                            rescorer=stages[1], rescorer_iters=stages[2],
                            source=CentroidLSHSpec(**LSH)))
    jax_ = JConfig(
        method="act", iters=2, top_l=4,
        cascade=JCascadeSpec(stages=tuple(JStage(*s) for s in stages[0]),
                             rescorer=stages[1], rescorer_iters=stages[2],
                             source=JLSHSpec(**LSH)))
    return port, jax_


async def _serve_rows(server, rows, jcorpus):
    async with server:
        return await asyncio.gather(*[server.search(
            np.asarray(jcorpus.ids[k]), np.asarray(jcorpus.w[k]))
            for k in rows])


@pytest.mark.parametrize("sourced", [False, True],
                         ids=["unsourced", "lsh-primary"])
def test_jax_snapshot_restores_in_the_port(jcorpus, tmp_path, sourced):
    """A JAX server's snapshot (after an append and a delete; with a
    sourced primary, its built tables too) restores through the port's
    ``restore_server``: the same generation, ids and tables, no refit,
    answers within the parity bars of JAX's."""
    pcfg, jcfg = _sourced_configs() if sourced else (
        None, JConfig(method="act", iters=2, top_l=4))
    jindex = JIndex.build(jcorpus, jcfg)
    d = str(tmp_path / "snap")

    async def jax_side():
        async with jserving.EmdServer(jindex, jpolicy()) as server:
            server.append(np.asarray(jcorpus.ids[:2]),
                          np.asarray(jcorpus.w[:2]))
            server.delete([3])
            jserving.snapshot(server, d)
            return server
    jserver = run(jax_side())
    want = run(_serve_rows(jserving.restore_server(d, jpolicy()),
                           range(0, 24, 5), jcorpus))
    snap = restore_latest(d)
    assert snap.generation == jserver.generation == 2
    np.testing.assert_array_equal(snap.doc_ids, jserver.doc_ids)
    np.testing.assert_array_equal(snap.corpus.ids.numpy(),
                                  np.asarray(jserver.corpus.ids))
    assert snap.config.backend == "reference"
    if sourced:
        assert snap.config == pcfg
        jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(
            jserver._gen.tiers[0].index.source)]
        for a, b in zip(snap.source.leaves(), jleaves, strict=True):
            np.testing.assert_array_equal(a.numpy(), b)
    server = _restore_without_refit(d)
    got = run(_serve_rows(server, range(0, 24, 5), jcorpus))
    for g, w in zip(got, want, strict=True):
        assert g.generation == w.generation == 2
        _assert_within(g, w)


def _restore_without_refit(d):
    real = CentroidLSHSpec.build

    def refit(*a, **kw):
        raise AssertionError("restore refit the candidate source")
    CentroidLSHSpec.build = refit
    try:
        return restore_server(d, policy(), device="cpu")
    finally:
        CentroidLSHSpec.build = real


@pytest.mark.parametrize("sourced", [False, True],
                         ids=["unsourced", "lsh-primary"])
def test_port_snapshot_restores_in_jax(corpus, jcorpus, tmp_path, sourced):
    pcfg = _sourced_configs()[0] if sourced else EngineConfig(
        method="act", iters=2, top_l=4)
    index = EmdIndex.build(corpus, pcfg, device="cpu")
    d = str(tmp_path / "snap")

    async def port_side():
        async with EmdServer(index, policy()) as server:
            server.append(corpus.ids[:2].numpy(), corpus.w[:2].numpy())
            server.delete([3])
            snapshot(server, d)
            return server
    server = run(port_side())
    jsnap = jserving.restore_latest(d)
    assert jsnap.generation == 2
    np.testing.assert_array_equal(jsnap.doc_ids, server.doc_ids)
    assert jsnap.config.backend == ("reference" if sourced else "pallas")
    if sourced:
        for a, b in zip(server._gen.tiers[0].index.source.leaves(),
                        jax.tree_util.tree_leaves(jsnap.source),
                        strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = run(_serve_rows(restore_server(d, policy(), device="cpu"),
                           range(0, 24, 5), jcorpus))
    got = run(_serve_rows(jserving.restore_server(d, jpolicy()),
                          range(0, 24, 5), jcorpus))
    for g, w in zip(want, got, strict=True):
        assert g.generation == w.generation == 2
        _assert_within(g, w)


def test_config_codec_matches_jax():
    pcfg, jcfg = _sourced_configs()
    d = lifecycle.config_to_dict(pcfg)
    assert d == jserving.lifecycle.config_to_dict(jcfg)
    assert lifecycle.config_from_dict(d) == pcfg
    cuda = EngineConfig(method="rwmd", cascade="fast", precision="bf16")
    on_disk = lifecycle.config_to_dict(cuda)
    assert on_disk["backend"] == "pallas"     # the JAX package's name
    assert jserving.lifecycle.config_from_dict(on_disk).backend == "pallas"
    assert lifecycle.config_from_dict(on_disk) == cuda


@pytest.mark.parametrize("fault", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    KernelError("dist_topk kernel launch failed: invalid argument"),
    KernelError("nvcc failed for dist_topk"),
], ids=["cuda-error", "launch", "build"])
def test_device_fault_is_not_retried_or_degraded(index, corpus, fault):
    """A device fault fails its batch with the fault itself (no retry, no
    cheaper tier), then every queued and later request is refused."""
    calls = []

    def hook(launch_fn, tier, q_ids, q_w):
        calls.append(tier.name)
        if len(calls) == 2:
            raise fault
        return launch_fn(tier, q_ids, q_w)

    async def go():
        async with EmdServer(index, policy(max_retries=3),
                             launch_hook=hook) as server:
            ok = await server.search(*q(corpus, 0))
            with pytest.raises(type(fault)) as got:
                await server.search(*q(corpus, 1))
            assert got.value is fault
            with pytest.raises(RuntimeError, match="device fault"):
                await server.search(*q(corpus, 2))
            return ok, server.stats
    ok, stats = run(go())
    assert ok.tier == "primary"
    assert calls == ["primary", "primary"]
    assert stats.device_faults == 1 and stats.launch_failures == 1
    assert stats.shed == 0


def test_other_exceptions_are_retried(index, corpus):
    """An out-of-memory error does not poison the context: retried."""
    calls = []

    def hook(launch_fn, tier, q_ids, q_w):
        calls.append(tier.name)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return launch_fn(tier, q_ids, q_w)

    async def go():
        async with EmdServer(index, policy(), launch_hook=hook) as server:
            return await server.search(*q(corpus, 0)), server.stats
    res, stats = run(go())
    assert res.tier == "primary" and res.retries == 1
    assert stats.device_faults == 0


def test_mesh_pieces_not_yet_ported(index, corpus, tmp_path):
    """The mesh pieces are ported now (the name is kept from when they
    raised "not yet ported"): ``reshard`` and ``restore_server(mesh=)``
    refuse a non-Mesh by its type; a one-device server's reshard onto a
    1 x 1 mesh is a new generation that answers as before (a
    single-device backend ignores the mesh, as in the JAX package)."""
    server = EmdServer(index, policy())
    with pytest.raises(ValueError, match="reshard takes .*Mesh, got object"):
        server.reshard(object())
    with pytest.raises(ValueError, match="mesh=.*Mesh, got dict"):
        restore_server(str(tmp_path), policy(), mesh={})
    mesh = make_test_mesh(1, 1, backend="gloo", device="cpu")

    async def go():
        async with server:
            before = await server.search(*q(corpus, 3))
            server.reshard(mesh)
            after = await server.search(*q(corpus, 3))
            return before, after
    before, after = run(go())
    assert after.generation == before.generation + 1 == 1
    np.testing.assert_array_equal(before.scores, after.scores)
    np.testing.assert_array_equal(before.indices, after.indices)


def test_server_runs_again_in_a_new_event_loop(index, corpus):
    """A stopped server starts again under another ``asyncio.run`` (each
    run makes its own arrival event; one bound to the first loop left the
    second run's requests waiting forever)."""
    server = EmdServer(index, policy())

    async def go(k):
        async with server:
            return await asyncio.wait_for(server.search(*q(corpus, k)), 30)
    first, second = run(go(1)), run(go(2))
    assert_direct(first, index, corpus, 1)
    assert_direct(second, index, corpus, 2)
    assert server.stats.launches == 2


def test_sourced_primary_serves_and_mutates(corpus, jcorpus):
    """A sourced primary serves through its built source; a mutation
    rebuilds it over the new corpus (the new rows become candidates)."""
    pcfg = _sourced_configs()[0]
    index = EmdIndex.build(corpus, pcfg, device="cpu")

    async def go():
        async with EmdServer(index, policy()) as server:
            a = await server.search(*q(corpus, 0))
            server.append(corpus.ids[:1].numpy(), corpus.w[:1].numpy())
            b = await server.search(*q(corpus, 0))
            return a, b, server
    a, b, server = run(go())
    assert_direct(a, index, corpus, 0)
    assert 24 in b.indices.tolist() and b.generation == 1
    assert server._gen.tiers[0].index.source.rows.numel() > 0
