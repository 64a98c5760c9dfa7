"""The serving half of the port's mesh: ``EmdServer`` over an
``EmdIndex(backend="distributed")`` on a ``torch.distributed`` (data,
model) mesh, its leader and followers, its mutations and reshards,
``runtime.elastic.reshard_live`` and ``restore_server(mesh=)``, against
the JAX package's single-host index and the port's single-process one.

Two worlds of four gloo ranks on the CPU (``launch.local.run_local``; the
rank bodies are ``torch_serving_ranks.py`` and import only the port), each
started once and shared: a 2 x 2 world, then a 1 x 4 world that restores
the 2 x 2 world's snapshots. The corpus and config are JAX's mesh-serving
test's (``tests/test_distributed.py``): 24 rows, a vocabulary of 64, act
with 2 iterations, top-4, rows padded to 8.

Tolerances: a served answer is bitwise its tier's single-process index on
the same padded batch (the launch the server made), and within rtol 1e-5 /
atol 1e-6 of JAX's single-host index on that batch, its indices equal
wherever JAX's scores are separated by twice that from both neighbours.
Every reshard, restore and replay is bitwise the answers it replaces.
"""
import re

import numpy as np
import pytest

import torch_serving_ranks as ranks
from repro.api import EmdIndex as JIndex
from repro.api import EngineConfig as JConfig
from repro.core.lc import Corpus as JCorpus
from repro.data.synth import make_text_like
from repro_torch.api import EmdIndex, EngineConfig, corpus_from_numpy
from repro_torch.launch.local import run_local
from repro_torch.launch.mesh import make_test_mesh, plan_mesh
from repro_torch.serving import EmdServer, snapshot
from repro_torch.serving.policy import resolve_tier
from repro_torch.serving.server import _tier_config

F32_TOL = dict(rtol=1e-5, atol=1e-6)
ROWS = [0, 5, 9, 13, 17, 21, 2, 7]
APPEND_SEED, DELETE = 5, [2, 7, 25]
SPAWN_TIMEOUT = 240


def _jcorpus():
    return make_text_like(n_docs=24, vocab=64, m=8, doc_len=10, hmax=16)[0]


def _arrays(c):
    return tuple(np.asarray(x) for x in (c.ids, c.w, c.coords))


def _mutation():
    extra = make_text_like(n_docs=4, vocab=64, m=8, doc_len=10, hmax=16,
                           seed=APPEND_SEED)[0]
    return {"append": (np.asarray(extra.ids), np.asarray(extra.w)),
            "delete": DELETE}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    arrays = _arrays(_jcorpus())
    queries = arrays[:2]
    dirs = {k: str(tmp_path_factory.mktemp(k)) for k in ("snap", "lsh")}
    a = run_local(ranks.world_2x2, 2, 2,
                  args=(arrays, queries, ROWS, _mutation(), dirs),
                  timeout=SPAWN_TIMEOUT)
    dirs["newest"] = a[0]["snap_path"]
    b = run_local(ranks.world_1x4, 1, 4, args=(arrays, queries, ROWS, dirs),
                  timeout=SPAWN_TIMEOUT)
    return a, b


def _padded(rows, bucket, corpus_arrays=None):
    ids, w = (corpus_arrays or _arrays(_jcorpus()))[:2]
    q_ids = np.zeros((bucket, ids.shape[1]), np.int32)
    q_w = np.zeros((bucket, ids.shape[1]), np.float32)
    q_ids[:len(rows)], q_w[:len(rows)] = ids[rows], w[rows]
    return q_ids, q_w


def _port_index(arrays, tier="primary"):
    cfg = EngineConfig(**dict(ranks.CONFIG, backend="cuda"))
    if tier != "primary":
        cfg = _tier_config(cfg, resolve_tier(tier))
    return EmdIndex.build(corpus_from_numpy(*arrays, "cpu"), cfg,
                          device="cpu")


def _jax_index(arrays, tier="primary"):
    cfg = JConfig(method="act", iters=2, top_l=4)
    if tier == "wcd":
        cfg = JConfig(method="wcd", iters=0, top_l=4)
    return JIndex.build(JCorpus(*arrays), cfg)


def _hold(answers, index, jindex, q_ids, q_w, doc_ids=None):
    """Served answers (one per row of the padded batch, in order) bitwise
    the port's index and within tolerance of JAX's, on that batch."""
    s, i = (x.numpy() for x in index.search(q_ids, q_w))
    js, ji = (np.asarray(x) for x in jindex.search(q_ids, q_w))
    full = np.sort(np.asarray(jindex.scores(q_ids, q_w)), axis=1)
    ext = (lambda x: x) if doc_ids is None else (lambda x: doc_ids[x])
    for k, (_, _, scores, indices) in enumerate(answers):
        np.testing.assert_array_equal(scores, s[k])
        np.testing.assert_array_equal(indices, ext(i[k]))
        np.testing.assert_allclose(scores, js[k], **F32_TOL)
        band = 2 * (F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(js[k]))
        gaps = np.diff(np.concatenate([[-np.inf], js[k], [full[k, 4]]]))
        firm = (gaps[:-1] > band) & (gaps[1:] > band)
        assert firm.any()
        np.testing.assert_array_equal(indices[firm], ext(ji[k])[firm])


def _same(a, b):
    for x, y in zip(a, b, strict=True):
        assert x[0] == y[0]
        np.testing.assert_array_equal(x[2], y[2])
        np.testing.assert_array_equal(x[3], y[3])


# ------------------------------------------------- the 2 x 2 world


def test_mesh_server_builds_every_tier_on_the_mesh(worlds):
    """bench_serve's ladder on a 2 x 2 mesh: every rung's index is on the
    mesh on every rank (the parent built the rungs with no mesh and
    refused a mesh of more than one rank)."""
    a, _ = worlds
    for rank in a:
        assert rank["tier_meshes"] == [True, True, True]


def test_coalesced_requests_make_one_launch_on_every_rank(worlds):
    a, _ = worlds
    assert [r["coalesce_launches"] for r in a] == [1, 1, 1, 1]
    assert a[0]["coalesce_buckets"] == {8: 1}
    assert [len(r["coalesce_batches"]) for r in a] == [1, 1, 1, 1]
    for r in a[1:]:
        for x, y in zip(r["coalesce_batches"][0][1:],
                        a[0]["coalesce_batches"][0][1:]):
            np.testing.assert_array_equal(x, y)


def test_served_answers_match_jax_and_the_cpu_index(worlds):
    a, _ = worlds
    answers = a[0]["coalesce"]
    assert [x[:2] for x in answers] == [("primary", 0)] * 5
    _, q_ids, q_w = a[0]["coalesce_batches"][0]
    np.testing.assert_array_equal((q_ids, q_w), _padded(ROWS[:5], 8))
    arrays = _arrays(_jcorpus())
    _hold(answers, _port_index(arrays), _jax_index(arrays), q_ids, q_w)


def test_wcd_rung_serves_bitwise_its_cpu_index(worlds):
    a, _ = worlds
    answers = a[0]["wcd"]
    assert [x[0] for x in answers] == ["wcd"] * 3
    assert a[0]["wcd_launches"] == 5 and \
        [r["wcd_launches"] for r in a[1:]] == [1, 1, 1]
    arrays = _arrays(_jcorpus())
    _hold(answers, _port_index(arrays, "wcd"), _jax_index(arrays, "wcd"),
          *_padded(ROWS[:3], 4))


def test_inflight_batch_finishes_on_its_generation_on_every_rank(worlds):
    """A retry after an append launches the batch's own generation: the
    followers keep it while the leader's batch holds it."""
    a, _ = worlds
    old, new = a[0]["inflight"]
    assert old[:2] == ("primary", 0) and new[:2] == ("primary", 1)
    arrays = _arrays(_jcorpus())
    s, i = (x.numpy() for x in _port_index(arrays).search(
        *_padded(ROWS[:1], 1)))
    np.testing.assert_array_equal(old[2], s[0])
    np.testing.assert_array_equal(old[3], i[0])


def test_append_delete_match_a_fresh_jax_index(worlds):
    a, _ = worlds
    new_ids, removed, answers = a[0]["mutate"]
    np.testing.assert_array_equal(new_ids, [24, 25, 26, 27])
    assert removed == 3 and a[0]["mutate_gen"] == 2
    assert {x[1] for x in answers} == {2}
    ids, w, coords = _arrays(_jcorpus())
    extra = _mutation()["append"]
    doc_ids = np.arange(28)
    keep = ~np.isin(doc_ids, DELETE)
    mutated = (np.concatenate([ids, extra[0]])[keep],
               np.concatenate([w, extra[1]])[keep], coords)
    _hold(answers, _port_index(mutated), _jax_index(mutated),
          *_padded(ROWS, 8), doc_ids=doc_ids[keep])


def test_reshard_2x2_to_1x2_to_2x2_keeps_answers(worlds):
    """Half the world goes and comes back (JAX's 4x2 -> 2x2 -> 4x2): one
    generation a reshard, the same bits, and no row moves (every rank
    slices its rows from the corpus it holds); only commands cross."""
    a, _ = worlds
    before, half, back = a[0]["reshard"]
    assert [{x[1] for x in r} for r in (before, half, back)] == \
        [{2}, {3}, {4}]
    _same(before, half)
    _same(before, back)
    for r in a:
        assert r["reshard_gen"] == 4
        assert r["reshard_mesh"] == {"data": 2, "model": 2}
        assert r["reshard_traffic"]["control"] > 0
        assert "reshard" not in r["reshard_traffic"]


def test_reshard_live_is_bitwise_a_fresh_build_and_serves(worlds):
    """JAX's 8 -> 4 -> 8 on the built tables: 2x2 -> 1x2 -> 2x2."""
    a, _ = worlds
    for r in a[:2]:
        for k, t in r["live_down"].items():
            np.testing.assert_array_equal(t, r["live_down_fresh"][k])
        for x, y in zip(r["live_down_search"], r["live_want"]):
            np.testing.assert_array_equal(x, y)
    for r in a[2:]:
        assert r["live_down"] is None
    for r in a:
        for k, t in r["live_up"].items():
            np.testing.assert_array_equal(t, r["live_up_first"][k])
        for x, y in zip(r["live_up_search"], r["live_want"]):
            np.testing.assert_array_equal(x, y)
    # Ranks 2 and 3 receive their whole shard: rows, weights and coords.
    shard = sum(t.nbytes for t in a[2]["live_up"].values())
    assert a[2]["live_up_traffic"]["reshard"] > shard
    assert a[0]["live_up_traffic"]["reshard"] < shard


def test_chaos_replay_is_identical_and_bitwise(worlds):
    a, _ = worlds
    first, second = a[0]["chaos"]
    assert first["log"] == second["log"]
    assert any(e[2] == "fail" for e in first["log"])
    for x, y in zip(first["results"], second["results"], strict=True):
        if x == ("SHED",):
            assert y == ("SHED",)
            continue
        assert x[:2] == y[:2]
        np.testing.assert_array_equal(x[2], y[2])
        np.testing.assert_array_equal(x[3], y[3])
    for r in a:
        for run in r["chaos"]:
            assert run["launches"] == a[0]["chaos"][0]["launches"]
            assert run["replay"] and all(run["replay"])


def test_follower_kernel_error_is_a_leader_device_fault(worlds):
    """Rank 1's kernel error fails the batch on the leader as a device
    fault once the mesh's collectives time out, and the server refuses
    what follows; every rank returns (the world ended)."""
    a, _ = worlds
    first, secs, later, faults, launches = a[0]["fault"]
    assert len(first) == 1 and first[0].startswith("MeshFault(")
    failed = re.search(r"failed on world ranks \[([0-9, ]+)\]", first[0])
    assert 1 in {int(r) for r in failed.group(1).split(",")}
    assert ranks.FAULT_TIMEOUT <= secs < 8 * ranks.FAULT_TIMEOUT
    assert "stopped serving after a device fault" in later[0]
    assert faults == 1 and launches == 1
    assert a[1]["fault_follower"] == (1, 1)


def test_mesh_server_serves_after_an_idle_spell(worlds):
    """A follower waits for the leader's next command however long the
    server idles: here longer than twice the mesh's timeout (the limit
    of a command's own waits), and the next request is served on every
    rank."""
    a, _ = worlds
    first, second = (x[0] for x in a[0]["idle"])
    assert ranks.IDLE_S > 2 * ranks.IDLE_MESH_TIMEOUT
    assert first[:2] == second[:2] == ("primary", 0)
    np.testing.assert_array_equal(first[2], second[2])
    np.testing.assert_array_equal(first[3], second[3])
    assert [r["idle_launches"] for r in a] == [2] * 4


# ------------------------------------------------- the 1 x 4 world


def test_reshard_1x4_to_2x2_keeps_answers(worlds):
    """The model axis changes and the rows split anew."""
    _, b = worlds
    before, after = b[0]["reshard"]
    assert {x[1] for x in before} == {0} and {x[1] for x in after} == {1}
    _same(before, after)
    for r in b:
        assert r["reshard_gen"] == 1
        assert r["reshard_mesh"] == {"data": 2, "model": 2}
        assert r["reshard_launches"] == 2
        assert r["reshard_traffic"]["control"] > 0
        assert "reshard" not in r["reshard_traffic"]


def test_restore_on_1x4_from_a_2x2_snapshot(worlds):
    a, b = worlds
    for r in b:
        assert r["restored_gen"] == 4 and r["restore_s"] > 0
        np.testing.assert_array_equal(r["restored_doc_ids"],
                                      np.setdiff1d(np.arange(28), DELETE))
    _same(b[0]["restored"], a[0]["reshard"][2])
    assert {x[1] for x in b[0]["restored"]} == {4}


def test_restore_falls_back_past_a_corrupt_newest(worlds):
    a, b = worlds
    assert [r["fallback_gen"] for r in b] == [2] * 4
    _same(b[0]["fallback"], a[0]["mutate"][2])


def test_lsh_primary_restores_without_refit(worlds):
    a, b = worlds
    for r in b:
        for x, y in zip(r["lsh_leaves"], a[0]["lsh_leaves"], strict=True):
            np.testing.assert_array_equal(x, y)
    _same(b[0]["lsh"], a[0]["lsh"])
    assert {x[0] for x in b[0]["lsh"]} == {"primary"}


# ------------------------------------------------- one process


def test_one_rank_mesh_server_reshards_and_snapshots(tmp_path):
    """A distributed index on the 1 x 1 mesh with no process group serves
    bench_serve's ladder; a reshard onto another such mesh is one
    generation with the same bits, and the snapshot is the leader's."""
    import asyncio
    arrays = _arrays(_jcorpus())
    index = EmdIndex.build(corpus_from_numpy(*arrays, "cpu"),
                           EngineConfig(**ranks.CONFIG), device="cpu")
    server = EmdServer(index, ranks.policy())
    assert server.is_leader and server.mesh is index.mesh

    async def go():
        async with server:
            before = await ranks.ask(server, arrays[:2], ROWS)
            server.reshard(make_test_mesh(1, 1, backend="gloo",
                                          device="cpu"))
            return before, await ranks.ask(server, arrays[:2], ROWS)
    before, after = asyncio.run(go())
    _same(before, after)
    assert {x[1] for x in after} == {1}
    assert snapshot(server, str(tmp_path)).endswith("step_00000001")
    with pytest.raises(ValueError, match="needs an initialized process"):
        server.reshard(plan_mesh(1, 1, ranks=(0,)))
    with pytest.raises(ValueError, match="Mesh, got str"):
        server.reshard("1x1")


class _Channel:
    """A leader's control channel that fails at ``where``: sending a
    command, or in the status exchange after it."""
    is_leader, leader, rank, world = True, 0, 0, 4

    def __init__(self, where):
        self.where, self.sent = where, 0

    def send(self, *args):
        self.sent += 1
        if self.where == "send":
            raise RuntimeError("Connection closed by peer")

    def statuses(self, status):
        raise RuntimeError("Timed out waiting for the status exchange")


@pytest.mark.parametrize("where", ["send", "statuses"])
def test_a_failed_control_channel_is_a_device_fault(where):
    """A broadcast or status exchange that fails on the leader is a
    MeshFault: no retry, no cheaper rung, the server refuses what
    follows and sends nothing more (stop included)."""
    import asyncio
    arrays = _arrays(_jcorpus())
    index = EmdIndex.build(corpus_from_numpy(*arrays, "cpu"),
                           EngineConfig(**ranks.CONFIG), device="cpu")
    server = EmdServer(index, ranks.policy())
    channel = server._control = _Channel(where)

    async def go():
        async with server:
            first = await ranks.ask(server, arrays[:2], ROWS[:1])
            later = await ranks.ask(server, arrays[:2], ROWS[1:2])
            return first, later
    first, later = asyncio.run(go())
    assert type(first[0]).__name__ == "MeshFault"
    assert "control channel failed" in str(first[0])
    assert "stopped serving after a device fault" in str(later[0])
    st = server.stats
    assert (st.launches, st.launch_failures, st.device_faults) == (1, 1, 1)
    with pytest.raises(RuntimeError, match="stopped serving"):
        server.append(*(np.array(x[:1]) for x in arrays[:2]))
    assert channel.sent == 1
