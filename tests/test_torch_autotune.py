"""The port's tile autotuner (``repro_torch.kernels.autotune``) and the tile
knobs it resolves, on the CPU; one ``cuda``-marked test holds every
admissible variant bitwise to the default on the card.

Counterparts of ``tests/test_autotune.py``: enumeration (every enumerated
tile passes ``analysis.smem.check_launch``, deterministic and without
repeats, the 20 Newsgroups-scale K1 admits its default tile, a hypothesis
sweep), the ``TuneCache`` round trip, cached mode never timing, the
``EngineConfig`` resolution policy (off ignores the cache, cached is
deterministic, an explicit knob wins). Parity with the JAX package: the
cache key rule and the JSON file read the same by either package. The
knobs and ``rev_block`` leave every score bitwise unchanged on the CPU,
where the plain versions ignore the tiles.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data.synth import make_text_like
from repro.kernels import autotune as jautotune
from repro_torch.analysis import smem
from repro_torch.api import EmdIndex, EngineConfig, corpus_from_numpy
from repro_torch.kernels import _build, autotune, ops, timing

# ------------------------------------------------------------ enumeration

FIXED_CASES = (
    ("dist_topk", dict(nq=8, v=2048, h=256, m=64, k=8)),
    ("act_phase2", dict(nq=8, n=4096, h=128, iters=7)),
    ("cand_pour", dict(nq=8, b=256, h=64, iters=3, mode="pour")),
    ("cand_dist", dict(nq=8, b=256, h=500, mode="ict")),
)

#: The 20 Newsgroups workload (configs/emd_20news.py), 16 queries.
NEWS_K1 = dict(nq=16, v=69_682, h=500, m=300, k=8)


@pytest.mark.parametrize("family,dims", FIXED_CASES,
                         ids=[f for f, _ in FIXED_CASES])
def test_every_enumerated_config_passes_check_launch(family, dims):
    cfgs = autotune.admissible_configs(family, dims)
    assert cfgs, (family, dims)
    for cfg in cfgs:
        assert smem.check_launch(f"t:{family}", family, {**dims, **cfg}) \
            == [], (family, cfg)
        assert set(cfg) == {k for k, _ in autotune.FAMILY_KNOBS[family]}


def test_enumeration_is_deterministic_and_deduped():
    for family, dims in FIXED_CASES:
        a = autotune.admissible_configs(family, dims)
        assert a == autotune.admissible_configs(family, dims)
        keys = [tuple(sorted(c.items())) for c in a]
        assert len(keys) == len(set(keys))
        # the family's default tile leads: a tournament's incumbent
        assert a[0] == ops.DEFAULT_TILES[family]
    # the rest ascending; over-budget tiles are left out, not clipped
    k1 = autotune.admissible_configs(*FIXED_CASES[0])
    assert k1[1:] == sorted(k1[1:], key=lambda c: (c["block_v"],
                                                  c["block_h"]))
    k3 = autotune.admissible_configs(*FIXED_CASES[2])
    assert [c["block_n"] for c in k3] == [4, 1, 2, 8]      # 16+ > 48 KB
    assert autotune.admissible_configs("act_phase2_cand",
                                       dict(nq=8, n=64, h=16, iters=3)) \
        == [{}]                                            # K5: fixed


def test_news_scale_dist_topk_admits_its_default():
    """At 20 Newsgroups width K1's default tile (128 rows, 64 bins: 60,160
    B of shared memory, three blocks an SM) is admitted and leads; the
    tiles whose accumulator or shared memory cannot fit never appear."""
    cfgs = autotune.admissible_configs("dist_topk", NEWS_K1)
    assert cfgs[0] == {"block_v": 128, "block_h": 64}
    layout, nbytes = smem.footprint("dist_topk", **NEWS_K1)
    assert nbytes == 60_160 and smem.blocks_per_sm(layout) == 3
    assert layout.grid == (545, 1)
    assert {"block_v": 256, "block_h": 128} in cfgs        # 184,832 B
    assert smem.check_launch("t", "dist_topk",
                             dict(NEWS_K1, block_v=512, block_h=128))
    assert len(cfgs[:autotune.MAX_VARIANTS]) == autotune.MAX_VARIANTS


def test_admissible_configs_hypothesis_property():
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.settings(max_examples=25, deadline=None)
    @hyp.given(v=st.integers(1, 100_000), h=st.integers(1, 1024),
               m=st.integers(1, 512), k=st.integers(1, 16),
               nq=st.integers(1, 512), n=st.integers(1, 70_000))
    def prop(v, h, m, k, nq, n):
        cases = (("dist_topk", dict(nq=nq, v=v, h=h, m=m, k=k)),
                 ("act_phase2", dict(nq=nq, n=n, h=h, iters=k - 1)),
                 ("cand_dist", dict(nq=nq, b=n, h=h, mode="rev_min")))
        for family, dims in cases:
            for cfg in autotune.admissible_configs(family, dims):
                assert smem.check_launch(f"h:{family}", family,
                                         {**dims, **cfg}) == []
    prop()


# ------------------------------------------------------------- TuneCache

def test_tune_cache_round_trip(tmp_path):
    cache = autotune.TuneCache()
    dims = dict(nq=8, v=2048, h=256, m=64, k=8)
    cache.put("dist_topk", dims, {"block_v": 256, "block_h": 32})
    assert cache.get("dist_topk", dims) == {"block_v": 256, "block_h": 32}
    # shape bucketing: 2048 and 1500 share the next-pow2 bucket
    assert cache.get("dist_topk", dict(dims, v=1500)) \
        == {"block_v": 256, "block_h": 32}
    assert cache.get("dist_topk", dict(dims, v=4096)) is None
    assert cache.get("dist_topk", dims, dtype="bfloat16") is None

    path = tmp_path / "tune.json"
    cache.save(str(path))
    loaded = autotune.TuneCache.load(str(path))
    assert loaded.entries == cache.entries
    assert autotune.TuneCache.from_json(cache.to_json()).entries \
        == cache.entries
    # cold-cache states are empty, not errors
    assert autotune.TuneCache.load(None).entries == {}
    assert autotune.TuneCache.load(str(tmp_path / "no.json")).entries == {}


@pytest.mark.parametrize("family,dims", FIXED_CASES + (
    ("cand_pour", dict(nq=16, b=18_828, h=500, iters=0, mode="pour",
                       form="all")),), ids=lambda x: str(x)[:40])
def test_tune_cache_key_and_file_parity_with_jax(tmp_path, family, dims):
    """The key rule is the JAX package's, and a file written by either
    package is read the same by the other."""
    for dtype in ("float32", "bfloat16"):
        assert autotune.TuneCache.key(family, dims, dtype) \
            == jautotune.TuneCache.key(family, dims, dtype)
    pick = ops.DEFAULT_TILES[family]
    port, jax_cache = autotune.TuneCache(), jautotune.TuneCache()
    port.put(family, dims, pick)
    jax_cache.put(family, dims, pick)
    assert port.to_json() == jax_cache.to_json()
    port.save(str(tmp_path / "port.json"))
    jax_cache.save(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() \
        == (tmp_path / "jax.json").read_bytes()
    assert jautotune.TuneCache.load(str(tmp_path / "port.json")).get(
        family, dims) == pick
    assert autotune.TuneCache.load(str(tmp_path / "jax.json")).get(
        family, dims) == pick


def test_tune_cached_mode_never_times(monkeypatch):
    """``mode="cached"`` must not invoke the timing factory nor the timing
    harness at all: a make_run that explodes proves it."""
    def boom(cfg):
        raise AssertionError("cached mode timed a config")
    timing.calls = 0
    dims = dict(nq=8, v=256, h=32, m=16, k=4)
    assert autotune.tune("dist_topk", dims, boom, cache=autotune.TuneCache(),
                         mode="cached") is None
    assert autotune.tune("dist_topk", dims, boom, mode="off") is None
    with pytest.raises(ValueError):
        autotune.tune("dist_topk", dims, boom, mode="sometimes")
    assert timing.calls == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        timing.paired(lambda: None, lambda: None, 1)


def test_force_tournament_keeps_the_incumbent_on_ties(monkeypatch):
    """``force`` times the first MAX_VARIANTS admissible tiles, default
    first, and a challenger must be strictly faster to win."""
    seen = []

    def fake_paired(a, b, reps):
        return 1.0, 1.0, 2.0 if b() == {"block_n": 2} else 1.0
    monkeypatch.setattr(timing, "paired", fake_paired)

    def make_run(cfg):
        seen.append(cfg)
        return lambda: cfg
    cache = autotune.TuneCache()
    dims = dict(nq=8, n=4096, h=128, iters=7)
    pick = autotune.tune("act_phase2", dims, make_run, cache=cache,
                         mode="force")
    assert pick == {"block_n": 2}
    assert seen == autotune.admissible_configs("act_phase2", dims)[
        :autotune.MAX_VARIANTS]
    assert cache.get("act_phase2", dims) == pick


# ------------------------------------------------- EngineConfig resolution

def _corpus():
    c, _ = make_text_like(n_docs=32, n_classes=4, vocab=96, m=8,
                          doc_len=12, hmax=16, seed=3)
    return corpus_from_numpy(c.ids, c.w, c.coords, "cpu")


def test_resolve_config_off_ignores_cache(tmp_path):
    corpus = _corpus()
    path = tmp_path / "tune.json"
    cache = autotune.TuneCache()
    for family, dims in autotune.index_plan(
            corpus, EngineConfig(method="act", iters=2)):
        cache.put(family, dims, {"block_v": 64, "block_h": 32,
                                 "block_n": 4})
    cache.save(str(path))
    cfg = EngineConfig(method="act", iters=2, autotune="off",
                       tune_cache=str(path))
    out, picks = autotune.resolve_config(corpus, cfg)
    assert out is cfg and picks == {}
    idx = EmdIndex.build(corpus, cfg, device="cpu")
    assert idx.tuned_blocks == {} and idx.config == cfg


def test_resolve_config_cached_is_deterministic(tmp_path):
    corpus = _corpus()
    cfg0 = EngineConfig(method="act", iters=2)
    plan = autotune.index_plan(corpus, cfg0)
    assert [f for f, _ in plan] == ["dist_topk", "act_phase2"]
    path = tmp_path / "tune.json"
    cache = autotune.TuneCache()
    cache.put("dist_topk", plan[0][1], {"block_v": 64, "block_h": 32})
    cache.save(str(path))

    cfg = dataclasses.replace(cfg0, autotune="cached",
                              tune_cache=str(path))
    timing.calls = 0
    out1, picks1 = autotune.resolve_config(corpus, cfg)
    out2, picks2 = autotune.resolve_config(corpus, cfg)
    assert timing.calls == 0
    assert out1 == out2 and picks1 == picks2      # never times -> stable
    assert out1.block_v == 64 and out1.block_h == 32
    assert picks1 == {"dist_topk": {"block_v": 64, "block_h": 32}}
    # act_phase2 missed the cache: block_n keeps its dataclass default
    assert out1.block_n is None

    idx = EmdIndex.build(corpus, cfg, device="cpu")
    assert idx.tuned_blocks == picks1
    assert idx.config.block_v == 64


def test_resolve_config_explicit_override_wins(tmp_path):
    corpus = _corpus()
    plan = autotune.index_plan(corpus, EngineConfig(method="act", iters=2))
    path = tmp_path / "tune.json"
    cache = autotune.TuneCache()
    cache.put("dist_topk", plan[0][1], {"block_v": 64, "block_h": 32})
    cache.save(str(path))
    cfg = EngineConfig(method="act", iters=2, autotune="cached",
                       tune_cache=str(path), block_v=128)
    out, picks = autotune.resolve_config(corpus, cfg)
    assert out.block_v == 128                     # explicit knob held
    assert out.block_h == 32                      # default knob replaced
    assert picks == {"dist_topk": {"block_h": 32}}


def test_shared_block_n_goes_to_the_first_planned_family(tmp_path):
    corpus = _corpus()
    cfg = EngineConfig(method="act", iters=1, cascade="tight")
    plan = autotune.index_plan(corpus, cfg)
    # the method's engine, tight's rwmd stage 1 (K1, K3's dump), its act-3
    # stage and ict rescorer on candidate rows
    assert [(f, d.get("k", d.get("mode"))) for f, d in plan] == [
        ("dist_topk", 2), ("act_phase2", None), ("dist_topk", 1),
        ("cand_pour", "pour"), ("dist_topk", 4), ("cand_pour", "pour"),
        ("cand_dist", "ict")]
    cache = autotune.TuneCache()
    cache.put("act_phase2", plan[1][1], {"block_n": 8})
    cache.put("cand_pour", plan[3][1], {"block_n": 2})
    path = tmp_path / "tune.json"
    cache.save(str(path))
    tuned = dataclasses.replace(cfg, autotune="cached", tune_cache=str(path))
    out, picks = autotune.resolve_config(corpus, tuned)
    assert out.block_n == 8 and picks == {"act_phase2": {"block_n": 8}}
    # a pick the fused K2 takes but K3's dump, which stage 1 launches,
    # cannot (64 KB of static shared memory) is refused, not applied
    cache.put("act_phase2", plan[1][1], {"block_n": 16})
    cache.save(str(path))
    with pytest.raises(ValueError, match=r"block_n.*16.*cand_pour"):
        autotune.resolve_config(corpus, tuned)


def test_force_times_only_tiles_every_planned_launch_takes(tmp_path,
                                                           monkeypatch):
    """``force`` on the tight cascade: the fused K2 comes first for
    ``block_n``, and its candidates leave out 16 and 32 warps, which K3's
    dump (stage 1) cannot take; the winners go to the cache file."""
    import types
    timed = {}

    def fake_runner(family, dims, corpus, configs):
        timed.setdefault(family, []).append(list(configs))
        return lambda cfg: (lambda: cfg)
    monkeypatch.setattr(autotune, "_runner", fake_runner)
    monkeypatch.setattr(timing, "paired", lambda a, b, reps: (1, 1, 1.0))
    c = _corpus()
    fake = types.SimpleNamespace(n=c.n, hmax=c.hmax, v=c.v, m=c.m,
                                 device=torch.device("cuda"))
    path = tmp_path / "tune.json"
    cfg = EngineConfig(cascade="tight", autotune="force",
                       tune_cache=str(path))
    out, picks = autotune.resolve_config(fake, cfg)
    assert [c["block_n"] for c in timed["act_phase2"][0]] == [8, 1, 2, 4]
    assert "cand_pour" not in timed and "cand_dist" not in timed
    assert picks == {"dist_topk": ops.DEFAULT_TILES["dist_topk"],
                     "act_phase2": {"block_n": 8}}
    assert autotune.TuneCache.load(str(path)).entries


def test_cached_entry_the_port_cannot_build_raises(tmp_path):
    corpus = _corpus()
    cfg = EngineConfig(method="rwmd")
    plan = autotune.index_plan(corpus, cfg)
    assert [f for f, _ in plan] == ["dist_topk", "cand_pour"]
    cache = autotune.TuneCache()
    cache.put("cand_pour", plan[1][1], {"block_n": 32})   # 128 KB static
    path = tmp_path / "tune.json"
    cache.save(str(path))
    with pytest.raises(ValueError, match=r"block_n.*32.*cand_pour.*static "
                                         r"shared memory"):
        EmdIndex.build(corpus, dataclasses.replace(
            cfg, autotune="cached", tune_cache=str(path)), device="cpu")


def test_explicit_tile_a_planned_launch_cannot_take_raises_at_build():
    corpus = _corpus()
    # block_n=16 suits the fused K2 but not K3's corpus-row entry (64 KB
    # of static shared memory), which LC-RWMD launches.
    cfg = EngineConfig(method="rwmd", block_n=16)
    with pytest.raises(ValueError, match=r"block_n.*16.*cand_pour"):
        EmdIndex.build(corpus, cfg, device="cpu")
    assert EmdIndex.build(corpus, dataclasses.replace(cfg, method="act"),
                          device="cpu").config.block_n == 16
    with pytest.raises(ValueError, match="block_n=64.*no kernel"):
        EngineConfig(block_n=64)


def test_server_and_snapshot_carry_the_resolved_config(tmp_path):
    """``EmdServer`` keeps the resolved config, and a snapshot restores it
    exactly, a tuned ``block_v=256`` included (the config codec writes the
    port's None as the JAX package's 256 and reads 256 back as None; the
    snapshot carries the tiles themselves beside it)."""
    from repro_torch.serving import EmdServer, lifecycle, restore_latest
    from repro_torch.serving import snapshot
    corpus = _corpus()
    cfg0 = EngineConfig(method="act", iters=2, block_n=4)
    cache = autotune.TuneCache()
    cache.put("dist_topk", autotune.index_plan(corpus, cfg0)[0][1],
              {"block_v": 256, "block_h": 32})
    path = tmp_path / "tune.json"
    cache.save(str(path))
    index = EmdIndex.build(corpus, dataclasses.replace(
        cfg0, autotune="cached", tune_cache=str(path)), device="cpu")
    assert (index.config.block_v, index.config.block_h,
            index.config.block_n) == (256, 32, 4)
    server = EmdServer(index)
    assert server.config == index.config
    snapshot(server, str(tmp_path / "snap"))
    assert restore_latest(str(tmp_path / "snap")).config == index.config
    d = lifecycle.config_to_dict(EngineConfig())
    assert d["block_v"] == d["block_h"] == d["block_n"] == 256
    assert lifecycle.config_from_dict(d) == EngineConfig()


def test_force_raises_on_an_index_built_on_the_cpu(tmp_path):
    with pytest.raises(ValueError, match="on the card"):
        EmdIndex.build(_corpus(), EngineConfig(
            autotune="force", tune_cache=str(tmp_path / "t.json")),
            device="cpu")


def test_index_plan_follows_the_port_launches():
    corpus = _corpus()
    fams = {m: [f for f, _ in autotune.index_plan(
        corpus, EngineConfig(method=m))] for m in
        ("act", "rwmd", "omr", "rwmd_rev", "ict", "bow", "wcd")}
    assert fams == {"act": ["dist_topk", "act_phase2"],
                    "rwmd": ["dist_topk", "cand_pour"],
                    "omr": ["dist_topk", "cand_pour"],
                    "rwmd_rev": ["cand_dist"], "ict": ["cand_dist"],
                    "bow": [], "wcd": []}
    assert autotune.index_plan(
        corpus, EngineConfig(backend="reference")) == []


# ---------------------------------------------- the knobs change no score

def _np_corpus():
    c, _ = make_text_like(n_docs=40, n_classes=4, vocab=128, m=8,
                          doc_len=10, hmax=16, seed=5)
    return c


@pytest.mark.parametrize("method", ["act", "rwmd", "omr", "rwmd_rev", "ict"])
@pytest.mark.parametrize("tiles", [
    dict(block_v=256, block_h=32, block_n=2),
    dict(block_v=64, block_h=128, block_n=1, rev_block=7),
    dict(rev_block=3),
], ids=["wide", "narrow", "rev_block"])
def test_tile_knobs_and_rev_block_leave_scores_unchanged(method, tiles):
    c = _np_corpus()
    corpus = corpus_from_numpy(c.ids, c.w, c.coords, "cpu")
    q_ids, q_w = corpus.ids[:6], corpus.w[:6]
    for backend in ("cuda", "reference"):
        base = dict(method=method, iters=2, backend=backend)
        want = EmdIndex.build(corpus, EngineConfig(**base),
                              device="cpu").scores(q_ids, q_w)
        got = EmdIndex.build(corpus, EngineConfig(**base, **tiles),
                             device="cpu").scores(q_ids, q_w)
        assert torch.equal(got, want), (backend, method, tiles)
        one = EmdIndex.build(corpus, EngineConfig(**base, **tiles),
                             device="cpu").scores(q_ids[0], q_w[0])
        assert torch.equal(one, EmdIndex.build(
            corpus, EngineConfig(**base), device="cpu").scores(
                q_ids[0], q_w[0]))


@pytest.mark.parametrize("cascade", ["chain", "tight"])
def test_tile_knobs_leave_cascade_search_unchanged(cascade):
    c = _np_corpus()
    corpus = corpus_from_numpy(c.ids, c.w, c.coords, "cpu")
    q_ids, q_w = corpus.ids[:5], corpus.w[:5]
    base = dict(top_l=4, cascade=cascade)
    s0, i0 = EmdIndex.build(corpus, EngineConfig(**base),
                            device="cpu").search(q_ids, q_w)
    s1, i1 = EmdIndex.build(corpus, EngineConfig(
        **base, block_v=64, block_h=32, block_n=8, rev_block=5),
        device="cpu").search(q_ids, q_w)
    assert torch.equal(s0, s1) and torch.equal(i0, i1)


# --------------------------------------------------- variants and builds

def test_variant_defines_and_library_keys():
    assert ops.variant("dist_topk") == ()
    assert ops.variant("dist_topk", block_v=128, block_h=64) == ()
    assert ops.variant("dist_topk", block_v=256) == (("DIST_TOPK_BV", 256),)
    assert ops.variant("cand_dist", block_n=16) == (
        ("CAND_DIST_VALID_WARPS", 16),)
    with pytest.raises(ValueError, match="not admitted"):
        ops.variant("cand_pour", block_n=16)
    with pytest.raises(ValueError, match="tile knobs"):
        ops.variant("cand_pour", block_v=64)
    # the default variant keeps the library name it always had
    assert _build.library_path("dist_topk") \
        == _build.library_path("dist_topk", {})
    assert _build.library_path("dist_topk", {"DIST_TOPK_BV": 256}) \
        != _build.library_path("dist_topk")
    assert _build.define_flags({"B": 2, "A": 1}) == ("-DA=1", "-DB=2")


def test_wrapper_rejects_a_tile_the_model_does_not_admit():
    ids = torch.zeros((3, 4), dtype=torch.int32)
    w = torch.ones((3, 4))
    Z = torch.ones((2, 5, 1))
    with pytest.raises(ValueError, match="not admitted"):
        ops.cand_pour_rows(ids, w, None, Z, None, 0, block_n=32)
    out = ops.cand_pour_rows(ids, w, None, Z, None, 0, block_n=8)
    assert torch.equal(out, ops.cand_pour_rows(ids, w, None, Z, None, 0))


# ------------------------------------------------------- on a CUDA card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_every_admissible_variant_is_bitwise_the_default(cuda):
    """Each family's admissible tiles (the first MAX_VARIANTS) on a small
    corpus, under float32 and bfloat16 ladders: the same bits as the
    default tile, and the compiler's shared memory the model's."""
    from repro_torch.core import lc
    from repro_torch.kernels import act_phase2, cand_pour, dist_topk
    rng = np.random.default_rng(0)
    c = _np_corpus()
    corpus = corpus_from_numpy(c.ids, c.w, c.coords, cuda)
    q_ids, q_w = corpus.ids[:5].contiguous(), corpus.w[:5].contiguous()
    cand = torch.tensor(rng.integers(0, corpus.n, (5, 17)), device=cuda)
    dims = {"dist_topk": dict(nq=5, v=corpus.v, h=corpus.hmax, m=corpus.m,
                              k=4),
            "act_phase2": dict(nq=5, n=corpus.n, h=corpus.hmax, iters=3),
            "cand_pour": dict(nq=5, b=17, h=corpus.hmax, iters=3,
                              mode="pour"),
            "cand_dist": dict(nq=5, b=17, h=corpus.hmax, mode="ict")}
    for precision in ("f32", "bf16"):
        Z, W = lc._phase1_batched_dispatch(corpus, q_ids, q_w, 4, True,
                                           precision)
        W0 = W[..., 0].contiguous()
        valid = lc.phase1_valid_dist(corpus.coords, q_ids, q_w, precision)
        ids, w = corpus.ids, corpus.w
        calls = {
            "dist_topk": lambda t: ops.dist_topk_batched(
                corpus.coords, corpus.coords[q_ids], q_w > 0, 4,
                out_dtype=Z.dtype, **t),
            "act_phase2": lambda t: ops.act_phase2_gather(w, ids, Z, W, **t),
            "cand_pour": lambda t: (
                ops.cand_pour_rows(ids, w, cand, Z, W, 3, **t),
                ops.cand_omr_rows(ids, w, None, Z, W0, **t)),
            "cand_dist": lambda t: (
                ops.cand_ict_valid(ids, w, cand, *valid, **t),
                ops.cand_rev_min_valid(ids, w, None, *valid, **t)),
        }
        for family, call in calls.items():
            def run(t, call=call):
                out = call(t)
                return out if isinstance(out, tuple) else (out,)
            want = run({})
            for cfg in autotune.admissible_configs(family, dims[family])[
                    :autotune.MAX_VARIANTS]:
                got = run(cfg)
                for g, x in zip(got, want, strict=True):
                    assert torch.equal(g, x), (precision, family, cfg)
                var = ops.variant(family, **cfg)
                attrs = {
                    "dist_topk": lambda: dist_topk.attrs(
                        4, torch.float32, Z.dtype, var),
                    "act_phase2": lambda: act_phase2.gather_attrs(
                        4, 4, Z.dtype, var),
                    "cand_pour": lambda: cand_pour.rows_attrs(
                        "pour", 3, False, Z.dtype, var),
                    "cand_dist": lambda: cand_pour.valid_attrs(
                        "ict", Z.dtype, var)}[family]()
                layout = ops.block_layout(family, **dims[family], **cfg)
                assert attrs["static_bytes"] + attrs["dynamic_bytes"] \
                    == layout.smem_bytes, (family, cfg, attrs)
                assert attrs["regs"] <= smem.reg_cap(layout)
