"""The port's LM serving path (``repro_torch.models``) against the JAX
package's ``repro.models`` on the CPU.

Every architecture at ``smoke_config``, float32: the JAX weights carried
across by ``convert.params_from_numpy``, the same numpy inputs from a seed,
``forward`` / ``prefill`` / ``init_decode_cache`` / 4 ``decode_step``s
within atol 1e-4 and rtol 1e-4, MoE routing equal. Then each module's
pieces (the chunked attention, the MoE dispatch and combine with capacity
drops, the SSD scan and decode step, M-RoPE at head_dim 80, the norms, the
tanh GELU, gemma3's window schedule), the parameter count on the meta
device, the weight carry-over and the token pipeline.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import smoke_config as jax_smoke_config
from repro.data import tokens as jax_tokens
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import ssm as JS
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.data import tokens
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import ssm as S

ATOL = RTOL = 1e-4
B, SEQ, DECODE_STEPS = 2, 16, 4


def close(got, want, atol=ATOL, rtol=RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


def close_trees(got, want, what):
    """Two cache trees (nested dicts / tuples) leaf for leaf, same shapes."""
    if want is None:
        assert got is None, what
        return
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            close_trees(got[k], want[k], f"{what}/{k}")
        return
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            close_trees(g, w, f"{what}[{i}]")
        return
    assert tuple(got.shape) == tuple(want.shape), (what, got.shape,
                                                   want.shape)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype), what
    close(got, want, what=what)


@functools.lru_cache(maxsize=None)
def jitted(fn, static):
    """The JAX reference ``fn`` under ``jax.jit`` (one compile, instead of
    one per primitive op by op), with the configs and sizes static."""
    return jax.jit(fn, static_argnums=static)


@functools.lru_cache(maxsize=None)
def pair(name):
    """(JAX cfg, port cfg, JAX params, port model) at smoke width, the
    port holding the JAX weights."""
    jcfg, cfg = jax_smoke_config(name), smoke_config(name)
    params = jitted(JM.init, (1,))(jax.random.PRNGKey(0), jcfg)
    model = convert.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                      "cpu")
    return jcfg, cfg, params, model


def inputs(cfg, seq, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.frontend != "none":
        return {"embeddings": rng.normal(size=(B, seq, cfg.d_model))
                .astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32)}


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# The ten architectures end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCH_IDS)
def test_forward_matches_jax(name):
    jcfg, cfg, params, model = pair(name)
    batch = inputs(cfg, SEQ)
    jl, jaux, _ = jitted(JM.forward, (2,))(params, as_jax(batch), jcfg)
    tl, taux, _ = M.forward(model, as_torch(batch))
    assert tl.shape == (B, SEQ, cfg.vocab) and tl.dtype == torch.float32
    close(tl, jl, what="logits")
    close(taux, jaux, what="aux")
    if cfg.is_moe:
        assert float(taux) > 0.0


@pytest.mark.parametrize("name", ARCH_IDS)
def test_prefill_matches_jax(name):
    jcfg, cfg, params, model = pair(name)
    batch = inputs(cfg, SEQ, seed=1)
    jl, jc = jitted(JM.prefill, (2,))(params, as_jax(batch), jcfg)
    tl, tc = M.prefill(model, as_torch(batch))
    assert tl.shape == (B, 1, cfg.vocab)
    close(tl, jl, what="logits")
    # the compact length-S caches, leaf for leaf
    close_trees(tc, jax.tree.map(np.asarray, jc,
                                 is_leaf=lambda x: x is None), "cache")


@pytest.mark.parametrize("name", ARCH_IDS)
def test_decode_cache_layout_matches_jax(name):
    jcfg, cfg = jax_smoke_config(name), smoke_config(name)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = JM.init_decode_cache(jcfg, B, SEQ, dtype=jdt)
        got = M.init_decode_cache(cfg, B, SEQ, dtype=tdt, device="cpu")
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = {tuple(k): v for k, v in _paths(got)}
        assert sorted(flat_g) == sorted(
            tuple(p.key for p in path) for path, _ in flat_w)
        for path, leaf in flat_w:
            g = flat_g[tuple(p.key for p in path)]
            assert tuple(g.shape) == leaf.shape, path
            assert str(g.dtype).removeprefix("torch.") == str(leaf.dtype)
            assert not g.any()


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("name", ARCH_IDS)
def test_decode_steps_match_jax(name):
    jcfg, cfg, params, model = pair(name)
    batch = inputs(cfg, DECODE_STEPS, seed=2)
    jcache = JM.init_decode_cache(jcfg, B, SEQ, dtype=jnp.float32)
    tcache = M.init_decode_cache(cfg, B, SEQ, dtype=torch.float32,
                                 device="cpu")
    for t in range(DECODE_STEPS):
        step = {k: v[:, t:t + 1] for k, v in batch.items()}
        jl, jcache = jitted(JM.decode_step, (3,))(params, {**as_jax(step),
                                             "cache_index": jnp.int32(t)},
                                    jcache, jcfg)
        tl, tcache = M.decode_step(model, {**as_torch(step),
                                           "cache_index": t}, tcache)
        assert tl.shape == (B, 1, cfg.vocab)
        close(tl, jl, what=f"step {t} logits")
        close_trees(tcache, jax.tree.map(np.asarray, jcache),
                    f"step {t} cache")


@pytest.mark.parametrize("name", ["olmo-1b", "mamba2-2.7b", "zamba2-2.7b",
                                  "gemma3-27b"])
def test_decode_matches_full_forward(name):
    """The port's own weights (a torch.Generator): decoding token by token
    gives the full forward's logits within JAX's own 2e-2."""
    cfg = smoke_config(name)
    model = M.init(cfg, seed=1, device="cpu")
    toks = torch.as_tensor(inputs(cfg, SEQ, seed=3)["tokens"])
    full, _, _ = M.forward(model, {"tokens": toks})
    cache = M.init_decode_cache(cfg, B, SEQ, dtype=torch.float32,
                                device="cpu")
    outs = []
    for t in range(SEQ):
        dl, cache = M.decode_step(model, {"tokens": toks[:, t:t + 1],
                                          "cache_index": t}, cache)
        outs.append(dl)
    err = float((torch.cat(outs, dim=1) - full).abs().max())
    assert err < 2e-2, (name, err)


def test_decode_writes_in_place_and_repeats_bitwise():
    """decode_step writes into the cache it is given; two runs from copies
    of one cache give the same bits (the MoE's fixed-order combine)."""
    _, cfg, _, model = pair("mixtral-8x22b")
    cache = M.init_decode_cache(cfg, B, SEQ, dtype=torch.float32,
                                device="cpu")
    toks = torch.as_tensor(inputs(cfg, 3, seed=4)["tokens"])
    for t in range(2):
        _, out = M.decode_step(model, {"tokens": toks[:, t:t + 1],
                                       "cache_index": t}, cache)
        assert out is cache
    assert cache["attn"]["k"][:, :, :2].abs().sum() > 0
    assert not cache["attn"]["k"][:, :, 2:].any()
    runs = []
    for _ in range(2):
        c = {"attn": {k: v.clone() for k, v in cache["attn"].items()}}
        logits, c = M.decode_step(model, {"tokens": toks[:, 2:3],
                                          "cache_index": 2}, c)
        runs.append((logits, c["attn"]["k"]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_decode_past_the_cache_raises():
    _, cfg, _, model = pair("olmo-1b")
    cache = M.init_decode_cache(cfg, B, 3, dtype=torch.float32, device="cpu")
    with pytest.raises(IndexError, match="cache_index 4"):
        M.decode_step(model, {"tokens": torch.zeros((B, 1), dtype=torch.long),
                              "cache_index": 4}, cache)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config("olmo-1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_decode_cache(cfg, 1, 4)
    tree = convert.params_to_numpy(pair("olmo-1b")[3])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_numpy(tree, cfg)


# ---------------------------------------------------------------------------
# The modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [1024, 0], ids=["gemma3-window",
                                                   "global"])
def test_flash_attention_matches_jax(window):
    """S = 1536: three 512-chunks, each query chunk over its causal prefix;
    gemma3's window (1024) and global."""
    rng = np.random.default_rng(5)
    Bq, S_, KV, G, hd = 1, 1536, 2, 2, 16
    q = rng.normal(size=(Bq, S_, KV, G, hd)).astype(np.float32)
    k = rng.normal(size=(Bq, S_, KV, hd)).astype(np.float32)
    v = rng.normal(size=(Bq, S_, KV, hd)).astype(np.float32)
    want = jitted(JL._flash_attention, (4,))(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.int32(window), hd ** -0.5)
    got = L._flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), window, hd ** -0.5)
    close(got, want)


def test_attention_takes_the_flash_path_above_the_threshold():
    """attention_apply at S = 1536 (the flash path) against JAX's, and
    against the port's own unchunked path on the same inputs."""
    jcfg, cfg, params, model = pair("gemma3-27b")
    rng = np.random.default_rng(6)
    x = rng.normal(size=(1, 1536, cfg.d_model)).astype(np.float32)
    pos = np.arange(1536, dtype=np.int32)[None]
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    want, _ = jitted(JL.attention_apply, (2,))(jp, jnp.asarray(x), jcfg,
                                 positions=jnp.asarray(pos), window=8)
    attn = model.blocks[0].attn
    got, _ = L.attention_apply(attn, torch.as_tensor(x), cfg,
                               positions=torch.as_tensor(pos), window=8)
    close(got, want)


@pytest.mark.parametrize("index", [3, 12])
def test_attention_decode_window_matches_jax(index):
    """The cached path masks the whole cache to kpos <= index and the
    window (8 here), before and after the window bites."""
    jcfg, cfg, params, model = pair("gemma3-27b")
    rng = np.random.default_rng(7)
    size = 17
    kc = rng.normal(size=(B, size, cfg.n_kv_heads, cfg.head_dim)).astype(
        np.float32)
    vc = rng.normal(size=kc.shape).astype(np.float32)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    pos = np.full((B, 1), index, np.int32)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    want, wc = jitted(JL.attention_apply, (2,))(
        jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos), window=8,
        cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        cache_index=jnp.int32(index))
    cache = {"k": torch.as_tensor(kc.copy()), "v": torch.as_tensor(vc.copy())}
    got, gc = L.attention_apply(model.blocks[0].attn, torch.as_tensor(x), cfg,
                                positions=torch.as_tensor(pos), window=8,
                                cache=cache, cache_index=index)
    close(got, want)
    close_trees(gc, jax.tree.map(np.asarray, wc), "cache")


@pytest.mark.parametrize("cf,shards", [(0.25, 1), (0.25, 2), (1.25, 2)],
                         ids=["drops", "drops-ff-shards-2", "ff-shards-2"])
def test_moe_dispatch_and_combine_match_jax(cf, shards):
    """Capacity drops (cf 0.25: C = int(S*k/E*cf) + 1 = 3 of 8 entries an
    expert on average) and moe_ff_shards = 2: routing equal, expert inputs,
    the combine and moe_apply within tolerance."""
    name = "mixtral-8x22b"
    jcfg = dataclasses.replace(jax_smoke_config(name),
                               moe_capacity_factor=cf, moe_ff_shards=shards)
    cfg = dataclasses.replace(smoke_config(name), moe_capacity_factor=cf,
                              moe_ff_shards=shards)
    jp = JL.moe_init(jax.random.PRNGKey(8), jcfg)
    moe = L.MoE(cfg, None, torch.device("meta"))
    moe.load_state_dict({k: torch.as_tensor(np.array(v))
                         for k, v in jp.items()}, assign=True)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(B, SEQ, cfg.d_model)).astype(np.float32)
    C = int(SEQ * cfg.experts_per_token / cfg.n_experts * cf) + 1
    dropped = 0
    for b in range(B):
        jxe, jroute, jaux = jitted(JL._moe_dispatch, (2, 3))(
            jp, jnp.asarray(x[b]), jcfg, C)
        xe, route, aux = L._moe_dispatch(moe, torch.as_tensor(x[b]), cfg, C)
        for g, w in zip(route, jroute):             # slot, stok, sgate, keep
            if g.dtype == torch.float32:
                close(g, w)
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        close(xe, jxe)
        close(aux, jaux)
        dropped += int((~route[3]).sum())
        ye = rng.normal(size=xe.shape).astype(np.float32)
        close(L._moe_combine(torch.as_tensor(ye), route, SEQ, torch.float32),
              jitted(JL._moe_combine, (2, 3))(jnp.asarray(ye), jroute,
                                                SEQ, jnp.float32))
    if cf < 1:
        assert dropped > 0
    jy, jaux = jitted(JL.moe_apply, (2,))(jp, jnp.asarray(x), jcfg)
    y, aux = L.moe_apply(moe, torch.as_tensor(x), cfg)
    close(y, jy)
    close(aux, jaux)


def test_top_k_takes_the_lowest_index_on_ties():
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
    tv, ti = L.top_k(torch.as_tensor(x), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _ssm_pair(name="mamba2-2.7b"):
    jcfg, cfg, params, model = pair(name)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["ssm"])
    blk = model.blocks[0][0] if cfg.family == "hybrid" else model.blocks[0]
    return jcfg, cfg, jp, blk.ssm


def test_ssd_chunked_matches_jax():
    rng = np.random.default_rng(11)
    b, s, h, p, n, chunk = 2, 32, 4, 8, 16, 8
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 1.0, size=(b, s, h)).astype(np.float32)
    a = -np.linspace(1.0, 16.0, h).astype(np.float32)
    Bm = rng.normal(size=(b, s, n)).astype(np.float32)
    Cm = rng.normal(size=(b, s, n)).astype(np.float32)
    jy, jf = jitted(JS._ssd_chunked, (5,))(
        *map(jnp.asarray, (x, dt, a, Bm, Cm)), chunk)
    ty, tf = S._ssd_chunked(*map(torch.as_tensor, (x, dt, a, Bm, Cm)), chunk)
    close(ty, jy)
    close(tf, jf)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        S._ssd_chunked(*map(torch.as_tensor, (x, dt, a, Bm, Cm)), 12)


@pytest.mark.parametrize("name", ["mamba2-2.7b", "zamba2-2.7b"])
def test_ssm_apply_and_decode_step_match_jax(name):
    jcfg, cfg, jp, ssm = _ssm_pair(name)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(B, SEQ, cfg.d_model)).astype(np.float32)
    jy, jc = jitted(JS.ssm_apply, (2,))(jp, jnp.asarray(x), jcfg)
    ty, tc = S.ssm_apply(ssm, torch.as_tensor(x), cfg)
    close(ty, jy)
    close_trees(tc, jax.tree.map(np.asarray, jc), "cache")
    # the decode step from the prefill's cache
    x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    jo, jc2 = jitted(JS.ssm_decode_step, (3,))(jp, jnp.asarray(x1), jc,
                                                jcfg)
    to, tc2 = S.ssm_decode_step(ssm, torch.as_tensor(x1),
                                {k: v.clone() for k, v in tc.items()}, cfg)
    close(to, jo)
    close_trees(tc2, jax.tree.map(np.asarray, jc2), "decode cache")


@pytest.mark.parametrize("mrope", [True, False], ids=["mrope", "rope"])
def test_apply_rope_at_head_dim_80_matches_jax(mrope):
    """head_dim 80 (zamba2): a half-dim of 40, which 3 does not divide.
    JAX's sectioned M-RoPE over its three identical position streams is
    its standard rotation bit for bit, so the port has only that one."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 6, 3, 80)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(2, 6)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0, mrope)
    np.testing.assert_array_equal(
        np.asarray(want),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)))
    got = L.rotate(torch.as_tensor(x),
                   *L.rope_cos_sin(torch.as_tensor(pos), 80, 10_000.0))
    close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kind", ["nonparametric", "rmsnorm"])
def test_norms_match_jax(kind):
    cfg = dataclasses.replace(smoke_config("olmo-1b"), norm=kind)
    jcfg = dataclasses.replace(jax_smoke_config("olmo-1b"), norm=kind)
    rng = np.random.default_rng(14)
    x = (rng.normal(size=(3, 5, cfg.d_model)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=cfg.d_model).astype(np.float32)
    jparams = {} if kind == "nonparametric" else {"scale": jnp.asarray(scale)}
    want = JL.norm_apply(jparams, jnp.asarray(x), jcfg)
    got = L.norm_apply(None if kind == "nonparametric"
                       else torch.as_tensor(scale), torch.as_tensor(x), kind)
    close(got, want, atol=1e-5, rtol=1e-5)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    got = L.activation("gelu", torch.as_tensor(x))
    close(got, jax.nn.gelu(jnp.asarray(x)), atol=1e-6, rtol=1e-6)
    exact = torch.nn.functional.gelu(torch.as_tensor(x))
    assert float((got - exact).abs().max()) > 1e-4   # not the erf form


def test_musicgen_mlp_matches_jax():
    """musicgen's MLP (gelu) through mlp_apply, weights carried across."""
    jcfg, cfg, params, model = pair("musicgen-large")
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["mlp"])
    x = np.random.default_rng(15).normal(size=(B, 4, cfg.d_model)).astype(
        np.float32)
    close(L.mlp_apply(model.blocks[0].mlp, torch.as_tensor(x), cfg),
          JL.mlp_apply(jp, jnp.asarray(x), jcfg))


def test_window_schedule_gemma():
    cfg = get_config("gemma3-27b")
    ws = M.window_schedule(cfg)
    assert ws.dtype == torch.int32 and ws.shape == (62,)
    np.testing.assert_array_equal(ws.numpy(),
                                  np.asarray(JM.window_schedule(cfg)))
    assert (ws[5::6] == 0).all()
    np.testing.assert_array_equal(
        M.window_schedule(smoke_config("olmo-1b")).numpy(),
        np.asarray(JM.window_schedule(jax_smoke_config("olmo-1b"))))


# ---------------------------------------------------------------------------
# Configs, parameter count, carry-over, tokens
# ---------------------------------------------------------------------------

def test_configs_are_the_jax_packages():
    from repro.configs import get_config as jax_get_config
    assert ARCH_IDS == JAX_ARCH_IDS
    for name in ARCH_IDS:
        for ours, theirs in ((get_config(name), jax_get_config(name)),
                             (smoke_config(name), jax_smoke_config(name))):
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
            assert ours.param_count() == theirs.param_count()


@pytest.mark.parametrize("name", ARCH_IDS)
def test_param_count_on_meta(name):
    """The full published config, built on the meta device (no memory):
    its parameters number ``cfg.param_count()``."""
    cfg = get_config(name)
    model = M.init(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_count(), (name, n, cfg.param_count())
    assert {p.dtype for p in model.parameters()} <= {
        getattr(torch, cfg.param_dtype), torch.float32}


@pytest.mark.parametrize("name", ARCH_IDS)
def test_convert_round_trip_is_bitwise(name):
    _, _, params, model = pair(name)
    tree = jax.tree.map(np.asarray, params)
    back = convert.params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_convert_round_trip_bfloat16():
    """bfloat16 leaves (the published configs' dtype) cross bitwise."""
    jcfg = dataclasses.replace(jax_smoke_config("zamba2-2.7b"),
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(smoke_config("zamba2-2.7b"),
                              param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jitted(JM.init, (1,))(
        jax.random.PRNGKey(3), jcfg))
    model = convert.params_from_numpy(tree, cfg, "cpu")
    assert model.blocks[1][0].ssm.in_proj.dtype == torch.bfloat16
    assert model.blocks[1][0].ssm.a_log.dtype == torch.float32
    back = convert.params_to_numpy(model)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_convert_names_a_missing_extra_or_misshapen_leaf():
    _, cfg, params, _ = pair("olmo-1b")
    tree = jax.tree.map(np.asarray, params)
    missing = jax.tree.map(lambda a: a, tree)
    del missing["blocks"]["attn"]["wq"]
    with pytest.raises(ValueError, match="missing leaves.*blocks/attn/wq"):
        convert.params_from_numpy(missing, cfg, "cpu")
    extra = jax.tree.map(lambda a: a, tree)
    extra["blocks"]["attn"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="extra leaves.*blocks/attn/bias"):
        convert.params_from_numpy(extra, cfg, "cpu")
    shaped = jax.tree.map(lambda a: a, tree)
    shaped["embed"] = shaped["embed"][:-1]
    with pytest.raises(ValueError, match="leaf embed: shape"):
        convert.params_from_numpy(shaped, cfg, "cpu")
    typed = jax.tree.map(lambda a: a, tree)
    typed["blocks"]["mlp"]["w_up"] = typed["blocks"]["mlp"]["w_up"].astype(
        np.float16)
    with pytest.raises(ValueError, match="leaf blocks/mlp/w_up: dtype"):
        convert.params_from_numpy(typed, cfg, "cpu")


@pytest.mark.parametrize("vocab,seq_len,batch,shards,seed", [
    (256, 16, 2, 1, 7), (50_304, 64, 4, 2, 7), (1000, 9, 6, 3, 0)])
def test_tokens_match_jax(vocab, seq_len, batch, shards, seed):
    cfg = tokens.DataConfig(vocab=vocab, seq_len=seq_len, global_batch=batch,
                            seed=seed, n_shards=shards)
    jcfg = jax_tokens.DataConfig(vocab=vocab, seq_len=seq_len,
                                 global_batch=batch, seed=seed,
                                 n_shards=shards)
    for step in (0, 3):
        got, want = tokens.global_batch(cfg, step), \
            jax_tokens.global_batch(jcfg, step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(
            tokens.shard_batch(cfg, step, shards - 1)["tokens"],
            jax_tokens.shard_batch(jcfg, step, shards - 1)["tokens"])
