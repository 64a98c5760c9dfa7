"""The port's LM serving path under bfloat16 weights (the published configs'
dtype) against the JAX package's on the CPU.

Every architecture at ``smoke_config`` with ``param_dtype="bfloat16"``: the
JAX weights carried across by ``convert.params_from_numpy``, the same numpy
inputs from a seed. ``forward``, ``prefill`` and ``decode_step`` (the whole
prompt token by token into a bfloat16 cache, then 4 more steps) must give
every output and cache leaf JAX's shape and dtype, with values within
BF16_ATOL + BF16_RTOL * |JAX|. Two libraries round bfloat16 matmuls and
their float32 islands differently: the readings were up to 3 bfloat16 ulps
of logits of magnitude ~4 (max |d| 0 for mamba2, 0.039 to 0.097 for the
rest, zamba2 the widest), so the bar is 4 ulps there. Decoding against the full forward, the port's
gap stays within that bar of JAX's own bfloat16 gap (0.10 to 0.12 for the
SSM families, 2.1 to 2.8 for the MoE, whose capacity is 1 at decode, 0 for
the rest).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import model as JM
from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.models import convert
from repro_torch.models import model as M

BF16_ATOL, BF16_RTOL = 0.125, 2.0 ** -6
B, SEQ, STEPS = 2, 16, 4


def as_f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def close_trees(got, want, what):
    """Leaf for leaf: the same layout, shapes and dtypes, values within the
    bfloat16 bar."""
    if want is None:
        assert got is None, what
    elif isinstance(want, (dict, tuple)):
        assert type(got) is type(want) and len(got) == len(want), what
        keys = sorted(want) if isinstance(want, dict) else range(len(want))
        for k in keys:
            close_trees(got[k], want[k], f"{what}/{k}")
    else:
        assert tuple(got.shape) == tuple(want.shape), (what, got.shape,
                                                       want.shape)
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), (
            what, got.dtype, want.dtype)
        np.testing.assert_allclose(as_f32(got), as_f32(want),
                                   atol=BF16_ATOL, rtol=BF16_RTOL,
                                   err_msg=what)


@functools.lru_cache(maxsize=None)
def jitted(fn, static):
    return jax.jit(fn, static_argnums=static)


@functools.lru_cache(maxsize=None)
def pair(name):
    """(JAX cfg, JAX params, port model) at smoke width in bfloat16, the
    port holding the JAX weights."""
    jcfg = dataclasses.replace(jax_smoke_config(name), param_dtype="bfloat16")
    cfg = dataclasses.replace(smoke_config(name), param_dtype="bfloat16")
    params = jitted(JM.init, (1,))(jax.random.PRNGKey(0), jcfg)
    model = convert.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                      "cpu")
    return jcfg, params, model


def inputs(name):
    """The prompt and the STEPS tokens (or embeddings) after it."""
    cfg = smoke_config(name)
    seq = SEQ + STEPS
    rng = np.random.default_rng(0)
    if cfg.frontend != "none":
        return "embeddings", rng.normal(size=(B, seq, cfg.d_model)).astype(
            np.float32)
    return "tokens", rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def forwards(name):
    """JAX's and the port's bfloat16 forward over the SEQ-token prompt."""
    jcfg, params, model = pair(name)
    key, x = inputs(name)
    x = x[:, :SEQ]
    want = jitted(JM.forward, (2,))(params, {key: jnp.asarray(x)}, jcfg)
    got = M.forward(model, {key: torch.as_tensor(x)})
    return got, want


@pytest.mark.parametrize("name", ARCH_IDS)
def test_bf16_forward_matches_jax(name):
    (tl, taux, _), (jl, jaux, _) = forwards(name)
    assert tl.dtype == torch.bfloat16
    close_trees(tl, jl, "logits")
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-2,
                               rtol=1e-2)


@pytest.mark.parametrize("name", ARCH_IDS)
def test_bf16_prefill_matches_jax(name):
    jcfg, params, model = pair(name)
    key, x = inputs(name)
    x = x[:, :SEQ]
    jl, jc = jitted(JM.prefill, (2,))(params, {key: jnp.asarray(x)}, jcfg)
    tl, tc = M.prefill(model, {key: torch.as_tensor(x)})
    close_trees(tl, jl, "logits")
    close_trees(tc, jax.tree.map(np.asarray, jc,
                                 is_leaf=lambda a: a is None), "cache")


@pytest.mark.parametrize("name", ARCH_IDS)
def test_bf16_decode_matches_jax(name):
    """The prompt token by token into a bfloat16 cache, then STEPS more:
    each step's logits and whole cache against JAX's; over the prompt,
    the decode-vs-forward gap against JAX's own."""
    jcfg, params, model = pair(name)
    key, x = inputs(name)
    (tfull, _, _), (jfull, _, _) = forwards(name)
    jcache = JM.init_decode_cache(jcfg, B, SEQ + STEPS, dtype=jnp.bfloat16)
    tcache = M.init_decode_cache(model.cfg, B, SEQ + STEPS,
                                 dtype=torch.bfloat16, device="cpu")
    jgap = tgap = 0.0
    for t in range(SEQ + STEPS):
        step = x[:, t:t + 1]
        jl, jcache = jitted(JM.decode_step, (3,))(
            params, {key: jnp.asarray(step), "cache_index": jnp.int32(t)},
            jcache, jcfg)
        tl, tcache = M.decode_step(model, {key: torch.as_tensor(step),
                                           "cache_index": t}, tcache)
        close_trees(tl, jl, f"step {t} logits")
        close_trees(tcache, jax.tree.map(np.asarray, jcache),
                    f"step {t} cache")
        if t < SEQ:
            jgap = max(jgap, float(np.abs(as_f32(jl[:, 0])
                                          - as_f32(jfull[:, t])).max()))
            tgap = max(tgap, float(np.abs(as_f32(tl[:, 0])
                                          - as_f32(tfull[:, t])).max()))
    assert abs(tgap - jgap) <= BF16_ATOL, (name, tgap, jgap)
