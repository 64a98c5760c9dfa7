"""The port's optimizer (``optim/adamw.py``) and gradient utilities
(``optim/grad_utils.py``) against the JAX package's on the CPU.

``schedule``, ``clip_by_global_norm`` and ``update`` on shared numpy
inputs within ULPS float32 ulps of JAX's (a bfloat16 leaf within one
bfloat16 ulp: the float32 results round to it); ``accumulate_grads`` at
n_micro 2 and 4 against one pass and against JAX's; the int8 round trip
unbiased and tight (JAX's ``test_int8_compression_unbiased_and_tight``),
and bitwise JAX's on the int8 grid; ``compressed_psum_tree`` on a 2-rank
gloo world against the plain sum.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.configs import smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.optim import grad_utils as JG
from repro_torch.configs import smoke_config
from repro_torch.launch.local import run_local
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models import parity
from repro_torch.optim import adamw
from repro_torch.optim import grad_utils as G

ULPS = 4
CFG = dict(peak_lr=1e-2, min_lr=1e-3, warmup_steps=5, total_steps=40)


def within_ulps(got, want, ulps=ULPS, what=""):
    """float32 arrays within ``ulps`` units in the last place of JAX's."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = ulps * np.spacing(np.abs(want))
    bad = np.abs(got - want) > tol
    assert not bad.any(), (what, got[bad][:4], want[bad][:4])


def tree(rng, bf16=True, grid=False):
    """A small nested gradient or parameter tree of numpy arrays. ``grid``:
    integers in [-3, 3] times 2^-4, whose squares and their sums are exact
    in float32 in any order, so the global norm is one correctly rounded
    square root in both packages."""
    def draw(*shape):
        if grid:
            return (rng.integers(-3, 4, size=shape) / 16).astype(np.float32)
        return rng.normal(size=shape).astype(np.float32)
    out = {"a": draw(7, 5),
           "blk": {"w": draw(3, 4, 6), "b": draw(6) * np.float32(1e-3)}}
    if bf16:
        out["h"] = draw(9).astype(jnp.bfloat16)
    return out


def to_torch(t):
    return {k: to_torch(v) if isinstance(v, dict)
            else convert._to_tensor(np.asarray(v)) for k, v in t.items()}


def to_jax(t):
    return jax.tree.map(jnp.asarray, t)


def leaves(t, prefix=""):
    for k, v in sorted(t.items()):
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def same_tree(got, want, what):
    for (name, g), (_, w) in zip(leaves(got), leaves(want), strict=True):
        if g.dtype == torch.bfloat16:
            within_bf16(g, w, f"{what}/{name}")
        else:
            within_ulps(as_f32(g), as_f32(w), what=f"{what}/{name}")


def within_bf16(got, want, what):
    """Within one bfloat16 ulp (float32 values ULPS ulps apart round to
    neighbouring bfloat16 values at most)."""
    w = as_f32(want)
    np.testing.assert_array_less(np.abs(as_f32(got) - w),
                                 2.0 ** -7 * np.abs(w) + 1e-30,
                                 err_msg=what)


def test_schedule_matches_jax():
    for cfg in (CFG, dict(CFG, warmup_steps=0), dict(CFG, total_steps=5)):
        jc, tc = JA.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
        for step in range(0, 45):
            got = adamw.schedule(torch.tensor(step, dtype=torch.int32), tc)
            want = JA.schedule(jnp.int32(step), jc)
            assert got.dtype == torch.float32
            within_ulps(got.numpy(), np.asarray(want), what=(cfg, step))


def test_schedule_shape():
    cfg = adamw.AdamWConfig(peak_lr=1.0, min_lr=0.1, warmup_steps=10,
                            total_steps=100)
    lrs = [float(adamw.schedule(s, cfg)) for s in range(101)]
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1.0) < 1e-6
    assert lrs[100] <= 0.1 + 1e-6
    assert all(a >= b - 1e-9 for a, b in zip(lrs[10:], lrs[11:]))


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax(rng, max_norm):
    g = tree(rng)
    got, norm = adamw.clip_by_global_norm(to_torch(g), max_norm)
    want, jnorm = JA.clip_by_global_norm(to_jax(g), max_norm)
    within_ulps(norm.numpy(), np.asarray(jnorm), what="norm")
    same_tree(got, want, "clipped")
    for (_, a), (_, b) in zip(leaves(got), leaves(g)):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
    f32, _ = adamw.clip_by_global_norm(to_torch(tree(rng, bf16=False)),
                                       max_norm)
    if max_norm == 1.0:
        assert abs(float(adamw.global_norm(f32)) - 1.0) < 1e-6


@pytest.mark.parametrize("clipped", [False, True],
                         ids=["unclipped", "clipped"])
def test_update_matches_jax(rng, clipped):
    """Four AdamW steps on shared gradients: parameters (float32 and
    bfloat16 leaves), both moments, the step counter and the metrics.

    The global norm's float32 sums run in each library's own order and may
    land one ulp apart (clip_by_global_norm's test allows 4). Under an
    active clip that ulp scales every gradient, and a moment near 0 (m
    is 0.9 m + 0.1 g, which cancels) can end many of its own ulps apart.
    So the clipped case draws gradients on a grid whose norm both compute
    exactly; the unclipped case (``clip_norm`` 1e3) draws them normal."""
    params = tree(rng)
    jp, tp = to_jax(params), to_torch(params)
    js, ts = JA.init(jp), adamw.init(tp)
    assert ts["step"].dtype == torch.int32
    kw = dict(CFG, clip_norm=1.0 if clipped else 1e3)
    jc, tc = JA.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    for i in range(4):
        g = tree(rng, grid=clipped)
        jp, js, jm = JA.update(to_jax(g), js, jp, jc)
        tp, ts, tm = adamw.update(to_torch(g), ts, tp, tc)
        same_tree(tp, jp, f"step {i} params")
        same_tree(ts["m"], js["m"], f"step {i} m")
        same_tree(ts["v"], js["v"], f"step {i} v")
        assert int(ts["step"]) == int(js["step"]) == i + 1
        within_ulps(tm["lr"].numpy(), np.asarray(jm["lr"]))
        within_ulps(tm["grad_norm"].numpy(), np.asarray(jm["grad_norm"]))
        assert (float(tm["grad_norm"]) > tc.clip_norm) == clipped


def test_adamw_converges_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = adamw.init(params)
    cfg = adamw.AdamWConfig(peak_lr=0.1, min_lr=0.01, warmup_steps=5,
                            total_steps=300, weight_decay=0.0)
    for _ in range(300):
        w = params["w"].requires_grad_()
        (g,) = torch.autograd.grad(torch.sum((w - target) ** 2), [w])
        params, state, _ = adamw.update({"w": g}, state,
                                        {"w": w.detach()}, cfg)
    assert float(torch.sum((params["w"] - target) ** 2)) < 1e-3


def test_accumulate_grads_matches_monolithic_linear():
    """JAX's ``test_accumulate_grads_matches_monolithic`` on the port."""
    w = torch.tensor([[1.0, 2.0], [3.0, 4.0]], requires_grad=True)
    batch = {"x": torch.arange(8.0).reshape(8, 1), "y": torch.ones((8, 2))}

    def loss_fn(b):
        pred = b["x"] @ torch.ones((1, 2)) @ w
        return torch.mean((pred - b["y"]) ** 2)

    l1, g1 = G.accumulate_grads(loss_fn, {"w": w}, batch, 1)
    l4, g4 = G.accumulate_grads(loss_fn, {"w": w}, batch, 4)
    assert abs(float(l1) - float(l4)) < 1e-5
    np.testing.assert_allclose(g1["w"].numpy(), g4["w"].numpy(), rtol=1e-5)
    with pytest.raises(ValueError, match="not a multiple"):
        G.accumulate_grads(loss_fn, {"w": w}, batch, 3)


@pytest.mark.parametrize("n_micro", [2, 4])
def test_accumulate_grads_matches_monolithic_and_jax(n_micro):
    """train_loss over 4 rows of smoke olmo: n_micro slices against one
    pass (rtol 1e-5) and against JAX's ``accumulate_grads`` at the same
    n_micro (atol = rtol = 1e-4); the sums are float32 under bfloat16
    parameters, and one pass keeps the parameters' dtype."""
    cfg = smoke_config("olmo-1b")
    model = M.init(cfg, seed=0, device="cpu")
    params = dict(model.named_parameters())
    batch = {k: torch.as_tensor(v) for k, v in
             parity.train_batch(cfg, batch=4).items()}
    fn = lambda b: M.train_loss(model, b)                      # noqa: E731
    l1, g1 = G.accumulate_grads(fn, params, batch, 1)
    ln, gn = G.accumulate_grads(fn, params, batch, n_micro)
    assert abs(float(l1) - float(ln)) < 1e-5
    for k in g1:
        np.testing.assert_allclose(gn[k].numpy(), g1[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    jcfg = jax_smoke_config("olmo-1b")
    jparams = jax.tree.map(jnp.asarray, convert.params_to_numpy(model))
    jl, jg = jax.jit(lambda p, b: JG.accumulate_grads(
        lambda pp, bb: JM.train_loss(pp, bb, jcfg), p, b, n_micro))(
        jparams, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    np.testing.assert_allclose(float(ln), float(jl), atol=1e-4, rtol=1e-4)
    got = dict(leaves(convert.grads_to_numpy(model, gn)))
    for k, want in leaves(jax.tree.map(np.asarray, jg)):
        np.testing.assert_allclose(got[k], want, atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    bf = M.init(cfg.__class__(**{**cfg.__dict__,
                                 "param_dtype": "bfloat16"}), device="cpu")
    bparams = dict(bf.named_parameters())
    fn = lambda b: M.train_loss(bf, b)                         # noqa: E731
    assert {g.dtype for g in G.accumulate_grads(
        fn, bparams, batch, 1)[1].values()} == {torch.bfloat16}
    assert {g.dtype for g in G.accumulate_grads(
        fn, bparams, batch, n_micro)[1].values()} == {torch.float32}


def test_int8_compression_unbiased_and_tight(rng):
    x = torch.as_tensor(rng.normal(size=(64, 64)), dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    acc = torch.zeros_like(x)
    n = 64
    for _ in range(n):
        q, s = G.compress_int8(x, gen)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        acc = acc + G.decompress_int8(q, s)
    err = float((acc / n - x).abs().max())
    scale = float(x.abs().max()) / 127
    assert err < 3 * scale / np.sqrt(n) + 1e-6
    q, s = G.compress_int8(x, gen)
    assert float((G.decompress_int8(q, s) - x).abs().max()) <= float(s) \
        + 1e-6


def test_int8_bitwise_jax_on_the_grid(rng):
    """Values on the int8 grid (integers times a power of two, max |x| at
    127 steps) need no rounding: payload, scale and round trip equal
    JAX's bit for bit, whatever the random bits."""
    for step in (1.0, 2.0 ** -3, 2.0 ** 5):
        k = rng.integers(-127, 128, size=(33, 17)).astype(np.float32)
        k[0, 0] = 127.0
        x = k * np.float32(step)
        q, s = G.compress_int8(torch.as_tensor(x),
                               torch.Generator().manual_seed(1))
        jq, js = JG.compress_int8(jnp.asarray(x), jax.random.PRNGKey(1))
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
        back = G.decompress_int8(q, s, torch.bfloat16)
        jback = JG.decompress_int8(jq, js, jnp.bfloat16)
        assert np.array_equal(back.float().numpy(),
                              np.asarray(jback, np.float32))


def test_compressed_psum_tree_two_ranks(rng):
    """Two gloo ranks, each with its own gradients: every rank gets the
    same tree, each leaf within two quantization steps a rank of the
    plain sum, in its dtype; the bytes under the label are the shared
    scales (4 B a leaf) and the int32 payloads."""
    trees = [{"w": rng.normal(size=(32, 8)).astype(np.float32),
              "b": (1e-3 * rng.normal(size=(8,))).astype(np.float32)}
             for _ in range(2)]
    out = run_local(ranks.compressed_psum, 1, 2, args=("model", trees, 7),
                    timeout=180)
    (r0, t0), (r1, t1) = out
    for k in trees[0]:
        assert np.array_equal(r0[k], r1[k])
        plain = trees[0][k] + trees[1][k]
        step = max(np.abs(t[k]).max() for t in trees) / 127
        assert np.abs(r0[k] - plain).max() <= 2 * step * (1 + 1e-6)
    payload = sum(4 * a.size for a in trees[0].values())
    assert t0 == t1 == {G.LABEL: payload + 4 * len(trees[0])}
