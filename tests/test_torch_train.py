"""The port's LM training path (``models.model.train_loss`` with remat,
``launch.steps.make_train_step``) against the JAX package's on the CPU.

Every architecture at ``smoke_config``, float32, the JAX weights carried
across by ``convert.params_from_numpy`` and the same numpy batch from a
seed: the loss and every gradient leaf (``convert.grads_to_numpy``, in
JAX's tree layout) against ``jax.value_and_grad(train_loss)`` within atol
= rtol = 1e-4, the forward's bar. The largest readings were 2.8e-2 of that
bar (zamba2), the losses equal within 1e-6 (``pytest -s`` prints them). Then: remat off, ``full`` and
``dots`` give the same loss and gradients (bitwise on the CPU); the
chunked attention's gradient at S = 1536 (> ``FLASH_THRESHOLD``); the
``loss_mask``; olmo under bfloat16 weights against JAX's (loss within
BF16_LOSS_ATOL, grad norm within BF16_NORM_RTOL; readings 2.9e-3 and
6.2e-4); three ``make_train_step`` steps against JAX's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.launch import steps as JSt
from repro.models import model as JM
from repro.models.config import InputShape as JInputShape
from repro.optim import adamw as JA
from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.launch import steps as St
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import parity
from repro_torch.models.config import InputShape
from repro_torch.optim import adamw

ATOL = RTOL = 1e-4
#: olmo under bfloat16 weights: two libraries round bfloat16 matmuls
#: differently (readings: loss 2.9e-3 apart on 6.02, grad norm 6.2e-4).
BF16_LOSS_ATOL, BF16_NORM_RTOL = 2e-2, 1e-2
#: After each of three train steps, every parameter within this fraction
#: of that step's learning rate of JAX's (readings up to 0.132, zamba2's
#: third step: AdamW's update is ~sign(g) x lr where |g| is near eps, so
#: such a gradient moves the parameter by a visible part of lr).
STEP_LR_FRACTION = 0.25


def jax_params(jcfg):
    return JM.init(jax.random.PRNGKey(0), jcfg)   # op by op: no compile


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def jax_value_and_grad(jcfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: JM.train_loss(p, b, jcfg)))


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, np.float32)
    return out


def close_trees(got, want, atol=ATOL, rtol=RTOL):
    """Two numpy trees of one layout, leaf for leaf; returns the largest
    |d| / (atol + rtol |want|)."""
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    worst = 0.0
    for path in w:
        assert g[path].shape == w[path].shape, path
        np.testing.assert_allclose(g[path], w[path], atol=atol, rtol=rtol,
                                   err_msg="/".join(path))
        worst = max(worst, float((np.abs(g[path] - w[path])
                                  / (atol + rtol * np.abs(w[path]))).max()))
    return worst


def port_pair(name, **over):
    """(JAX cfg, JAX params, port cfg, port model holding them)."""
    jcfg = dataclasses.replace(jax_smoke_config(name), **over)
    cfg = dataclasses.replace(smoke_config(name), **over)
    params = jax_params(jcfg)
    model = convert.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                      "cpu")
    return jcfg, params, cfg, model


@pytest.mark.parametrize("name", ARCH_IDS)
def test_train_loss_and_grads_match_jax(name):
    jcfg, params, cfg, model = port_pair(name)
    batch = parity.train_batch(cfg)
    jl, jg = jax_value_and_grad(jcfg)(params, as_jax(batch))
    loss, grads = parity.loss_and_grads(model, as_torch(batch))
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(jl), atol=ATOL, rtol=RTOL)
    worst = close_trees(convert.grads_to_numpy(model, grads),
                        jax.tree.map(np.asarray, jg))
    assert worst < 1.0
    print(f"{name}: loss |d| {abs(float(loss) - float(jl)):.3g}, the "
          f"worst gradient leaf at {worst:.3g} of the bar")


@pytest.mark.parametrize("name", ARCH_IDS)
def test_remat_policies_same_loss_and_grads(name):
    """JAX's ``test_remat_policy_dots_same_loss_and_grads`` on every
    architecture: recomputing in backward changes nothing (here bitwise)."""
    spread = parity.remat_spread(smoke_config(name), "cpu")
    assert spread["full_loss"] < 1e-6 and spread["dots_loss"] < 1e-6
    assert spread["full_grads"] < 1e-5 and spread["dots_grads"] < 1e-5


def test_remat_wraps_each_block_and_dots_saves_the_projections():
    """Under remat the blocks recompute in backward: ``full`` reruns every
    projection (``aten.mm``), ``dots`` none of them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.mm += func is torch.ops.aten.mm.default
            return func(*args, **(kwargs or {}))

    tree = convert.params_to_numpy(M.init(smoke_config("olmo-1b"), seed=0,
                                          device="cpu"))
    batch = as_torch(parity.train_batch(smoke_config("olmo-1b")))
    counts = {}
    for kw in (dict(remat=False), dict(remat=True, remat_policy="full"),
               dict(remat=True, remat_policy="dots")):
        cfg = dataclasses.replace(smoke_config("olmo-1b"), **kw)
        loss = M.train_loss(convert.params_from_numpy(tree, cfg, "cpu"),
                            batch)
        with Count() as c:
            loss.backward()
        counts[kw.get("remat_policy", "off")] = c.mm
    # olmo: q, k, v, o, up, gate, down are 7 projections; 6 of them are
    # recomputed under full (the output projection's is not needed).
    assert counts["dots"] == counts["off"]
    assert counts["full"] > counts["off"]
    with pytest.raises(ValueError, match="remat_policy"):
        cfg = dataclasses.replace(smoke_config("olmo-1b"), remat=True,
                                  remat_policy="names")
        M.train_loss(convert.params_from_numpy(tree, cfg, "cpu"), batch)


def test_full_configs_remat_and_smoke_does_not():
    from repro_torch.configs import get_config
    for name in ARCH_IDS:
        assert get_config(name).remat
        assert not smoke_config(name).remat


@pytest.mark.parametrize("window", [0, 1024], ids=["global", "window"])
def test_chunked_attention_grads_match_jax(window):
    """S = 1536 > FLASH_THRESHOLD: the chunked online softmax's gradients
    with respect to the input and the four projections of smoke olmo's
    first attention block (global, and gemma3's sliding window of 1024),
    under a random cotangent."""
    from repro.models import layers as JL
    seq = 1536
    assert seq > L.FLASH_THRESHOLD and seq % L.FLASH_CHUNK == 0
    jcfg, params, cfg, model = port_pair("olmo-1b")
    attn = model.blocks[0].attn
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    rng = np.random.default_rng(9)
    x = rng.normal(size=(1, seq, cfg.d_model)).astype(np.float32)
    r = rng.normal(size=(1, seq, cfg.d_model)).astype(np.float32)
    pos = np.arange(seq, dtype=np.int32)[None]

    def jloss(p, xx):
        out, _ = JL.attention_apply(p, xx, jcfg, positions=jnp.asarray(pos),
                                    window=window)
        return jnp.sum(out * jnp.asarray(r))
    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jp, jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    out, _ = L.attention_apply(attn, xt, cfg, positions=torch.as_tensor(pos),
                               window=window)
    loss = torch.sum(out * torch.as_tensor(r))
    names = ("wq", "wk", "wv", "wo")
    grads = torch.autograd.grad(loss, [xt] + [getattr(attn, n)
                                              for n in names])
    np.testing.assert_allclose(loss.item(), float(jl), rtol=RTOL)
    close_trees({"x": grads[0].numpy(),
                 **{n: g.numpy() for n, g in zip(names, grads[1:])}},
                {"x": np.asarray(jgx), **{n: np.asarray(jgp[n])
                                          for n in names}})


@pytest.mark.parametrize("window", list(parity.LONG_WINDOWS.values()),
                         ids=list(parity.LONG_WINDOWS))
def test_long_train_loss_and_grads_match_jax(window):
    """The whole loss at S = LONG_SEQ (1536) under full remat: every
    block's chunked attention, its backward and its recomputation, global
    and with a window of 1024 on every layer, leaf for leaf JAX's."""
    cfg = parity.long_config(window)
    jcfg, params, cfg, model = port_pair(
        "olmo-1b", remat=cfg.remat, remat_policy=cfg.remat_policy,
        sliding_window=cfg.sliding_window)
    assert parity.LONG_SEQ > L.FLASH_THRESHOLD
    batch = parity.train_batch(cfg, batch=parity.LONG_BATCH,
                               seq=parity.LONG_SEQ)
    jl, jg = jax_value_and_grad(jcfg)(params, as_jax(batch))
    loss, grads = parity.loss_and_grads(model, as_torch(batch))
    np.testing.assert_allclose(float(loss), float(jl), atol=ATOL, rtol=RTOL)
    worst = close_trees(convert.grads_to_numpy(model, grads),
                        jax.tree.map(np.asarray, jg))
    print(f"olmo S={parity.LONG_SEQ} window {window}: loss |d| "
          f"{abs(float(loss) - float(jl)):.3g}, the worst gradient leaf at "
          f"{worst:.3g} of the bar")


def test_loss_mask_matches_jax():
    jcfg, params, cfg, model = port_pair("mixtral-8x22b")
    batch = parity.train_batch(cfg)
    rng = np.random.default_rng(3)
    for mask in (rng.integers(0, 2, batch["labels"].shape),
                 np.zeros(batch["labels"].shape)):
        b = {**batch, "loss_mask": mask.astype(np.float32)}
        jl, jg = jax_value_and_grad(jcfg)(params, as_jax(b))
        loss, grads = parity.loss_and_grads(model, as_torch(b))
        np.testing.assert_allclose(float(loss), float(jl), atol=ATOL,
                                   rtol=RTOL)
        close_trees(convert.grads_to_numpy(model, grads),
                    jax.tree.map(np.asarray, jg))
    # an all-zero mask leaves only the router's aux term
    assert 0.0 < float(loss) < 0.1


def test_bf16_olmo_loss_and_grad_norm_match_jax():
    jcfg, params, cfg, model = port_pair("olmo-1b", param_dtype="bfloat16")
    batch = parity.train_batch(cfg)
    jl, jg = jax_value_and_grad(jcfg)(params, as_jax(batch))
    loss, grads = parity.loss_and_grads(model, as_torch(batch))
    assert all(g.dtype == torch.bfloat16 for g in grads.values())
    assert abs(float(loss) - float(jl)) < BF16_LOSS_ATOL
    jn, tn = float(JA.global_norm(jg)), float(adamw.global_norm(grads))
    assert abs(tn - jn) < BF16_NORM_RTOL * jn
    print(f"bf16 olmo: loss |d| {abs(float(loss) - float(jl)):.3g}, grad "
          f"norm relative |d| {abs(tn - jn) / jn:.3g}")


@pytest.mark.parametrize("name", ["olmo-1b", "zamba2-2.7b"])
def test_train_steps_match_jax(name):
    jcfg, params, cfg, model = port_pair(name)
    kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(JSt.make_train_step(jcfg, JInputShape("t", 16, 2,
                                                          "train"),
                                        JA.AdamWConfig(**kw), n_micro=1))
    step = St.make_train_step(InputShape("t", 16, 2, "train"),
                              adamw.AdamWConfig(**kw), n_micro=1)
    jopt = JA.init(params, jcfg.opt_state_dtype)
    opt = adamw.init(dict(model.named_parameters()), cfg.opt_state_dtype)
    for s in range(3):
        batch = parity.train_batch(cfg, s)
        params, jopt, jm = jstep(params, jopt, as_jax(batch))
        model, opt, m = step(model, opt, as_torch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert float(m["lr"]) == float(jm["lr"])
        assert int(opt["step"]) == int(jopt["step"]) == s + 1
        lr = float(jm["lr"])
        worst = close_trees(convert.params_to_numpy(model),
                            jax.tree.map(np.asarray, params),
                            atol=STEP_LR_FRACTION * lr, rtol=0.0)
        print(f"{name} step {s + 1}: parameters within "
              f"{worst * STEP_LR_FRACTION:.3g} x lr of JAX's")
    close_trees(convert.opt_state_to_numpy(model, opt)["m"],
                jax.tree.map(np.asarray, jopt["m"]))
    # The AdamW state round trip is bitwise; then the port restarted from
    # JAX's own parameters and state takes a fourth step as JAX does.
    back = convert.opt_state_from_numpy(
        convert.opt_state_to_numpy(model, opt), model, "cpu")
    assert all(torch.equal(back[k][n], opt[k][n])
               for k in ("m", "v") for n in opt[k])
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 3
    model = convert.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                      "cpu")
    opt = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jopt),
                                       model, "cpu")
    batch = parity.train_batch(cfg, 3)
    params, jopt, jm = jstep(params, jopt, as_jax(batch))
    model, opt, m = step(model, opt, as_torch(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    close_trees(convert.params_to_numpy(model),
                jax.tree.map(np.asarray, params),
                atol=STEP_LR_FRACTION * float(jm["lr"]), rtol=0.0)
    close_trees(convert.opt_state_to_numpy(model, opt)["v"],
                jax.tree.map(np.asarray, jopt["v"]))


def test_train_step_reads_the_models_config():
    """The step takes its config from the model: one step serves remat
    off and ``dots`` (the same loss and parameters after it), and its
    microbatch count defaults to ``microbatches_for`` of the model's."""
    cfg = smoke_config("olmo-1b")
    shape = InputShape("t", 16, 2, "train")
    assert St.microbatches_for(cfg, shape) == 1
    step = St.make_train_step(shape)
    tree = convert.params_to_numpy(M.init(cfg, seed=0, device="cpu"))
    batch = as_torch(parity.train_batch(cfg))
    runs = []
    for c in (cfg, dataclasses.replace(cfg, remat=True,
                                       remat_policy="dots")):
        model = convert.params_from_numpy(tree, c, "cpu")
        opt = adamw.init(dict(model.named_parameters()))
        model, opt, m = step(model, opt, batch)
        runs.append((float(m["loss"]), convert.params_to_numpy(model)))
    assert runs[0][0] == runs[1][0]
    got, want = flat(runs[1][1]), flat(runs[0][1])
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# launch/steps.py's other surfaces
# ---------------------------------------------------------------------------

def shapes(tree, prefix=()):
    """{path: (shape, dtype name)} of a tree of JAX ShapeDtypeStructs or
    torch (meta) tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(shapes(v, prefix + (k,)))
        return out
    return {prefix: (tuple(tree.shape),
                     str(tree.dtype).removeprefix("torch."))}


@pytest.mark.parametrize("name", ["olmo-1b", "mixtral-8x22b",
                                  "zamba2-2.7b", "musicgen-large"])
def test_abstract_inputs_match_jax(name):
    """The meta-device stand-ins of the full configs (no memory): the
    parameters and AdamW state in JAX's tree layout, the decode cache and
    every cell's inputs, leaf for leaf JAX's shapes and dtypes; the
    microbatch factors JAX's."""
    from repro.configs import get_config as jax_get_config
    from repro.models.config import SHAPES as JSHAPES
    from repro_torch.configs import get_config
    from repro_torch.models.config import SHAPES
    jcfg, cfg = jax_get_config(name), get_config(name)
    model = St.abstract_params(cfg)
    assert model.embed.device.type == "meta"
    assert shapes(convert.to_tree(model, dict(model.named_parameters()))) \
        == shapes(JSt.abstract_params(jcfg))
    opt, jopt = St.abstract_opt_state(cfg), JSt.abstract_opt_state(jcfg)
    assert shapes({"m": convert.to_tree(model, opt["m"]),
                   "v": convert.to_tree(model, opt["v"]),
                   "step": opt["step"]}) == shapes(jopt)
    for cell, shape in SHAPES.items():
        jshape = JSHAPES[cell]
        assert shapes(St.input_specs(cfg, shape)) \
            == shapes(JSt.input_specs(jcfg, jshape))
        assert St.microbatches_for(cfg, shape) \
            == JSt.microbatches_for(jcfg, jshape)
        if shape.kind == "decode":
            assert shapes(St.abstract_cache(cfg, shape)) \
                == shapes(JSt.abstract_cache(jcfg, jshape))


def test_serving_and_emd_steps_delegate():
    """make_prefill_step / make_decode_step are the model's entry points;
    the EMD steps and input specs are launch/search.py's at the workload's
    method, iters and sizes (JAX's specs)."""
    from repro.configs.emd_20news import CONFIG as JNEWS
    from repro_torch.cascade import cascade_search
    from repro_torch.configs.emd_20news import CONFIG as NEWS
    from repro_torch.core import retrieval
    from repro_torch.data.synth import make_text_like
    cfg = smoke_config("olmo-1b")
    model = M.init(cfg, seed=0, device="cpu")
    toks = as_torch(parity.train_batch(cfg))["tokens"]
    got, _ = St.make_prefill_step(cfg)(model, {"tokens": toks})
    want, _ = M.prefill(model, {"tokens": toks})
    assert torch.equal(got, want)
    caches = [M.init_decode_cache(cfg, 2, 4, torch.float32, device="cpu")
              for _ in range(2)]
    got, _ = St.make_decode_step(cfg)(model, {"tokens": toks[:, :1],
                                              "cache_index": 0}, caches[0])
    want, _ = M.decode_step(model, {"tokens": toks[:, :1],
                                    "cache_index": 0}, caches[1])
    assert torch.equal(got, want)

    assert shapes(dict(enumerate(St.emd_search_input_specs(NEWS)))) == \
        shapes(dict(enumerate(JSt.emd_search_input_specs(JNEWS))))
    assert St.workload_method(NEWS) == "act"
    work = dataclasses.replace(NEWS, n_db=40, vocab=60, dim=8, hmax=6,
                               iters=2, queries=3)
    c, _ = make_text_like(work.n_db, vocab=work.vocab, m=work.dim,
                          hmax=work.hmax, seed=0)
    ops = (c.ids, c.w, c.coords, c.ids[:3], c.w[:3])
    s, i = St.make_emd_search_step(work, top_l=4)(*ops)
    full = retrieval.batch_scores(c, c.ids[:3], c.w[:3], method="act",
                                  iters=2)
    assert torch.equal(s, full.sort(dim=1).values[:, :4])
    s2, i2 = St.make_emd_cascade_step(work, "chain", top_l=4)(*ops)
    res = cascade_search(c, c.ids[:3], c.w[:3], "chain", 4,
                         n_valid=work.n_db)
    assert torch.equal(s2, res.scores) and torch.equal(i2, res.indices)
