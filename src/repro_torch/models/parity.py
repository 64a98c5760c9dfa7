"""One model on two devices: ``card_vs_cpu`` draws a config's weights on the
CPU, carries the same weights to another device through ``convert``, runs
``forward``, ``prefill`` and a few ``decode_step``s on both with the same
inputs from a seed, and holds every logit and every cache leaf on that
device to the CPU's within a tolerance. For training, ``train_card_vs_cpu``
does the same for one train step (loss, grad norm, parameters, moments),
``remat_spread`` compares the remat settings on one device, and
``replay_bitwise`` holds a ``FaultTolerantRunner`` run through injected
failures to the failure-free run.

``chip_smoke.py`` phases 13 (a) and 14 (a), ``tests/test_torch_models_cuda.py``
and ``tests/test_torch_train_cuda.py`` run them on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

#: Two prompts of SEQ tokens, STEPS decode steps, weights and inputs from
#: seed 0; rtol = atol = TOL (float32: cuBLAS's summation order against
#: the CPU's).
BATCH, SEQ, STEPS, TOL = 2, 16, 4, 1e-4


def max_diff(got, want, what: str) -> float:
    """max |got - want| over two trees (dicts, tuples, tensors, None) of
    one layout, ``want`` on the CPU; raises ``AssertionError`` naming the
    leaf whose layout differs or which is beyond rtol = atol = TOL."""
    if want is None:
        if got is not None:
            raise AssertionError(f"{what}: a value where the CPU has none")
        return 0.0
    if isinstance(want, (dict, tuple)):
        keys = sorted(want) if isinstance(want, dict) else range(len(want))
        if type(got) is not type(want) or len(got) != len(want):
            raise AssertionError(f"{what}: the layout differs")
        return max((max_diff(got[k], want[k], f"{what}/{k}") for k in keys),
                   default=0.0)
    g = got.cpu()
    if g.shape != want.shape or g.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(g.shape)} {g.dtype} against "
                             f"{tuple(want.shape)} {want.dtype} on the CPU")
    d = float((g.double() - want.double()).abs().max()) if g.numel() else 0.
    if not torch.allclose(g, want, rtol=TOL, atol=TOL):
        raise AssertionError(f"{what}: max |d| {d} beyond rtol / atol {TOL}")
    return d


def card_vs_cpu(cfg: ModelConfig, device) -> dict[str, float]:
    """``cfg``'s model on the CPU and on ``device``: forward's logits and
    aux, prefill's logits and compact caches, and STEPS decode steps into
    a SEQ-token cache, each step's logits and whole cache. Returns the
    largest |device - CPU| of each stage; raises ``AssertionError`` at the
    first leaf out of tolerance."""
    batch, seq, steps = BATCH, SEQ, STEPS
    cpu = M.init(cfg, seed=0, device="cpu")
    other = convert.params_from_numpy(convert.params_to_numpy(cpu), cfg,
                                      device)
    rng = np.random.default_rng(0)
    if cfg.frontend != "none":
        key = "embeddings"
        x = rng.normal(size=(batch, seq + steps, cfg.d_model)).astype(
            np.float32)
    else:
        key = "tokens"
        x = rng.integers(0, cfg.vocab, (batch, seq + steps))
    runs = ((other, device), (cpu, "cpu"))

    def on(d, sl):
        return {key: torch.as_tensor(x[:, sl], device=d)}
    prompt = slice(0, seq)
    err = {}
    got, want = (M.forward(m, on(d, prompt)) for m, d in runs)
    err["forward"] = max_diff(got[:2], want[:2], "forward")
    got, want = (M.prefill(m, on(d, prompt)) for m, d in runs)
    err["prefill"] = max_diff(got, want, "prefill")
    caches = [M.init_decode_cache(cfg, batch, seq, torch.float32, device=d)
              for _, d in runs]
    err["decode"] = 0.0
    for t in range(steps):
        sl = slice(seq + t, seq + t + 1)
        (gl, _), (wl, _) = (
            M.decode_step(m, {**on(d, sl), "cache_index": t}, c)
            for (m, d), c in zip(runs, caches))
        err["decode"] = max(err["decode"],
                            max_diff(gl, wl, f"step {t}"),
                            max_diff(caches[0], caches[1], f"step {t} cache"))
    return err


# ----------------------------------------------------------------------------
# Training: one step, the remat policies, a replay through failures
# ----------------------------------------------------------------------------

#: Tokens a row and rows of the training batches at smoke width.
TRAIN_BATCH, TRAIN_SEQ = 2, 16


def train_batch(cfg: ModelConfig, step: int = 0,
                batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ) -> dict:
    """A training batch of numpy arrays from a seed: the token pipeline's
    tokens and labels (``data.tokens.global_batch``, seed 0, at ``step``),
    with seeded normal embeddings in place of the tokens for the stub
    audio / vision frontends."""
    from repro_torch.data.tokens import DataConfig, global_batch
    b = global_batch(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                global_batch=batch, seed=0), step)
    if cfg.frontend != "none":
        rng = np.random.default_rng(step)
        b["embeddings"] = rng.normal(
            size=(batch, seq, cfg.d_model)).astype(np.float32)
        del b["tokens"]
    return b


def _on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


#: A sequence past ``layers.FLASH_THRESHOLD`` (1,024) and a multiple of
#: ``FLASH_CHUNK`` (512): the chunked attention, its backward and the remat
#: over it, in one row.
LONG_SEQ, LONG_BATCH = 1536, 1
#: The long runs' attention: global, and a sliding window of 1,024 on every
#: layer (gemma3's local window).
LONG_WINDOWS = {"global": 0, "window": 1024}


def long_config(window: int) -> ModelConfig:
    """Smoke olmo with full remat (``smoke_config`` turns it off) and
    ``window`` on every layer, for the LONG_SEQ runs."""
    import dataclasses

    from repro_torch.configs import smoke_config
    return dataclasses.replace(smoke_config("olmo-1b"), remat=True,
                               remat_policy="full", sliding_window=window)


def train_card_vs_cpu(cfg: ModelConfig, device, seq: int = TRAIN_SEQ,
                      batch_rows: int = TRAIN_BATCH) -> dict[str, float]:
    """One ``launch.steps.make_train_step`` step (default AdamW, one
    microbatch) of ``cfg``'s model on the CPU and on ``device`` from the
    same weights and a batch of ``batch_rows`` x ``seq`` tokens: the loss,
    the grad norm, every parameter and both moments after it within
    rtol = atol = TOL. Returns the largest |device - CPU| of each; raises
    ``AssertionError`` at the first leaf out of tolerance."""
    from repro_torch.launch import steps
    from repro_torch.models.config import InputShape
    from repro_torch.optim import adamw
    cpu = M.init(cfg, seed=0, device="cpu")
    other = convert.params_from_numpy(convert.params_to_numpy(cpu), cfg,
                                      device)
    step = steps.make_train_step(InputShape("train", seq, batch_rows,
                                            "train"), n_micro=1)
    batch = train_batch(cfg, batch=batch_rows, seq=seq)
    outs = []
    for model, d in ((other, device), (cpu, "cpu")):
        opt = adamw.init(dict(model.named_parameters()), cfg.opt_state_dtype)
        _, opt, metrics = step(model, opt, _on(batch, d))
        outs.append((dict(model.named_parameters()), opt, metrics))
    (gp, go, gm), (wp, wo, wm) = outs
    return {"loss": max_diff(gm["loss"], wm["loss"], "loss"),
            "grad_norm": max_diff(gm["grad_norm"], wm["grad_norm"],
                                  "grad norm"),
            "params": max_diff({k: v.detach() for k, v in gp.items()},
                               {k: v.detach() for k, v in wp.items()},
                               "params"),
            "moments": max(max_diff(go["m"], wo["m"], "m"),
                           max_diff(go["v"], wo["v"], "v"))}


def loss_and_grads(model, batch: dict):
    """``train_loss`` and its gradients, keyed by parameter name."""
    from repro_torch.optim.grad_utils import accumulate_grads
    params = dict(model.named_parameters())
    return accumulate_grads(lambda b: M.train_loss(model, b), params,
                            batch, 1)


def remat_spread(cfg: ModelConfig, device) -> dict[str, float]:
    """``train_loss`` and its gradients with remat off, ``full`` and
    ``dots`` on one set of weights on ``device``: the largest |d| of the
    loss and of any gradient between ``full`` or ``dots`` and remat off
    (0.0 where the recomputation is bitwise)."""
    import dataclasses
    tree = convert.params_to_numpy(M.init(cfg, seed=0, device="cpu"))
    batch = _on(train_batch(cfg), device)
    runs = {}
    for name, kw in (("off", dict(remat=False)),
                     ("full", dict(remat=True, remat_policy="full")),
                     ("dots", dict(remat=True, remat_policy="dots"))):
        model = convert.params_from_numpy(
            tree, dataclasses.replace(cfg, **kw), device)
        runs[name] = loss_and_grads(model, batch)
    (l0, g0) = runs["off"]
    out = {}
    for name in ("full", "dots"):
        loss, grads = runs[name]
        out[f"{name}_loss"] = float((loss - l0).abs())
        out[f"{name}_grads"] = max(float((grads[k] - g0[k]).abs().max())
                                   for k in g0)
    return out


def replay_run(cfg: ModelConfig, device, ckpt_dir: str, n_steps: int,
               fail_at: tuple[int, ...] = (), ckpt_every: int = 5):
    """``n_steps`` train steps of ``cfg``'s model (seed 0) on ``device``
    under ``runtime.fault.FaultTolerantRunner``, checkpoints in
    ``ckpt_dir``, the first attempt of each step in ``fail_at`` failing
    before it runs. Returns (the final ``TrainState``, the runner, the
    losses of the steps that ran, replays included)."""
    from repro_torch.launch import steps
    from repro_torch.models.config import InputShape
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault import FaultTolerantRunner
    model = M.init(cfg, seed=0, device=device)
    opt = adamw.init(dict(model.named_parameters()), cfg.opt_state_dtype)
    step = steps.runner_step(steps.make_train_step(
        InputShape("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
        adamw.AdamWConfig(peak_lr=3e-3, warmup_steps=5,
                          total_steps=n_steps), n_micro=1))
    pending, losses = set(fail_at), []

    def flaky(state, batch):
        n = int(state.opt["step"])
        if n in pending:
            pending.discard(n)
            raise RuntimeError(f"injected failure at step {n}")
        state = step(state, batch)
        losses.append(float(state.metrics["loss"]))
        return state

    runner = FaultTolerantRunner(
        flaky, lambda n: _on(train_batch(cfg, n), device), ckpt_dir,
        ckpt_every=ckpt_every)
    state = runner.run(steps.TrainState(model, opt), n_steps)
    return state, runner, losses


def replay_bitwise(cfg: ModelConfig, device, ckpt_root: str,
                   n_steps: int = 30, fail_at: tuple[int, ...] = (7, 18)):
    """``replay_run`` with failures at ``fail_at`` against the same run
    without any: every parameter, moment and the step counter must be
    bitwise equal. Returns (restarts, the failure-free run's losses);
    raises ``AssertionError`` naming the first leaf that differs."""
    import os
    clean, _, losses = replay_run(cfg, device,
                                  os.path.join(ckpt_root, "clean"), n_steps)
    flaky, runner, _ = replay_run(cfg, device,
                                  os.path.join(ckpt_root, "flaky"), n_steps,
                                  fail_at)
    if runner.restarts != len(fail_at):
        raise AssertionError(f"{runner.restarts} restarts, not "
                             f"{len(fail_at)}")
    want, got = clean.tree(), flaky.tree()

    def same(a, b, what):
        if isinstance(a, dict):
            for k in a:
                same(a[k], b[k], f"{what}/{k}")
        elif not torch.equal(a, b):
            d = float((a.double() - b.double()).abs().max())
            raise AssertionError(f"{what}: the replayed run differs from "
                                 f"the failure-free one (max |d| {d})")
    same(want, got, "state")
    return runner.restarts, losses
