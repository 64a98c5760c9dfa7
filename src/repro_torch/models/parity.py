"""One model on two devices: ``card_vs_cpu`` draws a config's weights on the
CPU, carries the same weights to another device through ``convert``, runs
``forward``, ``prefill`` and a few ``decode_step``s on both with the same
inputs from a seed, and holds every logit and every cache leaf on that
device to the CPU's within a tolerance.

``chip_smoke.py`` phase 13 (a) and ``tests/test_torch_models_cuda.py``
both run it on the card.
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
