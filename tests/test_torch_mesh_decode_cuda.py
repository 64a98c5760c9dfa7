"""The mesh prefill and decode steps on the card (``chip_smoke.py`` phase
16): on a one-rank NCCL mesh they are the single card's ``prefill`` and
``decode_step`` bit for bit, for every architecture at ``smoke_config``
(float32); on gloo worlds whose ranks share the card, within 1e-4 of the
port's single-device run on the CPU (a 2x2 world with TP attention, MLP
and vocabulary; a 1x4 world whose GQA caches split the sequence).

Needs a CUDA device; skips without one. This file imports no JAX: on the
card the reference is the port's own single-device run, which
``tests/test_torch_mesh_decode.py`` and ``tests/test_torch_models.py``
hold to the JAX package.
"""
import numpy as np
import pytest
import torch

import torch_decode_ranks as ranks
from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.launch import steps as St
from repro_torch.launch.local import run_local
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.sharding import rules

ROWS, PROMPT, STEPS, TOL = 4, 16, 4, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mesh steps run on the card")
    if torch.backends.cuda.matmul.allow_tf32:
        pytest.skip("float32 matmuls may use TF32 in this process")
    return torch.device("cuda")


def inputs_of(cfg):
    rng = np.random.default_rng(2)
    n = PROMPT + STEPS
    if cfg.frontend != "none":
        return {"embeddings": rng.normal(size=(ROWS, n, cfg.d_model))
                .astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab, (ROWS, n)).astype(np.int32)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ARCH_IDS)
def test_one_rank_nccl_mesh_serve_is_the_single_card(cuda, name):
    cfg = smoke_config(name)
    out, = run_local(ranks.one_rank_against_one_device, 1, 1,
                     backend="nccl", device="cuda",
                     args=(cfg, inputs_of(cfg), PROMPT))
    assert out == {"prefill": True, "caches": True, "steps": [True] * STEPS,
                   "cache": True, "bytes": {}}


def cpu_run(cfg, tree, inputs):
    """The port's single-device logits on the CPU: [prefill, step...]."""
    model = convert.params_from_numpy(tree, cfg, "cpu")
    (key, x), S = next(iter(inputs.items())), PROMPT
    x = torch.as_tensor(x)
    logits, caches = M.prefill(model, {key: x[:, :S]})
    cache = M.init_decode_cache(cfg, ROWS, S + St.CACHE_PAD - 1,
                                torch.float32, device="cpu")
    ssm, kv = {"ssm": (caches, None), "hybrid": caches}.get(
        cfg.family, (None, caches))
    for n, t in (kv or {}).items():
        cache["attn"][n][..., :S, :, :].copy_(t)
    for n, t in (ssm or {}).items():
        cache["ssm"][n].copy_(t)
    out = [logits]
    for t in range(S, x.shape[1]):
        logits, cache = M.decode_step(
            model, {key: x[:, t:t + 1], "cache_index": t}, cache)
        out.append(logits)
    return [o.numpy() for o in out]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_gloo_world_on_the_card_matches_the_cpu(cuda, shape):
    names = ["olmo-1b", "gemma3-27b", "zamba2-2.7b"]
    cases = []
    for name in names:
        cfg = smoke_config(name)
        cases.append(dict(cfg=cfg, tree=convert.params_to_numpy(
            M.init(cfg, seed=0, device="cpu")), inputs=inputs_of(cfg),
            prompt_len=PROMPT))
    results = run_local(ranks.serve_cases, *shape, backend="gloo",
                        device="cuda", args=(cases,))
    for i, case in enumerate(cases):
        cfg = case["cfg"]
        want = cpu_run(cfg, case["tree"], case["inputs"])
        spec = rules.logits_spec(ranks_mesh(shape), ROWS, cfg.vocab)
        for r in results:
            run = r[i]
            for got, w in zip([run["prefill"], *run["decode"]], want):
                sl = rules.block_slices(w.shape, spec, ranks_mesh(shape),
                                        run["coords"])
                np.testing.assert_allclose(got, w[sl], atol=TOL, rtol=TOL,
                                           err_msg=f"{cfg.name} {shape}")


def ranks_mesh(shape):
    from repro_torch.launch.mesh import plan_mesh
    return plan_mesh(*shape)
