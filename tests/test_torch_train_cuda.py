"""The LM training path on the card at ``smoke_config``, under float32
(``chip_smoke.py`` phase 14 (a)): one train step of every architecture on
the card against the port's CPU run on the same weights and batch (loss,
grad norm, parameters and moments within atol / rtol 1e-4), and smoke
olmo at 1,536 tokens under full remat, global and with a window of 1,024
(the chunked attention's backward and its recomputation); remat off,
``full`` and ``dots`` giving the same loss and gradients on the card; and
30 smoke-olmo steps through two injected failures bitwise the failure-free
run on the card.

The mesh train step (``chip_smoke.py`` phase 15 (a)): on a one-rank NCCL
mesh it is the single-card step bit for bit.

Needs a CUDA device; skips without one. This file imports no JAX: on the
card the reference is the port's own CPU run, which
``tests/test_torch_train.py`` holds to the JAX package.
"""
import dataclasses

import pytest
import torch

import torch_train_ranks as ranks
from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.launch.local import run_local
from repro_torch.models import parity


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the model trains on the card")
    if torch.backends.cuda.matmul.allow_tf32:
        pytest.skip("float32 matmuls may use TF32 in this process")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ARCH_IDS)
def test_train_step_on_the_card_matches_the_cpu(cuda, name):
    err = parity.train_card_vs_cpu(smoke_config(name), cuda)
    assert sorted(err) == ["grad_norm", "loss", "moments", "params"]


@pytest.mark.cuda
@pytest.mark.parametrize("window", list(parity.LONG_WINDOWS.values()),
                         ids=list(parity.LONG_WINDOWS))
def test_long_train_step_on_the_card_matches_the_cpu(cuda, window):
    """S = 1536 under full remat: the chunked attention's backward and the
    recomputation over it, global and with a window of 1024."""
    err = parity.train_card_vs_cpu(parity.long_config(window), cuda,
                                   parity.LONG_SEQ, parity.LONG_BATCH)
    assert sorted(err) == ["grad_norm", "loss", "moments", "params"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ARCH_IDS)
def test_remat_policies_agree_on_the_card(cuda, name):
    spread = parity.remat_spread(smoke_config(name), cuda)
    assert spread["full_loss"] < 1e-6 and spread["dots_loss"] < 1e-6
    assert spread["full_grads"] < 1e-5 and spread["dots_grads"] < 1e-5


@pytest.mark.cuda
def test_training_through_failures_is_bitwise_on_the_card(cuda, tmp_path):
    restarts, _ = parity.replay_bitwise(smoke_config("olmo-1b"), cuda,
                                        str(tmp_path))
    assert restarts == 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["olmo-1b", "mixtral-8x22b"])
def test_one_rank_nccl_mesh_step_is_the_single_card_step(cuda, name):
    """Two steps (remat dots; mixtral with moe_shard_map, whose one-rank
    model axis keeps the plain path): loss, grad norm, lr, parameters and
    moments bitwise the single-card step's."""
    cfg = dataclasses.replace(smoke_config(name), remat=True,
                              remat_policy="dots", moe_shard_map=True)
    batches = [{k: torch.as_tensor(v) for k, v in
                parity.train_batch(cfg, s, batch=4).items()}
               for s in range(2)]
    out, = run_local(ranks.one_rank_against_one_device, 1, 1,
                     backend="nccl", device="cuda", args=(cfg, batches))
    assert out == {"metrics": [True, True], "params": True,
                   "moments": True}
