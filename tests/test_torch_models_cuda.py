"""The LM serving path on the card: every architecture at ``smoke_config``
under float32, the same weights on the CPU and on the card, ``forward``,
``prefill`` and 4 ``decode_step``s within atol 1e-4 / rtol 1e-4 of the
port's CPU run (``chip_smoke.py`` phase 13 (a)).

Needs a CUDA device; skips without one. This file imports no JAX: on the
card the reference is the port's own CPU run, which
``tests/test_torch_models.py`` holds to the JAX package.
"""
import pytest
import torch

from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.models import parity


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the model runs on the card")
    if torch.backends.cuda.matmul.allow_tf32:
        pytest.skip("float32 matmuls may use TF32 in this process")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ARCH_IDS)
def test_card_matches_the_cpu_at_smoke_width(cuda, name):
    err = parity.card_vs_cpu(smoke_config(name), cuda)
    assert sorted(err) == ["decode", "forward", "prefill"]
