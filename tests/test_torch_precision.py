"""The port's precision policies against the JAX package's: sentinels bitwise
equal, the same presets, an unknown preset refused by name."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jprec
from repro_torch.core import precision as tprec


@pytest.mark.parametrize("name", ["float32", "bfloat16", "float16"])
def test_pad_dist_for_bitwise_equal_to_jax(name):
    got = tprec.pad_dist_for(getattr(torch, name))
    want = jprec.pad_dist_for(jnp.dtype(name))
    assert np.float64(got).tobytes() == np.float64(want).tobytes()
    assert tprec.pad_dist_for(name) == got          # dtype name accepted
    # exactly representable in its dtype: a round trip is the identity
    assert float(torch.tensor(got, dtype=getattr(torch, name))) == got


def test_pad_dist_f32_is_float32_1e30():
    assert tprec.pad_dist_for(torch.float32) == float(np.float32(1e30))


@pytest.mark.parametrize("name", sorted(tprec.POLICIES))
def test_policies_match_jax(name):
    got, want = tprec.resolve(name), jprec.resolve(name)
    assert (got.name, got.storage, got.compute, got.accum) == \
        (want.name, want.storage, want.compute, want.accum)
    assert tprec.resolve(got) is got
    assert got.storage_dtype == getattr(torch, want.storage)


def test_every_jax_policy_is_ported_or_refused_by_name():
    # Every JAX preset is ported now (bf16_agg last); a name neither
    # package knows is still refused by name.
    assert set(tprec.POLICIES) == set(jprec.POLICIES)
    assert tprec.resolve("bf16_agg").compute_dtype == torch.bfloat16
    assert tprec.resolve("bf16").compute_dtype is None
    with pytest.raises(ValueError, match="unknown precision"):
        tprec.resolve("fp8")
