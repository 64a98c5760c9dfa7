"""The port's sharding rules (``repro_torch.sharding.rules``) against the
JAX package's (``repro.sharding.rules``), which are shape code and run
here: every parameter spec of the ten full configs in modes tp, fsdp and
ep, the batch, cache and logits specs, on the production meshes
({data: 16, model: 16} and {pod: 2, data: 16, model: 16}) and on 2x2,
1x4 and 4x1; leaf for leaf in JAX's tree layout, a JAX ``PartitionSpec``
read as the tuple of its entries. Then the per-block table of the port's
parameters and the block a rank holds.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.launch import steps as JSt
from repro.models.config import SHAPES as JSHAPES
from repro.sharding import rules as JR
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import steps as St
from repro_torch.launch.mesh import make_test_mesh, plan_mesh
from repro_torch.models import convert
from repro_torch.models.config import SHAPES
from repro_torch.sharding import rules


class FakeMesh:
    """Shape-only stand-in (the rules read .shape and .axis_names)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "pod2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
          "2x2": FakeMesh({"data": 2, "model": 2}),
          "1x4": FakeMesh({"data": 1, "model": 4}),
          "4x1": FakeMesh({"data": 4, "model": 1})}


def as_tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda s: isinstance(s, P))


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


@functools.lru_cache(maxsize=None)
def trees(name):
    """(JAX's abstract parameters, the port's model on the meta device and
    its JAX-layout tree) of a full config."""
    model = St.abstract_params(get_config(name))
    return (JSt.abstract_params(jax_get_config(name)), model,
            convert.to_tree(model, dict(model.named_parameters())))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", ARCH_IDS)
def test_param_specs_match_jax(name, mesh):
    jparams, model, tree = trees(name)
    for mode in rules.MODES:
        want = flat(as_tuples(JR.param_specs(jparams, MESHES[mesh], mode)))
        got = flat(rules.param_specs(tree, MESHES[mesh], mode))
        assert got == want, mode
        # the per-block table: the stacked layer dim dropped
        per_block = rules.model_specs(model, MESHES[mesh], mode)
        for pname, spec in per_block.items():
            path, layer = convert.layer_path(pname, model.cfg)
            stacked = got[path]
            assert spec == (stacked[1:] if layer is not None and stacked
                            else stacked), (mode, pname)


def test_fall_through_to_a_later_candidate_and_to_replication():
    """qwen2-vl-7b's 28 heads do not split 16 ways: its wq falls past the
    head-sharded candidate to the head-dim one; mamba2-2.7b's lm_head (a
    vocabulary of 50,277) fits no candidate in mode tp and is replicated.
    Both as in JAX."""
    mesh = MESHES["16x16"]
    q = flat(rules.param_specs(trees("qwen2-vl-7b")[2], mesh))
    assert q[("blocks", "attn", "wq")] == (None, "data", None, "model")
    assert rules._CAND["wq"][1][1] == q[("blocks", "attn", "wq")]
    m = flat(rules.param_specs(trees("mamba2-2.7b")[2], mesh))
    assert m[("lm_head",)] == ()
    assert get_config("mamba2-2.7b").vocab % 16 != 0
    jm = flat(as_tuples(JR.param_specs(trees("mamba2-2.7b")[0], mesh)))
    assert jm[("lm_head",)] == ()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_match_jax(mesh):
    """Every cell's inputs of the ten architectures (tokens, the stub
    frontends' embeddings, the decode index) in every mode; long_500k's
    batch of 1 and a batch of 2 fall back as JAX's do."""
    fake = MESHES[mesh]
    for name in ARCH_IDS:
        for cell, shape in SHAPES.items():
            batch = St.input_specs(get_config(name), shape)
            jbatch = JSt.input_specs(jax_get_config(name), JSHAPES[cell])
            for mode in rules.MODES:
                assert flat(rules.batch_specs(batch, fake, mode)) == flat(
                    as_tuples(JR.batch_specs(jbatch, fake, mode))), \
                    (name, cell, mode)
    two = {"tokens": torch.empty((2, 8), device="meta")}
    jtwo = {"tokens": jax.ShapeDtypeStruct((2, 8), np.int32)}
    for mode in rules.MODES:
        assert rules.batch_specs(two, fake, mode) == as_tuples(
            JR.batch_specs(jtwo, fake, mode))


@pytest.mark.parametrize("name", ARCH_IDS)
def test_cache_specs_match_jax(name):
    cfg, jcfg = get_config(name), jax_get_config(name)
    for cell in ("decode_32k", "long_500k"):
        cache = St.abstract_cache(cfg, SHAPES[cell])
        jcache = JSt.abstract_cache(jcfg, JSHAPES[cell])
        for mesh in MESHES.values():
            assert flat(rules.cache_specs(cache, cfg, mesh)) == flat(
                as_tuples(JR.cache_specs(jcache, jcfg, mesh))), (cell, mesh)


def test_logits_spec_matches_jax():
    for mesh in MESHES.values():
        for batch in (1, 2, 32, 128):
            for vocab in (32_000, 50_277, 50_304, 256):
                assert rules.logits_spec(mesh, batch, vocab) == tuple(
                    JR.logits_spec(mesh, batch, vocab))


def test_block_slices_lay_out_the_mesh_data_major():
    """A dim over ("data", "model") is cut into data x model parts, data
    major, as JAX's device order lays it out; the blocks of all ranks tile
    the leaf once."""
    mesh = MESHES["2x2"]
    for spec, shape in (((("data", "model"), None), (8, 3)),
                        (("model", "data"), (4, 6))):
        whole = torch.arange(shape[0] * shape[1]).reshape(shape)
        seen = torch.zeros_like(whole)
        for d in range(2):
            for m in range(2):
                sl = rules.block_slices(whole.shape, spec, mesh,
                                        {"data": d, "model": m})
                if spec[1] is None:
                    assert sl[0] == slice((2 * d + m) * 2,
                                          (2 * d + m + 1) * 2)
                seen[sl] += 1
        assert bool((seen == 1).all())
    with pytest.raises(ValueError, match="does not split"):
        rules.block_slices((5, 4), ("data", None), mesh,
                           {"data": 0, "model": 0})
    with pytest.raises(ValueError, match="mode"):
        rules.param_specs({"wq": torch.empty(2, 2)}, mesh, "dp")


def test_port_mesh_and_plan_serve_the_rules():
    """The port's ``Mesh`` (a plan, or a joined one-rank mesh) has JAX's
    ``axis_names``; the rules read it as they read a stand-in."""
    plan = plan_mesh(2, 2)
    assert plan.axis_names == ("data", "model")
    _, model, tree = trees("olmo-1b")
    assert rules.param_specs(tree, plan) == rules.param_specs(
        tree, MESHES["2x2"])
    one = make_test_mesh(1, 1, device="cpu")
    assert rules.block_slices((4, 6), ("data", "model"), one) == (
        slice(0, 4), slice(0, 6))
    specs = rules.model_specs(model, plan, "fsdp")
    assert specs["embed"] == (None, ("data", "model"))
    assert specs["blocks.0.attn.wq"] == (("data", "model"), None, None)
