"""The port's checkpoint store (``repro_torch.checkpoint.store``) against the
JAX package's (``repro.checkpoint.store``).

Each case of ``tests/test_checkpoint.py`` has its counterpart here, on a
tree of tensors (a bfloat16 leaf and nested dicts and lists included);
then a bfloat16 round trip, the typed dtype-mismatch error, numpy leaves,
and the cross-package restores: a checkpoint the JAX store writes, read by
the port's ``restore``, and the reverse, leaves bitwise and the files byte
for byte the same.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro_torch.checkpoint import store


@pytest.fixture
def tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones((2, 2), dtype=torch.bfloat16),
                       "c": [torch.zeros(3), torch.tensor(5)]}}


def _leaves(tree):
    return [leaf for _, leaf in store._leaf_paths(tree)]


def _assert_same(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert type(x) is type(y)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x.view(torch.uint8) if x.dim() else x,
                               y.view(torch.uint8) if y.dim() else y)
        else:
            np.testing.assert_array_equal(x, y)


def test_roundtrip(tmp_path, tree):
    d = str(tmp_path)
    store.save(d, 7, tree, extra={"loss": 1.5})
    assert store.latest_step(d) == 7
    out = store.restore(d, 7, tree)
    _assert_same(tree, out)
    assert isinstance(out["nested"]["c"], list)
    assert store.restore_extra(d, 7)["loss"] == 1.5


def test_corruption_detected(tmp_path, tree):
    d = str(tmp_path)
    path = store.save(d, 1, tree)
    victim = os.path.join(path, "a.npy")
    arr = np.load(victim)
    arr.ravel()[0] += 1
    np.save(victim, arr)
    with pytest.raises(IOError, match="corruption"):
        store.restore(d, 1, tree)
    # verify=False permits (for forensics)
    store.restore(d, 1, tree, verify=False)


def test_latest_ignores_torn_tmp(tmp_path, tree):
    d = str(tmp_path)
    store.save(d, 3, tree)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    os.makedirs(os.path.join(d, "step_00000010"))  # no manifest => torn
    assert store.latest_step(d) == 3


def test_save_overwrites_same_step(tmp_path, tree):
    d = str(tmp_path)
    store.save(d, 2, tree)
    tree2 = {"a": tree["a"] * 0 + 9, "nested": tree["nested"]}
    store.save(d, 2, tree2)
    out = store.restore(d, 2, tree)
    assert float(out["a"].ravel()[0]) == 9.0


def test_manifest_contents(tmp_path, tree):
    d = str(tmp_path)
    p = store.save(d, 4, tree)
    with open(os.path.join(p, "manifest.json")) as f:
        man = json.load(f)
    assert man["step"] == 4
    assert "a" in man["leaves"]
    assert man["leaves"]["a"]["shape"] == [3, 4]
    assert len(man["leaves"]["a"]["sha256"]) == 64
    assert man["leaves"]["nested/b"]["dtype"] == "bfloat16"
    assert man["leaves"]["nested/c/1"]["shape"] == []


def test_corruption_is_typed_for_fallback(tmp_path, tree):
    d = str(tmp_path)
    path = store.save(d, 1, tree)
    with open(os.path.join(path, "a.npy"), "r+b") as f:
        f.seek(8)
        f.write(b"\xff")
    with pytest.raises(store.CheckpointCorrupt):
        store.restore(d, 1, tree)
    assert issubclass(store.CheckpointCorrupt, IOError)


def test_latest_skips_partial_manifest(tmp_path, tree):
    d = str(tmp_path)
    store.save(d, 3, tree)
    p = store.save(d, 5, tree)
    man = os.path.join(p, store.MANIFEST)
    with open(man) as f:
        content = f.read()
    with open(man, "w") as f:
        f.write(content[:len(content) // 2])       # torn mid-write
    assert store.steps(d) == [3]
    assert store.latest_step(d) == 3
    with pytest.raises(store.CheckpointCorrupt, match="partial"):
        store.load_manifest(d, 5)


def test_latest_skips_missing_leaf_file(tmp_path, tree):
    d = str(tmp_path)
    store.save(d, 2, tree)
    p = store.save(d, 4, tree)
    os.remove(os.path.join(p, "a.npy"))
    assert store.latest_step(d) == 2
    with pytest.raises(store.CheckpointCorrupt, match="unreadable"):
        store.restore(d, 4, tree)


def test_crash_mid_save_leaves_previous_snapshot_live(tmp_path, tree,
                                                      monkeypatch):
    d = str(tmp_path)
    store.save(d, 1, tree)
    real_rename = os.rename

    def crash(src, dst):
        raise OSError("simulated crash before atomic publish")

    monkeypatch.setattr(store.os, "rename", crash)
    with pytest.raises(OSError, match="simulated crash"):
        store.save(d, 2, tree)
    monkeypatch.setattr(store.os, "rename", real_rename)
    assert os.path.isdir(os.path.join(d, "step_00000002.tmp"))
    assert store.steps(d) == [1]
    assert store.latest_step(d) == 1
    store.save(d, 2, tree)
    assert store.latest_step(d) == 2
    _assert_same(tree, store.restore(d, 2, tree))


def test_restore_missing_manifest_is_corrupt(tmp_path, tree):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step_00000006"))
    with pytest.raises(store.CheckpointCorrupt, match="manifest missing"):
        store.restore(d, 6, tree)
    assert store.latest_step(d) is None


# --------------------------------------------------- beyond the JAX suite


def test_bfloat16_roundtrip_bitwise(tmp_path):
    """bfloat16 leaves of every rank round-trip bitwise through torch (no
    ml_dtypes), NaN and infinity payloads included."""
    g = torch.Generator().manual_seed(0)
    bits = torch.randint(-2**15, 2**15, (5, 7), generator=g,
                         dtype=torch.int16)
    tree = {"m": bits.view(torch.bfloat16), "s": torch.tensor(
        1.5, dtype=torch.bfloat16), "v": torch.tensor(
        [float("nan"), float("inf"), -0.0], dtype=torch.bfloat16)}
    store.save(str(tmp_path), 0, tree)
    out = store.restore(str(tmp_path), 0, tree)
    for k in tree:
        assert out[k].dtype == torch.bfloat16
        assert torch.equal(out[k].reshape(-1).view(torch.int16),
                           tree[k].reshape(-1).view(torch.int16))


@pytest.mark.parametrize("target", [torch.float32, torch.float16,
                                    torch.int32])
def test_dtype_mismatch_is_typed_not_cast(tmp_path, target):
    tree = {"x": torch.ones(4, dtype=torch.bfloat16)}
    store.save(str(tmp_path), 0, tree)
    with pytest.raises(store.CheckpointCorrupt, match="dtype mismatch"):
        store.restore(str(tmp_path), 0, {"x": torch.ones(4, dtype=target)})


def test_numpy_leaves_and_zero_storage_targets(tmp_path):
    tree = {"i": np.arange(6, dtype=np.int64).reshape(2, 3),
            "m": np.array([True, False]), "t": torch.arange(3.0)}
    store.save(str(tmp_path), 1, tree)
    like = {"i": np.zeros((2, 3), np.int64), "m": np.zeros(2, bool),
            "t": torch.empty((), dtype=torch.float32).expand(3)}
    out = store.restore(str(tmp_path), 1, like)
    assert isinstance(out["i"], np.ndarray) and isinstance(out["t"],
                                                           torch.Tensor)
    _assert_same(tree, out)


def _jax_tree():
    return {"a": jnp.arange(12.0).reshape(3, 4),
            "nested": {"b": jnp.asarray([[1.5, -2.0], [3.25, 0.0]],
                                        jnp.bfloat16),
                       "c": [jnp.asarray([1, 2, 3], jnp.int32),
                             jnp.asarray(5, jnp.int32)]},
            "z": jnp.asarray([True, False, True])}


def _torch_tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.tensor([[1.5, -2.0], [3.25, 0.0]],
                                         dtype=torch.bfloat16),
                       "c": [torch.tensor([1, 2, 3], dtype=torch.int32),
                             torch.tensor(5, dtype=torch.int32)]},
            "z": torch.tensor([True, False, True])}


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


def test_jax_written_checkpoint_restores_in_the_port(tmp_path):
    jtree, ttree = _jax_tree(), _torch_tree()
    jstore.save(str(tmp_path), 3, jtree, extra={"from": "jax"})
    out = store.restore(str(tmp_path), 3, ttree)
    _assert_same(ttree, out)
    assert store.restore_extra(str(tmp_path), 3) == {"from": "jax"}


def test_port_written_checkpoint_restores_in_jax(tmp_path):
    jtree, ttree = _jax_tree(), _torch_tree()
    store.save(str(tmp_path / "t"), 3, ttree, extra={"from": "torch"})
    out = jstore.restore(str(tmp_path / "t"), 3, jtree)
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(out),
                    strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(
            np.asarray(a).reshape(-1).view(np.uint8),
            np.asarray(b).reshape(-1).view(np.uint8))
    # The two packages write the same bytes, manifest included.
    jstore.save(str(tmp_path / "j"), 3, jtree, extra={"from": "torch"})
    assert _files(tmp_path / "t" / "step_00000003") == \
        _files(tmp_path / "j" / "step_00000003")
