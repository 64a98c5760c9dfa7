"""Checkpoint store: a tree of tensors or numpy arrays -> per-leaf .npy
files + a JSON manifest.

The on-disk format is the JAX package's (``repro/checkpoint/store.py``),
byte for byte, so a checkpoint written by either package restores in the
other:

  * ``<ckpt_dir>/step_%08d/``, one ``<name>.npy`` per leaf, where a leaf's
    name is its path of dict keys and list indices joined by ``/`` (dict
    keys in sorted order, as ``jax.tree_util`` flattens them) and its file
    name replaces ``/`` by ``__``;
  * each file is ``np.save`` of the leaf's raw bytes as uint8 (the last
    axis widened by the item size; a 0-d leaf as shape (1,)), so extension
    dtypes such as bfloat16 round-trip without ``ml_dtypes``;
  * ``manifest.json`` lists every leaf's file, shape, numpy dtype name and
    SHA-256, plus the caller's ``extra`` block. It is written LAST into a
    ``.tmp`` staging directory, which is then renamed into place: a crash
    mid-save never publishes a torn step, and ``steps`` / ``latest_step``
    also skip a step whose manifest is missing or partial or names a file
    that is not on disk;
  * restore verifies every leaf's SHA-256; a mismatch, an unreadable file,
    a torn manifest or a dtype that differs from the restore target raises
    the typed :class:`CheckpointCorrupt` (never a silent cast), so recovery
    code can fall back to an older step.

Leaves are torch tensors (any device; bfloat16 included) or numpy arrays.
``restore`` gives each leaf back in the kind of its ``like`` leaf: a tensor
on that tensor's device, or a numpy array.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
from typing import Any

import numpy as np
import torch

MANIFEST = "manifest.json"

#: The numpy dtype names a manifest records, as torch dtypes.
TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                "float32": torch.float32, "float64": torch.float64,
                "int8": torch.int8, "int16": torch.int16,
                "int32": torch.int32, "int64": torch.int64,
                "uint8": torch.uint8, "bool": torch.bool}
_DTYPE_NAMES = {dt: name for name, dt in TORCH_DTYPES.items()}


class CheckpointCorrupt(IOError):
    """A checkpoint failed integrity verification: SHA-256 mismatch,
    missing/unreadable leaf file, missing/partial manifest, or a stored
    dtype that differs from the restore target's. Typed so recovery paths
    (``serving/lifecycle.restore_latest``) can skip the bad snapshot and
    fall back to an older one."""


def _leaf_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(name, leaf) of every leaf, in ``jax.tree_util`` order: dict keys
    sorted, list and tuple items by index; ``None`` is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out.extend(_leaf_paths(sub, f"{prefix}/{key}" if prefix else key))
    return out


def _unflatten(like: Any, leaves: dict[str, Any], prefix: str = "") -> Any:
    """``like``'s structure with each leaf replaced by ``leaves[name]``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}/{k}" if prefix
                              else str(k)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, leaves, f"{prefix}/{i}" if prefix else str(i))
               for i, v in enumerate(like)]
        return type(like)(out)
    return leaves[prefix]


def _fname(name: str) -> str:
    return name.replace("/", "__") + ".npy"


def dtype_name(x) -> str:
    """The numpy name of a leaf's dtype (``"bfloat16"`` for a bfloat16
    tensor): what the manifest records."""
    if isinstance(x, torch.Tensor):
        if x.dtype not in _DTYPE_NAMES:
            raise ValueError(f"no checkpoint format for {x.dtype} leaves")
        return _DTYPE_NAMES[x.dtype]
    return str(np.asarray(x).dtype)


def _raw_bytes(x) -> np.ndarray:
    """The leaf's bytes as the uint8 array the JAX package saves: the last
    axis widened by the item size, a 0-d leaf as shape (1,)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        t = t if t.dim() else t.reshape(1)
        return t.view(torch.uint8).numpy()
    arr = np.ascontiguousarray(np.asarray(x))
    return (arr if arr.ndim else arr.reshape(1)).view(np.uint8)


def save(ckpt_dir: str, step: int, tree: Any,
         extra: dict | None = None) -> str:
    """Write checkpoint ``step`` under ckpt_dir/step_<n>/; returns the
    path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest: dict[str, Any] = {"step": step, "leaves": {},
                                "extra": extra or {}}
    for name, leaf in _leaf_paths(tree):
        path = os.path.join(tmp, _fname(name))
        np.save(path, _raw_bytes(leaf))
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        manifest["leaves"][name] = {
            "file": _fname(name), "shape": list(np.shape(leaf)),
            "dtype": dtype_name(leaf), "sha256": digest,
        }
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish
    return final


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def load_manifest(ckpt_dir: str, step: int) -> dict:
    """The parsed manifest of checkpoint ``step``.

    Raises :class:`CheckpointCorrupt` when the manifest is missing or
    partial (a crash mid-save on a filesystem without atomic rename, or a
    truncated copy): the checkpoint must be treated as torn.
    """
    path = os.path.join(_step_dir(ckpt_dir, step), MANIFEST)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except FileNotFoundError as e:
        raise CheckpointCorrupt(
            f"checkpoint step {step}: manifest missing ({path})") from e
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointCorrupt(
            f"checkpoint step {step}: manifest partial/unparseable "
            f"({path}: {e})") from e
    if not isinstance(manifest, dict) or "leaves" not in manifest:
        raise CheckpointCorrupt(
            f"checkpoint step {step}: manifest has no leaf table ({path})")
    return manifest


def _complete(ckpt_dir: str, step: int) -> bool:
    """True when the step directory holds a parseable manifest AND every
    leaf file it names (stat only, no hashing; full integrity is verified
    at restore)."""
    try:
        manifest = load_manifest(ckpt_dir, step)
    except CheckpointCorrupt:
        return False
    d = _step_dir(ckpt_dir, step)
    return all(os.path.exists(os.path.join(d, meta["file"]))
               for meta in manifest["leaves"].values())


def steps(ckpt_dir: str) -> list[int]:
    """All COMPLETE checkpoint steps under ``ckpt_dir``, ascending; skips
    ``.tmp`` staging directories and torn checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return []
    found = []
    for d in os.listdir(ckpt_dir):
        if not d.startswith("step_") or d.endswith(".tmp"):
            continue
        with contextlib.suppress(ValueError):
            found.append(int(d.split("_")[1]))
    return sorted(s for s in found if _complete(ckpt_dir, s))


def latest_step(ckpt_dir: str) -> int | None:
    """Newest complete checkpoint step, or None."""
    all_steps = steps(ckpt_dir)
    return all_steps[-1] if all_steps else None


def _from_raw(raw: np.ndarray, shape, like):
    """A leaf from its stored bytes, in ``like``'s kind: a tensor on its
    device (bfloat16 through torch, no ``ml_dtypes``), else numpy."""
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(raw)).view(like.dtype)
        return t.reshape(shape).to(like.device)
    return raw.view(np.asarray(like).dtype).reshape(shape)


def restore(ckpt_dir: str, step: int, like: Any, *,
            verify: bool = True) -> Any:
    """Restore into the structure of ``like``: each leaf as a tensor on
    its ``like`` tensor's device, or as a numpy array. Only the names,
    kinds and dtypes of ``like``'s leaves are read, so a zero-storage
    ``torch.empty(()).expand(shape)`` serves as a target.

    Integrity failures (SHA-256 mismatch, missing leaf file or manifest,
    a stored dtype other than the target's) raise
    :class:`CheckpointCorrupt`.
    """
    manifest = load_manifest(ckpt_dir, step)
    out = {name: restore_leaf(ckpt_dir, step, name, want, manifest=manifest,
                              verify=verify)
           for name, want in _leaf_paths(like)}
    return _unflatten(like, out)


def restore_leaf(ckpt_dir: str, step: int, name: str, like, *,
                 manifest: dict | None = None, verify: bool = True):
    """One leaf of a checkpoint by its name (its path joined by ``/``), in
    the kind of ``like`` as :func:`restore` gives it; ``manifest``: the
    step's, when the caller has read it. Raises :class:`CheckpointCorrupt`
    as :func:`restore` does."""
    d = _step_dir(ckpt_dir, step)
    if manifest is None:
        manifest = load_manifest(ckpt_dir, step)
    try:
        meta = manifest["leaves"][name]
    except KeyError as e:
        raise CheckpointCorrupt(
            f"checkpoint corruption in {name}: leaf missing from "
            f"manifest at step {step}") from e
    path = os.path.join(d, meta["file"])
    try:
        if verify:
            with open(path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
        raw = np.load(path)
    except (OSError, ValueError) as e:
        # ValueError: np.load on a corrupted/truncated .npy header.
        raise CheckpointCorrupt(
            f"checkpoint corruption in {name}: leaf file unreadable "
            f"({path}: {e})") from e
    if verify and digest != meta["sha256"]:
        raise CheckpointCorrupt(
            f"checkpoint corruption in {name}: "
            f"{digest} != {meta['sha256']}")
    if dtype_name(like) != meta["dtype"]:
        # A precision-policy index must come back in its stored
        # dtypes: reinterpreting or casting here would silently
        # change what the caller serves.
        raise CheckpointCorrupt(
            f"checkpoint dtype mismatch in {name}: stored "
            f"{meta['dtype']} but restore target expects "
            f"{dtype_name(like)}; rebuild the target with the "
            "checkpoint's dtypes (no silent cast)")
    return _from_raw(raw, meta["shape"], like)


def restore_extra(ckpt_dir: str, step: int) -> dict:
    return load_manifest(ckpt_dir, step).get("extra", {})
