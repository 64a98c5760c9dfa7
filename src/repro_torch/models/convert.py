"""Carry a JAX parameter tree across to the port's model, and back.

The JAX package's ``models.model.init`` returns nested dicts whose block
leaves are stacked on a leading layer axis. ``params_from_numpy`` takes
that tree with each leaf as a numpy array (``np.asarray`` of the JAX leaf;
bfloat16 as numpy's ``bfloat16`` dtype) and returns the port's ``LM``
holding exactly those values, the layer axis split over
``model.blocks`` (for the hybrid, into groups of ``hybrid_attn_every``).
``params_to_numpy`` is its inverse. Both name the path of a missing or
extra leaf, or of a wrong shape or dtype, in a ``ValueError``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

Path = tuple[str, ...]


def _layer_path(name: str, cfg: ModelConfig) -> tuple[Path, int | None]:
    """A state-dict name -> (its JAX path, its layer or None)."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return tuple(parts), None
    if cfg.family == "hybrid":
        layer = int(parts[1]) * cfg.hybrid_attn_every + int(parts[2])
        return ("blocks", *parts[3:]), layer
    return ("blocks", *parts[2:]), int(parts[1])


def _layout(model: M.LM):
    """JAX path -> (per-layer shape, dtype, [(state-dict name, layer)])."""
    out: dict[Path, tuple] = {}
    for name, p in model.state_dict(keep_vars=True).items():
        path, layer = _layer_path(name, model.cfg)
        entry = out.setdefault(path, (tuple(p.shape), p.dtype, []))
        entry[2].append((name, layer))
    return out


def _empty_norms(model: M.LM) -> list[Path]:
    """JAX paths of the parameter-free norms (empty dicts in the tree)."""
    paths = []
    for name, mod in model.named_modules():
        if isinstance(mod, L.Norm) and mod.scale is None:
            path, _ = _layer_path(name, model.cfg)
            if path not in paths:
                paths.append(path)
    return paths


def _flatten(tree, prefix: Path = ()) -> dict[Path, object]:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = value
    return out


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        try:
            bf16 = np.dtype("bfloat16")
        except TypeError:
            raise ValueError("a bfloat16 leaf needs numpy's bfloat16 dtype "
                             "(registered by ml_dtypes)") from None
        return t.view(torch.int16).numpy().view(bf16)
    return t.numpy()


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> M.LM:
    """The port's model holding the JAX tree's values, on ``device``."""
    model = M.init(cfg, device="meta")
    layout = _layout(model)
    leaves = _flatten(tree)
    missing = sorted(set(layout) - set(leaves))
    extra = sorted(set(leaves) - set(layout))
    if missing or extra:
        raise ValueError(f"parameter tree for {cfg.name}: missing leaves "
                         f"{['/'.join(p) for p in missing]}, extra leaves "
                         f"{['/'.join(p) for p in extra]}")
    device = M.resolve_device(device)
    state = {}
    for path, (shape, dtype, names) in layout.items():
        a = np.asarray(leaves[path])
        stacked = names[0][1] is not None
        want = (len(names), *shape) if stacked else shape
        if tuple(a.shape) != want:
            raise ValueError(f"leaf {'/'.join(path)}: shape {a.shape}, the "
                             f"model wants {want}")
        if a.dtype.name != _dtype_name(dtype):
            raise ValueError(f"leaf {'/'.join(path)}: dtype {a.dtype.name}, "
                             f"the model wants {_dtype_name(dtype)}")
        t = _to_tensor(a).to(device)
        for name, layer in names:
            state[name] = t[layer] if stacked else t
    model.load_state_dict(state, assign=True)
    return model


def params_to_numpy(model: M.LM) -> dict:
    """The JAX package's parameter tree of ``model``: nested dicts of numpy
    arrays, block leaves stacked on a leading layer axis."""
    tree: dict = {}

    def put(path: Path, value):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    for path in _empty_norms(model):
        put(path, {})
    params = model.state_dict(keep_vars=True)
    for path, (_, _, names) in _layout(model).items():
        ts = [params[name] for name, _ in names]      # in layer order
        put(path, _to_numpy(torch.stack(ts) if names[0][1] is not None
                            else ts[0]))
    return tree
