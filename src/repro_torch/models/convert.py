"""Carry a JAX parameter tree across to the port's model, and back; and
the trees that share its layout: gradients and the AdamW state.

The JAX package's ``models.model.init`` returns nested dicts whose block
leaves are stacked on a leading layer axis. ``params_from_numpy`` takes
that tree with each leaf as a numpy array (``np.asarray`` of the JAX leaf;
bfloat16 as numpy's ``bfloat16`` dtype) and returns the port's ``LM``
holding exactly those values, the layer axis split over
``model.blocks`` (for the hybrid, into groups of ``hybrid_attn_every``).
``params_to_numpy`` is its inverse. Both name the path of a missing or
extra leaf, or of a wrong shape or dtype, in a ``ValueError``.

The port keeps a gradient or a moment as a dict keyed by the model's
parameter names (``model.named_parameters()``). ``to_tree`` stacks such a
dict into JAX's layout (torch tensors, parameter-free norms as empty
dicts) and ``from_tree`` splits it back; ``grads_to_numpy``,
``opt_state_to_numpy`` and ``opt_state_from_numpy`` do the same for the
gradients and for ``optim.adamw``'s state ``{"m", "v", "step"}`` as numpy
trees, leaf for leaf those of ``jax.value_and_grad`` and JAX's
``adamw.init`` / ``update``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

Path = tuple[str, ...]


def layer_path(name: str, cfg: ModelConfig) -> tuple[Path, int | None]:
    """A state-dict name -> (its JAX path, its layer on the stacked
    leading axis, or None for a leaf that is not stacked)."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return tuple(parts), None
    if cfg.family == "hybrid":
        layer = int(parts[1]) * cfg.hybrid_attn_every + int(parts[2])
        return ("blocks", *parts[3:]), layer
    return ("blocks", *parts[2:]), int(parts[1])


def layout(model: M.LM) -> dict:
    """JAX path -> (per-layer shape, dtype, [(state-dict name, layer)]),
    the layers in order (layer None for a leaf that is not stacked)."""
    out: dict[Path, tuple] = {}
    for name, p in model.state_dict(keep_vars=True).items():
        path, layer = layer_path(name, model.cfg)
        entry = out.setdefault(path, (tuple(p.shape), p.dtype, []))
        entry[2].append((name, layer))
    return out


def _empty_norms(model: M.LM) -> list[Path]:
    """JAX paths of the parameter-free norms (empty dicts in the tree)."""
    paths = []
    for name, mod in model.named_modules():
        if isinstance(mod, L.Norm) and mod.scale is None:
            path, _ = layer_path(name, model.cfg)
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


def _from_leaves(tree: dict, model: M.LM, device, dtype=None,
                 what: str = "parameter") -> dict:
    """A JAX-layout tree of numpy arrays -> tensors on ``device`` keyed by
    the model's parameter names (a stacked leaf's layers are views of one
    tensor). Each leaf must have the model's shape and ``dtype`` (default:
    the parameter's own)."""
    paths = layout(model)
    leaves = _flatten(tree)
    missing = sorted(set(paths) - set(leaves))
    extra = sorted(set(leaves) - set(paths))
    if missing or extra:
        raise ValueError(f"{what} tree for {model.cfg.name}: missing leaves "
                         f"{['/'.join(p) for p in missing]}, extra leaves "
                         f"{['/'.join(p) for p in extra]}")
    device = M.resolve_device(device)
    out = {}
    for path, (shape, p_dtype, names) in paths.items():
        a = np.asarray(leaves[path])
        stacked = names[0][1] is not None
        want = (len(names), *shape) if stacked else shape
        if tuple(a.shape) != want:
            raise ValueError(f"leaf {'/'.join(path)}: shape {a.shape}, the "
                             f"model wants {want}")
        want_dtype = _dtype_name(p_dtype if dtype is None else dtype)
        if a.dtype.name != want_dtype:
            raise ValueError(f"leaf {'/'.join(path)}: dtype {a.dtype.name}, "
                             f"the model wants {want_dtype}")
        t = _to_tensor(a).to(device)
        for name, layer in names:
            out[name] = t[layer] if stacked else t
    return out


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> M.LM:
    """The port's model holding the JAX tree's values, on ``device``."""
    model = M.init(cfg, device="meta")
    model.load_state_dict(_from_leaves(tree, model, device), assign=True)
    return model


def to_tree(model: M.LM, tensors: dict) -> dict:
    """``tensors`` keyed by the model's parameter names (its parameters,
    their gradients or moments) -> JAX's tree layout: nested dicts of
    tensors, block leaves stacked on a leading layer axis, each
    parameter-free norm an empty dict."""
    tree: dict = {}

    def put(path: Path, value):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    for path in _empty_norms(model):
        put(path, {})
    for path, (_, _, names) in layout(model).items():
        ts = [tensors[name] for name, _ in names]     # in layer order
        put(path, torch.stack(ts) if names[0][1] is not None else ts[0])
    return tree


def from_tree(model: M.LM, tree: dict) -> dict:
    """``to_tree``'s inverse: a JAX-layout tree of tensors -> tensors keyed
    by the model's parameter names (a stacked leaf's layers are views)."""
    leaves = _flatten(tree)
    out = {}
    for path, (_, _, names) in layout(model).items():
        t = leaves[path]
        for name, layer in names:
            out[name] = t[layer] if layer is not None else t
    return out


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else _to_numpy(v)
            for k, v in tree.items()}


def params_to_numpy(model: M.LM) -> dict:
    """The JAX package's parameter tree of ``model``: nested dicts of numpy
    arrays, block leaves stacked on a leading layer axis."""
    return _numpy_tree(to_tree(model, model.state_dict(keep_vars=True)))


def grads_to_numpy(model: M.LM, grads: dict) -> dict:
    """Gradients keyed by parameter name -> the numpy tree of
    ``jax.value_and_grad`` over the JAX parameters."""
    return _numpy_tree(to_tree(model, grads))


def opt_state_to_numpy(model: M.LM, state: dict) -> dict:
    """``optim.adamw``'s state of ``model`` -> JAX's ``{"m", "v", "step"}``
    tree of numpy arrays (``step`` a 0-d int32)."""
    return {"m": grads_to_numpy(model, state["m"]),
            "v": grads_to_numpy(model, state["v"]),
            "step": _to_numpy(state["step"])}


def opt_state_from_numpy(tree: dict, model: M.LM, device="cuda") -> dict:
    """JAX's AdamW state (numpy leaves) -> ``optim.adamw``'s state of
    ``model`` on ``device``; the moments keep their stored dtype (the
    config's ``opt_state_dtype``), which must be one dtype for all."""
    dtypes = {np.asarray(a).dtype.name
              for a in _flatten({"m": tree["m"], "v": tree["v"]}).values()}
    if len(dtypes) != 1:
        raise ValueError(f"moments of several dtypes {sorted(dtypes)}")
    dtype = getattr(torch, dtypes.pop())
    step = np.asarray(tree["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"step: {step.dtype} {step.shape}, want a 0-d "
                         "int32")
    return {"m": _from_leaves(tree["m"], model, device, dtype, "m"),
            "v": _from_leaves(tree["v"], model, device, dtype, "v"),
            "step": _to_tensor(step).to(M.resolve_device(device))}
