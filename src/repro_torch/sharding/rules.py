"""Sharding rules: which mesh axes split each dim of every parameter,
optimizer moment, batch input, decode-cache leaf and the logits (the JAX
package's ``sharding/rules.py``).

The scheme:
  * DP   - the batch over ("pod", "data");
  * FSDP - parameter d_model-like dims over "data" (ZeRO-3: gathered on
           use, gradients reduced);
  * TP   - heads / ffn / vocab dims over "model";
  * EP   - the MoE expert dim over "model";
  * SP   - a long-context KV cache's sequence over "model" (and "data"
           when the batch cannot fill it).

Every leaf is resolved through an ordered candidate list; the first spec
whose every named dim divides evenly into the mesh is taken, ending in full
replication, so one table serves all ten architectures (28-head qwen2-vl
falls through head-sharding to d_model-sharding, a 2-KV-head cache falls
through to sequence sharding ...).

A spec is a plain tuple with one entry a dim: an axis name, a tuple of
axis names (the dim split over their product, the first axis major), or
None; ``()`` is full replication (JAX's ``P()``). The functions take any
mesh with ``.shape`` ({axis: size}) and ``.axis_names``: the port's
``launch.mesh.Mesh``, a plan of one, or a shape-only stand-in with JAX's
production ``pod`` axis.

The table is keyed on JAX's tree layout: leaf names, and the full array's
ndim with the stacked layer dim. :func:`param_specs` takes such a tree
(``models.convert.to_tree``; on the meta device it holds no memory);
:func:`model_specs` maps its specs onto the port's per-block
``named_parameters()`` by dropping the stack dim, as ``models/convert.py``
maps the leaves. :func:`block_slices` is the one place that says which
block of a whole leaf a rank holds at its mesh coordinates.
"""
from __future__ import annotations

import math
from typing import Any

from repro_torch.models.config import ModelConfig

Axis = str | tuple[str, ...] | None
Spec = tuple[Axis, ...]

# name -> list of (ndim, core spec) candidates, tried in order.
# Specs are written for the FULL array ndim (stacked L dim included).
_CAND: dict[str, list[tuple[int, Spec]]] = {
    "embed": [(2, ("model", "data")), (2, (None, "data")),
              (2, (None, None))],
    "lm_head": [(2, ("data", "model")), (2, (None, "model"))],
    # attention projections (stacked (L, d, h, hd) / shared (d, h, hd))
    "wq": [(4, (None, "data", "model", None)),
           (4, (None, "data", None, "model")),
           (4, (None, ("data", "model"), None, None)),
           (4, (None, "data", None, None)),
           (3, ("data", "model", None)), (3, ("data", None, "model")),
           (3, ("data", None, None))],
    "wo": [(3, (None, "model", "data")), (3, (None, None, "data")),
           (2, ("model", "data")), (2, (None, "data"))],
    # dense MLP (L, d, ff) / shared (d, ff); MoE (L, E, d, ff)
    "w_up": [(4, (None, "model", "data", None)),
             (4, (None, None, "data", "model")),
             (4, (None, None, "data", None)),
             (3, (None, "data", "model")), (3, (None, "data", None)),
             (2, ("data", "model")), (2, ("data", None))],
    "w_down": [(4, (None, "model", None, "data")),
               (4, (None, None, "model", "data")),
               (4, (None, None, None, "data")),
               (3, (None, "model", "data")), (3, (None, None, "data")),
               (2, ("model", "data")), (2, (None, "data"))],
    "router": [(3, (None, "data", None)), (2, ("data", None))],
    # SSM
    "in_proj": [(3, (None, "data", "model")), (3, (None, "data", None)),
                (2, ("data", None))],
    "out_proj": [(3, (None, "model", "data")), (3, (None, None, "data")),
                 (2, (None, "data"))],
}
_CAND["wk"] = _CAND["wq"]
_CAND["wv"] = _CAND["wq"]
_CAND["w_gate"] = _CAND["w_up"]
# Small leaves (norm scales, conv, per-head scalars): replicate.
_REPLICATED = {"scale", "norm", "conv_w", "conv_b", "a_log", "dt_bias",
               "d_skip"}

#: The modes of :func:`param_specs`.
MODES = ("tp", "fsdp", "ep")


def axes_of(ax: Axis) -> tuple[str, ...]:
    """A spec entry's axis names, major first (() for None)."""
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def _size(ax: Axis, mesh) -> int:
    return math.prod(mesh.shape[a] for a in axes_of(ax))


def _divides(shape: tuple[int, ...], spec: Spec, mesh) -> bool:
    if len(shape) != len(spec):
        raise ValueError(f"spec {spec} for a {len(shape)}-d shape {shape}")
    return all(dim % _size(ax, mesh) == 0 for dim, ax in zip(shape, spec))


def _fsdp_axis(spec: Spec) -> Spec:
    """Rewrite a TP/FSDP-hybrid candidate into pure ZeRO-3: drop TP dims,
    shard the FSDP dim over the flattened ("data", "model") axes."""
    out: list[Axis] = []
    for ax in spec:
        if ax == "data" or (isinstance(ax, tuple) and "data" in ax):
            out.append(("data", "model"))
        else:
            out.append(None)
    return tuple(out)


_MOE_LEAVES = {"w_up", "w_gate", "w_down"}


def _leaf_spec(name: str, shape: tuple[int, ...], mesh,
               mode: str = "tp") -> Spec:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    if name in _REPLICATED or name not in _CAND:
        return ()
    # mode "ep": FSDP for the dense stack, native EP for expert tensors
    # (4-D moe leaves keep their "model"-sharded expert dim).
    fsdp_this = (mode == "fsdp"
                 or (mode == "ep" and not (name in _MOE_LEAVES
                                           and len(shape) == 4)))
    for ndim, spec in _CAND[name]:
        if fsdp_this:
            spec = _fsdp_axis(spec)
        if ndim == len(shape) and _divides(shape, spec, mesh):
            return spec
    return ()


def _tree_map(fn, tree, name: str = ""):
    """``fn(name, leaf)`` over a tree of dicts and tuples, ``name`` the
    leaf's own key (JAX's last ``DictKey`` of the path); a dict stays a
    dict, a tuple a tuple and None (an empty subtree) None."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, str(k)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, v, name) for v in tree)
    if tree is None:
        return None
    return fn(name, tree)


def param_specs(params: Any, mesh, mode: str = "tp") -> Any:
    """The spec tree of a JAX-layout parameter tree (leaves with
    ``.shape``: tensors, meta tensors, numpy arrays).

    mode="tp"   - Megatron TP over "model" + FSDP over "data" (baseline);
    mode="fsdp" - pure ZeRO-3 over the flattened mesh; no TP;
    mode="ep"   - "fsdp" for the dense leaves, the 4-d expert leaves as
                  "tp" (the expert dim over "model").
    """
    return _tree_map(lambda name, leaf: _leaf_spec(
        name, tuple(leaf.shape), mesh, mode), params)


def model_specs(model, mesh, mode: str = "tp") -> dict[str, Spec]:
    """{parameter name: the spec of its per-block tensor} of the port's
    ``models.model.LM`` (on any device; the meta device holds nothing):
    :func:`param_specs` of its JAX-layout tree, the stacked layer dim
    dropped from the spec of each block leaf (the table never splits it)."""
    from repro_torch.models import convert
    shapes = {n: p.to("meta") for n, p in model.named_parameters()}
    specs = param_specs(convert.to_tree(model, shapes), mesh, mode)
    out = {}
    for name in shapes:
        path, layer = convert.layer_path(name, model.cfg)
        spec = specs
        for key in path:
            spec = spec[key]
        if layer is not None and spec:
            if spec[0] is not None:
                raise ValueError(f"{name}: spec {spec} splits the stacked "
                                 "layer dim")
            spec = spec[1:]
        out[name] = spec
    return out


def block_slices(shape: tuple[int, ...], spec: Spec, mesh,
                 coords: dict[str, int] | None = None) -> tuple[slice, ...]:
    """The block of a whole leaf of ``shape`` split by ``spec`` that the
    rank at ``coords`` ({axis: index}; default: this rank's,
    ``mesh.index``) holds: one slice a dim. A dim split over a tuple of
    axes is cut into their product of parts, the first axis major (JAX's
    device order: ("data", "model") is data-major)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    if not _divides(tuple(shape), spec, mesh):
        raise ValueError(f"spec {spec} does not split shape {tuple(shape)} "
                         f"on a {dict(mesh.shape)} mesh")
    out = []
    for dim, ax in zip(shape, spec):
        idx, parts = 0, 1
        for a in axes_of(ax):
            i = mesh.index(a) if coords is None else coords[a]
            idx, parts = idx * mesh.shape[a] + i, parts * mesh.shape[a]
        step = dim // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def spec_axes(spec: Spec) -> tuple[str, ...]:
    """Every axis that ``spec`` names, in order of appearance."""
    return tuple(a for ax in spec for a in axes_of(ax))


# ----------------------------------------------------------------------------
# Batch / cache specs
# ----------------------------------------------------------------------------

def _dp(mesh) -> Axis:
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if len(axes) > 1 else axes[0]


def _fits(dim: int, ax: Axis, mesh) -> bool:
    return dim % _size(ax, mesh) == 0


def batch_specs(batch: Any, mesh, mode: str = "tp") -> Any:
    """Specs of a train / prefill / decode input batch tree (leaves with
    ``.shape``).

    Leading dim = global batch, sharded over the DP axes when divisible
    (long_500k's batch of 1 falls back to replication); trailing dims
    replicated. In fsdp mode the batch spreads over the whole mesh. The
    fall-back drops axes from the right until the product divides.
    """
    dp = _dp(mesh)
    if mode == "fsdp":
        axes = tuple(a for a in ("pod", "data", "model")
                     if a in mesh.axis_names)
        dp = axes if len(axes) > 1 else axes[0]

    def spec_of(_, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        axes = axes_of(dp)
        while axes and shape[0] % _size(axes, mesh) != 0:
            axes = axes[:-1]
        first = (axes if len(axes) > 1 else axes[0]) if axes else None
        return (first,) + (None,) * (len(shape) - 1)

    return _tree_map(spec_of, batch)


def cache_specs(cache: Any, cfg: ModelConfig, mesh) -> Any:
    """Decode-cache specs.

    Attention KV leaves (L, B, S, KV, hd): batch over DP when divisible;
    KV heads over "model" when divisible, else SP: the sequence over
    "model" (and over the whole mesh when the batch cannot use DP, e.g.
    long_500k's B=1). SSM state leaves (L, B, H, P, N) / conv
    (L, B, kw-1, C): batch over DP, SSM heads over "model".
    """
    del cfg                      # the layout alone decides, as in JAX
    dp = _dp(mesh)
    msize = mesh.shape.get("model", 1)

    def spec_of(name, leaf):
        shape = tuple(leaf.shape)
        if name in ("k", "v"):
            lead = len(shape) - 4
            b, s, kv, _ = shape[-4:]
            b_ax = dp if _fits(b, dp, mesh) else None
            if kv % msize == 0:
                return (None,) * lead + (b_ax, None, "model", None)
            s_ax: Axis = "model"
            if b_ax is None and _fits(s, tuple(mesh.axis_names), mesh):
                s_ax = tuple(mesh.axis_names)   # SP over the whole mesh
            if not _fits(s, s_ax, mesh):
                s_ax = None
            return (None,) * lead + (b_ax, s_ax, None, None)
        if name == "state":
            lead = len(shape) - 4
            b, h = shape[-4], shape[-3]
            b_ax = dp if _fits(b, dp, mesh) else None
            h_ax = "model" if h % msize == 0 else None
            return (None,) * lead + (b_ax, h_ax, None, None)
        if name == "conv":
            lead = len(shape) - 3
            b_ax = dp if _fits(shape[-3], dp, mesh) else None
            return (None,) * lead + (b_ax, None, None)
        return ()

    return _tree_map(spec_of, cache)


def logits_spec(mesh, batch: int, vocab: int) -> Spec:
    dp = _dp(mesh)
    b_ax = dp if _fits(batch, dp, mesh) else None
    v_ax = "model" if vocab % mesh.shape.get("model", 1) == 0 else None
    return (b_ax, None, v_ax)


# ----------------------------------------------------------------------------
# The mesh prefill and decode steps' plan
# ----------------------------------------------------------------------------

def _specs_named(tree: Any, name: str, key: str = "") -> list[Spec]:
    """The specs of every leaf called ``name`` in a spec tree (dicts, and
    tuples of dicts as the hybrid's prefill caches; a spec is a tuple of
    axis entries)."""
    if isinstance(tree, dict):
        return [s for k, v in tree.items()
                for s in _specs_named(v, name, str(k))]
    if isinstance(tree, tuple) and any(isinstance(v, dict) for v in tree):
        return [s for v in tree for s in _specs_named(v, name, key)]
    return [tree] if key == name and tree is not None else []


def _entry(spec: Spec, dim: int) -> Axis:
    """``spec``'s entry for ``dim`` (negative from the end), None past its
    length (a replicated leaf's spec is ())."""
    return spec[dim] if -len(spec) <= dim < len(spec) else None


def _modules(specs: dict[str, Spec], leaf: str) -> list[str]:
    return sorted(n.rpartition(".")[0] for n in specs
                  if n.rpartition(".")[2] == leaf)


def serve_plan(specs: dict[str, Spec], cache: Any) -> dict[str, Any]:
    """What each module of the mesh prefill or decode step computes, from
    the specs alone: ``specs`` the per-block parameter specs of mode "tp"
    (:func:`model_specs`), ``cache`` :func:`cache_specs` of the step's
    cache (the decode cache, or prefill's compact caches). Returns
    {module name: mode}:

    * attention (``...attn``): "heads" - Megatron TP on the rank's heads,
      where ``wq``, ``wk`` and ``wv`` split their heads and ``wo`` its
      input over ``model`` and the cache its KV heads; ("seq", axes) -
      sequence parallel, the cache's sequence split over ``axes``, the
      weights whole; or "whole";
    * a dense MLP (``...mlp``): "tp" where ``w_up`` / ``w_gate`` split ff
      and ``w_down`` its input over ``model``, else "whole";
    * an SSM (``...ssm``): "heads" where the state's heads split over
      ``model`` (its projections whole), else "whole";
    * "embed" (the lookup) and "head" (the logits): "vocab" where the
      table splits the vocabulary over ``model``, else "whole".

    A MoE's experts are not planned here: they take the train step's path
    (expert parallel under ``cfg.moe_shard_map``, else gathered whole). A
    cache that splits its KV heads over ``model`` while the projections
    keep theirs whole is no layout of the rules, and raises."""
    plan: dict[str, Any] = {}
    kv = _specs_named(cache, "k")
    state = _specs_named(cache, "state")
    for mod in _modules(specs, "wq"):
        if not kv:
            raise ValueError(f"{mod}: the cache holds no attention K / V")
        k = kv[0]
        heads = (all(_entry(specs[f"{mod}.{w}"], -2) == "model"
                     for w in ("wq", "wk", "wv"))
                 and _entry(specs[f"{mod}.wo"], 0) == "model")
        if _entry(k, -2) == "model":
            if not heads:
                raise ValueError(f"{mod}: the cache splits its KV heads over "
                                 "'model', the projections do not split "
                                 "theirs")
            plan[mod] = "heads"
        elif _entry(k, -3) is not None:
            plan[mod] = ("seq", axes_of(_entry(k, -3)))
        else:
            plan[mod] = "whole"
    for mod in _modules(specs, "w_down"):
        if f"{mod}.router" in specs:
            continue                                    # a MoE
        cols = [f"{mod}.{w}" for w in ("w_up", "w_gate")
                if f"{mod}.{w}" in specs]
        tp = (all(_entry(specs[c], -1) == "model" for c in cols)
              and _entry(specs[f"{mod}.w_down"], 0) == "model")
        plan[mod] = "tp" if tp else "whole"
    for mod in _modules(specs, "in_proj"):
        split = bool(state) and _entry(state[0], -3) == "model"
        plan[mod] = "heads" if split else "whole"
    plan["embed"] = ("vocab" if _entry(specs["embed"], 0) == "model"
                     else "whole")
    head = (_entry(specs["lm_head"], -1) if "lm_head" in specs
            else _entry(specs["embed"], 0))
    plan["head"] = "vocab" if head == "model" else "whole"
    return plan


#: The leaves each mode of :func:`serve_plan` computes as the rank's block.
_PLANNED_LEAVES = {"heads": ("wq", "wk", "wv", "wo"),
                   "tp": ("w_up", "w_gate", "w_down")}


def block_leaves(plan: dict[str, Any], specs: dict[str, Spec]) -> set[str]:
    """The parameters that ``plan`` computes as the rank's TP block: each
    is gathered over ``data`` alone, never over ``model``."""
    out = set()
    for mod, mode in plan.items():
        if isinstance(mode, str):            # an SSM's "heads" has none
            out.update(n for n in (f"{mod}.{leaf}" for leaf in
                                   _PLANNED_LEAVES.get(mode, ()))
                       if n in specs)
    if plan["embed"] == "vocab":
        out.add("embed")
    if plan["head"] == "vocab" and "lm_head" in specs:
        out.add("lm_head")
    return out


def without_model(spec: Spec) -> Spec:
    """``spec`` with its ``model`` entries dropped: a TP block gathered
    over the other axes only."""
    if any(isinstance(ax, tuple) and "model" in ax for ax in spec):
        raise ValueError(f"spec {spec} splits one dim over 'model' and "
                         "another axis: not a TP block")
    return tuple(None if ax == "model" else ax for ax in spec)
