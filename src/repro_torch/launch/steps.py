"""Train / prefill / decode steps and the EMD search steps, built from the
config (the JAX package's ``launch/steps.py``, on one device).

A step here runs eagerly on the model's device: the port's parameters are
the ``models.model.LM`` (its ``named_parameters()`` are the leaves that
JAX's tree stacks, ``models/convert.py``), and a train step updates them
and the AdamW state in place. The abstract stand-ins are tensors on the
meta device, which hold shapes and dtypes and no memory.

:func:`make_mesh_train_step` is the counterpart of JAX's
``jit_train_step``: the same step on a ``torch.distributed`` (data, model)
mesh (``launch/mesh.py``), acting on a :class:`MeshTrainState`, in which
each rank holds only the blocks of the parameters and AdamW moments that
``sharding.rules.param_specs`` gives its coordinates.
:func:`make_mesh_prefill_step` and :func:`make_mesh_decode_step` are the
counterparts of JAX's ``jit_prefill_step`` and ``jit_decode_step``: on a
:class:`MeshServeState` (the rank's blocks in mode "tp"), Megatron TP over
the rules' heads, ``d_ff`` and vocabulary (``rules.serve_plan``), the
decode cache held in ``rules.cache_specs``' blocks (KV heads, or the
sequence under SP), the logits in ``rules.logits_spec``'s blocks. The EMD
search steps run on a mesh:
pass ``mesh=`` to ``make_emd_search_step`` / ``make_emd_cascade_step``
(the port's counterparts of ``jit_emd_search_step`` /
``jit_emd_cascade_step``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.nn.utils import parametrize

from repro_torch.checkpoint import store
from repro_torch.launch.mesh import AXES
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.optim import adamw
from repro_torch.optim.grad_utils import accumulate_grads
from repro_torch.sharding import annotate, rules

#: KV-cache capacity padding: seq_len + 512 keeps the sequence dim divisible
#: by every mesh-axis product the JAX package shards it over (16, 256, 512).
CACHE_PAD = 512


def microbatches_for(cfg: ModelConfig, shape: InputShape) -> int:
    """Gradient-accumulation factor: keeps activation memory bounded for
    the widest architectures."""
    tokens = shape.seq_len * shape.global_batch
    if cfg.d_model >= 16_384:
        return 8                      # nemotron-4-340b
    if cfg.d_model >= 5_000 or tokens > 2 ** 21:
        return 4
    return 1


# ----------------------------------------------------------------------------
# Abstract inputs (meta tensors: shapes and dtypes, no memory)
# ----------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Meta tensors of every model input of this cell: int32 tokens and
    labels, bfloat16 frontend embeddings, an int32 0-d cache index."""
    B, S = shape.global_batch, shape.seq_len

    def tok(*s):
        return _meta(s, torch.int32)

    def emb(*s):
        return _meta(s, torch.bfloat16)

    def inputs(seq):
        if cfg.frontend != "none":
            return {"embeddings": emb(B, seq, cfg.d_model)}
        return {"tokens": tok(B, seq)}
    if shape.kind == "train":
        return {"labels": tok(B, S), **inputs(S)}
    if shape.kind == "prefill":
        return inputs(S)
    # decode: one new token against a cache of S past tokens
    return {"cache_index": tok(), **inputs(1)}


def abstract_params(cfg: ModelConfig) -> M.LM:
    """The model on the meta device."""
    return M.init(cfg, device="meta")


def abstract_opt_state(cfg: ModelConfig) -> dict:
    """The AdamW state of :func:`abstract_params`, on the meta device."""
    params = dict(abstract_params(cfg).named_parameters())
    return adamw.init(params, cfg.opt_state_dtype)


def abstract_cache(cfg: ModelConfig, shape: InputShape) -> dict:
    cap = shape.seq_len + CACHE_PAD
    return M.init_decode_cache(cfg, shape.global_batch, cap - 1,
                               dtype=torch.bfloat16, device="meta")


# ----------------------------------------------------------------------------
# Steps
# ----------------------------------------------------------------------------

def make_train_step(shape: InputShape,
                    opt_cfg: adamw.AdamWConfig | None = None,
                    n_micro: int | None = None):
    """Returns train_step(model, opt_state, batch) -> (model, opt_state,
    metrics {"loss", "grad_norm", "lr"}): ``train_loss``'s gradients over
    ``n_micro`` microbatches (default ``microbatches_for`` of the model's
    config and ``shape``), one AdamW update written into the model's
    parameters in place, the new state. The config is the model's own
    (``model.cfg``): JAX's step takes it as an argument because its
    parameters are a bare tree."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def train_step(model: M.LM, opt_state: dict, batch: dict):
        micro = microbatches_for(model.cfg, shape) if n_micro is None \
            else n_micro
        params = dict(model.named_parameters())
        loss, grads = accumulate_grads(
            lambda b: M.train_loss(model, b), params, batch, micro)
        with torch.no_grad():
            detached = {k: p.detach() for k, p in params.items()}
            new, opt_state, metrics = adamw.update(grads, opt_state,
                                                   detached, opt_cfg)
            del grads
            for k, p in params.items():
                p.copy_(new[k])
        metrics["loss"] = loss
        return model, opt_state, metrics

    return train_step


@dataclasses.dataclass
class TrainState:
    """A model and its AdamW state, as ``runtime.fault.FaultTolerantRunner``
    checkpoints them: ``tree()`` is the JAX package's training state
    ``{"params": params, "opt": {"m", "v", "step"}}``, block leaves stacked
    (copies), and ``load_tree`` writes such a tree back into the model's
    parameters and the moments, in place. ``metrics``: the last step's."""
    model: M.LM
    opt: dict
    metrics: dict = dataclasses.field(default_factory=dict)

    @torch.no_grad()
    def tree(self) -> dict:
        m = self.model
        return {"params": convert.to_tree(m, dict(m.named_parameters())),
                "opt": {"m": convert.to_tree(m, self.opt["m"]),
                        "v": convert.to_tree(m, self.opt["v"]),
                        "step": self.opt["step"]}}

    def load_tree(self, tree: dict) -> "TrainState":
        m = self.model
        with torch.no_grad():
            for name, t in convert.from_tree(m, tree["params"]).items():
                m.get_parameter(name).copy_(t)
            for key in ("m", "v"):
                for name, t in convert.from_tree(m, tree["opt"][key]).items():
                    self.opt[key][name].copy_(t)
            self.opt["step"] = tree["opt"]["step"].clone()
        return self


def runner_step(train_step):
    """``make_train_step``'s step as the runner's (TrainState, batch) ->
    TrainState function."""
    def step(state: TrainState, batch: dict) -> TrainState:
        _, state.opt, state.metrics = train_step(state.model, state.opt,
                                                 batch)
        return state
    return step


# ----------------------------------------------------------------------------
# The train step on a (data, model) mesh (JAX's jit_train_step)
# ----------------------------------------------------------------------------

#: Labels of the mesh step's scalar all-reduces in ``annotate.TRAFFIC``:
#: the loss mask's count and the loss, and the gradients' squared norm.
LOSS_SUMS, NORM_SUM = "loss_sums", "grad_norm"

#: The expert leaves that the expert-parallel path computes locally.
_EXPERT_LEAVES = ("w_up", "w_gate", "w_down")


class _GatherOnUse(nn.Module):
    """The parametrization of one parameter of a mesh state: reading the
    parameter gathers the rank's block into the whole leaf
    (``annotate.fsdp_gather``, over the axes of ``spec``); backward sums
    its gradient over ``batch_axes``, which the step sets from the
    batch."""

    def __init__(self, mesh, spec):
        super().__init__()
        self.mesh, self.spec, self.batch_axes = mesh, spec, ()
        self.loaded = spec          # ``spec`` as loaded; a serve plan may
                                    # narrow it to a TP block's

    def forward(self, block):
        return annotate.fsdp_gather(block, self.mesh, self.spec,
                                    self.batch_axes)


def _zeros_like(blocks: dict, dtype) -> dict:
    return {k: torch.zeros(b.shape, dtype=dtype, device=b.device)
            for k, b in blocks.items()}


def _load_blocks(cfg: ModelConfig, mesh, mode: str, blocks: dict):
    """``cfg``'s model with each parameter this rank's block of it (from
    ``blocks``, {parameter name: block} on ``mesh.device``), read through
    a gather on use over the axes of its spec (:class:`_GatherOnUse`).
    The expert leaves of a MoE layer are computed where they lie (the
    expert-parallel path, gathered over ``data`` only) under
    ``cfg.moe_shard_map`` or mode "ep" on a mesh whose ``model`` axis has
    more than one rank. Returns (the model, its layout on the meta device,
    the specs, {name: the block parameter})."""
    layout = M.init(cfg, device="meta")
    specs = rules.model_specs(layout, mesh, mode)
    ep = (cfg.is_moe and (cfg.moe_shard_map or mode == "ep")
          and mesh.size("model") > 1)
    if ep and mode == "fsdp":
        raise ValueError("the expert-parallel MoE needs the batch "
                         "replicated over 'model': mode 'tp' or 'ep', "
                         "not 'fsdp'")
    if set(blocks) != set(specs):
        raise ValueError(f"blocks {sorted(set(blocks) ^ set(specs))} "
                         "differ from the model's parameters")
    model = M.init(cfg, device="meta")
    for name, block in blocks.items():
        whole = layout.get_parameter(name).shape
        want = tuple(s.stop - s.start for s in rules.block_slices(
            whole, specs[name], mesh))
        if tuple(block.shape) != want:
            raise ValueError(f"{name}: block {tuple(block.shape)}, the "
                             f"rules give {want} on this rank")
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        setattr(mod, leaf, nn.Parameter(block))
        spec = specs[name]
        if ep and isinstance(mod, L.MoE) and leaf in _EXPERT_LEAVES:
            if spec[:1] != ("model",):
                raise ValueError(f"{name}: spec {spec} does not split "
                                 "the expert rows over 'model'")
            mod.ep_mesh = mesh
            spec = (None,) + spec[1:]
        parametrize.register_parametrization(
            mod, leaf, _GatherOnUse(mesh, spec), unsafe=True)
    params = {name: model.get_submodule(name.rpartition(".")[0])
              .parametrizations[name.rpartition(".")[2]].original
              for name in specs}
    return model, layout, specs, params


def _cut_blocks(model: M.LM, mesh, mode: str) -> dict:
    """This rank's blocks of a whole ``model`` by the rules in ``mode``,
    copied to ``mesh.device``."""
    specs = rules.model_specs(model, mesh, mode)
    return {n: p.detach()[rules.block_slices(p.shape, specs[n], mesh)]
            .to(mesh.device, copy=True).contiguous()
            for n, p in model.named_parameters()}


@dataclasses.dataclass(eq=False)
class MeshTrainState:
    """One rank's part of a model and its AdamW state on a mesh, laid out
    by ``sharding.rules`` in ``mode`` ("tp", "fsdp" or "ep").

    ``model``: an ``LM`` whose every parameter is this rank's block of it
    (``blocks``, keyed by the single-device model's parameter names), read
    through a gather on use: the forward and backward of ``train_loss``
    run on it as on one device. ``opt``: the moments' blocks and the step
    counter. ``layout``: the model on the meta device (names, shapes, JAX's
    tree layout); ``specs``: each parameter's per-block spec.

    The expert leaves of a MoE layer are computed where they lie (the
    expert-parallel path, ``layers.moe_apply_shard_map``) under
    ``cfg.moe_shard_map`` or mode "ep" on a mesh whose ``model`` axis has
    more than one rank: they are gathered over ``data`` only. That needs
    the batch replicated over ``model``, so mode "fsdp" refuses it.

    ``save`` / ``restore`` checkpoint the state in the JAX package's
    layout, so ``runtime.fault.FaultTolerantRunner`` runs a mesh step: the
    leader (data 0, model 0) writes the gathered whole leaves, every rank
    reads back its own blocks (``runtime.elastic.restore_on_mesh``)."""
    model: M.LM
    layout: M.LM
    mesh: object
    mode: str
    specs: dict
    blocks: dict
    opt: dict
    metrics: dict = dataclasses.field(default_factory=dict)

    @property
    def cfg(self) -> ModelConfig:
        return self.layout.cfg

    @property
    def is_leader(self) -> bool:
        return all(self.mesh.index(a) == 0 for a in AXES)

    @classmethod
    def from_blocks(cls, cfg: ModelConfig, mesh, mode: str, blocks: dict,
                    opt: dict | None = None) -> "MeshTrainState":
        """A state of ``cfg``'s model from this rank's ``blocks``
        ({parameter name: block}, on ``mesh.device``) and, optionally, the
        moments' blocks and step (default: zeros in the config's
        ``opt_state_dtype``, step 0)."""
        model, layout, specs, params = _load_blocks(cfg, mesh, mode, blocks)
        if opt is None:
            dt = getattr(torch, cfg.opt_state_dtype)
            opt = {"m": _zeros_like(params, dt), "v": _zeros_like(params, dt),
                   "step": torch.zeros((), dtype=torch.int32,
                                       device=mesh.device)}
        return cls(model=model, layout=layout, mesh=mesh, mode=mode,
                   specs=specs, blocks=params, opt=opt)

    @classmethod
    def from_model(cls, model: M.LM, mesh,
                   mode: str = "tp") -> "MeshTrainState":
        """This rank's blocks of a whole ``model``, copied to
        ``mesh.device``; zero moments, step 0."""
        return cls.from_blocks(model.cfg, mesh, mode,
                               _cut_blocks(model, mesh, mode))

    @classmethod
    def init(cls, cfg: ModelConfig, mesh, mode: str = "tp",
             seed: int = 0) -> "MeshTrainState":
        """``models.model.init(cfg, seed=seed)`` on ``mesh.device``, cut to
        this rank's blocks (the whole model is freed)."""
        return cls.from_model(M.init(cfg, seed=seed, device=mesh.device),
                              mesh, mode)

    def set_batch_axes(self, axes: tuple[str, ...]) -> None:
        """The axes whose ranks hold different batch rows: the gathers'
        backward sums the gradients over them."""
        for mod in self.model.modules():
            if isinstance(mod, _GatherOnUse):
                mod.batch_axes = tuple(axes)

    @torch.no_grad()
    def tree(self) -> dict | None:
        """The training state in the JAX package's layout (``TrainState``'s
        tree), whole leaves on the CPU, on the leader; None on every other
        rank. A collective: every rank of the mesh calls it."""
        def whole(blocks):
            return {n: annotate.gather_to_leader(b, self.mesh, self.specs[n])
                    for n, b in blocks.items()}
        params, m, v = (whole(t) for t in (self.blocks, self.opt["m"],
                                           self.opt["v"]))
        if not self.is_leader:
            return None
        return {"params": convert.to_tree(self.layout, params),
                "opt": {"m": convert.to_tree(self.layout, m),
                        "v": convert.to_tree(self.layout, v),
                        "step": self.opt["step"].cpu()}}

    def save(self, ckpt_dir: str, step: int, extra: dict | None = None):
        """Write ``tree()`` as checkpoint ``step`` from the leader; every
        rank returns once it is written (a collective)."""
        tree = self.tree()
        if tree is not None:
            store.save(ckpt_dir, step, tree, extra=extra)
        done = torch.zeros(1, device=self.mesh.device)
        for axis in AXES:
            annotate.all_reduce_sum(done, self.mesh, axis,
                                    annotate.CKPT_GATHER)

    @torch.no_grad()
    def restore(self, ckpt_dir: str, step: int) -> "MeshTrainState":
        """Load checkpoint ``step`` (a ``TrainState`` tree, written from
        any mesh or one device) into this state's blocks, in place."""
        from repro_torch.runtime import elastic
        params, m, v, counter = elastic.read_state_blocks(
            ckpt_dir, step, self.layout, self.specs, self.mesh)
        for name, p in self.blocks.items():
            p.copy_(params[name])
            self.opt["m"][name].copy_(m[name])
            self.opt["v"][name].copy_(v[name])
        self.opt["step"] = counter
        return self


def batch_axes(batch: dict, mesh, mode: str = "tp") -> tuple[str, ...]:
    """The mesh axes that split the rows of ``batch`` (a dict of arrays
    with one leading batch dim): ``rules.batch_specs``' first dim."""
    specs = rules.batch_specs(batch, mesh, mode)
    firsts = {rules.axes_of(spec[0]) for spec in specs.values() if spec}
    if len(firsts) != 1:
        raise ValueError(f"batch leaves split over {firsts}: one leading "
                         "batch dim for all")
    return firsts.pop()


def rank_rows(batch: dict, mesh, axes: tuple[str, ...],
              n_micro: int) -> dict:
    """This rank's rows of each of ``n_micro`` microbatches of the global
    ``batch``, concatenated: microbatch i is the global rows' i-th
    contiguous chunk (JAX's ``accumulate_grads``), split over ``axes``,
    so ``accumulate_grads`` over the result takes the rank's part of
    chunk i as its microbatch i. On ``mesh.device``."""
    spec = ((axes if len(axes) > 1 else axes[0]) if axes else None,)
    out = {}
    for key, v in batch.items():
        v = torch.as_tensor(v)
        if v.shape[0] % n_micro:
            raise ValueError(f"batch[{key!r}] has {v.shape[0]} rows, not a "
                             f"multiple of n_micro={n_micro}")
        chunks = v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
        sl, = rules.block_slices((chunks.shape[1],), spec, mesh)
        out[key] = chunks[:, sl].reshape(-1, *v.shape[1:]).to(mesh.device)
    return out


def _mesh_global_norm(grads: dict, state: MeshTrainState) -> torch.Tensor:
    """``adamw.global_norm`` of the whole gradient tree from this rank's
    blocks: each block's sum of squares counted on one rank of those that
    hold it (the ranks at index 0 of every axis its spec does not name),
    summed over the mesh."""
    mesh, sums = state.mesh, []
    for name in sorted(grads):
        named = rules.spec_axes(state.specs[name])
        if all(mesh.index(a) == 0 for a in AXES if a not in named):
            sums.append(torch.sum(torch.square(grads[name].float())))
        else:
            sums.append(torch.zeros((), device=grads[name].device))
    total = torch.sum(torch.stack(sums))
    for axis in AXES:
        total = annotate.all_reduce_sum(total, mesh, axis, NORM_SUM)
    return torch.sqrt(total)


def _sum_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    for axis in axes:
        x = annotate.all_reduce_sum(x, mesh, axis, LOSS_SUMS)
    return x


def make_mesh_train_step(shape: InputShape, mesh, *, mode: str = "tp",
                         opt_cfg: adamw.AdamWConfig | None = None,
                         n_micro: int | None = None):
    """JAX's ``jit_train_step`` on ``mesh``: returns step(state, batch) ->
    state, for a :class:`MeshTrainState` of this mesh and ``mode``, with
    ``state.metrics`` {"loss", "grad_norm", "lr"} the same on every rank.

    ``batch`` is the global batch, the same on every rank (the token
    pipeline makes it from the step number); the step keeps this rank's
    rows of each microbatch (:func:`rank_rows`, the axes of
    ``rules.batch_specs``). Each rank's loss is its rows' part of the
    single-device loss: its masked sum over the whole microbatch's mask
    count (summed over the batch axes, or the token count), and the MoE
    aux loss over the number of batch shards; the gathers' backward sums
    the gradients over the batch axes. The global norm counts every
    element once; AdamW then updates the rank's blocks in place, the step
    counter alike on every rank."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def step(state: MeshTrainState, batch: dict) -> MeshTrainState:
        if state.mesh is not mesh or state.mode != mode:
            raise ValueError(f"a {state.mode!r} state of {state.mesh!r} "
                             f"for a {mode!r} step of {mesh!r}")
        micro = microbatches_for(state.cfg, shape) if n_micro is None \
            else n_micro
        axes = batch_axes(batch, mesh, mode)
        shards = math.prod(mesh.size(a) for a in axes)
        state.set_batch_axes(axes)

        def loss_fn(b):
            nll_sum, count, aux = M.loss_terms(state.model, b)
            if isinstance(count, torch.Tensor):
                count = torch.clamp_min(
                    _sum_over(count.detach(), mesh, axes), 1.0)
            else:
                count = count * shards
            return nll_sum / count + 0.01 * (aux / shards)
        loss, grads = accumulate_grads(
            loss_fn, state.blocks, rank_rows(batch, mesh, axes, micro),
            micro)
        with torch.no_grad():
            loss = _sum_over(loss, mesh, axes)
            norm = _mesh_global_norm(grads, state)
            detached = {k: p.detach() for k, p in state.blocks.items()}
            new, state.opt, metrics = adamw.update(grads, state.opt,
                                                   detached, opt_cfg, norm)
            del grads
            for k, p in state.blocks.items():
                p.copy_(new[k])
        metrics["loss"] = loss
        state.metrics = metrics
        return state

    return step


# ----------------------------------------------------------------------------
# Prefill and decode on a (data, model) mesh (JAX's jit_prefill_step /
# jit_decode_step)
# ----------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class MeshServeState:
    """One rank's part of a model for the mesh prefill and decode steps:
    its blocks of the parameters by ``sharding.rules`` in mode "tp" (the
    layout of JAX's ``jit_prefill_step``), no optimizer.

    ``model``: an ``LM`` whose every parameter is this rank's block
    (``blocks``), read through a gather on use as in
    :class:`MeshTrainState` (the shared loader; the expert-parallel MoE
    alike). A step lays its plan (``rules.serve_plan``) on the state
    before it runs (:meth:`apply_plan`): the modules it plans as Megatron
    TP compute on their blocks, which are then gathered over ``data``
    only; every other leaf is gathered whole."""
    model: M.LM
    layout: M.LM
    mesh: object
    specs: dict
    blocks: dict
    plan: dict | None = None

    #: The sharding rules' mode of a serve state.
    MODE = "tp"

    @property
    def cfg(self) -> ModelConfig:
        return self.layout.cfg

    @classmethod
    def from_blocks(cls, cfg: ModelConfig, mesh,
                    blocks: dict) -> "MeshServeState":
        """A state of ``cfg``'s model from this rank's ``blocks``
        ({parameter name: block}, on ``mesh.device``)."""
        model, layout, specs, params = _load_blocks(cfg, mesh, cls.MODE,
                                                    blocks)
        return cls(model=model, layout=layout, mesh=mesh, specs=specs,
                   blocks=params)

    @classmethod
    def from_model(cls, model: M.LM, mesh) -> "MeshServeState":
        """This rank's blocks of a whole ``model`` (for example one that
        ``models.convert`` carried across from JAX), copied to
        ``mesh.device``."""
        return cls.from_blocks(model.cfg, mesh,
                               _cut_blocks(model, mesh, cls.MODE))

    @classmethod
    def init(cls, cfg: ModelConfig, mesh, seed: int = 0) -> "MeshServeState":
        """``models.model.init(cfg, seed=seed)`` on ``mesh.device``, cut to
        this rank's blocks (the whole model is freed)."""
        return cls.from_model(M.init(cfg, seed=seed, device=mesh.device),
                              mesh)

    def apply_plan(self, plan: dict) -> None:
        """Hand each module its part of ``plan`` (``rules.serve_plan`` of
        this state's specs) and narrow the gathers of the leaves it
        computes as TP blocks to ``data``."""
        if plan == self.plan:
            return
        mesh, model = self.mesh, self.model
        tp = rules.block_leaves(plan, self.specs)
        for name in self.specs:
            mod_name, _, leaf = name.rpartition(".")
            gather = model.get_submodule(mod_name).parametrizations[leaf][0]
            gather.spec = (rules.without_model(gather.loaded) if name in tp
                           else gather.loaded)
        model.vocab_mesh = mesh if plan["embed"] == "vocab" else None
        for mod_name, mode in plan.items():
            if mod_name in ("embed", "head"):
                continue
            mod = model.get_submodule(mod_name)
            if isinstance(mod, L.Attention):
                mod.tp_mesh = mesh if mode == "heads" else None
                mod.sp = (mesh, mode[1]) if isinstance(mode, tuple) else None
            elif isinstance(mod, L.MLP):
                mod.tp_mesh = mesh if mode == "tp" else None
            else:
                mod.head_mesh = mesh if mode == "heads" else None
        self.plan = plan


def abstract_prefill_cache(cfg: ModelConfig, shape: InputShape):
    """Meta tensors of ``models.model.prefill``'s compact caches for a
    prompt of ``shape``: the attention stack's {"k", "v"} (L, B, S, KV,
    hd) in the parameters' dtype; the SSM stack's {"state", "conv"} in
    float32; the hybrid's (SSM caches, K / V)."""
    cache = M.init_decode_cache(cfg, shape.global_batch, shape.seq_len - 1,
                                dtype=L.param_dtype(cfg), device="meta")
    if cfg.family == "ssm":
        return cache["ssm"]
    if cfg.family == "hybrid":
        return cache["ssm"], cache["attn"]
    return cache["attn"]


def _zip_map(fn, tree, *others):
    """``fn(leaf, *other leaves)`` over trees of one layout (dicts and
    tuples)."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_zip_map(fn, *leaves) for leaves in zip(tree, *others))
    return fn(tree, *others)


def _block_shape(leaf, spec, mesh) -> tuple[int, ...]:
    return tuple(s.stop - s.start
                 for s in rules.block_slices(tuple(leaf.shape), spec, mesh))


def cache_blocks(cache, cfg: ModelConfig, mesh):
    """This rank's blocks of a whole cache (a decode cache, or prefill's
    compact caches; any device), cut by ``rules.cache_specs`` and copied
    to ``mesh.device``."""
    specs = rules.cache_specs(cache, cfg, mesh)
    return _zip_map(lambda t, spec: t[rules.block_slices(
        tuple(t.shape), spec, mesh)].to(mesh.device, copy=True)
        .contiguous(), cache, specs)


def init_mesh_decode_cache(cfg: ModelConfig, shape: InputShape, mesh,
                           dtype=torch.bfloat16) -> dict:
    """This rank's blocks of an empty decode cache for ``shape`` (JAX's
    ``abstract_cache``: ``seq_len + CACHE_PAD`` slots, K / V in ``dtype``,
    the SSM's state and conv window in float32), on ``mesh.device``."""
    whole = M.init_decode_cache(cfg, shape.global_batch,
                                shape.seq_len + CACHE_PAD - 1, dtype=dtype,
                                device="meta")
    specs = rules.cache_specs(whole, cfg, mesh)
    return _zip_map(lambda t, spec: torch.zeros(
        _block_shape(t, spec, mesh), dtype=t.dtype, device=mesh.device),
        whole, specs)


def handoff_prefill(prefill_caches, cache: dict, cfg: ModelConfig, mesh,
                    prompt: InputShape, decode: InputShape) -> dict:
    """Write the mesh prefill step's compact caches (this rank's blocks,
    for a prompt of ``prompt``'s shape) into this rank's blocks of a
    decode cache of ``decode``'s shape (:func:`init_mesh_decode_cache`),
    in place: K / V at slots 0 .. S-1, the SSM's state and conv window as
    they are. Where the prompt's cache splits the sequence (SP), its K / V
    are gathered along it first (``annotate.cache_handoff``); each rank
    keeps the slots of its decode block. Returns ``cache``."""
    whole = {"prefill": abstract_prefill_cache(cfg, prompt),
             "decode": M.init_decode_cache(
                 cfg, decode.global_batch, decode.seq_len + CACHE_PAD - 1,
                 device="meta")}
    specs = {k: rules.cache_specs(v, cfg, mesh) for k, v in whole.items()}

    def split(tree):
        if cfg.family == "ssm":
            return tree, None
        return tree if cfg.family == "hybrid" else (None, tree)
    blocks, p_specs = split(prefill_caches), split(specs["prefill"])
    into = (cache.get("ssm"), cache.get("attn"))
    d_specs = (specs["decode"].get("ssm"), specs["decode"].get("attn"))
    with torch.no_grad():
        for part, p_spec, dst, d_spec in zip(blocks, p_specs, into, d_specs):
            for name, block in (part or {}).items():
                if name in ("k", "v"):
                    _handoff_kv(block, dst[name], p_spec[name],
                                d_spec[name], mesh)
                else:
                    dst[name].copy_(block)
    return cache


def _handoff_kv(block: torch.Tensor, dst: torch.Tensor, p_spec, d_spec,
                mesh) -> None:
    """One K or V leaf of :func:`handoff_prefill`: the prompt's (lead...,
    B, S, KV, hd) block, split by ``p_spec``, into the decode cache's
    block, split by ``d_spec``."""
    seq = block.dim() - 3
    if p_spec[:seq] + p_spec[seq + 1:] != d_spec[:seq] + d_spec[seq + 1:]:
        raise ValueError(f"the prompt's cache {p_spec} and the decode "
                         f"cache {d_spec} differ in more than the sequence")
    prompt = annotate.cache_handoff(block, mesh, rules.axes_of(p_spec[seq]),
                                    seq)
    total = dst.shape[seq] * math.prod(
        mesh.size(a) for a in rules.axes_of(d_spec[seq]))
    if prompt.shape[seq] > total:
        raise ValueError(f"a prompt of {prompt.shape[seq]} tokens into a "
                         f"cache of {total} slots")
    mine, = rules.block_slices((total,), (d_spec[seq],), mesh)
    lo, hi = mine.start, min(mine.stop, prompt.shape[seq])
    if hi > lo:
        dst.narrow(seq, 0, hi - lo).copy_(prompt.narrow(seq, lo, hi - lo))


def _rank_batch(batch: dict, mesh, shape: InputShape, seq: int) -> dict:
    """This rank's rows of the global ``batch`` (``rules.batch_specs``)
    on ``mesh.device``, after checking its shape against the step's:
    ``shape.global_batch`` rows of ``seq`` tokens."""
    rows = {k: v for k, v in batch.items() if k != "cache_index"}
    for key, v in rows.items():
        if tuple(v.shape[:2]) != (shape.global_batch, seq):
            raise ValueError(f"batch[{key!r}] is {tuple(v.shape)}; the step "
                             f"takes {shape.global_batch} rows of {seq}")
    out = rank_rows(rows, mesh, batch_axes(rows, mesh), 1)
    if "cache_index" in batch:
        out["cache_index"] = batch["cache_index"]
    return out


def _check_state(state, mesh) -> None:
    if not isinstance(state, MeshServeState) or state.mesh is not mesh:
        raise ValueError(f"a MeshServeState of {mesh!r}, got "
                         f"{type(state).__name__}")


def _serve_layout(cfg: ModelConfig, shape: InputShape, mesh, params_abs,
                  cache_abs):
    """A mesh serving step's layout: (its plan, ``rules.serve_plan`` of
    the parameters' and ``cache_abs``'s specs; the cache's block shapes on
    this rank; ``rules.logits_spec``)."""
    specs = rules.model_specs(params_abs, mesh, MeshServeState.MODE)
    c_spec = rules.cache_specs(cache_abs, cfg, mesh)
    want = _zip_map(lambda t, s: _block_shape(t, s, mesh), cache_abs, c_spec)
    return (rules.serve_plan(specs, c_spec), want,
            rules.logits_spec(mesh, shape.global_batch, cfg.vocab))


def make_mesh_prefill_step(cfg: ModelConfig, shape: InputShape, mesh):
    """JAX's ``jit_prefill_step`` on ``mesh``: returns (step,
    (abstract_params, input_specs)), step(state, batch) -> (this rank's
    block of the last-token logits by ``rules.logits_spec``, this rank's
    blocks of the compact caches by ``rules.cache_specs``).

    ``state`` is a :class:`MeshServeState` of ``mesh``; ``batch`` the
    global batch of ``shape`` (the same on every rank), of which the step
    keeps the rank's rows (``rules.batch_specs``). Attention computes on
    the rank's heads where the plan (``rules.serve_plan``) says "heads";
    under SP it computes with whole weights and keeps the rank's block of
    the sequence; the logits stay in blocks."""
    params_abs, batch_abs = abstract_params(cfg), input_specs(cfg, shape)
    plan, want, l_spec = _serve_layout(cfg, shape, mesh, params_abs,
                                       abstract_prefill_cache(cfg, shape))

    def step(state: MeshServeState, batch: dict):
        _check_state(state, mesh)
        state.apply_plan(plan)
        logits, caches = M.prefill(state.model, _rank_batch(
            batch, mesh, shape, shape.seq_len))
        got = _zip_map(lambda t: tuple(t.shape), caches)
        if got != want:
            raise RuntimeError(f"prefill's caches {got}, the rules give "
                               f"{want} on this rank")
        return _vocab_block(logits, l_spec, mesh, cfg), caches

    return step, (params_abs, batch_abs)


def make_mesh_decode_step(cfg: ModelConfig, shape: InputShape, mesh):
    """JAX's ``jit_decode_step`` on ``mesh``: returns (step,
    (abstract_params, input_specs, abstract_cache)), step(state, batch,
    cache) -> (this rank's block of the logits (B, 1, vocab) by
    ``rules.logits_spec``, ``cache``). ``cache`` is this rank's blocks of
    the decode cache (:func:`init_mesh_decode_cache`, filled by
    :func:`handoff_prefill` or earlier steps), written in place; ``batch``
    the global {"tokens" (B, 1) or "embeddings", "cache_index"}.

    Attention on "heads" writes the new K / V into the rank's heads of
    the cache; under SP only the rank whose block holds slot
    ``cache_index`` writes it, and the ranks combine their partial
    softmaxes (``sp_combine``). The SSM updates the rank's heads of the
    state."""
    params_abs, batch_abs = abstract_params(cfg), input_specs(cfg, shape)
    cache_abs = abstract_cache(cfg, shape)
    plan, want, l_spec = _serve_layout(cfg, shape, mesh, params_abs,
                                       cache_abs)

    def step(state: MeshServeState, batch: dict, cache: dict):
        _check_state(state, mesh)
        got = _zip_map(lambda t: tuple(t.shape), cache)
        if got != want:
            raise ValueError(f"cache blocks {got}, the rules give {want} "
                             "on this rank")
        state.apply_plan(plan)
        logits, cache = M.decode_step(state.model, _rank_batch(
            batch, mesh, shape, 1), cache)
        return _vocab_block(logits, l_spec, mesh, cfg), cache

    return step, (params_abs, batch_abs, cache_abs)


def _vocab_block(logits: torch.Tensor, spec, mesh,
                 cfg: ModelConfig) -> torch.Tensor:
    """The logits' block of ``rules.logits_spec`` (their rows are already
    the rank's): a head whose vocabulary is whole is cut to the block."""
    if logits.shape[-1] != cfg.vocab:
        return logits                      # the head's own vocab block
    sl, = rules.block_slices((cfg.vocab,), (spec[2],), mesh)
    return logits[..., sl]


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(model: M.LM, batch: dict):
        return M.prefill(model, batch)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(model: M.LM, batch: dict, cache: dict):
        return M.decode_step(model, batch, cache)
    return decode_step


# ----------------------------------------------------------------------------
# EMD search steps (the paper's retrieval workload), delegated to
# ``launch/search.py`` so that callers consume ONE steps surface for every
# cell type, model or EMD. ``EMDWorkload.method`` picks the
# ``retrieval.METHODS`` entry.
# ----------------------------------------------------------------------------

def workload_method(workload) -> str:
    """The registry method a workload scores with (``"act"`` when it
    declares none)."""
    return getattr(workload, "method", "act") or "act"


def make_emd_search_step(workload, top_l: int = 16, **score_kw):
    """The method-generic search step of ``workload``
    (``launch/search.make_search_step``; ``mesh=`` runs it on a mesh)."""
    from repro_torch.launch import search as Sx
    return Sx.make_search_step(workload.iters, top_l,
                               method=workload_method(workload), **score_kw)


def emd_search_input_specs(workload, pad_multiple: int | None = None):
    """Meta tensors of one search step's five operands, the corpus rows
    padded to a multiple of ``pad_multiple`` (default
    ``launch/search.DEFAULT_ROW_PAD_MULTIPLE``)."""
    from repro_torch.launch import search as Sx
    pad = Sx.DEFAULT_ROW_PAD_MULTIPLE if pad_multiple is None \
        else pad_multiple
    n, w = Sx.padded_rows(workload.n_db, pad), workload
    return (_meta((n, w.hmax), torch.int32),
            _meta((n, w.hmax), torch.float32),
            _meta((w.vocab, w.dim), torch.float32),
            _meta((w.queries, w.hmax), torch.int32),
            _meta((w.queries, w.hmax), torch.float32))


def make_emd_cascade_step(workload, spec, top_l: int = 16, **score_kw):
    """The cascaded prune-and-rescore step of ``workload``
    (``launch/search.make_cascade_search_step``; ``spec`` a
    ``CascadeSpec`` or preset name; ``mesh=`` runs it on a mesh)."""
    from repro_torch.launch import search as Sx
    return Sx.make_cascade_search_step(spec, top_l, workload.n_db,
                                       **score_kw)
