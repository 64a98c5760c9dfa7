"""Train / prefill / decode steps and the EMD search steps, built from the
config (the JAX package's ``launch/steps.py``, on one device).

A step here runs eagerly on the model's device: the port's parameters are
the ``models.model.LM`` (its ``named_parameters()`` are the leaves that
JAX's tree stacks, ``models/convert.py``), and a train step updates them
and the AdamW state in place. The abstract stand-ins are tensors on the
meta device, which hold shapes and dtypes and no memory.

JAX's ``jit_train_step``, ``jit_prefill_step`` and ``jit_decode_step`` wrap
these steps with the parameter, batch and cache shardings of a mesh; they
wait for the port's LM mesh slice (``sharding/rules.py``, ROADMAP Queue 1
item 8). The EMD search steps run on a mesh already: pass ``mesh=`` to
``make_emd_search_step`` / ``make_emd_cascade_step`` (the port's
counterparts of ``jit_emd_search_step`` / ``jit_emd_cascade_step``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.optim import adamw
from repro_torch.optim.grad_utils import accumulate_grads

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
