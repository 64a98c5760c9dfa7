"""Decoder LM assembly: per-family block wiring, the training loss and the
serving entry points (the JAX package's ``models/model.py``).

The layers are an ``nn.ModuleList`` in place of JAX's stacked ``lax.scan``;
gemma3's local:global pattern rides along as a per-layer window
(``window_schedule``), and the zamba2 hybrid's blocks are a ``ModuleList``
of groups of ``hybrid_attn_every`` SSM blocks with ONE weight-tied shared
attention block applied at the end of each group. Caches keep JAX's
layouts leaf for leaf: stacked on a leading layer axis (group and period
axes for the hybrid).

Entry points (``forward``, ``prefill`` and ``decode_step`` run under
``torch.inference_mode``; ``train_loss`` runs under autograd, each block
or hybrid group under ``torch.utils.checkpoint`` where ``cfg.remat``):
  init(cfg, seed=, device=)                -> model
  train_loss(model, batch)                 -> scalar float32 loss
  loss_terms(model, batch)                 -> (nll sum, its count, aux)
  forward(model, batch, collect_cache=, last_token_logits=)
                                           -> (logits, aux, caches)
  prefill(model, batch)                    -> (last-token logits, caches)
  init_decode_cache(cfg, batch, seq_len, dtype, device=) -> cache
  decode_step(model, batch, cache)         -> (logits, cache)

They place everything on ``"cuda"`` unless the caller asks for another
device, and raise where no CUDA device is available. Under float32 the
card's matmuls must not use TF32: the model leaves torch's global settings
as it finds them (their defaults are full float32 for matmuls), and its
one convolution is elementwise (``ssm._conv_full``).
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import annotate


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the model runs on 'cuda' by default and no CUDA "
                           "device is available; pass device='cpu' to run "
                           "on the CPU")
    return device


# ----------------------------------------------------------------------------
# Modules and init
# ----------------------------------------------------------------------------

class AttnBlock(nn.Module):
    """One transformer block: norm, attention, norm, MLP or MoE."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        self.ln1 = L.Norm(cfg, device)
        self.ln2 = L.Norm(cfg, device)
        self.attn = L.Attention(cfg, generator, device)
        if cfg.is_moe:
            self.moe = L.MoE(cfg, generator, device)
        else:
            self.mlp = L.MLP(cfg, generator, device)


class SSMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        self.ln = L.Norm(cfg, device)
        self.ssm = S.SSM(cfg, generator, device)


class SharedAttn(nn.Module):
    """zamba2's one weight-tied attention + MLP block (the config's d_ff
    belongs here)."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        self.ln = L.Norm(cfg, device)
        self.attn = L.Attention(cfg, generator, device)
        self.ln2 = L.Norm(cfg, device)
        self.mlp = L.MLP(cfg, generator, device)


class LM(nn.Module):
    """The decoder. Its parameters carry the JAX tree's leaf names:
    ``embed``, ``final_ln``, ``lm_head`` (untied heads), ``blocks`` (one
    module a layer; for the hybrid one ``ModuleList`` a group) and
    ``shared_attn`` (hybrid).

    The same modules serve one device and a (data, model) mesh: the mesh
    prefill and decode steps (``launch.steps``) hand each module its part
    (``Attention.tp_mesh`` / ``.sp``, ``MLP.tp_mesh``, ``SSM.head_mesh``,
    ``MoE.ep_mesh``, ``LM.vocab_mesh``) and its parameters are the rank's
    blocks; a module with no mesh computes as on one device."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        self.cfg = cfg
        # The mesh whose ``model`` ranks split ``embed``'s vocabulary rows
        # for the lookup (``layers.vocab_lookup``), set by the mesh
        # prefill and decode steps; None on one device.
        self.vocab_mesh = None
        dt = L.param_dtype(cfg)
        self.embed = nn.Parameter((L.normal((cfg.vocab, cfg.d_model),
                                            generator, device)
                                   * cfg.d_model ** -0.5).to(dt))
        self.final_ln = L.Norm(cfg, device)
        if not cfg.tie_embeddings:
            self.lm_head = L.dense_init(generator, cfg.d_model, (cfg.vocab,),
                                        dt, device)
        if cfg.family == "hybrid":
            every = cfg.hybrid_attn_every
            n_groups = cfg.n_layers // every
            if n_groups * every != cfg.n_layers:
                raise ValueError(f"{cfg.n_layers} layers do not split into "
                                 f"groups of {every}")
            self.blocks = nn.ModuleList(
                nn.ModuleList(SSMBlock(cfg, generator, device)
                              for _ in range(every))
                for _ in range(n_groups))
            self.shared_attn = SharedAttn(cfg, generator, device)
        else:
            block = SSMBlock if cfg.family == "ssm" else AttnBlock
            self.blocks = nn.ModuleList(block(cfg, generator, device)
                                        for _ in range(cfg.n_layers))


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> LM:
    """A model with random weights drawn from the JAX package's
    distributions (not its bits: compare with JAX through
    ``convert.params_from_numpy``) by a ``torch.Generator`` on ``device``
    seeded with ``seed``. On the meta device the model has shapes only and
    takes no memory."""
    device = resolve_device(device)
    generator = (None if device.type == "meta"
                 else torch.Generator(device=device).manual_seed(seed))
    return LM(cfg, generator, device)


def window_schedule(cfg: ModelConfig) -> torch.Tensor:
    """Per-layer sliding-window sizes, int32 (0 = global full attention)."""
    if cfg.local_global_ratio > 0:
        period = cfg.local_global_ratio + 1
        idx = torch.arange(cfg.n_layers)
        is_global = (idx % period) == cfg.local_global_ratio
        return torch.where(is_global, 0, cfg.sliding_window).to(torch.int32)
    return torch.full((cfg.n_layers,), cfg.sliding_window, dtype=torch.int32)


# ----------------------------------------------------------------------------
# Forward (train / prefill): the three stacks
# ----------------------------------------------------------------------------

def _attn_block(bp: AttnBlock, x, positions, window: int, *,
                cfg: ModelConfig, collect_kv: bool):
    h = bp.ln1(x)
    a, kv = L.attention_apply(bp.attn, h, cfg, positions=positions,
                              window=window, return_kv=collect_kv)
    x = x + a
    h = bp.ln2(x)
    if cfg.is_moe:
        y, aux = L.moe_apply(bp.moe, h, cfg)
    else:
        y = L.mlp_apply(bp.mlp, h, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux, kv


def _remat(body, cfg: ModelConfig):
    """``body`` (one block, or one hybrid group) recomputed in backward
    where ``cfg.remat``: ``remat_policy="full"`` saves only its inputs;
    ``"dots"`` also saves the outputs of its matmuls without batch dims
    (``aten.mm`` / ``addmm``: every projection), as JAX's
    ``dots_with_no_batch_dims_saveable`` does, and the expert-parallel
    MoE's summed output (``annotate.MOE_OUT_OP``, JAX's name
    ``moe_out``), so that its all-reduce over ``model`` does not run again
    in the recomputation; it recomputes the rest. Outside autograd (the
    serving entry points) the body runs as it is."""
    if not cfg.remat:
        return body
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat_policy != "full":
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: 'full' or "
                         "'dots'")

    def run(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        return ckpt.checkpoint(body, *args, use_reentrant=False, **kw)
    return run


#: The operators whose outputs ``remat_policy="dots"`` saves: the matmuls
#: without batch dims and the expert-parallel MoE's output.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         annotate.MOE_OUT_OP)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _stack(trees: list):
    """Per-layer cache dicts -> one dict stacked on a leading axis (None
    where the layers collected nothing)."""
    if trees[0] is None:
        return None
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def _run_attn_stack(model: LM, x, cfg: ModelConfig, positions,
                    collect_kv: bool):
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs = []
    block = _remat(functools.partial(_attn_block, cfg=cfg,
                                     collect_kv=collect_kv), cfg)
    for bp, window in zip(model.blocks, window_schedule(cfg).tolist()):
        x, aux, kv = block(bp, x, positions, window)
        aux_sum = aux_sum + aux
        kvs.append(kv)
    return x, aux_sum, _stack(kvs)


def _ssm_block(bp: SSMBlock, x, cfg: ModelConfig):
    y, cache = S.ssm_apply(bp.ssm, bp.ln(x), cfg)
    return x + y, cache


def _run_ssm_stack(model: LM, x, cfg: ModelConfig):
    caches = []
    block = _remat(functools.partial(_ssm_block, cfg=cfg), cfg)
    for bp in model.blocks:
        x, cache = block(bp, x)
        caches.append(cache)
    return x, _stack(caches)


def _shared_attn(shared: SharedAttn, x, cfg: ModelConfig, positions, **kw):
    h = shared.ln(x)
    a, kv = L.attention_apply(shared.attn, h, cfg, positions=positions,
                              window=0, **kw)
    x = x + a
    return x + L.mlp_apply(shared.mlp, shared.ln2(x), cfg), kv


def _run_hybrid_stack(model: LM, x, cfg: ModelConfig, positions,
                      collect_kv: bool):
    """zamba2: groups of ``hybrid_attn_every`` SSM blocks, the weight-tied
    shared attention block at the end of each group. Caches:
    ({"state", "conv"} stacked (groups, every, ...), {"k", "v"} stacked
    (groups, ...) or None)."""
    def group_body(group, x):
        caches = []
        for bp in group:
            x, cache = _ssm_block(bp, x, cfg)
            caches.append(cache)
        x, kv = _shared_attn(model.shared_attn, x, cfg, positions,
                             return_kv=collect_kv)
        return x, _stack(caches), kv

    body = _remat(group_body, cfg)
    ssm_caches, kvs = [], []
    for group in model.blocks:
        x, caches, kv = body(group, x)
        ssm_caches.append(caches)
        kvs.append(kv)
    return x, (_stack(ssm_caches), _stack(kvs))


def _embed_inputs(model: LM, batch: dict, cfg: ModelConfig):
    """Token ids -> embeddings, or pass through stub frontend embeddings."""
    dev = next(model.parameters()).device
    if cfg.frontend != "none":
        return torch.as_tensor(batch["embeddings"], device=dev).to(
            L.param_dtype(cfg))
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    if model.vocab_mesh is not None:
        return L.vocab_lookup(model.embed, tokens, model.vocab_mesh)
    return model.embed[tokens]


def _logits(model: LM, x, cfg: ModelConfig):
    x = model.final_ln(x)
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    return L.proj(x, head)


def _forward(model: LM, batch: dict, collect_cache: bool = False,
             last_token_logits: bool = False):
    """``forward``'s body, under whatever grad mode the caller runs:
    ``train_loss`` runs it under autograd."""
    cfg = model.cfg
    x = _embed_inputs(model, batch, cfg)
    B, seq = x.shape[0], x.shape[1]
    positions = torch.arange(seq, dtype=torch.int32,
                             device=x.device).expand(B, seq)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        x, caches = _run_ssm_stack(model, x, cfg)
    elif cfg.family == "hybrid":
        x, caches = _run_hybrid_stack(model, x, cfg, positions, collect_cache)
    else:
        x, aux, caches = _run_attn_stack(model, x, cfg, positions,
                                         collect_cache)
    if last_token_logits:
        x = x[:, -1:, :]
    return _logits(model, x, cfg), aux, caches


@torch.inference_mode()
def forward(model: LM, batch: dict, collect_cache: bool = False,
            last_token_logits: bool = False):
    """Full-sequence forward. Returns (logits, aux_loss, caches).

    batch: {"tokens": (B, S)} or, for the stub audio/vision frontends,
    {"embeddings": (B, S, d)}; positions are 0 .. S-1.
    ``last_token_logits``: the LM head only for the final position.
    caches: the attention stack's {"k", "v"} (L, B, S, KV, hd) when
    ``collect_cache`` (else None); the SSM stack's {"state", "conv"}
    always; the hybrid's (ssm caches, kv or None).
    """
    return _forward(model, batch, collect_cache, last_token_logits)


def train_loss(model: LM, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy (+ 0.01 x the MoE router's aux loss), a
    float32 scalar under autograd.

    batch: the inputs of ``forward``, ``"labels"`` (B, S) and optionally
    ``"loss_mask"`` (B, S), which weights each position's loss and divides
    by max(its sum, 1) in place of B x S. As the JAX package computes it:
    float32 logits shifted by their max (a constant to autograd), the log
    of the summed exponentials, less the gold logit (picked by a gather:
    JAX's iota compare selects the same element; it keeps a sharded
    vocabulary local on a mesh, and the port gathers the vocabulary)."""
    nll_sum, count, aux = loss_terms(model, batch)
    if isinstance(count, torch.Tensor):
        count = torch.clamp_min(count, 1.0)
    return nll_sum / count + 0.01 * aux


def loss_terms(model: LM, batch: dict):
    """``train_loss``'s parts: (the masked sum of the per-token losses,
    what it is divided by before the clamp to >= 1: the mask's float32 sum
    or, with no mask, the token count as an int, the aux loss summed over
    the layers of the mean over the batch rows). The mesh step adds them
    up over the ranks that hold other rows."""
    logits, aux, _ = _forward(model, batch)
    dev = logits.device
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    logits_f = logits.float()
    lmax = logits_f.amax(dim=-1, keepdim=True).detach()
    shifted = logits_f - lmax
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    gold = torch.gather(shifted, -1, labels[..., None])[..., 0]
    nll = lse - gold
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev).float()
        nll = nll * mask
        count = torch.sum(mask)
    else:
        count = nll.numel()
    return torch.sum(nll), count, aux


@torch.inference_mode()
def prefill(model: LM, batch: dict):
    """Returns (last-token logits, caches): the COMPACT length-S caches of
    ``forward(..., collect_cache=True)``, as the JAX package's prefill
    does, not a decode cache."""
    logits, _, caches = forward(model, batch, collect_cache=True,
                                last_token_logits=True)
    return logits, caches


def init_decode_cache(cfg: ModelConfig, batch: int, seq_len: int,
                      dtype=torch.bfloat16, device="cuda") -> dict:
    """Empty decode cache sized for ``seq_len`` past tokens (+1 new): KV in
    ``dtype``, SSM state and conv window in float32."""
    device = resolve_device(device)
    hd, KV = cfg.head_dim, cfg.n_kv_heads
    size = seq_len + 1

    def kv(*lead):
        return {name: torch.zeros((*lead, batch, size, KV, hd), dtype=dtype,
                                  device=device) for name in ("k", "v")}

    def ssm(*lead):
        return {name: t.expand(*lead, *t.shape).contiguous()
                for name, t in S.ssm_decode_init(cfg, batch,
                                                 device=device).items()}
    if cfg.family == "ssm":
        return {"ssm": ssm(cfg.n_layers)}
    if cfg.family == "hybrid":
        n_groups = cfg.n_layers // cfg.hybrid_attn_every
        return {"ssm": ssm(n_groups, cfg.hybrid_attn_every),
                "attn": kv(n_groups)}
    return {"attn": kv(cfg.n_layers)}


def _at(cache: dict, *idx) -> dict:
    """One layer's views of a stacked cache (writes go to the stack)."""
    return {name: t[idx] for name, t in cache.items()}


@torch.inference_mode()
def decode_step(model: LM, batch: dict, cache: dict):
    """One-token decode. batch: {"tokens": (B, 1)} (or "embeddings"
    (B, 1, d)) and {"cache_index": int — the number of tokens already in
    the cache}. Writes the new token's KV and SSM state into ``cache`` IN
    PLACE and returns (logits (B, 1, vocab), cache): copy the cache first
    to decode twice from one state."""
    cfg = model.cfg
    x = _embed_inputs(model, batch, cfg)
    idx = int(batch["cache_index"])
    B = x.shape[0]
    positions = torch.full((B, 1), idx, dtype=torch.int32, device=x.device)

    if cfg.family == "ssm":
        for layer, bp in enumerate(model.blocks):
            y, _ = S.ssm_decode_step(bp.ssm, bp.ln(x),
                                     _at(cache["ssm"], layer), cfg)
            x = x + y
    elif cfg.family == "hybrid":
        for g, group in enumerate(model.blocks):
            for i, bp in enumerate(group):
                y, _ = S.ssm_decode_step(bp.ssm, bp.ln(x),
                                         _at(cache["ssm"], g, i), cfg)
                x = x + y
            x, _ = _shared_attn(model.shared_attn, x, cfg, positions,
                                cache=_at(cache["attn"], g), cache_index=idx)
    else:
        for layer, (bp, window) in enumerate(
                zip(model.blocks, window_schedule(cfg).tolist())):
            a, _ = L.attention_apply(bp.attn, bp.ln1(x), cfg,
                                     positions=positions, window=window,
                                     cache=_at(cache["attn"], layer),
                                     cache_index=idx)
            x = x + a
            h = bp.ln2(x)
            if cfg.is_moe:
                y, _ = L.moe_apply(bp.moe, h, cfg)
            else:
                y = L.mlp_apply(bp.mlp, h, cfg)
            x = x + y
    return _logits(model, x, cfg), cache
