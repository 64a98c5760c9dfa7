"""Transformer building blocks on torch tensors: norms, rotary embeddings,
GQA attention with KV cache, MLP flavors, and a sort-based token-dropping
MoE layer (the JAX package's ``models/layers.py``).

Each block is an ``nn.Module`` that holds its weights under the JAX
package's leaf names and shapes (``wq`` is (d, H, hd), an expert's
``w_up`` (E*s, d, ff/s) ...), so ``models/convert.py`` carries a JAX
parameter tree across leaf for leaf. The math is plain functions on
tensors, each named after its JAX counterpart and following its rounding:
the same casts, the same float32 islands, the same masking constants.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.sharding import annotate, rules

NEG_INF = -1e30


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def normal(shape, generator, device) -> torch.Tensor:
    """Standard normal float32 draws from ``generator`` on ``device``; on
    the meta device, shapes only (no draw)."""
    if device.type == "meta":
        return torch.empty(shape, device=device)
    return torch.randn(shape, generator=generator, device=device)


def proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., k) times the (k, *out) weight -> (..., *out): one matmul
    (the JAX package's ``einsum("bsd,dhk->bshk")`` and kin)."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1],
                                                    *w.shape[1:])


def dense_init(generator, in_dim: int, out_shape: tuple[int, ...], dtype,
               device) -> nn.Parameter:
    """Fan-in-scaled normal init, matmul weight of shape (in_dim, *out)."""
    w = normal((in_dim, *out_shape), generator, device) * in_dim ** -0.5
    return nn.Parameter(w.to(dtype))


# ----------------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------------

class Norm(nn.Module):
    """RMSNorm with a ``scale``, or OLMo's non-parametric LayerNorm (no
    parameter; the JAX leaf is an empty dict)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.kind = cfg.norm
        if cfg.norm == "nonparametric":
            self.register_parameter("scale", None)
        else:
            self.scale = nn.Parameter(torch.ones(
                cfg.d_model, dtype=param_dtype(cfg), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return norm_apply(self.scale, x, self.kind)


def norm_apply(scale, x: torch.Tensor, kind: str) -> torch.Tensor:
    """Statistics in float32: the population variance and eps 1e-5 for the
    non-parametric LayerNorm; RMSNorm at eps 1e-6, cast to ``x.dtype``
    before the scale multiplies."""
    xf = x.float()
    if kind == "nonparametric":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        return ((xf - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype)
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    return (xf * rms).to(x.dtype) * scale


# ----------------------------------------------------------------------------
# Rotary position embeddings
# ----------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_cos_sin(positions: torch.Tensor, hd: int, theta: float):
    """The rotary angles' (cos, sin), (B, S, 1, hd/2) float32, for
    positions (B, S). M-RoPE (qwen2-vl) under the stub vision frontend,
    whose three position streams are the same ids, is this rotation bit
    for bit."""
    freqs = rope_freqs(hd, theta, positions.device)          # (hd/2,)
    ang = positions[..., None].float() * freqs                # (B,S,hd/2)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd) rotated by ``rope_cos_sin``'s angles, in float32,
    cast back to x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# GQA attention with optional sliding window and KV cache
# ----------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA attention's weights. On a mesh (set by the mesh prefill and
    decode steps, ``launch.steps``; None on one device): ``tp_mesh``, the
    mesh over whose ``model`` ranks the heads are split (Megatron TP: the
    projections are the rank's heads, ``wo``'s output summed over
    ``model``); ``sp``, (mesh, axes) where the cache's sequence is split
    over ``axes`` (sequence parallel, the weights whole)."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        self.tp_mesh, self.sp = None, None
        d, hd, dt = cfg.d_model, cfg.head_dim, param_dtype(cfg)
        self.wq = dense_init(generator, d, (cfg.n_heads, hd), dt, device)
        self.wk = dense_init(generator, d, (cfg.n_kv_heads, hd), dt, device)
        self.wv = dense_init(generator, d, (cfg.n_kv_heads, hd), dt, device)
        self.wo = dense_init(generator, cfg.n_heads * hd, (d,), dt, device)


#: Full-sequence attention switches to the chunked online-softmax (flash)
#: path above this length, as the JAX package does: the S x S score matrix
#: never materializes there.
FLASH_THRESHOLD = 1024
FLASH_CHUNK = 512


def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int, scale: float) -> torch.Tensor:
    """Chunked causal attention with online softmax.

    q: (B, S, KV, G, hd) grouped queries; k, v: (B, S, KV, hd). Each query
    chunk scans only its causal prefix of KV chunks. q is scaled in float32
    before the scores; masking is additive ``NEG_INF`` and the denominator
    is floored at 1e-30. ``window`` 0 is global.
    """
    B, S, KV, G, hd = q.shape
    C = FLASH_CHUNK
    dev = q.device
    ar = torch.arange(C, device=dev)
    outs = []
    for i in range(S // C):
        q_blk = q[:, i * C:(i + 1) * C].float() * scale
        qpos = i * C + ar[:, None]                             # (C, 1)
        m = torch.full((B, C, KV, G), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, C, KV, G), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, C, KV, G, hd), dtype=torch.float32, device=dev)
        for j in range(i + 1):
            k_blk = k[:, j * C:(j + 1) * C].float()
            v_blk = v[:, j * C:(j + 1) * C].float()
            s = torch.einsum("bqngh,btnh->bqngt", q_blk, k_blk)
            kpos = j * C + ar[None, :]                         # (1, C)
            ok = kpos <= qpos
            if window > 0:
                ok &= (qpos - kpos) < window
            s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqngt,btnh->bqngh", p, v_blk)
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    return torch.cat(outs, dim=1)                              # (B,S,KV,G,hd)


def _sp_decode(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cache: dict, cache_index: int, window: int, sp,
               scale: float) -> torch.Tensor:
    """One token's attention over a cache whose sequence is split over
    ``sp`` = (mesh, axes): this rank's block holds the global slots
    off .. off + n - 1. The rank that owns slot ``cache_index`` writes the
    new K / V there; every rank scores its block at the slots' global
    positions (causal mask and window), and the ranks combine their
    partial softmaxes: the max over the axes, then the exp-sums and
    weighted values (``annotate.sp_max`` / ``sp_sum``). qg: (B, 1, KV, G,
    hd). Returns (B, KV, G, 1, hd) in float32."""
    mesh, axes = sp
    k_cache, v_cache = cache["k"], cache["v"]
    n = k_cache.shape[1]
    total = n * math.prod(mesh.size(a) for a in axes)
    off = rules.block_slices((total,), (axes,), mesh)[0].start
    if not 0 <= cache_index < total:
        raise IndexError(f"cache_index {cache_index} is outside the "
                         f"cache's {total} slots")
    if off <= cache_index < off + n:
        k_cache[:, cache_index - off] = k[:, 0].to(k_cache.dtype)
        v_cache[:, cache_index - off] = v[:, 0].to(v_cache.dtype)
    kpos = off + torch.arange(n, device=qg.device)
    ok = kpos <= cache_index
    if window > 0:
        ok &= (cache_index - kpos) < window
    kf = k_cache.float().permute(0, 2, 3, 1)[:, :, None]      # (B,KV,1,hd,n)
    scores = (qg.float().permute(0, 2, 3, 1, 4) @ kf) * scale
    scores = scores + torch.where(ok, 0.0, NEG_INF).float()
    m = annotate.sp_max(scores.amax(dim=-1, keepdim=True), mesh, axes)
    p = torch.exp(scores - m)
    acc = p @ v_cache.float().transpose(1, 2)[:, :, None]     # (B,KV,G,1,hd)
    sums = annotate.sp_sum(torch.cat([acc, p.sum(dim=-1, keepdim=True)],
                                     dim=-1), mesh, axes)
    return sums[..., :-1] / sums[..., -1:]


def attention_apply(attn: Attention, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, window: int = 0,
                    cache: dict | None = None, cache_index: int | None = None,
                    return_kv: bool = False):
    """Full-sequence (prefill) or single-token (decode) attention.

    cache: {"k", "v"}: (B, S_cache, kvH, hd). When given, x is (B, 1, d):
    the new KV is written IN PLACE at slot ``cache_index`` (an index past
    the cache raises ``IndexError``) and attention runs over the whole
    cache, masked to ``kpos <= cache_index`` and the window.
    Returns (out, cache) for decode, (out, {"k", "v"} or None) otherwise.

    The head counts are the weights' own: on a TP mesh (``attn.tp_mesh``)
    the rank's heads, whose partial output is summed over ``model``. With
    ``attn.sp`` the cache is the rank's sequence block: decode combines
    the ranks' partial softmaxes (:func:`_sp_decode`), and prefill keeps
    only the block in the K / V it returns.
    """
    B, S, _ = x.shape
    wq, wk, wv = attn.wq, attn.wk, attn.wv
    H, KV, hd = wq.shape[1], wk.shape[1], cfg.head_dim
    q = proj(x, wq)
    k = proj(x, wk)
    v = proj(x, wv)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    q, k = rotate(q, cos, sin), rotate(k, cos, sin)
    group = H // KV
    qg = q.reshape(B, S, KV, group, hd)
    out = None

    if cache is not None and attn.sp is not None:
        new_cache = cache
        out = _sp_decode(qg, k, v, cache, cache_index, window, attn.sp,
                         hd ** -0.5).to(x.dtype)
        out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H * hd)
    elif cache is not None:
        k_cache, v_cache = cache["k"], cache["v"]
        skv = k_cache.shape[1]
        if not 0 <= cache_index < skv:
            raise IndexError(f"cache_index {cache_index} is outside the "
                             f"cache's {skv} slots")
        k_cache[:, cache_index] = k[:, 0].to(k_cache.dtype)
        v_cache[:, cache_index] = v[:, 0].to(v_cache.dtype)
        new_cache = cache
        k, v = k_cache.to(x.dtype), v_cache.to(x.dtype)
        kpos = torch.arange(skv, device=x.device)
        ok = kpos <= cache_index
        if window > 0:
            ok &= (cache_index - kpos) < window
    else:
        new_cache = None
        if return_kv:
            keep = slice(None)
            if attn.sp is not None:
                mesh, axes = attn.sp
                keep, = rules.block_slices((S,), (axes,), mesh)
            new_cache = {"k": k[:, keep], "v": v[:, keep]}
        if S > FLASH_THRESHOLD and S % FLASH_CHUNK == 0:
            out = _flash_attention(qg, k, v, window, hd ** -0.5)
            out = out.to(x.dtype).reshape(B, S, H * hd)
        else:
            ar = torch.arange(S, device=x.device)
            qpos, kpos = ar[:, None], ar[None, :]
            ok = kpos <= qpos
            if window > 0:
                ok &= (qpos - kpos) < window
    if out is None:
        mask = torch.where(ok, 0.0, NEG_INF).float()   # (skv,) or (S, S)
        # "bsngk,btnk->bngst" and "bngst,btnk->bsngk" as batched matmuls
        scores = (qg.permute(0, 2, 3, 1, 4)
                  @ k.permute(0, 2, 3, 1)[:, :, None]).float()
        scores = scores * (hd ** -0.5)
        scores = scores + mask
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = probs @ v.transpose(1, 2)[:, :, None]           # (B,KV,G,S,hd)
        out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H * hd)
    out = proj(out, attn.wo)
    if attn.tp_mesh is not None:
        out = annotate.tp_reduce(out, attn.tp_mesh)
    return out, new_cache


# ----------------------------------------------------------------------------
# MLP flavors
# ----------------------------------------------------------------------------

class MLP(nn.Module):
    """A dense MLP's weights. ``tp_mesh``: None, or the mesh over whose
    ``model`` ranks ``d_ff`` is split (Megatron TP, set by the mesh
    prefill and decode steps): ``w_up`` / ``w_gate`` are the rank's
    columns, ``w_down`` its rows, and the output is summed over
    ``model``."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        self.tp_mesh = None
        d, ff, dt = cfg.d_model, cfg.d_ff, param_dtype(cfg)
        self.w_up = dense_init(generator, d, (ff,), dt, device)
        self.w_down = dense_init(generator, ff, (d,), dt, device)
        if cfg.mlp == "swiglu":
            self.w_gate = dense_init(generator, d, (ff,), dt, device)


def activation(kind: str, up: torch.Tensor, gate=None) -> torch.Tensor:
    """swiglu: silu(gate) * up; relu2: relu(up)^2; gelu: the tanh
    approximation (``jax.nn.gelu``'s default)."""
    if kind == "swiglu":
        return F.silu(gate) * up
    if kind == "relu2":                      # nemotron squared-ReLU
        r = F.relu(up)
        return r * r
    return F.gelu(up, approximate="tanh")


def mlp_apply(mlp: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    up = proj(x, mlp.w_up)
    gate = (proj(x, mlp.w_gate)
            if cfg.mlp == "swiglu" else None)
    y = proj(activation(cfg.mlp, up, gate), mlp.w_down)
    if mlp.tp_mesh is not None:
        y = annotate.tp_reduce(y, mlp.tp_mesh)
    return y


def vocab_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 mesh) -> torch.Tensor:
    """The vocab-parallel embedding lookup: ``table`` is this rank's block
    of rows of the (vocab, d) table, the ranks' blocks in ``model`` order.
    An id outside the block gives zeros; the sum over ``model``
    (``annotate.vocab_embed``) gives every id its row."""
    rows = table.shape[0]
    local = tokens - mesh.index("model") * rows
    ok = (local >= 0) & (local < rows)
    x = table[torch.where(ok, local, 0)]
    x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
    return annotate.vocab_embed(x, mesh)


# ----------------------------------------------------------------------------
# Mixture of Experts: sort-based capacity dispatch (GShard semantics)
# ----------------------------------------------------------------------------

class MoE(nn.Module):
    """Packed layout: (E*s, d, ff/s), slice j of expert e at row e*s + j.

    ``ep_mesh``: None (the plain path), or the mesh over whose ``model``
    ranks (more than one) this layer's packed rows are split, set by the
    mesh train step (``launch.steps.MeshTrainState``): ``moe_apply`` then
    takes the expert-parallel path, each rank holding its own rows."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        self.ep_mesh = None
        d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        s, dt = cfg.moe_ff_shards, param_dtype(cfg)
        self.router = dense_init(generator, d, (E,), torch.float32, device)
        self.w_up = nn.Parameter((normal((E * s, d, ff // s), generator,
                                         device) * d ** -0.5).to(dt))
        self.w_down = nn.Parameter((normal((E * s, ff // s, d), generator,
                                           device) * ff ** -0.5).to(dt))
        if cfg.mlp == "swiglu":
            self.w_gate = nn.Parameter((normal((E * s, d, ff // s),
                                               generator, device)
                                        * d ** -0.5).to(dt))


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, descending, the
    lowest index first among equals (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_routing(router: torch.Tensor, xg: torch.Tensor, k: int, E: int):
    """Routing for one group xg: (tg, d). Returns the entries sorted by
    expert (stable), each entry's position in its expert's run, and the
    Switch-style load-balance loss."""
    logits = xg.float() @ router                                  # (tg, E)
    return _route(logits, logits, k, E)


def _route(logits: torch.Tensor, aux_logits: torch.Tensor, k: int, E: int):
    """``_moe_routing`` from the router's logits (tg, E): the gates from
    ``logits``, the load-balance loss from ``aux_logits``, the same values
    (the expert-parallel path passes *f* of them as ``logits``)."""
    tg = logits.shape[0]
    gate_top, ids = top_k(logits, k)
    gates = torch.softmax(gate_top, dim=-1)
    flat_e = ids.reshape(-1)
    flat_tok = torch.arange(tg * k, device=logits.device) // k
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    stok = flat_tok[order]
    sgate = gates.reshape(-1)[order]
    first = torch.searchsorted(se, se, side="left")
    pos = torch.arange(tg * k, device=logits.device) - first
    me = F.one_hot(ids[:, 0], E).float().mean(dim=0)
    pe = torch.softmax(aux_logits, dim=-1).mean(dim=0)
    aux = E * torch.sum(me * pe)
    return se, stok, sgate, pos, aux


def _moe_dispatch(moe: MoE, x: torch.Tensor, cfg: ModelConfig,
                  capacity: int, router: torch.Tensor | None = None):
    """Routing + capacity bucketing for one token group x: (tg, d), with
    ``router`` (default ``moe.router``: a caller looping over groups reads
    it once, since on a mesh each read gathers it).

    Returns (xe (E, C, d) expert inputs, (slot, stok, sgate, keep) for the
    combine, aux load-balance loss). An entry past its expert's capacity
    goes to the spare row E*C, which is dropped.
    """
    tg, d = x.shape
    E, C = cfg.n_experts, capacity
    router = moe.router if router is None else router
    se, stok, sgate, pos, aux = _moe_routing(router, x,
                                             cfg.experts_per_token, E)
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)
    xe = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    xe[slot] = x[stok]
    return xe[:E * C].reshape(E, C, d), (slot, stok, sgate, keep), aux


def _moe_combine(ye: torch.Tensor, route, tg: int, dtype) -> torch.Tensor:
    """Expert outputs back to their tokens for one group; ye: (E, C, d).

    Each token's k contributions are summed in a fixed order (by expert,
    the order of the JAX package's scatter-add), without atomics, so two
    runs give the same bits."""
    slot, stok, sgate, keep = route
    EC, d = ye.shape[0] * ye.shape[1], ye.shape[2]
    ye_flat = torch.cat([ye.reshape(EC, d),
                         torch.zeros((1, d), dtype=ye.dtype,
                                     device=ye.device)])
    contrib = (ye_flat[slot] * (sgate * keep)[:, None].to(ye.dtype)).to(dtype)
    by_token = torch.argsort(stok, stable=True).reshape(tg, -1)  # (tg, k)
    y = contrib[by_token[:, 0]]
    for j in range(1, by_token.shape[1]):
        y = y + contrib[by_token[:, j]]
    return y


def moe_apply(moe: MoE, x: torch.Tensor,
              cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Groups = batch rows (sequence-local routing), so the
    capacity C = int(S*k/E*cf) + 1 counts one row's S (1 at decode).

    With moe_ff_shards = s > 1 every expert's FFN is s column slices whose
    partial outputs are summed. A layer with an ``ep_mesh`` takes the
    expert-parallel path (``moe_apply_shard_map``); otherwise, as on one
    device, the plain path.
    """
    if moe.ep_mesh is not None:
        return moe_apply_shard_map(moe, x, cfg, moe.ep_mesh)
    B, S, d = x.shape
    E, s = cfg.n_experts, cfg.moe_ff_shards
    k = cfg.experts_per_token
    C = int(S * k / cfg.n_experts * cfg.moe_capacity_factor) + 1

    router = moe.router
    groups = [_moe_dispatch(moe, x[b], cfg, C, router) for b in range(B)]
    xe = torch.stack([g[0] for g in groups])                     # (G,E,C,d)
    if s > 1:
        xe = torch.repeat_interleave(xe, s, dim=1)               # (G,E*s,C,d)
    up = torch.einsum("gecd,edf->gecf", xe, moe.w_up)
    gate = (torch.einsum("gecd,edf->gecf", xe, moe.w_gate)
            if cfg.mlp == "swiglu" else None)
    ye = torch.einsum("gecf,efd->gecd", activation(cfg.mlp, up, gate),
                      moe.w_down)                                # (G,E*s,C,d)
    if s > 1:
        ye = ye.reshape(B, E, s, C, d).sum(dim=2)
    y = torch.stack([_moe_combine(ye[b], groups[b][1], S, x.dtype)
                     for b in range(B)])
    return y, torch.stack([g[2] for g in groups]).mean()


def moe_apply_shard_map(moe: MoE, x: torch.Tensor, cfg: ModelConfig,
                        mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Explicit expert parallelism over ``mesh``'s ``model`` ranks (the
    JAX package's ``moe_apply_shard_map``). x: (B, S, d), this rank's rows,
    the same on every model rank; ``moe``'s expert weights are the rank's
    ``e_loc`` packed rows (``e_loc * model`` in all), the router whole.

    Every rank routes every token with the replicated router, builds only
    the buckets of its own rows, computes them and contributes a partial
    output; *g* (``annotate.moe_out``) sums the partials over ``model``,
    one activation all-reduce a layer, and no (G, E, C, d) tensor crosses.
    *f* (``annotate.moe_in``) wraps what each rank reads for its own rows
    alone, the tokens and the gates' logits, so that their gradients sum
    over ``model``; the load-balance loss reads the logits as they are, its
    gradient the same on every rank. Returns (y, the mean aux over the
    rank's groups)."""
    B, S, d = x.shape
    E, s, k = cfg.n_experts, cfg.moe_ff_shards, cfg.experts_per_token
    C = int(S * k / E * cfg.moe_capacity_factor) + 1
    router, w_up, w_down = moe.router, moe.w_up, moe.w_down
    w_gate = moe.w_gate if cfg.mlp == "swiglu" else None
    e_loc = w_up.shape[0]
    row0 = mesh.index("model") * e_loc
    xf = annotate.moe_in(x, mesh)
    ys, auxes = [], []
    for b in range(B):
        logits = x[b].float() @ router                           # (S, E)
        se, stok, sgate, pos, aux = _route(annotate.moe_in(logits, mesh),
                                           logits, k, E)
        keep = pos < C
        xg = xf[b][stok]
        y = torch.zeros((S, d), dtype=x.dtype, device=x.device)
        for j in range(e_loc):
            mine = keep & (se == (row0 + j) // s)
            slot = torch.where(mine, pos, C)
            xe = torch.zeros((C + 1, d), dtype=x.dtype, device=x.device)
            xe[slot] = xg
            xe = xe[:C]
            gate = xe @ w_gate[j] if w_gate is not None else None
            h = activation(cfg.mlp, xe @ w_up[j], gate)
            ye = torch.cat([h @ w_down[j],
                            torch.zeros((1, d), dtype=x.dtype,
                                        device=x.device)])
            contrib = ye[slot] * (sgate * mine)[:, None].to(x.dtype)
            y = y.index_add(0, stok, contrib)
        ys.append(y)
        auxes.append(aux)
    return annotate.moe_out(torch.stack(ys), mesh), torch.stack(auxes).mean()
