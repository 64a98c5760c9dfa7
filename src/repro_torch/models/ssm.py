"""Mamba2 (SSD — state-space duality) blocks, prefill + decode paths (the
JAX package's ``models/ssm.py``).

Chunked SSD (Dao & Gu 2024): the sequence is split into chunks;
within-chunk interactions are an attention-like masked matmul, cross-chunk
interactions flow through a per-chunk state recurrence (a loop over the
chunks here, a ``lax.scan`` in JAX). Decode is the O(1)-per-token
recurrent update on (B, H, P, N) state.

Used by ``mamba2-2.7b`` (pure SSM) and ``zamba2-2.7b`` (hybrid, with a
shared attention block interleaved by models/model.py).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import normal, param_dtype, proj
from repro_torch.sharding import annotate


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    heads = d_in // cfg.ssm_head_dim
    n = cfg.ssm_state
    conv_dim = d_in + 2 * n                    # x, B, C share the conv
    return d_in, heads, n, conv_dim


class SSM(nn.Module):
    """A Mamba2 block's weights. ``head_mesh``: None, or the mesh over
    whose ``model`` ranks the recurrent state's heads are split (set by
    the mesh prefill and decode steps): the state is updated on the rank's
    heads, the projections and the conv window stay whole, and the heads'
    outputs are gathered (``annotate.ssm_heads``) before the gated norm."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        self.head_mesh = None
        d = cfg.d_model
        d_in, heads, n, conv_dim = _dims(cfg)
        dt = param_dtype(cfg)
        f32 = dict(dtype=torch.float32, device=device)
        proj_out = 2 * d_in + 2 * n + heads        # z, x, B, C, dt
        kw = cfg.ssm_conv_width
        self.in_proj = nn.Parameter(
            (normal((d, proj_out), generator, device) * d ** -0.5).to(dt))
        self.conv_w = nn.Parameter(
            (normal((kw, conv_dim), generator, device) * kw ** -0.5).to(dt))
        self.conv_b = nn.Parameter(torch.zeros(conv_dim, dtype=dt,
                                               device=device))
        self.a_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, heads,
                                                           **f32)))
        self.dt_bias = nn.Parameter(torch.zeros(heads, **f32))
        self.d_skip = nn.Parameter(torch.ones(heads, **f32))
        self.norm = nn.Parameter(torch.ones(d_in, dtype=dt, device=device))
        self.out_proj = nn.Parameter(
            (normal((d_in, d), generator, device) * d_in ** -0.5).to(dt))


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    d_in, heads, n, _ = _dims(cfg)
    z, xs, B, C, dt = torch.split(zxbcdt, [d_in, d_in, n, n, heads], dim=-1)
    return z, xs, B, C, dt


def _conv_full(xbc: torch.Tensor, ssm: SSM, cfg: ModelConfig) -> torch.Tensor:
    """Causal depthwise conv over (B, S, conv_dim): the cross-correlation
    ``out[t] = sum_j w[j] * x[t - kw + 1 + j]`` with the (kw, conv_dim)
    weight, as a sum of kw shifted products in float32 (elementwise, so no
    cuDNN convolution and no TF32 whatever its global setting)."""
    w = ssm.conv_w.float()                            # (kw, conv_dim)
    kw, S = w.shape[0], xbc.shape[1]
    x = F.pad(xbc.float(), (0, 0, kw - 1, 0))
    out = x[:, :S] * w[0]
    for j in range(1, kw):
        out = out + x[:, j:j + S] * w[j]
    return F.silu(out + ssm.conv_b.float()).to(xbc.dtype)


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int):
    """Chunked SSD. x: (b,s,h,p); dt: (b,s,h) (>0); a: (h,) (<0);
    B, C: (b,s,n) (single group, broadcast over heads). Every decay
    exponent is clipped to [-60, 0]. Returns (y (b,s,h,p), the state after
    the last token (b,h,p,n))."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the SSD "
                         f"chunk {chunk}")
    nc, cl = s // chunk, chunk

    xr = x.reshape(b, nc, cl, h, p)
    dtr = dt.reshape(b, nc, cl, h)
    Br = B.reshape(b, nc, cl, n)
    Cr = C.reshape(b, nc, cl, n)
    dA = dtr * a                                        # (b,nc,cl,h) negative
    dA_cs = torch.cumsum(dA, dim=2)                     # within-chunk cumsum
    xdt = xr * dtr[..., None]

    # --- diagonal (within-chunk) term: attention-like masked matmul ---
    cb = torch.einsum("bzin,bzjn->bzij", Cr, Br)        # (b,nc,cl,cl)
    li = dA_cs[:, :, :, None, :]                        # i index -> axis 2
    lj = dA_cs[:, :, None, :, :]                        # j index
    decay = torch.exp(torch.clamp(li - lj, -60.0, 0.0))  # (b,nc,cl,cl,h)
    causal = torch.tril(torch.ones((cl, cl), dtype=torch.bool,
                                   device=x.device))
    scores = cb[..., None] * torch.where(causal[None, None, :, :, None],
                                         decay, 0.0)
    y_diag = torch.einsum("bzijh,bzjhp->bzihp", scores, xdt)

    # --- per-chunk final states ---
    decay_to_end = torch.exp(torch.clamp(dA_cs[:, :, -1:, :] - dA_cs,
                                         -60.0, 0.0))
    states = torch.einsum("bzjn,bzjh,bzjhp->bzhpn", Br, decay_to_end, xdt)

    # --- cross-chunk recurrence: each chunk sees the PREVIOUS state ---
    chunk_decay = torch.exp(torch.clamp(dA_cs[:, :, -1, :], -60.0, 0.0))
    carry = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    prev = []
    for z in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z]
    prev_states = torch.stack(prev, dim=1)              # (b,nc,h,p,n)

    # --- off-diagonal term: contribution of previous chunks' states ---
    c_decay = torch.exp(torch.clamp(dA_cs, -60.0, 0.0))  # from chunk start
    y_off = torch.einsum("bzin,bzih,bzhpn->bzihp", Cr, c_decay, prev_states)

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, carry


def _gated_out(ssm: SSM, y: torch.Tensor, z: torch.Tensor,
               dtype) -> torch.Tensor:
    """Gated RMSNorm (float32, eps 1e-6), cast, scaled, then ``out_proj``."""
    y = y * F.silu(z.float())
    rms = torch.rsqrt((y * y).mean(dim=-1, keepdim=True) + 1e-6)
    y = (y * rms).to(dtype) * ssm.norm
    return proj(y, ssm.out_proj)


def ssm_apply(ssm: SSM, x: torch.Tensor, cfg: ModelConfig):
    """Full-sequence SSD pass. x: (B, S, d) -> (y, decode_cache).

    decode_cache = {"state": (B,h,p,n), "conv": (B, kw-1, conv_dim)}: the
    recurrent state after the last token and the last kw-1 tokens' PRE-conv
    ``xbc``, both float32, so prefill hands off to ``ssm_decode_step``."""
    d_in, heads, n, conv_dim = _dims(cfg)
    zxbcdt = proj(x, ssm.in_proj)
    z, xs, B, C, dt = _split_proj(zxbcdt, cfg)
    xbc_pre = torch.cat([xs, B, C], dim=-1)
    conv_tail = xbc_pre[:, -(cfg.ssm_conv_width - 1):, :]
    xbc = _conv_full(xbc_pre, ssm, cfg)
    xs, B, C = torch.split(xbc, [d_in, n, n], dim=-1)
    dt = F.softplus(dt.float() + ssm.dt_bias)
    a = -torch.exp(ssm.a_log)                           # (h,) negative
    xh = xs.reshape(*xs.shape[:-1], heads, cfg.ssm_head_dim)
    y, final = _ssd_chunked(xh.float(), dt, a, B.float(), C.float(),
                            cfg.ssm_chunk)
    y = y + ssm.d_skip[:, None] * xh.float()
    y = y.reshape(*x.shape[:-1], d_in)
    if ssm.head_mesh is not None:
        final = final[:, _heads(ssm.head_mesh, heads)]
    cache = {"state": final, "conv": conv_tail.float()}
    return _gated_out(ssm, y, z, x.dtype), cache


def _heads(mesh, heads: int) -> slice:
    """This rank's block of the ``heads`` over ``mesh``'s ``model``."""
    n = heads // mesh.size("model")
    return slice(mesh.index("model") * n, (mesh.index("model") + 1) * n)


def ssm_decode_init(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    """The empty recurrent state and conv window, both float32."""
    d_in, heads, n, conv_dim = _dims(cfg)
    return {
        "state": torch.zeros((batch, heads, cfg.ssm_head_dim, n),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=torch.float32, device=device),
    }


def ssm_decode_step(ssm: SSM, x: torch.Tensor, cache: dict,
                    cfg: ModelConfig):
    """Single-token recurrent update. x: (B, 1, d). Writes the new state
    and conv window into ``cache``'s tensors IN PLACE and returns
    (out (B, 1, d), cache)."""
    d_in, heads, n, conv_dim = _dims(cfg)
    zxbcdt = proj(x[:, 0], ssm.in_proj)
    z, xs, B, C, dt = _split_proj(zxbcdt, cfg)
    xbc_new = torch.cat([xs, B, C], dim=-1)             # (B, conv_dim)
    window = torch.cat([cache["conv"],
                        xbc_new[:, None, :].to(cache["conv"].dtype)], dim=1)
    w = ssm.conv_w.float()                              # (kw, conv_dim)
    conv_out = (window.float() * w).sum(dim=1)
    xbc = F.silu(conv_out + ssm.conv_b.float())
    xs, B, C = torch.split(xbc, [d_in, n, n], dim=-1)
    dt = F.softplus(dt.float() + ssm.dt_bias)           # (B, h)
    a = -torch.exp(ssm.a_log)
    xh = xs.reshape(-1, heads, cfg.ssm_head_dim)
    d_skip = ssm.d_skip
    if ssm.head_mesh is not None:                       # the rank's heads
        mine = _heads(ssm.head_mesh, heads)
        dt, a, xh, d_skip = dt[:, mine], a[mine], xh[:, mine], d_skip[mine]
    decay = torch.exp(dt * a)                           # (B, h)
    state = cache["state"] * decay[..., None, None] + (
        (xh * dt[..., None])[..., None] * B[:, None, None, :])
    y = (state @ C[:, None, :, None])[..., 0]             # (B, h, p)
    y = y + d_skip[:, None] * xh
    if ssm.head_mesh is not None:
        y = annotate.ssm_heads(y, ssm.head_mesh, 1)
    out = _gated_out(ssm, y.reshape(-1, d_in), z, x.dtype)[:, None, :]
    cache["state"].copy_(state)
    cache["conv"].copy_(window[:, 1:])
    return out, cache

