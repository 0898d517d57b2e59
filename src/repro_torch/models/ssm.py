"""Mamba-2 (SSD) block, chunked scan formulation (arXiv:2405.21060;
counterpart of :mod:`repro.models.ssm`).

State-space recurrence per head (state N, head dim P):

    h_t = exp(A * dt_t) h_{t-1} + dt_t * B_t x_t^T        h: [N, P]
    y_t = C_t h_t + D x_t

computed with the SSD chunk decomposition: an intra-chunk quadratic term
(attention-like matmuls) plus the inter-chunk recurrence over chunk states,
a loop over chunks (the reference's ``lax.scan``).  :func:`mamba2_apply`
has the reference's three branches: no cache (the chunked scan from a zero
state), a cache and more than 4 tokens (the chunked scan from the carried
state, a cache-filling prefill), and the recurrent update token by token.

The cache ``{"ssm_state": [B, H, N, P] fp32, "conv_state": [B, W-1, C]}``
is never written in place: each call returns new tensors, so decoding
twice from one cache starts both times from the same state.

The reference annotates the cache-free SSD input's heads ``"heads"``;
inside :func:`placement.model_split
<repro_torch.dist.placement.model_split>` that path computes this rank's
heads where :func:`~repro_torch.models.layers.tp_plan` splits them
(:func:`_mamba2_share`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from repro_torch.dist import placement
from repro_torch.dist import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Norm, _param, _reads_index, dense_init, norm_apply,
                                       tp_plan)

__all__ = ["Mamba2", "mamba2_init", "mamba2_apply", "mamba2_cache_init"]


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.state_dim
    return s, d_in, n_heads, conv_dim


class Mamba2(nn.Module):
    """``in_proj [d, 2 d_in + 2 G N + H]`` (z, x, B, C, dt), ``out_proj
    [d_in, d]``, ``dt_bias``/``A_log``/``D [H]`` (fp32), ``conv_w [W, C]``,
    ``conv_b [C]`` and ``gate_norm`` over ``d_in``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None, *,
                 device=None):
        super().__init__()
        s, d_in, nh, conv_dim = _dims(cfg)
        d = cfg.d_model
        dev = gen.device if gen is not None else device
        proj_out = 2 * d_in + 2 * s.n_groups * s.state_dim + nh
        self.cfg = cfg
        self.in_proj = _param(dense_init(gen, (d, proj_out), cfg.p_dtype, device=dev))
        self.out_proj = _param(dense_init(gen, (d_in, d), cfg.p_dtype, device=dev))
        if gen is None:
            dt_bias = torch.empty(nh, device=dev)
        else:
            u = torch.rand(nh, generator=gen, device=dev)
            dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                           + math.log(s.dt_min))
            dt_bias = dt + torch.log(-torch.expm1(-dt))          # inverse softplus
        self.dt_bias = _param(dt_bias)
        self.A_log = _param(torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                                   device=dev)))
        self.D = _param(torch.ones(nh, dtype=torch.float32, device=dev))
        self.conv_w = _param(dense_init(gen, (s.conv_width, conv_dim), cfg.p_dtype,
                                        scale=1.0 / math.sqrt(s.conv_width), device=dev))
        self.conv_b = _param(torch.zeros(conv_dim, dtype=cfg.p_dtype, device=dev))
        self.gate_norm = Norm(cfg, d_in, device=dev)

    def forward(self, x: Tensor, *, cache: dict | None = None):
        return mamba2_apply(self, x, self.cfg, cache=cache)


def mamba2_init(gen: torch.Generator | None, cfg: ModelConfig, *, device=None) -> Mamba2:
    return Mamba2(cfg, gen, device=device)


def _causal_conv(x: Tensor, w: Tensor, b: Tensor, state: Tensor | None):
    """Depthwise causal conv1d.  x: [B, S, C], w: [W, C] -> [B, S, C].

    ``state``: [B, W-1, C] carries the tail for decode; returns the new
    state (a new tensor)."""
    W = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                         # [B, S+W-1, C]
    out = sum(xp[:, i: i + x.shape[1]] * w[i].to(x.dtype) for i in range(W))
    new_state = xp[:, -(W - 1):] if W > 1 else None
    return out + b.to(x.dtype), new_state


def _ssd_chunked(x, dt, A, B, C, chunk: int, init_state=None):
    """SSD scan.  x:[b,s,h,p] dt:[b,s,h] A:[h] B,C:[b,s,g,n] -> y:[b,s,h,p].

    fp32 state math; returns (y, final_state [b,h,n,p])."""
    b, s_len, h, p_dim = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    pad = (-s_len) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    L = x.shape[1] // chunk
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    state = (x.new_zeros((b, h, n, p_dim), dtype=torch.float32) if init_state is None
             else init_state.float())
    ys = []
    # a loop over chunks: every quadratic intermediate stays one chunk in
    # size ([b, q, q, h]), so memory is O(chunk^2) whatever S is
    for c in range(L):
        sl = slice(c * chunk, (c + 1) * chunk)
        xq = x[:, sl].float()
        dtq = dt[:, sl].float()
        Bq = B[:, sl].repeat_interleave(rep, dim=2).float()   # [b,q,h,n]
        Cq = C[:, sl].repeat_interleave(rep, dim=2).float()
        dA = dtq * A[None, None, :]                         # [b,q,h] (negative)
        cum = torch.cumsum(dA, dim=1)
        # intra: y[t] = sum_{j<=t} exp(a_t - a_j) (C_t . B_j) dt_j x_j.  Above
        # the diagonal exp(a_t - a_j) can overflow to inf, so the exponent is
        # -inf there: the decay is 0 and so is its gradient.  (The reference
        # selects 0 after the exp, which gives the same values but a nan
        # gradient, 0 * inf, once a chunk's decays overflow, as they do at
        # full width.)
        decay = torch.exp(torch.where(mask[None, :, :, None],
                                      cum[:, :, None, :] - cum[:, None, :, :],
                                      float("-inf")))               # [b,q,j,h]
        CB = torch.einsum("bqhn,bjhn->bqjh", Cq, Bq)
        y_intra = torch.einsum("bqjh,bjhp->bqhp", CB * decay * dtq[:, None], xq)
        # inter: y += C_t exp(a_t) H_prev
        y_inter = torch.einsum("bqhn,bqh,bhnp->bqhp", Cq, torch.exp(cum), state)
        # new chunk state
        seg = torch.exp(cum[:, -1:, :] - cum) * dtq          # [b,q,h]
        chunk_state = torch.einsum("bqh,bqhn,bqhp->bhnp", seg, Bq, xq)
        state = state * torch.exp(cum[:, -1])[..., None, None] + chunk_state
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :s_len]
    return y, state


def mamba2_apply(p: Mamba2, x: Tensor, cfg: ModelConfig, *, cache: dict | None = None):
    """x: [B, S, D].  Train/prefill when cache is None; else the
    cache-filling chunked path (S > 4) or the recurrent update.

    Returns (y, new_cache); the new cache holds new tensors.  Inside
    :func:`placement.model_split <repro_torch.dist.placement.model_split>`
    the cache-free path computes this rank's SSD heads where
    :func:`~repro_torch.models.layers.tp_plan` splits them
    (:func:`_mamba2_share`); the cached paths compute whole, as the
    reference annotates nothing there."""
    s, d_in, nh, conv_dim = _dims(cfg)
    share = placement.model_part() if cache is None else None
    if share is not None and tp_plan(cfg, share[1])["ssd_heads"]:
        return _mamba2_share(p, x, cfg, share), None
    B_, S_, D_ = x.shape
    gn = s.n_groups * s.state_dim
    proj = x @ p.in_proj.to(x.dtype)                        # [B,S,*]
    z, xin, Bc, Cc, dt = torch.split(proj, [d_in, d_in, gn, gn, nh], dim=-1)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv_state = cache.get("conv_state") if cache else None
    conv_out, new_conv = _causal_conv(conv_in, p.conv_w, p.conv_b, conv_state)
    conv_out = F.silu(conv_out)
    xin = conv_out[..., :d_in]
    Bc = conv_out[..., d_in: d_in + gn]
    Cc = conv_out[..., d_in + gn:]

    heads_x = xin.reshape(B_, S_, nh, s.head_dim)
    Bh = Bc.reshape(B_, S_, s.n_groups, s.state_dim)
    Ch = Cc.reshape(B_, S_, s.n_groups, s.state_dim)
    dt = F.softplus(dt.float() + p.dt_bias)                 # [B,S,nh]
    A = -torch.exp(p.A_log)                                 # [nh]

    if cache is None:
        heads_x = shd.shard(heads_x, "batch", None, "heads", None)
        y, new_state = _ssd_chunked(heads_x, dt, A, Bh, Ch, s.chunk)
    elif S_ > 4:
        # cache-filling prefill: chunked path from the carried state
        y, new_state = _ssd_chunked(heads_x, dt, A, Bh, Ch, s.chunk,
                                    init_state=cache["ssm_state"])
    else:
        # recurrent single (or few) token update
        st = cache["ssm_state"].float()                     # [B,nh,N,P]
        rep = nh // s.n_groups
        Bh_ = Bh.repeat_interleave(rep, dim=2).float()
        Ch_ = Ch.repeat_interleave(rep, dim=2).float()
        xf = heads_x.float()
        ys = []
        for t in range(S_):                                 # S_ is 1 in decode
            dA = torch.exp(dt[:, t] * A[None, :])           # [B,nh]
            st = st * dA[..., None, None] + torch.einsum(
                "bhn,bhp,bh->bhnp", Bh_[:, t], xf[:, t], dt[:, t])
            ys.append(torch.einsum("bhn,bhnp->bhp", Ch_[:, t], st))
        y = torch.stack(ys, dim=1)                          # [B,S,nh,P]
        new_state = st

    y = y + heads_x.float() * p.D[None, None, :, None]
    y = y.reshape(B_, S_, d_in).to(x.dtype)
    y = norm_apply(p.gate_norm, y * F.silu(z), cfg)
    out = shd.shard(y @ p.out_proj.to(x.dtype), "batch", None, "model_embed")
    new_cache = ({"ssm_state": new_state, "conv_state": new_conv} if cache is not None
                 else None)
    return out, new_cache


def _mamba2_share(p: Mamba2, x: Tensor, cfg: ModelConfig, share: tuple) -> Tensor:
    """Share ``r`` of ``share = (r, tp, group)`` of the cache-free layer,
    summed over the group: its ``nh / tp`` heads ``H_r`` and their ``d_in /
    tp`` channels ``C_r``: ``in_proj``'s z, x and dt columns of those,
    ``conv_w``/``conv_b``'s x channels ``C_r``, ``dt_bias``, ``A_log`` and
    ``D`` on ``H_r``, ``gate_norm.scale`` on ``C_r``, ``out_proj``'s rows
    ``C_r`` (Megatron's ``g``).  The B and C columns and their conv
    channels are computed whole, and each head reads its own group
    (:func:`~repro_torch.models.layers._reads_index`).  The gate norm is an
    RMS over all of ``d_in``: the share's sum of squares is summed over
    the group forward and backward (:func:`placement.sum_over_group
    <repro_torch.dist.placement.sum_over_group>`).  ``x`` goes through
    Megatron's ``f``; every weight's gradient holds this share's part
    alone (the whole B/C columns too: only the share's heads read them
    here), so each is marked :func:`placement.sum_over_model
    <repro_torch.dist.placement.sum_over_model>`."""
    if cfg.norm_kind != "rmsnorm":
        raise ValueError(f"the SSD split sums an RMS statistic, not a {cfg.norm_kind}'s")
    s, d_in, nh, _ = _dims(cfg)
    r, tp, group = share
    B_, S_, _ = x.shape
    gn = s.n_groups * s.state_dim
    hq = nh // tp
    c = hq * s.head_dim
    x = placement.copy_to_group(x, group)
    for w in (p.in_proj, p.out_proj, p.dt_bias, p.A_log, p.D, p.conv_w, p.conv_b,
              p.gate_norm.scale):
        placement.sum_over_model(w)
    ch, hs = slice(r * c, (r + 1) * c), slice(r * hq, (r + 1) * hq)
    w = p.in_proj
    dt0 = 2 * d_in + 2 * gn
    w = torch.cat([w[:, ch], w[:, d_in + r * c:d_in + (r + 1) * c], w[:, 2 * d_in:dt0],
                   w[:, dt0 + r * hq:dt0 + (r + 1) * hq]], dim=1)
    z, xin, Bc, Cc, dt = torch.split(x @ w.to(x.dtype), [c, c, gn, gn, hq], dim=-1)
    conv_w = torch.cat([p.conv_w[:, ch], p.conv_w[:, d_in:]], dim=1)
    conv_b = torch.cat([p.conv_b[ch], p.conv_b[d_in:]])
    conv_out, _ = _causal_conv(torch.cat([xin, Bc, Cc], dim=-1), conv_w, conv_b, None)
    conv_out = F.silu(conv_out)
    xin, Bc, Cc = torch.split(conv_out, [c, gn, gn], dim=-1)

    heads_x = shd.shard(xin.reshape(B_, S_, hq, s.head_dim), "batch", None, "heads", None)
    reads = _reads_index([(r * hq + j) // (nh // s.n_groups) for j in range(hq)])
    Bh = Bc.reshape(B_, S_, s.n_groups, s.state_dim)[:, :, reads]
    Ch = Cc.reshape(B_, S_, s.n_groups, s.state_dim)[:, :, reads]
    dt = F.softplus(dt.float() + p.dt_bias[hs])             # [B,S,hq]
    A = -torch.exp(p.A_log[hs])
    y, _ = _ssd_chunked(heads_x, dt, A, Bh, Ch, s.chunk)
    y = y + heads_x.float() * p.D[hs][None, None, :, None]
    y = y.reshape(B_, S_, c).to(x.dtype)
    # the gate norm over all d_in channels: the sum of squares of every share
    yf = (y * F.silu(z)).float()
    sq = placement.sum_over_group((yf * yf).sum(-1, keepdim=True), share)
    y = (yf * torch.rsqrt(sq / d_in + 1e-6) * p.gate_norm.scale[ch].float()).to(x.dtype)
    out = placement.all_reduce_sum(y @ p.out_proj[ch].to(x.dtype), group)
    return shd.shard(out, "batch", None, "model_embed")


def mamba2_cache_init(cfg: ModelConfig, batch: int, *, device=None) -> dict:
    s, d_in, nh, conv_dim = _dims(cfg)
    return {
        "ssm_state": torch.zeros((batch, nh, s.state_dim, s.head_dim), dtype=torch.float32,
                                 device=device),
        "conv_state": torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=torch.float32,
                                  device=device),
    }
