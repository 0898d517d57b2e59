"""RWKV-6 ("Finch") block: data-dependent decay linear attention
(arXiv:2404.05892; counterpart of :mod:`repro.models.rwkv`).

Per head (key/value dim M = d_model / n_heads), with data-dependent
per-channel decay w_t in (0,1) and bonus u:

    out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T            S: [M, M]

Token-shift mixing and the low-rank (LoRA) data-dependent interpolation
follow the paper.  :func:`_wkv_scan` is the recurrence token by token (a
loop over time); :func:`_wkv_chunked` is the chunked form, matmuls within
a chunk and the recurrence across chunks, which :func:`rwkv6_apply` takes
from 256 tokens on, as the reference does.

The cache ``{"shift_tm", "shift_cm", "wkv_state"}`` is never written in
place: each call returns new tensors.

The reference's ``"heads"`` (r, k, v, w) and ``"ffn"`` (the gate, the
gated output, the channel mix's key) annotations stand where it has them.
What they make GSPMD split over ``"model"`` the port computes per rank
inside :func:`placement.model_split
<repro_torch.dist.placement.model_split>`, with a cache or without:
:func:`rwkv6_time_mix` this rank's heads, :func:`rwkv6_channel_mix` its
``d_ff`` columns, where :func:`~repro_torch.models.layers.tp_plan` splits
them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from repro_torch.dist import placement
from repro_torch.dist import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Norm, _param, dense_init, norm_apply, tp_plan

__all__ = ["LORA_R", "MIX_R", "RWKV6", "rwkv6_init", "rwkv6_apply", "rwkv6_time_mix",
           "rwkv6_channel_mix", "rwkv6_cache_init"]

LORA_R = 32     # decay LoRA rank
MIX_R = 32      # token-shift mix LoRA rank


def _head_norm(scale: Tensor, x: Tensor, h: int) -> Tensor:
    """Per-head RMS normalization (RWKV's GroupNorm(n_heads), scale-only)
    of ``x [B, S, h·m]`` by ``scale [h·m]``."""
    B, S, D = x.shape
    m = D // h
    xf = x.float().reshape(B, S, h, m)
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + 1e-6)
    y = y * scale.float().reshape(h, m)
    return y.reshape(B, S, D).to(x.dtype)


class RWKV6(nn.Module):
    """Time-mix (``mu [5, d]``, ``mix_w1``/``mix_w2``, ``wr``/``wk``/``wv``/
    ``wg``/``wo``, the decay ``w0`` and its LoRA, the bonus ``u [h, m]``,
    ``ln_x``) and channel-mix (``cm_mu [2, d]``, ``cm_k``, ``cm_v``,
    ``cm_r``) weights, with the pre-norms ``ln1`` and ``ln2``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None, *,
                 device=None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        m = d // h
        dev = gen.device if gen is not None else device
        pd = cfg.p_dtype
        self.cfg = cfg

        def uniform(shape, lo, width, dtype):
            if gen is None:
                return torch.empty(shape, dtype=dtype, device=dev)
            return (torch.rand(shape, generator=gen, device=dev) * width + lo).to(dtype)

        def dense(shape, scale=None):
            return _param(dense_init(gen, shape, pd, scale=scale, device=dev))

        # token-shift static mixes (5 for time-mix: r, k, v, g, w)
        self.mu = _param(uniform((5, d), 0.25, 0.5, pd))
        self.mix_w1 = dense((d, 5 * MIX_R))
        self.mix_w2 = dense((5, MIX_R, d), 0.01)
        self.wr = dense((d, d))
        self.wk = dense((d, d))
        self.wv = dense((d, d))
        self.wg = dense((d, d))
        self.wo = dense((d, d), 1.0 / math.sqrt(d))
        # decay: w = exp(-exp(w0 + lora(xw)))
        self.w0 = _param(uniform((d,), -6.0, 2.0, torch.float32))
        self.decay_w1 = dense((d, LORA_R))
        self.decay_w2 = dense((LORA_R, d), 0.01)
        self.u = _param(uniform((h, m), -0.5, 1.0, torch.float32))
        self.ln_x = Norm(cfg, d, device=dev)
        # channel-mix
        self.cm_mu = _param(uniform((2, d), 0.25, 0.5, pd))
        self.cm_k = dense((d, cfg.d_ff))
        self.cm_v = dense((cfg.d_ff, d))
        self.cm_r = dense((d, d))
        # pre-norms for the two sub-blocks
        self.ln1 = Norm(cfg, d, device=dev)
        self.ln2 = Norm(cfg, d, device=dev)

    def forward(self, x: Tensor, *, cache: dict | None = None, chunked: bool | None = None):
        return rwkv6_apply(self, x, self.cfg, cache=cache, chunked=chunked)


def rwkv6_init(gen: torch.Generator | None, cfg: ModelConfig, *, device=None) -> RWKV6:
    return RWKV6(cfg, gen, device=device)


def _wkv_scan(r, k, v, w, u, state):
    """Sequential recurrence.  r,k,v: [B,S,H,M]; w: [B,S,H,M] decay in (0,1);
    u: [H,M]; state: [B,H,M,M] (key dim first).  Returns (out, new_state)."""
    s = state
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]   # [B,H,M] each
        kv = kt[..., :, None] * vt[..., None, :]             # [B,H,M,M]
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, s + u[None, :, :, None] * kv))
        s = wt[..., None] * s + kv
    return torch.stack(outs, dim=1), s                      # [B,S,H,M]


def _wkv_chunked(r, k, v, w, u, state, chunk: int = 64):
    """Chunked equivalent of :func:`_wkv_scan` (matmul-dominated).

    Within a chunk of length Q: decay products D_t = prod_{i<=t} w_i let the
    intra-chunk term become a masked (r D_t / D_j) k_j^T matmul; the carried
    state contributes r_t D_t S.  fp32 throughout; w is clamped away from 0.
    """
    B, S, H, M = r.shape
    pad = (-S) % chunk
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    L = r.shape[1] // chunk
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device),
                      diagonal=-1)                          # strict lower
    s = state.float()
    ys = []
    for c in range(L):
        sl = slice(c * chunk, (c + 1) * chunk)
        rq, kq, vq, wq = (t[:, sl].float() for t in (r, k, v, w))   # [B,Q,H,M]
        logw = torch.log(torch.clamp(wq, 1e-6, 1.0))
        cum = torch.cumsum(logw, dim=1)                     # log D_t (incl. t)
        # intra-chunk (j < t): A[t,j] = r_t . (D_{t-1} / D_j) k_j
        r_d = rq * torch.exp(cum - logw)                    # r_t D_{t-1}
        k_d = kq * torch.exp(-cum)                          # k_j / D_j
        att = torch.einsum("bqhm,bjhm->bhqj", r_d, k_d)
        att = torch.where(mask[None, None], att, 0.0)
        y = torch.einsum("bhqj,bjhm->bqhm", att, vq)
        # bonus diagonal: u * (r_t . k_t) v_t
        y = y + torch.einsum("bqhm,bqhm->bqh", rq, u[None, None] * kq)[..., None] * vq
        # carried state: r_t D_{t-1} S, S the pre-chunk state
        y = y + torch.einsum("bqhk,bhkv->bqhv", r_d, s)
        # new state: S' = D_Q S + sum_j (D_Q/D_j) k_j v_j
        k_end = kq * torch.exp(cum[:, -1:] - cum)
        s = s * torch.exp(cum[:, -1])[..., None] + torch.einsum(
            "bjhk,bjhv->bhkv", k_end, vq)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], s


def rwkv6_apply(p: RWKV6, x: Tensor, cfg: ModelConfig, *, cache: dict | None = None,
                chunked: bool | None = None):
    """Time-mix + channel-mix (residuals internal).  x: [B,S,D] -> (y, cache).

    The returned y is the full block output: the LM must NOT add another
    residual around this block.  Inside :func:`placement.model_split
    <repro_torch.dist.placement.model_split>` each mix computes this rank's
    share (:func:`rwkv6_time_mix`, :func:`rwkv6_channel_mix`); a cache's
    ``wkv_state`` then comes back holding the rank's heads."""
    y_tm, xin, new_state = rwkv6_time_mix(p, x, cfg, cache=cache, chunked=chunked)
    x = x + y_tm
    y_cm, xc = rwkv6_channel_mix(p, x, cfg, cache=cache)
    y = x + y_cm

    new_cache = None
    if cache is not None:
        new_cache = {
            "shift_tm": xin[:, -1:],   # last time-mix INPUT token
            "shift_cm": xc[:, -1:],    # last channel-mix INPUT token
            "wkv_state": new_state,
        }
    return y, new_cache


def _share(cfg: ModelConfig, key: str) -> tuple | None:
    """``(r, tp, group)`` inside :func:`placement.model_split
    <repro_torch.dist.placement.model_split>` where :func:`tp_plan` splits
    ``key``, else None."""
    part = placement.model_part()
    return part if part is not None and tp_plan(cfg, part[1])[key] else None


def rwkv6_time_mix(p: RWKV6, x: Tensor, cfg: ModelConfig, *, cache: dict | None = None,
                   chunked: bool | None = None):
    """The time mix's output (before the residual), its normed input
    ``xin`` and the new WKV state: (y [B,S,D], xin, state).

    Where :func:`tp_plan` splits ``rwkv_heads`` over ``"model"``, share
    ``r`` of ``tp`` computes its ``h / tp`` heads, i.e. the ``D / tp``
    channels ``C_r`` from ``r · D / tp`` on: r, k, v and g from those
    columns of ``wr``, ``wk``, ``wv`` and ``wg``, the decay from those
    columns of ``decay_w2`` and entries of ``w0``, the bonus ``u``'s rows
    of its heads, ``ln_x`` on ``C_r`` (the norm is per head), the WKV
    recurrence on ``[B, S, h / tp, m]`` from the state's rows of those
    heads (a cache's state holding only the share's heads is taken as it
    is), and the output over ``wo``'s rows ``C_r``, summed over the group
    (Megatron's ``g``).  The token-shift mixes and both LoRAs are computed
    whole on every rank from ``xin`` put through Megatron's ``f`` (one
    all-reduce of its gradient), so every weight the share uses (``mu``,
    ``mix_w1``, ``mix_w2``, ``decay_w1`` whole, the split ones by their
    share) has a gradient holding this share's part alone and is marked
    :func:`placement.sum_over_model
    <repro_torch.dist.placement.sum_over_model>`; ``ln1``, before the
    ``f``, is not.  The returned state then holds the share's heads."""
    B, S, D = x.shape
    h = cfg.n_heads
    m = D // h
    if chunked is None:
        chunked = S >= 256
    share = _share(cfg, "rwkv_heads")
    xin = norm_apply(p.ln1, x, cfg)
    xs, group = xin, None
    wr, wk, wv, wg, wo, w0, decay_w2, u, ln_scale = (
        p.wr, p.wk, p.wv, p.wg, p.wo, p.w0, p.decay_w2, p.u, p.ln_x.scale)
    if share is not None:
        r_, tp, group = share
        xs = placement.copy_to_group(xin, group)
        for w in (p.mu, p.mix_w1, p.mix_w2, p.decay_w1, wr, wk, wv, wg, wo, w0, decay_w2, u,
                  ln_scale):
            placement.sum_over_model(w)
        cols = slice(r_ * D // tp, (r_ + 1) * D // tp)
        heads = slice(r_ * h // tp, (r_ + 1) * h // tp)
        wr, wk, wv, wg, decay_w2 = (w[:, cols] for w in (wr, wk, wv, wg, decay_w2))
        wo, w0, ln_scale, u = wo[cols], w0[cols], ln_scale[cols], u[heads]
        h, D = h // tp, D // tp

    last_tm = cache["shift_tm"].to(xs.dtype) if cache else xs.new_zeros((B, 1, x.shape[2]))
    sx = torch.cat([last_tm, xs[:, :-1]], dim=1) - xs        # shifted minus x
    base = xs + sx * p.mu[0].to(xs.dtype)
    lora = torch.tanh(base @ p.mix_w1.to(xs.dtype)).view(B, S, 5, MIX_R)
    # the five [B,S,D] mixes one at a time (the reference's order)
    w2 = p.mix_w2.to(xs.dtype)                              # [5, R, D]
    mu = p.mu.to(xs.dtype)                                  # [5, D]
    xr, xk, xv, xg, xw = (xs + sx * (mu[i] + lora[:, :, i] @ w2[i]) for i in range(5))

    def hs(t):
        return shd.shard(t, "batch", None, "heads", None)

    r = hs((xr @ wr.to(x.dtype)).view(B, S, h, m))
    k = hs((xk @ wk.to(x.dtype)).view(B, S, h, m))
    v = hs((xv @ wv.to(x.dtype)).view(B, S, h, m))
    g = shd.shard(F.silu(xg @ wg.to(x.dtype)), "batch", None, "ffn")
    dec = w0 + (torch.tanh(xw @ p.decay_w1.to(x.dtype)) @ decay_w2.to(x.dtype)).float()
    w = hs(torch.exp(-torch.exp(dec)).view(B, S, h, m))     # (0,1)

    if cache:
        state = cache["wkv_state"]
        if share is not None and state.shape[1] != h:       # every head: the share's rows
            state = state[:, heads]
    else:
        state = torch.zeros((B, h, m, m), dtype=torch.float32, device=x.device)
    rf, kf, vf = r.float(), k.float(), v.float()
    if chunked and S > 1:
        out, new_state = _wkv_chunked(rf, kf, vf, w, u, state)
    else:
        out, new_state = _wkv_scan(rf, kf, vf, w, u, state)
    out = _head_norm(ln_scale, out.reshape(B, S, D), h).to(x.dtype) * g
    out = shd.shard(out, "batch", None, "ffn")
    y = placement.all_reduce_sum(out @ wo.to(x.dtype), group)
    return shd.shard(y, "batch", None, "model_embed"), xin, new_state


def rwkv6_channel_mix(p: RWKV6, x: Tensor, cfg: ModelConfig, *, cache: dict | None = None):
    """The channel mix's output (before the residual) and its normed input
    ``xc``: (y [B,S,D], xc).

    Where :func:`tp_plan` splits ``rwkv_cm_ffn`` over ``"model"``, share
    ``r`` of ``tp`` computes its ``d_ff / tp`` columns of the key (``cm_k``)
    and the matching rows of ``cm_v``, summed over the group (Megatron's
    ``g``) before the product with ``sigmoid(xr2 @ cm_r)``, which every
    rank computes whole.  The key's input ``xk2`` goes through Megatron's
    ``f``, so ``cm_mu`` (whose row 0 makes ``xk2`` and row 1 the whole
    ``xr2``) keeps a whole gradient and only ``cm_k`` and ``cm_v`` are
    marked :func:`placement.sum_over_model
    <repro_torch.dist.placement.sum_over_model>`."""
    B, S, D = x.shape
    share = _share(cfg, "rwkv_cm_ffn")
    xc = norm_apply(p.ln2, x, cfg)
    last_cm = cache["shift_cm"].to(xc.dtype) if cache else xc.new_zeros((B, 1, D))
    sx2 = torch.cat([last_cm, xc[:, :-1]], dim=1) - xc
    xk2 = xc + sx2 * p.cm_mu[0].to(xc.dtype)
    xr2 = xc + sx2 * p.cm_mu[1].to(xc.dtype)
    cm_k, cm_v, group = p.cm_k, p.cm_v, None
    if share is not None:
        r_, tp, group = share
        f = cm_k.shape[1]
        cols = slice(r_ * f // tp, (r_ + 1) * f // tp)
        xk2 = placement.copy_to_group(xk2, group)
        cm_k = placement.sum_over_model(cm_k)[:, cols]
        cm_v = placement.sum_over_model(cm_v)[cols]
    kk = shd.shard(torch.square(F.relu(xk2 @ cm_k.to(x.dtype))), "batch", None, "ffn")
    cmix = torch.sigmoid(xr2 @ p.cm_r.to(x.dtype)) * placement.all_reduce_sum(
        kk @ cm_v.to(x.dtype), group)
    return shd.shard(cmix, "batch", None, "model_embed"), xc


def rwkv6_cache_init(cfg: ModelConfig, batch: int, *, device=None) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    m = d // h
    return {
        "shift_tm": torch.zeros((batch, 1, d), dtype=cfg.act_dtype, device=device),
        "shift_cm": torch.zeros((batch, 1, d), dtype=cfg.act_dtype, device=device),
        "wkv_state": torch.zeros((batch, h, m, m), dtype=torch.float32, device=device),
    }
