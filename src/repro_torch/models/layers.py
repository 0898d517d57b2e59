"""Shared neural-net layers: norms, RoPE, GQA flash attention, GLU MLPs
(counterpart of :mod:`repro.models.layers`).

PyTorch idiom: each layer is an ``nn.Module`` (:class:`Norm`,
:class:`Attention`, :class:`MLP`) whose parameters carry the reference's
names and layouts (``wq [d, h, dh]``, ``wo [h, dh, d]``, ``w_up [d, f]``,
...), so carrying the reference's weights across is a copy
(:func:`repro_torch.models.lm.params_from_reference`).  The reference's
functions keep their names: ``<layer>_init(gen, cfg, ...)`` builds the
module from a ``torch.Generator`` and ``<layer>_apply(p, x, cfg, ...)``
runs it, ``p`` being the module (its ``forward`` calls the same function).

Attention is the reference's chunked online-softmax ("flash") attention in
plain torch ops (matmul, max, exp): memory stays O(chunk_q * chunk_k) per
head whatever the sequence length, causal and sliding-window masks are
applied per tile, and the softmax statistics are fp32.  It is pure JAX in
the reference, not a Pallas kernel.  The reference's ``shd.shard``
annotations stand where it has them; they are the identity on the local
tensors the port computes on (:mod:`repro_torch.dist.sharding`).  What
they make GSPMD split over ``"model"`` the port computes per rank inside
:func:`placement.model_split <repro_torch.dist.placement.model_split>`:
attention's query heads and KV heads and the MLP's ffn columns, where
:func:`tp_plan` (the reference's ``sanitize`` of those annotations) splits
them (the head's ``"vocab"`` columns split in
:mod:`repro_torch.models.lm`, rwkv6's and the SSD's heads in
:mod:`~repro_torch.models.rwkv` and :mod:`~repro_torch.models.ssm`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import Tensor, nn

from repro_torch.dist import placement
from repro_torch.dist import sharding as shd
from repro_torch.models.config import ModelConfig

__all__ = ["checkpointed", "dense_init", "Norm", "norm_init", "norm_apply", "rope_freqs",
           "rope_apply", "Attention", "attn_init", "flash_attention", "attn_apply", "MLP",
           "mlp_init", "mlp_apply", "tp_plan"]


def _param(t: Tensor) -> nn.Parameter:
    """A weight, made without a gradient: serving keeps none.  Training
    turns gradients on for the whole model with ``requires_grad_()``
    (:func:`repro_torch.train.train_step.init_state`)."""
    return nn.Parameter(t, requires_grad=False)


def checkpointed(fn, on: bool, *args, **kw):
    """``fn(*args, **kw)``, under ``torch.utils.checkpoint`` when ``on``:
    the backward pass recomputes the activations inside ``fn`` instead of
    keeping them (the reference's ``jax.checkpoint`` of a layer body).  The
    models draw no random numbers, so no RNG state is saved."""
    if not on:
        return fn(*args, **kw)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False, **kw)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator | None, shape, dtype, scale: float | None = None, *,
               device=None) -> Tensor:
    """Normal weights of std ``scale`` (default ``1/sqrt(shape[0])``, the
    fan-in of ``[d, ...]`` projections) drawn from ``gen``, on its device.
    ``gen=None`` leaves them uninitialized on ``device``, for weights about
    to be copied in."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=gen, device=gen.device) * std).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """RMSNorm or LayerNorm (``cfg.norm_kind``): ``scale`` (and ``bias``)."""

    def __init__(self, cfg: ModelConfig, d: int | None = None, *, device=None):
        super().__init__()
        d = d or cfg.d_model
        self.cfg = cfg
        self.scale = _param(torch.ones(d, dtype=cfg.p_dtype, device=device))
        self.bias = (_param(torch.zeros(d, dtype=cfg.p_dtype, device=device))
                     if cfg.norm_kind == "layernorm" else None)

    def forward(self, x: Tensor) -> Tensor:
        return norm_apply(self, x, self.cfg)


def norm_init(cfg: ModelConfig, d: int | None = None, *, device=None) -> Norm:
    return Norm(cfg, d, device=device)


def norm_apply(p: Norm, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Normalizes in fp32 and returns ``x``'s dtype."""
    xf = x.float()
    if cfg.norm_kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        y = y * p.scale.float() + p.bias.float()
    else:
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p.scale.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(cfg: ModelConfig, dh: int | None = None, *, device=None) -> Tensor:
    dh = dh or cfg.head_dim
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh
    return 1.0 / (cfg.rope_theta ** exps)  # [dh/2]


def rope_apply(x: Tensor, positions: Tensor, inv_freq: Tensor) -> Tensor:
    """x: [..., S, H, Dh]; positions broadcastable to [..., S]."""
    ang = positions[..., None].float() * inv_freq  # [..., S, dh/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA self-attention weights: ``wq [d, h, dh]``, ``wk``/``wv [d, kv,
    dh]``, ``wo [h, dh, d]``, and ``bq``/``bk``/``bv`` with
    ``cfg.qkv_bias``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None, *,
                 device=None):
        super().__init__()
        d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dev = gen.device if gen is not None else device
        self.cfg = cfg
        self.wq = _param(dense_init(gen, (d, h, dh), cfg.p_dtype, device=dev))
        self.wk = _param(dense_init(gen, (d, kv, dh), cfg.p_dtype, device=dev))
        self.wv = _param(dense_init(gen, (d, kv, dh), cfg.p_dtype, device=dev))
        self.wo = _param(dense_init(gen, (h, dh, d), cfg.p_dtype,
                                    scale=1.0 / math.sqrt(h * dh), device=dev))
        self.bq = self.bk = self.bv = None
        if cfg.qkv_bias:
            self.bq = _param(torch.zeros(h, dh, dtype=cfg.p_dtype, device=dev))
            self.bk = _param(torch.zeros(kv, dh, dtype=cfg.p_dtype, device=dev))
            self.bv = _param(torch.zeros(kv, dh, dtype=cfg.p_dtype, device=dev))

    def forward(self, x: Tensor, **kw):
        return attn_apply(self, x, self.cfg, **kw)


def attn_init(gen: torch.Generator | None, cfg: ModelConfig, *, device=None) -> Attention:
    return Attention(cfg, gen, device=device)


def _tile_mask(q_pos: Tensor, k_pos: Tensor, causal: bool, window: int | None) -> Tensor:
    """[Q, K] bool mask tile from absolute positions."""
    d = q_pos[:, None] - k_pos[None, :]
    m = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        m &= d >= 0
    if window is not None:
        m &= d < window
    return m


def flash_attention(
    q: Tensor, k: Tensor, v: Tensor, *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    chunk_q: int = 512,
    chunk_k: int = 1024,
    kv_valid: Tensor | None = None,
) -> Tensor:
    """Chunked online-softmax attention.

    q: [B, Sq, H, Dh];  k/v: [B, Sk, KV, Dh] with H % KV == 0; query head
    ``h`` reads KV head ``h // (H // KV)`` (the reference's ``jnp.repeat``).
    ``q_offset``: absolute position of q[0] (cross/self decode alignment).
    ``kv_valid``: [B, Sk] bool — masks cache padding.
    Returns [B, Sq, H, Dh] in q.dtype; softmax in fp32.

    The reference's double scan becomes a double loop, q chunks outer and
    kv chunks inner, with the same tiles and the same update per tile.
    Each tile is one batched matmul per KV head over its ``g`` query heads
    (``[g·cq, Dh] @ [Dh, ck]``), so the repeated K/V are never written.

    Memory law (the reference's ``jax.checkpoint(kv_step)``): when autograd
    will differentiate the call, each key tile's step runs under
    :func:`checkpointed`, so the backward keeps per tile only the step's
    inputs (the running ``m``, ``l`` and ``acc``; the K/V tile and its
    ``kv_valid`` slice are views, the fp32 query chunk is shared by the
    chunk's tiles) and
    recomputes the tile's ``[g·cq, ck]`` scores and probabilities; no score
    tile is stored.  Under a layer's :func:`checkpointed` the checkpoints
    nest: the layer's recompute keeps only the tiles' carries.  Without
    grad (serving, decode, prefill) the same steps run with no checkpoint.
    """
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    g = H // KV
    cq, ck = min(chunk_q, Sq), min(chunk_k, Sk)
    # pad to tile multiples
    pq, pk = (-Sq) % cq, (-Sk) % ck
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
    kvv = kv_valid
    if pk or kvv is not None:
        base = (torch.ones((B, Sk), dtype=torch.bool, device=q.device) if kvv is None
                else kvv)
        kvv = F.pad(base, (0, pk))
    nq, nk = q.shape[1] // cq, k.shape[1] // ck
    scale = 1.0 / math.sqrt(Dh)
    dev = q.device

    qg = q.view(B, nq * cq, KV, g, Dh).permute(0, 2, 3, 1, 4)   # [B,KV,g,Sq',Dh]
    kt = k.permute(0, 2, 1, 3)                                 # [B,KV,Sk',Dh]
    vt = v.permute(0, 2, 1, 3)
    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    out = torch.empty((B, KV, g, nq * cq, Dh), dtype=q.dtype, device=dev)
    for i in range(nq):
        qs = slice(i * cq, (i + 1) * cq)
        qf = qg[:, :, :, qs].float().reshape(B, KV, g * cq, Dh)
        m_run = torch.full((B, KV, g, cq), float("-inf"), device=dev)
        l_run = torch.zeros((B, KV, g, cq), device=dev)
        acc = torch.zeros((B, KV, g, cq, Dh), device=dev)
        for j in range(nk):
            ks = slice(j * ck, (j + 1) * ck)
            # everything that varies over the loops is an argument: the
            # backward's recompute runs after the loops have moved on
            m_run, l_run, acc = checkpointed(
                _kv_step, remat, m_run, l_run, acc, qf, kt[:, :, ks], vt[:, :, ks],
                None if kvv is None else kvv[:, ks], q_offset + i * cq, j * ck,
                causal, window, scale)
        out[:, :, :, qs] = (acc / l_run.clamp(min=1e-30)[..., None]).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, nq * cq, H, Dh)[:, :Sq]


def _kv_step(m_run: Tensor, l_run: Tensor, acc: Tensor, qf: Tensor, kc: Tensor,
             vc: Tensor, kval: Tensor | None, q0: int, k0: int, causal: bool,
             window: int | None, scale: float):
    """One key tile of :func:`flash_attention`'s online softmax: the running
    max ``m_run`` and sum ``l_run`` ``[B,KV,g,cq]`` and ``acc [B,KV,g,cq,Dh]``
    updated by the tile ``kc``/``vc [B,KV,ck,Dh]`` (cast to fp32 here, so a
    checkpoint keeps the tile's own storage) against ``qf [B,KV,g·cq,Dh]``
    fp32; ``kval [B, ck]`` the tile's ``kv_valid`` slice, ``q0``/``k0`` the
    absolute positions of the chunk's first query and the tile's first key
    (ints, so a checkpoint keeps no position tensors)."""
    B, KV, g, cq, Dh = acc.shape
    ck = kc.shape[2]
    kc, vc = kc.float(), vc.float()
    s = torch.matmul(qf, kc.transpose(-1, -2)).view(B, KV, g, cq, ck) * scale
    mask = _tile_mask(torch.arange(q0, q0 + cq, device=qf.device),
                      torch.arange(k0, k0 + ck, device=qf.device), causal, window)
    if kval is not None:
        mask = mask & kval[:, None, None, None, :]
    # one kernel: an out-of-place masked_fill is a copy and a fill
    s = torch.where(mask, s, float("-inf"))
    m_new = torch.maximum(m_run, s.amax(-1))
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    # masked entries are -inf, so exp leaves them 0 (the reference's
    # where(mask, p, 0)); so does a row that nothing has reached yet
    p = torch.exp(s - m_safe[..., None])
    corr = torch.where(torch.isneginf(m_run), 0.0, torch.exp(m_run - m_safe))
    l_new = l_run * corr + p.sum(-1)
    pv = torch.matmul(p.view(B, KV, g * cq, ck), vc).view(B, KV, g, cq, Dh)
    return m_new, l_new, acc * corr[..., None] + pv


def attn_apply(
    p: Attention, x: Tensor, cfg: ModelConfig, *,
    positions: Tensor | None = None,
    cache: dict | None = None,
    cache_len: int | None = None,
    kv_override: tuple[Tensor, Tensor] | None = None,
    causal: bool = True,
):
    """Self-attention (or cross-attention via ``kv_override``).

    Training/prefill: ``cache=None`` — full-sequence flash attention.
    Decode: ``cache = {"k": [B,Smax,KV,Dh], "v": ...}`` with ``cache_len``
    (an int) the number of valid entries; x is [B, S, D] (S = 1 to decode,
    more to fill the cache).  The new K/V are written into the cache's
    tensors in place (the reference returns updated copies).  Returns
    (y, cache).

    Inside :func:`placement.head_split <repro_torch.dist.placement.head_split>`
    a cache (or ``kv_override``) that holds this rank's ``1/tp`` of the KV
    heads (``tp`` the ``"model"`` axis's size) is attended by this rank's
    query heads only: their contiguous share of the (padded, repeated)
    heads, the output projection over their rows of ``wo``, summed over
    ``"model"`` (Megatron's ``f`` and ``g``).  K/V that hold every head
    compute whole.

    Inside :func:`placement.model_split
    <repro_torch.dist.placement.model_split>` the cache-free self-attention
    computes this rank's share of the query heads where :func:`tp_plan`
    splits them (:func:`_attn_share`); otherwise it computes whole.
    """
    B, S, D = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    inv_freq = rope_freqs(cfg, device=x.device)
    share = placement.model_part() if cache is None and kv_override is None else None
    if share is not None and tp_plan(cfg, share[1])["heads"]:
        if positions is None:
            positions = torch.arange(S, device=x.device).expand(B, S)
        return _attn_share(p, x, cfg, positions, causal, inv_freq, share), cache
    split = placement.head_part()
    if split is not None:
        held = (cache["k"].shape[2] * split[1] == kv * cfg.kv_repeat if cache is not None
                else kv_override is not None and kv_override[0].shape[2] * split[1] == kv)
        split = split if held else None
    if split is not None:
        x = placement.copy_to_group(x, split[2])

    q = (x @ p.wq.to(x.dtype).reshape(D, h * dh)).view(B, S, h, dh)
    if p.bq is not None:
        q = q + p.bq.to(x.dtype)
    if kv_override is None:
        kx = (x @ p.wk.to(x.dtype).reshape(D, kv * dh)).view(B, S, kv, dh)
        vx = (x @ p.wv.to(x.dtype).reshape(D, kv * dh)).view(B, S, kv, dh)
        if p.bk is not None:
            kx = kx + p.bk.to(x.dtype)
            vx = vx + p.bv.to(x.dtype)
    else:
        kx, vx = kv_override

    if positions is None:
        offset = cache_len if cache_len is not None else 0
        positions = (torch.arange(S, device=x.device) + offset).expand(B, S)
    q = rope_apply(q, positions, inv_freq)
    if kv_override is None:
        kx = rope_apply(kx, positions, inv_freq)
    g_orig = h // kv
    g_pad = cfg.q_group_pad
    if g_pad is not None and g_pad > g_orig:
        # q-group padding: zero q-heads at each KV group's tail so the padded
        # head count shards over TP; their outputs are sliced off before wo,
        # so the outputs equal the unpadded model's (tested)
        qg = F.pad(q.view(B, S, kv, g_orig, dh), (0, 0, 0, g_pad - g_orig))
        q = qg.reshape(B, S, kv * g_pad, dh)
    if cfg.kv_repeat > 1:
        # Megatron-style KV replication (params stay at n_kv_heads)
        kx = kx.repeat_interleave(cfg.kv_repeat, dim=2)
        vx = vx.repeat_interleave(cfg.kv_repeat, dim=2)
    if split is not None:
        # this rank's query heads, and the new K/V of its KV heads (an
        # override already holds only those)
        r, tp, _ = split
        hq = q.shape[2] // tp
        q = q[:, :, r * hq:(r + 1) * hq]
        if kv_override is None:
            hk = kx.shape[2] // tp
            kx, vx = kx[:, :, r * hk:(r + 1) * hk], vx[:, :, r * hk:(r + 1) * hk]

    q = shd.shard(q, "batch", None, "heads", None)
    kx = shd.shard(kx, "batch", None, "kv_heads", None)
    vx = shd.shard(vx, "batch", None, "kv_heads", None)

    if cache is not None:
        idx = int(cache_len)
        smax = cache["k"].shape[1]
        ring = (cfg.sliding_window is not None and smax == cfg.sliding_window
                and S == 1)
        if ring:
            # rolling SWA buffer: slot = t mod W; every live slot is inside
            # the window by construction, RoPE was baked at write time, so
            # masking reduces to "slot is filled".
            write_at = idx % smax
            kvalid = (torch.arange(smax, device=x.device) < min(idx + 1, smax)).expand(B, smax)
            causal, window, q_off = False, None, 0
        else:
            if idx + S > smax:
                raise ValueError(f"cache of {smax} slots cannot take {S} more "
                                 f"after {idx}")
            write_at = idx
            # causal across the cache: q row t attends to kv <= idx + t (and
            # within the window)
            kvalid = (torch.arange(smax, device=x.device) < idx + S).expand(B, smax)
            causal, window, q_off = True, cfg.sliding_window, idx
        cache["k"][:, write_at:write_at + S] = kx
        cache["v"][:, write_at:write_at + S] = vx
        out = flash_attention(
            q, cache["k"].to(x.dtype), cache["v"].to(x.dtype),
            causal=causal, window=window, q_offset=q_off, kv_valid=kvalid,
            chunk_q=min(max(S, 8), cfg.attn_chunk_q), chunk_k=cfg.attn_chunk_k,
        )
    else:
        out = flash_attention(
            q, kx, vx, causal=causal, window=cfg.sliding_window,
            chunk_q=cfg.attn_chunk_q, chunk_k=cfg.attn_chunk_k,
        )
    if split is not None:
        y = _head_split_out(p, out, split, g_orig, g_pad, x.dtype)
    else:
        if g_pad is not None and g_pad > g_orig:
            out = out.reshape(B, S, kv, g_pad, dh)[:, :, :, :g_orig]
        y = out.reshape(B, S, h * dh) @ p.wo.to(x.dtype).reshape(h * dh, D)
    y = shd.shard(y, "batch", None, "model_embed")
    return y, cache


def tp_plan(cfg: ModelConfig, tp: int, d_ff: int | None = None) -> dict:
    """What splits over ``tp`` ranks of ``"model"`` (the reference's
    ``sanitize`` of its ``"heads"``, ``"kv_heads"``, ``"ffn"`` and
    ``"vocab"`` annotations: a dim ``tp`` divides splits, any other is
    whole): ``heads`` the padded query heads (``kv · q_group_pad``, or
    ``n_heads``), ``kv_heads`` the repeated KV heads (``kv · kv_repeat``),
    ``ffn`` the MLP's ``d_ff`` columns (``d_ff`` if given, else
    ``cfg.d_ff``), ``vocab`` the head's logit columns (``cfg.vocab``).
    Where the query heads stay whole the attention computes whole; KV
    heads that split while the query heads do not have no such layout, and
    raise.

    With an rwkv6 layer: ``rwkv_heads`` the time mix's ``n_heads`` (the
    ``"heads"`` of r, k, v and w), ``rwkv_ffn`` its ``d_model`` (the
    ``"ffn"`` of the gate and the gated output), ``rwkv_cm_ffn`` the
    channel mix's ``d_ff`` (the ``"ffn"`` of its key).  The time mix
    splits where its heads do; ``d_model = n_heads · m`` then splits too,
    so no layout of split heads over a whole ``d_model`` exists.  Where
    ``d_model`` splits and the heads do not (the reference then splits the
    gate alone) the time mix computes whole.  With a Mamba2 layer:
    ``ssd_heads`` its ``expand · d_model / head_dim`` heads (the
    ``"heads"`` of the cache-free SSD input)."""
    kv = cfg.n_kv_heads
    g = cfg.n_heads // kv
    heads = kv * max(cfg.q_group_pad or g, g)

    def splits(n):
        return tp > 1 and n % tp == 0

    plan = {"heads": splits(heads), "kv_heads": splits(kv * cfg.kv_repeat),
            "ffn": splits(d_ff or cfg.d_ff), "vocab": splits(cfg.vocab)}
    if plan["kv_heads"] and not plan["heads"]:
        raise ValueError(f"{kv * cfg.kv_repeat} KV heads split over {tp} ranks, "
                         f"{heads} query heads do not")
    if "rwkv6" in cfg.layer_types:
        plan.update(rwkv_heads=splits(cfg.n_heads), rwkv_ffn=splits(cfg.d_model),
                    rwkv_cm_ffn=splits(cfg.d_ff))
    if "mamba2" in cfg.layer_types:
        plan["ssd_heads"] = splits(cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim)
    return plan


def _attn_share(p: Attention, x: Tensor, cfg: ModelConfig, positions: Tensor,
                causal: bool, inv_freq: Tensor, share: tuple) -> Tensor:
    """This share's part of the cache-free self-attention over ``"model"``
    (``share = (r, tp, group)``), summed over the group: the query heads
    ``[r·hq, (r+1)·hq)`` of the padded order (``hq`` = padded heads / tp)
    from their own columns of ``wq`` (a padding head is a zero query), the
    K/V of their KV heads from those heads' columns of ``wk``/``wv`` where
    :func:`tp_plan` splits the KV heads, else whole and then the heads the
    share's queries read; the output projection over the share's rows of
    ``wo`` (:func:`_head_split_out`).  Each weight the share takes columns
    of is marked :func:`placement.sum_over_model
    <repro_torch.dist.placement.sum_over_model>`."""
    r, tp, group = share
    B, S, D = x.shape
    h, kv, dh, rep = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.kv_repeat
    g_orig = h // kv
    g_pad = max(cfg.q_group_pad or g_orig, g_orig)
    hq = kv * g_pad // tp
    ids = range(r * hq, (r + 1) * hq)                      # padded query heads
    real = [(i // g_pad) * g_orig + i % g_pad for i in ids if i % g_pad < g_orig]
    x = placement.copy_to_group(x, group)
    for w in (p.wq, p.wk, p.wv, p.wo, p.bq, p.bk, p.bv):
        placement.sum_over_model(w)

    def project(w, b, heads):
        idx = (slice(heads[0], heads[-1] + 1) if heads == list(range(heads[0], heads[-1] + 1))
               else heads)
        y = (x @ w[:, idx].to(x.dtype).reshape(D, len(heads) * dh)).view(B, S, len(heads), dh)
        return y if b is None else y + b[idx].to(x.dtype)

    if not real:                                          # a share of padding heads
        q = x.new_zeros(B, S, hq, dh)
    elif len(real) < hq:
        slots = torch.tensor([i - r * hq for i in ids if i % g_pad < g_orig],
                             dtype=torch.long, device=x.device)
        q = x.new_zeros(B, S, hq, dh).index_copy(
            2, slots, rope_apply(project(p.wq, p.bq, real), positions, inv_freq))
    else:
        q = rope_apply(project(p.wq, p.bq, real), positions, inv_freq)

    n_kv = kv * rep                                        # repeated KV heads
    if tp_plan(cfg, tp)["kv_heads"]:
        hk = n_kv // tp
        lo, hi = r * hk // rep, ((r + 1) * hk - 1) // rep + 1   # their own heads
        base = r * hk
    else:
        hk, lo, hi, base = n_kv, 0, kv, 0
    kx = rope_apply(project(p.wk, p.bk, list(range(lo, hi))), positions, inv_freq)
    vx = project(p.wv, p.bv, list(range(lo, hi)))
    if rep > 1:
        kx = kx.repeat_interleave(rep, dim=2)[:, :, base - lo * rep:base - lo * rep + hk]
        vx = vx.repeat_interleave(rep, dim=2)[:, :, base - lo * rep:base - lo * rep + hk]
    # the KV head each of the share's queries reads (the whole layer's query
    # head i reads repeated KV head i // G), as an index into kx
    G = kv * g_pad // n_kv
    reads = _reads_index([i // G - base for i in ids])
    kx, vx = kx[:, :, reads], vx[:, :, reads]

    out = flash_attention(q, kx, vx, causal=causal, window=cfg.sliding_window,
                          chunk_q=cfg.attn_chunk_q, chunk_k=cfg.attn_chunk_k)
    return _head_split_out(p, out, share, g_orig, g_pad, x.dtype)


def _reads_index(reads: list) -> slice | list:
    """The heads ``reads[j]`` that a share's ``j``-th head reads (K/V heads
    of its queries, B/C groups of its SSD heads), as an index into the read
    dim under which the layer repeats each read head onto its readers: the
    slice of the read heads where each is read by as many of the share's
    heads in turn, else the list, one read head per head."""
    n, k = len(reads), reads[-1] - reads[0] + 1
    if n % k == 0 and reads == [reads[0] + j // (n // k) for j in range(n)]:
        return slice(reads[0], reads[0] + k)
    return reads


def _head_split_out(p: Attention, out: Tensor, split: tuple, g_orig: int,
                    g_pad: int | None, dtype) -> Tensor:
    """The output projection of this rank's heads ``out [B, S, hq, dh]``
    (its ``hq`` consecutive heads of the padded order), summed over the
    split's group: the padding heads are dropped and each real head meets
    its own row of ``wo``."""
    B, S, hq, dh = out.shape
    r, _, group = split
    first = r * hq
    if g_pad is not None and g_pad > g_orig:
        ids = [i for i in range(first, first + hq) if i % g_pad < g_orig]
        out = out[:, :, [i - first for i in ids]]
        wo = p.wo[torch.tensor([(i // g_pad) * g_orig + i % g_pad for i in ids],
                               dtype=torch.long, device=out.device)]
    else:
        wo = p.wo[first:first + hq]
    n = out.shape[2]                    # 0 where every head of the share pads
    y = out.reshape(B, S, n * dh) @ wo.to(dtype).reshape(n * dh, p.wo.shape[-1])
    return placement.all_reduce_sum(y, group)


# ---------------------------------------------------------------------------
# MLP (GLU family)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """``w_up``/``w_gate [d, f]`` (the gate for swiglu and geglu) and
    ``w_down [f, d]``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None,
                 d_ff: int | None = None, *, device=None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        dev = gen.device if gen is not None else device
        self.cfg = cfg
        self.w_up = _param(dense_init(gen, (d, f), cfg.p_dtype, device=dev))
        self.w_down = _param(dense_init(gen, (f, d), cfg.p_dtype, device=dev))
        self.w_gate = (_param(dense_init(gen, (d, f), cfg.p_dtype, device=dev))
                       if cfg.mlp_kind in ("swiglu", "geglu") else None)

    def forward(self, x: Tensor) -> Tensor:
        return mlp_apply(self, x, self.cfg)


def mlp_init(gen: torch.Generator | None, cfg: ModelConfig, d_ff: int | None = None, *,
             device=None) -> MLP:
    return MLP(cfg, gen, d_ff, device=device)


def mlp_apply(p: MLP, x: Tensor, cfg: ModelConfig) -> Tensor:
    """GELU is the tanh form, ``jax.nn.gelu``'s default.

    Inside :func:`placement.model_split
    <repro_torch.dist.placement.model_split>`, where :func:`tp_plan` splits
    the ffn columns, this rank computes its ``d_ff / tp`` columns of
    ``up`` (and ``gate``) and the matching rows of ``down``, summed over
    the group (Megatron's ``f`` and ``g``)."""
    share = placement.model_part()
    f = p.w_up.shape[-1]
    if share is not None and tp_plan(cfg, share[1], f)["ffn"]:
        r, tp, group = share
        cols = slice(r * f // tp, (r + 1) * f // tp)
        x = placement.copy_to_group(x, group)
        w_up, w_down = (placement.sum_over_model(p.w_up)[:, cols],
                        placement.sum_over_model(p.w_down)[cols])
        w_gate = None if p.w_gate is None else placement.sum_over_model(p.w_gate)[:, cols]
    else:
        group, w_up, w_gate, w_down = None, p.w_up, p.w_gate, p.w_down
    up = shd.shard(x @ w_up.to(x.dtype), "batch", None, "ffn")
    if cfg.mlp_kind == "swiglu":
        hidden = F.silu(x @ w_gate.to(x.dtype)) * up
    elif cfg.mlp_kind == "geglu":
        hidden = F.gelu(x @ w_gate.to(x.dtype), approximate="tanh") * up
    else:
        hidden = F.gelu(up, approximate="tanh")
    y = placement.all_reduce_sum(hidden @ w_down.to(x.dtype), group)
    return shd.shard(y, "batch", None, "model_embed")
