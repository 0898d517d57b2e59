"""Whisper-style encoder-decoder backbone, the audio frontend a stub
(counterpart of :mod:`repro.models.whisper`).

The conv/mel frontend is not modeled: the inputs carry precomputed frame
embeddings ``[B, n_frames, D]`` (1,500 frames for whisper-small's 30 s
window).  The transformer backbone is real:

  encoder: bidirectional attention blocks over the frames
  decoder: causal self-attention + cross-attention to the encoder output + MLP

Serving runs the encoder once (:func:`whisper_cache_init`), keeps each
decoder layer's cross-attention K/V, and decodes with a self-attention KV
cache written in place, as :mod:`repro_torch.models.lm` does.
"""
from __future__ import annotations

import torch
from torch import Tensor, nn

from repro_torch.device import resolve_device
from repro_torch.dist import placement
from repro_torch.dist import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MLP, Attention, Norm, _param, attn_apply,
                                       checkpointed, dense_init, mlp_apply, norm_apply)
from repro_torch.models.lm import _flat, _layer_leaves

__all__ = ["Whisper", "whisper_init", "encode", "whisper_forward", "whisper_cache_init",
           "whisper_decode_step"]


class EncLayer(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``mlp``."""

    gathers_own_params = True

    def __init__(self, cfg: ModelConfig, gen=None, *, device=None):
        super().__init__()
        self.ln1 = Norm(cfg, device=device)
        self.attn = Attention(cfg, gen, device=device)
        self.ln2 = Norm(cfg, device=device)
        self.mlp = MLP(cfg, gen, device=device)


class DecLayer(nn.Module):
    """``ln1``, ``self`` (self-attention), ``ln2``, ``cross``, ``ln3``,
    ``mlp``: the reference's names."""

    gathers_own_params = True

    def __init__(self, cfg: ModelConfig, gen=None, *, device=None):
        super().__init__()
        self.ln1 = Norm(cfg, device=device)
        self.add_module("self", Attention(cfg, gen, device=device))
        self.ln2 = Norm(cfg, device=device)
        self.cross = Attention(cfg, gen, device=device)
        self.ln3 = Norm(cfg, device=device)
        self.mlp = MLP(cfg, gen, device=device)


class Whisper(nn.Module):
    """``embed.table``, ``enc`` and ``dec`` (one layer module each),
    ``enc_norm``, ``final_norm`` and ``lm_head.w`` (absent with tied
    embeddings).  ``gen=None`` leaves the weights uninitialized on
    ``device``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None, *,
                 device=None):
        super().__init__()
        dev = gen.device if gen is not None else device
        self.cfg = cfg
        self.embed = nn.ParameterDict({"table": _param(dense_init(
            gen, (cfg.vocab, cfg.d_model), cfg.p_dtype, scale=0.02, device=dev))})
        self.enc = nn.ModuleList(EncLayer(cfg, gen, device=dev)
                                 for _ in range(cfg.encoder_layers))
        self.dec = nn.ModuleList(DecLayer(cfg, gen, device=dev) for _ in range(cfg.n_layers))
        self.enc_norm = Norm(cfg, device=dev)
        self.final_norm = Norm(cfg, device=dev)
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = nn.ParameterDict({"w": _param(dense_init(
                gen, (cfg.d_model, cfg.vocab), cfg.p_dtype, device=dev))})

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device


def whisper_init(gen: torch.Generator | int, cfg: ModelConfig, *, device=None) -> Whisper:
    """A randomly initialized encoder-decoder (``gen`` as in
    :func:`~repro_torch.models.lm.lm_init`)."""
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(resolve_device(device)).manual_seed(int(gen))
    return Whisper(cfg, gen)


def _enc_block(p: EncLayer, x: Tensor, cfg: ModelConfig) -> Tensor:
    a, _ = attn_apply(p.attn, norm_apply(p.ln1, x, cfg), cfg, causal=False)
    x = x + a
    return x + mlp_apply(p.mlp, norm_apply(p.ln2, x, cfg), cfg)


def _dec_block(p: DecLayer, x: Tensor, enc_kv, cfg: ModelConfig, cache=None,
               cache_len=None):
    a, new_self = attn_apply(
        getattr(p, "self"), norm_apply(p.ln1, x, cfg), cfg,
        cache=None if cache is None else cache["self"], cache_len=cache_len)
    x = x + a
    c, _ = attn_apply(p.cross, norm_apply(p.ln2, x, cfg), cfg,
                      kv_override=enc_kv, causal=False, cache_len=cache_len)
    x = x + c
    x = x + mlp_apply(p.mlp, norm_apply(p.ln3, x, cfg), cfg)
    return x, None if cache is None else {"self": new_self}


def _cross_kv(p: DecLayer, enc_out: Tensor, cfg: ModelConfig):
    """Cross-attention K/V ``[B, Se, KV, Dh]`` of one layer from the
    encoder output."""
    B, Se, D = enc_out.shape
    at = p.cross
    kv, dh = at.wk.shape[1], at.wk.shape[2]
    k = (enc_out @ at.wk.to(enc_out.dtype).reshape(D, kv * dh)).view(B, Se, kv, dh)
    v = (enc_out @ at.wv.to(enc_out.dtype).reshape(D, kv * dh)).view(B, Se, kv, dh)
    if at.bk is not None:
        k = k + at.bk.to(enc_out.dtype)
        v = v + at.bv.to(enc_out.dtype)
    return k, v


def encode(params: Whisper, frames, cfg: ModelConfig) -> Tensor:
    """frames [B, Se, D] -> encoder output [B, Se, D].  With ``cfg.remat``
    and gradients on, each layer is checkpointed (as the reference's
    scanned body is)."""
    x = torch.as_tensor(frames, device=params.device).to(cfg.act_dtype)
    x = shd.shard(x, "batch", None, "model_embed")
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params.enc:
        x = checkpointed(placement.gathered_call, remat, _enc_block, lp, x, cfg)
    return norm_apply(params.enc_norm, x, cfg)


def _embed(params: Whisper, tokens, cfg: ModelConfig) -> Tensor:
    tokens = torch.as_tensor(tokens, device=params.device)
    return shd.shard(params.embed["table"][tokens].to(cfg.act_dtype),
                     "batch", None, "model_embed")


def _dec_layer(p: DecLayer, x: Tensor, enc_out: Tensor, cfg: ModelConfig) -> Tensor:
    """One decoder layer of the teacher-forced pass, its cross K/V
    included (the reference's checkpointed body)."""
    return _dec_block(p, x, _cross_kv(p, enc_out, cfg), cfg)[0]


def whisper_forward(params: Whisper, frames, tokens, cfg: ModelConfig):
    """Teacher-forced pass -> (hidden [B, St, D], None, aux = 0).  With
    ``cfg.remat`` and gradients on, each layer is checkpointed."""
    enc_out = encode(params, frames, cfg)
    x = _embed(params, tokens, cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params.dec:
        x = checkpointed(placement.gathered_call, remat, _dec_layer, lp, x, enc_out, cfg)
    x = norm_apply(params.final_norm, x, cfg)
    return x, None, torch.zeros((), dtype=torch.float32, device=x.device)


def whisper_cache_init(params: Whisper, frames, cfg: ModelConfig, batch: int,
                       max_seq: int) -> list:
    """Run the encoder once; one ``{"self": {"k", "v"}, "cross_k",
    "cross_v"}`` per decoder layer."""
    enc_out = encode(params, frames, cfg)
    kv, dh = cfg.n_kv_heads * cfg.kv_repeat, cfg.head_dim
    dev = params.device

    def per_layer(lp):
        ck, cv = _cross_kv(lp, enc_out, cfg)
        return {"self": {n: torch.zeros((batch, max_seq, kv, dh), dtype=cfg.act_dtype,
                                        device=dev) for n in ("k", "v")},
                "cross_k": ck, "cross_v": cv}

    return [per_layer(lp) for lp in params.dec]


def whisper_decode_step(params: Whisper, tokens, cfg: ModelConfig, cache: list,
                        cache_len: int):
    """tokens [B, S] -> (hidden [B, S, D], new cache).  The self-attention
    K/V are written into the cache's tensors in place; the returned list
    is a new one.  On a mesh each layer gathers its own parameters."""
    x = _embed(params, tokens, cfg)
    new_cache = []
    for lp, lc in zip(params.dec, cache, strict=True):
        x, nc = placement.gathered_call(_dec_block, lp, x, (lc["cross_k"], lc["cross_v"]),
                                        cfg, cache=lc, cache_len=cache_len)
        new_cache.append(dict(lc, self=nc["self"]))
    x = norm_apply(params.final_norm, x, cfg)
    return x, new_cache


def _reference_leaves(params_np: dict, cfg: ModelConfig) -> dict:
    """The reference's Whisper pytree as the port's ``named_parameters``
    names: its ``enc`` and ``dec`` runs (stacked ``[count, ...]`` under
    ``lax.scan``) unstacked into ``enc.<layer>`` and ``dec.<layer>``, the
    other trees kept as they are."""
    leaves = dict(_flat({k: v for k, v in params_np.items() if k not in ("enc", "dec")}))
    for part, count in (("enc", cfg.encoder_layers), ("dec", cfg.n_layers)):
        for j in range(count):
            leaves.update(_layer_leaves(params_np[part], j, cfg.use_scan, f"{part}.{j}."))
    return leaves


def _reference_paths(names, cfg: ModelConfig) -> dict:
    """Each of the port's parameter ``names`` mapped to the reference's
    ``/``-joined path of its leaf (the inverse of
    :func:`_reference_leaves`): ``enc.<j>.<rest>`` to ``enc/<rest>`` under
    ``lax.scan`` (one stacked leaf) or ``enc/<j>/<rest>``, and ``dec``
    alike; the other trees with their dots as slashes."""
    out = {}
    for name in names:
        parts = name.split(".")
        if parts[0] in ("enc", "dec") and cfg.use_scan:
            parts = [parts[0], *parts[2:]]
        out[name] = "/".join(parts)
    return out


def _reference_stacked(names, cfg: ModelConfig) -> dict:
    """{name: the run's layer count} of the ``names`` whose reference leaf
    stacks the ``enc`` or ``dec`` run's layers (one dim more than the
    port's parameter)."""
    count = {"enc": cfg.encoder_layers, "dec": cfg.n_layers}
    return {n: count[n.split(".")[0]] for n in names
            if n.split(".")[0] in ("enc", "dec") and cfg.use_scan}
