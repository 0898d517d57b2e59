"""Uniform model interface over the three model kinds, lm / vlm / whisper
(counterpart of :mod:`repro.models.registry`).

    fns = model_fns(cfg)
    params = fns.init(seed, device)                       # an nn.Module
    hidden, cache, aux = fns.forward(params, batch)       # train/prefill
    cache = fns.cache_init(params, batch, bsz, max_seq)   # serving
    hidden, cache = fns.decode_step(params, tokens, cache, cache_len)

``batch`` is a dict: tokens/labels (+ patches | frames for vlm | whisper).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.shapes import model_kind
from repro_torch.device import resolve_device
from repro_torch.models import lm as lm_mod
from repro_torch.models import vlm as vlm_mod
from repro_torch.models import whisper as wh_mod
from repro_torch.models.config import ModelConfig

__all__ = ["ModelFns", "model_fns", "model_class", "reference_leaves", "reference_paths",
           "reference_ndims", "reference_shapes",
           "params_from_reference", "synthetic_batch"]

#: each kind's module and the map of the reference's parameter pytree onto
#: its parameter names (the leaves, their paths, the stacked ones)
_KINDS = {"lm": (lm_mod.LM, lm_mod._reference_leaves, lm_mod._reference_paths,
                 lm_mod._reference_stacked),
          "vlm": (vlm_mod.VLM, lm_mod._reference_leaves, lm_mod._reference_paths,
                  lm_mod._reference_stacked),
          "whisper": (wh_mod.Whisper, wh_mod._reference_leaves, wh_mod._reference_paths,
                      wh_mod._reference_stacked)}


@dataclasses.dataclass(frozen=True)
class ModelFns:
    cfg: ModelConfig
    kind: str
    init: Callable[..., Any]             # (seed, device=None) -> params
    forward: Callable[..., Any]          # (params, batch) -> (hidden, cache, aux)
    cache_init: Callable[..., Any]       # (params, batch, bsz, max_seq) -> cache
    decode_step: Callable[..., Any]      # (params, tokens, cache, cache_len)
    lm_head: Callable[..., Any]          # (params, hidden) -> logits
    loss_offset: Callable[[dict], int]   # #prefix positions excluded from loss


def model_class(cfg: ModelConfig) -> type:
    """The ``nn.Module`` that holds ``cfg``'s parameters."""
    return _KINDS[model_kind(cfg)][0]


def reference_leaves(params_np: dict, cfg: ModelConfig) -> dict:
    """The reference's parameter pytree (numpy leaves) of ``cfg``'s kind as
    the port's ``named_parameters`` names."""
    return _KINDS[model_kind(cfg)][1](params_np, cfg)


def reference_paths(model, cfg: ModelConfig) -> dict:
    """Each of ``model``'s parameter names mapped to the reference's
    ``/``-joined path of the leaf that :func:`reference_leaves` maps onto
    it (a scanned run's stacked leaf serves all its layers)."""
    return _KINDS[model_kind(cfg)][2]([n for n, _ in model.named_parameters()], cfg)


def reference_ndims(model, cfg: ModelConfig) -> dict:
    """Each of ``model``'s parameter names mapped to the number of dims of
    the reference's leaf: one more than the parameter's where the leaf
    stacks a scanned run's layers."""
    own = dict(model.named_parameters())
    stacked = _KINDS[model_kind(cfg)][3](list(own), cfg)
    return {n: p.ndim + (n in stacked) for n, p in own.items()}


def reference_shapes(model, cfg: ModelConfig) -> dict:
    """Each of ``model``'s parameter names mapped to the shape of the
    reference's leaf: the parameter's, led by the run's layer count where
    the leaf stacks a scanned run's layers."""
    own = dict(model.named_parameters())
    stacked = _KINDS[model_kind(cfg)][3](list(own), cfg)
    return {n: ((stacked[n],) if n in stacked else ()) + tuple(p.shape)
            for n, p in own.items()}


def params_from_reference(params_np: dict, cfg: ModelConfig, device=None):
    """The port's model of ``cfg``'s kind (``LM``, ``VLM`` or ``Whisper``)
    with the reference's weights (``jax.tree.map(np.asarray, params)``):
    every leaf must meet a parameter of the same name and shape
    (:func:`repro_torch.models.lm.load_reference`)."""
    return lm_mod.load_reference(model_class(cfg)(cfg, device=resolve_device(device)),
                                 reference_leaves(params_np, cfg))


def model_fns(cfg: ModelConfig) -> ModelFns:
    kind = model_kind(cfg)
    make = {"lm": lm_mod.lm_init, "vlm": vlm_mod.vlm_init, "whisper": wh_mod.whisper_init}

    def init(seed=0, device=None):
        return make[kind](seed, cfg, device=device)

    def head(params, hidden):
        return lm_mod.lm_head_apply(params, hidden, cfg)

    if kind == "whisper":
        def fwd(params, batch):
            return wh_mod.whisper_forward(params, batch["frames"], batch["tokens"], cfg)

        def cache_init(params, batch, bsz, max_seq):
            return wh_mod.whisper_cache_init(params, batch["frames"], cfg, bsz, max_seq)

        def decode(params, tokens, cache, cache_len):
            return wh_mod.whisper_decode_step(params, tokens, cfg, cache, cache_len)

        return ModelFns(cfg, kind, init, fwd, cache_init, decode, head, lambda batch: 0)

    def fwd(params, batch):
        if kind == "vlm":
            return vlm_mod.vlm_forward(params, batch["patches"], batch["tokens"], cfg)
        return lm_mod.lm_forward(params, batch["tokens"], cfg)

    def cache_init(params, batch, bsz, max_seq):
        return lm_mod.lm_cache_init(cfg, bsz, max_seq, device=params.device)

    def decode(params, tokens, cache, cache_len):
        h, nc, _ = lm_mod.lm_forward(params, tokens, cfg, cache=cache, cache_len=cache_len)
        return h, nc

    return ModelFns(cfg, kind, init, fwd, cache_init, decode, head,
                    lambda batch: cfg.vision_seq)


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                    device=None) -> dict:
    """Random int32 tokens and labels ``[batch, seq]``, and for the vlm
    kind ``patches [batch, vision_seq, VIT_WIDTH]``, for the whisper kind
    ``frames [batch, encoder_seq, d_model]`` (standard normal, bf16), all
    from one ``torch.Generator`` seeded with ``seed`` on ``device``
    (``None`` means CUDA).  They are not the reference's ``jax.random``
    draws; tests give both packages the same numpy inputs."""
    kind = model_kind(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)

    def draw():
        return torch.randint(0, cfg.vocab, (batch, seq), generator=gen, device=dev,
                             dtype=torch.int32)

    out = {"tokens": draw(), "labels": draw()}
    if kind == "vlm":
        out["patches"] = torch.randn((batch, cfg.vision_seq, vlm_mod.VIT_WIDTH),
                                     generator=gen, device=dev).to(torch.bfloat16)
    if kind == "whisper":
        out["frames"] = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                                    generator=gen, device=dev).to(torch.bfloat16)
    return out
