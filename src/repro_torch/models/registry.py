"""Uniform model interface (counterpart of :mod:`repro.models.registry`).

    fns = model_fns(cfg)
    params = fns.init(seed, device)                       # an LM module
    hidden, cache, aux = fns.forward(params, batch)       # train/prefill
    cache = fns.cache_init(params, batch, bsz, max_seq)   # serving
    hidden, cache = fns.decode_step(params, tokens, cache, cache_len)

``batch`` is a dict: tokens/labels.  Only the ``"lm"`` kind is ported; the
reference's ``vlm`` and ``whisper`` kinds raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.shapes import model_kind
from repro_torch.device import resolve_device
from repro_torch.models import lm as lm_mod
from repro_torch.models.config import ModelConfig

__all__ = ["ModelFns", "model_fns", "synthetic_batch"]

#: model kinds of the reference that the port does not run yet
_UNPORTED_KINDS = {
    "vlm": "ROADMAP.md Queue 1 item 2 (models/vlm.py)",
    "whisper": "ROADMAP.md Queue 1 item 2 (models/whisper.py)",
}


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


def _check_kind(kind: str) -> None:
    if kind in _UNPORTED_KINDS:
        raise NotImplementedError(
            f"model kind {kind!r} is not ported to repro_torch yet: {_UNPORTED_KINDS[kind]}")


def model_fns(cfg: ModelConfig) -> ModelFns:
    kind = model_kind(cfg)
    _check_kind(kind)

    def init(seed=0, device=None):
        return lm_mod.lm_init(seed, cfg, device=device)

    def fwd(params, batch):
        return lm_mod.lm_forward(params, batch["tokens"], cfg)

    def cache_init(params, batch, bsz, max_seq):
        return lm_mod.lm_cache_init(cfg, bsz, max_seq, device=params.device)

    def decode(params, tokens, cache, cache_len):
        h, nc, _ = lm_mod.lm_forward(params, tokens, cfg, cache=cache,
                                     cache_len=cache_len)
        return h, nc

    return ModelFns(cfg, kind, init, fwd, cache_init, decode,
                    lambda p, h: lm_mod.lm_head_apply(p, h, cfg),
                    lambda batch: 0)


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                    device=None) -> dict:
    """Random int32 tokens and labels ``[batch, seq]`` from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (``None`` means
    CUDA).  They are not the reference's ``jax.random`` draws; tests give
    both packages the same numpy tokens."""
    _check_kind(model_kind(cfg))
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)

    def draw():
        return torch.randint(0, cfg.vocab, (batch, seq), generator=gen, device=dev,
                             dtype=torch.int32)

    return {"tokens": draw(), "labels": draw()}
