"""Assigned input shapes (counterpart of :mod:`repro.configs.shapes`).

Four shapes per architecture (LM family):

  train_4k      seq 4096   global_batch 256   -> train_step
  prefill_32k   seq 32768  global_batch 32    -> serve prefill
  decode_32k    seq 32768  global_batch 128   -> serve_step (1 new token,
                                                 KV/state cache of 32k)
  long_500k     seq 524288 global_batch 1     -> serve_step; ONLY for
                sub-quadratic archs (SSM/hybrid/SWA) — full-attention archs
                skip it (DESIGN.md §5)

``input_specs`` returns tensors on the ``meta`` device (shapes and dtypes,
no storage: the counterpart of the reference's ``jax.ShapeDtypeStruct``
stand-ins); modality frontends are stubs, so whisper gets frame
*embeddings* and internvl2 gets patch *embeddings* directly.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig

__all__ = ["Shape", "SHAPES", "model_kind", "is_subquadratic", "applicable", "input_specs"]


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}


def model_kind(cfg: ModelConfig) -> str:
    if cfg.encoder_layers > 0:
        return "whisper"
    if cfg.vision_seq > 0:
        return "vlm"
    return "lm"


def is_subquadratic(cfg: ModelConfig) -> bool:
    """True if the arch can run long_500k (SSM/hybrid/SWA-bounded)."""
    types = set(cfg.layer_types)
    if types <= {"mamba2", "rwkv6", "shared_attn"} and (
            "mamba2" in types or "rwkv6" in types):
        return cfg.sliding_window is not None or "shared_attn" not in types
    return cfg.sliding_window is not None


def applicable(cfg: ModelConfig, shape: Shape) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not is_subquadratic(cfg):
        return False, "full attention is quadratic/unbounded-KV at 500k"
    return True, ""


def input_specs(cfg: ModelConfig, shape: Shape, *, scale: float = 1.0) -> dict:
    """Abstract inputs for the given cell: ``meta`` tensors with the
    reference's keys, shapes and dtypes.  ``scale`` shrinks batch for
    smoke tests (batch >= 1)."""
    from repro_torch.models.vlm import VIT_WIDTH

    b = max(1, int(shape.batch * scale))
    s = shape.seq
    kind = model_kind(cfg)

    def f(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        specs = {"tokens": f((b, s), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = f((b, s), torch.int32)
        if kind == "vlm":
            specs["patches"] = f((b, cfg.vision_seq, VIT_WIDTH), torch.bfloat16)
        if kind == "whisper":
            specs["frames"] = f((b, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
        return specs
    # decode: one new token against a cache of length seq
    return {"tokens": f((b, 1), torch.int32), "cache_len": f((), torch.int32)}
