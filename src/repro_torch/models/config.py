"""Model configuration (counterpart of :mod:`repro.models.config`) — one
dataclass covers every assigned architecture.

Blocks are described by a per-layer pattern so heterogeneous (hybrid) stacks
are first-class: ``block_pattern`` is a list of block-type strings of length
``n_layers`` (or a short form that is tiled).  Supported block types:

  "attn"     GQA self-attention (+ optional sliding window) + MLP
  "moe"      GQA self-attention + mixture-of-experts MLP
  "mamba2"   Mamba-2 (SSD) block
  "rwkv6"    RWKV-6 time-mix + channel-mix block
  "shared_attn"  Zamba2-style block: weight-TIED attention+MLP (one shared
                 set of weights applied at several depths)

Encoder–decoder (whisper) and vision-prefix (internvl2) variants are handled
by the model wrappers (:mod:`repro_torch.models.whisper`,
:mod:`repro_torch.models.vlm`) on top of the same decoder stack
(:mod:`repro_torch.models.lm`).  The dataclasses are copies of the
reference's, field for field and default for default, so a configuration
means the same in both packages; ``act_dtype`` and ``p_dtype`` return torch
dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64          # N
    head_dim: int = 64           # P
    expand: int = 2              # d_inner = expand * d_model
    n_groups: int = 1            # B/C groups (GVA)
    chunk: int = 256             # SSD chunk length
    conv_width: int = 4          # local conv kernel size
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int | None = None           # default d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    block_pattern: tuple[str, ...] = ("attn",)   # tiled to n_layers
    mlp_kind: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    norm_kind: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    qkv_bias: bool = False
    sliding_window: int | None = None   # tokens; None = full attention
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    shared_attn_every: int = 6          # zamba2: shared block cadence
    max_seq_len: int = 4096
    # --- numerics / execution ---
    kv_repeat: int = 1                  # replicate KV heads so TP divides them
    q_group_pad: int | None = None      # pad q heads per KV group to this
                                        # (zero heads -> zero outputs; lets
                                        # awkward head counts shard over TP)
    dtype: str = "bfloat16"             # activation dtype
    param_dtype: str = "float32"
    use_scan: bool = True               # scan over homogeneous layer runs
    remat: bool = True                  # activation checkpoint each layer
    attn_chunk_q: int = 512             # flash-attention tile sizes
    attn_chunk_k: int = 1024
    logits_chunk: int = 512             # chunked cross-entropy span
    # encoder-decoder / multimodal frontends (stubs provide embeddings)
    encoder_layers: int = 0             # whisper: encoder depth
    encoder_seq: int = 0                # whisper: #frames (e.g. 1500)
    vision_seq: int = 0                 # internvl2: #patch embeddings

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def layer_types(self) -> tuple[str, ...]:
        pat = self.block_pattern
        reps = -(-self.n_layers // len(pat))
        return tuple((pat * reps)[: self.n_layers])

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def p_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- analytic parameter / FLOP accounting (for roofline §) ----------
    def param_count(self) -> int:
        d, h, kv, dh, f, v = (self.d_model, self.n_heads, self.n_kv_heads,
                              self.head_dim, self.d_ff, self.vocab)
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        glu = self.mlp_kind in ("swiglu", "geglu")
        mlp = d * f * (3 if glu else 2)
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        for t in self.layer_types:
            if t == "attn":
                n += attn + mlp
            elif t == "moe":
                m = self.moe or MoEConfig()
                n += attn + m.n_experts * mlp + d * m.n_experts
            elif t == "mamba2":
                s = self.ssm or SSMConfig()
                di = s.expand * d
                nh = di // s.head_dim
                n += d * (2 * di + 2 * s.n_groups * s.state_dim + nh) + di * d + di
            elif t == "rwkv6":
                # time-mix: r,k,v,g,o + decay MLPs; channel-mix: 2 mats
                n += 5 * d * d + 2 * d * self.d_ff + self.d_ff * d
            elif t == "shared_attn":
                pass  # weight-tied; counted once below
        if "shared_attn" in self.layer_types:
            n += attn + mlp + 2 * d * d  # shared block + in/out projections
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        glu = self.mlp_kind in ("swiglu", "geglu")
        mlp = d * f * (3 if glu else 2)
        dead = sum(
            (self.moe.n_experts - self.moe.top_k) * mlp
            for t in self.layer_types if t == "moe"
        )
        return self.param_count() - dead
