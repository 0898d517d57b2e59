"""Generic decoder LM (counterpart of :mod:`repro.models.lm`).

The model is an ``nn.Module`` (:class:`LM`) whose parameters keep the
reference's names and layouts: ``embed.table``, ``final_norm``,
``lm_head.w`` (absent with tied embeddings) and one :class:`Block` per
layer (``ln1``, ``attn``, ``ln2``, ``mlp``).  :func:`params_from_reference`
copies the reference's parameter pytree into it.

Departures from the reference, all of them execution, not arithmetic:

* The reference groups consecutive layers of one type into *runs*
  (:func:`_runs`) and ``lax.scan``s a run over stacked parameters
  (``cfg.use_scan``), with ``jax.checkpoint`` around each layer
  (``cfg.remat``): both are compile devices of XLA.  The port keeps one
  module per layer in an ``nn.ModuleList`` and loops over it eagerly;
  ``use_scan`` and ``remat`` are read by nothing here.
* The KV cache is one preallocated ``[B, Smax, KV, Dh]`` pair per layer
  (:func:`lm_cache_init`), written in place at ``cache_len``; the
  reference's scan returns an updated copy.
* Only the ``"attn"`` block type is ported.  The others raise
  ``NotImplementedError`` naming the ROADMAP.md item that ports them.

The forward pass returns final *hidden states*; logits come from
:func:`lm_head_apply`, and :func:`embed_hidden` is the kNN-LM datastore's
retrieval hook.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import Tensor, nn

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MLP, Attention, Norm, _param, attn_apply, dense_init,
                                       mlp_apply, norm_apply)

__all__ = ["Block", "LM", "lm_init", "lm_forward", "lm_head_apply", "lm_cache_init",
           "embed_hidden", "params_from_reference"]

#: block types of the reference that the port does not run yet, and the
#: ROADMAP.md item that ports each
_UNPORTED = {
    "moe": "ROADMAP.md Queue 1 item 2 (models/moe.py)",
    "mamba2": "ROADMAP.md Queue 1 item 2 (models/ssm.py)",
    "rwkv6": "ROADMAP.md Queue 1 item 2 (models/rwkv.py)",
    "shared_attn": "ROADMAP.md Queue 1 item 2 (Zamba2's shared block, with models/ssm.py)",
}


def _check_block_type(btype: str) -> None:
    if btype in _UNPORTED:
        raise NotImplementedError(
            f"block type {btype!r} is not ported to repro_torch yet: {_UNPORTED[btype]}")
    if btype != "attn":
        raise ValueError(f"unknown block type {btype!r}")


def _runs(cfg: ModelConfig):
    """Group layer types into (type, count) runs (the reference's; the
    layout of its parameter pytree)."""
    runs = []
    for t in cfg.layer_types:
        if runs and runs[-1][0] == t and t != "shared_attn":
            runs[-1][1] += 1
        else:
            runs.append([t, 1])
    return [(t, c) for t, c in runs]


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """The ``"attn"`` block: pre-norm GQA attention and MLP, each residual."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None, *,
                 device=None):
        super().__init__()
        dev = gen.device if gen is not None else device
        self.ln1 = Norm(cfg, device=dev)
        self.attn = Attention(cfg, gen, device=dev)
        self.ln2 = Norm(cfg, device=dev)
        self.mlp = MLP(cfg, gen, device=dev)


class LM(nn.Module):
    """The decoder LM's parameters; :func:`lm_forward` runs it.

    ``gen=None`` leaves the weights uninitialized on ``device``
    (:func:`params_from_reference` copies weights in)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None, *,
                 device=None):
        super().__init__()
        for t in cfg.layer_types:
            _check_block_type(t)
        dev = gen.device if gen is not None else device
        self.cfg = cfg
        self.embed = nn.ParameterDict({"table": _param(dense_init(
            gen, (cfg.vocab, cfg.d_model), cfg.p_dtype, scale=0.02, device=dev))})
        self.final_norm = Norm(cfg, device=dev)
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = nn.ParameterDict({"w": _param(dense_init(
                gen, (cfg.d_model, cfg.vocab), cfg.p_dtype, device=dev))})
        self.blocks = nn.ModuleList(Block(cfg, gen, device=dev) for _ in cfg.layer_types)

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device


def lm_init(gen: torch.Generator | int, cfg: ModelConfig, *, device=None) -> LM:
    """A randomly initialized LM: ``gen`` is a ``torch.Generator`` (the
    weights are made on its device) or an int seed for a generator on
    ``device`` (``None`` means CUDA)."""
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(resolve_device(device)).manual_seed(int(gen))
    return LM(cfg, gen)


def _block_apply(btype: str, p: Block, x: Tensor, cfg: ModelConfig, *,
                 cache=None, cache_len=None):
    """Returns (x_out, cache)."""
    _check_block_type(btype)
    a, new_attn = attn_apply(p.attn, norm_apply(p.ln1, x, cfg), cfg,
                             cache=None if cache is None else cache["attn"],
                             cache_len=cache_len)
    x = x + a
    x = x + mlp_apply(p.mlp, norm_apply(p.ln2, x, cfg), cfg)
    return x, None if cache is None else {"attn": new_attn}


def _block_cache_init(btype: str, cfg: ModelConfig, batch: int, max_seq: int, device):
    _check_block_type(btype)
    kv, dh = cfg.n_kv_heads * cfg.kv_repeat, cfg.head_dim
    if cfg.sliding_window is not None:
        max_seq = min(max_seq, cfg.sliding_window)   # rolling SWA buffer
    return {"attn": {
        "k": torch.zeros((batch, max_seq, kv, dh), dtype=cfg.act_dtype, device=device),
        "v": torch.zeros((batch, max_seq, kv, dh), dtype=cfg.act_dtype, device=device),
    }}


def lm_forward(
    params: LM,
    tokens,
    cfg: ModelConfig,
    *,
    extra_embeds: Tensor | None = None,
    cache: list | None = None,
    cache_len: int | None = None,
):
    """tokens [B, S] -> (hidden [B, S', D], cache, aux_loss).

    ``extra_embeds`` [B, Sv, D] (vision/audio prefix) is prepended;
    S' = Sv + S.  ``cache``/``cache_len`` select the decode path: the
    cache (one entry per layer, :func:`lm_cache_init`) is written in place
    and returned.  ``aux_loss`` is the MoE balance loss, 0 for the ported
    block types.
    """
    tokens = torch.as_tensor(tokens, device=params.device)
    x = params.embed["table"][tokens].to(cfg.act_dtype)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(cfg.act_dtype), x], dim=1)
    li = 0
    for btype, count in _runs(cfg):
        for _ in range(count):
            x, _ = _block_apply(btype, params.blocks[li], x, cfg,
                                cache=None if cache is None else cache[li],
                                cache_len=cache_len)
            li += 1
    x = norm_apply(params.final_norm, x, cfg)
    return x, cache, torch.zeros((), dtype=torch.float32, device=x.device)


def lm_head_apply(params: LM, hidden: Tensor, cfg: ModelConfig) -> Tensor:
    """hidden [B, S, D] -> logits [B, S, V] (fp32)."""
    if cfg.tie_embeddings:
        w = params.embed["table"].to(cfg.act_dtype).T
    else:
        w = params.lm_head["w"].to(cfg.act_dtype)
    return (hidden @ w).float()


def lm_cache_init(cfg: ModelConfig, batch: int, max_seq: int, *, device=None) -> list:
    """One ``{"attn": {"k", "v"}}`` of zeros per layer, ``[batch, max_seq
    (the window with sliding-window attention), KV, Dh]`` in the
    activation dtype, on ``device`` (``None`` means CUDA)."""
    dev = resolve_device(device)
    return [_block_cache_init(t, cfg, batch, max_seq, dev) for t in cfg.layer_types]


def embed_hidden(params, hidden: Tensor, cfg) -> Tensor:
    """Unit-normalized retrieval embedding of final hidden states
    ``[B, S, D]`` (float32).  ``params`` and ``cfg`` are unused, as in the
    reference.  This is the hook the kNN-LM datastore uses."""
    h = torch.as_tensor(hidden).float()
    return h / torch.linalg.vector_norm(h, dim=-1, keepdim=True).clamp(min=1e-12)


# ---------------------------------------------------------------------------
# weights carried across from the reference
# ---------------------------------------------------------------------------

def _flat(tree: dict, prefix: str = ""):
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _flat(leaf, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", leaf


def params_from_reference(params_np: dict, cfg: ModelConfig, device=None) -> LM:
    """The port's model with the reference's weights.

    ``params_np`` is the reference's parameter pytree with numpy leaves
    (``jax.tree.map(np.asarray, params)``).  Its scanned runs' leading
    ``[count, ...]`` axis is unstacked into the layer list; every leaf must
    meet a parameter of the same name and shape, and every parameter a
    leaf.  The counterpart of ``core/index.py:index_from_reference``.
    """
    model = LM(cfg, device=resolve_device(device))
    leaves = dict(_flat({k: v for k, v in params_np.items() if k != "blocks"}))
    li = 0
    for (btype, count), run in zip(_runs(cfg), params_np["blocks"], strict=True):
        stacked = count > 1 and cfg.use_scan
        for j in range(count):
            layer = run if stacked else run[j]
            for name, a in _flat(layer, f"blocks.{li}."):
                leaves[name] = a[j] if stacked else a
            li += 1
    own = dict(model.named_parameters())
    if own.keys() != leaves.keys():
        raise ValueError(f"parameter names differ: only in the reference "
                         f"{sorted(leaves.keys() - own.keys())}, only in the port "
                         f"{sorted(own.keys() - leaves.keys())}")
    with torch.no_grad():
        for name, p in own.items():
            a = np.array(leaves[name])               # a writable copy
            if a.dtype.name == "bfloat16":           # ml_dtypes: torch has no view
                a = a.astype(np.float32)
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: the reference's shape {a.shape}, the "
                                 f"port's {tuple(p.shape)}")
            p.copy_(torch.from_numpy(a))
    return model
