"""Generic decoder LM over heterogeneous block stacks (counterpart of
:mod:`repro.models.lm`).

The model is an ``nn.Module`` (:class:`LM`) whose parameters keep the
reference's names and layouts: ``embed.table``, ``final_norm``,
``lm_head.w`` (absent with tied embeddings), one :class:`Block` per layer,
and Zamba2's weight-tied ``shared`` block.  A block holds, by type:

  "attn"         ``ln1``, ``attn``, ``ln2``, ``mlp``
  "moe"          ``ln1``, ``attn``, ``ln2``, ``moe`` (:mod:`~repro_torch.models.moe`)
  "mamba2"       ``ln1``, ``ssm`` (:mod:`~repro_torch.models.ssm`)
  "rwkv6"        ``rwkv`` (:mod:`~repro_torch.models.rwkv`; residuals inside)
  "shared_attn"  nothing: every occurrence applies ``LM.shared`` to
                 ``concat(x, x0)``, x0 the embedding stream (arXiv:2411.15242)

:func:`params_from_reference` copies the reference's parameter pytree into
it.

Departures from the reference, all of them execution, not arithmetic:

* The reference groups consecutive layers of one type into *runs*
  (:func:`_runs`) and ``lax.scan``s a run over stacked parameters
  (``cfg.use_scan``), a compile device of XLA.  The port keeps one module
  per layer in an ``nn.ModuleList`` and loops over it eagerly; ``use_scan``
  is read only where the reference's pytree is carried across.
  ``cfg.remat`` is read as the reference reads it: with gradients on and
  no cache, each layer body runs under ``torch.utils.checkpoint``
  (:func:`~repro_torch.models.layers.checkpointed`), so the backward pass
  keeps each layer's input and recomputes the rest.
* On a mesh (parameters placed as DTensors,
  :mod:`repro_torch.dist.placement`) each layer gathers its own
  parameters inside its checkpointed body (``gathered_call``); the
  embedding, the final norm and the head are gathered by the caller (the
  train step's loss function).  Under ``placement.model_split`` (the
  mesh train step, the dry-run's train, prefill and decode steps) the
  attention and GLU MLP of every block (``"attn"``,
  ``"moe"``'s attention, the shared block) compute this rank's heads and
  ffn columns of ``"model"``, RWKV's time and channel mix its heads and
  ffn columns, the cache-free Mamba2 layer its SSD heads, and the head
  its ``V / tp`` logit columns (:func:`vocab_part`); the embedding lookup
  and the MoE's own split are unchanged.
* The cache is one entry per layer (:func:`lm_cache_init`), not one per
  run.  Attention K/V are preallocated ``[B, Smax, KV, Dh]`` tensors
  written in place at ``cache_len``; the recurrent states (Mamba2's,
  RWKV's) are replaced by new tensors at every call, in the new list that
  :func:`lm_forward` returns, so a second decode from the same cache starts
  from the same state.

The forward pass returns final *hidden states*; logits come from
:func:`lm_head_apply`, and :func:`embed_hidden` is the kNN-LM datastore's
retrieval hook.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import Tensor, nn

from repro_torch.device import resolve_device
from repro_torch.dist import placement
from repro_torch.dist import sharding as shd
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MLP, Attention, Norm, _param, attn_apply,
                                       checkpointed, dense_init, mlp_apply, norm_apply,
                                       tp_plan)

__all__ = ["Block", "SharedBlock", "LM", "lm_init", "lm_forward", "lm_head_apply",
           "vocab_part", "head_weight", "lm_head_share", "lm_cache_init", "embed_hidden",
           "params_from_reference", "load_reference"]

BLOCK_TYPES = ("attn", "moe", "mamba2", "rwkv6", "shared_attn")


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
    """One layer of type ``btype`` (see the module's docstring)."""

    gathers_own_params = True

    def __init__(self, btype: str, cfg: ModelConfig, gen: torch.Generator | None = None, *,
                 device=None):
        super().__init__()
        if btype not in BLOCK_TYPES:
            raise ValueError(f"unknown block type {btype!r}")
        dev = gen.device if gen is not None else device
        self.btype = btype
        if btype in ("attn", "moe"):
            self.ln1 = Norm(cfg, device=dev)
            self.attn = Attention(cfg, gen, device=dev)
            self.ln2 = Norm(cfg, device=dev)
            if btype == "attn":
                self.mlp = MLP(cfg, gen, device=dev)
            else:
                self.moe = moe_mod.MoE(cfg, gen, device=dev)
        elif btype == "mamba2":
            self.ln1 = Norm(cfg, device=dev)
            self.ssm = ssm_mod.Mamba2(cfg, gen, device=dev)
        elif btype == "rwkv6":
            self.rwkv = rwkv_mod.RWKV6(cfg, gen, device=dev)


class SharedBlock(nn.Module):
    """Zamba2's weight-tied block: ``in_proj [2d, d]``, ``ln1``, ``attn``,
    ``ln2``, ``mlp``, ``out_proj [d, d]``."""

    gathers_own_params = True

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None, *,
                 device=None):
        super().__init__()
        d = cfg.d_model
        dev = gen.device if gen is not None else device
        self.in_proj = _param(dense_init(gen, (2 * d, d), cfg.p_dtype, device=dev))
        self.ln1 = Norm(cfg, device=dev)
        self.attn = Attention(cfg, gen, device=dev)
        self.ln2 = Norm(cfg, device=dev)
        self.mlp = MLP(cfg, gen, device=dev)
        self.out_proj = _param(dense_init(gen, (d, d), cfg.p_dtype, device=dev))


class LM(nn.Module):
    """The decoder LM's parameters; :func:`lm_forward` runs it.

    ``gen=None`` leaves the weights uninitialized on ``device``
    (:func:`params_from_reference` copies weights in)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None, *,
                 device=None):
        super().__init__()
        dev = gen.device if gen is not None else device
        self.cfg = cfg
        self.embed = nn.ParameterDict({"table": _param(dense_init(
            gen, (cfg.vocab, cfg.d_model), cfg.p_dtype, scale=0.02, device=dev))})
        self.final_norm = Norm(cfg, device=dev)
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = nn.ParameterDict({"w": _param(dense_init(
                gen, (cfg.d_model, cfg.vocab), cfg.p_dtype, device=dev))})
        self.blocks = nn.ModuleList(Block(t, cfg, gen, device=dev) for t in cfg.layer_types)
        self.shared = (SharedBlock(cfg, gen, device=dev)
                       if "shared_attn" in cfg.layer_types else None)

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
    """Returns (x_out, new_cache, aux_loss); the aux loss is None for the
    blocks without one (the reference's zero)."""
    aux = None
    if btype in ("attn", "moe"):
        a, new_attn = attn_apply(p.attn, norm_apply(p.ln1, x, cfg), cfg,
                                 cache=None if cache is None else cache["attn"],
                                 cache_len=cache_len)
        x = x + a
        h2 = norm_apply(p.ln2, x, cfg)
        if btype == "attn":
            x = x + mlp_apply(p.mlp, h2, cfg)
        else:
            y, aux = p.moe(h2, cfg, no_drop=cache is not None)  # a module call: hooks see it
            x = x + y
        return x, None if cache is None else {"attn": new_attn}, aux
    if btype == "mamba2":
        y, new_ssm = ssm_mod.mamba2_apply(p.ssm, norm_apply(p.ln1, x, cfg), cfg,
                                          cache=None if cache is None else cache["ssm"])
        return x + y, None if cache is None else {"ssm": new_ssm}, aux
    if btype == "rwkv6":
        y, new_rw = rwkv_mod.rwkv6_apply(p.rwkv, x, cfg,
                                         cache=None if cache is None else cache["rwkv"])
        return y, None if cache is None else {"rwkv": new_rw}, aux  # residuals inside
    raise ValueError(btype)


def _call(fn, module, *args, **kw):
    """``fn(module, ...)``: :func:`placement.gathered_call` off a mesh."""
    return fn(module, *args, **kw)


def _block_cache_init(btype: str, cfg: ModelConfig, batch: int, max_seq: int, device):
    if btype in ("attn", "moe", "shared_attn"):
        kv, dh = cfg.n_kv_heads * cfg.kv_repeat, cfg.head_dim
        if cfg.sliding_window is not None:
            max_seq = min(max_seq, cfg.sliding_window)   # rolling SWA buffer
        return {"attn": {
            n: torch.zeros((batch, max_seq, kv, dh), dtype=cfg.act_dtype, device=device)
            for n in ("k", "v")}}
    if btype == "mamba2":
        return {"ssm": ssm_mod.mamba2_cache_init(cfg, batch, device=device)}
    if btype == "rwkv6":
        return {"rwkv": rwkv_mod.rwkv6_cache_init(cfg, batch, device=device)}
    raise ValueError(btype)


def _shared_apply(p: SharedBlock, x: Tensor, x0: Tensor, cfg: ModelConfig, *,
                  cache=None, cache_len=None):
    u = torch.cat([x, x0], dim=-1) @ p.in_proj.to(x.dtype)
    a, new_attn = attn_apply(p.attn, norm_apply(p.ln1, u, cfg), cfg,
                             cache=None if cache is None else cache["attn"],
                             cache_len=cache_len)
    u = u + a
    u = u + mlp_apply(p.mlp, norm_apply(p.ln2, u, cfg), cfg)
    y = u @ p.out_proj.to(x.dtype)
    return x + y, None if cache is None else {"attn": new_attn}


def lm_forward(
    params: LM,
    tokens,
    cfg: ModelConfig,
    *,
    extra_embeds: Tensor | None = None,
    cache: list | None = None,
    cache_len: int | None = None,
):
    """tokens [B, S] -> (hidden [B, S', D], new_cache, aux_loss).

    ``extra_embeds`` [B, Sv, D] (vision/audio prefix) is prepended;
    S' = Sv + S.  ``cache``/``cache_len`` select the decode path: the
    cache is one entry per layer (:func:`lm_cache_init`); the new cache is
    a new list (attention K/V written in place, recurrent states new).
    ``aux_loss`` is the sum of the MoE layers' balance losses.  With
    ``cfg.remat``, gradients on and no cache, each layer is checkpointed.
    """
    tokens = torch.as_tensor(tokens, device=params.device)
    x = params.embed["table"][tokens].to(cfg.act_dtype)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(cfg.act_dtype), x], dim=1)
    x = shd.shard(x, "batch", None, "model_embed")
    x0 = x
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: list | None = None if cache is None else []
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    # the layers are never swapped for gathered copies by the caller
    call = placement.gathered_call if placement.mesh_of(params.blocks) is not None else _call
    for li, btype in enumerate(cfg.layer_types):
        layer_c = None if cache is None else cache[li]
        if btype == "shared_attn":
            x, nc = checkpointed(call, remat, _shared_apply,
                                 params.shared, x, x0, cfg, cache=layer_c,
                                 cache_len=cache_len)
        else:
            x, nc, aux = checkpointed(call, remat, functools.partial(_block_apply, btype),
                                      params.blocks[li], x, cfg, cache=layer_c,
                                      cache_len=cache_len)
            if aux is not None:
                aux_total = aux_total + aux
        if new_cache is not None:
            new_cache.append(nc)
    x = norm_apply(params.final_norm, x, cfg)
    return x, new_cache, aux_total


def lm_head_apply(params: LM, hidden: Tensor, cfg: ModelConfig) -> Tensor:
    """hidden [B, S, D] -> logits [B, S, V] (fp32).

    Inside :func:`placement.model_split
    <repro_torch.dist.placement.model_split>`, where the vocabulary splits
    (:func:`vocab_part`), this rank computes its ``V / tp`` columns
    (:func:`lm_head_share`) and all-gathers them over ``"model"`` (the
    reference's replicated output); without a group (one share computed
    alone) the share is returned."""
    logits = lm_head_share(params, hidden, cfg)
    part = vocab_part(cfg)
    return logits if part is None else placement.gather_shares(logits, -1, part)


def vocab_part(cfg: ModelConfig) -> tuple | None:
    """``(r, tp, group)`` where the head computes share ``r`` of ``tp``
    of the logit columns, ``[r·V/tp, (r+1)·V/tp)``: inside
    :func:`placement.model_split <repro_torch.dist.placement.model_split>`
    where :func:`~repro_torch.models.layers.tp_plan` splits ``"vocab"``;
    None (the whole head) otherwise."""
    part = placement.model_part()
    return part if part is not None and tp_plan(cfg, part[1])["vocab"] else None


def head_weight(params: LM, cfg: ModelConfig) -> Tensor:
    """The head's ``[D, V']`` weight in the parameter's dtype (each use
    casts it to the activation dtype, as the reference's head does, so the
    gradient of several uses adds up in the parameter's dtype): whole
    (``V' = V``), or inside the vocabulary split (:func:`vocab_part`) this
    share's ``V / tp`` columns: an untied ``lm_head.w``'s, marked
    :func:`placement.sum_over_model
    <repro_torch.dist.placement.sum_over_model>` (each rank's gradient
    holds its columns alone), or the tied ``embed.table``'s rows through
    :func:`placement.take_share <repro_torch.dist.placement.take_share>`,
    whose backward all-gathers them over ``"model"`` (the lookup's use of
    the whole table already gives each rank the whole, equal gradient, so
    the table is not marked: a sum over ``"model"`` would count it ``tp``
    times)."""
    part = vocab_part(cfg)
    if cfg.tie_embeddings:
        table = params.embed["table"]
        if part is not None:
            table = placement.take_share(table, 0, part)
        return table.T
    w = params.lm_head["w"]
    if part is None:
        return w
    r, tp, _ = part
    n = w.shape[-1] // tp
    return placement.sum_over_model(w)[:, r * n:(r + 1) * n]


def lm_head_share(params: LM, hidden: Tensor, cfg: ModelConfig,
                  w: Tensor | None = None) -> Tensor:
    """hidden [B, S, D] -> this share's logits [B, S, V'] (fp32): the
    whole head outside the vocabulary split, else share ``r``'s ``V / tp``
    columns, its input through :func:`placement.copy_to_group
    <repro_torch.dist.placement.copy_to_group>` (Megatron's ``f``: the
    hidden states' gradient summed over ``"model"``).  ``w``: the
    :func:`head_weight` to use, made once for several calls (the loss's
    chunks)."""
    part = vocab_part(cfg)
    if w is None:
        w = head_weight(params, cfg)
    if part is not None:
        hidden = placement.copy_to_group(hidden, part[2])
    return shd.shard(hidden @ w.to(cfg.act_dtype), "batch", None, "vocab").float()


def lm_cache_init(cfg: ModelConfig, batch: int, max_seq: int, *, device=None) -> list:
    """One entry of zeros per layer, on ``device`` (``None`` means CUDA):
    ``{"attn": {"k", "v"}}`` for attn, moe and shared_attn layers
    (``[batch, max_seq (the window with sliding-window attention), KV,
    Dh]`` in the activation dtype), ``{"ssm": ...}`` for mamba2
    (:func:`~repro_torch.models.ssm.mamba2_cache_init`) and ``{"rwkv":
    ...}`` for rwkv6 (:func:`~repro_torch.models.rwkv.rwkv6_cache_init`)."""
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


def _layer_leaves(run, j: int, stacked: bool, prefix: str):
    """Layer ``j`` of a run of the reference: a slice of its stacked
    ``[count, ...]`` leaves (``lax.scan`` layout) or its ``j``-th tree."""
    for name, a in _flat(run if stacked else run[j], prefix):
        yield name, a[j] if stacked else a


def _reference_leaves(params_np: dict, cfg: ModelConfig) -> dict:
    """The reference's decoder pytree as the port's ``named_parameters``
    names: its scanned runs unstacked into ``blocks.<layer>``, Zamba2's
    ``{}`` run placeholders skipped, and its top-level trees (``shared``,
    a VLM's ``projector``) kept as they are."""
    leaves = dict(_flat({k: v for k, v in params_np.items() if k != "blocks"}))
    li = 0
    for (btype, count), run in zip(_runs(cfg), params_np["blocks"], strict=True):
        if btype == "shared_attn" and run:
            raise ValueError(f"blocks[{li}]: the reference keeps the weight-tied "
                             "block at the top level, not in its run")
        stacked = count > 1 and cfg.use_scan
        for j in range(count):
            if btype != "shared_attn":
                leaves.update(_layer_leaves(run, j, stacked, f"blocks.{li}."))
            li += 1
    return leaves


def _reference_paths(names, cfg: ModelConfig) -> dict:
    """Each of the port's parameter ``names`` mapped to the reference's
    ``/``-joined path of its leaf (the inverse of
    :func:`_reference_leaves`): ``blocks.<layer>.<rest>`` to
    ``blocks/<run>/<rest>`` in a scanned run (one stacked leaf for all its
    layers) or ``blocks/<run>/<j>/<rest>`` in a list run, the top-level
    trees with their dots as slashes."""
    where = _layer_places(cfg)
    out = {}
    for name in names:
        parts = name.split(".")
        if parts[0] == "blocks":
            ri, j = where[int(parts[1])]
            parts = ["blocks", ri, *parts[2:]] if j is None else ["blocks", ri, j, *parts[2:]]
        out[name] = "/".join(parts)
    return out


def _reference_stacked(names, cfg: ModelConfig) -> dict:
    """{name: the run's layer count} of the ``names`` whose reference leaf
    stacks a scanned run's layers (one dim more than the port's
    parameter)."""
    where, runs = _layer_places(cfg), _runs(cfg)
    return {n: runs[int(where[int(n.split(".")[1])][0])][1] for n in names
            if n.split(".")[0] == "blocks" and where[int(n.split(".")[1])][1] is None}


def _layer_places(cfg: ModelConfig) -> dict:
    """{layer: (its run, its index in the run)}, as strings; the index is
    None where the run is one stacked leaf (``lax.scan``)."""
    where, li = {}, 0
    for ri, (_, count) in enumerate(_runs(cfg)):
        for j in range(count):
            where[li] = (str(ri), None if count > 1 and cfg.use_scan else str(j))
            li += 1
    return where


def params_from_reference(params_np: dict, cfg: ModelConfig, device=None) -> LM:
    """The port's :class:`LM` with the reference's weights.

    ``params_np`` is the reference's parameter pytree with numpy leaves
    (``jax.tree.map(np.asarray, params)``), mapped by
    :func:`_reference_leaves`.  The other kinds' models come from
    :func:`repro_torch.models.registry.params_from_reference`.  The
    counterpart of ``core/index.py:index_from_reference``.
    """
    return load_reference(LM(cfg, device=resolve_device(device)),
                          _reference_leaves(params_np, cfg))


def load_reference(model: nn.Module, leaves: dict) -> nn.Module:
    """Copies ``leaves`` (numpy arrays by the port's parameter names) into
    ``model``: every leaf must meet a parameter of the same name and shape,
    and every parameter a leaf."""
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
