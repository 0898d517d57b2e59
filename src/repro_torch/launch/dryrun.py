"""Multi-pod dry-run: every (arch x shape x mesh) cell's step run once on
rank 0 of a fake world, with fake tensors (counterpart of
:mod:`repro.launch.dryrun`).

For each cell this shows, without hardware:
  * the sharding config is coherent (the step runs on the placed state),
  * it fits: the rank's argument, output and temporary bytes,
  * the cost terms for a roofline: FLOPs, bytes accessed and the bytes of
    every collective the rank issues.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k --mesh pod            # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --jobs 6

Results land in experiments/dryrun_torch/<mesh>/<arch>__<shape>.json (the
reference's records, under experiments/dryrun, are never overwritten),
with the reference's keys.  ``--unrolled-probe`` adds the step of a
pattern-length unrolled model (``probe``) and of twice that (``probe2``).

How a cell runs.  torch has no ahead-of-time lowering, so the port runs
the step itself: ``torch.distributed`` under the ``"fake"`` backend at
world 256 (pod) or 512 (multipod), whose collectives move nothing, and a
``FakeTensorMode``, whose tensors have shapes, dtypes and devices but no
storage.  The parameters are placed by :func:`param_shardings`
(DTensors, :mod:`repro_torch.dist.placement`), the decode cache by
:func:`cache_shardings`, the batch split over the data axes where they
divide it; rank 0 then runs its part of the step as it would on a pod.
The fake tensors claim the card's device type (``device="cuda"``) unless
the caller asks for the CPU, as the tests do.  The ``"fake"`` backend is
registered by ``torch.testing._internal.distributed.fake_pg``, a private
module that ships with torch.

The steps are the reference's:

* **train**: the loss's gradient (``make_loss_fn``, ``REPRO_CAST_BF16``)
  under the mesh train step's ``"model"`` split
  (:func:`~repro_torch.dist.placement.model_split`: attention's heads, the
  GLU MLP's ffn columns, rwkv6's and the cache-free SSD's heads and the
  channel mix's ffn columns, and the head's vocab columns per rank, the loss
  vocab-parallel), optionally cast to bf16 (``REPRO_BF16_GRAD_REDUCE``;
  the port reduces inside the backward, so the cast lands after the
  reduce and changes only the moment's input), then one fp32 moment
  ``0.9 m + g`` and ``p - 1e-4 m``, on each rank's shards, in place (the
  reference donates both).  The microbatch is the shape's batch cut by
  :data:`TRAIN_ACCUM`.
* **prefill**: the forward, then ``lm_head`` of the last position, under
  the same ``"model"`` split (no gradient): attention's cache-free path
  computes the rank's query heads, the GLU MLP its ffn columns, rwkv6's
  mixes and the SSD their heads and columns, the head its vocab columns.
* **decode**: ``cache_init`` at the shape's seq and batch, placed by
  :func:`cache_shardings`, then one ``decode_step`` and ``lm_head``.
  Attention runs on the rank's own cache shard: its batch rows on the
  data axes and its KV heads on ``"model"``
  (:func:`~repro_torch.dist.placement.head_split`); the cache is never
  gathered whole.  The MLP computes its ffn columns, rwkv6's time mix its
  heads, reading them from the rank's own ``wkv_state`` shard (never
  gathered where they split), its channel mix its ffn columns, and the
  head its vocab columns (``model_split``).  Mamba2's state, placed with
  its heads on ``"model"``, is gathered over ``"model"`` for the step and
  its new value cut back to the rank's heads: the cached SSD computes
  whole, as the reference's does.
* The logits leave replicated (the reference's ``P()`` output), so a
  head split over ``"model"`` all-gathers its columns over it, and they
  are all-gathered over the data axes that split the batch.

``REPRO_TRAIN_BF16_PARAMS``, ``REPRO_SERVE_BF16`` and ``REPRO_PURE_DP``
act as in the reference.

The record (:func:`lower_cell`) keeps the reference's keys, so a roofline
script reads both.  What the port measures under them:

* ``memory.argument_bytes``: the rank's local bytes of parameters,
  moments, batch and cache (and the 4-byte ``cache_len`` of a decode
  step), from the placed shapes: equal to the reference's
  ``memory_analysis`` wherever the placements are equal.
  ``output_bytes``: the step's outputs (the new parameters and moments and
  the loss; the logits and the new cache).  ``temp_bytes``: the peak of
  the bytes of the storages the step makes while they are alive (a
  dispatch mode puts a weakref finalizer on each new output storage), the
  gradients, gathered parameters and activations included.
  ``generated_code_bytes`` is 0: nothing is compiled.
* ``cost.flops``: ``torch.utils.flop_counter``'s formulas (the matrix
  products and attention; elementwise work counts nothing, where XLA
  counts it).  ``cost["bytes accessed"]``: the sum of every tensor op's
  input and output bytes (views and the collectives' waits excluded): one
  read of each input and one write of each output per op, not XLA's
  fusion-level count.  Every layer runs (no scan), so the totals cover
  the whole depth; the probes remain for per-layer attribution.
* ``collectives``: per kind, under the reference's names (``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``), the count of collective ops the rank issued
  (``torch.distributed``'s and the functional collectives DTensor uses)
  and the bytes of their results, the reference's convention.
* ``hlo_lines``: the number of tensor ops the step dispatched, the length
  of the program the reference's HLO text measures.
* ``lower_s``: the seconds the fake step took.  There is no
  ``compile_s``: nothing is compiled.

Placement helpers used by the mesh launcher: :func:`param_shardings` and
:func:`batch_shardings` (reference ``launch/dryrun.py:63-75``), and
:func:`param_specs` under them.  The reference computes each spec on its
own leaves, where a scanned run's layers are one leaf ``[L, ...]``; the
port keeps one tensor per layer.  :func:`param_specs` computes the
reference's spec on the reference's leaf path and shape
(``registry.reference_paths`` / ``reference_shapes``) and gives the port's
tensor the entries of the dims it has.  Where the reference puts the FSDP
axes on the stacked layer dim (qwen2.5-14b and qwen2-72b on the pod mesh),
the port has no such dim: it shards the first of its own dims that the
rule would pick, i.e. ``param_spec`` on the port's own shape (option (b);
the memory per rank is the same, the gathers come per layer instead of
per layer group).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import sys
import time
import traceback
import weakref
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ARCHS, SHAPES, applicable, input_specs, model_kind
from repro_torch.dist import placement
from repro_torch.dist import sharding as shd
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig

__all__ = ["OUT_DIR", "TRAIN_ACCUM", "param_specs", "param_shardings", "batch_shardings",
           "cache_spec", "cache_shardings", "cache_leaves", "prepare_cfg", "Cell", "cell_rules", "build_cell",
           "argument_bytes", "Counter", "lower_cell", "run_cell", "refresh_probes", "main"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# per-arch microbatch accumulation for train_4k (the reference's)
TRAIN_ACCUM = {
    "qwen2-72b": 8, "mixtral-8x22b": 8, "qwen2.5-14b": 4,
}


def _flag(name: str) -> bool:
    return bool(int(os.environ.get(name, "0")))


# ---------------------------------------------------------------------------
# sharding helpers
# ---------------------------------------------------------------------------

def param_specs(model, cfg, mesh) -> dict:
    """{parameter name: its sanitized spec on ``mesh``} under the active
    rules (:func:`repro_torch.dist.sharding.set_rules`); ``mesh`` may be
    an :class:`~repro_torch.dist.sharding.AbstractMesh`."""
    paths = registry.reference_paths(model, cfg)
    shapes = registry.reference_shapes(model, cfg)
    out = {}
    for name, p in model.named_parameters():
        ref = shd.param_spec(paths[name], shapes[name])
        stacked = len(shapes[name]) - p.ndim
        if stacked and ref[0] is not None:
            spec = shd.param_spec(paths[name], tuple(p.shape))     # option (b)
        else:
            spec = ref[stacked:]
        out[name] = shd.sanitize(spec, tuple(p.shape), mesh)
    return out


def param_shardings(model, mesh, cfg) -> dict:
    """{parameter name: :class:`~repro_torch.dist.sharding.NamedSharding`}
    on the ``DeviceMesh`` ``mesh`` (the reference's tree of
    ``NamedSharding``)."""
    return {n: shd.NamedSharding(mesh, spec) for n, spec in param_specs(model, cfg, mesh).items()}


def _dp_size(mesh, dp_axes) -> int:
    shape = shd.mesh_shape(mesh)
    return math.prod(shape[a] for a in dp_axes)


def batch_shardings(batch: dict, mesh, dp_axes) -> dict:
    """{key: NamedSharding}: each array's first dim split over ``dp_axes``
    where it divides, else replicated (the reference's rule)."""
    def leaf(x):
        shape = tuple(x.shape)
        ok = len(shape) >= 1 and shape[0] % _dp_size(mesh, dp_axes) == 0
        return shd.NamedSharding(mesh, (tuple(dp_axes),) if ok else ())
    return {k: leaf(x) for k, x in batch.items()}


def cache_spec(name: str, shape: tuple, mesh, dp_axes) -> tuple:
    """The reference's cache rule for one leaf: batch -> the data axes (when
    they divide it), the KV-heads dim of attention K/V and the heads dim
    of the SSM/RWKV states -> ``"model"``, sanitized.  ``name`` is the
    leaf's ``/``-joined path (the reference's substrings: ``/k``, ``/v``,
    ``cross_``, ``ssm_state``, ``wkv_state``); the axes are found from the
    trailing structure, so a per-layer leaf and a scanned run's stacked
    one get the same entries on their common dims."""
    ndim = len(shape)
    dims: list[Any] = [None] * ndim
    if _attention_leaf(name) and ndim >= 4:
        b_ax, f_ax = ndim - 4, ndim - 2          # [., B, S, KV, dh]
    elif ("ssm_state" in name or "wkv_state" in name) and ndim >= 4:
        b_ax, f_ax = ndim - 4, ndim - 3          # [., B, H, ., .]
    elif ndim >= 3:                              # conv/shift [., B, ., C]
        b_ax, f_ax = ndim - 3, None
    else:
        b_ax, f_ax = 0, None
    if shape[b_ax] % _dp_size(mesh, dp_axes) == 0:
        dims[b_ax] = tuple(dp_axes)
    if f_ax is not None:
        dims[f_ax] = ("model",)
    return shd.sanitize(tuple(dims), shape, mesh)


def _attention_leaf(name: str) -> bool:
    """Whether the cache leaf at ``name`` is attention's K or V (self or
    cross), by the reference's substrings."""
    return "/k" in name or "/v" in name or "cross_" in name


def _cache_map(fn: Callable, cache: list) -> list:
    """``cache`` (one entry per layer, dicts of tensors) with each leaf
    ``x`` at path ``p`` replaced by ``fn(p, x)``; paths are
    ``<layer>/<key>/.../<leaf>``."""
    def walk(prefix, node):
        if isinstance(node, dict):
            return {k: walk(f"{prefix}/{k}", v) for k, v in node.items()}
        return fn(prefix, node)
    return [walk(str(li), entry) for li, entry in enumerate(cache)]


def cache_shardings(cache: list, mesh, dp_axes) -> list:
    """The cache's structure with a
    :class:`~repro_torch.dist.sharding.NamedSharding` per leaf
    (:func:`cache_spec`); ``mesh`` may be an AbstractMesh."""
    return _cache_map(lambda p, x: shd.NamedSharding(
        mesh, cache_spec(p, tuple(x.shape), mesh, dp_axes)), cache)


# ---------------------------------------------------------------------------
# what a step costs: one dispatch mode
# ---------------------------------------------------------------------------

#: the collective ops' names (the functional collectives and
#: torch.distributed's own) under the reference's kinds
_COLLECTIVE_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
                     ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
                     ("alltoall", "all-to-all"))
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "c10d")


def _collective_kind(func) -> str | None:
    if func.namespace not in _COLLECTIVE_NS:
        return None
    name = func._opname
    for key, kind in _COLLECTIVE_KINDS:
        if key in name:
            return kind
    return None


def _plain(xs) -> list:
    """The plain (non-DTensor) tensors among ``xs``."""
    return [x for x in xs if isinstance(x, torch.Tensor) and not placement.is_dtensor(x)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counter(TorchDispatchMode):
    """Counts, for every tensor op dispatched while it is active: FLOPs
    (``torch.utils.flop_counter``'s formulas), bytes accessed (inputs and
    outputs of each op that is not a view), the collectives by kind with
    their result bytes, the ops, and the bytes of the storages the ops
    make, alive and at their peak (each new output storage is watched
    with a weakref finalizer).  An op on DTensors counts nothing itself:
    the steps compute on local tensors, and DTensor's redistributions
    reach the mode as functional collectives."""

    def __init__(self):
        super().__init__()
        from torch.utils import flop_counter

        self._formulas = flop_counter.flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.ops = 0
        self.collectives: dict[str, dict[str, int]] = {}
        self.live = 0
        self.peak = 0
        self._live: dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _plain(tree_flatten((args, kwargs))[0])
        outs = _plain(tree_flatten(out)[0])
        self.ops += 1
        kind = _collective_kind(func)
        if kind is not None:
            rec = self.collectives.setdefault(kind, {"count": 0, "bytes": 0})
            rec["count"] += 1
            rec["bytes"] += sum(_nbytes(t) for t in outs)
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        held = {t.untyped_storage()._cdata for t in ins}
        aliasing = all(t.untyped_storage()._cdata in held for t in outs)
        if not func.is_view and not (aliasing and not func._schema.is_mutable):
            self.bytes_accessed += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in held or key in self._live:
                continue
            nb = st.nbytes()
            self._live[key] = nb
            self.live += nb
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def prepare_cfg(arch: str, shape_name: str, mesh, *,
                unrolled: bool = False, unroll_mult: int = 1) -> ModelConfig:
    """The cell's config: KV heads repeated so ``"model"`` divides them,
    the ``REPRO_HEAD_PAD`` q-group padding, ``max_seq_len`` and the
    unrolled probe's depth (the reference's)."""
    cfg = ARCHS[arch]
    tp = shd.mesh_shape(mesh).get("model", 1)
    # KV replication: smallest rep with (kv*rep) % tp == 0 that still divides
    # the query-head group structure (kv*rep must divide n_heads); rep=1
    # (replicated-KV sharding fallback) when impossible (whisper, internvl).
    rep = 1
    group = cfg.n_heads // cfg.n_kv_heads
    for cand in range(1, group + 1):
        if group % cand == 0 and (cfg.n_kv_heads * cand) % tp == 0:
            rep = cand
            break
    kw: dict[str, Any] = dict(kv_repeat=rep)
    if _flag("REPRO_HEAD_PAD") and (cfg.n_heads % tp or (cfg.n_kv_heads * rep) % tp):
        # q-group padding search: smallest padded group g' with kv*g' % tp
        # == 0 and a rep | g' making the KV cache shardable too
        for g2 in range(group, 4 * group + 1):
            if (cfg.n_kv_heads * g2) % tp:
                continue
            reps = [r for r in range(1, g2 + 1)
                    if g2 % r == 0 and (cfg.n_kv_heads * r) % tp == 0]
            if reps:
                kw["q_group_pad"] = g2
                kw["kv_repeat"] = reps[0]
                break
    kw["max_seq_len"] = SHAPES[shape_name].seq
    if unrolled:
        kw["use_scan"] = False
        kw["n_layers"] = len(cfg.block_pattern) * unroll_mult
        if cfg.encoder_layers:
            kw["encoder_layers"] = unroll_mult
    return cfg.replace(**kw)


def _dp_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


@contextlib.contextmanager
def cell_rules(shape_name: str, mesh):
    """The reference's rule table for a cell on ``mesh``, installed for the
    block (FSDP off under ``REPRO_SERVE_BF16`` serving, ``REPRO_PURE_DP``)."""
    serve_bf16 = SHAPES[shape_name].kind != "train" and _flag("REPRO_SERVE_BF16")
    shd.set_rules(mesh, shd.default_rules(multi_pod="pod" in mesh.mesh_dim_names,
                                          fsdp=not serve_bf16, pure_dp=_flag("REPRO_PURE_DP")))
    try:
        yield
    finally:
        shd.set_rules(None, None)


def _to_bf16(model: nn.Module, cfg: ModelConfig) -> None:
    """The reference's fp32 leaves of two dims or more in bf16, in place."""
    ndims = registry.reference_ndims(model, cfg)
    for name, p in list(model.named_parameters()):
        if p.dtype == torch.float32 and ndims[name] >= 2:
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner)
            mod._parameters[leaf] = nn.Parameter(p.detach().to(torch.bfloat16),
                                                 requires_grad=p.requires_grad)


def _frames(cfg: ModelConfig, bsz: int, device) -> dict:
    """The reference's ``_abstract_frames``: what ``cache_init`` reads,
    zeros on ``device``."""
    from repro_torch.models.vlm import VIT_WIDTH

    kind = model_kind(cfg)
    batch = {"tokens": torch.zeros((bsz, 1), dtype=torch.int32, device=device)}
    if kind == "whisper":
        batch["frames"] = torch.zeros((bsz, cfg.encoder_seq, cfg.d_model),
                                      dtype=torch.bfloat16, device=device)
    if kind == "vlm":
        batch["patches"] = torch.zeros((bsz, cfg.vision_seq, VIT_WIDTH),
                                       dtype=torch.bfloat16, device=device)
    return batch


def _rows(spec: torch.Tensor, mesh, dp_axes, device) -> tuple[torch.Tensor, bool]:
    """Zeros of this rank's rows of an input shaped as ``spec`` (its first
    dim split over ``dp_axes`` where they divide it), and whether it was
    split."""
    shape = tuple(spec.shape)
    split = len(shape) >= 1 and shape[0] % _dp_size(mesh, dp_axes) == 0
    if split:
        shape = (shape[0] // _dp_size(mesh, dp_axes),) + shape[1:]
    return torch.zeros(shape, dtype=spec.dtype, device=device), split


def _replace_axis(placements, mesh, axis: str, new):
    names = mesh.mesh_dim_names
    return tuple(new if names[i] == axis else pl for i, pl in enumerate(placements))


def _replicated(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t``, this rank's rows of a tensor split over ``axes`` on its first
    dim, gathered whole (every rank holds it: the reference's ``P()``
    output)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not axes:
        return t
    pl = tuple(Shard(0) if n in axes else Replicate() for n in mesh.mesh_dim_names)
    return DTensor.from_local(t, mesh, pl, run_check=False).redistribute(
        mesh, tuple(Replicate() for _ in pl)).to_local()


class Cell(NamedTuple):
    """A cell's placed state and its step.  ``args``: the rank's local
    tensors that the step takes (parameters, moments, batch, cache), by
    kind; ``step()`` runs the step once and returns its outputs (the
    parameters, moments and loss; the logits; the logits and new cache)."""
    cfg: ModelConfig
    model: nn.Module
    args: dict
    step: Callable[[], Any]
    #: the decode cache's DTensors (None off decode)
    cache: list | None


def build_cell(arch: str, shape_name: str, mesh, *, unrolled: bool = False,
               unroll_mult: int = 1, scale: float = 1.0, seed: int | None = None) -> Cell:
    """The cell's state placed on ``mesh`` (its rules installed:
    :func:`cell_rules`) and its step, on this rank's device of the mesh.
    ``seed=None`` leaves the weights uninitialized (the dry-run builds
    under ``FakeTensorMode``); an int draws them from that seed
    (``fns.init``), for a real run.  ``scale`` shrinks the batch
    (``input_specs``).  A decode step writes its token at the cache's last
    position, ``seq - 1``."""
    cfg = prepare_cfg(arch, shape_name, mesh, unrolled=unrolled, unroll_mult=unroll_mult)
    shape = SHAPES[shape_name]
    fns = registry.model_fns(cfg)
    dev = placement.local_device(mesh)
    dp_axes = _dp_axes(mesh)
    specs = input_specs(cfg, shape, scale=scale)
    if seed is None:
        model = registry.model_class(cfg)(cfg, device=dev)
    else:
        model = fns.init(seed, device=dev)
    low = (shape.kind != "train" and _flag("REPRO_SERVE_BF16")) or (
        shape.kind == "train" and _flag("REPRO_TRAIN_BF16_PARAMS"))
    if low:
        _to_bf16(model, cfg)
    cache = None
    if shape.kind == "decode":
        bsz = specs["tokens"].shape[0]
        with torch.no_grad():          # whisper's encoder runs on the whole model
            host_cache = fns.cache_init(model, _frames(cfg, bsz, dev), bsz, shape.seq)
        cache = _cache_map(lambda p, x: placement.distribute(
            x, mesh, shd.placements(cache_spec(p, tuple(x.shape), mesh, dp_axes), mesh)),
            host_cache)
        del host_cache
    placement.place_module(model, param_shardings(model, mesh, cfg))
    params = {n: placement.local(p) for n, p in model.named_parameters()}

    if shape.kind == "train":
        accum = 1 if unrolled else TRAIN_ACCUM.get(arch, 1)
        if accum > 1:
            specs = {k: torch.empty((v.shape[0] // accum,) + tuple(v.shape[1:]),
                                    dtype=v.dtype, device="meta") for k, v in specs.items()}
        batch, axes = _batch(specs, mesh, dp_axes, dev)
        model.requires_grad_(True)
        moments = {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                   for n, p in params.items()}
        step = _train_step(model, cfg, fns, batch, moments, mesh, axes)
        args = {"params": params, "moments": moments, "batch": batch}
    elif shape.kind == "prefill":
        batch, axes = _batch(specs, mesh, dp_axes, dev)
        step = _prefill_step(model, fns, batch, mesh, axes)
        args = {"params": params, "batch": batch}
    else:
        tokens, split = _rows(specs["tokens"], mesh, dp_axes, dev)
        axes = tuple(dp_axes) if split else ()
        step = _decode_step(model, cfg, fns, tokens, cache, shape.seq - 1, mesh, axes)
        args = {"params": params, "batch": {"tokens": tokens,
                                            "cache_len": torch.zeros((), dtype=torch.int32,
                                                                     device=dev)},
                "cache": {p: placement.local(x) for p, x in cache_leaves(cache).items()}}
    return Cell(cfg, model, args, step, cache)


def cache_leaves(cache: list) -> dict:
    """{path: tensor} of a cache (one entry per layer), paths as
    :func:`cache_spec` names them."""
    out = {}
    _cache_map(lambda p, x: out.__setitem__(p, x), cache)
    return out


def _batch(specs: dict, mesh, dp_axes, dev) -> tuple[dict, tuple]:
    batch, splits = {}, set()
    for k, v in specs.items():
        batch[k], split = _rows(v, mesh, dp_axes, dev)
        splits.add(split)
    if len(splits) > 1:
        raise ValueError(f"the batch's arrays split differently: {specs}")
    return batch, tuple(dp_axes) if splits.pop() else ()


def _train_step(model, cfg, fns, batch, moments, mesh, axes):
    from repro_torch.train.train_step import make_loss_fn

    loss_fn = make_loss_fn(fns, cfg, cast_bf16=_flag("REPRO_CAST_BF16"))
    bf16_grads = _flag("REPRO_BF16_GRAD_REDUCE")

    def step():
        with placement.batch_split(mesh, axes), placement.model_split(mesh), \
                placement.gathered(model):
            loss, _ = loss_fn(model, batch)
            loss.backward()
        with torch.no_grad():
            for n, p in model.named_parameters():
                w = placement.local(p)
                g = torch.zeros_like(w) if p.grad is None else placement.local(p.grad)
                p.grad = None
                if bf16_grads:
                    g = g.to(torch.bfloat16)
                m = moments[n]
                m.mul_(0.9).add_(g.float())
                del g
                w.copy_((w.float() - 1e-4 * m).to(w.dtype))
        return {n: placement.local(p) for n, p in model.named_parameters()}, moments, \
            loss.detach()
    return step


def _prefill_step(model, fns, batch, mesh, axes):
    def step():
        with torch.no_grad(), placement.batch_split(mesh, axes), placement.model_split(mesh), \
                placement.gathered(model):
            hidden, _, _ = fns.forward(model, batch)
            logits = fns.lm_head(model, hidden[:, -1:])
        return _replicated(logits, mesh, axes)
    return step


def _decode_step(model, cfg, fns, tokens, cache, cache_len, mesh, axes):
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.models.layers import tp_plan

    leaves = cache_leaves(cache)

    def gathered_states(part) -> dict:
        """The recurrent states placed with their heads on "model" that the
        step computes whole (Mamba2's; RWKV's where its heads do not split
        under ``part``): gathered over it for the step, their new values
        cut back to the rank's heads.  Attention K/V stay the rank's shard
        (placement.head_split), and so does a split RWKV's ``wkv_state``."""
        rwkv_split = part is not None and tp_plan(cfg, part[1]).get("rwkv_heads", False)
        return {p: _replace_axis(x.placements, mesh, "model", Replicate())
                for p, x in leaves.items()
                if not _attention_leaf(p) and not (rwkv_split and "wkv_state" in p)
                and any(n == "model" and pl.is_shard()
                        for n, pl in zip(mesh.mesh_dim_names, x.placements))}

    def step():
        with torch.no_grad(), placement.batch_split(mesh, axes), placement.head_split(mesh), \
                placement.model_split(mesh), placement.gathered(model):
            whole = gathered_states(placement.model_part())
            cache_in = _cache_map(lambda p, x: x.redistribute(mesh, whole[p]).to_local()
                                  if p in whole else placement.local(x), cache)
            hidden, new = fns.decode_step(model, tokens, cache_in, cache_len)
            logits = fns.lm_head(model, hidden)
            new = _cache_map(lambda p, t: DTensor.from_local(
                t, mesh, whole[p], run_check=False).redistribute(
                    mesh, leaves[p].placements).to_local() if p in whole else t, new)
        return _replicated(logits, mesh, axes), new
    return step


def _bytes(tree) -> int:
    return sum(_nbytes(t) for t in _plain(tree_flatten(tree)[0]))


def argument_bytes(cell: Cell) -> int:
    """The bytes of the rank's local arguments of ``cell``'s step:
    parameters, moments, batch and cache (and a decode step's 4-byte
    ``cache_len``)."""
    return _bytes(cell.args)


def lower_cell(arch: str, shape_name: str, mesh, *, unrolled: bool = False,
               unroll_mult: int = 1, scale: float = 1.0) -> dict:
    """The cell's record (see the module's docstring): its step run once
    on this rank of ``mesh`` under ``FakeTensorMode`` (nothing is
    allocated), with the rules of :func:`cell_rules`."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    # the groups of several mesh axes are made on real tensors, once
    for axes in (_dp_axes(mesh), ("model",)):
        if all(a in mesh.mesh_dim_names for a in axes):
            placement.axes_group(mesh, axes)
    with cell_rules(shape_name, mesh), FakeTensorMode(allow_non_fake_inputs=True):
        cell = build_cell(arch, shape_name, mesh, unrolled=unrolled, unroll_mult=unroll_mult,
                          scale=scale)
        t0 = time.perf_counter()
        with Counter() as counter:
            out = cell.step()
        lower_s = time.perf_counter() - t0
        cfg = cell.cfg
        return {
            "arch": arch, "shape": shape_name,
            "mesh": shd.mesh_shape(mesh), "unrolled": unrolled,
            "lower_s": round(lower_s, 1),
            "kv_repeat": cfg.kv_repeat,
            "params": int(cfg.param_count()),
            "active_params": int(cfg.active_param_count()),
            "memory": {"argument_bytes": argument_bytes(cell),
                       "output_bytes": _bytes(out),
                       "temp_bytes": counter.peak,
                       "generated_code_bytes": 0},
            "cost": {"flops": float(counter.flops),
                     "bytes accessed": float(counter.bytes_accessed)},
            "collectives": counter.collectives,
            "hlo_lines": counter.ops,
        }


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _fake_world(world: int):
    """A ``"fake"`` process group of ``world`` ranks, this process rank 0,
    for the block; an existing group is used as it is."""
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _production_mesh(mesh_kind: str, device: str):
    from repro_torch.launch.mesh import make_production_mesh

    return make_production_mesh(multi_pod=(mesh_kind == "multipod"), device_type=device)


def _mesh_dict(mesh_kind: str) -> dict:
    return ({"pod": 2, "data": 16, "model": 16} if mesh_kind == "multipod"
            else {"data": 16, "model": 16})


def run_cell(arch, shape_name, mesh_kind, *, unrolled_probe=False, out_dir=OUT_DIR,
             device: str = "cuda"):
    """One cell at rank 0 of a fake world of 256 (pod) or 512 (multipod)
    ranks: its record written to ``out_dir/<mesh>/<arch>__<shape>.json``
    and one ``OK``/``FAIL``/``SKIP`` line printed.  ``device``: the device
    type the mesh and the fake tensors claim."""
    cfg = ARCHS[arch]
    ok, reason = applicable(cfg, SHAPES[shape_name])
    cell_dir = os.path.join(out_dir, mesh_kind)
    os.makedirs(cell_dir, exist_ok=True)
    path = os.path.join(cell_dir, f"{arch}__{shape_name}.json")
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": _mesh_dict(mesh_kind),
               "skipped": True, "reason": reason}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"SKIP  {arch} x {shape_name} [{mesh_kind}]: {reason}")
        return rec
    try:
        with _fake_world(512 if mesh_kind == "multipod" else 256):
            mesh = _production_mesh(mesh_kind, device)
            rec = lower_cell(arch, shape_name, mesh)
            if unrolled_probe:
                rec["probe"] = lower_cell(arch, shape_name, mesh, unrolled=True,
                                          unroll_mult=1)
                rec["probe2"] = lower_cell(arch, shape_name, mesh, unrolled=True,
                                           unroll_mult=2)
        status = "OK"
    except Exception as e:
        rec = {"arch": arch, "shape": shape_name, "mesh": _mesh_dict(mesh_kind),
               "error": "".join(traceback.format_exception_only(e)).strip(),
               "traceback": traceback.format_exc()[-4000:]}
        status = "FAIL"
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    extra = ""
    if "memory" in rec:
        per_dev = rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"]
        extra = (f" mem/dev={per_dev / 2**30:.2f}GiB "
                 f"lower={rec.get('lower_s')}s "
                 f"coll={sum(v['bytes'] for v in rec.get('collectives', {}).values()) / 2**20:.0f}MiB")
    print(f"{status:4s}  {arch} x {shape_name} [{mesh_kind}]{extra}", flush=True)
    return rec


def refresh_probes(arch, shape_name, mesh_kind, out_dir=OUT_DIR, device: str = "cuda"):
    """Re-runs only the unrolled probes of an existing cell record."""
    path = os.path.join(out_dir, mesh_kind, f"{arch}__{shape_name}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rec = json.load(f)
    if rec.get("skipped") or "error" in rec:
        return rec
    try:
        with _fake_world(512 if mesh_kind == "multipod" else 256):
            mesh = _production_mesh(mesh_kind, device)
            rec["probe"] = lower_cell(arch, shape_name, mesh, unrolled=True, unroll_mult=1)
            rec["probe2"] = lower_cell(arch, shape_name, mesh, unrolled=True, unroll_mult=2)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"PROBE {arch} x {shape_name} [{mesh_kind}] refreshed", flush=True)
    except Exception as e:
        print(f"PROBE-FAIL {arch} x {shape_name}: {e}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--unrolled-probe", action="store_true")
    ap.add_argument("--probes-only", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device type the mesh and the fake tensors claim")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    args = ap.parse_args(argv)

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    cells = [(a, s, m) for m in meshes for a in archs for s in shapes]
    if args.probes_only:
        work = functools.partial(_probes, out_dir=args.out, device=args.device)
    else:
        work = functools.partial(_cell, unrolled_probe=args.unrolled_probe,
                                 out_dir=args.out, device=args.device)
    if args.jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(args.jobs, mp_context=multiprocessing.get_context("spawn"),
                                 max_tasks_per_child=1) as pool:
            recs = list(pool.map(work, cells))
    else:
        recs = [work(c) for c in cells]
    n_fail = sum(1 for r in recs if r is not None and "error" in r)
    sys.exit(1 if n_fail else 0)


def _cell(cell, **kw):
    return run_cell(*cell, **kw)


def _probes(cell, **kw):
    return refresh_probes(*cell, **kw)


if __name__ == "__main__":
    main()
