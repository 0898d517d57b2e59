"""Parameters placed on a ``DeviceMesh`` and the collectives of the mesh
train step (the part of the reference's GSPMD partitioning that the port
writes out by hand; no counterpart module in :mod:`repro.dist`).

The design:

* **Placement.**  Each parameter is an ``nn.Parameter`` holding a DTensor
  placed by the reference's :func:`~repro_torch.dist.sharding.param_spec`
  (:func:`place_module`; the specs come from
  :func:`repro_torch.launch.dryrun.param_shardings`).  The optimizer state
  (``m``, ``v``, the error feedback) takes the same placements, so each
  rank stores its share of everything, as under the reference's
  ``param_shardings``.
* **Compute on local tensors.**  The forward never runs on DTensors: a
  layer's parameters are gathered to whole tensors just before the layer
  runs (:func:`gathered_call`), inside the layer's
  ``torch.utils.checkpoint`` when remat is on, so the backward pass
  gathers them again, as GSPMD does.  The gather is all-gathers over the
  mesh dims the parameter is sharded on (FSDP's data axes and the model
  axis alike).
* **Compute split over ``"model"``.**  The train step runs in
  :func:`model_split`: attention (its cache-free path) computes this
  rank's share of the query heads and the GLU MLP its share of the ffn
  columns, as the reference's activation shardings (``"heads"``,
  ``"kv_heads"``, ``"ffn"`` on ``"model"``) make GSPMD do; K/V are this
  rank's KV heads where ``"model"`` divides them, whole otherwise; a dim
  ``"model"`` does not divide is computed whole (the reference's
  ``sanitize``).  The split layer's input goes through
  :func:`copy_to_group` and its output through :func:`all_reduce_sum`
  (Megatron's ``f`` and ``g``); it takes its share's columns of the
  gathered weights and marks them (:func:`sum_over_model`).  The head
  computes this rank's ``V / tp`` logit columns (the ``"vocab"``
  annotation, :func:`repro_torch.models.lm.vocab_part`): an untied
  ``lm_head.w``'s columns, marked; the tied ``embed.table``'s rows through
  :func:`take_share`, whose backward all-gathers their gradient over
  ``"model"``, so the table's whole gradient (the lookup's, equal on every
  rank, and the head's) is equal across a ``"model"`` group and the table
  is left unmarked.  The loss consumes the share
  (:func:`repro_torch.train.losses.chunked_ce`'s vocab-parallel chunks);
  a step that returns logits gathers them (:func:`gather_shares`).  rwkv6's
  time mix computes this rank's heads (``"heads"`` on r, k, v and w; the
  gate's ``"ffn"`` on ``d_model`` is their channels) and its channel mix
  its ``d_ff / tp`` key columns, with and without a cache
  (:func:`repro_torch.models.rwkv.rwkv6_apply`); the cache-free Mamba2
  layer its SSD heads, whose gate norm's statistic, a sum over every
  head's channels, is summed over ``"model"`` forward and backward
  (:func:`sum_over_group`; :func:`repro_torch.models.ssm.mamba2_apply`).
  The embedding lookup and the norms compute whole on each rank of a
  ``"model"`` group.  The MoE keeps its experts' ``d_ff``
  split over ``"model"`` and reduces with :func:`all_reduce_sum`
  (:func:`repro_torch.models.moe._moe_sharded`).  The dry-run's prefill
  step runs in :func:`model_split` too; its decode step runs in
  :func:`head_split`, where attention reads K/V that already hold this
  rank's KV heads, and in :func:`model_split`, where the MLP, rwkv6's
  mixes (reading the rank's heads of its ``wkv_state``) and the head
  split; the Mamba2 layer's cached path computes whole, as the
  reference's.
* **Gradients.**  The batch is split over the data axes
  (:func:`batch_split`); each rank's backward gives the gradient of its own
  rows.  The gather's backward turns it into the parameter's placement: a
  sum over the axes the batch is split on, and over ``"model"`` for a
  weight marked by :func:`sum_over_model` (each rank's gradient then holds
  only its own heads' or columns' part): a reduce-scatter where the
  parameter is sharded on that axis, an all-reduce where it is
  replicated; on the other axes the rank's own slice.  The loss is the
  global batch's (:func:`batch_sum` of the token sums: all-reduce forward,
  identity backward, Megatron's ``g``), so the summed gradients are the
  global batch's.

Without a placed model none of this runs: :func:`gathered_call` calls the
function directly and :func:`batch_sum` is the identity.  Inside
:func:`model_split` with a part whose group is None, one process computes
one share alone, with no collective; a share that sums a statistic over
its group (:func:`sum_over_group`) is then fed the sum (:func:`fed_sums`).
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch import Tensor, nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

from repro_torch.dist import sharding as shd

__all__ = ["is_dtensor", "local", "like", "mesh_of", "local_device", "dp_axes", "axes_group",
           "batch_split", "split_axes", "head_split", "head_part", "model_split",
           "model_part", "sum_over_model", "place_module", "distribute", "gather",
           "gathered", "gathered_call",
           "all_reduce_sum", "copy_to_group", "sum_over_group", "fed_sums",
           "take_share", "gather_shares",
           "batch_sum", "sum_over_shards",
           "describe"]


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def local(x):
    """This rank's part of a DTensor (an alias of its storage where no
    gradient is recorded), or ``x`` itself."""
    return x.to_local() if is_dtensor(x) else x


def like(ref, t: Tensor):
    """``t``, this rank's part of a tensor placed as ``ref``, as a DTensor
    placed as ``ref``; ``t`` itself where ``ref`` is a plain tensor."""
    if not is_dtensor(ref):
        return t
    return DTensor.from_local(t, ref.device_mesh, ref.placements, run_check=False,
                              shape=ref.shape, stride=ref.stride())


def mesh_of(module: nn.Module):
    """The ``DeviceMesh`` ``module``'s parameters are placed on, or None."""
    p = next(module.parameters(), None)
    return p.device_mesh if is_dtensor(p) else None


def local_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: its current CUDA device on a CUDA
    mesh, else the mesh's device type."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of ``mesh`` (the reference's ``("pod",
    "data")`` filter)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def axes_group(mesh, axes):
    """The process group over the ranks of the flattened mesh ``axes`` that
    share this rank's other coordinates; None for a group of one rank.
    Several axes make a group of their own, the same way on every rank
    (``DeviceMesh._flatten``), so every rank must ask for it."""
    axes = tuple(axes)
    names = tuple(mesh.mesh_dim_names)
    dims = [names.index(a) for a in axes]
    if dims != sorted(dims):
        raise ValueError(f"axes {axes} are not in the mesh's order {names}")
    if all(mesh.mesh.shape[d] == 1 for d in dims):
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


# ---------------------------------------------------------------------------
# the batch split
# ---------------------------------------------------------------------------

_SPLIT: tuple = (None, ())


@contextlib.contextmanager
def batch_split(mesh, axes):
    """Within the block, the activations hold this rank's rows of a batch
    split over the mesh ``axes`` (empty: every rank holds the whole
    batch).  The mesh train step runs its forward and backward in it."""
    global _SPLIT
    old, _SPLIT = _SPLIT, (mesh, tuple(axes))
    try:
        yield
    finally:
        _SPLIT = old


def split_axes() -> tuple[str, ...]:
    """The axes the current batch is split over (see :func:`batch_split`)."""
    return _SPLIT[1]


def _model_part(mesh) -> tuple:
    """``(this rank's index on "model", the axis size, its group or None
    for one rank)`` on ``mesh``; ``(0, 1, None)`` without a ``"model"``
    axis."""
    if "model" not in mesh.mesh_dim_names:
        return (0, 1, None)
    return (mesh.get_local_rank("model"), mesh.size(mesh.mesh_dim_names.index("model")),
            axes_group(mesh, ("model",)))


_HEADS: tuple | None = None


@contextlib.contextmanager
def head_split(mesh):
    """Within the block, attention whose K/V hold this rank's share of the
    KV heads over the mesh's ``"model"`` axis (a decode cache placed by
    ``launch.dryrun.cache_shardings``, or a cross-attention's cached K/V)
    computes this rank's query heads only and sums the head-split output
    projection over ``"model"``: Megatron's ``f`` on its input, ``g`` on
    its output (:func:`~repro_torch.models.layers.attn_apply`).  The mesh
    decode step runs in it; K/V that hold every head compute whole."""
    global _HEADS
    old, _HEADS = _HEADS, _model_part(mesh)
    try:
        yield
    finally:
        _HEADS = old


def head_part() -> tuple | None:
    """``(this rank's index on "model", the axis size, its group or None
    for one rank)`` inside :func:`head_split`, None outside it."""
    return _HEADS


_MODEL: tuple | None = None


@contextlib.contextmanager
def model_split(mesh=None, *, part: tuple | None = None):
    """Within the block, attention's cache-free path, the GLU MLP, rwkv6's
    time and channel mix, the cache-free Mamba2 layer and the head compute
    this rank's share over ``"model"`` (see the module's
    docstring; :func:`~repro_torch.models.layers.tp_plan` says what
    splits).  ``mesh``: the share is this rank's on the mesh's
    ``"model"`` axis, its collectives over that axis; where the rules
    (:mod:`~repro_torch.dist.sharding`) map ``"heads"`` to no axis (the
    reference's ``pure_dp``) nothing splits.  ``part``: ``(share, count,
    group)`` given outright; a group of None computes that share alone,
    with no collective, so one process can compute each share in turn.
    The mesh train step runs its forward and backward in it, the
    dry-run's prefill and decode steps their forward."""
    global _MODEL
    if part is None:
        part = _model_part(mesh)
        if shd.active() and shd.rule("heads") != "model":
            part = (0, 1, None)
    old, _MODEL = _MODEL, tuple(part)
    try:
        yield
    finally:
        _MODEL = old


def model_part() -> tuple | None:
    """``(this rank's share, the share count, the group or None)`` inside
    :func:`model_split` with more than one share, None otherwise."""
    return _MODEL if _MODEL is not None and _MODEL[1] > 1 else None


# ---------------------------------------------------------------------------
# placing parameters
# ---------------------------------------------------------------------------

def distribute(t: Tensor, mesh, placements) -> Tensor:
    """The whole tensor ``t`` (the same on every rank) as a DTensor placed
    by ``placements``: each rank keeps its slice, no collective."""
    return distribute_tensor(t.detach(), mesh, placements, src_data_rank=None)


def place_module(module: nn.Module, shardings: dict) -> nn.Module:
    """Replaces each of ``module``'s parameters named in ``shardings``
    ({name: :class:`~repro_torch.dist.sharding.NamedSharding`}) by a DTensor
    parameter with that placement (in place; the module is returned)."""
    for name, sh in shardings.items():
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner)
        p = mod._parameters[leaf]
        mod._parameters[leaf] = nn.Parameter(distribute(p, sh.mesh, sh.placements),
                                             requires_grad=p.requires_grad)
    return module


# ---------------------------------------------------------------------------
# the gather and the Megatron collectives
# ---------------------------------------------------------------------------

class _Gather(torch.autograd.Function):
    """Local part -> the tensor placed as ``target`` (forward); the
    gradient of that, placed as ``grad`` (and ``Partial`` on ``"model"``
    where ``marked[0]`` was set after the forward, :func:`sum_over_model`),
    -> the parameter's placement (backward)."""

    @staticmethod
    def forward(ctx, part, mesh, placed, target, grad, shape, stride, marked):
        ctx.args = mesh, placed, grad, shape, stride, marked
        full = DTensor.from_local(part, mesh, placed, run_check=False, shape=shape,
                                  stride=stride).redistribute(mesh, target).to_local()
        return full.view_as(full) if full is part else full

    @staticmethod
    def backward(ctx, g):
        mesh, placed, grad, shape, stride, marked = ctx.args
        if marked[0]:
            at = mesh.mesh_dim_names.index("model")
            grad = grad[:at] + (Partial(),) + grad[at + 1:]
        out = DTensor.from_local(g.contiguous(), mesh, grad, run_check=False, shape=shape,
                                 stride=stride).redistribute(mesh, placed).to_local()
        return out, None, None, None, None, None, None, None


def gather(p, keep: tuple = ()):
    """The parameter ``p`` as a local tensor for this rank's compute:
    whole, except on the mesh axes in ``keep``, which stay split.  A plain
    tensor is returned as it is.  Differentiable: the gradient reaching
    ``p`` is summed over the axes the batch is split on
    (:func:`batch_split`), and over ``"model"`` once the tensor is marked
    by :func:`sum_over_model`, and placed as ``p``."""
    if not is_dtensor(p):
        return p
    mesh, placed = p.device_mesh, p.placements
    names = mesh.mesh_dim_names
    split = tuple(a for a in split_axes() if a in names)
    target = tuple(pl if names[i] in keep else Replicate() for i, pl in enumerate(placed))
    grad = []
    for i, pl in enumerate(target):
        if names[i] in split:
            if not isinstance(pl, Replicate):
                raise ValueError(f"axis {names[i]} splits the batch; it cannot be kept")
            grad.append(Partial())
        else:
            grad.append(pl)
    marked = [False]
    out = _Gather.apply(p.to_local(), mesh, placed, target, tuple(grad), p.shape,
                        p.stride(), marked)
    if "model" in names and isinstance(target[names.index("model")], Replicate):
        out._sum_over_model = marked
    return out


def sum_over_model(w: Tensor) -> Tensor:
    """``w``, a gathered parameter that this rank's share of a computation
    split over ``"model"`` uses (:func:`model_split`): the gather's
    backward sums its gradient over ``"model"`` too, since each rank's
    holds only its share's part (a reduce-scatter where the parameter is
    sharded on ``"model"``, an all-reduce where it is replicated).  A
    plain tensor (or None) is returned as it is.  Returns ``w``."""
    marked = getattr(w, "_sum_over_model", None)
    if marked is not None:
        marked[0] = True
    return w


@contextlib.contextmanager
def _swapped(module: nn.Module, tensors: dict):
    """Within the block, ``module``'s parameters named in ``tensors`` read
    as those tensors (plain attributes in their owners' place)."""
    owners = []
    for name, t in tensors.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        owners.append((owner, leaf, owner._parameters.pop(leaf)))
        object.__setattr__(owner, leaf, t)
    try:
        yield module
    finally:
        for owner, leaf, p in owners:
            object.__delattr__(owner, leaf)
            owner._parameters[leaf] = p


def _own_placed(module: nn.Module) -> dict:
    """{name: parameter} of ``module``'s DTensor parameters that it gathers
    itself: those under a submodule whose ``gathers_own_params`` is true
    are left to that module (the model's layers, each gathered where it
    runs; the MoE, which keeps its experts' ``d_ff`` split)."""
    own = [prefix for prefix, m in module.named_modules()
           if prefix and getattr(m, "gathers_own_params", False)]
    return {n: p for n, p in module.named_parameters()
            if is_dtensor(p) and not any(n.startswith(f"{o}.") for o in own)}


@contextlib.contextmanager
def gathered(module: nn.Module):
    """Within the block, ``module``'s own placed parameters (see
    :func:`_own_placed`) read as their gathered whole tensors.  The mesh
    train step holds it over the forward and the backward, so the loss's
    checkpointed chunks recompute with the same tensors."""
    full = {n: gather(p) for n, p in _own_placed(module).items()}
    with _swapped(module, full):
        yield module


def gathered_call(fn, module: nn.Module, *args, **kw):
    """``fn(module, *args, **kw)`` with ``module``'s own placed parameters
    gathered for the call (:func:`gathered`).  Called inside a layer's
    checkpointed body, the recompute gathers again."""
    with gathered(module):
        return fn(module, *args, **kw)


class _AllReduceSum(torch.autograd.Function):
    """All-reduce sum forward, identity backward (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce sum backward (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: Tensor, group) -> Tensor:
    """Sum of ``x`` over ``group`` (identity without one); the backward
    passes each rank's gradient through unchanged: use it where every
    rank's result feeds the same replicated loss."""
    return x if group is None else _AllReduceSum.apply(x, group)


def copy_to_group(x: Tensor, group) -> Tensor:
    """``x`` (the same on every rank of ``group``) fed to a computation
    split over ``group``: its gradient is summed over the group."""
    return x if group is None else _CopyToGroup.apply(x, group)


class _SumOverGroup(torch.autograd.Function):
    """All-reduce sum forward and backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


_FEED = None


@contextlib.contextmanager
def fed_sums(feed):
    """Within the block, :func:`sum_over_group` over a part whose group is
    None (one process computing one share alone) returns ``feed(x)``, ``x``
    being the share's own term: the caller supplies the group's sum (see
    ``chip_smoke.split_shares``)."""
    global _FEED
    old, _FEED = _FEED, feed
    try:
        yield
    finally:
        _FEED = old


def sum_over_group(x: Tensor, part: tuple) -> Tensor:
    """``x``, this share's term of a statistic that every share of ``part =
    (r, tp, group)`` consumes (the SSD gate norm's sum of squares), summed
    over the group; the backward sums the gradient over the group too,
    since each rank's holds only its own share's use of the sum.  Without
    a group the sum comes from :func:`fed_sums` (a ``ValueError`` outside
    it)."""
    if part[2] is not None:
        return _SumOverGroup.apply(x, part[2])
    if _FEED is None:
        raise ValueError("a share computed alone needs its group's sum: "
                         "placement.fed_sums supplies it")
    return _FEED(x)


class _TakeShare(torch.autograd.Function):
    """Share ``r`` of ``tp`` equal blocks of ``x`` along ``dim`` (forward);
    the gradients of every rank's block all-gathered over the group into
    one of ``x``'s shape (backward), zeros outside the block without a
    group."""

    @staticmethod
    def forward(ctx, x, dim, part):
        r, tp, group = part
        ctx.dim, ctx.part, ctx.shape = dim, part, x.shape
        n = x.shape[dim] // tp
        return x.narrow(dim, r * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        r, tp, group = ctx.part
        if group is None:
            whole = g.new_zeros(ctx.shape)
            whole.narrow(ctx.dim, r * g.shape[ctx.dim], g.shape[ctx.dim]).copy_(g)
            return whole, None, None
        return _all_gather_cat(g, ctx.dim, tp, group), None, None


class _GatherShares(torch.autograd.Function):
    """Every rank's block all-gathered over the group along ``dim``
    (forward); this rank's block of the gradient (backward: the whole
    result feeds the same replicated computation on every rank)."""

    @staticmethod
    def forward(ctx, x, dim, part):
        r, tp, group = part
        ctx.dim, ctx.r, ctx.n = dim, r, x.shape[dim]
        return _all_gather_cat(x, dim, tp, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.r * ctx.n, ctx.n), None, None


def _all_gather_cat(x: Tensor, dim: int, tp: int, group) -> Tensor:
    parts = [torch.empty_like(x) for _ in range(tp)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def take_share(x: Tensor, dim: int, part: tuple) -> Tensor:
    """Share ``r`` of ``part = (r, tp, group)``: the ``r``-th of ``tp``
    equal blocks of ``x`` (the same on every rank of ``group``) along
    ``dim``.  Its gradient is every rank's block's gradient all-gathered
    over the group, so ``x``'s whole gradient is equal across the group
    and needs no sum over it (the tied embedding's rows the head takes,
    beside the lookup's use of the whole table).  Without a group the
    gradient holds the block's part alone."""
    return _TakeShare.apply(x, dim, part)


def gather_shares(x: Tensor, dim: int, part: tuple) -> Tensor:
    """``x``, share ``r`` of ``part = (r, tp, group)``, all-gathered with
    the other ranks' shares along ``dim`` (every rank holds the whole);
    ``x`` itself without a group."""
    return x if part[2] is None else _GatherShares.apply(x, dim, part)


def batch_sum(x: Tensor) -> Tensor:
    """``x`` summed over the ranks the batch is split over
    (:func:`batch_split`); the identity outside a split."""
    mesh, axes = _SPLIT
    return x if not axes else all_reduce_sum(x, axes_group(mesh, axes))


# ---------------------------------------------------------------------------
# reductions over a placed tree
# ---------------------------------------------------------------------------

def _sharded_axes(t) -> tuple[str, ...]:
    if not is_dtensor(t):
        return ()
    names = t.device_mesh.mesh_dim_names
    return tuple(names[i] for i, pl in enumerate(t.placements) if isinstance(pl, Shard))


def sum_over_shards(values: dict, tensors: dict) -> Tensor:
    """The sum of ``values`` (a scalar per key, each computed on this
    rank's part of ``tensors[key]``) over every element once: the values
    of the tensors sharded over one process group are summed, then
    all-reduced over that group only, so replicated copies count once.
    The values with no group to reduce over (plain tensors, or parts on
    mesh axes of one rank) are summed in their order, as a one-device sum
    is."""
    groups: dict = {}
    for key, v in values.items():
        t = tensors[key]
        axes = _sharded_axes(t)
        group = axes_group(t.device_mesh, axes) if axes else None
        groups[group] = v if group not in groups else groups[group] + v
    total = None
    for group, s in groups.items():
        if group is not None:
            dist.all_reduce(s, group=group)
        total = s if total is None else total + s
    return total


def describe(module: nn.Module) -> dict:
    """{name: (local shape, global shape, placements as text)} of
    ``module``'s parameters."""
    out = {}
    for n, p in module.named_parameters():
        out[n] = (tuple(local(p).shape), tuple(p.shape),
                  str(tuple(p.placements)) if is_dtensor(p) else "plain")
    return out
