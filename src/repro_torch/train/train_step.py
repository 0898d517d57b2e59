"""The train step: loss -> grads -> (optional compression) -> AdamW
(counterpart of :mod:`repro.train.train_step`).

Supports microbatch gradient accumulation (``accum`` splits the batch
along its first dim; each microbatch's backward adds into the parameters'
``.grad``, and the sum is divided by ``accum``).  The state keeps the
reference's shape, ``{"params", "opt": {"step", "m", "v"}, "step",
["err"]}``: ``params`` is the model, an ``nn.Module`` with gradients on,
the rest tensors (dicts of them by parameter name).  The step updates the
state's tensors in place (see :mod:`repro_torch.optim.adamw`) and returns
the state.

On a mesh (:func:`place_state`: the parameters, moments and error feedback
DTensors placed by ``launch.dryrun.param_shardings``) the same step runs
the reference's partitioned program by hand
(:mod:`repro_torch.dist.placement`): the batch is split over the data axes,
each layer gathers its parameters, attention, the GLU MLP and the head
compute this rank's heads, ffn columns and vocab columns of the
``"model"`` axis (:func:`placement.model_split`), the cross-entropy is
vocab-parallel over them, the loss is the global batch's token-weighted
mean (an all-reduce of the token sums, not a mean of the ranks' means),
and each gradient arrives summed over the data axes (and over ``"model"``
for the split layers' weights; the tied embedding's head rows all-gathered
over it) and placed as its parameter (reduce-scattered over its FSDP
axes).
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.dist import placement
from repro_torch.models import lm as lm_mod
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ModelFns
from repro_torch.optim import adamw, compression, schedule
from repro_torch.train.losses import chunked_ce

__all__ = ["make_loss_fn", "make_train_step", "init_state", "state_from_reference",
           "place_state"]


class _Cast(nn.Module):
    """Holds the model, so ``torch.func.functional_call`` can swap in its
    bf16 copies for one forward (the model has no ``forward`` of its own)."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, batch):
        return self.fn(self.model, batch)


def make_loss_fn(fns: ModelFns, cfg: ModelConfig, *, aux_weight: float = 0.01,
                 cast_bf16: bool = False):
    """``loss_fn(params, batch) -> (loss, metrics)``, differentiable in
    ``params``.  ``cast_bf16``: cast the fp32 matrices to bf16 ONCE at loss
    entry (mixed precision: the casts are differentiable, so the gradients
    land in the fp32 masters the optimizer keeps).  The matrices are the
    reference's: its float32 leaves of two dims or more, so a 1-D
    parameter of a scanned run, which the reference stacks into a 2-D
    leaf, is cast too."""
    if cast_bf16:
        ndims = registry.reference_ndims(registry.model_class(cfg)(cfg, device="meta"), cfg)

    def body(params, batch):
        hidden, _, aux = fns.forward(params, batch)
        off = fns.loss_offset(batch)
        labels = batch["labels"]
        if off:
            # prefix positions (vision/audio) carry no next-token loss
            hidden = hidden[:, off:]
        # the head's weight (inside model_split this rank's vocab columns,
        # which the loss consumes as they are), taken once for every chunk
        w = lm_mod.head_weight(params, cfg)
        head_fn = functools.partial(lm_mod.lm_head_share, params, cfg=cfg, w=w)
        loss, metrics = chunked_ce(hidden, labels, head_fn, cfg, psum=placement.batch_sum,
                                   vocab=lm_mod.vocab_part(cfg))
        loss = loss + aux_weight * aux
        metrics["aux"] = aux
        return loss, metrics

    def loss_fn(params, batch):
        if not cast_bf16:
            return body(params, batch)
        low = {f"model.{n}": p.to(torch.bfloat16)
               if (p.dtype == torch.float32 and ndims[n] >= 2) else p
               for n, p in params.named_parameters()}
        return torch.func.functional_call(_Cast(params, body), low, (batch,))
    return loss_fn


def _split(batch: dict, accum: int) -> list:
    """``accum`` microbatches of ``batch``, each a dict of views along the
    first dim."""
    out = []
    for i in range(accum):
        mb = {}
        for k, x in batch.items():
            rows = x.shape[0] // accum
            mb[k] = x[i * rows:(i + 1) * rows]
        out.append(mb)
    return out


def _local_batch(batch: dict, device):
    """(this rank's rows of ``batch``, the mesh axes they are split over).
    DTensors (``make_global``'s, split over the data axes) give their
    local parts; numpy arrays or tensors are the whole batch on every rank
    (the reference's replicated batch, where the data axes do not divide
    it), split over no axis."""
    out, split = {}, set()
    for k, x in batch.items():
        if placement.is_dtensor(x):
            names = x.device_mesh.mesh_dim_names
            split.add(tuple(names[i] for i, pl in enumerate(x.placements) if pl.is_shard(0)))
            out[k] = x.to_local()
        else:
            split.add(())
            out[k] = torch.as_tensor(x, device=device)
    if len(split) > 1:
        raise ValueError(f"the batch's arrays are split over different axes: {split}")
    return out, split.pop() if split else ()


@contextlib.contextmanager
def _on_mesh(params, mesh, axes):
    """The batch split over ``axes``; attention's heads, the GLU MLP's ffn
    columns and the head's vocab columns split over ``"model"``
    (:func:`placement.model_split`; the loss then takes the vocab-parallel
    cross-entropy, :func:`make_loss_fn`); and the model's top-level
    parameters (embedding, final norm, head) gathered whole, for a forward
    and backward; each layer gathers its own in the model's forward.  The
    rwkv6 and SSD layers, the norms and the embedding lookup compute
    whole."""
    with placement.batch_split(mesh, axes), placement.model_split(mesh), \
            placement.gathered(params):
        yield


def make_train_step(
    fns: ModelFns,
    cfg: ModelConfig,
    *,
    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
    lr_schedule=functools.partial(schedule.warmup_cosine, peak_lr=3e-4,
                                  warmup_steps=100, total_steps=10000),
    accum: int = 1,
    compress_grads: bool = False,
):
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params", "opt", "step", ["err"]}; ``batch`` holds tensors on
    the model's device (or numpy arrays, moved there).  ``loss`` is the
    microbatches' mean; the other loss metrics are the last microbatch's.
    """
    loss_fn = make_loss_fn(fns, cfg)
    # fixed for the model: each parameter's leaf in the reference's pytree
    # names its decay and its compression scale
    paths = registry.reference_paths(registry.model_class(cfg)(cfg, device="meta"), cfg)
    decay = adamw._decay_mask(paths, opt_cfg)

    def train_step(state, batch):
        params = state["params"]
        mesh = placement.mesh_of(params)
        if mesh is None:
            batch = {k: torch.as_tensor(x, device=params.device) for k, x in batch.items()}
            split = contextlib.nullcontext()
        else:
            batch, axes = _local_batch(batch, params.device)
            split = _on_mesh(params, mesh, axes)
        for p in params.parameters():
            p.grad = None
        lsum = None
        with split:       # the backward recomputes (remat) under the same split
            for mb in _split(batch, accum):
                loss, metrics = loss_fn(params, mb)
                loss.backward()                 # adds into each p.grad
                loss = loss.detach()
                lsum = loss if lsum is None else lsum + loss
        # a parameter the loss does not reach has a zero gradient (the
        # reference's value_and_grad)
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in params.named_parameters()}
        if accum > 1:
            grads = {n: g / accum for n, g in grads.items()}
            loss = lsum / accum
        metrics = {k: v.detach() for k, v in metrics.items()}

        if compress_grads:
            grads, new_err = compression.compress_tree(grads, state["err"], paths)

        lr = lr_schedule(state["opt"]["step"])
        params, new_opt, opt_metrics = adamw.update(grads, state["opt"], params, lr, opt_cfg,
                                                      decay=decay)
        for p in params.parameters():
            p.grad = None
        metrics = dict(metrics, loss=loss, **opt_metrics)
        new_state = {"params": params, "opt": new_opt, "step": state["step"] + 1}
        if compress_grads:
            new_state["err"] = new_err
        return new_state, metrics

    return train_step


def _state(params, compress_grads: bool) -> dict:
    st = {"params": params, "opt": adamw.init(params),
          "step": torch.zeros((), dtype=torch.int32, device=params.device)}
    if compress_grads:
        st["err"] = compression.init_error(params)
    return st


def init_state(fns: ModelFns, seed=0, *, compress_grads: bool = False,
               abstract: bool = False, device=None):
    """A fresh train state: ``fns.init(seed, device)`` with gradients on,
    zero moments (and zero error feedback with ``compress_grads``).
    ``abstract=True`` builds the same state on the ``meta`` device, shapes
    and dtypes without storage (the reference's ``jax.eval_shape``), e.g.
    as the target of a checkpoint restore."""
    if abstract:
        params = registry.model_class(fns.cfg)(fns.cfg, device="meta")
    else:
        params = fns.init(seed, device=resolve_device(device))
    return _state(params.requires_grad_(True), compress_grads)


def place_state(state: dict, shardings: dict) -> dict:
    """``state`` placed on a mesh: each parameter named in ``shardings``
    ({name: :class:`~repro_torch.dist.sharding.NamedSharding}``, e.g.
    ``launch.dryrun.param_shardings``) becomes a DTensor parameter in place,
    and its moments and error feedback DTensors of the same placement.
    Every rank must hold the same whole state (the same seed); each keeps
    its slice, with no collective."""
    placement.place_module(state["params"], shardings)

    def put(tree):
        return {n: placement.distribute(t, shardings[n].mesh, shardings[n].placements)
                if n in shardings else t for n, t in tree.items()}

    out = dict(state, opt=dict(state["opt"], m=put(state["opt"]["m"]),
                               v=put(state["opt"]["v"])))
    if "err" in state:
        out["err"] = put(state["err"])
    return out


def state_from_reference(ref_state_np: dict, cfg: ModelConfig, device=None) -> dict:
    """The reference's train state (numpy leaves, e.g.
    ``jax.tree.map(np.asarray, state)``) as the port's: the params through
    ``registry.params_from_reference``; ``m``, ``v`` and ``err``, which
    share the params' tree, through the same leaf map."""
    dev = resolve_device(device)
    params = registry.params_from_reference(ref_state_np["params"], cfg, dev)

    def leaves(tree):
        return {n: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
                for n, a in registry.reference_leaves(tree, cfg).items()}

    def scalar(a):
        return torch.as_tensor(np.array(a), dtype=torch.int32, device=dev)

    opt = ref_state_np["opt"]
    st = {"params": params.requires_grad_(True),
          "opt": {"step": scalar(opt["step"]), "m": leaves(opt["m"]), "v": leaves(opt["v"])},
          "step": scalar(ref_state_np["step"])}
    if "err" in ref_state_np:
        st["err"] = leaves(ref_state_np["err"])
    return st
