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
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ModelFns
from repro_torch.optim import adamw, compression, schedule
from repro_torch.train.losses import chunked_ce

__all__ = ["make_loss_fn", "make_train_step", "init_state", "state_from_reference"]


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
        loss, metrics = chunked_ce(hidden, labels, lambda h: fns.lm_head(params, h), cfg)
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
        batch = {k: torch.as_tensor(x, device=params.device) for k, x in batch.items()}
        for p in params.parameters():
            p.grad = None
        lsum = None
        for mb in _split(batch, accum):
            loss, metrics = loss_fn(params, mb)
            loss.backward()                     # adds into each p.grad
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
