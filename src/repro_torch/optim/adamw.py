"""AdamW with decoupled weight decay and global-norm clipping (counterpart
of :mod:`repro.optim.adamw`).

``init(params) -> state``; ``update(grads, state, params, lr, decay=...)
-> (params, state, metrics)``.  ``params`` is the model (an ``nn.Module``); ``m``,
``v`` and ``grads`` are dicts of tensors by its parameter names, ``m`` and
``v`` float32.  The port's idiom departs from the reference's functional
update in one way: ``update`` writes the parameters and the moments in
place under ``torch.no_grad()`` and returns the same objects (a functional
copy would write every parameter once more each step).  The arithmetic is
the reference's, op for op: the clip scale, the float32 bias corrections,
the moments, ``new_p`` computed in float32 and cast back to ``p.dtype``.

On a mesh the parameters, their gradients and the moments are DTensors of
one placement each (:mod:`repro_torch.dist.placement`): the update is
elementwise, so each rank updates its own part, and :func:`global_norm`
sums every element once across the shards (replicated copies count once),
so the clip scale is the one-device run's.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from repro_torch.dist import placement

__all__ = ["AdamWConfig", "init", "global_norm", "update"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # parameters whose path matches any of these fragments get NO decay
    no_decay: tuple[str, ...] = ("scale", "bias", "norm", "dt_bias", "A_log",
                                 "D", "w0", "u", "mu")


def _decay_mask(paths: dict, cfg: AdamWConfig) -> dict:
    """{parameter name: decayed?} from ``paths``, {parameter name: the
    reference's leaf path}.  The reference matches ``cfg.no_decay`` as
    substrings of each leaf's ``/``-joined path in *its* pytree, so the
    mask is computed from those paths (``registry.reference_paths``, which
    the train step passes once), not from the port's names.  The match is
    the reference's, quirks included: "u" exempts ``w_up``, ``experts/up``,
    ``router`` and ``out_proj``."""
    return {name: not any(frag in path for frag in cfg.no_decay)
            for name, path in paths.items()}


def init(params) -> dict:
    def zeros():   # placed as its parameter on a mesh
        return {n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.named_parameters()}
    return {"step": torch.zeros((), dtype=torch.int32, device=params.device),
            "m": zeros(), "v": zeros()}


def global_norm(tree: dict) -> Tensor:
    """sqrt of the sum of squares of every tensor of ``tree``, in float32;
    a DTensor's elements are summed over its shards, each once."""
    sq = {n: torch.sum(torch.square(placement.local(t).float())) for n, t in tree.items()}
    return torch.sqrt(placement.sum_over_shards(sq, tree))


def update(grads: dict, state: dict, params, lr, cfg: AdamWConfig = AdamWConfig(), *,
           decay: dict):
    """One AdamW step, in place.  ``decay``: {parameter name: decayed?}
    (:func:`_decay_mask`).  Returns (params, new state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state["step"] + 1
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())
    lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
    with torch.no_grad():
        for name, p in params.named_parameters():
            p = placement.local(p)             # this rank's part, aliased
            m, v = placement.local(state["m"][name]), placement.local(state["v"][name])
            g = placement.local(grads[name]).float() * scale
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            if cfg.weight_decay and decay[name]:
                delta = delta + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"step": step, "m": state["m"], "v": state["v"]}, metrics
