"""Gradient compression with error feedback (int8, per-tensor scale;
counterpart of :mod:`repro.optim.compression`).

Error feedback (Seide et al. / EF-SGD) carries the quantization residual
into the next step, so the running sum of the compressed gradients stays
within O(1) of the true sum whatever the step count.  ``train_step(...,
compress_grads=True)`` quantizes the accumulated gradient before the
optimizer; on one device nothing is all-reduced, so the int8 payload's
saving waits for the port's data-parallel path.  ``torch.round`` rounds
half to even, as ``jnp.round`` does, so the int8 values are the
reference's.  Trees are dicts of tensors by parameter name.

The scale is per *reference* leaf: where the reference stacks a run of
layers into one leaf (``lax.scan``), one scale serves all of them, the
largest |target| over the run.  ``compress_tree``'s ``groups`` names each
parameter's leaf (``registry.reference_paths``, as the train step passes
it); without it every tensor is its own leaf.
"""
from __future__ import annotations

import torch
from torch import Tensor

__all__ = ["quantize", "dequantize", "compress_tree", "init_error"]


def _scale(absmax: Tensor) -> Tensor:
    return torch.clamp(absmax, min=1e-12) / 127.0


def _quantize(gf: Tensor, scale: Tensor) -> Tensor:
    return torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)


def quantize(g: Tensor):
    """fp -> (int8, scale).  Symmetric per-tensor."""
    gf = g.float()
    scale = _scale(gf.abs().max())
    return _quantize(gf, scale), scale


def dequantize(q: Tensor, scale: Tensor) -> Tensor:
    return q.float() * scale


def compress_tree(grads: dict, err: dict, groups: dict | None = None):
    """Quantize grads + error-feedback residual.

    ``groups``: {name: leaf} (see the module's docstring); the names of one
    leaf share its scale.  Returns (dequantized grads to feed the
    optimizer, new err), dicts with ``grads``' keys."""
    targets = {n: g.float() + err[n] for n, g in grads.items()}
    if groups is None:
        groups = {n: n for n in grads}
    absmax = {}
    for n, t in targets.items():
        m = t.abs().max()
        absmax[groups[n]] = m if groups[n] not in absmax else torch.maximum(absmax[groups[n]], m)
    deq, new_err = {}, {}
    for n, g in grads.items():
        s = _scale(absmax[groups[n]])
        d = dequantize(_quantize(targets[n], s), s)
        deq[n], new_err[n] = d.to(g.dtype), targets[n] - d
    return deq, new_err


def init_error(params) -> dict:
    """float32 zeros of each parameter's shape, by name, on its device."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.named_parameters()}
