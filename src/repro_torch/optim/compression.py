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
it); without it every tensor is its own leaf.  On a mesh each rank
quantizes its part of each DTensor, and the scale is still the whole
leaf's: the leaves' absmax are max-reduced over the ranks in one
all-reduce.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import Tensor

from repro_torch.dist import placement

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
    targets = {n: placement.local(g).float() + placement.local(err[n])
               for n, g in grads.items()}
    if groups is None:
        groups = {n: n for n in grads}
    absmax = {}
    for n, t in targets.items():
        m = t.abs().max()
        absmax[groups[n]] = m if groups[n] not in absmax else torch.maximum(absmax[groups[n]], m)
    mesh = next((g.device_mesh for g in grads.values() if placement.is_dtensor(g)), None)
    group = None if mesh is None else placement.axes_group(mesh, mesh.mesh_dim_names)
    if group is not None:
        # the whole leaf's absmax: a max over every rank's part of the mesh
        # (a replicated part is the same on each rank)
        stacked = torch.stack(list(absmax.values()))
        dist.all_reduce(stacked, op=dist.ReduceOp.MAX, group=group)
        absmax = dict(zip(absmax, stacked))
    deq, new_err = {}, {}
    for n, g in grads.items():
        s = _scale(absmax[groups[n]])
        d = dequantize(_quantize(targets[n], s), s)
        deq[n] = placement.like(g, d.to(g.dtype))
        new_err[n] = placement.like(err[n], targets[n] - d)
    return deq, new_err


def init_error(params) -> dict:
    """float32 zeros of each parameter's shape, by name, on its device
    (placed as the parameter on a mesh)."""
    return {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.named_parameters()}
