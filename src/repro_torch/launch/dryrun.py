"""The dry-run's placement helpers (counterpart of :mod:`repro.launch.dryrun`,
in part).

Ported: :func:`param_shardings` and :func:`batch_shardings`, which the
mesh launcher places the train state and the batch with (reference
``launch/dryrun.py:63-75``), and :func:`param_specs` under them.  The rest
of the reference's module (AOT lowering of every arch x shape x mesh cell,
``memory_analysis``, the collectives parsed from the HLO, with
``configs/shapes.py:input_specs``) is not ported: :func:`run_cell` and
:func:`main` raise (ROADMAP Queue 1).

The reference computes each spec on its own leaves, where a scanned run's
layers are one leaf ``[L, ...]``; the port keeps one tensor per layer.
:func:`param_specs` computes the reference's spec on the reference's leaf
path and shape (``registry.reference_paths`` / ``reference_shapes``) and
gives the port's tensor the entries of the dims it has.  Where the
reference puts the FSDP axes on the stacked layer dim (qwen2.5-14b and
qwen2-72b on the pod mesh), the port has no such dim: it shards the first
of its own dims that the rule would pick, i.e. ``param_spec`` on the
port's own shape (option (b); the memory per rank is the same, the
gathers come per layer instead of per layer group).
"""
from __future__ import annotations

import math

from repro_torch.dist import sharding as shd
from repro_torch.models import registry

__all__ = ["param_specs", "param_shardings", "batch_shardings", "run_cell", "main"]


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


def run_cell(*_, **__):
    raise NotImplementedError(
        "the dry-run's AOT lowering and memory analysis are not ported yet; "
        "see ROADMAP Queue 1 (launch/dryrun.py with configs/shapes.py:input_specs)")


def main(argv=None):
    run_cell()
