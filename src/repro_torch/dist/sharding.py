"""Logical-axis sharding rules (counterpart of :mod:`repro.dist.sharding`).

Model code never names mesh axes directly; it annotates activations with
*logical* axis names (``shd.shard(x, "batch", None, "heads", None)``) and
parameters are placed by :func:`param_spec`.  A rule table set once per
process (:func:`set_rules`) maps logical names to mesh axes; with no rules
active every annotation is a no-op, so the same model code runs unsharded
on one device and TP/FSDP-placed on a pod.

A spec is the reference's ``PartitionSpec`` as a tuple: one entry per
dim, each ``None`` (replicated), a mesh axis name, or a tuple of them (the
dim split over their product, the first the most significant).
:func:`placements` turns a spec into the DTensor placements of a
``torch.distributed`` ``DeviceMesh`` whose ``mesh_dim_names`` are the axis
names.  A mesh here is such a ``DeviceMesh`` or an :class:`AbstractMesh`
(axis names and sizes, no devices: the reference's
``jax.sharding.AbstractMesh``, for computing a pod's specs anywhere).

Departure from the reference: the port's model runs on local tensors (the
mesh train step gathers each layer's parameters, :mod:`repro_torch.dist.placement`),
so :func:`shard` is the identity on a plain tensor and a ``redistribute``
on a DTensor, where the reference's is a GSPMD constraint hint.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

__all__ = [
    "AbstractMesh", "set_rules", "active", "get_mesh", "rule", "default_rules",
    "shard", "sanitize", "param_spec", "path_name", "mesh_shape", "placements",
    "NamedSharding",
]

_MESH = None
_RULES: dict[str, Any] | None = None


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names without devices (the reference's
    ``jax.sharding.AbstractMesh(axis_sizes, axis_names)``)."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of an :class:`AbstractMesh` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def set_rules(mesh, rules: dict | None) -> None:
    """Install (or clear, with ``None, None``) the process-wide rule table."""
    global _MESH, _RULES
    _MESH = mesh
    _RULES = rules


def active() -> bool:
    return _MESH is not None and _RULES is not None


def get_mesh():
    return _MESH


def rule(name: str):
    """Mesh axis (or axes tuple) for a logical name; None when unmapped."""
    if _RULES is None:
        return None
    return _RULES.get(name)


def default_rules(*, fsdp: bool = False, multi_pod: bool = False,
                  pure_dp: bool = False) -> dict:
    """The standard rule table.

    ``fsdp`` additionally shards parameters over the data axes (one dim per
    param, picked by :func:`param_spec`).  ``pure_dp`` unmaps every model
    dimension (data parallelism only — the MoE ablation path).
    """
    dp = ("pod", "data") if multi_pod else ("data",)
    model = None if pure_dp else "model"
    return {
        "batch": dp,
        "heads": model,
        "kv_heads": model,
        "ffn": model,
        "vocab": model,
        "model_embed": None,      # activations stay replicated on d_model
        "expert_ffn": model,
        "fsdp": dp if fsdp else None,
    }


def _axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in axes)


def _axes_in_mesh(mesh, axes):
    if axes is None:
        return None
    tup = (axes,) if isinstance(axes, str) else tuple(axes)
    tup = tuple(a for a in tup if a in mesh_shape(mesh))
    if not tup:
        return None
    return tup[0] if len(tup) == 1 else tup


def sanitize(spec: tuple, shape, mesh) -> tuple:
    """Drop spec entries whose mesh axes are absent or do not divide the dim
    (and the trailing ``None`` s).

    Annotations degrade gracefully to replication, never an error.
    """
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim_size, axes in zip(shape, dims):
        axes = _axes_in_mesh(mesh, axes)
        if axes is not None and dim_size % _axes_size(mesh, axes) != 0:
            axes = None
        out.append(axes)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(spec: tuple, mesh) -> tuple:
    """The DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    per mesh dim, ``Shard(d)`` where the dim's axis shards tensor dim ``d``,
    else ``Replicate()``.  A tensor dim split over several axes must name
    them in mesh order (DTensor splits over the mesh dims in order, the
    first the most significant, as the reference's tuple entry does)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        tup = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in tup]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {axes} is not in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh`` (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def shard(x, *names):
    """Constrain ``x`` so dim ``i`` shards over the mesh axes of logical name
    ``names[i]`` (None = replicated).  No-op when no rules are active, and
    on a plain (local) tensor; a DTensor is redistributed."""
    if not active():
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = sanitize(tuple(rule(n) if n else None for n in names), x.shape, _MESH)
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


# ---------------------------------------------------------------------------
# parameter placement
# ---------------------------------------------------------------------------

def path_name(path) -> str:
    """A leaf's path as an ``"a/b/0/c"`` string: a string is kept as it
    is, a sequence of keys is joined."""
    if isinstance(path, str):
        return path
    return "/".join(str(p) for p in path)


#: parameter leaf names whose LAST dim is tensor-parallel (column parallel)
_TP_LAST = {"wq", "wk", "wv", "up", "gate", "wg", "in_proj", "w"}
#: parameter leaf names whose SECOND-TO-LAST dim is tensor-parallel (row par.)
_TP_FIRST = {"wo", "down", "out_proj"}


def param_spec(path, shape) -> tuple:
    """Spec for one parameter leaf (TP by name + optional FSDP), on the
    reference's leaf ``path`` and ``shape``.

    Works on both flat and scan-stacked ([L, ...]) leaves because only the
    trailing dims are matched.  The result still goes through
    :func:`sanitize` at placement time, so non-divisible dims replicate.
    """
    name = path_name(path)
    leaf = name.rsplit("/", 1)[-1]
    ndim = len(shape)
    spec: list = [None] * ndim
    model = rule("heads") or rule("ffn")
    if model is not None and ndim >= 2:
        if "embed" in name or "lm_head" in name:
            vocab = rule("vocab")
            if vocab is not None:
                # tok_embed [V, D] -> dim -2; lm_head/w [D, V] -> dim -1
                spec[-2 if "embed" in name else -1] = vocab
        elif leaf in _TP_LAST or any(s in name for s in ("experts/up",
                                                         "experts/gate")):
            spec[-1] = model
        elif leaf in _TP_FIRST or "experts/down" in name:
            spec[-2] = model
    fsdp_axes = rule("fsdp")
    if fsdp_axes is not None and _MESH is not None:
        size = _axes_size(_MESH, fsdp_axes)
        for dim in range(ndim):
            if spec[dim] is None and shape[dim] % size == 0 and shape[dim] > 1:
                spec[dim] = fsdp_axes
                break
    return tuple(spec)

