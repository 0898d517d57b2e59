"""Production mesh construction (counterpart of :mod:`repro.launch.mesh`).

A mesh is a ``torch.distributed`` ``DeviceMesh`` whose ``mesh_dim_names``
are the reference's axis names, one rank per device.  Functions, not
module constants, so importing this module touches no process group.
The process group must exist, or be creatable from the environment
(``torchrun``'s variables), before a mesh is made; a CUDA mesh needs NCCL
(or the ``"fake"`` backend of the dry-run, whose collectives move nothing)
and never falls back to gloo.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

__all__ = ["make_production_mesh", "make_host_mesh"]


def _mesh(device_type: str, shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    if dist.is_initialized():
        world = dist.get_world_size()
        if world != math.prod(shape):
            raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the process "
                             f"group has {world}")
        backend = str(dist.get_backend())
        if device_type == "cuda" and "nccl" not in backend and backend != "fake":
            raise RuntimeError(f"a CUDA mesh needs the NCCL backend (or the dry-run's "
                               f"fake one), not {backend!r}")
    if device_type == "cuda":
        torch.cuda.set_device(int(dist.get_rank() if dist.is_initialized() else 0)
                              % torch.cuda.device_count())
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 single pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, pod: int | None = None, *,
                   device_type: str = "cuda"):
    """The same dims over the ranks present (``data * model`` of them, times
    ``pod``): ``("data", "model")``, or ``("pod", "data", "model")`` with
    ``pod``."""
    if pod:
        return _mesh(device_type, (pod, data, model), ("pod", "data", "model"))
    return _mesh(device_type, (data, model), ("data", "model"))
