"""Process-local array assembly (counterpart of :mod:`repro.dist.compat`,
the part the port's callers need).

Ported: :func:`make_process_local_array` (the mesh launcher's batch).
Not ported: ``replicate_to_mesh`` (no caller in the port: a replicated
DTensor is ``placement.distribute`` of the same data), and, with no torch
counterpart to carry, ``shard_map`` (the port writes the collectives of
its one ``shard_map`` body, the sharded MoE, by hand on local tensors),
``optimization_barrier`` (eager torch runs ops in program order; nothing
reorders them) and ``multiprocess_cpu_init`` (``torch.distributed`` takes
its gloo group from ``init_process_group``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist import placement

__all__ = ["make_process_local_array"]


def make_process_local_array(sharding, local_data, global_shape):
    """The ``global_shape`` DTensor placed by ``sharding`` (a
    :class:`~repro_torch.dist.sharding.NamedSharding`) whose part on this
    rank is ``local_data`` (numpy or a tensor), moved to the mesh's
    device.  As in the reference, ``local_data`` is this rank's slice
    along every dim it is smaller than the global shape, and replicated
    data must be the same on every rank.  No collective runs."""
    from torch.distributed.tensor import DTensor

    mesh = sharding.mesh
    t = torch.as_tensor(np.asarray(local_data) if not isinstance(local_data, torch.Tensor)
                        else local_data, device=placement.local_device(mesh))
    global_shape = tuple(global_shape)
    stride = tuple(int(np.prod(global_shape[i + 1:])) for i in range(len(global_shape)))
    return DTensor.from_local(t, mesh, sharding.placements, run_check=False,
                              shape=global_shape, stride=stride)

