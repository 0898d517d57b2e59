"""Elastic mesh reconstruction after node loss (counterpart of
:mod:`repro.dist.elastic`).

Checkpoints store full (unsharded) arrays, so a restore only needs *some*
valid mesh over the surviving ranks; :func:`remesh` builds the largest
(data, model) mesh the survivors support, preferring to keep the model axis
at its previous width so TP layouts stay stable.
"""
from __future__ import annotations

import torch

__all__ = ["best_mesh", "remesh"]


def best_mesh(n: int, *, prefer_model: int | None = None) -> tuple[int, int]:
    """(data, model) shape for ``n`` surviving devices.

    ``model`` is the largest divisor of ``n`` that is ``<= prefer_model``
    (default: the most square split, ``floor(sqrt(n))``); the rest becomes
    the data axis.  Always satisfies ``data * model == n``.
    """
    if n <= 0:
        raise ValueError("best_mesh needs at least one device")
    if prefer_model is None:
        prefer_model = int(n ** 0.5)
    cap = max(1, min(prefer_model, n))
    model = max(d for d in range(1, cap + 1) if n % d == 0)
    return n // model, model


def remesh(ranks, *, prefer_model: int | None = None, device_type: str = "cuda"):
    """A ``("data", "model")`` ``DeviceMesh`` over the surviving ``ranks``
    (global ranks of the process group).  Every rank of the group must
    call it, survivors or not (the mesh's groups are made collectively);
    a rank outside it gets ``get_coordinate() is None``."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(ranks)
    data, model = best_mesh(len(ranks), prefer_model=prefer_model)
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(data, model),
                      mesh_dim_names=("data", "model"))
