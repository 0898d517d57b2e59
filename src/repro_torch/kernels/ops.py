"""Legacy wrappers around the kernels (counterpart of
:mod:`repro.kernels.ops`).

The kernel search path lives in :class:`repro_torch.search.SearchEngine`
with ``backend="kernel"`` (or the raw inner loop
:func:`repro_torch.search.backends.kernel_search`); ``search_index`` is a
hard error there, as in the reference.  ``block_bounds`` stays a supported
thin wrapper; it has no ``interpret`` knob, since the device of its tensors
decides whether the CUDA kernel or its plain version runs.
"""
from __future__ import annotations

from torch import Tensor

from repro_torch.kernels import bound_prune, cosine_topk  # noqa: F401  (re-export)
from repro_torch.search.backends import coarsen_intervals  # noqa: F401  (re-export)

__all__ = ["block_bounds", "search_index", "bound_prune", "cosine_topk",
           "coarsen_intervals"]


def block_bounds(qp: Tensor, dp_min: Tensor, dp_max: Tensor) -> Tensor:
    """Kernel-backed Eq. 13 block bounds (``[M, P] x [NB, P] -> [M, NB]``)."""
    return bound_prune.block_bounds(qp, dp_min, dp_max)


def search_index(*args, **kwargs):
    """Removed: use ``SearchEngine(index, backend="kernel")``."""
    raise TypeError(
        "repro_torch.kernels.ops.search_index() was removed. Use "
        "repro_torch.search.SearchEngine(index, backend='kernel').search("
        "queries, k), or the raw inner loop "
        "repro_torch.search.backends.kernel_search.")
