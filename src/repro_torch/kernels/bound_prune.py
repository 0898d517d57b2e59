"""``block_bounds``: Eq. 13 block upper bounds, ``[M, P] x [NB, P] -> [M, NB]``.

Replaces the TPU kernel ``src/repro/kernels/bound_prune.py:block_bounds``
(``pallas_call`` at line 103).  On CUDA tensors the wrapper launches the
hand-written kernel in ``csrc/block_bounds.cu`` (its header says what
bounds it on the H100 and how the design answers that); on CPU tensors it
runs :func:`block_bounds_plain`.  The plain version materializes
``[M, NB, P]`` intermediates, which is why the kernel exists; it works
through the queries in chunks to stay tractable at full size.

``block_bounds.launches`` counts kernel launches (never plain calls).
"""
from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from repro_torch.kernels import ref as kref
from repro_torch.kernels._build import check_operand, library

__all__ = ["block_bounds", "block_bounds_plain"]

#: elements per ``[chunk, NB, P]`` intermediate of the plain version
_PLAIN_CHUNK_ELEMS = 1 << 26


def block_bounds_plain(qp: Tensor, dp_min: Tensor, dp_max: Tensor,
                       ub_cap: Tensor | None = None) -> Tensor:
    """The oracle arithmetic of :func:`repro_torch.kernels.ref.block_bounds`,
    query chunk by query chunk, with ``ub_cap`` min'd in."""
    nb, p = dp_min.shape
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, nb * p))
    out = torch.cat([kref.block_bounds(qp[s:s + step], dp_min, dp_max)
                     for s in range(0, qp.shape[0], step)])
    if ub_cap is not None:
        out = torch.minimum(out, ub_cap.float())
    return out


def _lib():
    lib = library("block_bounds")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.block_bounds_launch.argtypes = [vp, vp, vp, vp, vp, i, i, i, vp]
        lib.block_bounds_launch.restype = i
        lib._typed = True
    return lib


def block_bounds(qp: Tensor, dp_min: Tensor, dp_max: Tensor,
                 ub_cap: Tensor | None = None) -> Tensor:
    """``[M, NB]`` float32 block upper bounds: the Eq. 13 interval bound,
    min over pivots, ``-inf`` for inverted intervals (``lo > hi``), min'd
    with ``ub_cap [M, NB]`` when given.

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    and must be contiguous float32 (no fallback: anything else raises).
    """
    if qp.device.type == "cpu":
        return block_bounds_plain(qp, dp_min, dp_max, ub_cap)
    if qp.device.type != "cuda":
        raise ValueError(f"block_bounds runs on cpu or cuda, not {qp.device}")
    m, p = qp.shape
    nb = dp_min.shape[0]
    dev = qp.device
    check_operand("qp", qp, (m, p), torch.float32, dev)
    check_operand("dp_min", dp_min, (nb, p), torch.float32, dev)
    check_operand("dp_max", dp_max, (nb, p), torch.float32, dev)
    if ub_cap is not None:
        check_operand("ub_cap", ub_cap, (m, nb), torch.float32, dev)
    out = torch.empty(m, nb, dtype=torch.float32, device=dev)
    if m == 0 or nb == 0:
        return out
    with torch.cuda.device(dev):
        rc = _lib().block_bounds_launch(
            qp.data_ptr(), dp_min.data_ptr(), dp_max.data_ptr(),
            None if ub_cap is None else ub_cap.data_ptr(), out.data_ptr(),
            m, nb, p, torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"block_bounds kernel launch failed: CUDA error {rc}")
    block_bounds.launches += 1
    return out


block_bounds.launches = 0
