"""``block_bounds``: Eq. 13 block upper bounds, ``[M, P] x [NB, P] -> [M, NB]``,
and ``block_bounds_select``: the same bounds reduced to what the search
engine reads of them.

Replaces the TPU kernel ``src/repro/kernels/bound_prune.py:block_bounds``
(``pallas_call`` at line 103).  On CUDA tensors the wrappers launch the
hand-written kernels in ``csrc/block_bounds.cu`` (its header says what
bounds them on the H100 and how the design answers that); on CPU tensors
they run :func:`block_bounds_plain` and :func:`block_bounds_select_plain`.
The plain version materializes ``[M, NB, P]`` intermediates, which is why
the kernel exists; it works through the queries in chunks to stay
tractable at full size.

``block_bounds_select`` never writes the ``[M, NB]`` matrix: it returns
each query tile's max bound per block (the best-first order's input) and
each query's ``n_pre`` best-bound blocks (the τ warm start's), for
``n_pre <= SELECT_MAX_N_PRE`` (128).

``block_bounds.launches`` and ``block_bounds_select.launches`` count kernel
launches (never plain calls).
"""
from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from repro_torch.kernels import ref as kref
from repro_torch.kernels._build import check_operand, library

__all__ = ["block_bounds", "block_bounds_plain", "block_bounds_select",
           "block_bounds_select_plain", "select_bounds", "sqrt_mismatches",
           "SELECT_MAX_N_PRE"]

#: elements per ``[chunk, NB, P]`` intermediate of the plain version
_PLAIN_CHUNK_ELEMS = 1 << 26
#: the most best-bound blocks per query that block_bounds_select keeps (the
#: select kernel's kMaxNPre: one chunk of 128 blocks)
SELECT_MAX_N_PRE = 128
#: the select kernel's largest query tile (kTileRows; pruned_topk's MAX_BM)
_SELECT_MAX_BM = 128


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


def select_bounds(ub: Tensor, *, bm: int, n_pre: int) -> tuple[Tensor, Tensor]:
    """``(tile_max [MT, NB] f32, best [M, n_pre] int64)`` of a bound matrix
    ``ub [M, NB]``: the max over each query tile of ``bm`` rows (a ragged
    last tile over its rows only), and each row's ``n_pre`` highest-bound
    blocks, the first ``n_pre`` of a stable descending argsort (value
    descending, lower block first)."""
    m, nb = ub.shape
    best = torch.argsort(ub, dim=1, descending=True, stable=True)[:, :n_pre]
    full = m // bm * bm
    tile_max = ub[:full].reshape(m // bm, bm, nb).amax(1)
    if full < m:
        tile_max = torch.cat([tile_max, ub[full:].amax(0, keepdim=True)])
    return tile_max, best


def block_bounds_select_plain(qp: Tensor, dp_min: Tensor, dp_max: Tensor,
                              ub_cap: Tensor | None = None, *, bm: int,
                              n_pre: int) -> tuple[Tensor, Tensor]:
    """:func:`select_bounds` of :func:`block_bounds_plain`."""
    return select_bounds(block_bounds_plain(qp, dp_min, dp_max, ub_cap),
                         bm=bm, n_pre=n_pre)


def _lib():
    lib = library("block_bounds")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.block_bounds_launch.argtypes = [vp] * 5 + [i] * 3 + [vp]
        lib.block_bounds_launch.restype = i
        lib.block_bounds_select_launch.argtypes = [vp] * 8 + [i] * 5 + [vp]
        lib.block_bounds_select_launch.restype = i
        lib.block_bounds_chunks.argtypes = [i]
        lib.block_bounds_chunks.restype = i
        lib.block_bounds_sqrt_mismatches.argtypes = [vp, vp]
        lib.block_bounds_sqrt_mismatches.restype = i
        lib._typed = True
    return lib


def _check(name: str, qp: Tensor, dp_min: Tensor, dp_max: Tensor,
           ub_cap: Tensor | None) -> None:
    """The CUDA operands: contiguous float32 on one card."""
    if qp.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {qp.device}")
    m, p = qp.shape
    nb = dp_min.shape[0]
    dev = qp.device
    check_operand("qp", qp, (m, p), torch.float32, dev)
    check_operand("dp_min", dp_min, (nb, p), torch.float32, dev)
    check_operand("dp_max", dp_max, (nb, p), torch.float32, dev)
    if ub_cap is not None:
        check_operand("ub_cap", ub_cap, (m, nb), torch.float32, dev)


def _ptr(t: Tensor | None):
    return None if t is None else t.data_ptr()


def block_bounds(qp: Tensor, dp_min: Tensor, dp_max: Tensor,
                 ub_cap: Tensor | None = None) -> Tensor:
    """``[M, NB]`` float32 block upper bounds: the Eq. 13 bound over the
    box of each query's interval (the float32 neighbours of ``qp``,
    ``kernels/ref.py:query_interval``) and each block interval, min over
    pivots, ``-inf`` for inverted intervals (``lo > hi``), min'd with
    ``ub_cap [M, NB]`` when given.

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    and must be contiguous float32 (no fallback: anything else raises).
    The kernel's result equals the plain version's bit for bit, NaN
    wherever the plain version gives NaN.
    """
    if qp.device.type == "cpu":
        return block_bounds_plain(qp, dp_min, dp_max, ub_cap)
    _check("block_bounds", qp, dp_min, dp_max, ub_cap)
    m, p = qp.shape
    nb = dp_min.shape[0]
    out = torch.empty(m, nb, dtype=torch.float32, device=qp.device)
    if m == 0 or nb == 0:
        return out
    with torch.cuda.device(qp.device):
        rc = _lib().block_bounds_launch(
            qp.data_ptr(), dp_min.data_ptr(), dp_max.data_ptr(), _ptr(ub_cap),
            out.data_ptr(), m, nb, p,
            torch.cuda.current_stream(qp.device).cuda_stream)
    if rc:
        raise RuntimeError(f"block_bounds kernel launch failed: CUDA error {rc}")
    block_bounds.launches += 1
    return out


block_bounds.launches = 0


def block_bounds_select(qp: Tensor, dp_min: Tensor, dp_max: Tensor,
                        ub_cap: Tensor | None = None, *, bm: int,
                        n_pre: int) -> tuple[Tensor, Tensor]:
    """:func:`block_bounds` reduced without writing it:
    ``(tile_max [ceil(M / bm), NB] f32, best [M, n_pre] int64)``, as
    :func:`select_bounds` gives them, for ``1 <= n_pre <=
    min(SELECT_MAX_N_PRE, NB)``.  The launch counter counts one call, which
    runs two kernels: the bounds with the per-chunk picks, and their merge.

    CPU tensors take :func:`block_bounds_select_plain`.  CUDA tensors
    launch the kernel (contiguous float32 operands, ``bm <= 128``, no
    fallback) and equal the plain version exactly: ``tile_max`` bit for
    bit and ``best`` index for index.  The one exception is a row whose
    bounds hold a NaN, where ``best`` ranks NaN above every number but need
    not follow the argsort's order.
    """
    m, nb = qp.shape[0], dp_min.shape[0]
    if bm < 1:
        raise ValueError(f"bm={bm} must be at least 1")
    if not 1 <= n_pre <= min(SELECT_MAX_N_PRE, nb):
        raise ValueError(f"n_pre={n_pre} outside [1, min({SELECT_MAX_N_PRE}, "
                         f"{nb} blocks)]; larger n_pre: select_bounds of "
                         "block_bounds")
    if qp.device.type == "cpu":
        return block_bounds_select_plain(qp, dp_min, dp_max, ub_cap, bm=bm,
                                          n_pre=n_pre)
    _check("block_bounds_select", qp, dp_min, dp_max, ub_cap)
    if bm > _SELECT_MAX_BM:
        raise ValueError(f"bm={bm} above the CUDA kernel's {_SELECT_MAX_BM}")
    p, dev = qp.shape[1], qp.device
    tile_max = torch.empty(-(-m // bm), nb, dtype=torch.float32, device=dev)
    best = torch.empty(m, n_pre, dtype=torch.int64, device=dev)
    if m == 0:
        return tile_max, best
    lib = _lib()
    chunks = lib.block_bounds_chunks(nb)
    cand_key = torch.empty(m, chunks, n_pre, dtype=torch.int32, device=dev)
    cand_idx = torch.empty(m, chunks, n_pre, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.block_bounds_select_launch(
            qp.data_ptr(), dp_min.data_ptr(), dp_max.data_ptr(), _ptr(ub_cap),
            tile_max.data_ptr(), best.data_ptr(), cand_key.data_ptr(),
            cand_idx.data_ptr(), m, nb, p, bm, n_pre,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(
            f"block_bounds_select kernel launch failed: CUDA error {rc}")
    block_bounds_select.launches += 1
    return tile_max, best


block_bounds_select.launches = 0


def sqrt_mismatches(device="cuda") -> tuple[int, int]:
    """The kernels' branch-free square root of a product of radicands
    (``sqrt_rad`` in ``csrc/eq13.cuh``) against the card's IEEE
    ``__fsqrt_rn``, for every float of its two domains, on ``device``:
    ``(mismatches of the zero-safe variant, of the nonzero variant)``; both
    are 0 where the bounds are bit for bit."""
    bad = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(bad.device):
        rc = _lib().block_bounds_sqrt_mismatches(
            bad.data_ptr(), torch.cuda.current_stream(bad.device).cuda_stream)
    if rc:
        raise RuntimeError(f"sqrt check kernel launch failed: CUDA error {rc}")
    return int(bad[0]), int(bad[1])
