"""Block-pruned exact cosine kNN: the index structure.

PyTorch counterpart of :mod:`repro.core.index`.  The Eq. 13 upper bound
over cached pivot similarities proves that a candidate cannot enter the
top-k; the index applies it at block granularity so surviving work stays
dense:

  build:   normalize db, pick P pivots, cache ``dp = db @ pivots.T`` and the
           per-block per-pivot interval ``[dp_min, dp_max]``, and beside it
           ``[dp_lo, dp_hi]``, the same interval widened to contain every
           row's float64 pivot cosine (what every bound reads); rows are
           reordered so each block is angularly coherent.
  search:  :class:`repro_torch.search.SearchEngine` (this module keeps the
           structure, the bounds over it and the brute-force baseline).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from repro_torch.core.bounds import joint_row_upper_bound
from repro_torch.core.pivots import (normalize, orthonormal_pivot_basis,
                                     select_pivots_maxmin, select_pivots_random)
from repro_torch.device import resolve_device
from repro_torch.kernels import ref as kref

__all__ = ["BlockIndex", "build_index", "search_brute", "interval_upper_bound",
           "block_upper_bound", "reorder_perm", "multipivot_block_cap", "search",
           "index_from_reference", "pivot_cosines64", "row_intervals",
           "sound_intervals"]


class BlockIndex(NamedTuple):
    """The search structure: a tuple of tensors on one device.

    ``db`` is padded to a multiple of the block size; ``valid`` masks
    padding.  ``dp_min/dp_max`` are the per-block pivot-similarity
    intervals ``[n_blocks, P]`` of the float32 ``dp``, as the reference
    builds them; ``dp_lo/dp_hi`` (:func:`sound_intervals`) widen them to
    contain every valid row's float64 pivot cosine, and every Eq. 13 bound
    reads those.  ``block_size = db.shape[0] // n_blocks``.
    ``ortho``/``beta``/``beta_nsq`` are the joint multi-pivot bound tables
    (``None`` when absent).
    """

    db: Tensor        # [n_pad, d]  normalized, padded database (f32)
    dp: Tensor        # [n_pad, P]  database-to-pivot similarities
    pivots: Tensor    # [P, d]      normalized pivot vectors
    dp_min: Tensor    # [n_blocks, P]
    dp_max: Tensor    # [n_blocks, P]
    valid: Tensor     # [n_pad]     bool, False on padding rows
    row_ids: Tensor   # [n_pad]     i32 original row id of each row (-1 = pad)
    ortho: Tensor | None = None     # [P, d]  orthonormalized pivot basis
    beta: Tensor | None = None      # [n_pad, P]  db @ ortho.T
    beta_nsq: Tensor | None = None  # [n_pad, P]  cumsum(beta**2, dim=1)
    dp_lo: Tensor | None = None     # [n_blocks, P]  sound_intervals
    dp_hi: Tensor | None = None     # [n_blocks, P]

    @property
    def n_blocks(self) -> int:
        return self.dp_min.shape[0]

    @property
    def block_size(self) -> int:
        return self.db.shape[0] // self.n_blocks

    @property
    def n_pivots(self) -> int:
        return self.pivots.shape[0]

    @property
    def bound_table_width(self) -> int:
        """Max usable ``n_pivots`` for the joint bound (0 = no table)."""
        return 0 if self.ortho is None else self.ortho.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.db.device

    def to(self, device) -> "BlockIndex":
        return BlockIndex(*(None if t is None else t.to(device) for t in self))


def build_index(
    db,
    *,
    n_pivots: int = 16,
    block_size: int = 128,
    pivot_method: str = "maxmin",
    reorder: bool = True,
    seed: int = 0,
    device=None,
) -> BlockIndex:
    """Build the block index on ``device`` (``None`` means CUDA).

    ``db`` is an ``[n, d]`` array or tensor.  ``reorder`` permutes rows so
    that each block is angularly coherent (nearest pivot ascending, then
    similarity to it descending, padding last); results map back to the
    original ids through ``row_ids``.
    """
    dev = resolve_device(device)
    dbn = normalize(torch.as_tensor(db, dtype=torch.float32, device=dev))
    n, d = dbn.shape
    n_pivots = max(1, min(int(n_pivots), n))
    n_pad = -(-n // block_size) * block_size
    dbn = torch.cat([dbn, dbn.new_zeros(n_pad - n, d)])
    ar = torch.arange(n_pad, device=dev)
    valid = ar < n
    row_ids = torch.where(valid, ar, -1).to(torch.int32)

    if pivot_method == "maxmin":
        piv_idx = select_pivots_maxmin(dbn[:n], n_pivots)
    elif pivot_method == "random":
        piv_idx = select_pivots_random(n, n_pivots, seed).to(dev)
    else:
        raise ValueError(f"unknown pivot_method {pivot_method!r}")
    pivots = dbn[piv_idx]                      # [P, d] (already unit norm)
    dp = dbn @ pivots.T                        # [n_pad, P]

    if reorder:
        perm = reorder_perm(dp, valid, n_pivots)
        dbn, dp, valid, row_ids = dbn[perm], dp[perm], valid[perm], row_ids[perm]
    # padding rows (dp = 0) are excluded from the intervals; an all-padding
    # block keeps the +inf/-inf identity: the empty-interval sentinel
    nb = n_pad // block_size
    inf = torch.tensor(float("inf"), device=dev)
    dp_min = torch.where(valid[:, None], dp, inf).reshape(nb, block_size, -1).amin(1)
    dp_max = torch.where(valid[:, None], dp, -inf).reshape(nb, block_size, -1).amax(1)

    # joint multi-pivot tables: float64 at build, float32 stored, computed
    # on the reordered rows so beta[i] matches db[i]
    u64 = torch.from_numpy(orthonormal_pivot_basis(pivots)).to(dev)
    beta64 = dbn.double() @ u64.T
    return BlockIndex(dbn, dp, pivots, dp_min, dp_max, valid, row_ids,
                      u64.float(), beta64.float(),
                      torch.cumsum(beta64 * beta64, dim=1).float(),
                      *sound_intervals(dbn, pivots, valid, dp_min, dp_max))


def pivot_cosines64(x: Tensor, pivots: Tensor) -> Tensor:
    """``[n, P]`` float64 cosines of the stored rows ``x`` with the stored
    pivots, each normalized again in float64 (0 for an all-zero row)."""
    x64, p64 = x.double(), pivots.double()
    norms = (torch.linalg.vector_norm(x64, dim=1)[:, None]
             * torch.linalg.vector_norm(p64, dim=1)[None, :])
    return (x64 @ p64.T) / torch.where(norms > 0, norms, 1.0)


def row_intervals(x: Tensor, pivots: Tensor) -> tuple[Tensor, Tensor]:
    """``(lo, hi) [n, P]``: each stored row's float64 pivot cosine
    (:func:`pivot_cosines64`) rounded outward to float32: the neighbours of
    the nearest float32 (:func:`~repro_torch.kernels.ref.query_interval`),
    clamped to ``[-1, 1]``.  The one rounding every sound interval is made
    of: :func:`sound_intervals` at the build, and the online insert
    (``core/online.py``), which widens the blocks and the tree's nodes
    with it."""
    return kref.query_interval(pivot_cosines64(x, pivots).float())


def sound_intervals(db: Tensor, pivots: Tensor, valid: Tensor, dp_min: Tensor,
                    dp_max: Tensor) -> tuple[Tensor, Tensor]:
    """``(dp_lo, dp_hi) [n_blocks, P]``: each block's union of its valid
    rows' :func:`row_intervals`, joined with ``[dp_min, dp_max]``, so no
    interval shrinks.  Blocks with no valid row keep ``[dp_min, dp_max]``
    (the inverted sentinel where the build found the block empty)."""
    nb, p = dp_min.shape
    lo_r, hi_r = (x.reshape(nb, -1, p) for x in row_intervals(db, pivots))
    rows = valid.reshape(nb, -1, 1)
    lo = torch.where(rows, lo_r, float("inf")).amin(1)
    hi = torch.where(rows, hi_r, float("-inf")).amax(1)
    return torch.minimum(lo, dp_min.float()), torch.maximum(hi, dp_max.float())


def reorder_perm(dp: Tensor, valid: Tensor, n_pivots: int) -> Tensor:
    """Row permutation making blocks angularly coherent.

    Sorts by (nearest pivot asc, similarity to it desc), padding last — the
    reference's ``jnp.lexsort`` as two stable sorts, secondary key first, so
    the row order is identical.
    """
    near_sim, nearest = torch.max(dp, dim=1)
    group = torch.where(valid, nearest, n_pivots)   # padding after every group
    p1 = torch.argsort(-near_sim, stable=True)
    return p1[torch.argsort(group[p1], stable=True)]


def interval_upper_bound(qp: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """Max of Eq. 13 over ``a`` in the query's interval and ``b in [lo,
    hi]``, elementwise (pivot axis kept); an inverted interval (``lo >
    hi``, the empty-block sentinel) bounds at ``-inf``.

    ``qp`` is the pivot cosine rounded to nearest float32 from float64
    (``prep_queries``); the bound is taken over its float32 neighbours
    ``[a_lo, a_hi]`` (:func:`~repro_torch.kernels.ref.query_interval`) and
    is :func:`~repro_torch.kernels.ref.box_bound` of that box, which the
    kernels in ``csrc/eq13.cuh`` compute bit for bit.

    Why it is sound (u = 2^-24, float32's unit roundoff): for a valid row
    x below a block or tree node, ``bound + margin >= q . x`` in float64
    of the stored float32 vectors, at every ``|a|`` and ``|s|`` up to 1.

    1. Containment.  Let ``a``, ``s`` be the cosines of the stored q and x
       with pivot p, normalized again in float64.  Their float64 values err
       by at most (d + 3)·2^-53 (1.1e-14 at d = 100), below half a float32
       ulp unless ``|a| < 2e-7``, so ``a`` lies in ``[a_lo, a_hi]``; near
       0 the bound's slope in ``a`` is at most about 1, and a slip of 1e-14
       stays far inside the margin.  ``[dp_lo, dp_hi]`` holds ``s`` for
       every valid row by the same rounding (:func:`sound_intervals`).
    2. The box.  With ``t = arccos``, ``cos(q, x) <= cos(t(a) - t(s))``,
       which is Eq. 13.  Over the box it is largest where ``|t(a) - t(s)|``
       is least: 0 where the intervals meet (the bound 1), else at the
       nearest corner, ``(a_lo, hi)`` when ``a_lo > hi`` and ``(a_hi, lo)``
       when ``a_hi < lo`` (``arccos`` decreases).  One corner per pivot.
    3. Evaluation.  Each radicand is ``(1 - x)(1 + x)``: for ``|x| >=
       1/2``, ``1 - x`` is exact (Sterbenz), so the radicand carries at
       most 2u of relative error and no cancellation, however close ``|x|``
       comes to 1 (the old ``1 - x·x`` lost 2.4e-7 of the bound at ``|x| =
       0.998`` and 1e-6 at 0.9999).  The product of radicands, the root,
       ``x·y`` and the sum then leave at most about 6.5u = 3.9e-7 of
       absolute error, a few u in practice.
    4. What ``margin = 4e-7`` (6.7u) covers: that evaluation error, the
       stored vectors' norms off 1 (``q . x = |q| |x| cos(q, x)``; about 2u
       each after float32 normalization), and the float32 score's own
       rounding against float64 (a few u at d = 100).  The worst cases of
       the last two grow with d (d·u/2 each); the property tests and
       ``chip_smoke.py``'s soundness phase check them against float64.

    Before, the query's similarity was a float32 dot product: near ``|a| =
    1`` its ~2u of error, amplified by the bound's slope ``|a| / sqrt(1 -
    a^2)`` (16 at ``a = -0.998``), moved the bound by more than the margin
    (n = 124, d = 2, seed 1: short by 1.53e-6).
    """
    a_lo, a_hi = kref.query_interval(qp)
    ub = kref.box_bound(a_lo, a_hi, lo.float(), hi.float())
    return ub.masked_fill(lo > hi, float("-inf"))


def block_upper_bound(qp: Tensor, dp_min: Tensor, dp_max: Tensor) -> Tensor:
    """``[m]`` tightest bound over pivots for one block's ``[P]`` intervals."""
    return interval_upper_bound(qp, dp_min[None, :], dp_max[None, :]).amin(-1)


def multipivot_block_cap(index: BlockIndex, qn: Tensor, *, n_pivots: int) -> Tensor:
    """Per-(query, block) joint multi-pivot upper bound ``[M, n_blocks]``.

    The max over a block's valid rows of the joint row bound at prefix depth
    ``n_pivots`` — a valid block bound because the max dominates every
    member.
    """
    if index.ortho is None:
        raise ValueError("index has no joint bound tables (ortho is None)")
    j = int(n_pivots)
    if not 1 <= j <= index.bound_table_width:
        raise ValueError(f"n_pivots={j} outside [1, {index.bound_table_width}]")
    alpha = qn.float() @ index.ortho[:j].T                      # [M, j]
    row_ub = joint_row_upper_bound(
        alpha, index.beta[:, :j], index.beta_nsq[:, j - 1])     # [M, n_pad]
    row_ub = row_ub.masked_fill(~index.valid[None, :], float("-inf"))
    return row_ub.reshape(row_ub.shape[0], index.n_blocks, -1).amax(-1)


def search(*args, **kwargs):
    """Removed: use :class:`repro_torch.search.SearchEngine`.

    The pre-engine entry point, kept as a hard error as in the reference:
    its legacy policy (natural block order, no τ warm-start) made numbers
    incomparable with the engine's.
    """
    raise TypeError(
        "repro_torch.core.index.search() was removed. Use "
        "repro_torch.search.SearchEngine: "
        "eng = SearchEngine(index, backend='scan'); "
        "sims, ids, stats = eng.search(queries, k). The migration table "
        "is in docs/search-api.md.")


def search_brute(index: BlockIndex, queries, k: int):
    """Brute-force exact top-k over the index: ``(sims, original ids)``."""
    qn = normalize(torch.as_tensor(queries, dtype=torch.float32,
                                   device=index.device))
    scores = (qn @ index.db.T).masked_fill(~index.valid[None, :], float("-inf"))
    sims, idx = torch.topk(scores, k, dim=1)
    return sims, index.row_ids[idx]


def index_from_reference(arrays: dict[str, np.ndarray], device=None) -> BlockIndex:
    """The port's index from the reference's ``BlockIndex`` fields.

    ``arrays`` maps each field name to a numpy array (``{f: np.asarray(
    getattr(idx, f)) for f in idx._fields}``), so both packages can search
    the identical index.  Missing or ``None`` joint tables stay ``None``;
    missing ``dp_lo/dp_hi`` (the reference has none) are computed.
    """
    dev = resolve_device(device)
    dtypes = {"valid": torch.bool, "row_ids": torch.int32}

    def conv(name):
        a = arrays.get(name)
        if a is None:
            return None
        return torch.tensor(np.asarray(a), dtype=dtypes.get(name, torch.float32),
                            device=dev)

    idx = BlockIndex(*(conv(f) for f in BlockIndex._fields))
    if idx.dp_lo is None:
        idx = idx._replace(**dict(zip(("dp_lo", "dp_hi"), sound_intervals(
            idx.db, idx.pivots, idx.valid, idx.dp_min, idx.dp_max))))
    return idx
