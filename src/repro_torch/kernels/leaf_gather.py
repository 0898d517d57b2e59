"""``gathered_topk``: the fused ``pruned_topk`` over a subset of index blocks.

Counterpart of ``src/repro/kernels/leaf_gather.py:gathered_topk``, which
has no ``pallas_call`` of its own: the tree backend's descent proves most
blocks irrelevant before any kernel runs, and this module hands the
surviving blocks to the fused kernel.  One gather each compacts the kept
blocks' rows, their per-row validity, their sound pivot intervals
(``dp_lo/dp_hi``) and, for element stats, their ``dp`` rows; the kernel
runs with its tile pinned to the index block (``bn = block_size``), so the
block intervals are its tile intervals and its grid shrinks from
``n_blocks`` to ``n_keep`` tiles.  The kept tiles' best-first order comes
from the ``block_bounds`` kernel on the compacted intervals (its plain
version on CPU tensors).  No kernel of its own: on CUDA tensors it launches
``block_bounds`` (with ``best_first``) and ``pruned_topk`` once each, and
never a plain version.

Shape contract: ``keep`` is sorted ascending.  The compacted validity rides
along as ``pruned_topk``'s ``row_valid``, so tombstoned rows are masked
like padding and no valid-row count (a host sync) is needed.  Exactness:
the caller guarantees that ``keep`` holds every block any query of the
batch still needs; the kernel's own per-tile bound skips the kept tiles a
risen τ has since made unnecessary.
"""
from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.kernels import cosine_topk
from repro_torch.kernels.bound_prune import block_bounds

__all__ = ["best_first_tiles", "compact_blocks", "gathered_topk"]


def compact_blocks(index, keep: Tensor, *, dp: bool = False):
    """One gather each of the ``keep`` blocks' rows ``[n_keep·bs, d]``,
    validity ``[n_keep·bs]``, sound intervals ``[n_keep, P]`` (two) and,
    with ``dp``, per-row pivot similarities ``[n_keep·bs, P]`` (else
    ``None``)."""
    nb, bs = index.n_blocks, index.block_size
    blocks = keep.long()
    rows = blocks.numel() * bs
    return (index.db.view(nb, bs, -1)[blocks].view(rows, -1),
            index.valid.view(nb, bs)[blocks].view(rows),
            index.dp_lo[blocks], index.dp_hi[blocks],
            index.dp.view(nb, bs, -1)[blocks].view(rows, -1) if dp else None)


def best_first_tiles(qp: Tensor, lo: Tensor, hi: Tensor, bm: int) -> Tensor:
    """``[ceil(m / bm), n_tiles]`` i32: each query tile's visit order over
    the tiles of intervals ``lo/hi``, by descending max bound over the
    tile's rows (``block_bounds``; a stable sort, as the reference's
    ``argsort``)."""
    ub = block_bounds(qp, lo, hi)                             # [m, n_tiles]
    m, n = ub.shape
    mt = -(-m // bm)
    ub = torch.cat([ub, ub.new_full((mt * bm - m, n), float("-inf"))])
    return torch.argsort(-ub.view(mt, bm, n).amax(1), dim=1, stable=True).int()


def gathered_topk(index, keep: Tensor, qn: Tensor, qp: Tensor,
                  tau0: Tensor | None, *, k: int,
                  bm: int = cosine_topk.DEFAULT_BM, margin: float = 4e-7,
                  element_stats: bool = False, best_first: bool = True,
                  row_out: Tensor | None = None):
    """Fused pruned top-k over the ``keep`` subset of index blocks.

    Args:
      index: the (single-shard) :class:`~repro_torch.core.index.BlockIndex`.
      keep: [n_keep] int block ids, sorted ascending (at least one).
      qn / qp: normalized queries and their pivot similarities.
      tau0: [m] τ warm-start seeds (true lower bounds) or ``None``.
      k: top-k, ``k <= block_size`` (the kernel's tile).
      best_first: each query tile visits the kept tiles by descending
        bound, as the kernel backend does.
      row_out: [m] i32, ``pruned_topk``'s epilogue order: row ``r``'s result
        goes to row ``row_out[r]`` (a caller that sorted its queries by
        ``perm`` passes ``perm``).

    Returns ``(sims [m, k], pos [m, k] i32 positions in the index's padded
    db, computed [m_tiles, n_keep] i32, elem [m_tiles, n_keep] i32 or
    None)``: compact positions map back through ``keep``; empty slots stay
    ``(-inf, -1)``.
    """
    bs = index.block_size
    m, d = qn.shape
    n_keep = keep.shape[0]
    if not 1 <= k <= bs:
        raise ValueError(f"the kernel leaf stage needs 1 <= k <= block_size={bs}, "
                         f"got k={k}")
    if n_keep < 1:
        raise ValueError("keep holds no block")
    db_c, valid_c, lo_c, hi_c, dp_c = compact_blocks(index, keep, dp=element_stats)

    block_order = best_first_tiles(qp, lo_c, hi_c, bm) if best_first else None
    splits = cosine_topk.default_splits(m, n_keep * bs, d, qp.shape[1], bm=bm,
                                        bn=bs, device=qn.device)
    sims, pos, computed, elem = cosine_topk.pruned_topk(
        qn, db_c, qp, lo_c, hi_c, n_keep * bs, tau_init=tau0,
        block_order=block_order, dp=dp_c, row_valid=valid_c, k=k, bm=bm,
        bn=bs, margin=margin, prune=True, element_stats=element_stats,
        splits=splits, row_out=row_out)
    # compact positions -> padded-db positions (-1 stays -1)
    tile = (pos // bs).clamp(0, n_keep - 1).long()
    orig = torch.where(pos >= 0, keep.int()[tile] * bs + pos % bs, -1)
    return sims, orig.int(), computed, elem
