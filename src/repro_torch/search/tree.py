"""Pivot-tree exact search (counterpart of :mod:`repro.search.tree`).

The paper's bound applied transitively: a balanced binary tree over the
block index's consecutive blocks, whose every node caches the union of
its descendants' per-pivot similarity intervals.  One Eq. 13 evaluation
at a node bounds every row below it, so ``ub(node) + margin < τ`` cuts the
whole subtree (DESIGN.md §3.5).

* **Heap layout.**  Node 1 is the root, node ``i`` has children ``2i`` and
  ``2i+1``; leaves sit at ``[nl, 2·nl)`` with ``nl`` the block count
  rounded up to a power of two, leaf slot ``s`` = index block ``s``.
* **Level-synchronous descent.**  Each level's ``[m, 2^l]`` bound matrix
  is one launch of the ``block_bounds`` kernel (its plain version on CPU
  tensors) over that level's node intervals; a boolean frontier per query
  masks it.  Empty subtrees carry the inverted sentinel interval
  (lo = +inf, hi = -inf), which the bound maps to ``-inf``.
* **Two leaf stages** (the engine's ``leaf_eval``): the scan loop through
  its ``tau0`` / ``ub_all`` / ``leaf_mask`` hooks
  (:func:`repro_torch.search.backends.scan_search`), or the fused kernel
  over the union of the batch's surviving leaves, compacted
  (:func:`repro_torch.kernels.leaf_gather.gathered_topk`).
* **Shard trees** (:class:`ShardTreeArrays`): one tree per shard of a
  shard-stacked index, over that shard's own pivots and blocks, for the
  ``sharded`` backend's tree branch
  (:func:`repro_torch.core.distributed.sharded_search_local`), whose descent
  prunes every shard against one global τ per query.

Exactness: the τ₀ seeds are k-th bests of real scored candidates, a node
bound dominates every descendant similarity (the node tables hold the
sound ``dp_lo/dp_hi`` intervals; ``core/index.py:interval_upper_bound``
has the argument), and either leaf stage skips only what a bound proves,
so ``backend="tree"`` returns the brute-force result set.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from repro_torch.core.index import (BlockIndex, interval_upper_bound,
                                    multipivot_block_cap)
from repro_torch.kernels.bound_prune import block_bounds
from repro_torch.kernels.cosine_topk import DEFAULT_BM
from repro_torch.kernels.leaf_gather import gathered_topk
from repro_torch.search import backends as _bk

__all__ = ["TreeIndex", "ShardTreeArrays", "build_tree", "build_shard_trees",
           "tree_warm_start", "tree_warm_start_topk", "tree_descend",
           "tree_search", "tree_kernel_search", "widen_tree", "widen_shard_trees"]


class TreeIndex(NamedTuple):
    """Array-encoded balanced pivot tree over a :class:`BlockIndex`.

    ``node_lo`` / ``node_hi`` ``[2·nl, P]`` cache the union of descendant
    per-pivot similarity intervals; ``node_valid [2·nl]`` is True iff the
    subtree holds a real row.  Node 0 is unused (the beam's empty slot).
    """

    index: BlockIndex
    node_lo: Tensor
    node_hi: Tensor
    node_valid: Tensor

    @property
    def n_leaf_slots(self) -> int:
        return self.node_valid.shape[0] // 2

    @property
    def n_levels(self) -> int:
        """Tree depth: leaves live ``n_levels`` below the root."""
        return self.n_leaf_slots.bit_length() - 1

    @property
    def n_blocks(self) -> int:
        return self.index.n_blocks

    @property
    def block_size(self) -> int:
        return self.index.block_size

    @property
    def n_valid_nodes(self) -> int:
        """Host int: nodes whose subtree holds a real row (one device sync;
        the tree backend reads it once per tree)."""
        return int(self.node_valid.sum())


def _next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length() if x > 1 else 1


def _tree_arrays(dp_min: Tensor, dp_max: Tensor, block_valid: Tensor, *,
                 nl: int):
    """Bottom-up interval union into heap-ordered node arrays.  Empty
    subtrees keep the ±inf identity of the reduce, the same inverted
    interval ``build_index`` writes for all-padding blocks."""
    nb, p = dp_min.shape
    dev = dp_min.device
    lo = torch.full((2 * nl, p), float("inf"), device=dev)
    hi = torch.full((2 * nl, p), float("-inf"), device=dev)
    valid = torch.zeros(2 * nl, dtype=torch.bool, device=dev)
    lo[nl:nl + nb] = dp_min.float().masked_fill(~block_valid[:, None],
                                                float("inf"))
    hi[nl:nl + nb] = dp_max.float().masked_fill(~block_valid[:, None],
                                                float("-inf"))
    valid[nl:nl + nb] = block_valid
    sz = nl // 2
    while sz >= 1:
        lo[sz:2 * sz] = lo[2 * sz:4 * sz].reshape(sz, 2, p).amin(1)
        hi[sz:2 * sz] = hi[2 * sz:4 * sz].reshape(sz, 2, p).amax(1)
        valid[sz:2 * sz] = valid[2 * sz:4 * sz].reshape(sz, 2).any(1)
        sz //= 2
    return lo, hi, valid


def build_tree(index: BlockIndex) -> TreeIndex:
    """Build the balanced pivot tree over ``index``'s blocks: one min/max
    reduce per level over the sound block intervals ``dp_lo/dp_hi`` (so
    every node interval holds the float64 pivot cosine of every valid row
    below it).  Shard-stacked
    indexes are refused (the ``sharded`` backend owns those)."""
    if index.db.ndim != 2:
        raise ValueError("build_tree needs a single-shard BlockIndex; "
                         "shard-stacked indexes are served by the 'sharded' "
                         "backend")
    nb, bs = index.n_blocks, index.block_size
    block_valid = index.valid.reshape(nb, bs).any(1)
    lo, hi, valid = _tree_arrays(index.dp_lo, index.dp_hi, block_valid,
                                 nl=_next_pow2(nb))
    return TreeIndex(index, lo, hi, valid)


def widen_tree(tree: TreeIndex, index: BlockIndex, blocks: Tensor,
               lo_rows: Tensor, hi_rows: Tensor) -> TreeIndex:
    """Widen the node tables along the root-to-leaf paths of freshly
    inserted rows, in place (the online insert, ``core/online.py``).

    Args:
      tree: the engine's tree (its heap shape must match ``index``: a
        shape-changing mutation drops the tree, which the next search
        rebuilds).
      index: the post-insert index the widened tree serves.
      blocks: ``[r]`` block of each inserted row.
      lo_rows / hi_rows: ``[r, P]`` each row's sound interval: its float64
        pivot cosines rounded outward (``core/index.py:row_intervals``)
        joined with its float32 ``dp``, exactly what the insert folds into
        the blocks' ``dp_lo/dp_hi``.

    The reference's ``widen_tree(tree, index, blocks, dp_rows)`` takes the
    float32 ``dp`` rows, the one value its intervals hold.  The port's
    nodes are built from the sound block intervals (:func:`build_tree`), so
    widening them with the float32 point alone could leave an inserted
    row's float64 cosine outside every node above it; hence the interval's
    two ends.  Every node on an affected path is scatter-min'd with
    ``lo_rows`` and scatter-max'd with ``hi_rows`` and marked valid: nodes
    only loosen, so each node bound stays an upper bound over its grown
    subtree.  While no block has lost its last row to a delete since the
    tree was built, the result equals :func:`build_tree` of ``index`` bit
    for bit.
    """
    _widen_paths(tree.node_lo, tree.node_hi, tree.node_valid,
                 blocks.long() + tree.n_leaf_slots, 0, lo_rows, hi_rows, tree.n_levels)
    return TreeIndex(index, tree.node_lo, tree.node_hi, tree.node_valid)


def _widen_paths(lo: Tensor, hi: Tensor, valid: Tensor, node: Tensor, base,
                 lo_rows: Tensor, hi_rows: Tensor, levels: int) -> None:
    """Scatter-min ``lo_rows`` / scatter-max ``hi_rows`` ``[r, P]`` into the
    node tables ``lo / hi [n, P]`` and mark ``valid [n]``, at ``base +
    node`` for every node from the leaves ``node [r]`` (heap numbers,
    ``levels`` below the root) up to the root, in place; ``base`` offsets
    each row's heap in tables that hold several (0, or a ``[r]`` tensor)."""
    for _ in range(levels + 1):                        # leaf ... root
        at = base + node
        idx = at[:, None].expand_as(lo_rows)
        lo.scatter_reduce_(0, idx, lo_rows, "amin", include_self=True)
        hi.scatter_reduce_(0, idx, hi_rows, "amax", include_self=True)
        valid[at] = True
        node = node // 2


class ShardTreeArrays(NamedTuple):
    """One tree per shard of a shard-stacked index, for the ``sharded``
    backend's tree branch: :class:`TreeIndex`'s heap layout with a leading
    shard axis, ``node_lo / node_hi [L, 2·nl, P]`` and ``node_valid [L,
    2·nl]``, each shard's tree over its own pivots and blocks (all shards
    share their shapes, so one ``nl``).  Kept apart from the index, as in
    the reference; :meth:`shard` joins shard ``i``'s tables to its flat
    index."""

    node_lo: Tensor
    node_hi: Tensor
    node_valid: Tensor

    @property
    def n_levels(self) -> int:
        """Each shard tree's depth."""
        return (self.node_valid.shape[1] // 2).bit_length() - 1

    def shard(self, index: BlockIndex, i: int) -> TreeIndex:
        """Shard ``i``'s tree over ``index``, its flat index (views)."""
        return TreeIndex(index, self.node_lo[i], self.node_hi[i], self.node_valid[i])


def build_shard_trees(index: BlockIndex) -> ShardTreeArrays:
    """One pivot tree per shard of a shard-stacked ``[L, ...]`` index, on
    its device: :func:`build_tree`'s tables for each shard, from its sound
    block intervals ``dp_lo/dp_hi`` (the reference's ``build_shard_trees``
    reads ``dp_min/dp_max``), stacked.  A flat index is refused, as in the
    reference."""
    if index.db.ndim != 3:
        raise ValueError("build_shard_trees needs a shard-stacked BlockIndex "
                         "(leading [S, ...] axis from build_sharded_index); "
                         "single-shard indexes are served by build_tree")
    n_shards, n_pad, _ = index.db.shape
    nb = index.dp_lo.shape[1]
    block_valid = index.valid.reshape(n_shards, nb, n_pad // nb).any(2)
    nl = _next_pow2(nb)
    parts = [_tree_arrays(index.dp_lo[s], index.dp_hi[s], block_valid[s], nl=nl)
             for s in range(n_shards)]
    return ShardTreeArrays(*(torch.stack(t) for t in zip(*parts)))


def widen_shard_trees(tree: ShardTreeArrays, blocks: Tensor, lo_rows: Tensor,
                      hi_rows: Tensor, mask: Tensor) -> ShardTreeArrays:
    """:func:`widen_tree` for every shard at once, in place (the sharded
    online insert).

    Args:
      tree: the shard trees ``[L, ...]``, whose heap shape matches the
        post-insert index (a shape change drops them instead).
      blocks: ``[L, R]`` the block of each inserted row in its shard,
        padded to a uniform width ``R`` across shards.
      lo_rows / hi_rows: ``[L, R, P]`` each row's sound interval under its
        shard's pivots (what the insert folds into ``dp_lo/dp_hi``).
      mask: ``[L, R]`` bool, False on the padding entries.

    Masked entries are dropped, so a shard that received no row is left
    untouched.  As in :func:`widen_tree`, nodes only loosen, and while no
    block has lost its last row the result equals
    :func:`build_shard_trees` of the post-insert index bit for bit.
    """
    n_shards, two_nl = tree.node_valid.shape
    p = tree.node_lo.shape[-1]
    sel = mask.reshape(-1)
    shard = torch.arange(n_shards, device=blocks.device)[:, None].expand_as(blocks)
    _widen_paths(tree.node_lo.view(-1, p), tree.node_hi.view(-1, p),
                 tree.node_valid.view(-1), blocks.reshape(-1)[sel].long() + two_nl // 2,
                 shard.reshape(-1)[sel] * two_nl, lo_rows.reshape(-1, p)[sel],
                 hi_rows.reshape(-1, p)[sel], tree.n_levels)
    return tree


def _gathered_bounds(qp: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """Eq. 13 interval bound for per-query node gathers: ``qp [m, P]``,
    ``lo / hi [m, W, P]`` -> ``[m, W]``."""
    return interval_upper_bound(qp[:, None, :], lo, hi).amin(-1)


def _top_w(x: Tensor, w: int) -> Tensor:
    """Positions of each row's ``w`` largest values, ties to the lower
    position (``lax.top_k``'s rule)."""
    return torch.argsort(x, dim=1, descending=True, stable=True)[:, :w]


def tree_warm_start_topk(tree: TreeIndex, qn: Tensor, qp: Tensor, k: int,
                         width: int):
    """Beam-descend to ``width`` best-bound leaves and exact-score them.

    A beam of ``width`` nodes starts at the root; each level expands to the
    ``2·width`` children and keeps the ``width`` highest Eq. 13 bounds, so
    ``2·width·depth`` bounds are evaluated per query, not ``n_blocks``.
    Returns ``(scores [m, k], valid [m, k])``: the k highest similarities
    among the reached real candidates, descending, padded with ``-inf`` /
    ``False`` when fewer than k were reached.
    """
    idx = tree.index
    m = qp.shape[0]
    nl, depth = tree.n_leaf_slots, tree.n_levels
    nb, bs = idx.n_blocks, idx.block_size
    w = max(1, min(width, nb))
    dev = qp.device
    beam = torch.zeros((m, w), dtype=torch.int64, device=dev)
    beam[:, 0] = 1                       # node 0 is the empty slot
    for _ in range(depth):
        live = beam > 0
        cand = torch.cat([torch.where(live, 2 * beam, 0),
                          torch.where(live, 2 * beam + 1, 0)], 1)  # [m, 2w]
        ub = _gathered_bounds(qp, tree.node_lo[cand], tree.node_hi[cand])
        ok = tree.node_valid[cand] & (cand > 0)
        sel = _top_w(ub.masked_fill(~ok, float("-inf")), w)
        beam = torch.where(ok.gather(1, sel), cand.gather(1, sel), 0)
    blocks = beam - nl                                    # leaf slot = block
    okb = (beam >= nl) & (blocks < nb)
    blocks = blocks.clamp(0, nb - 1)
    blk = idx.db.reshape(nb, bs, -1)[blocks].reshape(m, w * bs, -1)
    vb = (idx.valid.reshape(nb, bs)[blocks] & okb[:, :, None]).reshape(m, w * bs)
    scores = torch.bmm(blk, qn[:, :, None])[:, :, 0].masked_fill(
        ~vb, float("-inf"))
    kk = min(k, w * bs)
    sel = _top_w(scores, kk)
    top_s, top_v = scores.gather(1, sel), vb.gather(1, sel)
    if kk < k:
        top_s = torch.cat([top_s, top_s.new_full((m, k - kk), float("-inf"))], 1)
        top_v = torch.cat([top_v, top_v.new_zeros((m, k - kk))], 1)
    return top_s, top_v


def tree_warm_start(tree: TreeIndex, qn: Tensor, qp: Tensor, k: int,
                    width: int) -> Tensor:
    """Tree-native τ seed: the k-th best beam candidate, or -inf where the
    reached leaves hold fewer than k valid rows.  The k-th best of any set
    of real candidates is a valid lower bound on the final k-th best."""
    m = qp.shape[0]
    w = max(1, min(width, tree.n_blocks))
    if w * tree.block_size < k:
        return qp.new_full((m,), float("-inf"))
    scores, valid = tree_warm_start_topk(tree, qn, qp, k, width)
    return torch.where(valid[:, -1], scores[:, -1], float("-inf"))


def tree_descend(tree: TreeIndex, qp: Tensor, tau0: Tensor,
                 margin: float = 4e-7):
    """Level-synchronous transitive-bound descent (DESIGN.md §3.5).

    A node is evaluated when its parent survived, and survives when its
    Eq. 13 interval bound + ``margin`` reaches τ₀.  Each level's bounds are
    one ``block_bounds`` call over the level's ``2^l`` node intervals.

    Returns ``(leaf_alive [m, nb] bool, leaf_ub [m, nb], n_evals)``: the
    surviving leaves, the leaf level's bound matrix (what the flat scan
    would compute; the leaf stage reuses it) and the number of (query,
    node) bound evaluations a pointer walk would need, a 0-dim int64.
    """
    m = qp.shape[0]
    depth, nb = tree.n_levels, tree.n_blocks
    alive = tree.node_valid[1].expand(m, 1)                   # root frontier
    evals = torch.full((), m, dtype=torch.int64, device=qp.device)
    for level in range(1, depth + 1):
        base = 1 << level
        ub = block_bounds(qp, tree.node_lo[base:2 * base],
                          tree.node_hi[base:2 * base])        # [m, 2^l]
        evaluated = (alive.repeat_interleave(2, dim=1)
                     & tree.node_valid[base:2 * base][None, :])
        alive = evaluated & (ub + margin >= tau0[:, None])
        evals += evaluated.sum()
    if depth == 0:                                            # single block
        ub = block_bounds(qp, tree.node_lo[1:2], tree.node_hi[1:2])
        alive = alive & (ub + margin >= tau0[:, None])
    return alive[:, :nb], ub[:, :nb], evals


def _seed_and_descend(tree: TreeIndex, qn: Tensor, qp: Tensor, k: int, *,
                      warm_start: bool, warm_start_blocks: int | None,
                      margin: float, tau_seed: Tensor | None = None):
    """Beam seed -> transitive descent -> flat reseed, the one sequence
    every leaf stage shares.

    Returns ``(tau0 [m] or None, leaf_alive [m, nb], leaf_ub [m, nb],
    n_evals)``.  The flat reseed scores the leaf level's best-bound blocks
    too (from the descent's own bound matrix), so τ₀ is at least the scan
    backend's seed and the tree prunes at least what the scan prunes.

    ``tau_seed [m]`` (with ``warm_start``) takes the beam's place: a τ
    computed outside, a true lower bound on each query's final k-th best.
    The sharded tree branch passes the global τ, the k-th best of every
    shard's beam candidates (:func:`tree_warm_start_topk`, merged by
    ``global_tau_merge``); the reference passes a ``tau_merge`` hook that
    merges inside, which a loop over a rank's shards in one process
    cannot do.  ``None``: this tree's own beam seed.
    """
    idx = tree.index
    m = qn.shape[0]
    nb, bs = idx.n_blocks, idx.block_size
    tau0 = qn.new_full((m,), float("-inf"))
    n_pre = _bk.prescan_blocks(k, bs, nb, warm_start_blocks)
    if warm_start:
        tau0 = tree_warm_start(tree, qn, qp, k, n_pre) if tau_seed is None else tau_seed
    leaf_alive, leaf_ub, evals = tree_descend(tree, qp, tau0, margin)
    if warm_start:
        tau0 = torch.maximum(
            tau0, _bk.bound_ranked_tau(idx, qn, leaf_ub, k, n_pre))
    return (tau0 if warm_start else None), leaf_alive, leaf_ub, evals


def tree_search(tree: TreeIndex, qn: Tensor, qp: Tensor, k: int, *,
                prune: bool = True, margin: float = 4e-7,
                warm_start: bool = True, best_first: bool = True,
                element_stats: bool = False,
                warm_start_blocks: int | None = None, n_pivots: int = 0,
                tau_seed: Tensor | None = None):
    """Tree search with the scan leaf stage: beam seed (or ``tau_seed``,
    :func:`_seed_and_descend`) -> descent -> the scan loop over the
    surviving leaves, fed the descent's leaf bound matrix (with ``n_pivots
    > 0`` min'd with the joint cap; the descent and ``tree_pruned`` stay
    interval-only), the surviving-leaf mask and τ₀.

    Returns ``(top_s, pos, blk_pruned, elem_pruned, tree_pruned,
    node_evals)``: the first four as :func:`scan_search`, then the (query,
    block) pairs the descent alone cut and the (query, node) bound
    evaluations it needed, 0-dim int64 tensors.
    """
    idx = tree.index
    zero = torch.zeros((), dtype=torch.int64, device=qn.device)
    tau0 = leaf_alive = leaf_ub = None
    evals = zero
    if prune:
        tau0, leaf_alive, leaf_ub, evals = _seed_and_descend(
            tree, qn, qp, k, warm_start=warm_start,
            warm_start_blocks=warm_start_blocks, margin=margin, tau_seed=tau_seed)
        if n_pivots > 0:
            leaf_ub = torch.minimum(
                leaf_ub, multipivot_block_cap(idx, qn, n_pivots=n_pivots))
    top_s, pos, blk_pruned, elem_pruned = _bk.scan_search(
        idx, qn, qp, k, prune=prune, margin=margin, warm_start=False,
        best_first=best_first, element_stats=element_stats,
        tau0=tau0, ub_all=leaf_ub, leaf_mask=leaf_alive)
    tree_pruned = (~leaf_alive).sum() if prune else zero
    return top_s, pos, blk_pruned, elem_pruned, tree_pruned, evals


def tree_kernel_search(tree: TreeIndex, qn: Tensor, qp: Tensor, k: int, *,
                       margin: float = 4e-7, warm_start: bool = True,
                       warm_start_blocks: int | None = None, n_pivots: int = 0,
                       bm: int = DEFAULT_BM, sort_queries: bool = True,
                       best_first: bool = True, element_stats: bool = False,
                       tau_seed: Tensor | None = None):
    """Tree search with the kernel leaf stage (pruning on, ``k <=
    block_size``): seed (or ``tau_seed``) and descent, then the fused
    kernel over the compacted union of the batch's surviving leaves
    (:func:`gathered_topk`).

    With ``n_pivots > 0`` and no element stats, the joint cap against the
    τ seed first drops leaves from the union (element stats count every
    never-kept row as pruned by its interval bound, which the cap does not
    imply).  The union is one host sync; an empty union keeps block 0, so
    the kernel has a tile.  With ``sort_queries`` the queries are sorted
    into angularly coherent tiles, and ``pruned_topk``'s epilogue writes
    each row back to its caller's place (``row_out``).

    Returns ``(sims [m, k], pos [m, k], computed [m_tiles, n_keep],
    elem_pruned or None, tree_pruned, node_evals, keep [n_keep])``:
    ``elem_pruned`` (with ``element_stats``) counts the kernel's pruned
    (query, valid row) pairs plus every query's pairs with the rows of the
    never-kept blocks, which the descent proved below τ₀ (each row's own
    bound lies under its leaf's node bound); ``tree_pruned`` counts the
    descent's cuts alone.
    """
    idx = tree.index
    m, nb, bs = qn.shape[0], tree.n_blocks, tree.block_size
    tau0, leaf_alive, _, evals = _seed_and_descend(
        tree, qn, qp, k, warm_start=warm_start,
        warm_start_blocks=warm_start_blocks, margin=margin, tau_seed=tau_seed)
    tree_pruned = (~leaf_alive).sum()
    if n_pivots > 0 and tau0 is not None and not element_stats:
        cap = multipivot_block_cap(idx, qn, n_pivots=n_pivots)
        leaf_alive = leaf_alive & (cap + margin >= tau0[:, None])
    keep = torch.nonzero(leaf_alive.any(0))[:, 0].int()   # ascending
    if keep.numel() == 0:
        keep = keep.new_zeros(1)
    perm = None
    if sort_queries:
        perm = _bk.query_sort_perm(qp).int()
        qn, qp = qn[perm], qp[perm]
        tau0 = None if tau0 is None else tau0[perm]
    sims, pos, computed, elem = gathered_topk(
        idx, keep, qn, qp, tau0, k=k, bm=bm, margin=margin,
        element_stats=element_stats, best_first=best_first, row_out=perm)
    if element_stats:
        per_block = idx.valid.view(nb, bs).sum(1)
        never = per_block.sum() - per_block[keep.long()].sum()
        elem = elem.sum() + m * never
    return sims, pos, computed, elem, tree_pruned, evals, keep


@_bk.register_backend("tree")
class TreeBackend:
    """Hierarchical pivot-tree backend (``backend="tree"``).

    Builds a :class:`TreeIndex` over the engine's index on first use and
    caches it on the engine.  The leaf stage is the engine's ``leaf_eval``:
    ``"scan"`` (the scan loop over the surviving leaves), ``"kernel"``
    (:meth:`_run_kernel_leaves`: the union of the batch's surviving leaves
    compacted and searched by the fused kernel) or ``"auto"`` (kernel on a
    CUDA index with d <= 4096, else scan; the reference's rule with the
    card in the TPU's place).  As in the reference, the kernel leaf stage
    runs only with pruning on and ``k <= block_size`` (the kernel's tile);
    otherwise the scan leaf stage serves the call.  That is the reference's
    semantics, not a fallback from a failure.
    """

    name = "tree"

    def _tree(self, eng) -> TreeIndex:
        if eng._tree_index is None:
            eng._tree_index = build_tree(eng.index)
            eng._tree_valid_nodes = eng._tree_index.n_valid_nodes
        return eng._tree_index

    @staticmethod
    def _resolve_leaf_eval(eng) -> str:
        if eng.leaf_eval != "auto":
            return eng.leaf_eval
        # the flat kernel's rule in auto_backend: the fused kernel on the
        # card up to d = 4096
        return ("kernel" if eng.index.device.type == "cuda"
                and eng.index.db.shape[-1] <= 4096 else "scan")

    def run(self, eng, queries, k, *, prune=True, element_stats=False):
        tree = self._tree(eng)
        qn, qp = _bk.prep_queries(eng.index, queries)
        m, nb = qn.shape[0], tree.n_blocks
        if (self._resolve_leaf_eval(eng) == "kernel" and prune
                and k <= tree.block_size):
            return self._run_kernel_leaves(eng, tree, qn, qp, k,
                                           element_stats=element_stats)
        top_s, pos, blk_pruned, elem_pruned, tree_pruned, evals = tree_search(
            tree, qn, qp, k, prune=prune, margin=eng.margin,
            warm_start=eng.warm_start, best_first=eng.best_first,
            element_stats=element_stats,
            warm_start_blocks=eng.warm_start_blocks, n_pivots=eng.n_pivots)
        ids = _bk.map_row_ids(eng.index.row_ids, pos)
        raw = {"block_prune_frac": blk_pruned / (m * nb),
               "tree_levels": tree.n_levels}
        if prune:
            # absent-stage rule: with prune off the descent never ran, so
            # the tree fractions stay None (engine raw.get), never 0
            raw["tree_prune_frac"] = tree_pruned / (m * nb)
            raw["tree_node_eval_frac"] = evals / (
                m * max(1, eng._tree_valid_nodes))
        if element_stats:
            raw["elem_prune_frac"] = elem_pruned / (m * max(1, eng.n_valid))
        return top_s, ids, raw

    def _run_kernel_leaves(self, eng, tree: TreeIndex, qn: Tensor, qp: Tensor,
                           k: int, *, element_stats: bool):
        """:func:`tree_kernel_search` with the engine's options, and its
        stats over the full (query tile, block) grid: the compacted-away
        tiles were never launched."""
        m, nb = qn.shape[0], tree.n_blocks
        sims, pos, computed, elem, tree_pruned, evals, keep = tree_kernel_search(
            tree, qn, qp, k, margin=eng.margin, warm_start=eng.warm_start,
            warm_start_blocks=eng.warm_start_blocks, n_pivots=eng.n_pivots,
            bm=eng.bm, sort_queries=eng.sort_queries, best_first=eng.best_first,
            element_stats=element_stats)
        ids = _bk.map_row_ids(tree.index.row_ids, pos)
        grid = computed.shape[0] * nb
        computed_sum = computed.float().sum()
        raw = {"block_prune_frac": 1.0 - computed_sum / grid,
               "tile_computed_frac": computed_sum / grid,
               "tree_prune_frac": tree_pruned / (m * nb),
               "tree_node_eval_frac": evals / (m * max(1, eng._tree_valid_nodes)),
               "tree_levels": tree.n_levels,
               "n_keep": keep.numel()}
        if element_stats:
            raw["elem_prune_frac"] = elem.float() / (m * max(1, eng.n_valid))
        return sims, ids, raw
