"""Mesh-sharded exact cosine search: the sharded datastore.

Counterpart of :mod:`repro.core.distributed`, its flat part: the engine
room of the SearchEngine's ``"sharded"`` backend.  The datastore rows
split into ``S`` shards, each its own :class:`BlockIndex`.  Pivots are
*local* to a shard, which keeps the build embarrassingly parallel and,
because a shard covers a narrower slice of the sphere, makes its Eq. 13
bounds slightly tighter than global pivots would.  Every shard bakes the
GLOBAL row ids into ``row_ids``, so the merge needs no rank arithmetic.

**Placement.** The mesh is a ``torch.distributed.device_mesh.DeviceMesh``;
its ``mesh_dim_names`` play the reference's axis names.  The ``S`` shards
split over the ``W`` ranks of the flattened axes (``axis_names``, default
all of them, major to minor), and each rank holds its ``L = S / W``
contiguous shards as one stacked :class:`BlockIndex` ``[L, ...]`` on its
device.  The reference places one shard per device, which is ``L = 1``
here; ``L > 1`` is what lets one card hold ``S = 8``.  ``mesh=None`` means
this process alone, holding every shard of the index it is given.

**Search** (:func:`sharded_search_local`): each local shard runs its
device's single-device stage, and the per-shard top-k lists merge in one
tiny collective (:func:`repro_torch.dist.collectives.topk_allgather_merge`,
``O(S * k)`` values, then ``torch.topk``).  On CUDA the stage is the kernel
backend's :func:`~repro_torch.search.backends.kernel_search`: the
``block_bounds_select`` kernel (or ``block_bounds`` past 8 prescanned
tiles) and one ``pruned_topk`` launch per shard, with no fallback: a kernel
that does not build or launch fails the search.  On the CPU it is the
reference's scan loop (:func:`~repro_torch.search.backends.scan_search`),
for parity with the reference.  τ warm start and best-first order apply
per shard, each against its own local τ.  Exact: every shard returns its
true local top-k, and the union of the local top-k sets holds the global
top-k.

**Shard trees** (the ``tree=`` branch, the reference's DESIGN.md §3.6):
with one pivot tree per shard
(:class:`~repro_torch.search.tree.ShardTreeArrays`), each shard first runs
the transitive Eq. 13 descent over its own tree, against ONE global τ per
query: the k-th best of every shard's beam candidates on every rank
(:func:`~repro_torch.dist.collectives.global_tau_merge`, a second tiny
collective).  Then each shard's leaf stage searches its surviving leaves:
on CUDA the tree backend's kernel leaf stage (``gathered_topk`` over
``pruned_topk``, seeded with τ; the scan leaf stage where ``k`` exceeds
the block size, as the single-device tree backend rules), on the CPU the
scan loop, as the reference.  Exact: τ is the k-th best of real scored
rows, so a cut subtree holds no global top-k member.

**Online mutation** (the reference's DESIGN.md §3.10):
:class:`~repro_torch.core.online.ShardedMutableIndex` places each new row
by a pure function of host mirrors that every rank holds alike (built
from :func:`replicated_row_ids`), and :class:`ShardedMutationOps` writes
each rank's own shards.

**Multi-process** (the reference's DESIGN.md §3.7):
:func:`build_sharded_index_local` builds only this rank's shards, from the
rows it owns (:func:`local_shard_rows`), so no rank holds the whole
datastore; it is bit-identical to the matching slices of
:func:`build_sharded_index` on the same device type, since both call
:func:`_build_shard_part`.  Search needs nothing more: the merge and the
stats' sums are collectives over the group of the flattened axes.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor

from repro_torch.core.index import (BlockIndex, build_index, index_from_reference,
                                    reorder_perm, sound_intervals)
from repro_torch.core.online import append_blocks, write_rows
from repro_torch.dist.collectives import (gather_shards, global_tau_merge,
                                          topk_allgather_merge)
from repro_torch.dist.placement import local_device
from repro_torch.kernels.cosine_topk import DEFAULT_BM

__all__ = ["build_sharded_index", "build_sharded_index_local", "local_shard_rows",
           "make_sharded_search", "sharded_search_local", "place_sharded_index",
           "sharded_index_from_reference", "local_shard", "shard_group",
           "shard_layout", "runs_kernel", "replicated_row_ids", "ShardedMutationOps",
           "make_sharded_mutation"]


# ---------------------------------------------------------------------------
# stacked indexes
# ---------------------------------------------------------------------------

def local_shard(index: BlockIndex, i: int) -> BlockIndex:
    """Shard ``i`` of a stacked ``[L, ...]`` index, as a flat index (views)."""
    return BlockIndex(*(None if t is None else t[i] for t in index))


def _stack_shards(parts: list[BlockIndex]) -> BlockIndex:
    """Flat per-shard indexes of equal shapes -> one stacked ``[L, ...]``."""
    return BlockIndex(*(None if f[0] is None else torch.stack(f) for f in zip(*parts)))


def sharded_index_from_reference(arrays: dict, device=None) -> BlockIndex:
    """The port's stacked index from the reference's stacked ``BlockIndex``
    fields (numpy ``[S, ...]`` each, ``{f: np.asarray(getattr(idx, f))}``):
    :func:`~repro_torch.core.index.index_from_reference` per shard, stacked,
    so both packages can search the identical sharded index."""
    n_shards = np.asarray(arrays["db"]).shape[0]
    return _stack_shards([
        index_from_reference({f: None if a is None else np.asarray(a)[s]
                              for f, a in arrays.items()}, device)
        for s in range(n_shards)])


# ---------------------------------------------------------------------------
# the mesh: which shards this rank holds, and the group they merge over
# ---------------------------------------------------------------------------

def _flat_dims(mesh, axis_names) -> tuple[int, ...]:
    """The mesh dims of ``axis_names`` (names or dim indices; default all
    dims), in the order given: the first is the most significant."""
    if axis_names is None:
        return tuple(range(mesh.ndim))
    if isinstance(axis_names, (str, int)):
        axis_names = (axis_names,)
    names = tuple(mesh.mesh_dim_names or ())
    dims = []
    for a in axis_names:
        if not isinstance(a, int) and a not in names:
            raise ValueError(f"axis {a!r} is not a dim of the mesh {names}")
        dims.append(a if isinstance(a, int) else names.index(a))
    return tuple(dims)


def shard_layout(mesh, axis_names=None) -> tuple[int, int]:
    """``(W, position)``: the ranks of the flattened ``axis_names`` and this
    rank's position among them (its coordinates on those dims, major to
    minor).  ``mesh=None``: ``(1, 0)``."""
    if mesh is None:
        return 1, 0
    dims = _flat_dims(mesh, axis_names)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    shape = tuple(mesh.mesh.shape)
    pos = 0
    for d in dims:
        pos = pos * shape[d] + coord[d]
    return math.prod(shape[d] for d in dims), pos


def shard_group(mesh, axis_names=None):
    """The process group the merges run over: the ranks of the flattened
    ``axis_names`` that share this rank's other coordinates (e.g.
    ``("pod", "data")`` of a multipod mesh, ``"model"`` replicated).
    ``None`` (no collective) without a mesh or with one rank."""
    if mesh is None:
        return None
    dims = _flat_dims(mesh, axis_names)
    if math.prod(mesh.mesh.shape[d] for d in dims) == 1:
        return None
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    if sorted(dims) == list(range(mesh.ndim)) and mesh.mesh.numel() == dist.get_world_size():
        return dist.group.WORLD
    # several dims: a group over their flattened ranks, made the same way on
    # every rank (every rank must ask for it)
    if list(dims) != sorted(dims):
        raise ValueError(f"mesh dims {dims} must be given in the mesh's order")
    return mesh[tuple(mesh.mesh_dim_names[d] for d in dims)]._flatten().get_group()


def _per_rank(n_shards: int, n_ranks: int) -> int:
    if n_shards < 1 or n_shards % n_ranks:
        raise ValueError(f"{n_shards} shards do not split evenly over {n_ranks} ranks")
    return n_shards // n_ranks


def local_shard_rows(n_rows: int, mesh, axis_names=None, *, n_shards: int | None = None):
    """Which global datastore rows THIS rank's shards cover.

    ``n_shards`` defaults to one shard per rank of the flattened axes (the
    reference's layout); it must be a multiple of that rank count.  Returns
    ``(per, owned)``: ``per`` the global rows per shard (``ceil(n_rows /
    S)``), ``owned`` this rank's shards as ``[(shard_id, row_start,
    row_stop), ...]`` in ascending order, the order a rank's slab of the
    datastore is concatenated in for :func:`build_sharded_index_local`.
    ``row_stop`` is clamped to ``n_rows`` (the trailing shards may be short
    or empty; their tails pad with invalid rows at build time).
    """
    n_dev, pos = shard_layout(mesh, axis_names)
    n_shards = n_dev if n_shards is None else n_shards
    per_rank = _per_rank(n_shards, n_dev)
    per = -(-n_rows // n_shards)
    owned = [(s, min(s * per, n_rows), min((s + 1) * per, n_rows))
             for s in range(pos * per_rank, (pos + 1) * per_rank)]
    return per, owned


# ---------------------------------------------------------------------------
# the builds
# ---------------------------------------------------------------------------

def _padded(db: Tensor, start: int, stop: int, per: int) -> Tensor:
    """Rows ``[start, stop)`` of ``db``, zero rows appended up to ``per``."""
    rows = db[start:stop]
    if rows.shape[0] < per:
        rows = torch.cat([rows, rows.new_zeros(per - rows.shape[0], db.shape[1])])
    return rows


def _build_shard_part(shard, n_valid: int, row_offset: int, *, n_pivots: int,
                      block_size: int, pivot_method: str, device) -> BlockIndex:
    """One shard's :class:`BlockIndex` with GLOBAL row ids baked in.

    The one per-shard build both :func:`build_sharded_index` and
    :func:`build_sharded_index_local` call, which makes the process-local
    build bit-identical to the whole one (same rows in, same pivots,
    reorder and intervals out).  The shard's zero padding rows are marked
    invalid even where ``build_index``'s own padding did not cover them
    (``row_ids`` tracks the pre-reorder position); ``dp_min/dp_max`` keep
    them, as the reference's do, and ``dp_lo/dp_hi`` are recomputed over
    the valid rows, as ``index_from_reference`` computes them.
    """
    idx = build_index(shard, n_pivots=n_pivots, block_size=block_size,
                      pivot_method=pivot_method if n_valid > n_pivots else "random",
                      device=device)
    valid = idx.valid & (idx.row_ids >= 0) & (idx.row_ids < n_valid)
    gids = torch.where(valid, idx.row_ids + row_offset, -1).to(torch.int32)
    if not torch.equal(valid, idx.valid):
        lo, hi = sound_intervals(idx.db, idx.pivots, valid, idx.dp_min, idx.dp_max)
        idx = idx._replace(dp_lo=lo, dp_hi=hi)
    return idx._replace(valid=valid, row_ids=gids)


def build_sharded_index(db, n_shards: int, *, n_pivots: int = 16, block_size: int = 128,
                        pivot_method: str = "maxmin", device=None) -> BlockIndex:
    """Split ``db`` row-wise into ``n_shards`` and build one index per shard
    on ``device`` (``None`` means CUDA).

    Returns a :class:`BlockIndex` whose tensors carry a leading shard axis
    ``[S, ...]``; :func:`place_sharded_index` gives each rank its slice.
    Rows pad to equal shard sizes with invalid zero rows.
    """
    db = torch.as_tensor(db, dtype=torch.float32)
    n = db.shape[0]
    per = -(-n // n_shards)
    return _stack_shards([
        _build_shard_part(_padded(db, s * per, (s + 1) * per, per),
                          n_valid=min(per, max(0, n - s * per)), row_offset=s * per,
                          n_pivots=n_pivots, block_size=block_size,
                          pivot_method=pivot_method, device=device)
        for s in range(n_shards)])


def build_sharded_index_local(db_local, mesh, *, global_rows: int, axis_names=None,
                              n_shards: int | None = None, n_pivots: int = 16,
                              block_size: int = 128,
                              pivot_method: str = "maxmin") -> BlockIndex:
    """Process-local sharded build: this rank's shards from its own rows.

    ``db_local`` holds ONLY the rows this rank's shards cover: the
    concatenation, in ascending shard order, of the :func:`local_shard_rows`
    ranges.  ``global_rows`` is the TOTAL logical row count across all
    ranks (it fixes the rows per shard and the global row-id offsets).
    Returns this rank's ``[L, ...]`` stacked index on its device
    (its current CUDA device on a CUDA mesh), bit-identical, shard for shard, to the matching
    slice of ``build_sharded_index(full_db, n_shards)`` on the same device
    type.
    """
    db_local = torch.as_tensor(db_local, dtype=torch.float32)
    per, owned = local_shard_rows(global_rows, mesh, axis_names, n_shards=n_shards)
    expected = sum(stop - start for _, start, stop in owned)
    if db_local.shape[0] != expected:
        raise ValueError(
            f"db_local has {db_local.shape[0]} rows but this rank's shards "
            f"{[s for s, _, _ in owned]} cover {expected} of the {global_rows} "
            f"global rows ({per} per shard); slice the datastore with "
            f"local_shard_rows()")
    parts, ofs = [], 0
    for s, start, stop in owned:
        cnt = stop - start
        parts.append(_build_shard_part(
            _padded(db_local, ofs, ofs + cnt, per), n_valid=cnt, row_offset=s * per,
            n_pivots=n_pivots, block_size=block_size, pivot_method=pivot_method,
            device=local_device(mesh)))
        ofs += cnt
    return _stack_shards(parts)


def place_sharded_index(index: BlockIndex, mesh, axis_names=None) -> BlockIndex:
    """This rank's slice ``[L, ...]`` of a whole stacked index ``[S, ...]``,
    on its device: the shards the flattened mesh axes give it."""
    n_dev, pos = shard_layout(mesh, axis_names)
    per_rank = _per_rank(index.db.shape[0], n_dev)
    dev = local_device(mesh)
    return BlockIndex(*(None if t is None
                        else t[pos * per_rank:(pos + 1) * per_rank].to(dev)
                        for t in index))


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def runs_kernel(index: BlockIndex, k: int, tree=None) -> bool:
    """Whether each shard's stage of a search at ``k`` runs the fused
    kernel: on CUDA, save the tree branch's scan leaf stage past the block
    size (the single-device tree backend's rule)."""
    return index.db.device.type == "cuda" and (
        tree is None or k <= index.db.shape[-2] // index.dp_min.shape[-2])


def sharded_search_local(index: BlockIndex, queries, k: int, group=None, *,
                         prune: bool = True, warm_start: bool = False,
                         best_first: bool = False,
                         warm_start_blocks: int | None = None,
                         element_stats: bool = False, with_stats: bool = False,
                         margin: float = 4e-7, n_pivots: int = 0,
                         bm: int = DEFAULT_BM, bn: int | None = None,
                         sort_queries: bool = True, tree=None):
    """Search this rank's shards, then merge over ``group``.

    ``index`` is this rank's stacked ``[L, ...]`` index; every rank of the
    group passes the same ``queries``.  Each shard runs its device's stage
    (module docstring) with the engine policies (``warm_start``,
    ``best_first``, ``warm_start_blocks``, ``n_pivots``, ``element_stats``;
    ``bm``, ``bn`` and ``sort_queries`` are the kernel's tile options) at
    ``min(k, its padded rows)``, padded back to ``k`` with ``(-inf, -1)``.

    ``tree`` (this rank's :class:`~repro_torch.search.tree.ShardTreeArrays`,
    ``[L, ...]``; needs ``prune``) takes the tree branch in two passes over
    the shards.  Pass 1 prepares each shard's queries and takes its beam
    candidates (with ``warm_start``); one :func:`global_tau_merge` over
    every shard of every rank turns them into the global τ.  Pass 2
    descends each shard's tree against it, reseeds from the shard's own
    flat prescan (the max of the two), applies the joint cap with
    ``n_pivots > 0``, and runs the leaf stage at ``k``.

    Returns ``(sims [m, k], ids [m, k])`` global row ids, the same on every
    rank; with ``with_stats`` also ``(block_prune_frac, elem_prune_frac)``,
    and on the tree branch ``(tree_prune_frac, tree_node_eval_frac)`` after
    them, each a 0-dim float64 tensor: summed counts over summed
    denominators across every shard of every rank, so unevenly filled
    shards weigh correctly.  Their units are the reference's: the (query
    tile, kernel tile) pairs the kernel skipped on CUDA, the (query, block)
    pairs the scan skipped on the CPU; the (query, valid row) pairs whose
    own bound fell below τ; the (query, block) pairs the descent cut; the
    (query, node) bounds the descent evaluated over the valid nodes.
    """
    from repro_torch.search.backends import (kernel_search, map_row_ids,
                                             prep_queries, prescan_blocks, scan_search)
    from repro_torch.search import tree as _tree

    dev = index.db.device
    use_kernel = runs_kernel(index, k, tree)
    shards = [local_shard(index, i) for i in range(index.db.shape[0])]
    preps = [prep_queries(local, queries) for local in shards]
    m = preps[0][0].shape[0]
    # pruned units, units, pruned (query, row) pairs, valid rows; on the tree
    # branch the descent's cut (query, block) pairs, the shards' blocks, its
    # (query, node) evaluations and the valid nodes
    counts = torch.zeros(8, dtype=torch.int64, device=dev)
    sims, ids = [], []
    if tree is not None:
        if not prune:
            raise ValueError("the shard trees' descent needs prune=True")
        trees = [tree.shard(local, i) for i, local in enumerate(shards)]
        tau = None
        if warm_start:
            cands = [_tree.tree_warm_start_topk(
                t, qn, qp, k, prescan_blocks(k, t.block_size, t.n_blocks, warm_start_blocks))
                for t, (qn, qp) in zip(trees, preps)]
            tau = global_tau_merge(torch.stack([c[0] for c in cands]),
                                   torch.stack([c[1] for c in cands]), k, group)
        opts = dict(margin=margin, warm_start=warm_start,
                    warm_start_blocks=warm_start_blocks, n_pivots=n_pivots,
                    best_first=best_first, element_stats=element_stats, tau_seed=tau)
        for t, (qn, qp) in zip(trees, preps):
            if use_kernel:
                s, pos, computed, elem, cut, evals, _ = _tree.tree_kernel_search(
                    t, qn, qp, k, bm=bm, sort_queries=sort_queries, **opts)
                units = computed.shape[0] * t.n_blocks
                counts[0] += units - computed.sum()
                counts[1] += units
                if element_stats:
                    counts[2] += elem
            else:
                s, pos, blk_pruned, elem_pruned, cut, evals = _tree.tree_search(
                    t, qn, qp, k, **opts)
                counts[0] += blk_pruned
                counts[1] += m * t.n_blocks
                counts[2] += elem_pruned
            counts[3] += t.index.valid.sum()
            counts[4] += cut
            counts[5] += t.n_blocks
            counts[6] += evals
            counts[7] += t.node_valid.sum()
            sims.append(s)
            ids.append(map_row_ids(t.index.row_ids, pos))
    else:
        for local, (qn, qp) in zip(shards, preps):
            kk = min(k, local.db.shape[0])
            if use_kernel:
                s, pos, computed, elem = kernel_search(
                    local, qn, qp, kk, bm=bm, bn=bn, prune=prune, sort_queries=sort_queries,
                    warm_start=warm_start, best_first=best_first, margin=margin,
                    element_stats=element_stats, warm_start_blocks=warm_start_blocks,
                    n_pivots=n_pivots)
                counts[0] += computed.numel() - computed.sum()
                counts[1] += computed.numel()
                if element_stats:
                    counts[2] += elem.sum()
            else:
                s, pos, blk_pruned, elem_pruned = scan_search(
                    local, qn, qp, kk, prune=prune, margin=margin, warm_start=warm_start,
                    best_first=best_first, element_stats=element_stats,
                    warm_start_blocks=warm_start_blocks, n_pivots=n_pivots)
                counts[0] += blk_pruned
                counts[1] += m * local.n_blocks
                counts[2] += elem_pruned
            counts[3] += local.valid.sum()
            g = map_row_ids(local.row_ids, pos)
            if kk < k:
                s = torch.cat([s, s.new_full((m, k - kk), float("-inf"))], 1)
                g = torch.cat([g, g.new_full((m, k - kk), -1)], 1)
            sims.append(s)
            ids.append(g)
    merged = topk_allgather_merge(torch.stack(sims), torch.stack(ids), k, group)
    if not with_stats:
        return merged
    if group is not None:
        dist.all_reduce(counts, group=group)
    frac = counts[0].double() / counts[1]
    efrac = counts[2].double() / (m * counts[3]).clamp(min=1)
    if tree is None:
        return merged + (frac, efrac)
    tfrac = counts[4].double() / (m * counts[5])
    evfrac = counts[6].double() / (m * counts[7]).clamp(min=1)
    return merged + (frac, efrac, tfrac, evfrac)


def make_sharded_search(mesh=None, axis_names=None, *, prune: bool = True,
                        warm_start: bool = False, best_first: bool = False,
                        warm_start_blocks: int | None = None,
                        element_stats: bool = False, with_stats: bool = False,
                        margin: float = 4e-7, n_pivots: int = 0,
                        bm: int = DEFAULT_BM, bn: int | None = None,
                        sort_queries: bool = True):
    """An ``(index, queries, k, tree=None) -> (sims, gids[, block_prune_frac,
    elem_prune_frac[, tree_prune_frac, tree_node_eval_frac]])`` closure over
    :func:`sharded_search_local`, merging over the group of ``mesh``'s
    flattened ``axis_names`` (default all of them; ``mesh=None``: this
    process alone).  Pass ``tree`` (this rank's shard trees) for the tree
    branch.  Results are the same on every rank of the group."""
    group = shard_group(mesh, axis_names)

    def run(index: BlockIndex, queries, k: int, tree=None):
        return sharded_search_local(
            index, queries, k, group, prune=prune, warm_start=warm_start,
            best_first=best_first, warm_start_blocks=warm_start_blocks,
            element_stats=element_stats, with_stats=with_stats, margin=margin,
            n_pivots=n_pivots, bm=bm, bn=bn, sort_queries=sort_queries, tree=tree)

    return run


# ---------------------------------------------------------------------------
# online mutation
# ---------------------------------------------------------------------------

def replicated_row_ids(index: BlockIndex, mesh=None, axis_names=None) -> np.ndarray:
    """Host copy ``[S, n_pad]`` of every shard's ``row_ids``: this rank's
    ``[L, n_pad]`` all-gathered over the group of ``mesh``'s flattened
    ``axis_names`` (a plain copy without a mesh or with one rank).  The
    sharded online handle's one collective, when it is made and after each
    ``reoptimize``; every rank derives the same id -> (shard, slot) map and
    free lists from it."""
    return gather_shards(index.row_ids, shard_group(mesh, axis_names)).cpu().numpy()


class ShardedMutationOps:
    """The device writes of one sharded online handle, on this rank's
    shards, in place.

    Every operand is the host copy that all ranks hold alike: ``[S, R]``
    per-shard entries over all ``S`` shards, padded to a uniform width
    ``R`` with ``mask`` False.  Each op reads the rows of this rank's ``L``
    shards, ``[position·L, (position+1)·L)``, and writes only them, so no
    op needs a collective.  A loop over the local shards, each through the
    flat handle's own writes, takes the place of the reference's ``vmap``.
    """

    def __init__(self, mesh=None, axis_names=None):
        self.n_ranks, self.position = shard_layout(mesh, axis_names)

    def _mine(self, index: BlockIndex, *operands):
        n_local = index.db.shape[0]
        rows = slice(self.position * n_local, (self.position + 1) * n_local)
        return [np.asarray(x)[rows] for x in operands]

    def insert(self, index: BlockIndex, slots, mask, rows, ids):
        """Write the masked entries: ``slots`` / ``ids [S, R]`` int,
        ``rows [S, R, d]`` float64 unit rows.  Each shard's rows go through
        :func:`~repro_torch.core.online.write_rows` (its ``dp``, the blocks'
        ``dp_min/dp_max`` and sound ``dp_lo/dp_hi``, the joint tables).
        Returns ``(index, widening)``: ``widening = (blocks [L, R], lo, hi
        [L, R, P], mask [L, R])`` on the index's device, the operands of
        :meth:`widen`."""
        slots, mask, rows, ids = self._mine(index, slots, mask, rows, ids)
        dev = index.db.device
        n_local, width = mask.shape
        p = index.pivots.shape[-2]
        bs = index.db.shape[1] // index.dp_min.shape[1]
        lo = torch.full((n_local, width, p), float("inf"), device=dev)
        hi = torch.full((n_local, width, p), float("-inf"), device=dev)
        for i in range(n_local):
            sel = np.flatnonzero(mask[i])
            if sel.size:
                _, lo_i, hi_i = write_rows(local_shard(index, i), slots[i, sel],
                                           rows[i, sel], ids[i, sel].tolist())
                at = torch.from_numpy(sel).to(dev)
                lo[i, at], hi[i, at] = lo_i, hi_i
        widening = (torch.from_numpy(slots // bs).to(dev), lo, hi,
                    torch.from_numpy(mask).to(dev))
        return index, widening

    def delete(self, index: BlockIndex, slots, mask) -> BlockIndex:
        """Tombstone the masked ``slots [S, R]``: ``valid`` off,
        ``row_ids`` -1."""
        slots, mask = self._mine(index, slots, mask)
        shard, j = np.nonzero(mask)
        at = torch.from_numpy(shard * index.db.shape[1] + slots[shard, j]).to(index.db.device)
        index.valid.view(-1)[at] = False
        index.row_ids.view(-1)[at] = -1
        return index

    @staticmethod
    def grow(index: BlockIndex, n_add: int) -> BlockIndex:
        """Append ``n_add`` all-padding blocks to every local shard (new
        tensors; :func:`~repro_torch.core.online.append_blocks`)."""
        return append_blocks(index, n_add)

    @staticmethod
    def repack(index: BlockIndex, n_pad_new: int) -> BlockIndex:
        """Each local shard repacked under its own pivots (new tensors):
        its rows in ``build_index``'s reorder (nearest pivot, then
        similarity to it, descending; tombstones and padding last), cut to
        ``n_pad_new`` rows, and every interval recomputed from the live rows
        alone, ``dp_min/dp_max`` over their float32 ``dp`` and ``dp_lo/dp_hi``
        by :func:`~repro_torch.core.index.sound_intervals`.  No row moves
        across shards and no pivot is reselected."""
        parts = []
        for i in range(index.db.shape[0]):
            loc = local_shard(index, i)
            p, bs = loc.n_pivots, loc.block_size
            perm = reorder_perm(loc.dp, loc.valid, p)[:n_pad_new]
            db, dp, valid = loc.db[perm], loc.dp[perm], loc.valid[perm]
            nb = n_pad_new // bs
            rows = valid[:, None]
            dp_min = torch.where(rows, dp, float("inf")).reshape(nb, bs, p).amin(1)
            dp_max = torch.where(rows, dp, float("-inf")).reshape(nb, bs, p).amax(1)
            lo, hi = sound_intervals(db, loc.pivots, valid, dp_min, dp_max)
            new = loc._replace(db=db, dp=dp, valid=valid,
                               row_ids=torch.where(valid, loc.row_ids[perm], -1),
                               dp_min=dp_min, dp_max=dp_max, dp_lo=lo, dp_hi=hi)
            if loc.beta is not None:
                new = new._replace(beta=loc.beta[perm], beta_nsq=loc.beta_nsq[perm])
            parts.append(new)
        return _stack_shards(parts)

    @staticmethod
    def widen(tree, blocks, lo, hi, mask):
        """The live shard trees widened along the inserted rows' paths, in
        place (:func:`~repro_torch.search.tree.widen_shard_trees`)."""
        from repro_torch.search.tree import widen_shard_trees
        return widen_shard_trees(tree, blocks, lo, hi, mask)


def make_sharded_mutation(mesh=None, axis_names=None) -> ShardedMutationOps:
    """The :class:`ShardedMutationOps` of a handle over a sharded engine on
    ``mesh`` (``None``: every shard in this process)."""
    return ShardedMutationOps(mesh, axis_names)
