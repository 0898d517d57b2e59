"""Search backends: the inner loops behind :class:`SearchEngine`.

Counterpart of :mod:`repro.search.backends`.  Every backend implements::

    run(engine, queries, k, *, prune, element_stats)
        -> (sims [m, k] f32, ids [m, k] i32 original row ids, raw stats dict)

and registers itself under a name with :func:`register_backend`:

  ``scan``    a loop over the index blocks (masked matmuls), fed by the
              ``block_bounds`` kernel; also the ``tree`` backend's leaf
              stage (:mod:`repro_torch.search.tree`)
  ``kernel``  the hand-written ``pruned_topk`` kernel (tiles it proves
              unnecessary are skipped), fed by the ``block_bounds_select``
              kernel
  ``brute``   full matmul + top-k (baseline / tiny datastores)
  ``sharded`` a shard-stacked index: each shard's stage above for its
              device (``kernel`` on CUDA, ``scan`` on the CPU), then a
              top-k merge over the mesh (:mod:`repro_torch.core.distributed`)

The shared helpers (query prep, τ warm-start seeding, best-first tile
order) follow the reference line by line; every ``argsort`` is stable, as
``jnp.argsort`` is, because ties decide the visit order and so which tiles
are computed.
"""
from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.core.index import (BlockIndex, multipivot_block_cap,
                                    pivot_cosines64)
from repro_torch.core.pivots import normalize
from repro_torch.kernels import cosine_topk
from repro_torch.kernels import ref as kref
from repro_torch.kernels.bound_prune import (block_bounds, block_bounds_select,
                                             select_bounds)

__all__ = [
    "register_backend", "get_backend", "available_backends",
    "prep_queries", "map_row_ids", "scan_search", "kernel_inputs",
    "kernel_search", "brute_search", "tau_warm_start", "bound_ranked_tau",
    "prescan_blocks", "coarsen_intervals", "query_sort_perm",
    "best_first_order", "SELECT_ROUTE_MAX_N_PRE",
]

#: the widest prescan (tiles per query) that :func:`kernel_inputs` takes
#: through ``block_bounds_select``; a wider one, which only an explicit
#: ``warm_start_blocks`` asks for, takes the ``block_bounds`` matrix and
#: sorts it.  The select kernel's merge grows with n_pre squared, so the
#: matrix route wins for wide prescans; on an H100 the two cross between
#: 9 and 64 tiles, above this limit (PERF.md)
SELECT_ROUTE_MAX_N_PRE = 8

_REGISTRY: dict[str, object] = {}


def register_backend(name: str):
    """Class decorator: register a backend under ``name`` (instantiated)."""
    def deco(cls):
        _REGISTRY[name] = cls()
        return cls
    return deco


def get_backend(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown search backend {name!r}; "
            f"registered: {available_backends()}") from None


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# shared pieces (engine-owned plumbing)
# ---------------------------------------------------------------------------

def prep_queries(index: BlockIndex, queries) -> tuple[Tensor, Tensor]:
    """Normalize queries and compute query-pivot similarities once:
    ``qp`` is each float64 cosine (:func:`pivot_cosines64`) rounded to
    nearest float32, so its float32 neighbours contain it; every bound
    reads that interval (``core/index.py:interval_upper_bound``), while the
    query sort and the warm start read ``qp`` itself."""
    qn = normalize(torch.as_tensor(queries, dtype=torch.float32,
                                   device=index.device))
    return qn, pivot_cosines64(qn, index.pivots).float()


def map_row_ids(row_ids: Tensor, pos: Tensor) -> Tensor:
    """Padded/reordered positions -> original row ids (-1 stays -1)."""
    return torch.where(pos >= 0, row_ids[pos.clamp(min=0).long()], -1)


def coarsen_intervals(dp_min: Tensor, dp_max: Tensor, factor: int):
    """Merge ``factor`` consecutive index blocks into one kernel tile."""
    nb, p = dp_min.shape
    if nb % factor:
        raise ValueError(f"{nb} blocks do not split into tiles of {factor}")
    lo = dp_min.reshape(nb // factor, factor, p).amin(1)
    hi = dp_max.reshape(nb // factor, factor, p).amax(1)
    return lo, hi


def prescan_blocks(k: int, block_rows: int, n_blocks: int,
                   warm_start_blocks: int | None = None) -> int:
    """How many bound-ranked blocks τ seeding scores: at least
    ``ceil(k / block_rows)`` (the fewest that can hold k candidates),
    widened by ``warm_start_blocks``, clamped to ``n_blocks``."""
    n_pre = -(-k // max(1, block_rows))
    if warm_start_blocks is not None:
        n_pre = max(n_pre, warm_start_blocks)
    return max(1, min(n_pre, n_blocks))


def tau_warm_start(qn: Tensor, db_blocks: Tensor, valid_blocks: Tensor,
                   best: Tensor, k: int) -> Tensor:
    """Seed each query's running k-th best from its best-bound blocks
    ``best [m, n_pre]`` (:func:`~repro_torch.kernels.bound_prune.select_bounds`:
    the first ``n_pre`` of a stable descending sort of the bounds, so among
    equal bounds the lower block wins, as ``lax.top_k`` guarantees in the
    reference): gather them, exact-score them together and take the k-th
    best (a true lower bound on the final τ; DESIGN.md §3.4).  Queries whose
    prescanned blocks hold < k valid rows get -inf.
    """
    m, n_pre = best.shape
    _, bs, d = db_blocks.shape
    if n_pre * bs < k:
        return torch.full((m,), float("-inf"), device=qn.device)
    blk = db_blocks[best].reshape(m, n_pre * bs, d)
    vb = valid_blocks[best].reshape(m, n_pre * bs)
    scores = torch.bmm(blk, qn[:, :, None])[:, :, 0]
    scores = scores.masked_fill(~vb, float("-inf"))
    tau = kref.kth_value(scores, k)
    return torch.where(torch.isfinite(tau), tau, float("-inf"))


def bound_ranked_tau(index: BlockIndex, qn: Tensor, ub: Tensor, k: int,
                     n_pre: int) -> Tensor:
    """:func:`tau_warm_start` over each query's ``n_pre`` highest-bound
    index blocks of ``ub [m, nb]``, ranked by :func:`select_bounds` (among
    equal bounds the lower block wins, as ``lax.top_k`` does)."""
    nb, bs = index.n_blocks, index.block_size
    _, best = select_bounds(ub, bm=max(1, ub.shape[0]), n_pre=n_pre)
    return tau_warm_start(qn, index.db.reshape(nb, bs, -1),
                          index.valid.reshape(nb, bs), best, k)


def query_sort_perm(qp: Tensor) -> Tensor:
    """Permutation grouping queries by nearest pivot (desc sim within group),
    so a query tile is angularly coherent; the reference's ``jnp.lexsort``
    as two stable sorts, secondary key first."""
    near_sim, nearest = torch.max(qp, dim=1)
    p1 = torch.argsort(-near_sim, stable=True)
    return p1[torch.argsort(nearest[p1], stable=True)]


def best_first_order(tile_max: Tensor) -> Tensor:
    """Blocks by descending upper bound aggregated (max) over each query
    tile's rows: ``tile_max [..., nb] -> [..., nb]`` i32 visit order.  The
    block *any* query still needs comes first, which drives every τ up
    fastest."""
    return torch.argsort(-tile_max, dim=-1, stable=True).int()


# ---------------------------------------------------------------------------
# scan backend
# ---------------------------------------------------------------------------

def scan_search(index: BlockIndex, qn: Tensor, qp: Tensor, k: int, *,
                prune: bool = True, margin: float = 4e-7,
                warm_start: bool = False, best_first: bool = False,
                element_stats: bool = False,
                warm_start_blocks: int | None = None, n_pivots: int = 0,
                tau0: Tensor | None = None, ub_all: Tensor | None = None,
                leaf_mask: Tensor | None = None):
    """The scan backend's inner loop: one step per index block, in natural
    or best-first order, each a ``[m, d] x [d, bs]`` matmul whose rows the
    Eq. 13 bound proves unnecessary are masked to ``-inf`` (computed, then
    masked, as in the reference), merged into a running top-k.

    Returns ``(top_s [m, k], pos [m, k] padded-row positions, blk_pruned,
    elem_pruned)``, the counts as 0-dim int64 tensors on the device.
    ``blk_pruned`` counts the (query, block) pairs skipped, ``elem_pruned``
    (with ``element_stats``) the (query, valid row) pairs whose own Eq. 13
    bound + margin lay below τ at the visit.

    The bound matrix ``ub_all [m, nb]`` comes from the ``block_bounds``
    kernel (its plain version on CPU tensors), min'd with the joint
    multi-pivot cap when ``prune`` and ``n_pivots > 0``; it feeds the
    warm start, the best-first order and every step's prune test.  The
    running top-k starts at ``tau0 - 1e-6`` with position -1; each step
    keeps the k best of (running list, block scores) by a stable sort, so
    among equal scores the lower candidate wins and an entry already held
    beats a new one (``lax.top_k``'s rule).

    The hooks let the tree backend reuse this loop as its leaf stage:
    ``tau0 [m]`` replaces the warm start's seed (a true lower bound on
    each query's final k-th best, or -inf); ``ub_all [m, nb]`` is a bound
    matrix already computed (the descent's leaf level), so none is
    computed here; ``leaf_mask [m, nb]`` marks the blocks a caller has not
    proven prunable (False: skipped and counted in ``blk_pruned``; the
    proof is the caller's).
    """
    m = qn.shape[0]
    nb, bs = index.n_blocks, index.block_size
    db_blocks = index.db.reshape(nb, bs, -1)
    valid_blocks = index.valid.reshape(nb, bs)
    dp_blocks = index.dp.reshape(nb, bs, -1) if element_stats else None
    pos_blocks = torch.arange(nb * bs, dtype=torch.int32,
                              device=qn.device).reshape(nb, bs)
    cap = (multipivot_block_cap(index, qn, n_pivots=n_pivots)
           if prune and n_pivots > 0 else None)
    if ub_all is None and (prune or warm_start or best_first):
        ub_all = block_bounds(qp, index.dp_lo, index.dp_hi, cap)
    elif cap is not None:
        ub_all = torch.minimum(ub_all, cap)
    if tau0 is None:
        tau0 = qn.new_full((m,), float("-inf"))
        if warm_start:
            tau0 = bound_ranked_tau(
                index, qn, ub_all, k,
                prescan_blocks(k, bs, nb, warm_start_blocks))

    # per-block operands, block-major so each step reads contiguous rows
    ub_t = ub_all.T if prune else None
    mask_t = leaf_mask.T if leaf_mask is not None else None
    if best_first:
        order = best_first_order(ub_all.amax(0)).long()
        db_blocks, valid_blocks = db_blocks[order], valid_blocks[order]
        pos_blocks = pos_blocks[order]
        dp_blocks = dp_blocks[order] if element_stats else None
        ub_t = ub_t[order] if prune else None
        mask_t = mask_t[order] if mask_t is not None else None
    else:
        ub_t = ub_t.contiguous() if prune else None
        mask_t = mask_t.contiguous() if mask_t is not None else None

    if element_stats:
        a_lo, a_hi = (a[:, None, :] for a in kref.query_interval(qp))
    top_s = (tau0 - 1e-6)[:, None].expand(m, k).contiguous()
    top_i = torch.full((m, k), -1, dtype=torch.int32, device=qn.device)
    blk_pruned = torch.zeros((), dtype=torch.int64, device=qn.device)
    elem_pruned = torch.zeros((), dtype=torch.int64, device=qn.device)
    for j in range(nb):
        tau = top_s[:, -1]                                # running k-th best
        needed = (ub_t[j] + margin >= tau if prune else
                  torch.ones(m, dtype=torch.bool, device=qn.device))
        if mask_t is not None:
            needed = needed & mask_t[j]
        vb = valid_blocks[j]
        scores = (qn @ db_blocks[j].T).masked_fill(
            ~(needed[:, None] & vb[None, :]), float("-inf"))
        cand_s = torch.cat([top_s, scores], 1)
        cand_i = torch.cat([top_i, pos_blocks[j].expand(m, bs)], 1)
        cand_s, sel = torch.sort(cand_s, dim=1, descending=True, stable=True)
        top_s = cand_s[:, :k]
        top_i = cand_i.gather(1, sel[:, :k])
        blk_pruned += (~needed).sum()
        if element_stats:
            dpj = dp_blocks[j][None, :, :]
            eub = kref.box_bound(a_lo, a_hi, dpj, dpj).amin(-1)
            elem_pruned += ((eub + margin < tau[:, None]) & vb[None, :]).sum()
    return top_s, top_i, blk_pruned, elem_pruned


# ---------------------------------------------------------------------------
# kernel backend
# ---------------------------------------------------------------------------

def _resolve_bn(index: BlockIndex, bn: int | None) -> int:
    """Kernel tile size: a multiple of the index block size dividing n_pad."""
    n_pad = index.db.shape[0]
    ibs = index.block_size
    if bn is None:
        bn = ibs if ibs % 128 == 0 else ibs * max(1, -(-128 // ibs))
    while n_pad % bn or bn % ibs:
        bn //= 2
        if bn < ibs:
            bn = ibs
            break
    return bn


def kernel_inputs(index: BlockIndex, qn: Tensor, qp: Tensor, k: int, *,
                  bm: int = cosine_topk.DEFAULT_BM, bn: int | None = None,
                  prune: bool = True, sort_queries: bool = True,
                  warm_start: bool = False, best_first: bool = False,
                  margin: float = 4e-7, element_stats: bool = False,
                  warm_start_blocks: int | None = None, n_pivots: int = 0):
    """Everything :func:`kernel_search` hands ``pruned_topk``: returns
    ``(args, kwargs, perm)`` where ``perm`` is the query sort permutation,
    int32 (``None`` unless ``sort_queries``), which ``pruned_topk`` takes
    as ``row_out`` to write each result back to its query's row.  The warm start's best-bound tiles
    and the best-first order's per-query-tile maxima come from the
    ``block_bounds_select`` kernel on CUDA, which never writes the
    ``[m, nt]`` bound matrix; a prescan wider than ``SELECT_ROUTE_MAX_N_PRE``
    tiles (``warm_start_blocks`` > 8) takes that matrix from the
    ``block_bounds`` kernel and sorts it.  ``splits`` is the card's
    (:func:`cosine_topk.default_splits`) on CUDA and 1 on the CPU."""
    bn = _resolve_bn(index, bn)
    factor = bn // index.block_size
    lo, hi = coarsen_intervals(index.dp_lo, index.dp_hi, factor)
    m = qn.shape[0]
    perm = None
    if sort_queries:
        perm = query_sort_perm(qp).int()
        qn, qp = qn[perm], qp[perm]
    n_valid = int(index.valid.sum())

    ub_cap = None
    if prune and n_pivots > 0:
        cap = multipivot_block_cap(index, qn, n_pivots=n_pivots)  # [m, nb]
        ub_cap = cap.reshape(m, lo.shape[0], -1).amax(-1)         # [m, nt]
    tau_init = block_order = None
    if warm_start or best_first:
        nt = lo.shape[0]
        n_pre = prescan_blocks(k, bn, nt, warm_start_blocks)
        if n_pre <= SELECT_ROUTE_MAX_N_PRE:
            tile_max, best = block_bounds_select(qp, lo, hi, ub_cap, bm=bm,
                                                 n_pre=n_pre)
        else:
            tile_max, best = select_bounds(block_bounds(qp, lo, hi, ub_cap),
                                           bm=bm, n_pre=n_pre)
        if warm_start:
            tau_init = tau_warm_start(
                qn, index.db.reshape(nt, bn, -1), index.valid.reshape(nt, bn),
                best, k)
        if best_first:
            block_order = best_first_order(tile_max)
    args = (qn, index.db, qp, lo, hi, n_valid)
    kwargs = dict(tau_init=tau_init, block_order=block_order,
                  dp=index.dp if element_stats else None, ub_cap=ub_cap,
                  row_valid=index.valid, k=k, bm=bm, bn=bn, margin=margin,
                  prune=prune, element_stats=element_stats,
                  splits=cosine_topk.default_splits(
                      m, index.db.shape[0], qn.shape[1], qp.shape[1], bm=bm,
                      bn=bn, device=qn.device))
    return args, kwargs, perm


def kernel_search(index: BlockIndex, qn: Tensor, qp: Tensor, k: int, **kw):
    """The kernel backend's inner loop (keyword options of
    :func:`kernel_inputs`).

    Returns ``(sims [m,k], pos [m,k] padded-row positions, computed
    [m_tiles, n_tiles] by sorted query tile, elem_pruned or None)``;
    ``pruned_topk`` writes the results back in the caller's query order
    (``row_out=perm``), so nothing here undoes the query sort.
    """
    args, kwargs, perm = kernel_inputs(index, qn, qp, k, **kw)
    return cosine_topk.pruned_topk(*args, **kwargs, row_out=perm)


# ---------------------------------------------------------------------------
# brute backend
# ---------------------------------------------------------------------------

def brute_search(index: BlockIndex, qn: Tensor, k: int):
    """Full matmul + top-k over the padded database (positions, not ids);
    ``k`` past the padded rows pads with ``(-inf, -1)``."""
    scores = (qn @ index.db.T).masked_fill(~index.valid[None, :], float("-inf"))
    kk = min(k, scores.shape[-1])
    sims, pos = torch.topk(scores, kk, dim=1)
    pos = pos.int()
    if kk < k:
        sims = torch.cat([sims, sims.new_full((sims.shape[0], k - kk),
                                              float("-inf"))], 1)
        pos = torch.cat([pos, pos.new_full((pos.shape[0], k - kk), -1)], 1)
    return sims, pos


# ---------------------------------------------------------------------------
# the registered backends
# ---------------------------------------------------------------------------

@register_backend("scan")
class ScanBackend:
    """The block loop over the ``block_bounds`` kernel's bound matrix."""

    name = "scan"

    def run(self, eng, queries, k, *, prune=True, element_stats=False):
        qn, qp = prep_queries(eng.index, queries)
        s, pos, blk_pruned, elem_pruned = scan_search(
            eng.index, qn, qp, k, prune=prune, margin=eng.margin,
            warm_start=eng.warm_start, best_first=eng.best_first,
            element_stats=element_stats,
            warm_start_blocks=eng.warm_start_blocks, n_pivots=eng.n_pivots)
        ids = map_row_ids(eng.index.row_ids, pos)
        m, nb = qn.shape[0], eng.index.n_blocks
        raw = {"block_prune_frac": blk_pruned / (m * nb)}
        if element_stats:
            raw["elem_prune_frac"] = elem_pruned / (m * max(1, eng.n_valid))
        return s, ids, raw


@register_backend("kernel")
class KernelBackend:
    """The hand-written kernels (their plain versions on CPU tensors)."""

    name = "kernel"

    def run(self, eng, queries, k, *, prune=True, element_stats=False):
        qn, qp = prep_queries(eng.index, queries)
        s, pos, computed, elem = kernel_search(
            eng.index, qn, qp, k, bm=eng.bm, bn=eng.bn, prune=prune,
            sort_queries=eng.sort_queries, warm_start=eng.warm_start,
            best_first=eng.best_first, margin=eng.margin,
            element_stats=element_stats,
            warm_start_blocks=eng.warm_start_blocks, n_pivots=eng.n_pivots)
        ids = map_row_ids(eng.index.row_ids, pos)
        frac = computed.float().mean()
        raw = {"block_prune_frac": 1.0 - frac, "tile_computed_frac": frac}
        if element_stats:
            raw["elem_prune_frac"] = (
                elem.float().sum() / (qn.shape[0] * max(1, eng.n_valid)))
        return s, ids, raw


@register_backend("brute")
class BruteBackend:
    """Exact baseline: one big matmul, no pruning."""

    name = "brute"

    def run(self, eng, queries, k, *, prune=True, element_stats=False):
        qn, _ = prep_queries(eng.index, queries)
        s, pos = brute_search(eng.index, qn, k)
        ids = map_row_ids(eng.index.row_ids, pos)
        raw = {"block_prune_frac": 0.0}
        if element_stats:
            raw["elem_prune_frac"] = 0.0
        return s, ids, raw


@register_backend("sharded")
class ShardedBackend:
    """Per-shard search plus the all-gather top-k merge, over the engine's
    shard-stacked index and mesh (``mesh=None``: every shard in this
    process).  Every rank of the mesh passes the same queries, as in the
    reference's contract; they are not gathered.  On CUDA each shard runs
    the hand-written kernels (no fallback), on the CPU the scan loop, and
    the stats are summed over every shard (``tile_computed_frac`` where the
    kernel ran on CUDA).

    With the engine's shard trees on (``SearchEngine(tree_shards=...)``)
    and pruning on, each shard first descends its own pivot tree against
    the global τ (:func:`repro_torch.core.distributed.sharded_search_local`'s
    tree branch); its leaves go to the kernel leaf stage on CUDA (the scan
    past ``k > block_size``) and the scan on the CPU, and the stats add
    ``tree_prune_frac``, ``tree_node_eval_frac`` and ``tree_levels``.  The
    trees are built lazily on the index's device and cached on the engine
    (``eng._shard_tree``); with pruning off the shards are searched flat,
    as in the reference."""

    name = "sharded"

    @staticmethod
    def _shard_tree(eng):
        if eng._shard_tree is None:
            from repro_torch.search.tree import build_shard_trees
            eng._shard_tree = build_shard_trees(eng.index)
        return eng._shard_tree

    def run(self, eng, queries, k, *, prune=True, element_stats=False):
        from repro_torch.core.distributed import make_sharded_search, runs_kernel

        fn = make_sharded_search(
            eng.mesh, eng.axis_names, with_stats=True, prune=prune,
            warm_start=eng.warm_start, best_first=eng.best_first,
            warm_start_blocks=eng.warm_start_blocks, element_stats=element_stats,
            margin=eng.margin, n_pivots=eng.n_pivots, bm=eng.bm, bn=eng.bn,
            sort_queries=eng.sort_queries)
        tree = self._shard_tree(eng) if eng._tree_shards_enabled and prune else None
        if tree is not None:
            s, ids, frac, efrac, tfrac, evfrac = fn(eng.index, queries, k, tree=tree)
            raw = {"block_prune_frac": frac, "tree_prune_frac": tfrac,
                   "tree_node_eval_frac": evfrac, "tree_levels": tree.n_levels}
        else:
            s, ids, frac, efrac = fn(eng.index, queries, k)
            raw = {"block_prune_frac": frac}
        if runs_kernel(eng.index, k, tree):
            raw["tile_computed_frac"] = 1.0 - frac
        if element_stats:
            raw["elem_prune_frac"] = efrac
        return s, ids, raw
