"""SearchEngine: one front door for exact cosine search on the GPU.

Counterpart of :mod:`repro.search.engine`::

    eng = SearchEngine.build(db, n_pivots=16, block_size=128)   # on CUDA
    sims, ids, stats = eng.search(queries, k=10)

τ warm-start and best-first tile ordering are engine policy (on by
default); they change how fast τ rises, never the result set, which stays
the brute-force one.  Ported backends: ``kernel``, ``scan``, ``tree`` (with
its scan and kernel leaf stages), ``brute`` and ``sharded``
(``SearchEngine.build(db, mesh=...)``: the rows split into shards over a
``torch.distributed`` device mesh, :mod:`repro_torch.core.distributed`,
searched flat or through per-shard pivot trees, ``tree_shards``);
``engine.online()`` hands out the
:class:`~repro_torch.core.online.MutableIndex` (or, on a sharded engine,
the :class:`~repro_torch.core.online.ShardedMutableIndex`) that inserts,
deletes and rebuilds under a live engine.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core.index import BlockIndex, build_index
from repro_torch.device import resolve_device
from repro_torch.search import backends as _bk
from repro_torch.search.defaults import FALLBACK_DEFAULTS
from repro_torch.search.stats import SearchStats

__all__ = ["SearchEngine", "auto_backend"]

#: below this many padded rows the matmul is cheaper than any bookkeeping
_BRUTE_MAX_ROWS = 256
#: feature widths the reference's kernel backend is chosen for
_KERNEL_MAX_DIM = 4096
#: blocks from which the reference prefers the tree to the scan off the TPU,
#: and turns the shard trees on (per shard)
_TREE_MIN_BLOCKS = 256
_LEAF_EVALS = ("scan", "kernel", "auto")


def auto_backend(index: BlockIndex, mesh=None) -> str:
    """``sharded`` for a shard-stacked index or when a mesh is given;
    ``brute`` for tiny datastores (≤ 256 padded rows).  Past that, on a
    CUDA index ``kernel`` when ``d ≤ 4096``, else ``brute``; on a CPU index
    the reference's rule off the TPU: ``tree`` from 256 blocks, else
    ``scan``.

    The scan and tree follow the reference again since their bound is
    sound near ±1 (``core/index.py:interval_upper_bound``)."""
    if index.db.ndim == 3 or mesh is not None:
        return "sharded"
    n_pad, d = index.db.shape
    if n_pad <= _BRUTE_MAX_ROWS:
        return "brute"
    if index.device.type == "cuda":
        return "kernel" if d <= _KERNEL_MAX_DIM else "brute"
    return "tree" if index.n_blocks >= _TREE_MIN_BLOCKS else "scan"


class SearchEngine:
    """Backend-dispatched exact top-k cosine search over a :class:`BlockIndex`.

    Args (the reference's knobs and defaults):
      index: the block index; moved to ``device`` if it lies elsewhere.
      backend: ``"kernel"``, ``"scan"``, ``"tree"``, ``"brute"``,
        ``"sharded"`` or ``"auto"`` (default, :func:`auto_backend`).
      mesh / axis_names: the ``torch.distributed`` ``DeviceMesh`` a
        shard-stacked index (this rank's shards, ``[L, ...]``) is spread
        over, and the dims it shards along (default all); ``mesh=None``
        with a stacked index searches every shard in this process.
      tree_shards: ``sharded`` backend only: run the transitive Eq. 13
        descent over a pivot tree per shard (built lazily, over each
        shard's own pivots) before each shard's leaf stage, against one
        global τ per query (:mod:`repro_torch.core.distributed`).  ``True``
        / ``False`` force it; ``None`` (default) turns it on from 256
        blocks a shard, the reference's rule.  Ignored by the other
        backends.
      warm_start: seed each query's τ by exact-scoring its best-bound tiles.
      warm_start_blocks: widen that prescan (``None``: the ``ceil(k / bn)``
        floor).
      best_first: visit db tiles in descending bound order per query tile
        (``None``: the fallback default, ``True``).
      element_stats: default for ``search(..., element_stats=...)``.
      n_pivots: joint multi-pivot bound depth (``None``: fallback 0),
        clamped to the index's table width.
      margin: fp32 guard added to bounds before comparing with τ.
      leaf_eval: the tree backend's leaf stage: ``"scan"`` (the scan loop
        over the surviving leaves), ``"kernel"`` (the union of the batch's
        surviving leaves compacted and searched by ``pruned_topk``; with
        pruning on and ``k <= block_size``, else the scan serves the call,
        as in the reference) or ``"auto"`` (default; the fallback table,
        then kernel on a CUDA index with ``d <= 4096``, else scan).
        Ignored by the other backends.
      bm / bn / sort_queries: kernel tile options (``bm`` and
        ``sort_queries`` also apply to the tree's kernel leaf stage).
      device: ``None`` means CUDA and raises without a GPU; pass ``"cpu"``
        for the plain PyTorch versions of the kernels.
    """

    def __init__(
        self,
        index: BlockIndex,
        *,
        backend: str = "auto",
        mesh=None,
        axis_names=None,
        warm_start: bool = True,
        warm_start_blocks: int | None = None,
        best_first: bool | None = None,
        element_stats: bool = False,
        tree_shards: bool | None = None,
        n_pivots: int | None = None,
        margin: float = 4e-7,
        leaf_eval: str = "auto",
        bm: int = 128,
        bn: int | None = None,
        sort_queries: bool = True,
        device=None,
    ):
        self.device = resolve_device(device)
        if index.db.device != self.device:
            index = index.to(self.device)
        self.index = index
        self.mesh = mesh
        self.axis_names = axis_names
        self.backend_name = (auto_backend(index, mesh) if backend == "auto"
                             else backend)
        # the reference's two guards: a flat index cannot serve the sharded
        # backend, and a stacked one is served by it alone
        if self.backend_name == "sharded" and index.db.ndim != 3:
            raise ValueError(
                "the 'sharded' backend needs a shard-stacked BlockIndex "
                "(leading [S, ...] shard axis); this index is flat 2D. Build "
                "one with SearchEngine.build(db, mesh=...) or repro_torch.core."
                "distributed.build_sharded_index(...), or drop mesh= / pass "
                "backend='scan' to search the flat index.")
        if index.db.ndim == 3 and self.backend_name != "sharded":
            raise ValueError(
                f"a shard-stacked BlockIndex is served by the 'sharded' backend "
                f"only (got backend={self.backend_name!r}); pass mesh= (and "
                f"backend='auto') to search it.")
        self.tree_shards = tree_shards
        #: per-shard blocks, as the auto rule reads them
        self.n_blocks = int(index.dp_min.shape[-2])
        self._tree_shards_enabled = index.db.ndim == 3 and (
            self.n_blocks >= _TREE_MIN_BLOCKS if tree_shards is None else bool(tree_shards))
        self.backend = _bk.get_backend(self.backend_name)
        self.warm_start = warm_start
        self.warm_start_blocks = (warm_start_blocks if warm_start_blocks is not None
                                  else FALLBACK_DEFAULTS["warm_start_blocks"])
        self.best_first = (bool(best_first) if best_first is not None
                           else FALLBACK_DEFAULTS["best_first"])
        self.element_stats = element_stats
        if n_pivots is None:
            n_pivots = FALLBACK_DEFAULTS["n_pivots"]
        self.n_pivots = max(0, min(int(n_pivots), index.bound_table_width))
        self.margin = margin
        if leaf_eval not in _LEAF_EVALS:
            raise ValueError(f"leaf_eval={leaf_eval!r}; one of {_LEAF_EVALS}")
        if leaf_eval == "auto":
            leaf_eval = FALLBACK_DEFAULTS["leaf_eval"] or "auto"
        self.leaf_eval = leaf_eval
        self._tree_index = None             # built by the tree backend
        self._tree_valid_nodes = 0          # its node count, read once
        self._shard_tree = None             # built by the sharded backend
        #: bumped on every shape-changing online mutation (appended blocks,
        #: reoptimize), as in the reference
        self.index_epoch = 0
        self._online = None                 # the online handle, if any
        self.bm = bm
        self.bn = bn
        self.sort_queries = sort_queries
        n_valid = index.valid.sum()
        #: shards of every rank of the mesh's group (1: a flat index)
        self._n_shards = 1
        if index.db.ndim == 3:
            from repro_torch.core.distributed import shard_group
            group = shard_group(mesh, axis_names)
            self._n_shards = index.db.shape[0] * (1 if group is None
                                                  else dist.get_world_size(group))
            if group is not None:
                dist.all_reduce(n_valid, group=group)
        self.n_valid = int(n_valid)
        #: padded row slots across all shards: the most candidates a search
        #: can return
        self.n_slots = int(index.db.shape[-2]) * self._n_shards

    @classmethod
    def build(
        cls,
        db,
        *,
        n_pivots: int = 16,
        block_size: int = 128,
        pivot_method: str = "maxmin",
        reorder: bool = True,
        seed: int = 0,
        n_shards: int | None = None,
        mesh=None,
        distributed: bool = False,
        global_rows: int | None = None,
        bound_pivots: int | None = None,
        device=None,
        **engine_kw: Any,
    ) -> "SearchEngine":
        """Build the index on ``device`` and wrap it in an engine.

        ``n_pivots`` is the index pivot count; ``bound_pivots`` the engine's
        search-time joint-bound depth (``n_pivots`` knob).

        Pass ``mesh`` (and optionally ``n_shards``, default one shard per
        rank of the mesh's flattened ``axis_names``) to build a sharded
        datastore served by the ``sharded`` backend.  Each rank builds only
        its own shards, from its rows of ``db``, on its device; the mesh's
        device type must be ``device``'s.  ``distributed=True`` (needs
        ``mesh``) makes ``db`` only this rank's slice of the datastore (the
        rows its shards cover, :func:`~repro_torch.core.distributed.
        local_shard_rows`) and ``global_rows`` the total row count across
        all ranks (defaults to ``len(db)`` only with one process).  Either
        way each rank's index equals its slice of ``build_sharded_index(
        full_db, n_shards)`` (``reorder`` and ``seed`` apply to flat builds
        only, as in the reference).
        """
        if bound_pivots is not None:
            engine_kw["n_pivots"] = bound_pivots
        if distributed and mesh is None:
            raise ValueError("SearchEngine.build(distributed=True) needs mesh= (the "
                             "mesh the datastore shards across)")
        if mesh is None:
            idx = build_index(db, n_pivots=n_pivots, block_size=block_size,
                              pivot_method=pivot_method, reorder=reorder,
                              seed=seed, device=device)
            return cls(idx, device=device, **engine_kw)
        from repro_torch.core.distributed import (build_sharded_index_local,
                                                  local_shard_rows)
        dev = resolve_device(device)
        if mesh.device_type != dev.type:
            raise ValueError(f"the mesh is on {mesh.device_type!r} but the engine's "
                             f"device is {str(dev)!r}")
        axis_names = engine_kw.get("axis_names")
        if distributed:
            if global_rows is None:
                if dist.is_initialized() and dist.get_world_size() > 1:
                    raise ValueError(
                        "SearchEngine.build(distributed=True) with several "
                        "processes needs global_rows= (db holds only this rank's "
                        "slice)")
                global_rows = len(db)
        else:
            global_rows = len(db)
            _, owned = local_shard_rows(global_rows, mesh, axis_names, n_shards=n_shards)
            db = db[owned[0][1]:owned[-1][2]]
        idx = build_sharded_index_local(
            db, mesh, global_rows=global_rows, axis_names=axis_names,
            n_shards=n_shards, n_pivots=n_pivots, block_size=block_size,
            pivot_method=pivot_method)
        return cls(idx, mesh=mesh, device=device, **engine_kw)

    def online(self, **kw):
        """The engine's online handle (created on first use; one per
        engine): a :class:`~repro_torch.core.online.MutableIndex`, or on a
        shard-stacked index a :class:`~repro_torch.core.online.
        ShardedMutableIndex` (made on every rank of the mesh alike: it
        all-gathers ``row_ids``).  Insert, delete and reoptimize through it;
        the engine's index and trees stay consistent.  Keyword args
        (``reoptimize_threshold``, ``auto_reoptimize``) are taken on the
        first call only.  The handle installs its own copy of the index,
        which it then writes in place, so an index this engine shares with
        others is never changed under them."""
        if self._online is None:
            from repro_torch.core.online import MutableIndex, ShardedMutableIndex
            cls = ShardedMutableIndex if self.index.db.ndim == 3 else MutableIndex
            self._online = cls(self, **kw)
        elif kw:
            raise ValueError("engine.online() already created its MutableIndex; "
                             "per-handle options can only be set on the first call")
        return self._online

    def _apply_mutation(self, new_index: BlockIndex, *, n_valid: int,
                        shape_changed: bool, tree=None, shard_tree=None) -> None:
        """Install a mutated index (called by the online handles only).

        A shape change (appended blocks, reoptimize) bumps ``index_epoch``,
        drops the tree and the shard trees (the next search rebuilds them)
        and recomputes ``n_blocks`` and ``n_slots``.  Otherwise ``tree`` /
        ``shard_tree`` is the widened tree / shard trees of a shape-stable
        insert; after a delete under a live tree, the tree keeps its (wide)
        node tables and serves the new index, and the shard trees, which
        hold no index, serve on as they are.
        """
        self.index = new_index
        self.n_valid = int(n_valid)
        if shape_changed:
            self.index_epoch += 1
            self._tree_index = None
            self._tree_valid_nodes = 0
            self._shard_tree = None
            self.n_blocks = int(new_index.dp_min.shape[-2])
            self.n_slots = int(new_index.db.shape[-2]) * self._n_shards
            return
        if shard_tree is not None:
            self._shard_tree = shard_tree
        if tree is not None:
            self._tree_index = tree
            self._tree_valid_nodes = tree.n_valid_nodes
        elif self._tree_index is not None:
            self._tree_index = self._tree_index._replace(index=new_index)

    def search(self, queries, k: int, *, prune: bool = True,
               element_stats: bool | None = None):
        """Exact top-k: ``(sims [m,k] f32, ids [m,k] i32, SearchStats)``.

        ``ids`` are original row ids; ``k`` past the valid rows pads with
        ``(-inf, -1)``.  The result set equals brute force for every backend
        and policy setting.
        """
        if element_stats is None:
            element_stats = self.element_stats
        queries = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        kk = min(k, self.n_slots)
        sims, ids, raw = self.backend.run(
            self, queries, kk, prune=prune, element_stats=element_stats)
        if kk < k:
            m = sims.shape[0]
            sims = torch.cat([sims, sims.new_full((m, k - kk), float("-inf"))], 1)
            ids = torch.cat([ids, ids.new_full((m, k - kk), -1)], 1)
        stats = SearchStats(
            backend=self.backend_name,
            n_queries=int(queries.shape[0]),
            k=k,
            n_blocks=self.n_blocks,
            block_prune_frac=raw.get("block_prune_frac", 0.0),
            tile_computed_frac=raw.get("tile_computed_frac"),
            elem_prune_frac=raw.get("elem_prune_frac"),
            tree_prune_frac=raw.get("tree_prune_frac"),
            tree_node_eval_frac=raw.get("tree_node_eval_frac"),
            warm_start=self.warm_start,
            best_first=self.best_first,
            n_pivots=None if self.backend_name == "brute" else self.n_pivots,
            generation=None if self._online is None else self._online.generation,
            decay_estimate=(None if self._online is None
                            else self._online.decay_estimate),
            extras={key: v for key, v in raw.items()
                    if key not in ("block_prune_frac", "tile_computed_frac",
                                   "elem_prune_frac", "tree_prune_frac",
                                   "tree_node_eval_frac")},
        )
        return sims, ids, stats
