"""Online mutation for a live :class:`~repro_torch.search.SearchEngine`.

Counterpart of :mod:`repro.core.online`: :class:`MutableIndex` over a
flat index, and :class:`ShardedMutableIndex` over a shard-stacked one.
Every structure the search paths read stays valid under **conservative
widening** (DESIGN.md §3.9):

* inserts write rows into free padded slots (block tails, or freshly
  appended all-padding blocks) and only *loosen* the per-block pivot
  intervals and the tree's node tables, so every Eq. 13 bound stays an
  upper bound and search stays exact;
* deletes are tombstones: ``valid`` flips off and every interval stays as
  wide as it was; every backend masks scores by per-row validity before
  top-k, so a tombstoned row is never returned.

**Sound widening.**  The reference widens ``dp_min/dp_max`` with the
float32 ``rows @ pivots.T``.  The port does that too (its ``dp``,
``dp_min`` and ``dp_max`` follow the reference), but every bound of the
port reads ``dp_lo/dp_hi``, which hold each valid row's float64 pivot
cosine rounded outward (``core/index.py:interval_upper_bound`` has the
argument).  So an insert widens ``dp_lo/dp_hi`` and the tree's node tables
with each new row's :func:`~repro_torch.core.index.row_intervals` joined
with its float32 ``dp``: a row that only widened ``dp_min/dp_max`` could
lie outside the interval its block is bounded by, which near a pivot
similarity of ±1 costs more than the bound's margin.

**The handle owns its tensors.**  :class:`MutableIndex` clones the
engine's index once, when it is made, installs the clone, and from then on
writes it in place (``index_put_``, ``scatter_reduce_``), where the
reference's ``.at[].set`` returns new arrays; only a shape change
(appended blocks, :meth:`MutableIndex.reoptimize`) installs new tensors.
So an index that other engines or callers share (``SearchEngine(index)``
keeps the caller's tensors) never changes under them.

External row ids are stable across the handle's lifetime: the ids
:meth:`MutableIndex.insert` returns (and the original ``0..n-1`` corpus
ids) survive :meth:`MutableIndex.reoptimize`, so id-aligned side tables
(the kNN-LM value table, :mod:`repro_torch.serve.knnlm`) never need
remapping.

**Sharded** (the reference's DESIGN.md §3.10): every rank mirrors the same
host state, the id -> (shard, slot) map and each shard's free slots, from
one all-gather of ``row_ids``; a new row's shard and slot are a pure
function of that state (:meth:`ShardedMutableIndex.insert`), so every rank
places alike with no further collective, and each writes only its own
shards (:class:`~repro_torch.core.distributed.ShardedMutationOps`), with
the flat handle's sound widening per shard.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.index import BlockIndex, build_index, row_intervals

__all__ = ["MutableIndex", "ShardedMutableIndex", "append_blocks", "write_rows"]


def append_blocks(index: BlockIndex, n_add: int) -> BlockIndex:
    """Grow the index by ``n_add`` all-padding blocks (``valid`` False,
    ``row_ids`` -1): a shape change; no live row moves.  A shard-stacked
    index grows every shard by ``n_add`` blocks.

    New blocks carry the empty-interval sentinel (``+inf`` low end, ``-inf``
    high end) in ``dp_min/dp_max`` and in ``dp_lo/dp_hi``: every bound maps
    an inverted interval to ``-inf``, and the insert's scatter-min/max then
    records the first rows' exact interval (an anchor at 0 would keep the
    block loose until a rebuild).
    """
    axis = index.db.ndim - 2                    # the row / block axis
    nr = n_add * (index.db.shape[axis] // index.dp_min.shape[axis])

    def grow(t, n, fill):
        shape = list(t.shape)
        shape[axis] = n
        return torch.cat([t, t.new_full(shape, fill)], axis)

    new = index._replace(
        db=grow(index.db, nr, 0.0), dp=grow(index.dp, nr, 0.0),
        valid=grow(index.valid, nr, False), row_ids=grow(index.row_ids, nr, -1),
        dp_min=grow(index.dp_min, n_add, float("inf")),
        dp_max=grow(index.dp_max, n_add, float("-inf")),
        dp_lo=grow(index.dp_lo, n_add, float("inf")),
        dp_hi=grow(index.dp_hi, n_add, float("-inf")))
    if index.beta is not None:
        new = new._replace(beta=grow(index.beta, nr, 0.0),
                           beta_nsq=grow(index.beta_nsq, nr, 0.0))
    return new


def _scatter_blocks(table, blocks, rows, reduce):
    """``table[blocks[i]] = reduce(table[blocks[i]], rows[i])`` in place,
    for every ``i`` (several rows of one block reduce together)."""
    table.scatter_reduce_(0, blocks[:, None].expand_as(rows), rows, reduce,
                          include_self=True)


def write_rows(index: BlockIndex, pos, rows64: np.ndarray, ids: list[int]):
    """Write unit rows into free slots of a flat index, in place (a shard's
    views write into the stacked tensors).

    ``pos`` are the slots, ``rows64 [r, d]`` the rows normalized in float64,
    ``ids`` their external ids.  The rows' blocks widen ``dp_min/dp_max``
    with their float32 ``dp`` and ``dp_lo/dp_hi`` with their sound
    intervals (module docstring); the joint-bound tables get their rows.
    Returns ``(blocks [r], lo, hi [r, P])``, the rows' blocks and sound
    intervals, which also widen a live tree.
    """
    dev = index.device
    pos_t = torch.as_tensor(np.asarray(pos), dtype=torch.int64).to(dev)
    blk_t = pos_t // index.block_size
    rows_f = torch.from_numpy(rows64.astype(np.float32)).to(dev)
    # the reference's float32 product (dp, dp_min, dp_max), and beside it
    # the sound interval every bound of the port reads
    dp_new = rows_f @ index.pivots.T                          # [r, P]
    lo, hi = row_intervals(rows_f, index.pivots)
    lo, hi = torch.minimum(lo, dp_new), torch.maximum(hi, dp_new)
    index.db[pos_t] = rows_f
    index.dp[pos_t] = dp_new
    index.valid[pos_t] = True
    index.row_ids[pos_t] = torch.tensor(ids, dtype=torch.int32, device=dev)
    _scatter_blocks(index.dp_min, blk_t, dp_new, "amin")
    _scatter_blocks(index.dp_max, blk_t, dp_new, "amax")
    _scatter_blocks(index.dp_lo, blk_t, lo, "amin")
    _scatter_blocks(index.dp_hi, blk_t, hi, "amax")
    if index.ortho is not None:
        # the stored basis is float32; its upcast differs from the build's
        # float64 basis by ~1e-7, which JOINT_SLACK absorbs
        beta64 = rows64 @ index.ortho.double().cpu().numpy().T
        index.beta[pos_t] = torch.from_numpy(beta64).float().to(dev)
        index.beta_nsq[pos_t] = torch.from_numpy(
            np.cumsum(beta64 * beta64, axis=1)).float().to(dev)
    return blk_t, lo, hi


def _unit_rows(rows, d: int) -> np.ndarray:
    """``rows`` (``[n, d]`` or ``[d]``, numpy or tensor) as float64 unit
    rows ``[n, d]``, normalized on the host as in the reference (a zero row
    stays zero)."""
    if isinstance(rows, torch.Tensor):
        rows = rows.detach().cpu().numpy()
    rows64 = np.asarray(rows, np.float64)
    if rows64.ndim == 1:
        rows64 = rows64[None, :]
    if rows64.shape[0] and rows64.shape[1] != d:
        raise ValueError(f"inserted rows have dim {rows64.shape[1]}, index has dim {d}")
    norms = np.linalg.norm(rows64, axis=1, keepdims=True)
    return rows64 / np.where(norms == 0.0, 1.0, norms)


def _checked_ids(ids, live) -> list[int]:
    """``ids`` (one or many) as a list, after checking every one is in
    ``live`` and none repeats; raises ``KeyError`` before any change."""
    if isinstance(ids, (int, np.integer)):
        ids = [ids]
    ids = [int(i) for i in ids]
    bad = [i for i in ids if i not in live]
    if bad:
        raise KeyError(f"row ids {bad} are not in the live set (never "
                       f"inserted, or already deleted)")
    if len(set(ids)) != len(ids):
        raise KeyError(f"duplicate row ids in delete: {ids}")
    return ids


class MutableIndex:
    """Insert/delete/reoptimize handle over a ``SearchEngine``'s index.

    Obtain one through :meth:`SearchEngine.online`; do not construct two
    handles over one engine: the handle owns host mirrors (the free-slot
    list and the external-id → slot map), built from one ``.cpu()`` of
    ``row_ids``, that must stay in step with the device tensors, and the
    copy of the engine's index that it writes in place (module docstring).

    Args:
      engine: the engine to mutate.
      reoptimize_threshold: rebuild once ``decay_estimate`` (mutated rows
        over the corpus size at the last build) reaches this value.
      auto_reoptimize: if False, never rebuild implicitly: the caller
        watches ``decay_estimate`` and calls :meth:`reoptimize`.
    """

    #: the index layout the handle serves: flat (``db`` is 2-D)
    _stacked = False

    def __init__(self, engine, *, reoptimize_threshold: float = 0.5,
                 auto_reoptimize: bool = True):
        if (engine.index.db.ndim == 3) != self._stacked:
            raise TypeError(
                "MutableIndex serves flat engines and ShardedMutableIndex "
                "shard-stacked ones; engine.online() picks the right handle")
        self.engine = engine
        self.reoptimize_threshold = float(reoptimize_threshold)
        self.auto_reoptimize = bool(auto_reoptimize)
        #: mutation calls applied through this handle (also
        #: ``SearchStats.generation``)
        self.generation = 0
        self._mutations_since_opt = 0
        own = BlockIndex(*(None if t is None else t.clone() for t in engine.index))
        engine._apply_mutation(own, n_valid=engine.n_valid, shape_changed=False)
        self._mirror(self._host_row_ids(own))
        self._next_id = max(self._id_pos, default=-1) + 1
        self._rows_at_opt = max(1, len(self._id_pos))

    def _host_row_ids(self, index: BlockIndex) -> np.ndarray:
        return index.row_ids.cpu().numpy()

    def _mirror(self, row_ids: np.ndarray) -> None:
        """The host mirrors from ``row_ids``: id → slot of every live row,
        and the free slots, descending so ``list.pop()`` hands out the
        lowest first (inserts stay packed toward block fronts)."""
        live = np.flatnonzero(row_ids >= 0)
        self._id_pos = dict(zip(row_ids[live].tolist(), live.tolist()))
        self._free = np.flatnonzero(row_ids < 0)[::-1].tolist()

    @property
    def n_live(self) -> int:
        """Number of live (searchable) rows."""
        return len(self._id_pos)

    @property
    def decay_estimate(self) -> float:
        """Mutated rows since the last (re)build over the corpus size at
        that build: the proxy for the pruning the widened intervals lost."""
        return self._mutations_since_opt / self._rows_at_opt

    def __contains__(self, row_id: int) -> bool:
        return int(row_id) in self._id_pos

    def insert(self, rows) -> list[int]:
        """Insert ``rows`` (``[n, d]`` or ``[d]``, numpy or tensor); returns
        their external ids.

        Rows are normalized in float64 on the host, as in the reference, so
        the stored float32 rows equal the reference's bit for bit.  Free
        padded slots are filled first, lowest first; when they run out,
        all-padding blocks are appended (a shape change).  The rows are
        written by :func:`write_rows`; a live tree (shape-stable inserts
        only) is widened along the rows' root-to-leaf paths.
        """
        eng = self.engine
        index = eng.index
        rows64 = _unit_rows(rows, index.db.shape[1])
        n_new = rows64.shape[0]
        if n_new == 0:
            return []
        bs = index.block_size
        shape_changed = len(self._free) < n_new
        if shape_changed:
            n_add = -(-(n_new - len(self._free)) // bs)
            old_slots = index.db.shape[0]
            index = append_blocks(index, n_add)
            self._free = (list(range(old_slots + n_add * bs - 1, old_slots - 1, -1))
                          + self._free)
        pos = [self._free.pop() for _ in range(n_new)]
        ids = list(range(self._next_id, self._next_id + n_new))
        blk_t, lo, hi = write_rows(index, pos, rows64, ids)

        tree = None
        if not shape_changed and eng._tree_index is not None:
            from repro_torch.search.tree import widen_tree
            tree = widen_tree(eng._tree_index, index, blk_t, lo, hi)

        self._id_pos.update(zip(ids, pos))
        self._next_id += n_new
        self.generation += 1
        self._mutations_since_opt += n_new
        eng._apply_mutation(index, n_valid=len(self._id_pos),
                            shape_changed=shape_changed, tree=tree)
        self._maybe_reoptimize()
        return ids

    def delete(self, ids) -> None:
        """Tombstone-delete rows by external id: ``valid`` flips off and
        ``row_ids`` goes -1; every interval stays as wide as it was.
        Raises ``KeyError`` (before any state changes) if an id is not
        live or appears twice."""
        ids = _checked_ids(ids, self._id_pos)
        if not ids:
            return
        pos = [self._id_pos.pop(i) for i in ids]
        index = self.engine.index
        pos_t = torch.tensor(pos, dtype=torch.int64, device=index.device)
        index.valid[pos_t] = False
        index.row_ids[pos_t] = -1
        self._free = sorted(self._free + pos, reverse=True)
        self.generation += 1
        self._mutations_since_opt += len(pos)
        self.engine._apply_mutation(index, n_valid=len(self._id_pos),
                                    shape_changed=False)
        self._maybe_reoptimize()

    def reoptimize(self) -> None:
        """Full rebuild on the index's device: repack the live rows,
        reselect pivots, tighten every interval.  External ids are kept
        (mapped through the new build's permutation).  A shape change."""
        eng = self.engine
        index = eng.index
        row_ids = index.row_ids.cpu().numpy()
        live = np.flatnonzero(row_ids >= 0)
        self._rows_at_opt = max(1, live.size)
        self._mutations_since_opt = 0
        self.generation += 1
        if live.size == 0:
            # no live rows: a clean all-padding index (empty-interval
            # sentinels, pivots kept), installed like every other rebuild
            # so the stale tree drops and index_epoch bumps
            inf = float("inf")
            new = index._replace(
                db=torch.zeros_like(index.db), dp=torch.zeros_like(index.dp),
                valid=torch.zeros_like(index.valid),
                row_ids=torch.full_like(index.row_ids, -1),
                dp_min=torch.full_like(index.dp_min, inf),
                dp_max=torch.full_like(index.dp_max, -inf),
                dp_lo=torch.full_like(index.dp_lo, inf),
                dp_hi=torch.full_like(index.dp_hi, -inf))
            if index.beta is not None:
                new = new._replace(beta=torch.zeros_like(index.beta),
                                   beta_nsq=torch.zeros_like(index.beta_nsq))
            self._mirror(np.full(row_ids.shape, -1, row_ids.dtype))
            eng._apply_mutation(new, n_valid=0, shape_changed=True)
            return
        ext_ids = row_ids[live].astype(np.int32)
        live_t = torch.from_numpy(live).to(index.device)
        new = build_index(index.db[live_t], n_pivots=index.n_pivots,
                          block_size=index.block_size, device=index.device)
        # the fresh build numbers rows 0..n_live-1; map back to external ids
        nr = new.row_ids.cpu().numpy()
        mapped = np.where(nr >= 0, ext_ids[np.clip(nr, 0, live.size - 1)],
                          -1).astype(np.int32)
        new = new._replace(row_ids=torch.from_numpy(mapped).to(index.device))
        self._mirror(mapped)
        eng._apply_mutation(new, n_valid=live.size, shape_changed=True)

    def _maybe_reoptimize(self) -> None:
        if self.auto_reoptimize and self.decay_estimate >= self.reoptimize_threshold:
            self.reoptimize()


class ShardedMutableIndex(MutableIndex):
    """Insert/delete/reoptimize handle over a sharded ``SearchEngine``
    (counterpart of the reference's ``ShardedMutableIndex``): the same
    public surface and widening as :class:`MutableIndex`, plus the
    reference's placement protocol (DESIGN.md §3.10).

    * Every rank mirrors the same host state: the id -> (shard, slot) map
      and each shard's free slots, descending, made from one all-gather of
      ``row_ids`` (:func:`~repro_torch.core.distributed.replicated_row_ids`)
      when the handle is made and after each :meth:`reoptimize`.  The
      external-id counter is monotone over it.
    * A new row's place is a pure function of that state, one row at a
      time: shard ``id % S``; if its tail is full, the shard with the most
      free slots (ties to the lowest shard); if every tail is full, one
      all-padding block appended to EVERY shard (the stacked shapes stay
      uniform) and shard ``id % S`` again.  So every rank places alike with
      no collective.
    * Each rank writes only its own shards
      (:class:`~repro_torch.core.distributed.ShardedMutationOps`): the rows'
      float32 ``dp`` into ``dp_min/dp_max`` and their sound intervals into
      ``dp_lo/dp_hi`` and, while the shape is stable, into the engine's live
      shard trees (:func:`~repro_torch.search.tree.widen_shard_trees`).

    :meth:`reoptimize` repacks within each shard under its existing pivots
    (drops tombstones, restores block coherence, re-tightens every interval
    from the live rows, shrinks the common padded size to the fullest
    shard); no row moves across shards.  Like the flat handle, it owns a
    copy of the engine's index.  Contract: mutation calls are made
    identically on every rank (same rows, same order), as every other call
    on a mesh.
    """

    _stacked = True

    def __init__(self, engine, *, reoptimize_threshold: float = 0.5,
                 auto_reoptimize: bool = True):
        from repro_torch.core.distributed import make_sharded_mutation
        self._ops = make_sharded_mutation(engine.mesh, engine.axis_names)
        super().__init__(engine, reoptimize_threshold=reoptimize_threshold,
                         auto_reoptimize=auto_reoptimize)

    def _host_row_ids(self, index: BlockIndex) -> np.ndarray:
        from repro_torch.core.distributed import replicated_row_ids
        return replicated_row_ids(index, self.engine.mesh, self.engine.axis_names)

    def _mirror(self, row_ids: np.ndarray) -> None:
        """The host mirrors from every shard's ``row_ids [S, n_pad]``:
        ``_id_pos`` maps an external id to ``(shard, slot)``, ``_free[s]``
        lists shard ``s``'s free slots, descending, so ``pop()`` hands out
        the lowest first."""
        self._id_pos = {}
        self._free = []
        for s, rid in enumerate(row_ids):
            live = np.flatnonzero(rid >= 0)
            self._id_pos.update(zip(rid[live].tolist(), ((s, p) for p in live.tolist())))
            self._free.append(np.flatnonzero(rid < 0)[::-1].tolist())

    def insert(self, rows) -> list[int]:
        """Insert ``rows`` (``[n, d]`` or ``[d]``, numpy or tensor); returns
        their external ids.  Places every row from the host mirrors before
        any device work (class docstring), then writes each rank's shards;
        appending blocks (every tail full) is a shape change and drops the
        shard trees, else the live shard trees are widened."""
        eng = self.engine
        index = eng.index
        n_shards = len(self._free)
        _, n_pad, d = index.db.shape
        rows64 = _unit_rows(rows, d)
        n_new = rows64.shape[0]
        if n_new == 0:
            return []
        bs = n_pad // index.dp_min.shape[1]
        ids = list(range(self._next_id, self._next_id + n_new))

        n_add = 0
        placements = []
        for rid in ids:
            s = rid % n_shards
            if not self._free[s]:
                s2 = max(range(n_shards), key=lambda j: (len(self._free[j]), -j))
                if self._free[s2]:
                    s = s2
                else:
                    base = n_pad + n_add * bs
                    for fl in self._free:
                        fl.extend(range(base + bs - 1, base - 1, -1))
                    n_add += 1
            placements.append((s, self._free[s].pop()))
        shape_changed = n_add > 0
        if shape_changed:
            index = self._ops.grow(index, n_add)

        # uniform-width per-shard operands, the same on every rank
        per_shard = [[] for _ in range(n_shards)]
        for j, (s, slot) in enumerate(placements):
            per_shard[s].append((slot, j))
        width = max(len(v) for v in per_shard)
        slots = np.zeros((n_shards, width), np.int64)
        mask = np.zeros((n_shards, width), bool)
        ids_arr = np.full((n_shards, width), -1, np.int64)
        rows_arr = np.zeros((n_shards, width, d), np.float64)
        for s, entries in enumerate(per_shard):
            for c, (slot, j) in enumerate(entries):
                slots[s, c], mask[s, c], ids_arr[s, c] = slot, True, ids[j]
                rows_arr[s, c] = rows64[j]
        index, widening = self._ops.insert(index, slots, mask, rows_arr, ids_arr)
        shard_tree = None
        if not shape_changed and eng._shard_tree is not None:
            shard_tree = self._ops.widen(eng._shard_tree, *widening)

        self._id_pos.update(zip(ids, placements))
        self._next_id += n_new
        self.generation += 1
        self._mutations_since_opt += n_new
        eng._apply_mutation(index, n_valid=len(self._id_pos),
                            shape_changed=shape_changed, shard_tree=shard_tree)
        self._maybe_reoptimize()
        return ids

    def delete(self, ids) -> None:
        """Tombstone-delete rows by external id (:meth:`MutableIndex.delete`'s
        semantics, on each row's own shard)."""
        ids = _checked_ids(ids, self._id_pos)
        if not ids:
            return
        n_shards = len(self._free)
        per_shard = [[] for _ in range(n_shards)]
        for i in ids:
            s, slot = self._id_pos.pop(i)
            per_shard[s].append(slot)
        width = max(len(v) for v in per_shard)
        slots = np.zeros((n_shards, width), np.int64)
        mask = np.zeros((n_shards, width), bool)
        for s, sl in enumerate(per_shard):
            slots[s, :len(sl)] = sl
            mask[s, :len(sl)] = True
            if sl:
                self._free[s] = sorted(self._free[s] + sl, reverse=True)
        index = self._ops.delete(self.engine.index, slots, mask)
        self.generation += 1
        self._mutations_since_opt += len(ids)
        self.engine._apply_mutation(index, n_valid=len(self._id_pos),
                                    shape_changed=False)
        self._maybe_reoptimize()

    def reoptimize(self) -> None:
        """Per-shard repack (class docstring); the common padded size
        shrinks to the fullest shard's live rows, at least one block.
        External ids are kept.  A shape change: the shard trees drop."""
        eng = self.engine
        index = eng.index
        self._rows_at_opt = max(1, len(self._id_pos))
        self._mutations_since_opt = 0
        self.generation += 1
        bs = index.db.shape[1] // index.dp_min.shape[1]
        per_live = np.bincount([s for s, _ in self._id_pos.values()],
                               minlength=len(self._free))
        n_pad_new = max(bs, -(-int(per_live.max()) // bs) * bs)
        new = self._ops.repack(index, n_pad_new)
        self._mirror(self._host_row_ids(new))
        eng._apply_mutation(new, n_valid=len(self._id_pos), shape_changed=True)
