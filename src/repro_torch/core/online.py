"""Online mutation for a live :class:`~repro_torch.search.SearchEngine`.

Counterpart of :mod:`repro.core.online` (its single-device handle; the
sharded one is not ported yet).  Every structure the search paths read
stays valid under **conservative widening** (DESIGN.md §3.9):

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
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.index import BlockIndex, build_index, row_intervals

__all__ = ["MutableIndex"]


def _append_blocks(index: BlockIndex, n_add: int) -> BlockIndex:
    """Grow the index by ``n_add`` all-padding blocks (``valid`` False,
    ``row_ids`` -1): a shape change; no live row moves.

    New blocks carry the empty-interval sentinel (``+inf`` low end, ``-inf``
    high end) in ``dp_min/dp_max`` and in ``dp_lo/dp_hi``: every bound maps
    an inverted interval to ``-inf``, and the insert's scatter-min/max then
    records the first rows' exact interval (an anchor at 0 would keep the
    block loose until a rebuild).
    """
    nr = n_add * index.block_size

    def grow(t, rows, fill):
        return torch.cat([t, t.new_full((rows,) + t.shape[1:], fill)])

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

    def __init__(self, engine, *, reoptimize_threshold: float = 0.5,
                 auto_reoptimize: bool = True):
        self.engine = engine
        self.reoptimize_threshold = float(reoptimize_threshold)
        self.auto_reoptimize = bool(auto_reoptimize)
        #: mutation calls applied through this handle (also
        #: ``SearchStats.generation``)
        self.generation = 0
        self._mutations_since_opt = 0
        own = BlockIndex(*(None if t is None else t.clone() for t in engine.index))
        engine._apply_mutation(own, n_valid=engine.n_valid, shape_changed=False)
        self._mirror(own.row_ids.cpu().numpy())
        self._next_id = max(self._id_pos, default=-1) + 1
        self._rows_at_opt = max(1, len(self._id_pos))

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
        all-padding blocks are appended (a shape change).  The rows' blocks
        widen ``dp_min/dp_max`` with their float32 ``dp`` and
        ``dp_lo/dp_hi`` with their sound intervals (module docstring); the
        joint-bound tables get their rows; a live tree (shape-stable
        inserts only) is widened along the rows' root-to-leaf paths.
        """
        if isinstance(rows, torch.Tensor):
            rows = rows.detach().cpu().numpy()
        rows64 = np.asarray(rows, np.float64)
        if rows64.ndim == 1:
            rows64 = rows64[None, :]
        n_new = rows64.shape[0]
        if n_new == 0:
            return []
        eng = self.engine
        index = eng.index
        if rows64.shape[1] != index.db.shape[1]:
            raise ValueError(f"inserted rows have dim {rows64.shape[1]}, "
                             f"index has dim {index.db.shape[1]}")
        norms = np.linalg.norm(rows64, axis=1, keepdims=True)
        rows64 = rows64 / np.where(norms == 0.0, 1.0, norms)

        bs = index.block_size
        shape_changed = len(self._free) < n_new
        if shape_changed:
            n_add = -(-(n_new - len(self._free)) // bs)
            old_slots = index.db.shape[0]
            index = _append_blocks(index, n_add)
            self._free = (list(range(old_slots + n_add * bs - 1, old_slots - 1, -1))
                          + self._free)
        pos = [self._free.pop() for _ in range(n_new)]
        ids = list(range(self._next_id, self._next_id + n_new))

        dev = index.device
        pos_t = torch.tensor(pos, dtype=torch.int64, device=dev)
        blk_t = pos_t // bs
        rows_f = torch.from_numpy(rows64.astype(np.float32)).to(dev)
        # the reference's float32 product (dp, dp_min, dp_max), and beside it
        # the sound interval every bound of the port reads
        dp_new = rows_f @ index.pivots.T                          # [n_new, P]
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
            # the stored basis is float32; its upcast differs from the
            # build's float64 basis by ~1e-7, which JOINT_SLACK absorbs
            beta64 = rows64 @ index.ortho.double().cpu().numpy().T
            index.beta[pos_t] = torch.from_numpy(beta64).float().to(dev)
            index.beta_nsq[pos_t] = torch.from_numpy(
                np.cumsum(beta64 * beta64, axis=1)).float().to(dev)

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
        if isinstance(ids, (int, np.integer)):
            ids = [ids]
        ids = [int(i) for i in ids]
        if not ids:
            return
        bad = [i for i in ids if i not in self._id_pos]
        if bad:
            raise KeyError(f"row ids {bad} are not in the live set (never "
                           f"inserted, or already deleted)")
        if len(set(ids)) != len(ids):
            raise KeyError(f"duplicate row ids in delete: {ids}")
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
