"""The one stats object every search path returns (counterpart of
:mod:`repro.search.stats`)."""
from __future__ import annotations

from dataclasses import dataclass, field, fields

__all__ = ["SearchStats"]


@dataclass(frozen=True)
class SearchStats:
    """Per-call search statistics, with the reference's fields and rules.

    Numeric fields may be 0-dim tensors on the search device: reading one
    (``float(...)``, :meth:`as_dict`) waits for the device, ignoring them
    costs nothing.

    ``block_prune_frac``: fraction of (query tile, kernel tile) work units
    the Eq. 13 bound proved unnecessary (``1 - tile_computed_frac`` on the
    kernel backend; 0 for brute force).  ``elem_prune_frac`` (with
    ``element_stats``): fraction of (query, valid row) pairs whose own
    Eq. 13 bound fell below the running τ at visit time.

    ``tree_prune_frac`` (``tree`` backend, with pruning): fraction of
    (query, block) pairs the transitive descent alone cut;
    ``tree_node_eval_frac``: (query, node) bound evaluations the descent
    needed over ``m`` times the valid nodes; ``extras["tree_levels"]``: the
    tree's depth; ``extras["n_keep"]`` (kernel leaf stage): the blocks the
    batch's union of surviving leaves kept, over which ``pruned_topk`` ran.

    **Absent-stage fields are ``None``, never 0.**  ``tree_*`` are ``None``
    on every backend but ``tree``, and there with ``prune=False`` (the
    descent did not run).  ``retraces`` is always ``None``: the port has no
    trace cache.  ``generation`` (mutation calls applied) and
    ``decay_estimate`` (mutated rows over the corpus at the last build) are
    the online handle's, ``None`` while the engine has none
    (:meth:`SearchEngine.online`).
    """

    backend: str
    n_queries: int
    k: int
    n_blocks: int
    block_prune_frac: float = 0.0
    tile_computed_frac: float | None = None
    elem_prune_frac: float | None = None
    tree_prune_frac: float | None = None
    tree_node_eval_frac: float | None = None
    warm_start: bool = False
    best_first: bool = False
    n_pivots: int | None = None
    retraces: int | None = None
    generation: int | None = None
    decay_estimate: float | None = None
    extras: dict = field(default_factory=dict)

    def __getitem__(self, key):
        if key in self.extras:
            return self.extras[key]
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def keys(self):
        return [f.name for f in fields(self) if f.name != "extras"] + list(self.extras)

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def as_dict(self) -> dict:
        return dict(self.items())
