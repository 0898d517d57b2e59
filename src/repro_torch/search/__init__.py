"""Exact-cosine-kNN search runtime (counterpart of :mod:`repro.search`).

  engine   — :class:`SearchEngine` (build, query prep, τ warm-start,
             best-first order, id mapping, stats); ``.online()`` hands out
             the engine's :class:`MutableIndex` mutation handle (its
             sharded subclass on a sharded engine)
  backends — registry + the ``scan``, ``kernel``, ``sharded`` and ``brute``
             inner loops
  tree     — the pivot-tree backend (``backend="tree"``): transitive Eq. 13
             descent over an array-encoded balanced tree, then the scan
             or the kernel leaf stage (``leaf_eval``); the shard trees of
             the ``sharded`` backend (:class:`ShardTreeArrays`)
  stats    — the one :class:`SearchStats` every path returns
"""
from repro_torch.core.online import MutableIndex
from repro_torch.search.backends import (available_backends, get_backend,
                                         register_backend)
from repro_torch.search.engine import SearchEngine, auto_backend
from repro_torch.search.stats import SearchStats
from repro_torch.search.tree import (ShardTreeArrays, TreeIndex, build_shard_trees,
                                     build_tree, widen_tree)

__all__ = [
    "MutableIndex",
    "SearchEngine",
    "SearchStats",
    "ShardTreeArrays",
    "TreeIndex",
    "auto_backend",
    "available_backends",
    "build_shard_trees",
    "build_tree",
    "get_backend",
    "register_backend",
    "widen_tree",
]
