"""Exact-cosine-kNN search runtime (counterpart of :mod:`repro.search`).

  engine   — :class:`SearchEngine` (build, query prep, τ warm-start,
             best-first order, id mapping, stats); ``.online()`` hands out
             the engine's :class:`MutableIndex` mutation handle
  backends — registry + the ``scan``, ``kernel``, ``sharded`` and ``brute``
             inner loops
  tree     — the pivot-tree backend (``backend="tree"``): transitive Eq. 13
             descent over an array-encoded balanced tree, then the scan
             or the kernel leaf stage (``leaf_eval``)
  stats    — the one :class:`SearchStats` every path returns
"""
from repro_torch.core.online import MutableIndex
from repro_torch.search.backends import (available_backends, get_backend,
                                         register_backend)
from repro_torch.search.engine import SearchEngine, auto_backend
from repro_torch.search.stats import SearchStats
from repro_torch.search.tree import TreeIndex, build_tree, widen_tree

__all__ = [
    "MutableIndex",
    "SearchEngine",
    "SearchStats",
    "TreeIndex",
    "auto_backend",
    "available_backends",
    "build_tree",
    "get_backend",
    "register_backend",
    "widen_tree",
]
