"""Exact-cosine-kNN search runtime (counterpart of :mod:`repro.search`).

  engine   — :class:`SearchEngine` (build, query prep, τ warm-start,
             best-first order, id mapping, stats)
  backends — registry + the ``kernel`` and ``brute`` inner loops
  stats    — the one :class:`SearchStats` every path returns
"""
from repro_torch.search.backends import (available_backends, get_backend,
                                         register_backend)
from repro_torch.search.engine import SearchEngine, auto_backend
from repro_torch.search.stats import SearchStats

__all__ = [
    "SearchEngine",
    "SearchStats",
    "auto_backend",
    "available_backends",
    "get_backend",
    "register_backend",
]
