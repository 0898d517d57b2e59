"""Configuration of the paper's search subsystem itself (a copy of
:mod:`repro.configs.paper_index`).

These defaults reflect the §Perf.P3 hillclimb (EXPERIMENTS.md): 16 max-min
pivots, 128-row blocks (MXU-aligned), angular reorder on, query sorting on,
tau warm-start on, bm=32 query tiles (TPU sublane-friendly middle of the
16–64 sweet spot measured in interpret mode).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    n_pivots: int = 16
    block_size: int = 128
    pivot_method: str = "maxmin"
    reorder: bool = True
    # kernel search params
    bm: int = 32
    sort_queries: bool = True
    warm_start: bool = True
    margin: float = 4e-7
    # serving
    k: int = 16
    knn_temp: float = 10.0
    knn_lambda: float = 0.25


DEFAULT = IndexConfig()
