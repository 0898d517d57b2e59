"""Core: the paper's cosine triangle inequality and the block index.

  bounds   — Eq. 7–13 elementwise bound functions (torch)
  ref      — float64 numpy oracles (independent reference)
  pivots   — pivot selection
  index    — the block index (BlockIndex / build_index / search_brute)
  online   — MutableIndex: insert / delete / reoptimize under a live engine
  vptree   — host-side VP-tree baseline (the paper's index family)
  distributed — the mesh-sharded datastore: sharded and process-local
             builds, per-shard search and the top-k merge
"""
from repro_torch.core import bounds, distributed, ref  # noqa: F401
from repro_torch.core.index import BlockIndex, build_index, search_brute  # noqa: F401
from repro_torch.core.pivots import normalize, select_pivots_maxmin  # noqa: F401
from repro_torch.core.vptree import VPTree  # noqa: F401
