"""Vantage-point tree over cosine similarity — the paper-faithful baseline.

A copy of :mod:`repro.core.vptree` (numpy only, over the port's copy of the
float64 oracles, :mod:`repro_torch.core.ref`), so the port never imports
the JAX package; the tests hold the two to identical results.

This is the CPU-idiomatic, pointer-style index family the paper targets
(Yianilos 1993 / Uhlmann 1991), operated *directly in similarity space* using
the paper's bounds, with a pluggable upper-bound function so the pruning
power of Eq. 13 (Mult) can be measured against the chord-metric bound
(reverse Eq. 7) and the cheap approximations — the experiment the paper
explicitly defers to future work (§4: "we will not investigate the actual
performance in a similarity index here").

Host-side numpy on purpose: data-dependent tree traversal is the thing that
does NOT map to an accelerator (DESIGN.md §2); the accelerator-native
equivalent is :mod:`repro_torch.core.index`.  Both are exact.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from repro_torch.core import ref

__all__ = ["VPTree", "UPPER_BOUNDS"]


def _interval_ub(ub_fn, a: float, lo: float, hi: float) -> float:
    """max over b in [lo, hi] of ub_fn(a, b); both paper UBs peak at b=a."""
    if lo <= a <= hi:
        return 1.0
    return max(float(ub_fn(a, lo)), float(ub_fn(a, hi)))


#: name -> similarity upper-bound function sim(x,y) <= ub(sim(x,z), sim(z,y))
UPPER_BOUNDS = {
    "mult": ref.ub_mult,       # Eq. 13 (tight, recommended)
    "euclid": ref.ub_euclid,   # via chord metric (reverse Eq. 7)
}


@dataclass
class _Node:
    vp: int                      # index of the vantage point
    mu: float = 1.0              # similarity threshold (near: sim >= mu)
    near: "_Node | None" = None
    far: "_Node | None" = None
    near_iv: tuple = (1.0, 1.0)  # (lo, hi) sim(vp, y) interval of near subtree
    far_iv: tuple = (-1.0, -1.0)
    bucket: np.ndarray | None = None  # leaf: explicit point ids


class VPTree:
    """Exact cosine kNN via VP-tree with similarity-domain pruning.

    Args:
      data: [n, d] raw vectors (normalized internally).
      leaf_size: bucket size at which recursion stops.
      seed: vantage-point sampling seed.
    """

    def __init__(self, data: np.ndarray, leaf_size: int = 16, seed: int = 0):
        self.data = ref.normalize(np.asarray(data, np.float64))
        self.n = self.data.shape[0]
        self._rng = np.random.default_rng(seed)
        self.leaf_size = leaf_size
        self.root = self._build(np.arange(self.n))

    # -- construction ------------------------------------------------------
    def _build(self, ids: np.ndarray) -> _Node | None:
        if ids.size == 0:
            return None
        if ids.size <= self.leaf_size:
            node = _Node(vp=int(ids[0]))
            node.bucket = ids
            return node
        vp_pos = int(self._rng.integers(ids.size))
        vp = int(ids[vp_pos])
        rest = np.delete(ids, vp_pos)
        sims = self.data[rest] @ self.data[vp]
        mu = float(np.median(sims))
        near_mask = sims >= mu
        near_ids, far_ids = rest[near_mask], rest[~near_mask]
        node = _Node(vp=vp, mu=mu)
        if near_ids.size:
            s = sims[near_mask]
            node.near_iv = (float(s.min()), float(s.max()))
            node.near = self._build(near_ids)
        if far_ids.size:
            s = sims[~near_mask]
            node.far_iv = (float(s.min()), float(s.max()))
            node.far = self._build(far_ids)
        return node

    # -- search ------------------------------------------------------------
    def knn(self, query: np.ndarray, k: int, *, bound: str = "mult"):
        """Exact top-k for one query.

        Returns (sims [k], ids [k], n_exact) where n_exact counts exact
        similarity computations (pruning power = 1 - n_exact/n).
        """
        ub_fn = UPPER_BOUNDS[bound]
        q = ref.normalize(query[None, :])[0]
        heap: list[tuple[float, int]] = []   # min-heap of (sim, id), size <= k
        n_exact = 0

        def offer(i: int):
            nonlocal n_exact
            s = float(q @ self.data[i])
            n_exact += 1
            if len(heap) < k:
                heapq.heappush(heap, (s, i))
            elif s > heap[0][0]:
                heapq.heapreplace(heap, (s, i))

        def tau() -> float:
            return heap[0][0] if len(heap) == k else -np.inf

        # best-first traversal: max-heap on subtree upper bound
        pq: list[tuple[float, int, _Node]] = []
        tie = 0

        def push(node: _Node | None, ub: float):
            nonlocal tie
            if node is not None and ub >= tau():
                heapq.heappush(pq, (-ub, tie, node))
                tie += 1

        push(self.root, 1.0)
        while pq:
            neg_ub, _, node = heapq.heappop(pq)
            if -neg_ub < tau():
                continue                      # stale entry, now prunable
            if node.bucket is not None:
                for i in node.bucket:
                    offer(int(i))
                continue
            a = float(q @ self.data[node.vp])  # exact sim to vantage point
            n_exact += 1
            if len(heap) < k or a > heap[0][0]:
                if len(heap) < k:
                    heapq.heappush(heap, (a, node.vp))
                else:
                    heapq.heapreplace(heap, (a, node.vp))
            push(node.near, _interval_ub(ub_fn, a, *node.near_iv))
            push(node.far, _interval_ub(ub_fn, a, *node.far_iv))

        top = sorted(heap, key=lambda t: (-t[0], t[1]))
        sims = np.array([t[0] for t in top])
        ids = np.array([t[1] for t in top], np.int64)
        return sims, ids, n_exact

    def knn_batch(self, queries: np.ndarray, k: int, *, bound: str = "mult"):
        """Batched wrapper; returns (sims [m,k], ids [m,k], mean_exact_frac)."""
        out_s, out_i, total = [], [], 0
        for q in np.asarray(queries, np.float64):
            s, i, ne = self.knn(q, k, bound=bound)
            out_s.append(s)
            out_i.append(i)
            total += ne
        frac = total / (len(queries) * self.n)
        return np.stack(out_s), np.stack(out_i), frac
