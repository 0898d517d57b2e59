"""Pure-numpy float64 oracles for the bounds and for exact kNN search.

A copy of :mod:`repro.core.ref` kept inside the port so that
``repro_torch`` never imports the JAX package; the tests check that the two
agree.  No torch here either: this is the independent reference.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "lb_euclid",
    "lb_euclid_fast",
    "lb_arccos",
    "lb_mult",
    "lb_mult_fast1",
    "lb_mult_fast2",
    "ub_mult",
    "cosine_matrix",
    "normalize",
    "brute_force_knn",
    "pruned_knn_reference",
    "LOWER_BOUNDS",
]


def _rad(s):
    return np.maximum(0.0, 1.0 - s * s)


def lb_euclid(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a + b - 1.0 - 2.0 * np.sqrt(np.maximum(0.0, (1.0 - a) * (1.0 - b)))


def lb_euclid_fast(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a + b + 2.0 * np.minimum(a, b) - 3.0


def lb_arccos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.cos(np.arccos(np.clip(a, -1, 1)) + np.arccos(np.clip(b, -1, 1)))


def lb_mult(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a * b - np.sqrt(_rad(a) * _rad(b))


def lb_mult_fast1(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a * b + np.minimum(a, b) ** 2 - 1.0


def lb_mult_fast2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return 2.0 * a * b - np.abs(a - b) - 1.0


def ub_mult(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a * b + np.sqrt(_rad(a) * _rad(b))


def ub_euclid(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a + b - 1.0 + 2.0 * np.sqrt(np.maximum(0.0, (1.0 - a) * (1.0 - b)))


LOWER_BOUNDS = {
    "euclidean": lb_euclid,
    "eucl_lb": lb_euclid_fast,
    "arccos": lb_arccos,
    "mult": lb_mult,
    "mult_lb1": lb_mult_fast1,
    "mult_lb2": lb_mult_fast2,
}


# ---------------------------------------------------------------------------
# Exact-search oracles
# ---------------------------------------------------------------------------

def normalize(x, eps: float = 1e-12):
    x = np.asarray(x, np.float64)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), eps)


def cosine_matrix(q, db):
    """All-pairs cosine similarity, float64.  q: [m, d], db: [n, d]."""
    return normalize(q) @ normalize(db).T


def brute_force_knn(q, db, k: int):
    """Exact top-k by cosine similarity.  Returns (sims [m,k], idx [m,k]).

    Ties are broken by ascending index (stable), matching the device kernels.
    """
    s = cosine_matrix(q, db)
    # stable argsort on (-sim, idx): lexsort over keys.
    m, n = s.shape
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    sims = np.take_along_axis(s, order, axis=1)
    return sims, order


def pruned_knn_reference(q, db, pivots, k: int):
    """LAESA-style pruned exact kNN, scalar reference (paper's machinery).

    Per query: seed the candidate heap with the first k database points, then
    for each remaining point first test the pivot upper bound (Eq. 13, min
    over pivots); only if it exceeds the current k-th best similarity is the
    exact similarity computed.  Returns (sims, idx, exact_fraction) where
    exact_fraction is the fraction of database points whose exact similarity
    had to be computed (the paper's "pruning power" metric, lower = better).
    """
    qn, dbn, pn = normalize(q), normalize(db), normalize(pivots)
    qp = qn @ pn.T                     # [m, P]
    dp = dbn @ pn.T                    # [n, P]
    m, n = qn.shape[0], dbn.shape[0]
    sims_out = np.full((m, k), -np.inf)
    idx_out = np.zeros((m, k), np.int64)
    exact = 0
    for i in range(m):
        cand = []                       # list of (sim, idx)
        for j in range(n):
            if len(cand) >= k:
                tau = cand[k - 1][0]
                ub = np.min(ub_mult(qp[i], dp[j]))
                if ub < tau:            # Eq. 13 prune: cannot beat k-th best
                    continue
            s = float(qn[i] @ dbn[j])
            exact += 1
            cand.append((s, j))
            cand.sort(key=lambda t: (-t[0], t[1]))
            cand = cand[:k]
        sims_out[i] = [c[0] for c in cand]
        idx_out[i] = [c[1] for c in cand]
    return sims_out, idx_out, exact / (m * n)
