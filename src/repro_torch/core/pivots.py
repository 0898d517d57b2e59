"""Pivot (reference point) selection for LAESA-style bound pruning.

PyTorch counterpart of :mod:`repro.core.pivots`: greedy max-min
(farthest-first) selection in arc distance, a seeded random fallback, the
joint bound's table depth, and the float64 orthonormal pivot basis behind
that bound.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

__all__ = ["normalize", "select_pivots_maxmin", "select_pivots_random",
           "suggest_bound_pivots", "orthonormal_pivot_basis"]


def normalize(x: Tensor, eps: float = 1e-12) -> Tensor:
    """L2-normalize along the last axis (safe for zero rows)."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=eps)


def select_pivots_maxmin(db: Tensor, n_pivots: int, *, first: int = 0) -> Tensor:
    """Greedy farthest-first pivot selection (returns pivot *indices*).

    Iteratively picks the point whose maximum similarity to the pivots
    chosen so far is smallest.  Ties pick the first index, as
    ``jnp.argmin`` does in the reference; ``torch.argmin`` documents the
    same rule.  The similarities are a row-wise multiply-and-sum, not a
    BLAS matrix-vector product: every row is reduced by the same code, so
    duplicate rows tie exactly.  The indices stay on ``db``'s device (no
    host sync).
    """
    dbn = normalize(db.float())
    idx = torch.zeros(n_pivots, dtype=torch.int64, device=db.device)
    idx[0] = first
    max_sim = torch.full((dbn.shape[0],), float("-inf"), device=db.device)
    for i in range(1, n_pivots):
        max_sim = torch.maximum(max_sim, (dbn * dbn[idx[i - 1]]).sum(-1))
        idx[i] = torch.argmin(max_sim)
    return idx


def select_pivots_random(n: int, n_pivots: int, seed: int = 0) -> Tensor:
    """Uniform random pivot indices from numpy's seeded generator, the same
    draw as the reference; ``n_pivots`` is clamped to ``n``."""
    rng = np.random.default_rng(seed)
    n_pivots = max(1, min(n_pivots, n))
    return torch.from_numpy(rng.choice(n, size=n_pivots, replace=False)
                            .astype(np.int64))


def suggest_bound_pivots(n: int, d: int) -> int:
    """Pivot-table depth for the joint ``eq13_multi`` bound
    (:mod:`repro_torch.core.bounds`).

    ``d`` pivots span the whole space, where the joint bound equals the
    exact score at the cost of a full matmul; shallow tables lose all power
    on uniform high-d data.  ``7d/8`` keeps a usable orthogonal remainder;
    clamped to ``n - 1`` so tiny corpora stay non-degenerate.
    """
    return max(1, min(7 * d // 8, max(1, n - 1)))


def orthonormal_pivot_basis(pivots, jitter: float = 1e-6) -> np.ndarray:
    """Orthonormalized pivot basis ``U = R^{-1} Z`` (host float64 numpy).

    ``R`` is the lower Cholesky factor of ``Z Z^T + jitter*I``; the jitter
    escalates ×10 until the factorization succeeds, so duplicate or
    dependent pivots stay defined.  Prefix rows of ``U`` are the basis a
    shallower table would have built (DESIGN.md §3.8).
    """
    if isinstance(pivots, Tensor):
        pivots = pivots.detach().cpu().numpy()
    z = np.asarray(pivots, np.float64)
    p = z.shape[0]
    gram = z @ z.T
    eps = float(jitter)
    for _ in range(24):
        try:
            chol = np.linalg.cholesky(gram + eps * np.eye(p))
            break
        except np.linalg.LinAlgError:
            eps *= 10.0
    else:  # pragma: no cover - float64 PSD + jitter cannot get here
        raise np.linalg.LinAlgError("pivot Gram not factorizable")
    from scipy.linalg import solve_triangular

    return solve_triangular(chol, z, lower=True)
