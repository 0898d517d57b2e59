"""Plain PyTorch oracles for the kernels (counterpart of
:mod:`repro.kernels.ref`); the kernels' plain versions build on these."""
from __future__ import annotations

import torch
from torch import Tensor

__all__ = ["sqrt_rn", "radicand", "query_interval", "box_bound",
           "l2_normalize", "cosine_scores", "block_bounds", "kth_value",
           "cosine_topk", "pruned_cosine_topk"]


def sqrt_rn(x: Tensor) -> Tensor:
    """The square root rounded to nearest, as XLA's and the card's are.

    torch's vectorized CPU square root of float32 can be an ulp off; taken
    in float64 and rounded to float32 it is exact (float64 carries more than
    twice float32's 24 bits, so the double rounding is innocuous).
    """
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def l2_normalize(x: Tensor, eps: float = 1e-12) -> Tensor:
    xf = x.float()
    n = torch.sqrt(torch.sum(xf * xf, dim=-1, keepdim=True))
    return (xf / torch.clamp(n, min=eps)).to(x.dtype)


def cosine_scores(q: Tensor, db: Tensor) -> Tensor:
    """All-pairs cosine similarity with fused normalization; f32 accumulate."""
    return l2_normalize(q).float() @ l2_normalize(db).float().T


def radicand(s: Tensor) -> Tensor:
    """``max(0, (1 - s)(1 + s))``: ``1 - s^2`` without cancellation (for
    ``|s| >= 1/2``, ``1 - s`` is exact), 0 outside ``[-1, 1]``."""
    return torch.clamp((1.0 - s) * (1.0 + s), min=0.0)


def query_interval(qp: Tensor) -> tuple[Tensor, Tensor]:
    """``(a_lo, a_hi)``: the float32 neighbours of each pivot similarity,
    clamped to ``[-1, 1]`` (NaN stays NaN).

    ``qp`` is the pivot cosine rounded to nearest from a more precise value
    (``prep_queries`` computes it in float64), so ``[a_lo, a_hi]`` contains
    that value; every Eq. 13 bound is taken over this interval.
    """
    qp = qp.float()
    inf = torch.tensor(float("inf"), device=qp.device)
    return (torch.nextafter(qp, -inf).clamp(-1.0, 1.0),
            torch.nextafter(qp, inf).clamp(-1.0, 1.0))


def box_bound(a_lo: Tensor, a_hi: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """Eq. 13 over the box ``[a_lo, a_hi] x [lo, hi]``, elementwise: 1 where
    the two intervals meet, else the bound at the nearest corner, ``(a_hi,
    lo)`` where the query lies below the block and ``(a_lo, hi)`` where it
    lies above (the angle difference is least there; core/index.py's
    ``interval_upper_bound`` has the argument).  An inverted interval is not
    special-cased here.  NaN in ``a_lo``, ``a_hi`` or ``lo`` gives NaN; so
    does NaN in ``hi`` unless the query lies below ``lo``.
    """
    below = ~(a_hi >= lo)
    x = torch.where(below, a_hi, a_lo)
    y = torch.where(below, lo, hi)
    at_corner = x * y + sqrt_rn(radicand(x) * radicand(y))
    meet = (a_lo <= hi) & (a_hi >= lo)
    return torch.where(meet, torch.ones_like(at_corner), at_corner)


def block_bounds(qp: Tensor, dp_min: Tensor, dp_max: Tensor) -> Tensor:
    """Per-(query, block) Eq. 13 interval upper bound, min over pivots.

    qp: [M, P]; dp_min/dp_max: [NB, P] -> [M, NB] f32: :func:`box_bound`
    over :func:`query_interval` of ``qp`` and each block interval.  An
    inverted interval (lo > hi, the empty-block sentinel) bounds at -inf.
    Materializes ``[M, NB, P]`` intermediates.
    """
    a_lo, a_hi = (a[:, None, :] for a in query_interval(qp))    # [M, 1, P]
    lo = dp_min.float()[None, :, :]               # [1, NB, P]
    hi = dp_max.float()[None, :, :]
    per_pivot = box_bound(a_lo, a_hi, lo, hi).masked_fill(lo > hi, float("-inf"))
    return per_pivot.amin(dim=-1)                 # [M, NB]


def kth_value(scores: Tensor, k: int) -> Tensor:
    """Row-wise k-th highest value."""
    return torch.topk(scores, k, dim=1).values[:, -1]


def cosine_topk(q: Tensor, db: Tensor, k: int, valid: Tensor | None = None):
    """Exact top-k cosine (sims f32, idx i32).  ``valid`` masks db rows."""
    s = cosine_scores(q, db)
    if valid is not None:
        s = s.masked_fill(~valid[None, :], float("-inf"))
    sims, idx = torch.topk(s, k, dim=1)
    return sims, idx.to(torch.int32)


def pruned_cosine_topk(q: Tensor, db: Tensor, qp: Tensor, dp_min: Tensor,
                       dp_max: Tensor, k: int, valid: Tensor | None = None,
                       margin: float = 4e-7):
    """Oracle for the fused kernel including its pruning bookkeeping:
    ``(sims, idx, prunable fraction)`` — the per-(query, block) fraction
    whose bound (plus margin) is below the final k-th best.  The result
    equals plain :func:`cosine_topk`."""
    sims, idx = cosine_topk(q, db, k, valid)
    ub = block_bounds(qp, dp_min, dp_max)
    prunable = (ub + margin) < sims[:, -1:]
    return sims, idx, prunable.float().mean()
