"""Plain PyTorch oracles for the kernels (counterpart of
:mod:`repro.kernels.ref`); the kernels' plain versions build on these."""
from __future__ import annotations

import torch
from torch import Tensor

__all__ = ["sqrt_rn", "l2_normalize", "cosine_scores", "block_bounds",
           "kth_value", "cosine_topk", "pruned_cosine_topk"]


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


def block_bounds(qp: Tensor, dp_min: Tensor, dp_max: Tensor) -> Tensor:
    """Per-(query, block) Eq. 13 interval upper bound, min over pivots.

    qp: [M, P]; dp_min/dp_max: [NB, P] -> [M, NB] f32.  An inverted
    interval (lo > hi, the empty-block sentinel) bounds at -inf.
    Materializes ``[M, NB, P]`` intermediates.
    """
    qp = qp.float()[:, None, :]                   # [M, 1, P]
    lo = dp_min.float()[None, :, :]               # [1, NB, P]
    hi = dp_max.float()[None, :, :]
    rad_q = torch.clamp(1.0 - qp * qp, min=0.0)
    ub_lo = qp * lo + sqrt_rn(rad_q * torch.clamp(1.0 - lo * lo, min=0.0))
    ub_hi = qp * hi + sqrt_rn(rad_q * torch.clamp(1.0 - hi * hi, min=0.0))
    at_ends = torch.maximum(ub_lo, ub_hi)
    inside = (qp >= lo) & (qp <= hi)
    per_pivot = torch.where(inside, torch.ones_like(at_ends), at_ends)
    per_pivot = per_pivot.masked_fill(lo > hi, float("-inf"))
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
