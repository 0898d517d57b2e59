"""Triangle-inequality bounds for cosine similarity (Schubert, SISAP 2021).

PyTorch counterpart of :mod:`repro.core.bounds`.  All functions are
elementwise over tensors of *similarities* ``a = sim(x, z)``,
``b = sim(z, y)`` in ``[-1, 1]`` and return a bound on ``sim(x, y)``;
equation numbers follow the paper.  The ``1 - s^2`` radicands are taken
as ``(1 - s)(1 + s)``, which does not cancel near ``|s| = 1``, and clamped
at zero so a value outside ``[-1, 1]`` cannot produce NaN.
"""
from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.kernels.ref import radicand as _radicand
from repro_torch.kernels.ref import sqrt_rn

__all__ = [
    "lb_euclid",
    "lb_euclid_fast",
    "lb_arccos",
    "lb_mult",
    "lb_mult_fast1",
    "lb_mult_fast2",
    "ub_mult",
    "ub_euclid",
    "ub_arccos",
    "pivot_lower_bound",
    "pivot_upper_bound",
    "LOWER_BOUNDS",
    "JOINT_SLACK",
    "ub_joint",
    "joint_row_upper_bound",
    "BOUND_PROVIDERS",
    "register_bound_provider",
    "block_upper_provider",
]


def lb_euclid(a: Tensor, b: Tensor) -> Tensor:
    """Eq. (7): ``sim >= a + b - 1 - 2*sqrt((1-a)(1-b))``."""
    rad = torch.clamp((1.0 - a) * (1.0 - b), min=0.0)
    return a + b - 1.0 - 2.0 * torch.sqrt(rad)


def lb_euclid_fast(a: Tensor, b: Tensor) -> Tensor:
    """Eq. (8): ``sim >= a + b + 2*min(a,b) - 3`` (sqrt-free, loosest)."""
    return a + b + 2.0 * torch.minimum(a, b) - 3.0


def lb_arccos(a: Tensor, b: Tensor) -> Tensor:
    """Eq. (9): ``sim >= cos(arccos(a) + arccos(b))``."""
    ca = torch.arccos(torch.clamp(a, -1.0, 1.0))
    cb = torch.arccos(torch.clamp(b, -1.0, 1.0))
    return torch.cos(ca + cb)


def lb_mult(a: Tensor, b: Tensor) -> Tensor:
    """Eq. (10): ``sim >= a*b - sqrt((1-a^2)(1-b^2))`` (recommended)."""
    return a * b - sqrt_rn(_radicand(a) * _radicand(b))


def lb_mult_fast1(a: Tensor, b: Tensor) -> Tensor:
    """Eq. (11): ``sim >= a*b + min(a,b)^2 - 1``."""
    m = torch.minimum(a, b)
    return a * b + m * m - 1.0


def lb_mult_fast2(a: Tensor, b: Tensor) -> Tensor:
    """Eq. (12): ``sim >= 2*a*b - |a - b| - 1``."""
    return 2.0 * a * b - torch.abs(a - b) - 1.0


def ub_mult(a: Tensor, b: Tensor) -> Tensor:
    """Eq. (13): ``sim <= a*b + sqrt((1-a^2)(1-b^2))`` — the pruning bound."""
    return a * b + sqrt_rn(_radicand(a) * _radicand(b))


def ub_euclid(a: Tensor, b: Tensor) -> Tensor:
    """Chord-metric upper bound: ``sim <= a + b - 1 + 2*sqrt((1-a)(1-b))``."""
    rad = torch.clamp((1.0 - a) * (1.0 - b), min=0.0)
    return a + b - 1.0 + 2.0 * torch.sqrt(rad)


def ub_arccos(a: Tensor, b: Tensor) -> Tensor:
    """Arccos form of Eq. 13: ``cos(|arccos(a) - arccos(b)|)``."""
    ca = torch.arccos(torch.clamp(a, -1.0, 1.0))
    cb = torch.arccos(torch.clamp(b, -1.0, 1.0))
    return torch.cos(torch.abs(ca - cb))


def pivot_lower_bound(qp: Tensor, dp: Tensor, *, axis: int = -1) -> Tensor:
    """Best (largest) Eq. 10 lower bound over a set of pivots."""
    return torch.amax(lb_mult(qp, dp), dim=axis)


def pivot_upper_bound(qp: Tensor, dp: Tensor, *, axis: int = -1) -> Tensor:
    """Tightest (smallest) Eq. 13 upper bound over a set of pivots."""
    return torch.amin(ub_mult(qp, dp), dim=axis)


#: name -> fn map in the paper's Table 1 order.
LOWER_BOUNDS = {
    "euclidean": lb_euclid,       # Eq. 7
    "eucl_lb": lb_euclid_fast,    # Eq. 8
    "arccos": lb_arccos,          # Eq. 9
    "mult": lb_mult,              # Eq. 10 (recommended)
    "mult_lb1": lb_mult_fast1,    # Eq. 11
    "mult_lb2": lb_mult_fast2,    # Eq. 12
}


# ---------------------------------------------------------------------------
# Joint multi-pivot (projection) upper bound: with an orthonormalized pivot
# basis U, alpha = U q and beta = U y satisfy
#     sim(q, y) <= <alpha, beta> + sqrt((1 - |alpha|^2)(1 - |beta|^2)).
# ---------------------------------------------------------------------------

#: Additive guard for float32 accumulation in the joint bound's dot products.
JOINT_SLACK = 3e-5


def ub_joint(t: Tensor, a_nsq: Tensor, b_nsq: Tensor) -> Tensor:
    """Joint projection bound from ``t = <alpha, beta>`` and clamped norms."""
    rad = torch.clamp(1.0 - a_nsq, min=0.0) * torch.clamp(1.0 - b_nsq, min=0.0)
    return t + torch.sqrt(rad)


def joint_row_upper_bound(alpha: Tensor, beta: Tensor, beta_nsq: Tensor, *,
                          slack: float = JOINT_SLACK) -> Tensor:
    """Per-(query, row) joint bound ``[M, N]`` from ``alpha [M, J]``,
    ``beta [N, J]`` and ``beta_nsq [N]`` (``|beta|^2`` at this depth)."""
    t = alpha @ beta.T
    a_nsq = torch.clamp(torch.sum(alpha * alpha, dim=-1), max=1.0)
    b_nsq = torch.clamp(beta_nsq, max=1.0)
    return ub_joint(t, a_nsq[:, None], b_nsq[None, :]) + slack


#: name -> provider(index, qn, qp, n_pivots) -> [M, NB] block upper bounds.
BOUND_PROVIDERS: dict = {}


def register_bound_provider(name: str):
    """Decorator: register a block upper-bound provider under ``name``."""

    def deco(fn):
        BOUND_PROVIDERS[name] = fn
        return fn

    return deco


def block_upper_provider(name: str):
    """Look up a registered bound provider (KeyError lists known names)."""
    try:
        return BOUND_PROVIDERS[name]
    except KeyError:
        raise KeyError(
            f"unknown bound provider {name!r}; known: {sorted(BOUND_PROVIDERS)}"
        ) from None


@register_bound_provider("eq13")
def _eq13_provider(index, qn: Tensor, qp: Tensor, n_pivots: int = 0) -> Tensor:
    """Interval Eq. 13 bound, intersected over the index's pivots."""
    from repro_torch.kernels import ref as kref

    return kref.block_bounds(qp, index.dp_lo, index.dp_hi)


@register_bound_provider("eq13_multi")
def _eq13_multi_provider(index, qn: Tensor, qp: Tensor, n_pivots: int) -> Tensor:
    """Eq. 13 intervals intersected with the joint n_pivots projection cap."""
    from repro_torch.core.index import multipivot_block_cap
    from repro_torch.kernels import ref as kref

    base = kref.block_bounds(qp, index.dp_lo, index.dp_hi)
    if n_pivots <= 0 or index.ortho is None:
        return base
    return torch.minimum(base, multipivot_block_cap(index, qn, n_pivots=n_pivots))
