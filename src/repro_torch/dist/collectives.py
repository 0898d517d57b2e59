"""Tiny exact-search collectives over ``torch.distributed`` (counterpart of
:mod:`repro.dist.collectives`).

The sharded datastore pattern: every shard computes its exact local top-k,
then the global top-k is the top-k of the union: ``O(shards * k)`` values
on the wire, negligible next to the score matmuls the pruning avoided.

Each rank holds ``L`` shards and passes their candidate lists stacked as
``[L, m, k]``; the lists are all-gathered over ``group`` in rank order, so
the union is ``[m, S * k]`` in global shard order whatever the split of the
``S`` shards over ranks (ranks own contiguous shard ranges,
:func:`repro_torch.core.distributed.local_shard_rows`).  ``group=None``, or
a group of one rank, runs the same code with no collective.  Empty slots
carry ``(-inf, -1)``; they lose to every real candidate.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import Tensor

__all__ = ["gather_shards", "topk_allgather_merge", "masked_topk_merge",
           "global_tau_merge"]


def gather_shards(x: Tensor, group=None) -> Tensor:
    """``[L, ...]`` on each rank -> ``[W * L, ...]``, rank-major (``W``
    ranks in ``group``); ``x`` itself without a group or with one rank."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def _stacked(x: Tensor) -> Tensor:
    return x[None] if x.ndim == 2 else x


def topk_allgather_merge(sims: Tensor, ids: Tensor, k: int, group=None):
    """Merge per-shard ``(sims, ids)`` (``[L, m, k]``, or ``[m, k]`` for one
    shard) into the global top-k ``(sims [m, k], ids [m, k])``.

    Gathers the candidate sets over ``group`` and runs ``torch.topk`` on the
    ``[m, S * k]`` union.  Exact: every shard's true local top-k is in the
    union, and the global top-k is a subset of the union of local top-k
    sets.  ``ids`` is any payload riding along with its score.
    """
    s = gather_shards(_stacked(sims), group)       # [S, m, k]
    g = gather_shards(_stacked(ids), group)
    m = s.shape[1]
    s = s.transpose(0, 1).reshape(m, -1)            # [m, S * k]
    g = g.transpose(0, 1).reshape(m, -1)
    top_s, pos = torch.topk(s, k, dim=1)
    return top_s, g.gather(1, pos)


def masked_topk_merge(sims: Tensor, valid: Tensor, k: int, group=None):
    """Mask-carrying top-k merge: like :func:`topk_allgather_merge`, with the
    boolean validity mask as the payload.  Invalid entries are masked to
    ``-inf`` first; the returned mask tells "k-th best of >= k real
    candidates" from "ran out of candidates", which a bare ``-inf`` cannot
    once scores are compared across shards."""
    return topk_allgather_merge(sims.masked_fill(~valid, float("-inf")), valid, k,
                                group)


def global_tau_merge(sims: Tensor, valid: Tensor, k: int, group=None) -> Tensor:
    """Global τ: the k-th best of the union of per-shard candidates,
    ``[m]``, or ``-inf`` for queries whose union holds fewer than k real
    candidates.  Each entry is the exact score of a real row, so τ is a
    true lower bound on the final global k-th best similarity, and a block
    whose ``ub + margin < τ`` on any shard holds no global top-k member
    (the reference's DESIGN.md §3.6)."""
    top_s, top_v = masked_topk_merge(sims, valid, k, group)
    return torch.where(top_v[:, -1], top_s[:, -1], float("-inf"))
