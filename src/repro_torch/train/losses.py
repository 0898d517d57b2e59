"""Chunked cross-entropy: never holds the [B, S, V] logits tensor
(counterpart of :mod:`repro.train.losses`).

With V up to 152k and S up to 32k, full logits are the single largest
activation in the model.  The loss therefore loops over sequence chunks of
``cfg.logits_chunk`` tokens: per chunk, project to logits (fp32),
log-softmax, gather the label log-probs, accumulate (sum_nll, count).
With gradients on, each chunk runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of its scan body), so the backward pass
recomputes a chunk's logits instead of keeping them.

Also provides z-loss (softmax normalizer regularization, Chowdhery et al.)
— standard for large-vocab stability.

Vocab-parallel (``vocab=(r, tp, group)``): ``head_fn`` gives this rank's
``V / tp`` logit columns of each chunk, ``[r·V/tp, (r+1)·V/tp)``, and no
rank holds a chunk's whole logits.  The logsumexp is built from three
all-reduces over the group a chunk: the max of the shares (a constant for
the gradient, reduced on a detached tensor), the sum of ``exp(logit −
max)`` and the gold logit (each rank's where the label falls in its
columns, 0 elsewhere), both through
:func:`~repro_torch.dist.placement.all_reduce_sum` (Megatron's ``g``: each
rank's backward reaches its own columns).  They run again, in the same
order on every rank, when the backward recomputes the chunk.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import Tensor

from repro_torch.dist import placement
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import checkpointed

__all__ = ["chunked_ce"]


def _lse_gold(logits: Tensor, l: Tensor, vocab: tuple | None):
    """Per token of ``logits [B,c,V']`` (fp32): (the logsumexp over the
    whole vocabulary, the label's logit).  ``vocab``: None where the
    logits hold every column, else ``(r, tp, group)``, this rank's share
    of the columns (see the module's docstring)."""
    if vocab is None:
        lse = torch.logsumexp(logits, dim=-1)                # [B,c]
        return lse, torch.gather(logits, -1, l[..., None])[..., 0]
    r, _, group = vocab
    n = logits.shape[-1]
    top = logits.detach().amax(dim=-1)
    if group is not None:
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    sum_exp = placement.all_reduce_sum(torch.exp(logits - top[..., None]).sum(-1), group)
    lse = top + torch.log(sum_exp)
    local = l - r * n
    inside = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    return lse, placement.all_reduce_sum(torch.where(inside, gold, 0.0), group)


def _chunk(h: Tensor, l: Tensor, m: Tensor, head_fn, vocab: tuple | None):
    """One chunk's (sum of masked nll, sum of masked lse^2)."""
    lse, gold = _lse_gold(head_fn(h).float(), l, vocab)     # [B,c]
    return ((lse - gold) * m).sum(), (torch.square(lse) * m).sum()


def chunked_ce(hidden: Tensor, labels, head_fn, cfg: ModelConfig, *,
               mask: Tensor | None = None, z_weight: float = 1e-4, psum=None,
               vocab: tuple | None = None):
    """hidden [B,S,D], labels [B,S] -> (mean_nll, metrics).

    ``head_fn(hidden_chunk) -> logits_chunk`` (fp32).  ``mask`` [B,S] in
    {0,1} excludes positions (padding / vision prefix) from the loss.
    ``psum`` sums the token sums over the ranks a batch is split over
    (:func:`repro_torch.dist.placement.batch_sum`), so the mean is the
    global batch's, token-weighted.  ``vocab``: ``(r, tp, group)`` where
    ``head_fn`` gives share ``r`` of ``tp`` of the logit columns (the
    vocab-parallel loss, see the module's docstring; with a group of None
    a share alone, whose statistics are its own).
    """
    B, S, D = hidden.shape
    dev = hidden.device
    labels = torch.as_tensor(labels, device=dev).long()      # the gather's int64
    mask = (torch.ones((B, S), dtype=torch.float32, device=dev) if mask is None
            else torch.as_tensor(mask, device=dev).float())
    c = min(cfg.logits_chunk, S)
    pad = (-S) % c
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    remat = torch.is_grad_enabled()
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    nll_sum, z_sum, n = zero, zero, zero
    for i in range(hidden.shape[1] // c):
        cs = slice(i * c, (i + 1) * c)
        nll, z = checkpointed(_chunk, remat, hidden[:, cs], labels[:, cs], mask[:, cs],
                              head_fn, vocab)
        nll_sum, z_sum, n = nll_sum + nll, z_sum + z, n + mask[:, cs].sum()
    if psum is not None:
        nll_sum, z_sum, n = psum(nll_sum), psum(z_sum), psum(n)
    n = torch.clamp(n, min=1.0)
    loss = nll_sum / n + z_weight * z_sum / n
    metrics = {"nll": nll_sum / n, "zloss": z_sum / n, "tokens": n}
    return loss, metrics
