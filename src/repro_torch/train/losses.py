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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import checkpointed

__all__ = ["chunked_ce"]


def _chunk(h: Tensor, l: Tensor, m: Tensor, head_fn):
    """One chunk's (sum of masked nll, sum of masked lse^2)."""
    logits = head_fn(h).float()                              # [B,c,V]
    lse = torch.logsumexp(logits, dim=-1)                    # [B,c]
    gold = torch.gather(logits, -1, l[..., None])[..., 0]
    return ((lse - gold) * m).sum(), (torch.square(lse) * m).sum()


def chunked_ce(hidden: Tensor, labels, head_fn, cfg: ModelConfig, *,
               mask: Tensor | None = None, z_weight: float = 1e-4, psum=None):
    """hidden [B,S,D], labels [B,S] -> (mean_nll, metrics).

    ``head_fn(hidden_chunk) -> logits_chunk`` (fp32).  ``mask`` [B,S] in
    {0,1} excludes positions (padding / vision prefix) from the loss.
    ``psum`` sums the token sums over the ranks a batch is split over
    (:func:`repro_torch.dist.placement.batch_sum`), so the mean is the
    global batch's, token-weighted.
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
                              head_fn)
        nll_sum, z_sum, n = nll_sum + nll, z_sum + z, n + mask[:, cs].sum()
    if psum is not None:
        nll_sum, z_sum, n = psum(nll_sum), psum(z_sum), psum(n)
    n = torch.clamp(n, min=1.0)
    loss = nll_sum / n + z_weight * z_sum / n
    metrics = {"nll": nll_sum / n, "zloss": z_sum / n, "tokens": n}
    return loss, metrics
