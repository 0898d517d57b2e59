"""The language model's retrieval hook (counterpart of
:mod:`repro.models.lm`).

Only :func:`embed_hidden` is ported: the kNN-LM datastore
(:mod:`repro_torch.serve.knnlm`) embeds hidden states with it.  The model
itself (init, forward, decode caches) and the rest of ``models/`` wait for
the model slice of the port (ROADMAP.md Queue 1 item 6).
"""
from __future__ import annotations

import torch
from torch import Tensor

__all__ = ["embed_hidden"]


def embed_hidden(params, hidden: Tensor, cfg) -> Tensor:
    """Unit-normalized retrieval embedding of final hidden states
    ``[B, S, D]`` (float32).  ``params`` and ``cfg`` are unused, as in the
    reference, whose signature this keeps for the model slice's callers."""
    h = torch.as_tensor(hidden).float()
    return h / torch.linalg.vector_norm(h, dim=-1, keepdim=True).clamp(min=1e-12)
