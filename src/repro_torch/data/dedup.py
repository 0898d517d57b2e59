"""Near-duplicate filtering through the exact search (counterpart of
:mod:`repro.data.dedup`).

Documents are embedded (any encoder; tests use hashed bag-of-tokens
projections) and pairs with cosine >= 1 - eps are deduplicated.  Duplicate
thresholds lie close to 1, the regime where the Eq. 13 bound prunes most.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.search import SearchEngine

__all__ = ["embed_tokens", "find_near_duplicates", "dedup_mask"]


def embed_tokens(tokens: np.ndarray, dim: int = 256, seed: int = 0) -> np.ndarray:
    """Hashed bag-of-tokens embedding ``[n_docs, dim]`` (deterministic;
    numpy, a copy of the reference's)."""
    n, s = tokens.shape
    out = np.zeros((n, dim), np.float32)
    # feature-hash each token id into dim buckets with +-1 signs
    h = (tokens.astype(np.int64) * 2654435761) % dim
    sign = np.where(((tokens.astype(np.int64) * 40503) % 2) == 0, 1.0, -1.0)
    for i in range(n):
        np.add.at(out[i], h[i], sign[i])
    return out


def find_near_duplicates(embeddings, *, threshold: float = 0.95, k: int = 8,
                         n_pivots: int = 16, block_size: int = 128, device=None):
    """``(pairs [(i, j), ...] with i < j and sim >= threshold, stats)``.

    Builds an engine over the embeddings (numpy, or a tensor on any device)
    on ``device`` (``None`` means CUDA, and raises without a GPU) and
    searches every document's ``k`` nearest others (``k + 1`` with its
    self-match); only the hits come back to the host."""
    emb = torch.as_tensor(embeddings, dtype=torch.float32)
    eng = SearchEngine.build(emb, n_pivots=n_pivots, block_size=block_size,
                             device=device)
    sims, ids, stats = eng.search(emb, k + 1)
    rows = torch.arange(ids.shape[0], device=ids.device)[:, None].expand_as(ids)
    hit = (ids >= 0) & (ids != rows) & (sims >= threshold)
    pairs = np.unique(torch.stack([torch.minimum(rows, ids)[hit],
                                   torch.maximum(rows, ids)[hit]], 1).cpu().numpy(),
                      axis=0)
    return [(int(i), int(j)) for i, j in pairs], stats


def dedup_mask(n: int, pairs) -> np.ndarray:
    """Keep-mask: for each duplicate pair drop the larger index."""
    keep = np.ones((n,), bool)
    for i, j in pairs:
        if keep[i] and keep[j]:
            keep[j] = False
    return keep
