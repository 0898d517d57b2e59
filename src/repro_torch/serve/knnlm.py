"""kNN-LM (Khandelwal et al., ICLR 2020) on the exact search (counterpart
of :mod:`repro.serve.knnlm`).

Datastore: (unit-normalized final hidden state h_t -> next token w_{t+1})
pairs.  At decode, the current hidden state queries the datastore for its
exact top-k cosine neighbours, a temperature softmax over their
similarities becomes a distribution over their next tokens, and
``p = (1 - λ) p_LM + λ p_kNN``.

Every lookup goes through :class:`repro_torch.search.SearchEngine`, so the
backend is engine policy.  The store is online: :meth:`KNNDatastore.
add_pairs` and :meth:`KNNDatastore.delete` mutate it through the engine's
:class:`~repro_torch.core.online.MutableIndex`, and :meth:`KNNDatastore.
frontend` serves it request by request through a
:class:`~repro_torch.serve.frontend.ContinuousBatcher`, and :meth:`
KNNDatastore.from_corpus` harvests a store from a model's own forward pass.

Every entry point takes numpy arrays or tensors on any device: keys,
values and hidden states stay on the device they come from until the
engine moves them to its own, and only the online insert's float64
normalization reads rows on the host.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from repro_torch.core.index import BlockIndex
from repro_torch.models.lm import embed_hidden
from repro_torch.search import SearchEngine
from repro_torch.serve.frontend import ContinuousBatcher

__all__ = ["KNNDatastore"]


class KNNDatastore:
    """A value table (next-token ids, indexed by external row id) over an
    engine.

    Args:
      index: a :class:`SearchEngine`, or a :class:`BlockIndex` that gets
        wrapped in one (``backend``, on the index's device).
      values: ``[n]`` next-token id of each row (numpy or a tensor on any
        device); kept as an int32 tensor on the engine's device.
      vocab: vocabulary size of the distributions :meth:`knn_probs` returns.
      k / temp: neighbours per lookup and the softmax temperature.
      engine: an engine to use instead of ``index``'s.
    """

    def __init__(self, index: BlockIndex | SearchEngine, values, vocab: int, *,
                 k: int = 16, temp: float = 10.0, backend: str = "auto",
                 engine: SearchEngine | None = None):
        if engine is not None:
            self.engine = engine
        elif isinstance(index, SearchEngine):
            self.engine = index
        else:
            self.engine = SearchEngine(index, backend=backend, device=index.device)
        self.values = torch.as_tensor(values, dtype=torch.int32,
                                      device=self.engine.device)
        self.vocab = vocab
        self.k = k
        self.temp = temp

    @property
    def index(self) -> BlockIndex:
        return self.engine.index

    @classmethod
    def from_pairs(cls, embeddings, next_tokens, vocab: int, *, k: int = 16,
                   temp: float = 10.0, backend: str = "auto",
                   engine: SearchEngine | None = None, **build_kw) -> "KNNDatastore":
        """A store over (embedding, next-token) pairs, numpy or tensors on
        any device; ``build_kw`` goes to :meth:`SearchEngine.build` verbatim
        (``n_pivots``, ``block_size``, ``device``, any engine knob).  Pass
        ``engine=`` to skip the build."""
        if engine is None:
            engine = SearchEngine.build(embeddings, backend=backend, **build_kw)
        return cls(engine, next_tokens, vocab, k=k, temp=temp)

    @classmethod
    def from_corpus(cls, fns, params, batches, vocab: int, **kw) -> "KNNDatastore":
        """Harvest (hidden -> next token) pairs with the model itself: each
        batch's final hidden states past ``fns.loss_offset``, unit-normalized
        (:func:`~repro_torch.models.lm.embed_hidden`), are the keys of the
        tokens that follow them.  The keys stay on the model's device, the
        tokens on their batches', and both go to :meth:`from_pairs` (``kw``)
        in one piece."""
        embs, nxt = [], []
        with torch.inference_mode():
            for batch in batches:
                hidden, _, _ = fns.forward(params, batch)
                h = embed_hidden(params, hidden[:, fns.loss_offset(batch):], fns.cfg)
                embs.append(h[:, :-1].reshape(-1, h.shape[-1]))
                nxt.append(torch.as_tensor(batch["tokens"])[:, 1:].reshape(-1))
            keys, toks = torch.cat(embs), torch.cat(nxt)
        del embs
        return cls.from_pairs(keys, toks, vocab, **kw)

    def add_pairs(self, embeddings, next_tokens) -> list[int]:
        """Append (embedding, next-token) pairs to the live store through
        the engine's online handle; the next :meth:`lookup` sees them.
        Returns the new rows' external ids, which index :attr:`values`
        (ids are append-ordered and survive ``reoptimize``).  Mutate the
        store only through these methods: an insert past the store would
        mint ids the value table does not cover.  Both checks run before
        anything is inserted (the reference inserts first)."""
        toks = torch.as_tensor(next_tokens, dtype=torch.int32,
                               device=self.values.device).reshape(-1)
        n = 1 if np.ndim(embeddings) == 1 else len(embeddings)
        if n != toks.shape[0]:
            raise ValueError(f"{n} embeddings but {toks.shape[0]} next_tokens")
        handle = self.engine.online()
        if handle._next_id != self.values.shape[0]:
            raise RuntimeError(
                f"value table has {self.values.shape[0]} rows but the engine "
                f"mints id {handle._next_id} next; the engine was mutated "
                "outside this datastore")
        ids = handle.insert(embeddings)
        self.values = torch.cat([self.values, toks])
        return ids

    def delete(self, ids) -> None:
        """Tombstone-delete rows by external id: ``lookup`` never returns
        them again; their value rows stay (ids are never reused)."""
        self.engine.online().delete(ids)

    def frontend(self, *, max_batch: int = 32,
                 max_wait_ms: float = 2.0) -> ContinuousBatcher:
        """A continuous-batching front end over this store's engine at this
        store's ``k``."""
        return ContinuousBatcher(self.engine, self.k, max_batch=max_batch,
                                 max_wait_ms=max_wait_ms)

    def lookup(self, hidden):
        """``hidden [B, D] -> (sims [B, k], next tokens [B, k], ids [B, k])``
        (token 0 where the id is -1)."""
        sims, ids, _ = self.engine.search(hidden, self.k)
        toks = torch.where(ids >= 0, self.values[ids.clamp(min=0).long()], 0)
        return sims, toks, ids

    def knn_probs(self, hidden) -> Tensor:
        """``[B, vocab]``: the softmax of ``temp · sims`` over the
        neighbours, summed onto their next tokens."""
        sims, toks, ids = self.lookup(hidden)
        w = torch.softmax(self.temp * sims, dim=-1)
        w = torch.where(ids >= 0, w, 0.0)
        w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
        probs = torch.zeros((sims.shape[0], self.vocab), dtype=torch.float32,
                            device=sims.device)
        return probs.scatter_add_(1, toks.long(), w)

    def interpolate(self, hidden, lm_probs, lmbda: float) -> Tensor:
        """``(1 - lmbda) · lm_probs + lmbda · knn_probs(hidden)``."""
        knn = self.knn_probs(hidden)
        return (1.0 - lmbda) * torch.as_tensor(lm_probs, device=knn.device) + lmbda * knn
