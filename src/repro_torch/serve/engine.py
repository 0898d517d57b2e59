"""Serving engine: batched prefill + KV-cache decode, optional kNN-LM
(counterpart of :mod:`repro.serve.engine`).

``prefill`` runs the model over the prompt tokens through the cache-filling
path (attention writes K/V as it goes; SSM/RWKV states carry forward), so
a following ``decode`` continues exactly.  Sampling is greedy or
temperature; the kNN-LM hook (the paper's technique in the serving layer)
interpolates next-token distributions with datastore neighbours — see
:mod:`repro_torch.serve.knnlm`.

There is no ``jax.jit``: each step runs eagerly under
``torch.inference_mode()``; attention K/V are written into the cache in
place, recurrent states are replaced (:mod:`repro_torch.models.lm`).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.lm import lm_forward
from repro_torch.models.registry import ModelFns
from repro_torch.models.vlm import project_patches

__all__ = ["Engine"]


class Engine:
    def __init__(self, fns: ModelFns, params, *, max_seq: int,
                 knn: "Any | None" = None, lmbda: float = 0.25):
        self.fns = fns
        self.params = params
        self.cfg = fns.cfg
        self.max_seq = max_seq
        self.knn = knn
        self.lmbda = lmbda

    # -------------------------------------------------------------- prefill
    def prefill(self, batch: dict):
        """Prompt batch -> (cache, cache_len, last_hidden [B, D]).

        For ``whisper`` the encoder runs inside ``cache_init`` (the cross
        K/V) and the decoder takes the prompt; for ``vlm`` the projected
        patches and the prompt go through the cache path together, so the
        cache holds ``Sv + St`` positions."""
        with torch.inference_mode():
            toks = torch.as_tensor(batch["tokens"], device=self.params.device)
            cache = self.fns.cache_init(self.params, batch, toks.shape[0], self.max_seq)
            if self.fns.kind == "vlm":
                vis = project_patches(self.params, batch["patches"], self.cfg)
                hidden, cache, _ = lm_forward(self.params, toks, self.cfg, extra_embeds=vis,
                                              cache=cache, cache_len=0)
                return cache, vis.shape[1] + toks.shape[1], hidden[:, -1]
            hidden, cache = self.fns.decode_step(self.params, toks, cache, 0)
        return cache, toks.shape[1], hidden[:, -1]

    # --------------------------------------------------------------- decode
    def _decode_step(self, params, tokens, cache, cache_len):
        hidden, cache = self.fns.decode_step(params, tokens, cache, cache_len)
        logits = self.fns.lm_head(params, hidden)[:, -1]     # [B, V]
        return hidden[:, -1], logits, cache

    def decode(self, cache, cache_len: int, first_tokens, n_steps: int, *,
               temperature: float = 0.0, seed: int = 0):
        """Greedy/temperature decode.  Returns (tokens [B, n] int32, cache).

        Temperature sampling draws from a ``torch.Generator`` seeded with
        ``seed`` on the model's device."""
        out = []
        with torch.inference_mode():
            toks = torch.as_tensor(first_tokens, device=self.params.device)
            gen = torch.Generator(toks.device).manual_seed(seed)
            for _ in range(n_steps):
                hidden, logits, cache = self._decode_step(
                    self.params, toks, cache, cache_len)
                probs = torch.softmax(logits, dim=-1)
                if self.knn is not None:
                    probs = self.knn.interpolate(hidden, probs, self.lmbda)
                if temperature > 0:
                    logp = torch.log(probs.clamp(min=1e-20)) / temperature
                    nxt = torch.multinomial(torch.softmax(logp, dim=-1), 1,
                                            generator=gen)[:, 0]
                else:
                    nxt = torch.argmax(probs, dim=-1)
                toks = nxt[:, None].to(torch.int32)
                out.append(toks)
                cache_len = cache_len + 1
        return torch.cat(out, dim=1), cache
