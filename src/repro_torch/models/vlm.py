"""InternVL2-style VLM backbone, the vision frontend a stub (counterpart of
:mod:`repro.models.vlm`).

The ViT is not modeled: the inputs carry precomputed patch embeddings
``[B, n_patches, VIT_WIDTH]``.  What is real is the InternVL connector, an
MLP projector from the ViT width into the LM's ``d_model``, followed by the
full language model with the vision tokens prepended (``lm_forward``'s
``extra_embeds``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Norm, _param, dense_init, norm_apply
from repro_torch.models.lm import LM, lm_forward

__all__ = ["VIT_WIDTH", "VLM", "vlm_init", "project_patches", "vlm_forward"]

VIT_WIDTH = 1024   # InternViT-300M output width (stub frontend)


class Projector(nn.Module):
    """``ln`` over ``VIT_WIDTH``, ``w1 [VIT_WIDTH, d]``, ``w2 [d, d]``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None, *,
                 device=None):
        super().__init__()
        dev = gen.device if gen is not None else device
        self.ln = Norm(cfg, VIT_WIDTH, device=dev)
        self.w1 = _param(dense_init(gen, (VIT_WIDTH, cfg.d_model), cfg.p_dtype, device=dev))
        self.w2 = _param(dense_init(gen, (cfg.d_model, cfg.d_model), cfg.p_dtype,
                                    device=dev))


class VLM(LM):
    """The decoder LM's parameters and the ``projector``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None, *,
                 device=None):
        super().__init__(cfg, gen, device=device)
        self.projector = Projector(cfg, gen, device=self.device)


def vlm_init(gen: torch.Generator | int, cfg: ModelConfig, *, device=None) -> VLM:
    """A randomly initialized VLM (``gen`` as in :func:`~repro_torch.models.
    lm.lm_init`)."""
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(resolve_device(device)).manual_seed(int(gen))
    return VLM(cfg, gen)


def project_patches(params: VLM, patches, cfg: ModelConfig) -> Tensor:
    """[B, Sv, VIT_WIDTH] -> [B, Sv, d_model]."""
    pr = params.projector
    patches = torch.as_tensor(patches, device=params.device)
    h = norm_apply(pr.ln, patches.to(cfg.act_dtype), cfg)
    h = F.gelu(h @ pr.w1.to(h.dtype), approximate="tanh")
    return h @ pr.w2.to(h.dtype)


def vlm_forward(params: VLM, patches, tokens, cfg: ModelConfig, **kw):
    """-> (hidden [B, Sv+St, D], cache, aux)."""
    vis = project_patches(params, patches, cfg)
    return lm_forward(params, tokens, cfg, extra_embeds=vis, **kw)
