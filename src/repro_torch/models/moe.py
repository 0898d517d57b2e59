"""Mixture-of-Experts FFN: top-k routing, sort-based capacity dispatch
(counterpart of :mod:`repro.models.moe`).

Capacity: each expert takes at most ``C = ceil(T * top_k * cf / E)`` tokens;
overflow tokens fall back to their residual stream (token-dropping
semantics, GShard/Switch).  With ``no_drop`` (the cache path) ``C = T``, so
no token is dropped and cached decoding equals teacher forcing.  The router
and its softmax run in fp32; the Switch load-balancing loss is returned.

The dispatch is the reference's, op for op: a stable argsort of the flat
expert ids, counts per expert for the segment starts, a buffer of ``E * C`` rows
plus one trash row that overflow tokens are written to, a batched expert
einsum, and the combine.  The reference combines with a scatter-add over
the tokens; here each assignment's weighted row goes back to its place in
the flat ``[T*K]`` order and each token sums its ``K`` rows, so the sum
has one fixed order on every device (no atomics) and decoding twice from
one cache gives the same tokens.  ``experts`` forces the routing: the
router's probabilities still weight the given experts (used to replay one
path's expert choices into another).

Two execution modes share one math path (:func:`_moe_tokens`), as in the
reference: the local path, and on a mesh (:func:`_moe_sharded`) the
tokens of each ``(pod, data)`` shard stay on their rank, the experts'
``d_ff`` is split over ``"model"``, and the one collective is an
all-reduce of the expert outputs over ``"model"`` per layer.  The
reference's ``shard_map`` becomes explicit collectives on the local
tensors (:mod:`repro_torch.dist.placement`): the expert input enters the
split computation through ``copy_to_group`` (its gradient summed over
``"model"``) and the outputs leave through ``all_reduce_sum``.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from repro_torch.dist import placement
from repro_torch.dist import sharding as shd
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.layers import _param, dense_init

__all__ = ["MoE", "moe_init", "moe_apply"]


class MoE(nn.Module):
    """``router [d, E]`` (fp32) and ``experts.{up, gate, down}``
    (``[E, d, f]``, ``[E, d, f]``, ``[E, f, d]``; the gate for swiglu and
    geglu).  On a mesh its placed parameters are gathered by
    :func:`moe_apply`, not by the layer around it."""

    gathers_own_params = True

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None, *,
                 device=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
        dev = gen.device if gen is not None else device
        self.cfg = cfg
        self.router = _param(dense_init(gen, (d, e), torch.float32, device=dev))
        experts = {"up": dense_init(gen, (e, d, f), cfg.p_dtype, device=dev),
                   "down": dense_init(gen, (e, f, d), cfg.p_dtype, device=dev)}
        if cfg.mlp_kind in ("swiglu", "geglu"):
            experts["gate"] = dense_init(gen, (e, d, f), cfg.p_dtype, device=dev)
        self.experts = nn.ParameterDict({n: _param(t) for n, t in experts.items()})

    def forward(self, x: Tensor, cfg: ModelConfig | None = None, *, no_drop: bool = False,
                experts: Tensor | None = None):
        return moe_apply(self, x, self.cfg if cfg is None else cfg, no_drop=no_drop,
                         experts=experts)


def moe_init(gen: torch.Generator | None, cfg: ModelConfig, *, device=None) -> MoE:
    return MoE(cfg, gen, device=device)


def _capacity(t: int, m: MoEConfig) -> int:
    return max(1, math.ceil(t * m.top_k * m.capacity_factor / m.n_experts))


def _route(p: MoE, x: Tensor, cfg: ModelConfig, experts: Tensor | None = None):
    """x [T, D] -> (probs [T, E] fp32, gate weights [T, K] renormalized,
    gate experts [T, K]): the router's softmax and its top ``K``, or the
    given ``experts [T, K]`` weighted by their probabilities."""
    logits = x.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)
    if experts is None:
        gate_w, gate_e = torch.topk(probs, cfg.moe.top_k, dim=-1)
    else:
        gate_e = experts.to(device=probs.device, dtype=torch.int64)
        gate_w = probs.gather(1, gate_e)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gate_w, gate_e


def _counts(flat_e: Tensor, n_experts: int) -> Tensor:
    """Assignments per expert ``[E]`` (int64): ``bincount`` with a static
    length, so a shape-only run (the dry-run's fake tensors) can follow
    it."""
    return torch.zeros(n_experts, dtype=torch.int64, device=flat_e.device).scatter_add_(
        0, flat_e.long(), torch.ones_like(flat_e, dtype=torch.int64))


def _dispatch(gate_e: Tensor, n_experts: int, capacity: int):
    """The sort-based capacity dispatch of the flat ``[T*K]`` assignments:
    (order, keep, buffer slot, token of each sorted assignment).  Each
    expert keeps its first ``capacity`` assignments in token order; the
    rest go to the trash slot ``E * C``."""
    tk = gate_e.numel()
    flat_e = gate_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = _counts(flat_e, n_experts)
    seg_start = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(tk, device=gate_e.device) - seg_start[sorted_e]
    keep = pos_in_e < capacity
    trash = n_experts * capacity
    buf_slot = torch.where(keep, sorted_e * capacity + pos_in_e, trash)
    token_of = order // gate_e.shape[1]
    return order, keep, buf_slot, token_of


def _moe_tokens(p: MoE, x: Tensor, cfg: ModelConfig, *, no_drop: bool = False,
                experts: Tensor | None = None, psum_group=None):
    """Core MoE on a flat token batch x: [T, D] -> ([T, D], aux_loss);
    ``experts [T, K]`` forces the routing (see :func:`_route`).  With
    ``psum_group`` (the mesh path, ``d_ff`` split over the group) the
    expert outputs' partial sums are reduced over it."""
    m = cfg.moe
    T, D = x.shape
    E, K = m.n_experts, m.top_k
    C = T if no_drop else _capacity(T, m)

    probs, gate_w, gate_e = _route(p, x, cfg, experts)

    # ---- load-balancing aux loss (Switch): E * sum_e f_e * p_e --------
    me = probs.mean(0)
    assign = _counts(gate_e.reshape(-1), E).float()
    aux = E * torch.sum(assign / (T * K) * me)

    # ---- sort-based capacity dispatch ---------------------------------
    order, keep, buf_slot, token_of = _dispatch(gate_e, E, C)
    xbuf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    xbuf[buf_slot] = x[token_of]
    xbuf = placement.copy_to_group(xbuf[: E * C].view(E, C, D), psum_group)

    # ---- expert computation (batched over E) ---------------------------
    up = torch.bmm(xbuf, p.experts["up"].to(x.dtype))
    if "gate" in p.experts:
        g = torch.bmm(xbuf, p.experts["gate"].to(x.dtype))
        act = F.silu(g) if cfg.mlp_kind == "swiglu" else F.gelu(g, approximate="tanh")
        hidden = act * up
    else:
        hidden = F.gelu(up, approximate="tanh")
    ybuf = torch.bmm(hidden, p.experts["down"].to(x.dtype))
    ybuf = placement.all_reduce_sum(ybuf, psum_group)             # TP reduce

    # ---- combine back ---------------------------------------------------
    yflat = torch.cat([ybuf.reshape(E * C, D), ybuf.new_zeros((1, D))], 0)
    contrib = yflat[buf_slot]                                 # the trash row for dropped
    w = (gate_w.reshape(-1)[order] * keep).to(contrib.dtype)  # dropped -> 0
    out = torch.empty_like(contrib)
    out[order] = contrib * w[:, None]                         # back to [T*K] order
    return out.view(T, K, D).sum(1).to(x.dtype), aux


def _gathered(p: MoE, keep: tuple = ()) -> SimpleNamespace:
    """``p``'s weights for this rank's compute (the module itself where
    they are not placed): the router whole, the experts whole except on
    the mesh axes in ``keep``."""
    return SimpleNamespace(router=placement.gather(p.router),
                           experts={n: placement.gather(w, keep)
                                    for n, w in p.experts.items()})


def moe_apply(p: MoE, x: Tensor, cfg: ModelConfig, *, no_drop: bool = False,
              experts: Tensor | None = None):
    """[B, S, D] -> ([B, S, D], aux).  Chooses the mesh or the local path
    by context; ``experts [B, S, K]`` forces the routing (see
    :func:`_route`).

    The mesh path needs rules with ``expert_ffn`` mapped and a batch split
    over the data axes (the train step's ``placement.batch_split``; the
    reference's ``B % dp_size == 0``).  A batch that is not split (the
    reference's small decode batches) takes the local path with the whole
    experts, as the reference's does."""
    B, S, D = x.shape
    if experts is not None:
        experts = experts.reshape(B * S, -1)
    if shd.active() and shd.rule("expert_ffn") and placement.split_axes():
        y, aux = _moe_sharded(p, x.reshape(B * S, D), cfg, no_drop=no_drop, experts=experts)
    else:
        w = _gathered(p) if placement.is_dtensor(p.router) else p
        y, aux = _moe_tokens(w, x.reshape(B * S, D), cfg, no_drop=no_drop, experts=experts)
    return y.view(B, S, D), aux


def _moe_sharded(p: MoE, x: Tensor, cfg: ModelConfig, *, no_drop: bool = False,
                 experts: Tensor | None = None):
    """The reference's ``shard_map`` body on this rank's tokens ``x [T,
    D]``: capacity from the local token count, the experts' ``d_ff`` split
    over ``"model"`` where their placement splits it (one all-reduce of
    the outputs), the aux loss averaged over the data axes."""
    mesh = shd.get_mesh()
    dp = placement.split_axes()
    w = _gathered(p, keep=("model",))
    tp_split = placement.is_dtensor(p.experts["up"]) and any(
        pl.is_shard() for name, pl in zip(mesh.mesh_dim_names, p.experts["up"].placements)
        if name == "model")
    group = placement.axes_group(mesh, ("model",)) if tp_split else None
    y, aux = _moe_tokens(w, x, cfg, no_drop=no_drop, experts=experts, psum_group=group)
    n_dp = math.prod(shd.mesh_shape(mesh)[a] for a in dp)
    return y, placement.all_reduce_sum(aux / n_dp, placement.axes_group(mesh, dp))
