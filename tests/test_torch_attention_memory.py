"""flash_attention's memory law against the reference's, on the CPU.

The reference runs each key tile's step under ``jax.checkpoint``
(``src/repro/models/layers.py``: the backward recomputes the score tile
instead of storing one per step); the port runs it under
``layers.checkpointed`` whenever autograd will differentiate the call.

* No tensor that autograd keeps for the backward is a score tile.
* The bytes kept (the unique storages that ``saved_tensors_hooks`` sees)
  are at most ``RESIDUAL_SLACK`` times the reference's ``saved_residuals``
  at three shapes with several query and key tiles: causal, a sliding
  window over padded tiles, and bidirectional with ``kv_valid``.
* Under ``no_grad`` and ``inference_mode``, and on inputs that need no
  gradient, no checkpoint is entered and the output equals the
  differentiated call's bit for bit.
* Through the LM's per-layer checkpoint (the nested case), a train step's
  loss and backward peak below one layer's score tiles (the dry-run's
  ``Counter`` on real tensors).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax._src.ad_checkpoint import saved_residuals  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.launch.dryrun import Counter  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model_fns  # noqa: E402
from repro_torch.train import train_step  # noqa: E402
from tests.test_torch_models import cfgs, family_batch  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small torch ops on one thread (see tests/test_torch_moe.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the port's bytes kept for the backward, at most this times the
#: reference's residual bytes
RESIDUAL_SLACK = 1.05

#: (B, S, H, KV, Dh, keyword args): every case has several query and key
#: tiles; "window" pads both sequences to their tiles
CASES = {
    "causal": (1, 64, 4, 2, 8, dict(causal=True, chunk_q=8, chunk_k=16)),
    "window": (2, 100, 4, 2, 16, dict(causal=True, window=40, chunk_q=16, chunk_k=12)),
    "kv_valid": (2, 48, 4, 1, 8, dict(causal=False, chunk_q=16, chunk_k=16)),
}


def inputs(case, seed=0):
    B, S, H, KV, Dh, kw = CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, S, n, Dh)).astype(np.float32) for n in (H, KV, KV))
    valid = None
    if case == "kv_valid":
        valid = rng.random((B, S)) < 0.8
        valid[:, 0] = True
    return (q, k, v), valid, kw


def port_call(arrays, valid, kw, *, grad=True):
    ts = [torch.from_numpy(a).requires_grad_(grad) for a in arrays]
    out = tl.flash_attention(*ts, **kw,
                             kv_valid=None if valid is None else torch.from_numpy(valid))
    return ts, out


def kept_for_backward(arrays, valid, kw):
    """{storage pointer: (bytes, [shape of each tensor saved there])} of
    the tensors autograd keeps for the call's backward, and the call's
    inputs and output."""
    kept = {}

    def pack(t):
        st = t.untyped_storage()
        kept.setdefault(st.data_ptr(), [st.nbytes(), []])[1].append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        ts, out = port_call(arrays, valid, kw)
    return kept, ts, out


@pytest.mark.parametrize("case", list(CASES))
def test_flash_attention_keeps_no_score_tiles_for_backward(case):
    """Every key tile's step runs under checkpoint: what autograd keeps is
    the steps' inputs (the running max, sum and accumulator, the fp32
    query chunk, views of K/V and kv_valid), never a score, probability or
    mask tile: no saved tensor ends in (cq, ck) or (g·cq, ck), the shapes
    of one (batch, head)'s tile and of one KV head's g heads stacked (no
    case has Dh = ck).  The backward then runs."""
    arrays, valid, kw = inputs(case)
    B, S, H, Dh = arrays[0].shape
    g = H // arrays[1].shape[2]
    cq, ck = min(kw["chunk_q"], S), min(kw["chunk_k"], S)
    assert Dh != ck
    kept, ts, out = kept_for_backward(arrays, valid, kw)
    shapes = {sh for _, shs in kept.values() for sh in shs}
    tiles = {sh for sh in shapes if sh[-2:] in ((cq, ck), (g * cq, ck))}
    assert not tiles, tiles
    out.sum().backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in ts)


@pytest.mark.parametrize("case", list(CASES))
def test_flash_attention_keeps_the_references_residuals(case):
    """The unique bytes the port keeps for the backward, against the
    reference's ``saved_residuals`` of the same call (its
    ``jax.checkpoint(kv_step)`` inside the scans): at most RESIDUAL_SLACK
    times as many."""
    arrays, valid, kw = inputs(case)
    kept, _, _ = kept_for_backward(arrays, valid, kw)
    port = sum(nb for nb, _ in kept.values())
    jvalid = None if valid is None else jnp.asarray(valid)
    res = saved_residuals(lambda q, k, v: jl.flash_attention(q, k, v, **kw, kv_valid=jvalid),
                          *(jnp.asarray(a) for a in arrays))
    ref = sum(int(np.prod(r[0].shape)) * r[0].dtype.itemsize for r in res)
    print(f"{case}: the port keeps {port:,} B, the reference {ref:,} B")
    assert port <= RESIDUAL_SLACK * ref, (port, ref)


def test_flash_attention_enters_no_checkpoint_without_grad(monkeypatch):
    """Under no_grad and inference_mode (serving, prefill, decode) and on
    inputs that need no gradient, the tile steps run with no checkpoint,
    and the output equals the differentiated call's bit for bit; a
    differentiated call enters one checkpoint a tile."""
    import torch.utils.checkpoint as tuc

    entered = []
    real = tuc.checkpoint

    def counted(*a, **kw):
        entered.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(tuc, "checkpoint", counted)
    arrays, valid, kw = inputs("window")
    _, want = port_call(arrays, valid, kw)
    S = arrays[0].shape[1]
    tiles = -(-S // kw["chunk_q"]) * -(-S // kw["chunk_k"])
    assert len(entered) == tiles
    for ctx in (torch.no_grad, torch.inference_mode):
        entered.clear()
        with ctx():
            _, got = port_call(arrays, valid, kw)
        assert not entered, ctx
        assert torch.equal(got, want.detach())
    entered.clear()
    _, got = port_call(arrays, valid, kw, grad=False)
    assert not entered and not got.requires_grad
    assert torch.equal(got, want.detach())


#: the nested case's model: a long sequence over narrow widths (8 heads of
#: 8), so that one layer's score tiles (S x S x H fp32, 32 MiB) outweigh
#: everything else a step keeps
NESTED_S, NESTED_CQ, NESTED_CK, NESTED_H = 1024, 64, 256, 8


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-1.2b"])
def test_train_step_under_layer_remat_keeps_no_score_tiles(arch):
    """The LM's loss and backward with ``cfg.remat`` (each layer under
    checkpoint, the tiles' checkpoints nested inside it, as the
    reference's ``jax.checkpoint(kv_step)`` inside ``jax.checkpoint(body)``;
    zamba2's attention is its shared block): the bytes alive at the peak
    (the dry-run's ``Counter``) lie below one attention layer's score
    tiles, and every gradient is finite (a backward that keeps the tiles
    of the layer being recomputed peaks above them)."""
    _, cfg = cfgs(arch, remat=True, max_seq_len=NESTED_S, n_heads=NESTED_H,
                  d_head=64 // NESTED_H, attn_chunk_q=NESTED_CQ, attn_chunk_k=NESTED_CK,
                  logits_chunk=256)
    batch = family_batch(cfg, 1, NESTED_S)
    batch["labels"] = batch["tokens"]
    model = model_fns(cfg).init(0, device="cpu").requires_grad_(True)
    with Counter() as counter:
        loss, _ = train_step.make_loss_fn(model_fns(cfg), cfg)(model, batch)
        loss.backward()
    tiles = (NESTED_S // NESTED_CQ) * (NESTED_S // NESTED_CK) * cfg.n_heads \
        * NESTED_CQ * NESTED_CK * 4
    print(f"{arch}: peak {counter.peak:,} B, one layer's score tiles {tiles:,} B")
    assert counter.peak < tiles
    assert bool(torch.isfinite(loss))
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
