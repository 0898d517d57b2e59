"""Attention and the GLU MLP computed per share of ``"model"``
(``placement.model_split``), one process computing each share in turn
(a part whose group is None: no collective).

* The shares' outputs, summed, and their parameter and input gradients,
  summed (the all-reduces of Megatron's ``g`` and ``f``, and the gather's
  sum over ``"model"``, done by hand here), equal the whole layer's within
  ``SUM_RTOL`` of each tensor's largest magnitude.  Smoke configs in
  float64 (attention's tiles stay fp32, as in every dtype): tinyllama (one
  KV head: whole at tp 2 and 4), granite-moe (two KV heads: split at 2,
  whole at 4), qwen2.5 (qkv biases), whisper (non-causal, a GELU MLP), and
  6 query heads over 2 KV heads padded to 4 a group (``q_group_pad``) with
  the KV heads repeated, at tp 2, 4 and 8 (at 8 two shares hold only
  padding).
* Each share's FLOPs (``torch.utils.flop_counter``, forward and backward)
  are at most the whole's / tp, plus, for attention, the K/V projection
  where the KV heads stay whole; ``flash_attention`` sees ``n_heads / tp``
  query heads.
* The head's shares (``lm.lm_head_apply`` under a part: share ``r``'s
  ``V / tp`` logit columns, from an untied ``lm_head.w``'s columns or the
  tied ``embed.table``'s rows), concatenated, equal the whole head's
  logits within ``SUM_RTOL``; the vocab-parallel cross-entropy combined by
  hand from the shares (``chip_smoke.head_loss_by_hand``: the max over
  the shares, the sum of their ``exp(logit - max)``, the gold logit from
  the share holding the label) equals ``chunked_ce`` on the whole logits, and its hidden-state and
  weight gradients, summed over the shares, the whole head's; each
  share's FLOPs are at most the whole head's / tp.  Float64 smoke
  configs at tp 2 and 4.
* rwkv6's time mix and channel mix (``rwkv.rwkv6_time_mix`` /
  ``rwkv6_channel_mix`` under a part: the share's heads, its ``d_ff / tp``
  key columns) and the cache-free Mamba2 layer (``ssm.mamba2_apply``: the
  share's SSD heads) the same way, float64 smoke configs: the time mix at
  tp 2 and 4, by the scan and the chunked form, and from a cache (the
  shares' new ``wkv_state`` rows, concatenated, the whole's); the channel
  mix at tp 2 and 4, with and without a cache; the SSD at tp 2, 4 and 8,
  with one B/C group, two (each share's heads read one group, or half of
  its heads each) and, at 12 heads over 3 groups, a share whose heads
  read its groups unevenly (one group per head).  The SSD's gate norm
  sums its statistic over the group (``placement.sum_over_group``), which
  one process feeds by hand (``chip_smoke.split_shares``).  The layers'
  recurrences and norms run in fp32 in every dtype and some of their
  parameters are float32 (rwkv6's ``w0`` and ``u``, the SSD's ``A_log``,
  ``dt_bias`` and ``D``), so a float32 gradient is held to
  ``FP32_SUM_RTOL``: the whole layer's own ``A_log`` gradient moves by
  1.6e-6 of its largest when its input is perturbed by 1e-7, relative.
  Each share's FLOPs are at most the whole's / tp plus the parts every
  share computes whole: the token-shift and decay LoRAs of the time mix,
  ``cm_r`` of the channel mix, the B/C columns of the SSD's ``in_proj``.
* The split choice (:func:`repro_torch.models.layers.tp_plan`: query
  heads, KV heads, ffn columns, vocab columns, rwkv6's heads, gate
  channels and channel-mix columns, the SSD's heads, split or whole)
  equals the reference's ``sanitize`` of its activation annotations
  (``shd.shard(q, "batch", None, "heads", None)``, ``kv_heads``, ``ffn``,
  the logits' ``vocab``; rwkv6's ``heads`` on r, k, v, w and ``ffn`` on
  the gate, the gated output and the channel mix's key; the SSD input's
  ``heads``), read by tracing its ``attn_apply``, ``mlp_apply`` and
  ``lm_head_apply``, and where the arch has them ``rwkv6_apply`` (with and
  without a cache) and ``mamba2_apply``, with ``jax.eval_shape`` at full
  size under its rules on ``AbstractMesh``es, recorded per layer (the
  three layers' ``"heads"`` are three different dims), for every arch on
  the pod and multipod meshes, at the arch's own config and at the
  train_4k, prefill_32k and decode_32k cells' (``launch.dryrun.prepare_cfg``:
  the KV heads repeated for ``"model"``).
"""
from __future__ import annotations

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

import chip_smoke  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.dist import sharding as j_shd  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models import rwkv as j_rwkv  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.dist import placement  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import layers, lm, model_fns, rwkv, ssm  # noqa: E402
from repro_torch.models.config import SSMConfig  # noqa: E402
from repro_torch.train.losses import chunked_ce  # noqa: E402

SUM_RTOL = 1e-6
FP32_SUM_RTOL = 1e-5
B, S = 2, 24
PAD = dict(n_heads=6, n_kv_heads=2, q_group_pad=4, kv_repeat=2, d_head=16)
CASES = [("tinyllama-1.1b", {}, 2), ("tinyllama-1.1b", {}, 4),
         ("granite-moe-1b-a400m", {}, 2), ("granite-moe-1b-a400m", {}, 4),
         ("qwen2.5-14b", {}, 2), ("whisper-small", {}, 4),
         ("tinyllama-1.1b", PAD, 2), ("tinyllama-1.1b", PAD, 4),
         ("tinyllama-1.1b", dict(PAD, kv_repeat=4), 8)]
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def layer_and_fn(cfg, which):
    """(the module, ``x -> y``) of a smoke attention or MLP, weights from a
    seed (qkv biases drawn too, the init's are zero)."""
    gen = torch.Generator().manual_seed(3)
    if which == "mlp":
        m = layers.MLP(cfg, gen).requires_grad_(True)
        return m, lambda x: layers.mlp_apply(m, x, cfg)
    m = layers.Attention(cfg, gen).requires_grad_(True)
    if cfg.qkv_bias:
        with torch.no_grad():
            for b in (m.bq, m.bk, m.bv):
                b.copy_(torch.randn(b.shape, generator=gen, dtype=b.dtype))
    causal = cfg.name != "whisper-small"
    return m, lambda x: layers.attn_apply(m, x, cfg, causal=causal)[0]


def inputs(cfg, dtype):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(B, S, cfg.d_model))).to(dtype)
    dy = torch.from_numpy(rng.normal(size=(B, S, cfg.d_model))).to(dtype)
    return x, dy


def grads(m, fn, x, dy, parts):
    """(the output, the input's gradient, each parameter's gradient), each
    summed over the shares ``parts`` (None: the whole layer)."""
    for p in m.parameters():
        p.grad = None
    xg = x.clone().requires_grad_(True)
    total = 0
    for part in parts:
        with placement.model_split(part=part) if part else contextlib.nullcontext():
            y = fn(xg)
        (y * dy).sum().backward()
        total = total + y.detach()
    return total, xg.grad, {n: p.grad.clone() for n, p in m.named_parameters()}


def assert_close_to(got, want, what):
    """``got`` within ``SUM_RTOL`` of ``want``'s largest magnitude."""
    top = float(want.abs().max())
    assert top > 0, what
    err = float((got - want).abs().max())
    assert err <= SUM_RTOL * top, (what, err, top)


@pytest.mark.parametrize("which", ["attn", "mlp"])
@pytest.mark.parametrize("arch,over,tp", CASES,
                         ids=[f"{a.split('-')[0]}{'-pad' if o else ''}{o.get('kv_repeat', '')}-tp{t}"
                              for a, o, t in CASES])
def test_shares_sum_to_the_whole_layer(arch, over, tp, which):
    cfg = smoke_config(arch).replace(dtype="float64", **over)
    m, fn = layer_and_fn(cfg, which)
    x, dy = inputs(cfg, torch.float64)
    want = grads(m, fn, x, dy, [None])
    got = grads(m, fn, x, dy, [(r, tp, None) for r in range(tp)])
    pairs = [("y", got[0], want[0]), ("dx", got[1], want[1])]
    pairs += [(f"d{n}", got[2][n], want[2][n]) for n in want[2]]
    for name, a, b in pairs:
        assert_close_to(a, b, name)


@pytest.mark.parametrize("tp", [2, 4])
def test_share_flops_and_heads(tp, monkeypatch):
    """tinyllama's smoke config (4 query heads, 1 KV head), float32."""
    cfg = smoke_config("tinyllama-1.1b").replace(dtype="float32")
    x, dy = inputs(cfg, torch.float32)
    seen = []
    flash = layers.flash_attention

    def spy(q, *a, **kw):
        seen.append(q.shape[2])
        return flash(q, *a, **kw)

    monkeypatch.setattr(layers, "flash_attention", spy)
    d, kvd = cfg.d_model, cfg.n_kv_heads * cfg.head_dim
    # K and V's projections, forward and both backward products
    kv_flops = 3 * 2 * (2 * B * S * d * kvd)
    for which, extra in (("attn", kv_flops), ("mlp", 0)):
        m, fn = layer_and_fn(cfg, which)
        counts = []
        for part in (None, (0, tp, None), (tp - 1, tp, None)):
            seen.clear()
            with FlopCounterMode(display=False) as fc:
                grads(m, fn, x, dy, [part])
            counts.append(fc.get_total_flops())
            if which == "attn":
                assert set(seen) == {cfg.n_heads if part is None else cfg.n_heads // tp}
        whole, *shares = counts
        for share in shares:
            assert 0 < share <= whole / tp + extra, (which, share, whole)
        if which == "attn":
            assert all(share < whole / 1.5 for share in shares)


def head_model(tied: bool):
    """A float64 smoke LM (tinyllama's, tied or not: its head is what is
    used) with gradients on, and hidden states and labels from a seed."""
    cfg = smoke_config("tinyllama-1.1b").replace(dtype="float64", tie_embeddings=tied)
    model = model_fns(cfg).init(7, device="cpu").requires_grad_(True)
    rng = np.random.default_rng(2)
    hidden = torch.from_numpy(rng.normal(size=(B, S, cfg.d_model)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    return cfg, model, hidden, labels


def head_grads(model, cfg, hidden, loss_fn):
    """(the loss, the hidden states' gradient, the head weight's)."""
    name = "embed.table" if cfg.tie_embeddings else "lm_head.w"
    w = dict(model.named_parameters())[name]
    w.grad = None
    h = hidden.clone().requires_grad_(True)
    loss = loss_fn(h)
    loss.backward()
    return loss.detach(), h.grad, w.grad.clone()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_head_shares_concatenate_to_the_whole_head(tied, tp):
    cfg, model, hidden, labels = head_model(tied)
    n = cfg.vocab // tp
    with torch.no_grad():
        whole = lm.lm_head_apply(model, hidden, cfg)
        shares = []
        for r in range(tp):
            with placement.model_split(part=(r, tp, None)):
                assert lm.vocab_part(cfg) == (r, tp, None)
                shares.append(lm.lm_head_apply(model, hidden, cfg))
    assert all(x.shape == (B, S, n) for x in shares)
    assert_close_to(torch.cat(shares, -1), whole, "logits")

    # the vocab-parallel loss, its three reductions over the shares by hand
    want = head_grads(model, cfg, hidden, lambda h: chunked_ce(
        h, labels, lambda c: lm.lm_head_apply(model, c, cfg), cfg)[0])
    got = head_grads(model, cfg, hidden,
                     lambda h: chip_smoke.head_loss_by_hand(model, h, labels, cfg, tp))
    for what, a, b in zip(("loss", "dhidden", "dweight"), got, want):
        assert_close_to(a, b, what)

    # each share's FLOPs, forward and backward
    counts = []
    for part in (None, (0, tp, None), (tp - 1, tp, None)):
        with FlopCounterMode(display=False) as fc:
            split = placement.model_split(part=part) if part else contextlib.nullcontext()
            with split:
                h = hidden.clone().requires_grad_(True)
                lm.lm_head_share(model, h, cfg).sum().backward()
        counts.append(fc.get_total_flops())
    whole_flops, *share_flops = counts
    assert all(0 < f <= whole_flops / tp for f in share_flops), counts


def assert_shares_match(got, want, what=""):
    """The shares' sums (``chip_smoke.split_shares``) against the whole
    layer's: the output, the input's gradient, every parameter's gradient
    (a float32 one within ``FP32_SUM_RTOL``)."""
    pairs = [("y", got[0], want[0]), ("dx", got[1], want[1])]
    assert set(got[2]) == set(want[2]), what
    pairs += [(f"d{n}", got[2][n], want[2][n]) for n in want[2]]
    for name, a, b in pairs:
        top = float(b.abs().max())
        assert top > 0, (what, name)
        tol = FP32_SUM_RTOL if b.dtype == torch.float32 else SUM_RTOL
        err = float((a - b).abs().max())
        assert err <= tol * top, (what, name, err, top)


def rwkv_block(cached: bool):
    """A float64 rwkv6 smoke block with gradients on, and a cache from a
    seed (None without one)."""
    cfg = smoke_config("rwkv6-1.6b").replace(dtype="float64")
    m = rwkv.RWKV6(cfg, torch.Generator().manual_seed(3)).requires_grad_(True)
    cache = None
    if cached:
        g = torch.Generator().manual_seed(4)
        h, d = cfg.n_heads, cfg.d_model
        cache = {"shift_tm": torch.randn((B, 1, d), generator=g, dtype=torch.float64),
                 "shift_cm": torch.randn((B, 1, d), generator=g, dtype=torch.float64),
                 "wkv_state": torch.randn((B, h, d // h, d // h), generator=g) * 0.1}
    return cfg, m, cache


RWKV_CASES = [("time", 2, False, False), ("time", 4, False, False), ("time", 2, True, False),
              ("time", 4, True, False), ("time", 2, False, True), ("time", 4, False, True),
              ("channel", 2, False, False), ("channel", 4, False, False),
              ("channel", 2, False, True)]


@pytest.mark.parametrize("mix,tp,chunked,cached", RWKV_CASES,
                         ids=[f"{m}-tp{t}{'-chunked' if c else ''}{'-cache' if k else ''}"
                              for m, t, c, k in RWKV_CASES])
def test_rwkv_shares_sum_to_the_whole_mix(mix, tp, chunked, cached):
    cfg, m, cache = rwkv_block(cached)
    x, dy = inputs(cfg, torch.float64)
    if mix == "time":
        def fn(h):
            return rwkv.rwkv6_time_mix(m, h, cfg, cache=cache, chunked=chunked)[0]
    else:
        def fn(h):
            return rwkv.rwkv6_channel_mix(m, h, cfg, cache=cache)[0]
    parts = [(r, tp, None) for r in range(tp)]
    assert_shares_match(chip_smoke.split_shares(m, fn, x, dy, parts),
                        chip_smoke.split_shares(m, fn, x, dy, [None]), mix)
    if mix == "time" and cached:
        with torch.no_grad():
            want = rwkv.rwkv6_time_mix(m, x, cfg, cache=cache)[2]
            got = []
            for part in parts:
                with placement.model_split(part=part):
                    got.append(rwkv.rwkv6_time_mix(m, x, cfg, cache=cache)[2])
        assert all(s.shape[1] == cfg.n_heads // tp for s in got)
        assert_close_to(torch.cat(got, 1), want, "wkv_state")


SSD_CASES = [({}, 2), ({}, 4), ({}, 8), ({"n_groups": 2}, 2), ({"n_groups": 2}, 4),
             ({"n_groups": 2}, 8), ({"n_groups": 3, "expand": 3}, 2),
             ({"n_groups": 3, "expand": 3}, 4)]


def ssd_layer(over: dict):
    """A float64 Mamba2 smoke layer (zamba2's: 8 heads of 16, one group,
    unless ``over`` changes its SSM config) with gradients on."""
    base = smoke_config("zamba2-1.2b")
    kw = dict(state_dim=16, head_dim=16, expand=2, n_groups=1, chunk=16)
    cfg = base.replace(dtype="float64", ssm=SSMConfig(**{**kw, **over}))
    return cfg, ssm.Mamba2(cfg, torch.Generator().manual_seed(3)).requires_grad_(True)


@pytest.mark.parametrize("over,tp", SSD_CASES,
                         ids=[f"g{o.get('n_groups', 1)}{'-ragged' if 'expand' in o else ''}-tp{t}"
                              for o, t in SSD_CASES])
def test_ssd_shares_sum_to_the_whole_layer(over, tp):
    cfg, m = ssd_layer(over)
    nh = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    assert layers.tp_plan(cfg, tp)["ssd_heads"]
    x, dy = inputs(cfg, torch.float64)

    def fn(h):
        return ssm.mamba2_apply(m, h, cfg)[0]

    seen = []
    chunked = ssm._ssd_chunked

    def spy(xh, dt, A, Bh, Ch, *a, **kw):
        seen.append((xh.shape[2], Bh.shape[2]))
        return chunked(xh, dt, A, Bh, Ch, *a, **kw)

    ssm._ssd_chunked = spy
    try:
        got = chip_smoke.split_shares(m, fn, x, dy, [(r, tp, None) for r in range(tp)])
    finally:
        ssm._ssd_chunked = chunked
    assert_shares_match(got, chip_smoke.split_shares(m, fn, x, dy, [None]), over)
    # each share's heads, and the groups passed for them: the groups its
    # heads read, where each is read by as many of them, else one a head
    hq, rep = nh // tp, nh // cfg.ssm.n_groups
    want = set()
    for r in range(tp):
        reads = [(r * hq + j) // rep for j in range(hq)]
        k = len(set(reads))
        even = reads == [reads[0] + j // (hq // k) for j in range(hq)] and hq % k == 0
        want.add((hq, k if even else hq))
    assert set(seen) == want
    with placement.model_split(part=(0, tp, None)), pytest.raises(ValueError, match="fed_sums"):
        fn(x)


@pytest.mark.parametrize("tp", [2, 4])
def test_rwkv_and_ssd_share_flops(tp):
    """Each share's FLOPs (forward and backward) are at most the whole's /
    tp plus what every share computes whole."""
    cfg, m, _ = rwkv_block(False)
    x, dy = inputs(cfg, torch.float64)
    d, tokens = cfg.d_model, B * S
    cases = [(m, lambda h: rwkv.rwkv6_time_mix(m, h, cfg)[0],
              3 * 2 * tokens * d * (10 * rwkv.MIX_R + rwkv.LORA_R)),
             (m, lambda h: rwkv.rwkv6_channel_mix(m, h, cfg)[0], 3 * 2 * tokens * d * d)]
    scfg, sm = ssd_layer({})
    gn = scfg.ssm.n_groups * scfg.ssm.state_dim
    cases.append((sm, lambda h: ssm.mamba2_apply(sm, h, scfg)[0], 3 * 2 * tokens * d * 2 * gn))
    for layer, fn, whole_part in cases:
        (whole,) = chip_smoke.split_shares(layer, fn, x, dy, [None])[3]
        shares = chip_smoke.split_shares(layer, fn, x, dy,
                                         [(r, tp, None) for r in range(tp)])[3]
        assert all(0 < f <= whole / tp + whole_part for f in shares), (shares, whole)
        assert all(f < whole / 1.2 for f in shares), (shares, whole)


def reference_choice(cfg, mesh_name) -> dict:
    """The reference's sanitized annotations of its attention, MLP and
    head at ``cfg``, and of its rwkv6 and Mamba2 layers where the arch has
    them: {``tp_plan``'s name: whether "model" splits the dim}, each
    layer's annotations under its own names."""
    jmesh = JAbstractMesh(*MESHES[mesh_name])
    seen = {}
    names_of = [lambda n, x: n if n in ("heads", "kv_heads", "ffn", "vocab") else None]
    in_rwkv = {"heads": lambda x: "rwkv_heads",
               "ffn": lambda x: "rwkv_cm_ffn" if x.shape[-1] == cfg.d_ff else "rwkv_ffn"}

    def record(x, *names):
        spec = P(*[j_shd.rule(n) if n else None for n in names])
        spec = tuple(j_shd.sanitize(spec, x.shape, jmesh)) + (None,) * len(names)
        for i, n in enumerate(names):
            key = names_of[0](n, x)
            if key is not None:
                seen.setdefault(key, set()).add(spec[i] == "model")
        return x

    key = jax.random.PRNGKey(0)
    x = jax.ShapeDtypeStruct((512, 8, cfg.d_model), jnp.float32)
    j_shd.set_rules(jmesh, j_shd.default_rules(fsdp=True, multi_pod=mesh_name == "multipod"))
    shard, j_shd.shard = j_shd.shard, record
    try:
        pa = jax.eval_shape(lambda k: j_layers.attn_init(k, cfg), key)
        jax.eval_shape(lambda p, x_: j_layers.attn_apply(p, x_, cfg)[0], pa, x)
        pm = jax.eval_shape(lambda k: j_layers.mlp_init(k, cfg), key)
        jax.eval_shape(lambda p, x_: j_layers.mlp_apply(p, x_, cfg), pm, x)
        ph = {"embed": {"table": jax.ShapeDtypeStruct((cfg.vocab, cfg.d_model), jnp.float32)}}
        if not cfg.tie_embeddings:
            ph["lm_head"] = {"w": jax.ShapeDtypeStruct((cfg.d_model, cfg.vocab), jnp.float32)}
        jax.eval_shape(lambda p, x_: j_lm.lm_head_apply(p, x_, cfg), ph, x)
        if "rwkv6" in cfg.layer_types:
            names_of[0] = lambda n, x_: in_rwkv[n](x_) if n in in_rwkv else None
            pr = jax.eval_shape(lambda k: j_rwkv.rwkv6_init(k, cfg), key)
            cache = jax.eval_shape(lambda: j_rwkv.rwkv6_cache_init(cfg, x.shape[0]))
            jax.eval_shape(lambda p, x_: j_rwkv.rwkv6_apply(p, x_, cfg)[0], pr, x)
            jax.eval_shape(lambda p, x_, c: j_rwkv.rwkv6_apply(p, x_, cfg, cache=c)[0],
                           pr, x, cache)
        if "mamba2" in cfg.layer_types:
            names_of[0] = lambda n, x_: "ssd_heads" if n == "heads" else None
            ps = jax.eval_shape(lambda k: j_ssm.mamba2_init(k, cfg), key)
            jax.eval_shape(lambda p, x_: j_ssm.mamba2_apply(p, x_, cfg)[0], ps, x)
    finally:
        j_shd.shard = shard
        j_shd.set_rules(None, None)
    assert all(len(v) == 1 for v in seen.values()), seen
    return {n: v.pop() for n, v in seen.items()}


@pytest.mark.parametrize("variant", ["arch", "train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_split_choice_equals_the_reference_sanitize(arch, mesh, variant):
    m = shd.AbstractMesh(*MESHES[mesh])
    cfg = ARCHS[arch] if variant == "arch" else dryrun.prepare_cfg(arch, variant, m)
    jcfg = J_ARCHS[arch].replace(kv_repeat=cfg.kv_repeat, q_group_pad=cfg.q_group_pad)
    want = reference_choice(jcfg, mesh)
    got = layers.tp_plan(cfg, shd.mesh_shape(m)["model"])
    assert got == want, (cfg.kv_repeat, cfg.q_group_pad)
