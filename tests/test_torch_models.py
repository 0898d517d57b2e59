"""repro_torch.models and repro_torch.configs against repro's, on the CPU.

The same numpy inputs go through both packages, the port's weights carried
across from the reference's (``params_from_reference``, or the same numpy
arrays copied into one layer's module), at ``smoke_config`` size in float32.
Tolerance: ``ATOL = 1e-5``.  The two packages compute the same products and
sums, but XLA's and torch's CPU matmuls add a row's terms in different
orders; the largest difference seen is about 6e-6, on hidden states of
order 1 after four layers.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import shapes as j_shapes  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import model_fns as j_model_fns  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, smoke_config  # noqa: E402
from repro_torch.configs import shapes as t_shapes  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import model_fns, registry, synthetic_batch  # noqa: E402
from repro_torch.models.config import ModelConfig, MoEConfig  # noqa: E402

ATOL = 1e-5
#: archs the port runs (every layer an "attn" block, kind "lm"): plain GQA,
#: tied embeddings, and qkv bias with a wide rope_theta
LM_ARCHS = ["tinyllama-1.1b", "granite-3-2b", "qwen2.5-14b"]


def carry(module, ref_params):
    """Copy the reference's leaf dict (nested) into ``module``'s parameters
    of the same names; every parameter must be met."""
    flat = dict(lm._flat(ref_params))
    own = dict(module.named_parameters())
    assert own.keys() == flat.keys(), (sorted(own), sorted(flat))
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(torch.from_numpy(np.array(flat[name])))
    return module


def cfgs(arch, **kw):
    """The reference's and the port's smoke config of ``arch``, with ``kw``
    replaced in both."""
    return j_smoke(arch).replace(**kw), smoke_config(arch).replace(**kw)


def ref_lm(arch, **kw):
    """(reference cfg, fns, params; port cfg, model) for ``arch``'s smoke
    config with ``kw`` replaced in both."""
    jcfg, cfg = cfgs(arch, **kw)
    jfns = j_model_fns(jcfg)
    jp = jfns.init(jax.random.PRNGKey(0))
    model = registry.params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jfns, jp, cfg, model


def ref_family(arch):
    """ref_lm of ``arch``'s smoke config, the reference's weights drawn by
    its jitted init (another draw than the eager one, and seconds faster)."""
    jcfg, cfg = cfgs(arch)
    jfns = j_model_fns(jcfg)
    jp = jax.jit(jfns.init)(jax.random.PRNGKey(0))
    model = registry.params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jfns, jp, cfg, model


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


#: the reference's own tolerances for its smoke models in float32
#: (tests/test_serve.py): hidden states, and logits
HIDDEN_ATOL, LOGITS_ATOL = 2e-4, 2e-3


def family_batch(cfg, b, s, seed=0):
    """A numpy batch of ``cfg``'s kind: int32 tokens ``[b, s]``, and
    float32 standard-normal patches (vlm) or frames (whisper)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    kind = t_shapes.model_kind(cfg)
    if kind == "vlm":
        batch["patches"] = rng.normal(size=(b, cfg.vision_seq, 1024)).astype(np.float32)
    if kind == "whisper":
        batch["frames"] = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def assert_forward_matches(jcfg, jfns, jp, cfg, model, batch):
    """The cache-free forward's hidden states and aux loss against the
    reference's; returns the port's hidden states."""
    fns = model_fns(cfg)
    h, cache, aux = fns.forward(model, batch)
    jh, _, jaux = jfns.forward(jp, {n: jnp.asarray(v) for n, v in batch.items()})
    assert cache is None and h.shape == jh.shape
    close(h, jh, HIDDEN_ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-6)
    return h


def assert_prefill_decode_matches(jfns, jp, fns, model, batch, steps=5, seed=1):
    """Both packages' Engine.prefill of ``batch`` (the cache-filling path),
    then ``steps`` decode steps fed the same random tokens: the prefill's
    last hidden state within HIDDEN_ATOL and every step's logits within
    LOGITS_ATOL of the reference's.  Returns both caches after the
    prefill, the port's first."""
    from repro.serve.engine import Engine as JEngine
    from repro_torch.serve.engine import Engine

    b, s = batch["tokens"].shape
    max_seq = fns.loss_offset(batch) + s + steps + 3
    jeng, eng = JEngine(jfns, jp, max_seq=max_seq), Engine(fns, model, max_seq=max_seq)
    jc, jlen, jlast = jeng.prefill({n: jnp.asarray(v) for n, v in batch.items()})
    cache, clen, last = eng.prefill(batch)
    assert clen == int(jlen)
    close(last, jlast, HIDDEN_ATOL)
    feed = tokens(fns.cfg, b, steps, seed=seed)
    c, jprefilled = cache, jc
    with torch.inference_mode():
        for i in range(steps):
            _, jlogits, jc = jeng._decode_jit(jp, jnp.asarray(feed[:, i:i + 1]), jc,
                                              jlen + i)
            _, logits, c = eng._decode_step(model, feed[:, i:i + 1], c, clen + i)
            close(logits, jlogits, LOGITS_ATOL)
    return cache, jprefilled


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_archs_and_smoke_configs_match_reference(arch):
    """ARCHS and smoke_config field for field (nested MoE/SSM configs too),
    and the derived head_dim and layer_types."""
    assert sorted(ARCHS) == sorted(J_ARCHS)
    for mine, ref in ((ARCHS[arch], J_ARCHS[arch]), (smoke_config(arch), j_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.head_dim == ref.head_dim
        assert mine.layer_types == ref.layer_types
        assert str(mine.act_dtype).removeprefix("torch.") == str(ref.act_dtype)
        assert str(mine.p_dtype).removeprefix("torch.") == str(ref.p_dtype)


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_param_count_matches_reference(arch):
    for mine, ref in ((ARCHS[arch], J_ARCHS[arch]), (smoke_config(arch), j_smoke(arch))):
        assert mine.param_count() == ref.param_count()
        assert mine.active_param_count() == ref.active_param_count()


def test_config_dtypes_and_replace():
    cfg = ModelConfig()
    assert cfg.act_dtype is torch.bfloat16 and cfg.p_dtype is torch.float32
    small = cfg.replace(dtype="float32", moe=MoEConfig(n_experts=4))
    assert small.act_dtype is torch.float32 and small.moe.n_experts == 4
    assert cfg.dtype == "bfloat16"
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.d_model = 1


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_shapes_match_reference(arch):
    assert {n: dataclasses.asdict(s) for n, s in SHAPES.items()} == {
        n: dataclasses.asdict(s) for n, s in J_SHAPES.items()}
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    assert t_shapes.model_kind(cfg) == j_shapes.model_kind(jcfg)
    assert t_shapes.is_subquadratic(cfg) == j_shapes.is_subquadratic(jcfg)
    for name in SHAPES:
        assert t_shapes.applicable(cfg, SHAPES[name]) == j_shapes.applicable(
            jcfg, J_SHAPES[name])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_apply_matches_reference(kind):
    jcfg, cfg = cfgs("tinyllama-1.1b", norm_kind=kind)
    rng = np.random.default_rng(1)
    p = {"scale": rng.normal(1, 0.2, 64).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.normal(0, 0.2, 64).astype(np.float32)
    x = rng.normal(0.3, 2.0, (2, 7, 64)).astype(np.float32)
    norm = carry(tl.norm_init(cfg, device="cpu"), p)
    got = norm(torch.from_numpy(x))
    close(got, jl.norm_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg))
    assert got.dtype == torch.float32


def test_rope_apply_matches_reference():
    jcfg, cfg = cfgs("qwen2.5-14b", rope_theta=1e6)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(30, 39)]).astype(np.int32)
    inv = tl.rope_freqs(cfg)
    close(inv, jl.rope_freqs(jcfg), atol=1e-7)
    close(tl.rope_apply(torch.from_numpy(x), torch.from_numpy(pos), inv),
          jl.rope_apply(jnp.asarray(x), jnp.asarray(pos), jl.rope_freqs(jcfg)))


#: flash_attention cases: Sq, Sk, keyword args (chunks 8 and 16, so every
#: case runs several ragged tiles)
FLASH_CASES = {
    "causal": (37, 37, dict(causal=True)),
    "window": (37, 37, dict(causal=True, window=5)),
    "not_causal": (21, 37, dict(causal=False)),
    "kv_valid_offset": (9, 40, dict(causal=True, q_offset=25, kv_valid="prefix")),
    "decode_window": (1, 40, dict(causal=True, q_offset=33, window=7, kv_valid="prefix")),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_matches_reference(case):
    sq, sk, kw = FLASH_CASES[case]
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, sq, 6, 8)).astype(np.float32)
    k = rng.normal(size=(2, sk, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, sk, 2, 8)).astype(np.float32)
    kw = dict(kw, chunk_q=8, chunk_k=16)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("kv_valid") == "prefix":
        valid = np.arange(sk)[None, :] < np.array([[sk - 3], [kw["q_offset"] + sq]])
        jkw["kv_valid"], tkw["kv_valid"] = jnp.asarray(valid), torch.from_numpy(valid)
    got = tl.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **tkw)
    want = jl.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), **jkw)
    assert got.shape == want.shape
    close(got, want)


#: attn_apply variants: config replacements and the reference test each mirrors
ATTN_CASES = {
    "plain": dict(),
    "qkv_bias": dict(qkv_bias=True),
    "sliding_window": dict(sliding_window=6),
    "q_group_pad_kv_repeat": dict(q_group_pad=6, kv_repeat=2),   # tests/test_head_pad.py
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attn_apply_prefill_and_cache_decode_match_reference(case):
    """Prefill (no cache), then a cache-filling prefill of 10 tokens and 6
    one-token decode steps, against the reference's attn_apply on the same
    weights (qkv biases drawn non-zero)."""
    jcfg, cfg = cfgs("tinyllama-1.1b", n_kv_heads=2, **ATTN_CASES[case])
    p = jl.attn_init(jax.random.PRNGKey(1), jcfg)
    if cfg.qkv_bias:
        rng = np.random.default_rng(4)
        p = {n: (rng.normal(0, 0.3, a.shape).astype(np.float32) if n.startswith("b")
                 else a) for n, a in p.items()}
    attn = carry(tl.attn_init(None, cfg, device="cpu"), p)
    x = np.random.default_rng(5).normal(size=(2, 16, 64)).astype(np.float32)
    got, _ = attn(torch.from_numpy(x))
    want, _ = jl.attn_apply(p, jnp.asarray(x), jcfg)
    close(got, want)

    kv = cfg.n_kv_heads * cfg.kv_repeat
    cache = {n: torch.zeros(2, 24, kv, 16) for n in "kv"}
    jcache = {n: jnp.zeros((2, 24, kv, 16)) for n in "kv"}
    for start, stop in [(0, 10)] + [(t, t + 1) for t in range(10, 16)]:
        got, cache = attn(torch.from_numpy(x[:, start:stop]), cache=cache, cache_len=start)
        want, jcache = jl.attn_apply(p, jnp.asarray(x[:, start:stop]), jcfg, cache=jcache,
                                     cache_len=jnp.int32(start))
        close(got, want)
    close(cache["k"], jcache["k"])
    close(cache["v"], jcache["v"])


def test_ring_cache_matches_full_cache_and_reference():
    """Mirror of tests/test_ring_cache.py on an "attn" model: decoding 24
    tokens through a window-sized rolling cache (it wraps twice) equals
    decoding through a full 64-slot cache with the window mask, and the
    reference's ring decode."""
    window = 8
    jcfg, jfns, jp, cfg, model = ref_lm("tinyllama-1.1b", sliding_window=window)
    fns = model_fns(cfg)
    toks = tokens(cfg, 2, 24, seed=1)
    ring = fns.cache_init(model, None, 2, 32)
    assert ring[0]["attn"]["k"].shape[1] == window
    full = [{"attn": {n: torch.zeros(2, 64, cfg.n_kv_heads, cfg.head_dim) for n in "kv"}}
            for _ in cfg.layer_types]
    jring = jfns.cache_init(jp, None, 2, 32)
    jstep = jax.jit(jfns.decode_step)
    outs = {"ring": [], "full": [], "ref": []}
    for t in range(24):
        tok = toks[:, t:t + 1]
        h, ring = fns.decode_step(model, tok, ring, t)
        outs["ring"].append(h)
        h, full = fns.decode_step(model, tok, full, t)
        outs["full"].append(h)
        h, jring = jstep(jp, jnp.asarray(tok), jring, jnp.int32(t))
        outs["ref"].append(np.asarray(h))
    r, f = torch.cat(outs["ring"], 1), torch.cat(outs["full"], 1)
    close(r, f)
    close(r, np.concatenate(outs["ref"], 1))


@pytest.mark.parametrize("arch,g_pad,kv_rep,kw", [
    ("tinyllama-1.1b", 6, 2, {}),                       # GQA: g 4 -> 6
    ("internvl2-1b", 7, 1, dict(vision_seq=0)),         # g 4 -> 7 (its LM alone)
    ("whisper-small", 3, 1, dict(encoder_layers=0)),    # MHA, layernorm, gelu
])
def test_head_pad_exact_forward(arch, g_pad, kv_rep, kw):
    """Mirror of tests/test_head_pad.py: the padded model's hidden states
    equal the unpadded model's bit for bit, and the reference's padded
    forward within ATOL."""
    jcfg, _, jp, cfg, model = ref_lm(arch, **kw)
    toks = tokens(cfg, 2, 12, seed=1)
    h0, _, _ = lm.lm_forward(model, toks, cfg)
    padded = cfg.replace(q_group_pad=g_pad, kv_repeat=kv_rep)
    h1, _, _ = lm.lm_forward(model, toks, padded)
    assert torch.equal(h0, h1)
    jh1, _, _ = jlm.lm_forward(jp, jnp.asarray(toks),
                               jcfg.replace(q_group_pad=g_pad, kv_repeat=kv_rep))
    close(h1, jh1)


def test_head_pad_decode_consistent():
    _, _, _, cfg, model = ref_lm("tinyllama-1.1b")
    toks = tokens(cfg, 2, 10, seed=2)
    h0, _, _ = lm.lm_forward(model, toks, cfg)
    padded = cfg.replace(q_group_pad=6, kv_repeat=2)
    fns = model_fns(padded)
    cache = fns.cache_init(model, None, 2, 32)
    hs = []
    for t in range(10):
        hh, cache = fns.decode_step(model, toks[:, t:t + 1], cache, t)
        hs.append(hh)
    close(torch.cat(hs, 1), h0)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_apply_matches_reference(kind):
    jcfg, cfg = cfgs("tinyllama-1.1b", mlp_kind=kind)
    p = jl.mlp_init(jax.random.PRNGKey(2), jcfg)
    mlp = carry(tl.mlp_init(None, cfg, device="cpu"), p)
    assert (mlp.w_gate is None) == (kind == "gelu")
    x = np.random.default_rng(6).normal(size=(2, 5, 64)).astype(np.float32)
    close(mlp(torch.from_numpy(x)), jl.mlp_apply(p, jnp.asarray(x), jcfg))


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_forward_and_head_match_reference(arch):
    jcfg, _, jp, cfg, model = ref_lm(arch)
    assert model.lm_head is None if cfg.tie_embeddings else model.lm_head is not None
    assert (model.blocks[0].attn.bq is not None) == cfg.qkv_bias
    toks = tokens(cfg, 2, 40)
    h, cache, aux = lm.lm_forward(model, toks, cfg)
    jh, _, jaux = jlm.lm_forward(jp, jnp.asarray(toks), jcfg)
    assert cache is None and float(aux) == float(jaux) == 0.0
    close(h, jh)
    close(lm.lm_head_apply(model, h, cfg), jlm.lm_head_apply(jp, jh, jcfg))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cache_decode_matches_teacher_forcing(arch):
    """A cache-filling prefill of 30 tokens, then 10 one-token decode
    steps: hidden states equal the full forward without cache at the same
    positions, and the reference's cache decode."""
    jcfg, jfns, jp, cfg, model = ref_lm(arch)
    fns = model_fns(cfg)
    toks = tokens(cfg, 2, 40, seed=3)
    full, _, _ = lm.lm_forward(model, toks, cfg)
    cache, jcache = fns.cache_init(model, None, 2, 48), jfns.cache_init(jp, None, 2, 48)
    hs, jhs = [], []
    jstep = jax.jit(jfns.decode_step)
    for start, stop in [(0, 30)] + [(t, t + 1) for t in range(30, 40)]:
        h, cache = fns.decode_step(model, toks[:, start:stop], cache, start)
        jh, jcache = jstep(jp, jnp.asarray(toks[:, start:stop]), jcache,
                                      jnp.int32(start))
        hs.append(h)
        jhs.append(np.asarray(jh))
    got = torch.cat(hs, 1)
    close(got, full)
    close(got, np.concatenate(jhs, 1))
    close(fns.lm_head(model, got[:, 30:]), fns.lm_head(model, full[:, 30:]))


def ref_cache_layers(jcfg, jcache) -> list:
    """The reference's cache (one entry per run, a scanned run's leaves
    stacked) as one entry per layer, the port's layout."""
    if j_shapes.model_kind(jcfg) == "whisper":
        return ([jax.tree.map(lambda a, j=j: a[j], jcache) for j in range(jcfg.n_layers)]
                if jcfg.use_scan else list(jcache))
    out = []
    for (btype, count), run in zip(jlm._runs(jcfg), jcache, strict=True):
        if btype == "shared_attn":
            out.append(run)
        elif count > 1 and jcfg.use_scan:
            out += [jax.tree.map(lambda a, j=j: a[j], run) for j in range(count)]
        else:
            out += run
    return out


def assert_builds_and_carries(arch):
    """The port builds ``arch``'s smoke model from a seed and empty: its
    parameters are exactly the reference's names and shapes (unstacked per
    layer), params_from_reference carries every reference leaf, and both
    caches hold the same entries, shapes and dtypes layer by layer."""
    jcfg, cfg = cfgs(arch)
    jfns, fns = j_model_fns(jcfg), model_fns(cfg)
    assert fns.kind == jfns.kind
    jparams = jax.jit(jfns.init)(jax.random.PRNGKey(0))
    jp = jax.tree.map(np.asarray, jparams)
    leaves = registry.reference_leaves(jp, cfg)
    want = {n: tuple(a.shape) for n, a in leaves.items()}
    for model in (fns.init(0, device="cpu"), registry.params_from_reference(jp, cfg, "cpu")):
        assert {n: tuple(p.shape) for n, p in model.named_parameters()} == want
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.numpy(), leaves[name], err_msg=name)
    batch = synthetic_batch(cfg, 2, 5, device="cpu")
    jbatch = {n: jnp.asarray(v.float().numpy()) for n, v in batch.items()}
    cache = fns.cache_init(model, batch, 2, 16)
    jcache = jfns.cache_init(jparams, jbatch, 2, 16)
    jcache = ref_cache_layers(jcfg, jcache)
    assert len(cache) == len(jcache) == cfg.n_layers
    for mine, ref in zip(cache, jcache):
        flat, jflat = dict(lm._flat(mine)), dict(lm._flat(ref))
        assert flat.keys() == jflat.keys()
        for n, t in flat.items():
            assert tuple(t.shape) == jflat[n].shape, n
            assert str(t.dtype).removeprefix("torch.") == str(jflat[n].dtype), n
    return cfg, fns, batch


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "zamba2-1.2b", "rwkv6-1.6b"])
def test_other_block_types_build_and_carry(arch):
    """moe, mamba2 with Zamba2's shared_attn, and rwkv6 blocks: built from
    a seed and from the reference's weights, with the reference's cache
    layout, and the forward runs."""
    cfg, fns, batch = assert_builds_and_carries(arch)
    types = set(cfg.layer_types)
    assert types - {"attn"} and fns.kind == "lm"
    model = fns.init(0, device="cpu")
    assert (model.shared is not None) == ("shared_attn" in types)
    h, cache, aux = fns.forward(model, batch)
    assert h.shape == (2, 5, cfg.d_model) and cache is None
    assert (float(aux) > 0) == ("moe" in types)


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-1b"])
def test_other_model_kinds_build_and_carry(arch):
    """The whisper and vlm kinds: built and carried as above, and
    synthetic_batch draws their frames or patches (bf16) from its seed."""
    cfg, fns, batch = assert_builds_and_carries(arch)
    extra = {"whisper": ("frames", (2, cfg.encoder_seq, cfg.d_model)),
             "vlm": ("patches", (2, cfg.vision_seq, 1024))}[fns.kind]
    assert batch.keys() == {"tokens", "labels", extra[0]}
    assert batch[extra[0]].shape == extra[1] and batch[extra[0]].dtype == torch.bfloat16
    again = synthetic_batch(cfg, 2, 5, device="cpu")
    assert all(torch.equal(batch[n], again[n]) for n in batch)
    h, _, _ = fns.forward(fns.init(0, device="cpu"), batch)
    assert h.shape == (2, fns.loss_offset(batch) + 5, cfg.d_model)


def test_lm_init_is_seeded_and_counts_its_params():
    cfg = smoke_config("granite-3-2b")
    a, b, c = (lm.lm_init(s, cfg, device="cpu") for s in (0, 0, 1))
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), name
        assert name.endswith(("scale", "bias")) or not torch.equal(pa, pc), name
    assert sum(p.numel() for p in a.parameters()) == cfg.param_count() + sum(
        p.numel() for n, p in a.named_parameters() if "ln" in n or "norm" in n)
    assert all(not p.requires_grad for p in a.parameters())
    batch = synthetic_batch(cfg, 3, 5, seed=7, device="cpu")
    assert batch["tokens"].dtype == torch.int32 and batch["tokens"].shape == (3, 5)
    assert torch.equal(batch["tokens"], synthetic_batch(cfg, 3, 5, seed=7, device="cpu")["tokens"])
    assert int(batch["tokens"].max()) < cfg.vocab


def test_params_from_reference_rejects_another_config():
    _, _, jp, cfg, _ = ref_lm("tinyllama-1.1b")
    with pytest.raises(ValueError, match="shape"):
        lm.params_from_reference(jax.tree.map(np.asarray, jp), cfg.replace(d_ff=96), "cpu")
    with pytest.raises(ValueError, match="names differ"):
        lm.params_from_reference(jax.tree.map(np.asarray, jp),
                                 cfg.replace(qkv_bias=True), "cpu")
