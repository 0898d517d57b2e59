"""repro_torch.models.ssm and Zamba2's hybrid LM (Mamba2 blocks and the
weight-tied shared attention block) against repro's, on the CPU.

The smoke zamba2-1.2b (6 layers: 5 mamba2 and one shared_attn, state 16,
head dim 16, chunk 16) runs in float32 in both packages with the
reference's weights (``params_from_reference``), on the same numpy inputs.
Tolerances are the reference's own (tests/test_serve.py): 2e-4 on hidden
states and states, 2e-3 on logits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.models import lm, model_fns  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from tests.test_torch_models import (HIDDEN_ATOL, assert_forward_matches,  # noqa: E402
                                     assert_prefill_decode_matches, close, family_batch,
                                     ref_cache_layers, ref_family)

ARCH = "zamba2-1.2b"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size torch ops on one thread: under the suite's parallel
    workers, torch's per-process pool of one thread per core makes these
    small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return ref_family(ARCH)


def layer_params(jp, i):
    """The reference's Mamba2 parameters of the i-th layer of the first
    (scanned) run, numpy."""
    return jax.tree.map(lambda a: np.asarray(a)[i], jp["blocks"][0]["ssm"])


def test_zamba2_forward_hidden_matches_reference(models):
    """The cache-free forward: 5 chunked SSD blocks (a ragged last chunk)
    and the shared block applied to concat(x, x0)."""
    jcfg, jfns, jp, cfg, model = models
    assert cfg.layer_types.count("shared_attn") == 1 and model.shared is not None
    assert_forward_matches(jcfg, jfns, jp, cfg, model, family_batch(cfg, 2, 37))


def test_zamba2_prefill_then_decode_logits_match_reference(models):
    """The cache-filling prefill (chunked from the carried state) of 21
    tokens, then 5 recurrent decode steps' logits; the states after the
    prefill equal the reference's."""
    jcfg, jfns, jp, cfg, model = models
    batch = family_batch(cfg, 2, 21, seed=2)
    cache, jc = assert_prefill_decode_matches(jfns, jp, model_fns(cfg), model, batch)
    for mine, ref in zip(cache, ref_cache_layers(jcfg, jc), strict=True):
        if "ssm" in mine:
            for n in ("ssm_state", "conv_state"):
                close(mine["ssm"][n], ref["ssm"][n], HIDDEN_ATOL)


@pytest.mark.parametrize("s_len", [24, 37])
def test_ssd_chunked_from_a_carried_state_matches_reference(s_len):
    """_ssd_chunked from a non-zero state, chunk 8 (a ragged last chunk at
    37), with 2 groups over 4 heads: y and the final state."""
    rng = np.random.default_rng(3)
    b, h, p, g, n = 2, 4, 8, 2, 6
    x = rng.normal(size=(b, s_len, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, (b, s_len, h)).astype(np.float32)
    A = -np.exp(rng.normal(size=h)).astype(np.float32)
    B = rng.normal(size=(b, s_len, g, n)).astype(np.float32)
    C = rng.normal(size=(b, s_len, g, n)).astype(np.float32)
    st = rng.normal(size=(b, h, n, p)).astype(np.float32)
    y, fin = ssm._ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, B, C)), 8,
                              init_state=torch.from_numpy(st))
    jy, jfin = jssm._ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B, C)), 8,
                                 init_state=jnp.asarray(st))
    close(y, jy, HIDDEN_ATOL)
    close(fin, jfin, HIDDEN_ATOL)
    assert torch.isfinite(y).all()


def test_causal_conv_with_and_without_state_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 7, 10)).astype(np.float32)
    w = rng.normal(size=(4, 10)).astype(np.float32)
    b_ = rng.normal(size=10).astype(np.float32)
    st = rng.normal(size=(2, 3, 10)).astype(np.float32)
    for state in (None, st):
        out, new = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(b_),
                                    None if state is None else torch.from_numpy(state))
        jout, jnew = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b_),
                                       None if state is None else jnp.asarray(state))
        close(out, jout)
        close(new, jnew)


@pytest.mark.parametrize("branch,s_len", [("no_cache", 19), ("chunked_cache", 19),
                                          ("recurrent", 3)])
def test_mamba2_apply_branches_match_reference(models, branch, s_len):
    """One layer through each of mamba2_apply's three branches, the cache
    ones from a random carried state: outputs and new states."""
    jcfg, _, jp, cfg, model = models
    jlayer, layer = layer_params(jp, 2), model.blocks[2].ssm
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, s_len, cfg.d_model)).astype(np.float32)
    cache = jcache = None
    if branch != "no_cache":
        base = ssm.mamba2_cache_init(cfg, 2, device="cpu")
        c = {n: rng.normal(0, 0.5, t.shape).astype(np.float32) for n, t in base.items()}
        cache = {n: torch.from_numpy(a) for n, a in c.items()}
        jcache = {n: jnp.asarray(a) for n, a in c.items()}
    y, new = ssm.mamba2_apply(layer, torch.from_numpy(x), cfg, cache=cache)
    jy, jnew = jssm.mamba2_apply(jlayer, jnp.asarray(x), jcfg, cache=jcache)
    close(y, jy, HIDDEN_ATOL)
    assert (new is None) == (jnew is None) == (branch == "no_cache")
    if new is not None:
        for n in ("ssm_state", "conv_state"):
            close(new[n], jnew[n], HIDDEN_ATOL)
            assert new[n] is not cache[n]


def test_chunked_prefill_equals_recurrent_steps(models):
    """The port alone: one layer's chunked path over 20 tokens from a zero
    state equals 20 recurrent one-token steps (outputs and final states)."""
    _, _, _, cfg, model = models
    layer = model.blocks[0].ssm
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 20, cfg.d_model))
                         .astype(np.float32))
    y, chunked = ssm.mamba2_apply(layer, x, cfg, cache=ssm.mamba2_cache_init(cfg, 2))
    st = ssm.mamba2_cache_init(cfg, 2)
    ys = []
    for t in range(20):
        yt, st = ssm.mamba2_apply(layer, x[:, t:t + 1], cfg, cache=st)
        ys.append(yt)
    close(torch.cat(ys, 1), y, HIDDEN_ATOL)
    for n in ("ssm_state", "conv_state"):
        close(st[n], chunked[n], HIDDEN_ATOL)


def test_decoding_twice_from_one_cache_gives_the_same_tokens(models):
    """Recurrent states are replaced, never written in place: two greedy
    decodes from the same prefilled cache give the same tokens, and the
    prefilled cache's Mamba2 states come out unchanged."""
    from repro_torch.serve.engine import Engine

    _, _, _, cfg, model = models
    eng = Engine(model_fns(cfg), model, max_seq=32)
    batch = family_batch(cfg, 2, 12, seed=7)
    cache, clen, _ = eng.prefill(batch)
    before = [{n: t.clone() for n, t in c["ssm"].items()} for c in cache if "ssm" in c]
    t1, _ = eng.decode(cache, clen, batch["tokens"][:, -1:], 6)
    t2, _ = eng.decode(cache, clen, batch["tokens"][:, -1:], 6)
    assert torch.equal(t1, t2)
    after = [c["ssm"] for c in cache if "ssm" in c]
    for b, a in zip(before, after, strict=True):
        assert all(torch.equal(b[n], a[n]) for n in b)
    assert isinstance(cache, list) and len(cache) == cfg.n_layers
    assert lm.lm_cache_init(cfg, 2, 32, device="cpu")[5].keys() == {"attn"}
