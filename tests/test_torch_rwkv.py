"""repro_torch.models.rwkv and the LM's "rwkv6" block against repro's, on
the CPU.

The smoke rwkv6-1.6b (4 layers, 4 heads of 16) runs in float32 in both
packages with the reference's weights (``params_from_reference``), on the
same numpy inputs.  Smoke sequences stay under the 256 tokens from which
``rwkv6_apply`` takes the chunked WKV, so both of its forms are run by
``chunked=True`` and ``chunked=False``.  Tolerances are the reference's own
(tests/test_serve.py): 2e-4 on hidden states and states, 2e-3 on logits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import rwkv as jrwkv  # noqa: E402
from repro_torch.models import model_fns  # noqa: E402
from repro_torch.models import rwkv  # noqa: E402
from tests.test_torch_models import (HIDDEN_ATOL, assert_forward_matches,  # noqa: E402
                                     assert_prefill_decode_matches, close, family_batch,
                                     ref_cache_layers, ref_family)

ARCH = "rwkv6-1.6b"


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


def test_rwkv6_forward_hidden_matches_reference(models):
    """The cache-free forward; the LM adds no residual around the block."""
    jcfg, jfns, jp, cfg, model = models
    assert set(cfg.layer_types) == {"rwkv6"}
    assert_forward_matches(jcfg, jfns, jp, cfg, model, family_batch(cfg, 2, 33))


def test_rwkv6_prefill_then_decode_logits_match_reference(models):
    """Prefill of 19 tokens, then 5 decode steps' logits; the shifts and
    WKV states after the prefill equal the reference's."""
    jcfg, jfns, jp, cfg, model = models
    cache, jc = assert_prefill_decode_matches(jfns, jp, model_fns(cfg), model,
                                              family_batch(cfg, 2, 19, seed=2))
    for mine, ref in zip(cache, ref_cache_layers(jcfg, jc), strict=True):
        for n in ("shift_tm", "shift_cm", "wkv_state"):
            close(mine["rwkv"][n], ref["rwkv"][n], HIDDEN_ATOL)


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "scan"])
@pytest.mark.parametrize("with_cache", [False, True], ids=["no_cache", "cache"])
def test_rwkv6_apply_both_wkv_forms_match_reference(models, chunked, with_cache):
    """One block with chunked=True and chunked=False in both packages, from
    zero or from a random carried cache: outputs and the new cache."""
    jcfg, _, jp, cfg, model = models
    jlayer = jax.tree.map(lambda a: np.asarray(a)[1], jp["blocks"][0]["rwkv"])
    layer = model.blocks[1].rwkv
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 70, cfg.d_model)).astype(np.float32)
    cache = jcache = None
    if with_cache:
        base = rwkv.rwkv6_cache_init(cfg, 2, device="cpu")
        c = {n: rng.normal(0, 0.3, t.shape).astype(np.float32) for n, t in base.items()}
        cache = {n: torch.from_numpy(a) for n, a in c.items()}
        jcache = {n: jnp.asarray(a) for n, a in c.items()}
    y, new = rwkv.rwkv6_apply(layer, torch.from_numpy(x), cfg, cache=cache, chunked=chunked)
    jy, jnew = jrwkv.rwkv6_apply(jlayer, jnp.asarray(x), jcfg, cache=jcache,
                                 chunked=chunked)
    close(y, jy, HIDDEN_ATOL)
    assert (new is None) == (jnew is None) == (not with_cache)
    for n in ("shift_tm", "shift_cm", "wkv_state") if with_cache else ():
        close(new[n], jnew[n], HIDDEN_ATOL)
        assert new[n] is not cache[n]


@pytest.mark.parametrize("s_len", [48, 37])
def test_wkv_scan_and_chunked_match_reference_from_a_carried_state(s_len):
    """_wkv_scan and _wkv_chunked (chunk 16, a ragged last chunk at 37)
    from a random state, in both packages: outputs and final states, and
    the two forms against each other."""
    rng = np.random.default_rng(4)
    B, H, M = 2, 3, 8
    r, k, v = (rng.normal(size=(B, s_len, H, M)).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-6, -1, (B, s_len, H, M)))).astype(np.float32)
    u = rng.uniform(-0.5, 0.5, (H, M)).astype(np.float32)
    st = rng.normal(size=(B, H, M, M)).astype(np.float32)
    t_in = [torch.from_numpy(a) for a in (r, k, v, w, u, st)]
    j_in = [jnp.asarray(a) for a in (r, k, v, w, u, st)]
    outs = {}
    for name in ("_wkv_scan", "_wkv_chunked"):
        kw = {"chunk": 16} if name == "_wkv_chunked" else {}
        o, s = getattr(rwkv, name)(*t_in, **kw)
        jo, js = getattr(jrwkv, name)(*j_in, **kw)
        close(o, jo, HIDDEN_ATOL)
        close(s, js, HIDDEN_ATOL)
        outs[name] = o, s
    close(outs["_wkv_chunked"][0], outs["_wkv_scan"][0], HIDDEN_ATOL)
    close(outs["_wkv_chunked"][1], outs["_wkv_scan"][1], HIDDEN_ATOL)


def test_decoding_twice_from_one_cache_gives_the_same_tokens(models):
    """Recurrent states are replaced, never written in place: two greedy
    decodes from the same prefilled cache give the same tokens, and the
    prefilled cache's tensors come out unchanged."""
    from repro_torch.serve.engine import Engine

    _, _, _, cfg, model = models
    eng = Engine(model_fns(cfg), model, max_seq=32)
    batch = family_batch(cfg, 2, 12, seed=5)
    cache, clen, _ = eng.prefill(batch)
    before = [{n: t.clone() for n, t in c["rwkv"].items()} for c in cache]
    t1, _ = eng.decode(cache, clen, batch["tokens"][:, -1:], 6)
    t2, _ = eng.decode(cache, clen, batch["tokens"][:, -1:], 6)
    assert torch.equal(t1, t2)
    for b, c in zip(before, cache, strict=True):
        assert all(torch.equal(b[n], c["rwkv"][n]) for n in b)
