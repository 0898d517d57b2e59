"""repro_torch.models.moe and the LM's "moe" block against repro's, on the
CPU.

The smoke configs of granite-moe-1b-a400m (32 -> 8 experts, top 2, tied
embeddings) and mixtral-8x22b (8 experts, top 2, sliding window) run in
float32 in both packages with the reference's weights
(``params_from_reference``), on the same numpy inputs.  Tolerances are the
reference's own (tests/test_serve.py): 2e-4 on hidden states, 2e-3 on
logits.

Routing is compared exactly with one exception.  ``jax.lax.top_k`` and
``torch.topk`` may choose differently between two router probabilities
that lie within an ulp, so a token whose K-th and (K+1)-th probabilities
lie within ``NEAR_TIE`` is counted, printed and held only to the near-tie
rule: each expert it was given has a reference probability within
``NEAR_TIE`` of the reference's K-th.  The order of a token's K experts is
not compared: the dispatch depends on the set alone.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import model_fns  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from tests.test_torch_models import (HIDDEN_ATOL, assert_forward_matches,  # noqa: E402
                                     assert_prefill_decode_matches, family_batch, ref_family)

ARCHS = ["granite-moe-1b-a400m", "mixtral-8x22b"]
NEAR_TIE = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size torch ops on one thread: under the suite's parallel
    workers, torch's per-process pool of one thread per core makes these
    small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """(reference cfg, fns, params; port cfg, model) of one arch."""
    return ref_family(request.param)


def ref_routing(p, x, cfg, capacity):
    """The reference's routing and dispatch (src/repro/models/moe.py,
    ``_moe_tokens``), line for line: probs, top-K experts, and the kept
    mask of each (token, slot) assignment."""
    probs = jax.nn.softmax(x @ p["router"], axis=-1)
    _, gate_e = jax.lax.top_k(probs, cfg.moe.top_k)
    return np.asarray(probs), np.asarray(gate_e), ref_keep(gate_e, cfg.moe.n_experts, capacity)


def ref_keep(gate_e, n_experts, capacity):
    """The reference's kept mask of each (token, slot) assignment, from
    its sort-based dispatch over ``gate_e``."""
    gate_e = jnp.asarray(gate_e)
    T, K = gate_e.shape
    flat_e = gate_e.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    counts = jnp.bincount(flat_e, length=n_experts)
    seg_start = jnp.cumsum(counts) - counts
    pos_in_e = jnp.arange(T * K) - seg_start[flat_e[order]]
    keep = np.zeros(T * K, bool)
    keep[np.asarray(order)] = np.asarray(pos_in_e < capacity)
    return keep.reshape(T, K)


def port_routing(module, x, cfg, capacity):
    _, _, gate_e = moe._route(module, torch.from_numpy(x), cfg)
    order, keep, _, _ = moe._dispatch(gate_e, cfg.moe.n_experts, capacity)
    kept = torch.zeros_like(keep)
    kept[order] = keep
    return gate_e.numpy(), kept.view(gate_e.shape).numpy()


def near_tie_rows(probs, k):
    """Tokens whose K-th and (K+1)-th router probabilities lie within
    NEAR_TIE."""
    top = -np.sort(-probs, axis=1)[:, : k + 1]
    return np.flatnonzero(top[:, k - 1] - top[:, k] <= NEAR_TIE)


def assert_routing_matches(probs, want_e, want_keep, got_e, got_keep, capacity, n_experts):
    """Gate sets equal row by row outside near-ties, near-tie rows by the
    rule; the dispatch's kept mask equal to the reference's dispatch of
    the port's own gate indices, and to the reference's where no near-tie
    row exists.  Returns the number of near-tie rows."""
    k = want_e.shape[1]
    ties = near_tie_rows(probs, k)
    print(f"near-tie tokens (K-th and (K+1)-th within {NEAR_TIE}): {len(ties)} "
          f"of {len(probs)}")
    rest = np.setdiff1d(np.arange(len(probs)), ties)
    np.testing.assert_array_equal(np.sort(got_e[rest], 1), np.sort(want_e[rest], 1))
    kth = -np.sort(-probs, axis=1)[:, k - 1]
    for r in ties:
        assert (probs[r, got_e[r]] >= kth[r] - NEAR_TIE).all(), r
    np.testing.assert_array_equal(got_keep, ref_keep(got_e, n_experts, capacity))
    if not len(ties):
        # slots in the reference's order of each token's experts
        pos = {(r, e): j for r in range(len(want_e)) for j, e in enumerate(want_e[r])}
        mine = np.zeros_like(want_keep)
        for r in range(len(got_e)):
            for j, e in enumerate(got_e[r]):
                mine[r, pos[r, e]] = got_keep[r, j]
        np.testing.assert_array_equal(mine, want_keep)
    return len(ties)


def test_moe_forward_hidden_and_aux_match_reference(models):
    """The cache-free forward (capacity dispatch, tokens dropped) gives
    the reference's hidden states and summed balance loss, which is not 0."""
    jcfg, jfns, jp, cfg, model = models
    assert_forward_matches(jcfg, jfns, jp, cfg, model, family_batch(cfg, 2, 40))


def test_moe_prefill_then_decode_logits_match_reference(models):
    """The cache path (no_drop) over a 24-token prompt, then 5 decode
    steps' logits."""
    jcfg, jfns, jp, cfg, model = models
    assert_prefill_decode_matches(jfns, jp, model_fns(cfg), model, family_batch(cfg, 2, 24))


@pytest.mark.parametrize("no_drop", [False, True], ids=["capacity", "no_drop"])
def test_moe_gate_indices_dropped_mask_and_output_match_reference(models, no_drop):
    """One layer's router on 96 tokens: the gate indices and the kept
    (not dropped) assignments against the reference's, at its capacity
    and at no_drop; then _moe_tokens' output and aux loss.  The tokens share
    an offset, which loads some experts past their capacity, so tokens are
    dropped at capacity (none at no_drop)."""
    jcfg, _, jp, cfg, model = models
    layer = model.blocks[1].moe
    jlayer = jax.tree.map(lambda a: np.asarray(a)[1], jp["blocks"][0]["moe"])
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(96, cfg.d_model)) + 2.0 * rng.normal(size=cfg.d_model)).astype(
        np.float32)
    T = x.shape[0]
    cap = T if no_drop else moe._capacity(T, cfg.moe)
    assert cap == jmoe._capacity(T, jcfg.moe) or no_drop
    probs, want_e, want_keep = ref_routing(jlayer, jnp.asarray(x), jcfg, cap)
    got_e, got_keep = port_routing(layer, x, cfg, cap)
    assert_routing_matches(probs, want_e, want_keep, got_e, got_keep, cap,
                           cfg.moe.n_experts)
    assert got_keep.all() == no_drop
    y, aux = moe._moe_tokens(layer, torch.from_numpy(x), cfg, no_drop=no_drop)
    jy, jaux = jmoe._moe_tokens(jlayer, jnp.asarray(x), jcfg, no_drop=no_drop)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=HIDDEN_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_moe_near_tie_rows_are_counted_and_held_to_the_rule(models):
    """Tokens planted on exact ties (a router whose two expert columns are
    equal, so those experts' probabilities are equal for every token): the
    near-tie rows are counted, and both packages' choices satisfy the rule
    and their dispatches agree on the port's own gate indices."""
    jcfg, _, jp, cfg, model = models
    layer = copy.deepcopy(model.blocks[0].moe)
    jlayer = jax.tree.map(lambda a: np.array(a)[0], jp["blocks"][0]["moe"])
    router = jlayer["router"]
    router[:, 3] = router[:, 2]
    with torch.no_grad():
        layer.router.copy_(torch.from_numpy(router))
    x = np.random.default_rng(6).normal(size=(64, cfg.d_model)).astype(np.float32)
    cap = moe._capacity(64, cfg.moe)
    probs, want_e, want_keep = ref_routing(jlayer, jnp.asarray(x), jcfg, cap)
    got_e, got_keep = port_routing(layer, x, cfg, cap)
    ties = assert_routing_matches(probs, want_e, want_keep, got_e, got_keep, cap,
                                  cfg.moe.n_experts)
    # the planted ties at the boundary: experts 2 and 3 are the K-th and
    # (K+1)-th of a token
    k = cfg.moe.top_k
    top = -np.sort(-probs, axis=1)
    boundary = np.flatnonzero((top[:, k - 1] == probs[:, 2]) & (top[:, k] == probs[:, 3]))
    assert len(boundary) > 0 and ties >= len(boundary)


def test_moe_module_output_matches_reference_by_mlp_kind(models):
    """_moe_tokens with the GELU experts (no gate) and with geglu."""
    jcfg, _, jp, cfg, model = models
    x = np.random.default_rng(7).normal(size=(40, cfg.d_model)).astype(np.float32)
    for kind in ("gelu", "geglu"):
        c, jc = cfg.replace(mlp_kind=kind), jcfg.replace(mlp_kind=kind)
        jlayer = jmoe.moe_init(jax.random.PRNGKey(3), jc)
        layer = moe.moe_init(None, c, device="cpu")
        assert ("gate" in layer.experts) == (kind == "geglu")
        with torch.no_grad():
            layer.router.copy_(torch.from_numpy(np.array(jlayer["router"])))
            for n, a in jlayer["experts"].items():
                layer.experts[n].copy_(torch.from_numpy(np.array(a)))
        y, aux = moe.moe_apply(layer, torch.from_numpy(x).view(2, 20, -1), c)
        jy, jaux = jmoe.moe_apply(jlayer, jnp.asarray(x).reshape(2, 20, -1), jc)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=HIDDEN_ATOL, rtol=0)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_moe_forced_experts_replay_the_routing(models):
    """moe_apply(experts=...): the router's own choices give the same
    output bit for bit; other choices are weighted by their router
    probabilities, renormalized, as a per-token sum of the chosen experts'
    MLPs (no_drop, so nothing is dropped)."""
    _, _, _, cfg, model = models
    layer, m = model.blocks[0].moe, cfg.moe
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 20, cfg.d_model))
                         .astype(np.float32))
    flat = x.view(-1, cfg.d_model)
    probs, _, own = moe._route(layer, flat, cfg)
    y, aux = moe.moe_apply(layer, x, cfg, no_drop=True)
    y1, aux1 = layer(x, cfg, no_drop=True, experts=own.view(2, 20, -1))
    assert torch.equal(y, y1) and torch.equal(aux, aux1)
    other = (own + 1) % m.n_experts
    got, _ = moe.moe_apply(layer, x, cfg, no_drop=True, experts=other.view(2, 20, -1))
    w = probs.gather(1, other)
    w = w / w.sum(-1, keepdim=True)
    ex = layer.experts
    want = torch.zeros_like(flat)
    for t in range(flat.shape[0]):
        for j, e in enumerate(other[t].tolist()):
            h = F.silu(flat[t] @ ex["gate"][e]) * (flat[t] @ ex["up"][e])
            want[t] += w[t, j] * (h @ ex["down"][e])
    assert not torch.allclose(got.view(-1, cfg.d_model), y.view(-1, cfg.d_model))
    np.testing.assert_allclose(got.view(-1, cfg.d_model).numpy(), want.numpy(),
                               atol=HIDDEN_ATOL, rtol=0)
