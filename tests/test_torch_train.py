"""repro_torch.train (the loss, the train step) and the models' backward
pass against repro's, on the CPU.

The same numpy inputs go through both packages; the port's weights and
optimizer state come from the reference's (``state_from_reference``).
Sizes: the reference's tests/test_train.py model (``TRAIN_KW``: 2 layers,
d 32, vocab 64) in float32, and every arch's ``smoke_config`` (float32).
Tolerances: ``chunked_ce`` 1e-6 relative on the loss and its metrics, 1e-5
on its gradient; ``flash_attention``'s gradients 1e-5; three train steps
1e-5 (the metrics relative, the parameters and moments absolute; with int8
compression, elements whose target lies near a rounding boundary apart);
``cast_bf16`` at a bf16 tolerance that the float32 path fails.
Every arch's train step is in tests/test_torch_train_archs.py.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model_fns as j_model_fns  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro.train import losses as jlosses  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model_fns, registry  # noqa: E402
from repro_torch.optim import schedule  # noqa: E402
from repro_torch.train import losses, train_step  # noqa: E402
from tests.test_torch_models import cfgs  # noqa: E402

#: the reference's tests/test_train.py model, in float32
TRAIN_KW = dict(n_layers=2, d_model=32, d_ff=64, n_heads=2, n_kv_heads=2, d_head=16,
                vocab=64, dtype="float32")
#: a schedule that moves the parameters from the first step (the default
#: one's warm-up gives lr 0 there)
SCHED_KW = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size torch ops on one thread (see tests/test_torch_moe.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carried(tree, cfg):
    return {n: np.asarray(a) for n, a in
            registry.reference_leaves(jax.tree.map(np.asarray, tree), cfg).items()}


def ref_and_port_state(jcfg, cfg, *, compress_grads=False):
    """The reference's init_state (jitted) and the port's carried copy."""
    jfns = j_model_fns(jcfg)
    jst = jax.jit(lambda k: jts.init_state(jfns, k, compress_grads=compress_grads))(
        jax.random.PRNGKey(0))
    st = train_step.state_from_reference(jax.tree.map(np.asarray, jst), cfg, "cpu")
    return jfns, jst, st


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,masked", [(21, False), (32, False), (21, True)],
                         ids=["ragged", "whole_chunks", "masked"])
def test_chunked_ce_and_its_gradient_match_reference(S, masked):
    """S = 21 pads the last 8-token chunk; a random {0, 1} mask."""
    jcfg, cfg = cfgs("tinyllama-1.1b", logits_chunk=8)
    rng = np.random.default_rng(S + masked)
    B, D, V = 2, 16, 40
    hidden = rng.normal(size=(B, S, D)).astype(np.float32)
    w = rng.normal(size=(D, V)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32) if masked else None

    def jloss(h):
        return jlosses.chunked_ce(h, jnp.asarray(labels), lambda x: x @ jnp.asarray(w), jcfg,
                                  mask=None if mask is None else jnp.asarray(mask))

    (jl_, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(hidden))
    h = torch.from_numpy(hidden).requires_grad_(True)
    wt = torch.from_numpy(w)
    loss, m = losses.chunked_ce(h, labels, lambda x: x @ wt, cfg,
                                mask=None if mask is None else torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl_), rtol=1e-6)
    for k in ("nll", "zloss", "tokens"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
    assert float(m["tokens"]) == (B * S if mask is None else mask.sum())
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(jg), atol=1e-5, rtol=0)


def test_chunked_ce_keeps_no_chunk_logits_for_backward():
    """With gradients on, each chunk runs under checkpoint: what autograd
    keeps is the chunks' inputs, not their [B, c, V] logits."""
    _, cfg = cfgs("tinyllama-1.1b", logits_chunk=8)
    B, S, D, V = 2, 32, 16, 4096
    h = torch.randn(B, S, D, requires_grad=True)
    w = torch.randn(D, V)
    kept = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: kept.append(t.numel()) or t, lambda t: t):
        loss, _ = losses.chunked_ce(h, torch.zeros(B, S, dtype=torch.int32),
                                    lambda x: x @ w, cfg)
    assert max(kept) < B * 8 * V
    loss.backward()
    assert torch.isfinite(h.grad).all()


# ---------------------------------------------------------------------------
# flash attention's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["causal", "window", "kv_valid"])
def test_flash_attention_gradients_match_reference(case):
    """d(sum(out * w))/d(q, k, v) against jax.grad of the reference's, with
    GQA (4 heads over 2) and both sequences padded to their tiles (40 over
    tiles of 16 and 12); kv_valid: bidirectional with masked key slots."""
    rng = np.random.default_rng(11)
    B, S, H, KV, Dh = 2, 40, 4, 2, 16
    q, k, v = (rng.normal(size=(B, S, n, Dh)).astype(np.float32) for n in (H, KV, KV))
    w = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    kw = dict(causal=case != "kv_valid", window=8 if case == "window" else None,
              chunk_q=16, chunk_k=12)
    valid = None
    if case == "kv_valid":
        valid = rng.random((B, S)) < 0.8
        valid[:, 0] = True

    def jf(q_, k_, v_):
        out = jl.flash_attention(q_, k_, v_, **kw,
                                 kv_valid=None if valid is None else jnp.asarray(valid))
        return jnp.sum(out * jnp.asarray(w))

    jg = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tl.flash_attention(*ts, **kw, kv_valid=None if valid is None else torch.from_numpy(valid))
    (out * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5, rtol=0)


def ssd_recurrence(x, dt, A, B, C):
    """Mamba2's SSD as its plain recurrence in float64 (one B/C group):
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t."""
    b, S, h, p = x.shape
    st = torch.zeros(b, h, B.shape[-1], p, dtype=torch.float64)
    ys = []
    for t in range(S):
        st = (torch.exp(dt[:, t] * A)[..., None, None] * st
              + dt[:, t, :, None, None] * B[:, t, 0, None, :, None] * x[:, t, :, None, :])
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, t, 0], st))
    return torch.stack(ys, 1), st


def test_ssd_chunked_gradient_is_finite_where_decays_overflow():
    """One 256-token chunk whose decays exp(a_t - a_j) above the diagonal
    overflow float32 (exponents up to ~420): the port's chunked SSD gives
    the reference's values, and a finite gradient equal to the float64
    recurrence's, where the reference's (a select after the exp) is nan."""
    from repro.models import ssm as jssm
    from repro_torch.models import ssm

    g = torch.Generator().manual_seed(0)
    b, S, h, p, n = 1, 256, 4, 8, 16
    x, B, C = (torch.randn(*sh, generator=g) for sh in ((b, S, h, p), (b, S, 1, n), (b, S, 1, n)))
    dt = torch.rand(b, S, h, generator=g) * 2
    A = -torch.rand(h, generator=g) * 2 - 0.5
    cum = torch.cumsum(dt * A, 1)
    assert float((cum[:, :, None] - cum[:, None]).max()) > 100       # exp overflows

    def jloss(*a):
        y, st = jssm._ssd_chunked(a[0], a[1], jnp.asarray(A.numpy()), a[2], a[3], S)
        return jnp.sum(y) + jnp.sum(st)

    jargs = [jnp.asarray(t.numpy()) for t in (x, dt, B, C)]
    jy, _ = jssm._ssd_chunked(jargs[0], jargs[1], jnp.asarray(A.numpy()), jargs[2], jargs[3], S)
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(*jargs)
    assert not all(np.isfinite(np.asarray(t)).all() for t in jg)

    ts = [t.clone().requires_grad_(True) for t in (x, dt, B, C)]
    y, st = ssm._ssd_chunked(ts[0], ts[1], A, ts[2], ts[3], S)
    (y.sum() + st.sum()).backward()
    # XLA and torch round the float32 cumsum of exponents up to ~420 apart
    # by ~ulp(420) = 3e-5, each decay by that relative amount: the values
    # within 1e-4 of their max, the gradients within 1e-3 of theirs
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=1e-4 * float(np.abs(np.asarray(jy)).max()))
    ds = [t.double().requires_grad_(True) for t in (x, dt, B, C)]
    y64, st64 = ssd_recurrence(ds[0], ds[1], A.double(), ds[2], ds[3])
    (y64.sum() + st64.sum()).backward()
    for t, t64 in zip(ts, ds):
        assert torch.isfinite(t.grad).all()
        np.testing.assert_allclose(t.grad.numpy(), t64.grad.numpy(), rtol=0,
                                   atol=1e-3 * float(t64.grad.abs().max()))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 4], ids=["plain", "accum4"])
def test_three_train_steps_match_reference(accum):
    """From the reference's init_state, three steps on SyntheticLM batches
    (8 x 16 tokens) in both packages: every metric per step, then the
    parameters, m and v."""
    jcfg, cfg = cfgs("tinyllama-1.1b", **TRAIN_KW)
    jfns, jst, st = ref_and_port_state(jcfg, cfg)
    jstep = jax.jit(jts.make_train_step(
        jfns, jcfg, lr_schedule=functools.partial(jsched.warmup_cosine, **SCHED_KW),
        accum=accum))
    step = train_step.make_train_step(
        model_fns(cfg), cfg, lr_schedule=functools.partial(schedule.warmup_cosine, **SCHED_KW),
        accum=accum)
    data, jdata = pipeline.SyntheticLM(64, 16, 8, seed=1), jpipe.SyntheticLM(64, 16, 8, seed=1)
    for s in range(3):
        jst, jm = jstep(jst, jdata.batch(s))
        st, m = step(st, data.batch(s))
        assert m.keys() == jm.keys()
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {s} {k}")
    assert int(st["step"]) == int(jst["step"]) == int(st["opt"]["step"]) == 3
    want = carried(jst["params"], cfg)
    for name, p in st["params"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-5, rtol=0,
                                   err_msg=name)
    for part in ("m", "v"):
        want = carried(jst["opt"][part], cfg)
        for name, t in st["opt"][part].items():
            np.testing.assert_allclose(t.numpy(), want[name], atol=1e-5, rtol=0,
                                       err_msg=f"{part} {name}")


#: a compressed target within this share of a quantum of a rounding
#: boundary (q + 1/2) * scale may round apart between the packages (their
#: float32 gradients differ by up to ~5e-5 of a quantum at this size)
NEAR_BOUNDARY = 1e-3


def test_three_compressed_train_steps_match_reference(monkeypatch):
    """compress_grads=True.  The int8 quantizer rounds target / scale to an
    integer, so a target near a rounding boundary can round apart between
    the packages; such a flip moves that element's err by one quantum and
    its update by up to lr, and two free-running runs part from there.  So
    each of three steps starts both packages from the reference's state
    (state_from_reference), and every element that differs beyond the
    tolerance must be a near-boundary target of that step (the port's,
    recorded from its quantize): the metrics within 1e-5 (grad_norm plus
    the near-boundary elements' quanta), the parameters, m and v within
    1e-5, err within 1e-5 of its leaf's max |target| (at least 1e-5; err
    is a gradient) and near-boundary elements within one quantum more.
    A scanned run's layers share one scale, the reference's per-leaf
    scale of their stacked leaf."""
    jcfg, cfg = cfgs("tinyllama-1.1b", **TRAIN_KW)
    jfns, jst, _ = ref_and_port_state(jcfg, cfg, compress_grads=True)
    jstep = jax.jit(jts.make_train_step(
        jfns, jcfg, lr_schedule=functools.partial(jsched.warmup_cosine, **SCHED_KW),
        compress_grads=True))
    step = train_step.make_train_step(
        model_fns(cfg), cfg, lr_schedule=functools.partial(schedule.warmup_cosine, **SCHED_KW),
        compress_grads=True)
    seen = []
    quantize = train_step.compression._quantize

    def recording(t, sc):
        seen.append((t.detach().clone(), float(sc)))
        return quantize(t, sc)

    monkeypatch.setattr(train_step.compression, "_quantize", recording)
    data = pipeline.SyntheticLM(64, 16, 8, seed=1)
    n_near = 0
    for s in range(3):
        st = train_step.state_from_reference(jax.tree.map(np.asarray, jst), cfg, "cpu")
        names = [n for n, _ in st["params"].named_parameters()]
        seen.clear()
        jst, jm = jstep(jst, data.batch(s))
        st, m = step(st, data.batch(s))
        near, quantum, top = {}, {}, {}
        for name, (t, sc) in zip(names, seen, strict=True):
            x = (t / sc).numpy()
            near[name] = np.abs(np.abs(x - np.floor(x)) - 0.5) <= NEAR_BOUNDARY
            quantum[name], top[name] = sc, float(t.abs().max())
        n_near += sum(int(v.sum()) for v in near.values())
        for k in jm:
            slack = (float(np.sqrt(sum(quantum[n] ** 2 * near[n].sum() for n in names)))
                     if k == "grad_norm" else 0.0)
            assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])) + 1e-7 + slack, \
                (s, k, float(m[k]), float(jm[k]))
        parts = [("params", {n: p.detach() for n, p in st["params"].named_parameters()},
                  jst["params"]), ("m", st["opt"]["m"], jst["opt"]["m"]),
                 ("v", st["opt"]["v"], jst["opt"]["v"]), ("err", st["err"], jst["err"])]
        for part, tree, jtree in parts:
            want = carried(jtree, cfg)
            for name, t in tree.items():
                tol = 1e-5 * max(1.0, top[name]) if part == "err" else 1e-5
                diff = np.abs(t.numpy() - want[name])
                off = diff > tol
                assert not (off & ~near[name]).any(), (s, part, name,
                                                       float(diff[~near[name]].max()))
                if part == "err":
                    assert (diff <= tol + quantum[name] * (1 + 1e-5)).all(), (s, name)
    print(f"near-boundary targets over 3 steps: {n_near}")


#: make_loss_fn(cast_bf16=True) against the reference's: the loss within
#: 5e-7 relative, each leaf's gradient within 1e-2 of its norm (the bf16
#: products round apart by an ulp or two, 2^-8 each).  The float32 path
#: departs by 1.9e-6 to 6e-4 on the loss and 1.3e-2 to 1 on some leaf,
#: and a wrong cast set (1-D leaves, the head or the embedding left in
#: float32, a scanned run's 1-D leaves left uncast) by 1.6e-6 or more on
#: the loss (smoke configs, seed below)
CAST_LOSS_RTOL, CAST_GRAD_RTOL = 5e-7, 1e-2


def assert_cast_bf16_matches_reference(jcfg, cfg, batch):
    """The port's loss and gradients with cast_bf16=True against
    jax.value_and_grad of the reference's, from the reference's state with
    its 1-D leaves scaled by 1 + 0.1 N(0, 1) (norm scales of ones are
    exact in bf16, so a cast of them would not show); and the float32
    path outside the loss tolerance."""
    jfns, jst, _ = ref_and_port_state(jcfg, cfg)
    rng = np.random.default_rng(5)
    jp = jax.tree.map(lambda p: p * (1 + 0.1 * rng.standard_normal(p.shape)).astype(np.float32)
                      if p.ndim == 1 else p, jax.tree.map(np.asarray, jst["params"]))
    model = train_step.state_from_reference(dict(jax.tree.map(np.asarray, jst), params=jp),
                                            cfg, "cpu")["params"]
    (jl_, _), jg = jax.jit(jax.value_and_grad(
        jts.make_loss_fn(jfns, jcfg, cast_bf16=True), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    jg = carried(jg, cfg)
    losses_ = {}
    for cast in (True, False):
        loss, _ = train_step.make_loss_fn(model_fns(cfg), cfg, cast_bf16=cast)(model, batch)
        loss.backward()
        losses_[cast] = float(loss.detach())
        if cast:
            for name, p in model.named_parameters():
                assert p.dtype == p.grad.dtype == torch.float32, name
                want = jg[name]
                assert (np.linalg.norm(p.grad.numpy() - want)
                        <= CAST_GRAD_RTOL * np.linalg.norm(want) + 1e-12), name
        model.zero_grad(set_to_none=True)
    assert abs(losses_[True] - float(jl_)) <= CAST_LOSS_RTOL * abs(float(jl_)), losses_
    assert abs(losses_[False] - float(jl_)) > CAST_LOSS_RTOL * abs(float(jl_)), losses_


def test_cast_bf16_lands_gradients_in_the_fp32_masters():
    """make_loss_fn(cast_bf16=True): the reference's matrices run in bf16
    and the gradients arrive in the float32 parameters, as the
    reference's do (the other kinds in tests/test_torch_train_archs.py)."""
    jcfg, cfg = cfgs("tinyllama-1.1b", **TRAIN_KW)
    batch = pipeline.SyntheticLM(64, 16, 4, seed=2).batch(0)
    assert_cast_bf16_matches_reference(jcfg, cfg, batch)


def test_abstract_state_is_on_the_meta_device():
    _, cfg = cfgs("tinyllama-1.1b", **TRAIN_KW)
    st = train_step.init_state(model_fns(cfg), abstract=True, compress_grads=True)
    assert all(p.is_meta and p.requires_grad for p in st["params"].parameters())
    assert st["opt"]["m"].keys() == st["err"].keys() == dict(
        st["params"].named_parameters()).keys()
    assert all(t.is_meta and t.dtype == torch.float32 for t in st["opt"]["v"].values())
    assert st["step"].is_meta and st["step"].dtype == torch.int32
