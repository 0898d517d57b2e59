"""repro_torch.data.pipeline and repro_torch.optim against repro's, on the
CPU.

The data pipeline is a copy of the reference's numpy code: its batches are
compared bit for bit.  The schedules within 1 ulp of float32, the cosine
apart (``jnp.cos`` and ``torch.cos`` round a few percent of arguments 1 ulp
apart).  The weight-decay mask leaf for leaf
for all ten archs, from the reference's own ``_decay_mask``.  One AdamW
update from the same parameters and random gradients: parameters, ``m``
and ``v`` within ``ATOL = 1e-6``, ``grad_norm`` within 1e-6 relative of
the float64 norm and of the reference's within that plus the reference's
own distance from it (:func:`assert_norm_close`).  The int8 quantizer bit for
bit, ties at .5 included (both round half to even).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import model_fns as j_model_fns  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.optim import adamw, compression, schedule  # noqa: E402
from tests.test_torch_models import cfgs  # noqa: E402

ATOL = 1e-6


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------

def assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("shard", [None, (0, 4), (3, 4)], ids=["whole", "shard0of4", "shard3of4"])
def test_synthetic_batches_equal_reference(shard):
    kw = {} if shard is None else {"shard": pipeline.ShardInfo(*shard)}
    jkw = {} if shard is None else {"shard": jpipe.ShardInfo(*shard)}
    src = pipeline.SyntheticLM(100, 32, 8, seed=7, **kw)
    ref = jpipe.SyntheticLM(100, 32, 8, seed=7, **jkw)
    for step in (0, 5, 1000):
        assert_batches_equal(src.batch(step), ref.batch(step))
    # resumed: a fresh source restored from the state gives the same batch
    again = pipeline.SyntheticLM(100, 32, 8, seed=7, **kw)
    again.restore(src.state())
    assert src.state() == ref.state()
    assert_batches_equal(again.batch(42), ref.batch(42))


def test_synthetic_shards_partition_and_differ():
    parts = [pipeline.SyntheticLM(100, 16, 8, seed=3, shard=pipeline.ShardInfo(i, 4))
             .batch(5)["tokens"] for i in range(4)]
    assert all(p.shape == (2, 16) for p in parts)
    assert not np.array_equal(parts[0], parts[1])


@pytest.mark.parametrize("shard", [None, (1, 2)], ids=["whole", "shard1of2"])
def test_token_file_batches_equal_reference(tmp_path, shard):
    path = str(tmp_path / "toks.bin")
    np.random.default_rng(0).integers(0, 1000, size=170 * 17, dtype=np.int32).tofile(path)
    kw = {} if shard is None else {"shard": pipeline.ShardInfo(*shard)}
    jkw = {} if shard is None else {"shard": jpipe.ShardInfo(*shard)}
    src = pipeline.TokenFileSource(path, 16, 8, seed=1, **kw)
    ref = jpipe.TokenFileSource(path, 16, 8, seed=1, **jkw)
    # steps past the first epoch's end (170 samples, 8 a step) wrap
    for step in (0, 1, 5, 21, 22, 40):
        assert_batches_equal(src.batch(step), ref.batch(step))
    b0 = src.batch(0)
    np.testing.assert_array_equal(b0["labels"][:, :-1], b0["tokens"][:, 1:])
    again = pipeline.TokenFileSource(path, 16, 8, seed=1, **kw)
    again.restore(src.state())
    assert_batches_equal(again.batch(22), ref.batch(22))


@pytest.mark.parametrize("n", [1, 2, 7, 170, 1000, 4097])
def test_feistel_is_a_permutation_equal_to_reference(n):
    idx = np.arange(n)
    for key in (0, 1, 12345):
        got = pipeline._feistel(idx, n, key)
        np.testing.assert_array_equal(got, jpipe._feistel(idx, n, key))
        np.testing.assert_array_equal(np.sort(got), idx)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

class CosFrom:
    """``jax.numpy`` with ``cos`` replaced by ``fn`` (float32 in and out)."""

    def __init__(self, fn):
        self.fn = fn

    def __getattr__(self, name):
        return getattr(jnp, name)

    def cos(self, x):
        return jnp.asarray(self.fn(np.asarray(x, np.float32)), jnp.float32)


def torch_cos(x):
    return torch.cos(torch.from_numpy(np.array(x, np.float32))).numpy()


@pytest.mark.parametrize("kw", [dict(peak_lr=3e-4, warmup_steps=5, total_steps=100),
                                dict(peak_lr=1e-3, warmup_steps=100, total_steps=10000),
                                dict(peak_lr=3e-4, warmup_steps=0, total_steps=30,
                                     final_frac=0.0)],
                         ids=["short", "launcher_default", "no_warmup"])
def test_warmup_cosine_within_one_ulp(kw, monkeypatch):
    """Over steps 0 to past the end, in two parts.  The cosines: torch's
    float32 cos and XLA's (glibc's cosf on the CPU) of the same argument
    within 1 ulp; they differ at a few percent of arguments.  The
    schedule: within 1 ulp of the reference's own formula given torch's
    cosine (``1 + cos`` near the end turns one ulp of the cosine into
    several of the rate, so the two packages' rates are held to 1e-6
    relative)."""
    steps = list(range(0, kw["total_steps"] + 20, max(1, kw["total_steps"] // 200)))
    got = np.array([schedule.warmup_cosine(s, **kw).item() for s in steps], np.float32)
    plain = np.array([np.asarray(jsched.warmup_cosine(s, **kw)) for s in steps], np.float32)
    np.testing.assert_allclose(got, plain, rtol=1e-6, atol=0)
    args = np.array([np.float32(np.pi) * np.clip(
        (np.float32(s) - kw["warmup_steps"]) / np.float32(max(kw["total_steps"]
                                                               - kw["warmup_steps"], 1)),
        0, 1) for s in steps], np.float32)
    np.testing.assert_array_max_ulp(torch_cos(args), np.asarray(jnp.cos(args)), maxulp=1)
    monkeypatch.setattr(jsched, "jnp", CosFrom(torch_cos))
    want = np.array([np.asarray(jsched.warmup_cosine(s, **kw)) for s in steps], np.float32)
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    # a tensor step gives the int's value, as a float32 tensor
    t = schedule.warmup_cosine(torch.tensor(7, dtype=torch.int32), **kw)
    assert t.dtype == torch.float32 and t.item() == schedule.warmup_cosine(7, **kw).item()


def test_constant_equals_reference():
    for s in (0, 3, torch.tensor(9, dtype=torch.int32)):
        got = schedule.constant(s, peak_lr=3e-4, warmup_steps=5)
        assert got.dtype == torch.float32 and got.shape == ()
        assert got.item() == float(np.asarray(jsched.constant(0, peak_lr=3e-4)))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_decay_mask_equals_reference_leaf_for_leaf(arch):
    """The reference's mask, carried onto the port's names by the leaf map
    of params_from_reference, equals the port's for every parameter: the
    substring quirk included ("u" exempts w_up, the experts' up, the
    router and out_proj from decay)."""
    jcfg, cfg = cfgs(arch)
    jshapes = jax.eval_shape(j_model_fns(jcfg).init, jax.random.PRNGKey(0))
    jmask = jadamw._decay_mask(jshapes, jadamw.AdamWConfig())
    carried = registry.reference_leaves(
        jax.tree.map(lambda m, s: np.broadcast_to(np.bool_(m), s.shape), jmask, jshapes), cfg)
    model = registry.model_class(cfg)(cfg, device="meta")
    got = adamw._decay_mask(registry.reference_paths(model, cfg), adamw.AdamWConfig())
    assert got.keys() == carried.keys()
    for name, m in carried.items():
        assert m.all() == m.any(), name
        assert got[name] == bool(m.all()), name
    # the quirk, by name
    for name, dec in got.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("w_up", "up", "router", "out_proj", "scale", "bias"):
            assert not dec, name
        if leaf in ("w_gate", "w_down", "gate", "wq", "wo"):
            assert dec, name


def ref_state(arch, seed=0):
    """(reference cfg and params, port cfg and model) of ``arch``'s smoke
    config in float32."""
    jcfg, cfg = cfgs(arch)
    jp = jax.jit(j_model_fns(jcfg).init)(jax.random.PRNGKey(seed))
    model = registry.params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, model


def carried(tree, cfg):
    return {n: np.asarray(a) for n, a in
            registry.reference_leaves(jax.tree.map(np.asarray, tree), cfg).items()}


def assert_norm_close(got, want, leaves):
    """``got`` within 1e-6 relative of the float64 norm of ``leaves``, and
    of the reference's ``want`` within that plus the reference's own
    distance from it: XLA sums the ~10^6 float32 squares in another order
    than torch, and its sum lies up to ~8e-7 from the float64 one
    (granite's smoke gradients), torch's ~3e-8."""
    exact = float(np.sqrt(sum(np.sum(t.double().numpy() ** 2) for t in leaves)))
    assert abs(got - exact) <= 1e-6 * exact, (got, exact)
    assert abs(got - want) <= 1e-6 * exact + abs(want - exact), (got, want, exact)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-1b-a400m"])
def test_update_equals_reference(arch):
    """Two AdamW updates from the same parameters and random gradients
    (clipped: their global norm is far above 1), weight decay on."""
    _, jp, cfg, model = ref_state(arch)
    rng = np.random.default_rng(3)
    jst = jadamw.init(jp)
    st = adamw.init(model)
    opt = jadamw.AdamWConfig()
    decay = adamw._decay_mask(registry.reference_paths(model, cfg), adamw.AdamWConfig())
    for lr in (1e-3, 5e-4):
        jg = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32), jp)
        g = {n: torch.from_numpy(a.copy()) for n, a in carried(jg, cfg).items()}
        jp, jst, jm = jadamw.update(jg, jst, jp, lr, opt)
        model, st, m = adamw.update(g, st, model, lr, adamw.AdamWConfig(), decay=decay)
        assert float(jm["grad_norm"]) > 10
        assert_norm_close(float(m["grad_norm"]), float(jm["grad_norm"]), g.values())
        assert m["lr"].dtype == torch.float32 and float(m["lr"]) == float(jm["lr"])
    assert int(st["step"]) == int(jst["step"]) == 2
    want_p = carried(jp, cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[name], atol=ATOL, rtol=0)
    for part in ("m", "v"):
        want = carried(jst[part], cfg)
        for name, t in st[part].items():
            assert t.dtype == torch.float32
            np.testing.assert_allclose(t.numpy(), want[name], atol=ATOL, rtol=0)


def test_global_norm_is_the_float32_norm_of_every_leaf():
    leaves = {"a": torch.arange(6.0).view(2, 3), "b": torch.tensor([3.0, 4.0]),
              "h": torch.tensor([2.0], dtype=torch.bfloat16)}
    got = adamw.global_norm(leaves)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(np.sqrt(55 + 25 + 4))) < 1e-5


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------

def test_quantize_ties_round_half_to_even_as_reference():
    """max |g| = 127 makes the scale 1, so g / scale keeps its .5 ties."""
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5, -127.0, 0.0],
                 np.float32)
    q, s = compression.quantize(torch.from_numpy(g))
    jq, js = jcomp.quantize(jnp.asarray(g))
    assert float(s) == float(js) == 1.0 and q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(q.numpy()[1:8], [0, 2, 2, 0, -2, -2, 4])
    np.testing.assert_array_equal(compression.dequantize(q, s).numpy(),
                                  np.asarray(jcomp.dequantize(jq, js)))


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_and_compress_tree_bit_equal(seed):
    rng = np.random.default_rng(seed)
    grads = {"a": rng.normal(size=(64, 33)).astype(np.float32) * 1e-3,
             "b": rng.standard_cauchy(size=(257,)).astype(np.float32),
             "z": np.zeros((5,), np.float32)}
    err = {k: (rng.normal(size=v.shape) * 1e-5).astype(np.float32) for k, v in grads.items()}
    for k, g in grads.items():
        q, s = compression.quantize(torch.from_numpy(g))
        jq, js = jcomp.quantize(jnp.asarray(g))
        assert float(s) == float(js)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    deq, new_err = compression.compress_tree({k: torch.from_numpy(v) for k, v in grads.items()},
                                             {k: torch.from_numpy(v) for k, v in err.items()})
    jdeq, jerr = jcomp.compress_tree({k: jnp.asarray(v) for k, v in grads.items()},
                                     {k: jnp.asarray(v) for k, v in err.items()})
    for k in grads:
        np.testing.assert_array_equal(deq[k].numpy(), np.asarray(jdeq[k]))
        np.testing.assert_array_equal(new_err[k].numpy(), np.asarray(jerr[k]))


def test_compress_tree_shares_a_scale_per_reference_leaf():
    """Two layers of a scanned run are one stacked leaf in the reference,
    quantized with one scale: the port's groups give the same bits."""
    rng = np.random.default_rng(4)
    stacked = rng.normal(size=(2, 40)).astype(np.float32)
    stacked[1] *= 10.0
    zeros = np.zeros_like(stacked)
    jdeq, jerr = jcomp.compress_tree({"w": jnp.asarray(stacked)}, {"w": jnp.asarray(zeros)})
    names = {"blocks.0.w": "blocks/0/w", "blocks.1.w": "blocks/0/w"}
    grads = {n: torch.from_numpy(stacked[i].copy()) for i, n in enumerate(names)}
    err = {n: torch.zeros(40) for n in names}
    deq, new_err = compression.compress_tree(grads, err, names)
    for i, n in enumerate(names):
        np.testing.assert_array_equal(deq[n].numpy(), np.asarray(jdeq["w"])[i])
        np.testing.assert_array_equal(new_err[n].numpy(), np.asarray(jerr["w"])[i])
    alone, _ = compression.compress_tree(grads, err)
    assert not torch.equal(alone["blocks.0.w"], deq["blocks.0.w"])


def test_compression_error_feedback_bounded(rng):
    """The reference's EF property through the port: the accumulated
    residual stays bounded over many steps."""
    g = {"g": torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))}
    err = {"g": torch.zeros(256)}
    for _ in range(50):
        deq, new = compression.compress_tree(g, err)
        # no signal lost: deq + new err == g + old err
        np.testing.assert_allclose((deq["g"] + new["g"]).numpy(), (g["g"] + err["g"]).numpy(),
                                   atol=1e-6, rtol=0)
        err = new
    assert float(err["g"].abs().max()) < float(g["g"].abs().max()) * 0.05


def test_init_error_is_float32_zeros_by_name():
    _, _, cfg, model = ref_state("tinyllama-1.1b")
    err = compression.init_error(model)
    assert err.keys() == dict(model.named_parameters()).keys()
    assert all(e.dtype == torch.float32 and not e.any() for e in err.values())
