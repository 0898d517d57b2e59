"""One train step of every arch against repro's, and cfg.remat, on the CPU.

The counterpart of tests/test_models.py::test_smoke_train_step: each of
the ten archs' ``smoke_config`` (float32), the port's state carried from
the reference's ``init_state``, the same numpy batch: the loss and
``grad_norm`` within 1e-4 relative (see the test for the float64 rule
where the two norms part further); and ``make_loss_fn(cast_bf16=True)``
for each kind.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.models import model_fns, moe  # noqa: E402
from repro_torch.train import train_step  # noqa: E402
from tests.test_torch_models import cfgs, family_batch  # noqa: E402
from tests.test_torch_moe import assert_routing_matches, ref_routing  # noqa: E402
from tests.test_torch_train import (assert_cast_bf16_matches_reference,  # noqa: E402
                                    ref_and_port_state)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size torch ops on one thread (see tests/test_torch_moe.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def moe_routing_checked(model, cfg, batch):
    """Forward pre-hooks on each MoE module that hold the port's routing of
    the layer's input to the reference's (ref_routing at the cache-free
    capacity): gate sets equal outside near-ties, near-ties by the rule."""
    def hook(module, args):
        x = args[0].detach().reshape(-1, cfg.d_model).numpy()
        cap = moe._capacity(x.shape[0], cfg.moe)
        probs, want_e, want_keep = ref_routing(
            {"router": jnp.asarray(module.router.detach().numpy())}, jnp.asarray(x), cfg, cap)
        _, _, got_e = moe._route(module, torch.from_numpy(x), cfg)
        order, keep, _, _ = moe._dispatch(got_e, cfg.moe.n_experts, cap)
        kept = torch.zeros_like(keep)
        kept[order] = keep
        assert_routing_matches(probs, want_e, want_keep, got_e.numpy(),
                               kept.view(got_e.shape).numpy(), cap, cfg.moe.n_experts)
        seen.append(x.shape[0])

    seen = []
    handles = [mod.register_forward_pre_hook(hook) for mod in model.modules()
               if isinstance(mod, moe.MoE)]
    return seen, handles


def float64_grad_norm(model, cfg, batch, monkeypatch):
    """The global gradient norm of the loss at ``model``'s weights computed
    in float64: a copy of the model in float64 with ``Tensor.float``
    patched to ``double`` (the layers compute their norms, softmaxes and
    recurrences in ``.float()``)."""
    import copy

    m64 = copy.deepcopy(model).double()
    c64 = cfg.replace(dtype="float64", param_dtype="float64")
    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "float", torch.Tensor.double)
        loss, _ = train_step.make_loss_fn(model_fns(c64), c64)(m64, batch)
        loss.backward()
    return float(np.sqrt(sum(float((p.grad ** 2).sum()) for p in m64.parameters())))


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_one_train_step_matches_reference_every_arch(arch, monkeypatch):
    """The counterpart of tests/test_models.py::test_smoke_train_step: one
    step of the default train step (AdamW, its warm-up) from the
    reference's init_state on a batch of 2 x 32 tokens (and the kind's
    patches or frames): the loss and grad_norm within 1e-4.  Where the
    norms differ by more, the port's must lie within 1e-4 of the float64
    norm (float64_grad_norm) and the reference's within 1e-4 plus the
    reference's own distance from it.  rwkv6's smoke gradient is
    ill-conditioned (a head of layer 1 whose WKV output nearly cancels,
    variance 9e-9 under ln_x's 1e-6): a 1e-7 relative jitter of the
    weights moves it by 5e-4, and XLA's float32 norm lies 1.5e-4 from the
    float64 one, the port's 3e-5.  Every parameter gets a finite gradient
    (flash_attention backpropagates in every arch).  For an MoE the
    routing of every layer is first held to the reference's."""
    jcfg, cfg = cfgs(arch)
    jfns, jst, st = ref_and_port_state(jcfg, cfg)
    batch = family_batch(cfg, 2, 32)
    batch["labels"] = np.random.default_rng(1).integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    model = st["params"]
    if cfg.moe is not None:
        seen, handles = moe_routing_checked(model, cfg, batch)
    loss, _ = train_step.make_loss_fn(model_fns(cfg), cfg)(model, batch)
    loss.backward()
    if cfg.moe is not None:
        for h in handles:
            h.remove()
        assert len(seen) == sum(t == "moe" for t in cfg.layer_types)
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
    model.zero_grad(set_to_none=True)

    _, jm = jax.jit(jts.make_train_step(jfns, jcfg))(jst, {k: jnp.asarray(v) for k, v in
                                                          batch.items()})
    st, m = train_step.make_train_step(model_fns(cfg), cfg)(st, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    got, want = float(m["grad_norm"]), float(jm["grad_norm"])
    assert got > 0
    if abs(got - want) > 1e-4 * want:
        exact = float64_grad_norm(st["params"], cfg, batch, monkeypatch)
        assert abs(got - exact) <= 1e-4 * exact, (got, exact)
        assert abs(got - want) <= 1e-4 * want + abs(want - exact), (got, want, exact)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-small", "zamba2-1.2b"])
def test_remat_gives_the_same_loss_and_gradients(arch):
    """cfg.remat checkpoints each layer: the loss and every gradient equal
    those without it bit for bit, and autograd keeps less."""
    _, cfg = cfgs(arch)
    batch = family_batch(cfg, 2, 32)
    batch["labels"] = batch["tokens"]
    fns = model_fns(cfg)
    model = fns.init(0, device="cpu").requires_grad_(True)
    out = {}
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        kept = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: kept.append(t.numel() * t.element_size()) or t, lambda t: t):
            loss, _ = train_step.make_loss_fn(model_fns(c), c)(model, batch)
        loss.backward()
        out[remat] = (loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()},
                      sum(kept))
        model.zero_grad(set_to_none=True)
    assert torch.equal(out[True][0], out[False][0])
    for name, g in out[False][1].items():
        assert torch.equal(out[True][1][name], g), name
    assert out[True][2] < out[False][2]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "internvl2-1b", "rwkv6-1.6b",
                                  "whisper-small", "zamba2-1.2b"])
def test_cast_bf16_matches_reference_every_kind(arch):
    """make_loss_fn(cast_bf16=True) against the reference's for the kinds
    and layouts the dense LM does not cover: an MoE, a VLM, Whisper and
    two scanned runs, whose 1-D parameters the reference stacks into 2-D
    leaves and casts."""
    jcfg, cfg = cfgs(arch)
    batch = family_batch(cfg, 2, 16, seed=1)
    batch["labels"] = np.roll(batch["tokens"], -1, 1)
    assert_cast_bf16_matches_reference(jcfg, cfg, batch)
