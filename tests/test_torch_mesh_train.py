"""Training on a (data, model) mesh: the port on 4 gloo ranks against one
process, and its sharded MoE against the reference's.

* Three train steps of a dense (tinyllama), an MoE (granite-moe), an
  rwkv6 and a zamba2 smoke config in float32 (rwkv6 in float64:
  ``TRAIN_DTYPES``), with and without int8 gradient
  compression, on a ``(2, 2)`` ``("data", "model")`` mesh and on a
  ``(1, 2, 2)`` ``("pod", "data", "model")`` mesh (one spawn each,
  tests/torch_mesh_worker.py): parameters, moments and error feedback
  placed by ``launch.dryrun.param_shardings`` under
  ``default_rules(fsdp=True)``, each rank's rows of the global batch a
  DTensor (``make_process_local_array``).  Against the same steps in one
  process on the whole batch: the losses at every step within
  ``LOSS_RTOL``, the first step's gradients within ``GRAD_RTOL`` of each
  leaf's largest (the compressed ones within one quantizer step of their
  leaf, where a rounding near a half step may flip), the parameters after
  three steps within ``PARAM_ATOL``.  Attention, the GLU MLP, rwkv6's
  time and channel mix, the SSD and the head compute each rank's share of
  the query heads, ffn columns, rwkv6 and SSD heads and logit columns over
  ``"model"`` (``placement.model_split``; the cross-entropy
  vocab-parallel): every parameter replicated over ``"model"`` is bitwise
  equal across the ranks of a model group after the steps,
  ``flash_attention`` sees ``n_heads / tp`` query heads on each rank, the
  WKV recurrence ``n_heads / tp``, the SSD scan ``nh / tp``, and each
  chunk of the loss ``V / tp`` logit columns.  The tied arch run
  again with its ``embed.table`` placed replicated over ``"model"`` (the
  head takes the table's rows, the lookup the whole table): its table
  bitwise equal across each model group, its losses and parameters those
  of one process.  The MoE's capacity comes from each
  rank's tokens and its aux loss is averaged over the data ranks (the
  reference's ``_moe_sharded``), so the one-process run applies the MoE
  to each data shard's rows of the batch apart (``split_moe``).
* The port's ``_moe_sharded`` on the ``(2, 2)`` mesh against the
  reference's on 4 XLA host devices (``moe_apply`` under
  ``default_rules``, jitted, in a subprocess), from the same numpy inputs,
  at ``no_drop`` and with drops, within the reference's 2e-4
  (tests/test_distributed.py::test_sharded_vs_local_moe_equivalence).
* A plain batch whose rows the data axes do not divide is the whole batch
  on every rank, and the MoE takes the local path (the reference's
  fall-back when ``B % dp_size != 0``): one step equals one process's.
* The reference's elastic case (tests/test_distributed.py:132) on gloo: a
  leaf placed on the 4-rank mesh saved, ``remesh`` onto 3 ranks, restored
  bit for bit; the dense arch's placed train state the same way.
* A sharded search over ``("pod", "data")`` of the ``(1, 2, 2)`` mesh,
  ``"model"`` replicated, equals the brute force on every rank.
* The dry-run's prefill and decode steps (``launch.dryrun.build_cell``
  at ``SERVE_SEQ`` tokens, ``SERVE_BATCH`` rows, smoke configs in float32:
  an untied, a tied, an rwkv6 and a zamba2 arch) on both meshes: every
  rank's logits (gathered whole over ``"model"`` and the data axes) equal
  one process's within ``SERVE_RTOL`` of the largest |logit|, and each
  rank computes ``n_heads / tp`` query heads, ``d_ff / tp`` ffn columns,
  its share of rwkv6's and the cache-free SSD's heads and ``V / tp``
  logit columns.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ref as j_ref  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch.dryrun import param_specs  # noqa: E402
from repro_torch.models import model_fns, moe, registry  # noqa: E402
from repro_torch.optim import adamw, compression  # noqa: E402
from repro_torch.train.train_step import init_state, make_train_step  # noqa: E402
from tests.test_torch_distributed import assert_same_topk, corpus  # noqa: E402
from tests.torch_dist_worker import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = str(ROOT / "tests" / "torch_mesh_worker.py")
ARCHS = ("tinyllama-1.1b", "granite-moe-1b-a400m", "rwkv6-1.6b", "zamba2-1.2b")
#: the train runs' activation dtype where it is not float32: rwkv6's smoke
#: gradients move by up to 4.5e-5 of their largest when its weights are
#: perturbed by 1e-7, relative (its per-head norm divides small outputs),
#: so in float32 a split that only reorders sums cannot be told from one
#: that is wrong at GRAD_RTOL; in float64 its gradients meet it
TRAIN_DTYPES = {"rwkv6-1.6b": "float64"}
MESHES = {"2x2": ([2, 2], ["data", "model"]), "1x2x2": ([1, 2, 2], ["pod", "data", "model"])}
N_DP = 2            # the data ranks of both meshes
B, S, STEPS = 4, 32, 3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
PARAM_ATOL = 1e-4
MOE_ATOL = 2e-4     # the reference's own (tests/test_distributed.py:107)
SEARCH_K = 7
TIED_ARCH = "granite-moe-1b-a400m"
SERVE_ARCHS = ("tinyllama-1.1b", "granite-3-2b", "rwkv6-1.6b", "zamba2-1.2b")
SERVE_SEQ, SERVE_BATCH = 64, 4
SERVE_RTOL = 1e-5


def train_config(arch: str):
    """The smoke config the train runs use (``TRAIN_DTYPES``)."""
    return smoke_config(arch).replace(dtype=TRAIN_DTYPES.get(arch, "float32"))


def batches() -> dict:
    rng = np.random.default_rng(5)
    out = {}
    for i in range(STEPS):
        out[f"tokens_{i}"] = rng.integers(0, 128, (B, S)).astype(np.int32)
        out[f"labels_{i}"] = rng.integers(0, 128, (B, S)).astype(np.int32)
    for k in ("tokens", "labels"):                  # 3 rows over 2 data ranks
        out[f"odd_{k}"] = rng.integers(0, 128, (B - 1, S)).astype(np.int32)
    return out


def moe_inputs() -> dict:
    rng = np.random.default_rng(9)
    d, f = 64, 128          # smoke_config("mixtral-8x22b")'s d_model, d_ff
    return dict(moe_x=rng.normal(size=(4, 8, d)).astype(np.float32),
                moe_router=(rng.normal(size=(d, 4)) / 8).astype(np.float32),
                moe_up=(rng.normal(size=(4, d, f)) / 8).astype(np.float32),
                moe_gate=(rng.normal(size=(4, d, f)) / 8).astype(np.float32),
                moe_down=(rng.normal(size=(4, f, d)) / 11).astype(np.float32),
                moe_cf=1.0, moe_cf_nodrop=4.0)


REFERENCE_MOE = """
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import smoke_config
    from repro.dist import sharding as shd
    from repro.models.config import MoEConfig
    from repro.models.moe import moe_apply
    inp = dict(np.load(sys.argv[1]))
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    out = {}
    for cf, no_drop in ((float(inp["moe_cf_nodrop"]), True), (float(inp["moe_cf"]), False)):
        cfg = smoke_config("mixtral-8x22b").replace(
            dtype="float32", moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=cf))
        p = {"router": jnp.asarray(inp["moe_router"]),
             "experts": {n: jnp.asarray(inp[f"moe_{n}"]) for n in ("up", "gate", "down")}}
        shd.set_rules(mesh, shd.default_rules(fsdp=False))
        y, aux = jax.jit(lambda p_, x_: moe_apply(p_, x_, cfg, no_drop=no_drop))(
            p, jnp.asarray(inp["moe_x"]))
        shd.set_rules(None, None)
        out[f"y_{int(no_drop)}"], out[f"aux_{int(no_drop)}"] = np.asarray(y), np.asarray(aux)
    np.savez(sys.argv[2], **out)
"""


def start_reference_moe(workdir: Path, inputs: dict) -> subprocess.Popen:
    """The reference's sharded MoE on 4 XLA host devices, in a subprocess
    (the test process keeps one device)."""
    np.savez(workdir / "moe_in.npz", **inputs)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": str(ROOT / "src")}
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(REFERENCE_MOE),
                             str(workdir / "moe_in.npz"), str(workdir / "moe_out.npz")],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both meshes' spawns (the 2x2 one with the MoE, the elastic case and
    the reference's MoE beside it; the 1x2x2 one with the search)."""
    db, q = corpus(seed=21, n=900)
    common = dict(archs=np.asarray(ARCHS),
                  dtypes=np.asarray([train_config(a).dtype for a in ARCHS]),
                  steps=STEPS, tied_arch=TIED_ARCH,
                  serve_archs=np.asarray(SERVE_ARCHS), serve_seq=SERVE_SEQ,
                  serve_batch=SERVE_BATCH, **batches())
    out = {}
    wd = tmp_path_factory.mktemp("mesh_2x2")
    ref = start_reference_moe(wd, moe_inputs())
    try:
        out["2x2"] = run_ranks(4, wd, dict(
            common, **moe_inputs(),
            parts=np.asarray(["train", "replicated", "moe", "serve", "elastic"]),
            mesh_shape=np.asarray(MESHES["2x2"][0]), mesh_dims=np.asarray(MESHES["2x2"][1])),
            worker=WORKER)
        log, _ = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-3000:]
    out["reference_moe"] = dict(np.load(wd / "moe_out.npz"))
    out["1x2x2"] = run_ranks(4, tmp_path_factory.mktemp("mesh_1x2x2"), dict(
        common, db=db, q=q, n_shards=4, k=SEARCH_K,
        parts=np.asarray(["train", "serve", "search"]),
        mesh_shape=np.asarray(MESHES["1x2x2"][0]), mesh_dims=np.asarray(MESHES["1x2x2"][1])),
        worker=WORKER)
    out["search"] = (db, q)
    return out


@pytest.fixture(scope="module")
def one_process():
    """Each (arch, compress) run in this process on the whole batch: losses,
    the first step's raw and dequantized gradients, the parameters after
    the steps.  The MoE runs on each data shard's rows apart."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    local_moe = moe.moe_apply

    def split_moe(p, x, cfg, *, no_drop=False, experts=None):
        ys, auxs = zip(*(local_moe(p, xc, cfg, no_drop=no_drop) for xc in x.chunk(N_DP)))
        return torch.cat(ys), sum(auxs) / N_DP

    update, compress_tree = adamw.update, compression.compress_tree
    seen = {}

    def spy_update(grads, *a, **kw):
        seen.setdefault("update", {n: g.detach().clone() for n, g in grads.items()})
        return update(grads, *a, **kw)

    def spy_compress(grads, *a, **kw):
        seen.setdefault("raw", {n: g.detach().clone() for n, g in grads.items()})
        return compress_tree(grads, *a, **kw)

    moe.moe_apply, adamw.update, compression.compress_tree = (split_moe, spy_update,
                                                               spy_compress)
    out, data = {}, batches()
    try:
        for arch in ARCHS:
            cfg = train_config(arch)
            fns = model_fns(cfg)
            for compress in (False, True):
                seen.clear()
                state = init_state(fns, 0, device="cpu", compress_grads=compress)
                step = make_train_step(fns, cfg, compress_grads=compress)
                losses = []
                for i in range(STEPS):
                    state, m = step(state, {k: data[f"{k}_{i}"] for k in ("tokens", "labels")})
                    losses.append(float(m["loss"]))
                raw = seen.get("raw", seen["update"])
                paths = registry.reference_paths(state["params"], cfg)
                top = {}
                for n, g in raw.items():
                    top[paths[n]] = max(top.get(paths[n], 0.0), float(g.abs().max()))
                out[arch, compress] = dict(
                    loss=np.asarray(losses), update=seen["update"],
                    steps={n: top[paths[n]] / 127.0 for n in raw},
                    params={n: p.detach().clone()
                            for n, p in state["params"].named_parameters()})
    finally:
        moe.moe_apply, adamw.update, compression.compress_tree = (local_moe, update,
                                                                   compress_tree)
        torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "compressed"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_train_matches_one_process(runs, one_process, mesh, arch, compress):
    want = one_process[arch, compress]
    tag = f"{arch}|{int(compress)}"
    outs = runs[mesh]
    for out in outs:
        np.testing.assert_allclose(out[f"{tag}|loss"], want["loss"], rtol=LOSS_RTOL)
    got = outs[0]
    for name, g in want["update"].items():
        g = g.numpy()
        top = max(float(np.abs(g).max()), 1e-30)
        if compress:
            # the dequantized gradient: within one quantizer step of its
            # reference leaf (a value within an ulp of a half step rounds
            # either way)
            step = want["steps"][name]
            np.testing.assert_allclose(got[f"{tag}|grad|{name}"], g,
                                       atol=GRAD_RTOL * top + 1.001 * step, rtol=0, err_msg=name)
        else:
            np.testing.assert_allclose(got[f"{tag}|grad|{name}"], g, atol=GRAD_RTOL * top,
                                       rtol=0, err_msg=name)
        np.testing.assert_allclose(got[f"{tag}|param|{name}"], want["params"][name].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_replicated_parameters_agree_across_each_model_group(runs, mesh):
    """The gradients of the split layers' weights are summed over
    ``"model"``, so a weight replicated over it (the dense MLP's, FSDP
    only) stays bitwise equal on every rank of a model group; so does the
    tied ``embed.table`` placed replicated over ``"model"``, whose head
    rows' gradients are all-gathered over it."""
    outs = runs[mesh]
    groups: dict = {}
    for rank, out in enumerate(outs):
        groups.setdefault(tuple(out["model_group"].tolist()), []).append(rank)
    assert sorted(len(g) for g in groups.values()) == [2, 2]
    checked = 0
    for ranks in groups.values():
        first = outs[ranks[0]]
        keys = [k for k in first if "|replicated|" in k]
        assert any("|replicated|blocks.0.mlp.w_up" in k for k in keys)
        assert f"{TIED_ARCH}|table_replicated|replicated|embed.table" in keys
        for rank in ranks[1:]:
            for k in keys:
                np.testing.assert_array_equal(outs[rank][k], first[k], err_msg=k)
                checked += 1
    assert checked > 0


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tied_table_replicated_over_model_matches_one_process(runs, one_process, mesh):
    """The tied arch with its table replicated over ``"model"``: the
    table's whole gradient is the lookup's plus every share's head rows,
    once (a sum over ``"model"`` would count the lookup's ``tp`` times):
    the losses, the first step's gradients and the parameters after three
    steps within the tolerances of the runs above."""
    want = one_process[TIED_ARCH, False]
    tag = f"{TIED_ARCH}|table_replicated"
    for out in runs[mesh]:
        np.testing.assert_allclose(out[f"{tag}|loss"], want["loss"], rtol=LOSS_RTOL)
    got = runs[mesh][0]
    for name, g in want["update"].items():
        g = g.numpy()
        np.testing.assert_allclose(got[f"{tag}|grad|{name}"], g,
                                   atol=GRAD_RTOL * max(float(np.abs(g).max()), 1e-30), rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(got[f"{tag}|param|{name}"], want["params"][name].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_loss_sees_its_share_of_the_vocabulary(runs, mesh):
    """Each chunk of each rank's loss holds ``V / tp`` logit columns (the
    smoke configs' 128 over the mesh's 2 ``"model"`` ranks), never the
    whole ``[B, c, V]``."""
    tp = dict(zip(MESHES[mesh][1], MESHES[mesh][0]))["model"]
    for arch in ARCHS:
        for out in runs[mesh]:
            for compress in (0, 1):
                got = out[f"{arch}|{compress}|vocab_cols"].tolist()
                assert got == [smoke_config(arch).vocab // tp], (arch, got)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_serve_steps_match_one_process(runs, mesh, arch, kind):
    tag = f"serve|{arch}|{kind}"
    outs = runs[mesh]
    want = outs[0][f"{tag}|one_process"]
    assert want.shape == (SERVE_BATCH, 1, smoke_config(arch).vocab)
    top = float(np.abs(want).max())
    for out in outs:
        np.testing.assert_allclose(out[f"{tag}|logits"], want, atol=SERVE_RTOL * top, rtol=0)


def ssd_heads(cfg) -> int:
    return cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_serve_steps_compute_their_shares(runs, mesh):
    """Prefill's attention (cache-free) and decode's (the rank's KV heads
    of the cache) see ``n_heads / tp`` query heads (zamba2's shared block
    too); the GLU MLP ``d_ff / tp`` columns; the head ``V / tp`` columns.
    rwkv6's WKV recurrence sees ``n_heads / tp`` heads in both steps (the
    decode reads the rank's heads of its ``wkv_state``) and its ``"ffn"``
    annotations, the time mix's gate and the channel mix's key, ``d_model
    / tp`` and ``d_ff / tp`` columns.  zamba2's cache-free SSD (prefill)
    sees ``nh / tp`` heads; its cached decode computes whole and takes no
    chunked scan."""
    tp = dict(zip(MESHES[mesh][1], MESHES[mesh][0]))["model"]
    for arch in SERVE_ARCHS:
        cfg = smoke_config(arch)
        attn = "attn" in cfg.layer_types or "shared_attn" in cfg.layer_types
        rwkv = "rwkv6" in cfg.layer_types
        for out in runs[mesh]:
            for kind in ("prefill", "decode"):
                tag = f"serve|{arch}|{kind}"
                assert out[f"{tag}|heads"].tolist() == ([cfg.n_heads // tp] if attn else [])
                assert out[f"{tag}|ffn"].tolist() == (
                    sorted({cfg.d_model // tp, cfg.d_ff // tp}) if rwkv else [cfg.d_ff // tp])
                assert out[f"{tag}|vocab"].tolist() == [cfg.vocab // tp], (arch, kind)
                assert out[f"{tag}|rwkv_heads"].tolist() == ([cfg.n_heads // tp] if rwkv
                                                             else [])
                ssd = "mamba2" in cfg.layer_types and kind == "prefill"
                assert out[f"{tag}|ssd_heads"].tolist() == ([ssd_heads(cfg) // tp] if ssd
                                                            else []), (arch, kind)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_share_collectives_and_their_gradients(runs, mesh):
    """``gather_shares``: every rank of a model group holds the blocks of
    all its ranks in rank order, and its gradient is its own block of the
    whole's; ``take_share``: rank r's block of a tensor equal on every
    rank, and the tensor's gradient every rank's block's, all-gathered
    (block q scaled by q + 1 on every rank)."""
    tp = dict(zip(MESHES[mesh][1], MESHES[mesh][0]))["model"]
    weights = np.arange(2 * 3 * tp, dtype=np.float32).reshape(2, 3 * tp)
    whole = np.arange(tp * 2 * 3, dtype=np.float32).reshape(tp * 2, 3)
    assert sorted(int(out["model_index"]) for out in runs[mesh]) == sorted(list(range(tp)) * 2)
    for out in runs[mesh]:
        r = int(out["model_index"])
        np.testing.assert_array_equal(out["gather_shares"],
                                      np.repeat(np.arange(tp, dtype=np.float32), 3)[None]
                                      .repeat(2, 0))
        np.testing.assert_array_equal(out["gather_shares_grad"], weights[:, 3 * r:3 * (r + 1)])
        np.testing.assert_array_equal(out["take_share"], whole[2 * r:2 * (r + 1)])
        np.testing.assert_array_equal(out["take_share_grad"],
                                      np.repeat(np.arange(1, tp + 1, dtype=np.float32), 2)[:, None]
                                      .repeat(3, 1))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_attention_computes_its_share_of_the_heads(runs, mesh):
    """On each rank flash attention sees ``n_heads / tp`` query heads
    (tp = 2, the mesh's ``"model"``), on the attention archs: tinyllama's
    one KV head stays whole (1 % 2), granite-moe's two split, zamba2's
    shared block's four split; rwkv6's WKV recurrence sees ``n_heads /
    tp`` heads, zamba2's SSD ``nh / tp``."""
    tp = dict(zip(MESHES[mesh][1], MESHES[mesh][0]))["model"]
    for arch in ARCHS:
        cfg = smoke_config(arch)
        types = cfg.layer_types
        for out in runs[mesh]:
            for compress in (0, 1):
                tag = f"{arch}|{compress}"
                got = out[f"{tag}|q_heads"].tolist()
                want = ([cfg.n_heads // tp] if {"attn", "moe", "shared_attn"} & set(types)
                        else [])
                assert got == want, (arch, got)
                assert out[f"{tag}|rwkv_heads"].tolist() == (
                    [cfg.n_heads // tp] if "rwkv6" in types else []), arch
                assert out[f"{tag}|ssd_heads"].tolist() == (
                    [ssd_heads(cfg) // tp] if "mamba2" in types else []), arch


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_local_shapes_follow_param_spec(runs, mesh):
    import json

    shape, dims = MESHES[mesh]
    m = shd.AbstractMesh(tuple(shape), tuple(dims))
    shd.set_rules(m, shd.default_rules(fsdp=True, multi_pod="pod" in dims))
    try:
        for arch in ARCHS:
            cfg = smoke_config(arch)
            model = model_fns(cfg).init(0, device="cpu")
            specs = param_specs(model, cfg, m)
            local = json.loads(str(runs[mesh][0][f"{arch}|0|local"]))
            split = 0
            for name, p in model.named_parameters():
                spec = specs[name] + (None,) * (p.ndim - len(specs[name]))
                want = [n // int(np.prod([m.shape[a] for a in
                                          ((s,) if isinstance(s, str) else s)]))
                        if s is not None else n for n, s in zip(p.shape, spec)]
                assert local[name] == want, (arch, name)
                split += want != list(p.shape)
            assert split > 0, arch
    finally:
        shd.set_rules(None, None)


@pytest.mark.parametrize("no_drop", [True, False], ids=["no_drop", "drops"])
def test_moe_sharded_matches_the_reference(runs, no_drop):
    ref = runs["reference_moe"]
    y = np.zeros_like(ref[f"y_{int(no_drop)}"])
    for out in runs["2x2"]:
        lo, hi = out["moe_rows"]
        y[lo:hi] = out[f"moe_y_{int(no_drop)}"]
        np.testing.assert_allclose(float(out[f"moe_aux_{int(no_drop)}"]),
                                   float(ref[f"aux_{int(no_drop)}"]), atol=MOE_ATOL)
    np.testing.assert_allclose(y, ref[f"y_{int(no_drop)}"], atol=MOE_ATOL)
    # the experts' d_ff on "model", their first dim FSDP on "data"
    placed = str(runs["2x2"][0]["moe_placements"])
    assert "'experts.up': '(Shard(dim=0), Shard(dim=2))'" in placed
    assert "'experts.down': '(Shard(dim=0), Shard(dim=1))'" in placed


def test_moe_with_drops_drops_tokens(runs):
    """The drops case is a real one: its output differs from no_drop's."""
    ref = runs["reference_moe"]
    assert np.abs(ref["y_0"] - ref["y_1"]).max() > 1e-3


def test_replicated_batch_takes_the_local_moe(runs):
    cfg = smoke_config(ARCHS[1])
    fns = model_fns(cfg)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state = init_state(fns, 0, device="cpu")
        data = batches()
        state, m = make_train_step(fns, cfg)(state, {k: data[f"odd_{k}"]
                                                     for k in ("tokens", "labels")})
    finally:
        torch.set_num_threads(threads)
    for out in runs["2x2"]:
        assert int(out["replicated_sharded_calls"]) == 0
        np.testing.assert_allclose(float(out["replicated_loss"]), float(m["loss"]),
                                   rtol=LOSS_RTOL)
    for n, p in state["params"].named_parameters():
        np.testing.assert_allclose(runs["2x2"][0][f"replicated|param|{n}"],
                                   p.detach().numpy(), atol=PARAM_ATOL, rtol=0, err_msg=n)


def test_elastic_restore_onto_three_ranks(runs):
    outs = runs["2x2"]
    for rank, out in enumerate(outs):
        assert out["remesh_shape"].tolist() == [3, 1]
        if rank == 3:
            assert "elastic_w" not in out          # the lost rank holds nothing
            continue
        np.testing.assert_array_equal(out["elastic_w"], np.arange(64).reshape(8, 8))
        np.testing.assert_array_equal(out["elastic_w_local"], np.arange(64).reshape(8, 8))
        assert int(out["elastic_step"]) == 2
        assert out["elastic_not_placed"].size == 0
    assert bool(outs[0]["elastic_state_equal"])


def test_search_over_pod_and_data_equals_brute(runs):
    db, q = runs["search"]
    sref, iref = j_ref.brute_force_knn(q, db, SEARCH_K)
    outs = runs["1x2x2"]
    for out in outs:
        assert str(out["search_backend"]) == "sharded"
        assert_same_topk(out["search_s"], out["search_i"], sref, iref, 2e-5)
        np.testing.assert_array_equal(out["search_s"], outs[0]["search_s"])
        np.testing.assert_array_equal(out["search_i"], outs[0]["search_i"])
