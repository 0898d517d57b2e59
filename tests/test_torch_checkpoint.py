"""repro_torch.checkpoint, repro_torch.train.trainer, the whole system's
flow and repro_torch.launch.train, on the CPU.

The reference's tests/test_checkpoint.py and tests/test_train.py cases
through the port (the multi-rank resharding case is in
tests/test_torch_mesh_train.py, ``best_mesh`` in tests/test_torch_mesh.py),
one new case for the in-place optimizer (an async save must keep the values
it was given), and tests/test_system.py's flow (embed -> dedup -> train ->
datastore -> kNN-LM serving) in both packages from the reference's initial
state: the trained parameters within ``SYSTEM_ATOL = 1e-4`` and the greedy
tokens with kNN on equal.  The launcher's pod and multipod meshes run in a
subprocess under the fake process group (tests/torch_mesh_worker.py).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.data import dedup as jdedup  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import model_fns as j_model_fns  # noqa: E402
from repro.models import synthetic_batch as j_synthetic_batch  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.knnlm import KNNDatastore as JKNNDatastore  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data import dedup  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model_fns, synthetic_batch  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.knnlm import KNNDatastore  # noqa: E402
from repro_torch.train.train_step import (init_state, make_train_step,  # noqa: E402
                                          state_from_reference)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from tests.test_torch_models import cfgs  # noqa: E402
from tests.test_torch_train import TRAIN_KW, carried  # noqa: E402

SYSTEM_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size torch ops on one thread (see tests/test_torch_moe.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the checkpoint manager
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((16, 8), generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": [torch.ones(3), torch.zeros(2, 2)],
                       "h": torch.randn((5,), generator=g).to(torch.bfloat16)}}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_roundtrip(tmp_path):
    """Every leaf back bit for bit, its dtype kept; a bf16 leaf is stored as
    its uint16 bits with "bfloat16" in the manifest; each leaf's sha256 is
    the reference's."""
    import hashlib
    import json

    cm = CheckpointManager(str(tmp_path), async_save=False)
    t = _tree()
    cm.save(3, t, extra={"data": {"pos": 7}})
    got, extra, step = cm.restore(_zeros_like(t))
    assert step == 3 and extra["data"]["pos"] == 7
    for a, b in zip(_leaves(t), _leaves(got), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with open(tmp_path / "step_00000003" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    assert leaves["nested/h"]["dtype"] == "bfloat16"
    assert leaves["nested/c/1"]["shape"] == [2, 2]
    data = np.load(tmp_path / "step_00000003" / "shard_p0.npz")
    assert data["nested/h"].dtype == np.uint16
    for key, leaf in leaves.items():    # the reference's digest of the bytes
        assert leaf["sha256"] == hashlib.sha256(data[key].tobytes()).hexdigest(), key


def test_async_save_and_wait(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_save=True)
    cm.save(1, _tree())
    cm.wait()
    assert cm.latest_step() == 1


def test_async_save_keeps_the_values_it_was_given(tmp_path, monkeypatch):
    """An async save followed at once by an in-place optimizer step: the
    checkpoint holds the state at the save, not after the step (save()
    copies every leaf to host memory before it returns; a CPU tensor's
    numpy() would share the storage the step writes).  The writer thread
    is held until the step is done."""
    import threading

    from repro_torch.checkpoint import manager

    gate = threading.Event()
    savez = np.savez

    def held(*a, **kw):
        gate.wait(timeout=120)
        return savez(*a, **kw)

    monkeypatch.setattr(manager.np, "savez", held)
    _, cfg = cfgs("tinyllama-1.1b", **TRAIN_KW)
    fns = model_fns(cfg)
    state = init_state(fns, 0, device="cpu")
    step = make_train_step(fns, cfg, lr_schedule=lambda s: torch.tensor(1e-2))
    batch = SyntheticLM(cfg.vocab, 16, 8, seed=1).batch(0)
    state, _ = step(state, batch)
    want = {n: p.detach().clone() for n, p in state["params"].named_parameters()}
    want_m = {n: t.clone() for n, t in state["opt"]["m"].items()}
    cm = CheckpointManager(str(tmp_path), async_save=True)
    cm.save(1, state)
    state, _ = step(state, batch)                    # writes the same tensors in place
    gate.set()
    cm.wait()
    moved = [n for n, p in state["params"].named_parameters() if not torch.equal(p, want[n])]
    assert len(moved) > 0
    fresh = init_state(fns, 1, device="cpu")
    got, _, _ = cm.restore(fresh)
    for n, p in got["params"].named_parameters():
        assert torch.equal(p, want[n]), n
    for n, t in got["opt"]["m"].items():
        assert torch.equal(t, want_m[n]), n
    assert int(got["step"]) == int(got["opt"]["step"]) == 1


def test_restore_into_an_abstract_state(tmp_path):
    """init_state(abstract=True) lays out the state on the meta device; a
    restore makes it on the device asked for, with every value saved."""
    _, cfg = cfgs("tinyllama-1.1b", **TRAIN_KW)
    fns = model_fns(cfg)
    state = init_state(fns, 3, device="cpu", compress_grads=True)
    cm = CheckpointManager(str(tmp_path), async_save=False)
    cm.save(5, state)
    got, _, step = cm.restore(init_state(fns, abstract=True, compress_grads=True),
                              device="cpu")
    assert step == 5
    for (n, a), (_, b) in zip(state["params"].named_parameters(),
                              got["params"].named_parameters(), strict=True):
        assert b.device.type == "cpu" and b.requires_grad and torch.equal(a, b), n
    assert got["err"].keys() == state["err"].keys()
    assert all(not t.is_meta for t in got["opt"]["v"].values())


def test_integrity_detection(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_save=False)
    t = _tree()
    cm.save(1, t)
    p = os.path.join(str(tmp_path), "step_00000001", "shard_p0.npz")
    data = dict(np.load(p))
    data["a"] = data["a"] + 1.0
    np.savez(p, **data)
    with pytest.raises(IOError):
        cm.restore(_zeros_like(t))


def test_gc_keeps_latest(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        cm.save(s, _tree())
    assert cm.steps() == [3, 4]


def test_incomplete_checkpoint_ignored(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_save=False)
    cm.save(1, _tree())
    os.makedirs(os.path.join(str(tmp_path), "step_00000002"))
    assert cm.latest_step() == 1


def test_restore_onto_shardings_waits_for_dist(tmp_path):
    """restore(shardings=) places the named leaves onto a mesh (a one-rank
    gloo mesh in this process), bit for bit; the others restore as
    before."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist import placement
    from repro_torch.dist.sharding import NamedSharding

    cm = CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    t = _tree()
    cm.save(1, t)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = DeviceMesh("cpu", [[0]], mesh_dim_names=("data", "model"))
        got, _, step = cm.restore(_zeros_like(t), device="cpu", shardings={
            "a": NamedSharding(mesh, ("data", "model")), "nested": {"b": None}})
        assert step == 1
        assert placement.is_dtensor(got["a"]) and got["a"].device_mesh is mesh
        assert torch.equal(got["a"].full_tensor(), t["a"])
        assert not placement.is_dtensor(got["nested"]["b"])
        assert torch.equal(got["nested"]["b"], t["nested"]["b"])
        assert torch.equal(got["nested"]["h"], t["nested"]["h"])
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the trainer (the reference's tests/test_train.py through the port)
# ---------------------------------------------------------------------------

def _setup(tmp, total=14, ckpt_every=5, arch="tinyllama-1.1b", **step_kw):
    _, cfg = cfgs(arch, **{k: v for k, v in TRAIN_KW.items() if k != "dtype"})
    fns = model_fns(cfg)
    step = make_train_step(fns, cfg, **step_kw)
    state = init_state(fns, 0, compress_grads=step_kw.get("compress_grads", False),
                       device="cpu")
    data = SyntheticLM(cfg.vocab, 16, 8, seed=1)
    tc = TrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                       ckpt_dir=os.path.join(tmp, "ckpt"), log_every=100)
    return Trainer(step, state, data, tc), cfg


def _first_last(out):
    return (np.mean([h["loss"] for h in out["history"][:5]]),
            np.mean([h["loss"] for h in out["history"][-5:]]))


def test_loss_decreases(tmp_path):
    tr, _ = _setup(str(tmp_path), total=30)
    first, last = _first_last(tr.run(install_signal=False))
    assert last < first, (first, last)


def test_checkpoint_restart_exact(tmp_path):
    tr1, _ = _setup(str(tmp_path), total=9)
    tr1.run(install_signal=False)
    tr2, _ = _setup(str(tmp_path), total=14)
    out2 = tr2.run(install_signal=False)
    assert out2["final_step"] == 14
    assert out2["history"][0]["step"] == 10, "resumed from checkpoint"
    tr3, _ = _setup(str(tmp_path) + "_ref", total=14)
    ref = {h["step"]: h["loss"] for h in tr3.run(install_signal=False)["history"]}
    for h in out2["history"]:
        assert abs(h["loss"] - ref[h["step"]]) < 1e-4, h["step"]


def test_straggler_watchdog(tmp_path):
    import time

    tr, _ = _setup(str(tmp_path), total=12, ckpt_every=50)
    orig = tr.train_step
    calls = {"n": 0}

    def slow_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 8:
            time.sleep(max(1.0, 5.0 * (tr._ema or 0.2)))
        return orig(state, batch)

    tr.train_step = slow_step
    out = tr.run(install_signal=False)
    assert any(6 <= s <= 9 for s in out["stragglers"]), out["stragglers"]


def test_grad_compression_error_feedback(tmp_path):
    tr, _ = _setup(str(tmp_path), total=25, ckpt_every=100, compress_grads=True)
    first, last = _first_last(tr.run(install_signal=False))
    assert last < first, "int8+EF training still converges"


def test_accum_matches_single_batch():
    """Gradient accumulation == one big batch: the parameters after one
    step agree closely."""
    _, cfg = cfgs("tinyllama-1.1b", **{k: v for k, v in TRAIN_KW.items() if k != "dtype"})
    fns = model_fns(cfg)
    batch = synthetic_batch(cfg, 8, 16, device="cpu")
    s1 = init_state(fns, 0, device="cpu")
    s2 = init_state(fns, 0, device="cpu")
    s1, _ = make_train_step(fns, cfg, accum=1)(s1, batch)
    s2, _ = make_train_step(fns, cfg, accum=4)(s2, batch)
    d = max(float((a - b).abs().max()) for a, b in
            zip(s1["params"].parameters(), s2["params"].parameters()))
    assert d < 5e-3


def test_preemption_flag_writes_a_blocking_checkpoint(tmp_path):
    """SIGTERM's flag: the loop ends after the in-flight step and the
    final save is written before run() returns."""
    tr, _ = _setup(str(tmp_path), total=50, ckpt_every=100)

    def preempt(step, state, rec):
        if step == 3:
            tr._handle_preempt()

    tr.hooks.append(preempt)
    out = tr.run(install_signal=False)
    assert out["preempted"] and out["final_step"] == 3
    assert tr.ckpt.latest_step() == 3


def test_final_checkpoint_waits_for_a_save_of_the_same_step(tmp_path):
    """The loop's last step was just saved asynchronously: the final
    checkpoint waits for that write instead of writing the step again.
    Otherwise it is a blocking save of its own."""
    for total, every, want in ((10, 5, [(5, False), (10, False)]),
                               (9, 5, [(5, False), (9, True)])):
        tr, _ = _setup(str(tmp_path / str(total)), total=total, ckpt_every=every)
        calls = []
        save = tr.ckpt.save

        def counting(step, tree, *, extra=None, block=False, _save=save, _calls=calls):
            _calls.append((step, block))
            return _save(step, tree, extra=extra, block=block)

        tr.ckpt.save = counting
        out = tr.run(install_signal=False)
        assert calls == want and out["final_step"] == total
        assert tr.ckpt.latest_step() == total and tr.ckpt._thread is None


# ---------------------------------------------------------------------------
# the whole system: embed -> dedup -> train -> datastore -> kNN-LM serving
# ---------------------------------------------------------------------------

def test_full_stack_end_to_end_matches_reference():
    """tests/test_system.py::test_full_stack_end_to_end in both packages:
    the dedup finds the planted duplicate; 8 train steps from the
    reference's initial state give parameters within SYSTEM_ATOL of the
    reference's; the datastore harvested with the trained model and the
    greedy kNN-LM tokens equal the reference's."""
    jcfg, cfg = cfgs("tinyllama-1.1b", n_layers=2, d_model=32, d_ff=64, n_heads=2,
                     n_kv_heads=2, d_head=16, vocab=64, dtype="float32")
    jfns, fns = j_model_fns(jcfg), model_fns(cfg)

    # 1) data with near-duplicates -> dedup via the paper's exact search
    src, jsrc = SyntheticLM(cfg.vocab, 16, 16, seed=0), JSyntheticLM(cfg.vocab, 16, 16, seed=0)
    toks = src.batch(0)["tokens"]
    np.testing.assert_array_equal(toks, jsrc.batch(0)["tokens"])
    toks[9] = toks[2]
    emb = dedup.embed_tokens(toks)
    kw = dict(threshold=0.95, k=4, n_pivots=4, block_size=32)
    pairs, _ = dedup.find_near_duplicates(emb, device="cpu", **kw)
    jpairs, _ = jdedup.find_near_duplicates(jdedup.embed_tokens(toks), **kw)
    assert pairs == sorted(jpairs)
    keep = dedup.dedup_mask(len(toks), pairs)
    assert not keep[9] and keep[2]

    # 2) short training run, from the reference's initial state
    jstate = jts.init_state(jfns, jax.random.PRNGKey(0))
    state = state_from_reference(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    jstep, step = jax.jit(jts.make_train_step(jfns, jcfg)), make_train_step(fns, cfg)
    for s in range(8):
        jstate, jm = jstep(jstate, jsrc.batch(s))
        state, m = step(state, src.batch(s))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert np.isfinite(float(m["loss"]))
    want = carried(jstate["params"], cfg)
    params = state["params"]
    for name, p in params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=SYSTEM_ATOL, rtol=0,
                                   err_msg=name)

    # 3) harvest a datastore from the trained model and serve with kNN-LM
    jbatches = [j_synthetic_batch(jcfg, 2, 16, seed=s) for s in range(2)]
    batches = [{k: np.asarray(v) for k, v in b.items()} for b in jbatches]
    dkw = dict(k=4, n_pivots=4, block_size=32)
    jds = JKNNDatastore.from_corpus(jfns, jstate["params"], jbatches, jcfg.vocab, **dkw)
    ds = KNNDatastore.from_corpus(fns, params, batches, cfg.vocab, device="cpu", **dkw)
    np.testing.assert_array_equal(ds.values.numpy(), np.asarray(jds.values))
    jeng = JEngine(jfns, jstate["params"], max_seq=32, knn=jds, lmbda=0.25)
    eng = Engine(fns, params, max_seq=32, knn=ds, lmbda=0.25)
    jprompt = j_synthetic_batch(jcfg, 2, 8, seed=5)
    prompt = {k: np.asarray(v) for k, v in jprompt.items()}
    jcache, jclen, _ = jeng.prefill(jprompt)
    jout, _ = jeng.decode(jcache, jclen, jprompt["tokens"][:, -1:], 4)
    cache, clen, _ = eng.prefill(prompt)
    out, _ = eng.decode(cache, clen, prompt["tokens"][:, -1:], 4)
    assert out.shape == (2, 4) and int(out.max()) < cfg.vocab
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_on_the_cpu_and_its_loss_decreases(tmp_path, capsys):
    out = launch_train.main(["--smoke", "--device", "cpu", "--steps", "20",
                             "--ckpt-dir", str(tmp_path / "ckpt")])
    assert out["final_step"] == 20 and not out["preempted"]
    first, last = _first_last(out)
    assert last < first, (first, last)
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 20
    assert "done: step 20" in capsys.readouterr().out


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_launcher_mesh_paths_wait_for_dist(tmp_path, mesh):
    """``--mesh pod|multipod --smoke --device cpu`` trains 2 steps at rank 0
    of 256 / 512 fake ranks (the fake process group's collectives move no
    data, so the numbers are not checked): the mesh is the production
    one, each parameter's local shape is its global shape divided as
    ``launch.dryrun.param_specs`` says, and each rank's batch is its data
    shard's 8 rows."""
    world = 512 if mesh == "multipod" else 256
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(root / "src"), str(root)])}
    run = subprocess.run([sys.executable, str(root / "tests" / "torch_mesh_worker.py"),
                          "fake", str(world), mesh, str(tmp_path)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    rec = json.loads((tmp_path / "fake.json").read_text())
    assert rec["final_step"] == 2
    sizes = dict(zip(("pod", "data", "model") if world == 512 else ("data", "model"),
                     rec["mesh"]))
    assert rec["mesh"] == ([2, 16, 16] if world == 512 else [16, 16])
    assert rec["batch_local"] == [8, 64]
    split = 0
    for name, (local, glob, spec) in rec["params"].items():
        spec = spec + [None] * (len(glob) - len(spec))
        want = [g // int(np.prod([sizes[a] for a in ([s] if isinstance(s, str) else s)]))
                if s is not None else g for g, s in zip(glob, spec)]
        assert local == want, name
        split += local != glob
    assert split >= len(rec["params"]) // 2

