"""The port's dry-run (``repro_torch.launch.dryrun``, ``configs.shapes
.input_specs``) against the reference's (``repro.launch.dryrun``).

* ``input_specs``: the same keys, shapes and dtypes for every arch x shape
  at ``scale`` 1 and 1/256.
* ``prepare_cfg``: the same ``kv_repeat``, ``q_group_pad``,
  ``max_seq_len`` and unrolled depth for every arch x shape at ``"model"``
  sizes 1, 4 and 16, with ``REPRO_HEAD_PAD`` 0 and 1.
* ``cache_shardings``: the reference's spec of every leaf of every arch's
  ``decode_32k`` cache (``jax.eval_shape`` of its ``cache_init``) on the
  pod and multipod ``AbstractMesh``es, its scanned runs' stacked dim
  dropped, equals the port's spec of the same leaf of each layer.
* In three processes at once (tests/torch_dryrun_worker.py): the argument
  bytes of four cells on a ``(data 2, model 4)`` mesh, the reference's
  ``memory_analysis`` on 8 XLA host devices and the port's placed state at
  rank 0 of 8 fake ranks, equal to the byte; the port's FLOPs of an
  unrolled probe beside the reference's ``cost.flops``, its peak temp
  bytes below one layer's attention score tiles; and one pod cell
  through ``run_cell`` at rank 0 of 256 fake ranks, whose record has the
  reference's keys, ``compile_s`` aside.
* The head-split decode attention (``placement.head_split``): each rank's
  share of the heads, summed over the ranks, equals the whole attention.
* Phase 17b's checks at smoke size on a one-rank gloo mesh: the fake
  run's argument bytes equal the real placed state's, the mesh decode
  equals the host path's bit for bit.
* ``Counter``'s bytes alive and at peak on a known sequence of ops.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import input_specs as j_input_specs  # noqa: E402
from repro.models import model_fns as j_model_fns  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, input_specs, smoke_config  # noqa: E402
from repro_torch.dist import placement  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import lm as lm_mod  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.layers import Attention, attn_apply  # noqa: E402
from tests.torch_dryrun_worker import CELLS, POD_CELL  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
#: the reference's argument bytes of CELLS on (data 2, model 4), as its
#: memory_analysis reports them on jax 0.9.0's CPU backend
REFERENCE_ARGUMENT_BYTES = {
    "tinyllama-1.1b:train_4k": 3_388_317_696,
    "tinyllama-1.1b:decode_32k": 13_503_222_020,
    "granite-moe-1b-a400m:train_4k": 1_492_336_640,
    "zamba2-1.2b:decode_32k": 4_453_499_140,
}


@functools.lru_cache(maxsize=None)
def j_dryrun():
    """``repro.launch.dryrun``, imported with ``XLA_FLAGS`` as it was: the
    module asks for 512 host devices when it is imported, for its own
    runs, and this process keeps one."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as mod
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return mod


def _norm(spec) -> tuple:
    """A spec as a tuple of None / name / tuple of names, trailing None
    dropped, one-name tuples as the name."""
    out = []
    for a in spec:
        if a is not None and not isinstance(a, str):
            a = tuple(a)
            a = a[0] if len(a) == 1 else a
        out.append(a)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


# ---------------------------------------------------------------------------
# input_specs, prepare_cfg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 1 / 256], ids=["full", "1/256"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_equal_the_reference(arch, shape, scale):
    ref = j_input_specs(J_ARCHS[arch], J_SHAPES[shape], scale=scale)
    got = input_specs(ARCHS[arch], SHAPES[shape], scale=scale)
    assert list(got) == list(ref)
    for k, r in ref.items():
        assert tuple(got[k].shape) == tuple(r.shape), k
        assert str(got[k].dtype).removeprefix("torch.") == np.dtype(r.dtype).name, k
        assert got[k].device.type == "meta"


_CFG_FIELDS = ("kv_repeat", "q_group_pad", "max_seq_len", "use_scan", "n_layers",
               "encoder_layers")


@pytest.mark.parametrize("head_pad", ["0", "1"])
@pytest.mark.parametrize("tp", [1, 4, 16])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prepare_cfg_equals_the_reference(arch, tp, head_pad, monkeypatch):
    monkeypatch.setenv("REPRO_HEAD_PAD", head_pad)
    jm = JAbstractMesh((2, tp), ("data", "model"))
    m = shd.AbstractMesh((2, tp), ("data", "model"))
    for shape in SHAPES:
        for unrolled, mult in ((False, 1), (True, 1), (True, 2)):
            ref = j_dryrun().prepare_cfg(arch, shape, jm, unrolled=unrolled, unroll_mult=mult)
            got = dryrun.prepare_cfg(arch, shape, m, unrolled=unrolled, unroll_mult=mult)
            assert ({f: getattr(got, f) for f in _CFG_FIELDS}
                    == {f: getattr(ref, f) for f in _CFG_FIELDS}), (shape, unrolled, mult)


# ---------------------------------------------------------------------------
# cache_shardings
# ---------------------------------------------------------------------------

def reference_cache_specs(arch: str, mesh: str) -> dict:
    """{(layer, leaf path within the layer): the reference's spec} of the
    decode_32k cache (``jax.eval_shape``), scanned runs' stacked dim
    dropped."""
    jd = j_dryrun()
    jmesh = JAbstractMesh(*MESHES[mesh])
    cfg = jd.prepare_cfg(arch, "decode_32k", jmesh)
    fns = j_model_fns(cfg)
    shape = J_SHAPES["decode_32k"]
    params = jax.eval_shape(fns.init, jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda p, b: fns.cache_init(p, b, shape.batch, shape.seq),
                           params, jd._abstract_frames(cfg, shape.batch))
    dp = ("pod", "data") if mesh == "multipod" else ("data",)
    tree = jd.cache_shardings(cache, jmesh, dp)

    def leaves(node, stacked):
        flat, _ = jax.tree_util.tree_flatten_with_path(node)
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
                _norm(sh.spec)[1:] if stacked else _norm(sh.spec) for path, sh in flat}

    out = {}
    if cfg.encoder_layers:                  # whisper: the dec run, stacked under scan
        for li in range(cfg.n_layers):
            node = tree if cfg.use_scan else tree[li]
            out.update({(li, p): s for p, s in leaves(node, cfg.use_scan).items()})
        return out
    li = 0
    for (btype, count), run in zip(lm_mod._runs(cfg), tree, strict=True):
        stacked = count > 1 and cfg.use_scan and btype != "shared_attn"
        for j in range(count):
            node = run if stacked or btype == "shared_attn" else run[j]
            out.update({(li, p): s for p, s in leaves(node, stacked).items()})
            li += 1
    return out


def port_cache_specs(arch: str, mesh: str) -> dict:
    m = shd.AbstractMesh(*MESHES[mesh])
    cfg = dryrun.prepare_cfg(arch, "decode_32k", m)
    shape = SHAPES["decode_32k"]
    fns = registry.model_fns(cfg)
    model = registry.model_class(cfg)(cfg, device="meta")
    with torch.no_grad():
        cache = fns.cache_init(model, dryrun._frames(cfg, shape.batch, "meta"), shape.batch,
                               shape.seq)
    dp = ("pod", "data") if mesh == "multipod" else ("data",)
    out = {}

    def put(path, sh):
        layer, _, rest = path.partition("/")
        out[(int(layer), rest)] = _norm(sh.spec)
        return sh
    dryrun._cache_map(put, dryrun.cache_shardings(cache, m, dp))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_shardings_equal_the_reference(arch, mesh):
    ref, got = reference_cache_specs(arch, mesh), port_cache_specs(arch, mesh)
    assert got.keys() == ref.keys()
    bad = {k: (got[k], ref[k]) for k in ref if got[k] != ref[k]}
    assert not bad, bad
    # the attention K/V split their batch and, where they divide, their heads
    kv = [s for (li, p), s in got.items() if p.endswith("/k")]
    assert all(s and s[0] is not None for s in kv)


# ---------------------------------------------------------------------------
# the three processes: argument bytes, the probe's FLOPs, a pod cell
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worker's three parts, started together; {"ref": ..., "port":
    ..., "pod": ...}."""
    workdir = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    env.pop("XLA_FLAGS", None)
    procs = {}
    try:
        for side in ("ref", "port", "pod"):
            log = open(workdir / f"{side}.log", "w")
            procs[side] = (subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "torch_dryrun_worker.py"), side,
                 str(workdir)], env=env, stdout=log, stderr=subprocess.STDOUT), log)
        for side, (p, _) in procs.items():
            p.wait(timeout=600)
    finally:
        for p, log in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    out = {}
    for side, (p, _) in procs.items():
        assert p.returncode == 0, (side, (workdir / f"{side}.log").read_text()[-4000:])
        out[side] = json.loads((workdir / f"{side}.json").read_text())
    return out


@pytest.mark.parametrize("cell", [f"{a}:{s}" for a, s in CELLS])
def test_argument_bytes_equal_the_reference(runs, cell):
    assert runs["ref"]["argument_bytes"][cell] == REFERENCE_ARGUMENT_BYTES[cell]
    assert runs["port"]["argument_bytes"][cell] == REFERENCE_ARGUMENT_BYTES[cell]


def test_pod_cell_record_has_the_reference_keys(runs):
    rec = runs["pod"]
    assert "error" not in rec, rec.get("traceback")
    assert sorted(rec) == [k for k in runs["ref"]["keys"] if k != "compile_s"]
    assert sorted(rec["memory"]) == runs["ref"]["memory_keys"]
    assert rec["mesh"] == {"data": 16, "model": 16}
    assert (rec["arch"], rec["shape"]) == POD_CELL and rec["kv_repeat"] == 4
    # tinyllama's 4 KV heads repeated 4x split over the 16 "model" ranks:
    # each rank holds 1 of the 16 heads of 8 of the 128 rows, all 22 layers
    cache = 22 * 2 * 8 * 32768 * 1 * 64 * 2
    assert rec["memory"]["argument_bytes"] > cache
    assert rec["memory"]["output_bytes"] >= cache + 128 * 32000 * 4
    assert set(rec["collectives"]) <= {"all-gather", "all-reduce", "reduce-scatter",
                                       "all-to-all", "collective-permute"}
    assert rec["collectives"]["all-gather"]["bytes"] > 0
    assert rec["cost"]["flops"] > 0 and rec["hlo_lines"] > 0


def test_probe_flops_beside_the_reference(runs):
    """The unrolled probe of tinyllama x train_4k (one layer) on (data 2,
    model 4).  The two counts are not the same quantity: XLA's cost
    analysis counts a while loop's body once, and the reference's flash
    attention (a scan over query tiles and one over key tiles, 8 x 4 per
    layer at 4,096 tokens) and its chunked cross-entropy are loops, where
    the port runs and counts every tile; XLA also counts elementwise work,
    which the port's FlopCounterMode formulas leave out (a few percent of
    a step whose products have widths in the thousands).  So the port's
    count is at least the reference's, less that elementwise share (5 %),
    and at most the loops' trip counts times it (32, the attention's tiles
    per layer)."""
    port, ref = runs["port"]["probe_flops"], runs["ref"]["probe_flops"]
    print(f"probe FLOPs: port {port:.6e}, reference {ref:.6e}, ratio {port / ref:.3f}")
    assert 0.95 * ref <= port <= 32 * ref


def test_probe_keeps_no_score_tiles(runs):
    """The same probe's peak temp bytes: flash attention's key-tile steps
    run under checkpoint (the reference's ``jax.checkpoint(kv_step)``), so
    the backward keeps no ``[cq, ck]`` score tile.  One layer's tiles at
    this cell (this rank's 128 of the 256 rows, tinyllama's 32 heads,
    8 x 4 tiles of 512 x 1,024 at 4,096 tokens) are 274.9 GB in fp32, and
    a backward that keeps each tile's scores and probabilities needs more
    than that."""
    port, ref = runs["port"]["probe_temp_bytes"], runs["ref"]["probe_temp_bytes"]
    print(f"probe temp bytes: port {port:.6e}, reference {ref:.6e}")
    nq, nk, b, h, cq, ck = 4096 // 512, 4096 // 1024, 256 // 2, 32, 512, 1024
    assert 0 < port < nq * nk * b * h * cq * ck * 4


# ---------------------------------------------------------------------------
# the head-split decode attention, ranks emulated in one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,tp", [(dict(n_heads=8, n_kv_heads=2, kv_repeat=2), 2),
                                     (dict(n_heads=6, n_kv_heads=2, kv_repeat=1,
                                           q_group_pad=4), 2),
                                     (dict(n_heads=6, n_kv_heads=2, kv_repeat=4,
                                           q_group_pad=4), 8)],
                         ids=["repeat", "q_pad", "q_pad_ranks_of_padding"])
def test_head_split_attention_sums_to_the_whole(case, tp, monkeypatch):
    """Each of ``tp`` ranks attends with its share of the KV heads (its
    share of the cache) and of the query heads, and projects its heads'
    rows of ``wo``; the sum over the ranks (the all-reduce, one process
    here) equals the whole attention, and each rank writes its heads'
    slice of the new K/V into its cache shard.  With 8 ranks over 2 x 4
    padded query heads, the ranks that hold only padding contribute 0."""
    cfg = smoke_config("tinyllama-1.1b").replace(dtype="float32", d_head=16, **case)
    gen = torch.Generator().manual_seed(3)
    p = Attention(cfg, gen)
    rng = np.random.default_rng(4)
    B, S, L = 3, 40, 17
    kvr = cfg.n_kv_heads * cfg.kv_repeat
    x = torch.from_numpy(rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32))
    kc = torch.from_numpy(rng.normal(size=(B, S, kvr, cfg.head_dim)).astype(np.float32))
    vc = torch.from_numpy(rng.normal(size=(B, S, kvr, cfg.head_dim)).astype(np.float32))
    whole = {"k": kc.clone(), "v": vc.clone()}
    want, _ = attn_apply(p, x, cfg, cache=whole, cache_len=L)
    hk = kvr // tp
    total = 0
    for r in range(tp):
        part = {"k": kc[:, :, r * hk:(r + 1) * hk].clone(),
                "v": vc[:, :, r * hk:(r + 1) * hk].clone()}
        monkeypatch.setattr(placement, "_HEADS", (r, tp, None))
        y, _ = attn_apply(p, x, cfg, cache=part, cache_len=L)
        total = total + y
        for n in ("k", "v"):
            torch.testing.assert_close(part[n], whole[n][:, :, r * hk:(r + 1) * hk],
                                       atol=0, rtol=0)
    torch.testing.assert_close(total, want, atol=1e-5, rtol=1e-5)


def test_cell_on_one_rank_equals_the_host_path(tmp_path, monkeypatch):
    """Phase 17b's decode checks on the CPU at smoke size: tinyllama's
    smoke config (4 layers, d = 64, float32) as the cell's arch, decode_32k
    at B = 1, on a one-rank gloo (1, 1) mesh.  The fake run's argument
    bytes equal the real placed state's; the real decode step's logits and
    new cache equal the host path's decode_step (its weights from the same
    seed, the same cache and tokens) bit for bit.  (The train cell's step
    takes a minute of CPU at S = 4,096; phase 17b runs it on the card.)"""
    shape, scale = "decode_32k", 1 / 128
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    # the full config's key tiles (the smoke config's 32-token ones would
    # make 1,024 a layer over the 32,768-token cache)
    cfg = smoke_config("tinyllama-1.1b").replace(dtype="float32", attn_chunk_q=512,
                                                  attn_chunk_k=1024, logits_chunk=512)
    monkeypatch.setitem(dryrun.ARCHS, "tinyllama-1.1b", cfg)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = DeviceMesh("cpu", [[0]], mesh_dim_names=("data", "model"))
        fake = dryrun.lower_cell("tinyllama-1.1b", shape, mesh, scale=scale)
        with dryrun.cell_rules(shape, mesh):
            cell = dryrun.build_cell("tinyllama-1.1b", shape, mesh, scale=scale, seed=5)
            assert dryrun.argument_bytes(cell) == fake["memory"]["argument_bytes"]
            gen = torch.Generator().manual_seed(6)
            with torch.no_grad():
                for t in cell.args["cache"].values():
                    t.copy_(torch.randn(t.shape, generator=gen))
            tokens = cell.args["batch"]["tokens"]
            tokens.copy_(torch.randint(0, cfg.vocab, tokens.shape, generator=gen))
            host_cache = {p: t.clone() for p, t in cell.args["cache"].items()}
            logits, new = cell.step()
        fns = registry.model_fns(cell.cfg)
        params = fns.init(5, device="cpu")
        hcache = lm_mod.lm_cache_init(cell.cfg, tokens.shape[0], SHAPES[shape].seq,
                                      device="cpu")
        with torch.no_grad():
            for p, t in dryrun.cache_leaves(hcache).items():
                t.copy_(host_cache[p])
            hidden, hnew = fns.decode_step(params, tokens, hcache, SHAPES[shape].seq - 1)
            want = fns.lm_head(params, hidden)
        assert torch.equal(logits, want)
        got_cache = dryrun.cache_leaves(new)
        assert all(torch.equal(got_cache[p], t) for p, t in dryrun.cache_leaves(hnew).items())
    finally:
        dist.destroy_process_group()


def test_counter_tracks_live_and_peak_bytes():
    a = torch.zeros(256)                           # made before: not counted
    with dryrun.Counter() as c:
        b = a + 1                                  # 1 KiB
        d = b * 2                                  # 2 KiB alive
        v = d.view(16, 16)                         # a view: nothing new
        e = torch.mm(v, v)                         # 3 KiB alive: the peak
        del b                                      # 2 KiB alive
        a.add_(1)                                  # in place: nothing new
    assert (c.live, c.peak) == (2048, 3072)
    assert c.flops == 2 * 16 ** 3
    assert c.ops == 5 and not c.collectives
    del d, e, v                                   # the view held d's storage
    assert c.live == 0
