"""repro_torch's sharded online mutation (``core/online.py:ShardedMutableIndex``,
``core/distributed.py:ShardedMutationOps`` / ``make_sharded_mutation`` /
``replicated_row_ids``, ``SearchEngine.online()`` on a sharded engine) on the
CPU.

* the reference's interleavings (test_online.py's sharded test: 603 rows
  over 8 shards of blocks of 16, inserts, deletes of 7, reoptimize), flat
  and with the shard trees: after every step the search equals the fp64
  brute force over the live rows (ATOL 3e-5) and the single-device
  ``MutableIndex`` taking the same mutations (the same ids; tie-aware
  1e-6), and the id -> (shard, slot) mirror equals ``row_ids``;
* the placement rule: round robin by id, the shard with the most free
  slots when the preferred tail is full (ties to the lowest), one block
  appended to every shard when every tail is full (a shape change: the
  shard trees drop, ``n_slots`` grows);
* the reference's own ``ShardedMutableIndex`` in a subprocess on 8 virtual
  devices, over the same index: its jitted ops are unwrapped and the index
  left on the host, since on jax 0.9.0 its first insert raises in the
  ``vmap`` over a placed index; ids, placements, free lists, ``row_ids``,
  ``valid`` and ``db`` are equal after every step, ``dp_min/dp_max`` within
  2 ulp of 1 (XLA's and torch's float32 products);
* two gloo ranks with two shards each (``tests/torch_dist_worker.py``)
  agree with each other and with the one-process run on ids, placements
  and every answer;
* rows inserted at pivot cosines near +-1 of their own shard's pivots,
  into tombstones under live shard trees, then past every tail, then
  through a reoptimize: every block and node bound + margin reaches the
  float64 maximum below it in every shard, and the flat and tree
  searches stay exact.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.distributed import (build_sharded_index, local_shard,  # noqa: E402
                                          replicated_row_ids, sharded_index_from_reference)
from repro_torch.core.index import BlockIndex  # noqa: E402
from repro_torch.core.online import ShardedMutableIndex  # noqa: E402
from repro_torch.search import SearchEngine, build_shard_trees  # noqa: E402
from tests.test_torch_distributed import ROOT, assert_same_topk, mesh  # noqa: E402,F401
from tests.test_torch_online import (DP_ATOL, assert_bounds_dominate,  # noqa: E402
                                     check_live_exact, exact_on, norm64, planted_queries)
from tests.test_torch_tree import NEAR_PM1, at_cosine  # noqa: E402
from tests.torch_dist_worker import run_ranks  # noqa: E402

N, D, K = 603, 16, 7
SHARDS, PIVOTS, BLOCK = 8, 4, 16


def mirror_from_index(eng):
    """The id -> (shard, slot) map that the engine's ``row_ids`` imply."""
    rid = replicated_row_ids(eng.index, eng.mesh)
    return {int(r): (s, p) for s in range(rid.shape[0]) for p, r in enumerate(rid[s]) if r >= 0}


# ---------------------------------------------------------------------------
# the reference's interleavings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("tree_shards", [False, True], ids=["flat", "trees"])
def test_interleaved_mutations_stay_exact(mesh, tree_shards, seed):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(N, D)).astype(np.float32)
    eng = SearchEngine.build(rows, mesh=mesh, n_shards=SHARDS, n_pivots=PIVOTS,
                             block_size=BLOCK, tree_shards=tree_shards, device="cpu")
    single = SearchEngine.build(rows, n_pivots=PIVOTS, block_size=BLOCK, backend="scan",
                                device="cpu")
    h = eng.online(auto_reoptimize=False)
    h1 = single.online(auto_reoptimize=False)
    assert isinstance(h, ShardedMutableIndex) and eng._tree_shards_enabled == tree_shards
    live = {i: rows[i] for i in range(N)}
    q = rng.normal(size=(4, D)).astype(np.float32)

    def check():
        s, i, st = eng.search(q, K)
        check_live_exact(s.numpy(), i.numpy(), live, q, K)
        s1, i1, _ = single.search(q, K)
        assert_same_topk(s.numpy(), i.numpy(), s1.numpy(), i1.numpy(), 1e-6)
        assert h._id_pos == mirror_from_index(eng) and h.n_live == len(live) == eng.n_valid
        assert (st.tree_prune_frac is not None) == tree_shards
        assert st.generation == h.generation

    check()
    for step in range(8):
        op = int(rng.integers(0, 3)) if step >= 3 else step
        if op == 0 or len(live) < K + 16:
            new = rng.normal(size=(int(rng.integers(1, 12)), D)).astype(np.float32)
            ids = h.insert(new)
            assert ids == h1.insert(new)
            live.update(zip(ids, new))
        elif op == 1:
            dead = [int(x) for x in rng.choice(sorted(live), size=7, replace=False)]
            h.delete(dead)
            h1.delete(dead)
            for x in dead:
                del live[x]
        else:
            h.reoptimize()
            h1.reoptimize()
        check()
    assert h.generation == 8


def test_online_handle_surface(mesh):
    """One handle per engine; a delete of an unknown or repeated id raises
    before any change; the handle owns a copy of the index; decay and
    auto-reoptimize as the flat handle's."""
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(200, D)).astype(np.float32)
    idx = build_sharded_index(rows, 4, n_pivots=PIVOTS, block_size=BLOCK, device="cpu")
    before = [t.clone() for t in idx if t is not None]
    eng = SearchEngine(idx, mesh=mesh, device="cpu")
    h = eng.online(reoptimize_threshold=0.1)
    assert eng.online() is h
    with pytest.raises(ValueError, match="first call"):
        eng.online(auto_reoptimize=False)
    with pytest.raises(KeyError):
        h.delete([5, 10_000])
    with pytest.raises(KeyError):
        h.delete([5, 5])
    assert h.generation == 0 and 5 in h and h.n_live == 200
    h.insert(rng.normal(size=(3, D)))
    h.delete([5])
    assert 5 not in h and h.decay_estimate == 4 / 200
    assert all(torch.equal(a, b) for a, b in zip([t for t in idx if t is not None], before))
    h.insert(rng.normal(size=(16, D)))           # crosses 0.1: rebuilds
    assert h.decay_estimate == 0.0 and eng.index_epoch == 1
    assert h.insert(np.zeros((0, D))) == []
    with pytest.raises(ValueError, match="dim"):
        h.insert(np.ones((1, D + 1)))


# ---------------------------------------------------------------------------
# the placement rule
# ---------------------------------------------------------------------------

def test_placement_rule_and_the_append(mesh):
    """4 shards of 30 rows, 32 slots each (2 free a shard).  Ids go round
    robin; once shard 0's tail is full the next id meant for it goes to the
    shard with the most free slots, ties to the lowest; once every tail is
    full one block is appended to every shard, and the row goes to its
    round-robin shard's new block."""
    rng = np.random.default_rng(4)
    rows = rng.normal(size=(120, D)).astype(np.float32)
    eng = SearchEngine.build(rows, mesh=mesh, n_shards=4, n_pivots=PIVOTS,
                             block_size=BLOCK, tree_shards=True, device="cpu")
    q = rng.normal(size=(3, D)).astype(np.float32)
    eng.search(q, 5)
    h = eng.online(auto_reoptimize=False)
    assert [len(f) for f in h._free] == [2, 2, 2, 2] and eng.n_slots == 128
    free0 = [sorted(f) for f in h._free]
    ids = h.insert(rng.normal(size=(4, D)))
    assert ids == [120, 121, 122, 123]
    assert [h._id_pos[i] for i in ids] == [(s, free0[s][0]) for s in range(4)]
    # shard 0's tail: id 124 -> shard 0's last slot; id 128 would go to 0,
    # whose tail is then full: the most free slots, ties lowest -> shard 1
    h.insert(rng.normal(size=(1, D)))
    assert h._id_pos[124] == (0, free0[0][1]) and len(h._free[0]) == 0
    h.delete([121])                             # shard 1 gets a slot back
    ids = h.insert(rng.normal(size=(3, D)))     # 125 -> 1, 126 -> 2, 127 -> 3
    assert [h._id_pos[i][0] for i in ids] == [1, 2, 3]
    assert [len(f) for f in h._free] == [0, 1, 0, 0]
    assert eng.index_epoch == 0 and eng._shard_tree is not None
    h.insert(rng.normal(size=(2, D)))           # 128 -> shard 0 full -> shard 1
    assert h._id_pos[128][0] == 1
    # 129: every tail full: one block on every shard, round robin -> shard 1
    assert h._id_pos[129] == (1, 32) and eng.index.db.shape[1] == 48
    assert [len(f) for f in h._free] == [16, 15, 16, 16]
    assert eng.index_epoch == 1 and eng._shard_tree is None and eng.n_slots == 4 * 48
    assert eng.n_blocks == 3 and h._id_pos == mirror_from_index(eng)
    live = {i: eng.index.db[s, p].numpy() for i, (s, p) in h._id_pos.items()}
    s, i, st = eng.search(q, 5)
    check_live_exact(s.numpy(), i.numpy(), live, q, 5)
    assert eng._shard_tree is not None and st.tree_prune_frac is not None


# ---------------------------------------------------------------------------
# against the reference's handle
# ---------------------------------------------------------------------------

JAX_RUN = """
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.core.distributed import build_sharded_index
    from repro.search import SearchEngine
    inp = np.load(sys.argv[1])
    mesh = jax.make_mesh((8,), ("data",))
    eng = SearchEngine.build(inp["rows"], mesh=mesh, n_pivots=4, block_size=16,
                             tree_shards=False)
    h = eng.online(auto_reoptimize=False)
    # on jax 0.9.0 the jitted ops' vmap refuses the placed index: run them
    # unjitted on the host index
    host = build_sharded_index(inp["rows"], 8, n_pivots=4, block_size=16)
    eng.index = host
    for name in ("insert", "delete", "grow", "repack", "widen"):
        setattr(h._ops, name, getattr(h._ops, name).__wrapped__)
    h._ops.replicate = lambda x: jnp.asarray(np.asarray(x))
    out = {"index_" + f: np.asarray(getattr(host, f)) for f in host._fields
           if getattr(host, f) is not None}
    for i, op in enumerate(OPS):
        if op == "insert":
            out["ids_%d" % i] = np.asarray(h.insert(inp["arg_%d" % i]))
        elif op == "delete":
            h.delete(inp["arg_%d" % i].tolist())
        else:
            h.reoptimize()
        out["place_%d" % i] = np.asarray(
            sorted((r, s, p) for r, (s, p) in h._id_pos.items()), np.int64)
        out["free_%d" % i] = np.asarray([x for f in h._free for x in f + [-1]])
        for f in ("row_ids", "valid", "db", "dp_min", "dp_max"):
            out["%s_%d" % (f, i)] = np.asarray(getattr(eng.index, f))
    np.savez(sys.argv[2], **out)
"""


def mutation_script(rng, n):
    """(ops, args): inserts, deletes, an insert past every tail (the
    append), a reoptimize and inserts after it."""
    ops, args = [], []

    def add(op, arg=None):
        ops.append(op)
        args.append(arg)

    add("insert", rng.normal(size=(11, D)).astype(np.float32))
    add("delete", np.asarray([3, 77, 78, 250, n - 3, n + 2]))
    add("insert", rng.normal(size=(40, D)).astype(np.float32))     # past the tails
    add("delete", np.arange(100, 160))
    add("reoptimize")
    add("insert", rng.normal(size=(9, D)).astype(np.float32))
    return ops, args


@pytest.fixture(scope="module")
def jax_online(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_online")
    rng = np.random.default_rng(5)
    rows = rng.normal(size=(N, D)).astype(np.float32)
    ops, args = mutation_script(rng, N)
    np.savez(tmp / "in.npz", rows=rows,
             **{f"arg_{i}": a for i, a in enumerate(args) if a is not None})
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": str(ROOT / "src")}
    code = f"OPS = {ops!r}\n" + textwrap.dedent(JAX_RUN)
    out = subprocess.run([sys.executable, "-c", code, str(tmp / "in.npz"),
                          str(tmp / "out.npz")], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return rows, ops, args, dict(np.load(tmp / "out.npz"))


def test_matches_the_reference_handle(mesh, jax_online):
    rows, ops, args, j = jax_online
    idx = sharded_index_from_reference(
        {f: j.get("index_" + f) for f in BlockIndex._fields}, "cpu")
    eng = SearchEngine(idx, mesh=mesh, tree_shards=True, device="cpu")
    h = eng.online(auto_reoptimize=False)
    q = np.random.default_rng(6).normal(size=(5, D)).astype(np.float32)
    live = {i: r for i, r in enumerate(rows)}
    for i, (op, arg) in enumerate(zip(ops, args)):
        if op == "insert":
            ids = h.insert(arg)
            assert ids == j[f"ids_{i}"].tolist()
            live.update(zip(ids, arg))
        elif op == "delete":
            h.delete(arg.tolist())
            for x in arg.tolist():
                del live[x]
        else:
            h.reoptimize()
        place = np.asarray(sorted((r, s, p) for r, (s, p) in h._id_pos.items()), np.int64)
        np.testing.assert_array_equal(place, j[f"place_{i}"], err_msg=f"step {i} {op}")
        assert [x for f in h._free for x in f + [-1]] == j[f"free_{i}"].tolist()
        for f in ("row_ids", "valid", "db"):
            np.testing.assert_array_equal(getattr(eng.index, f).numpy(), j[f"{f}_{i}"],
                                          err_msg=f"step {i} {op}: {f}")
        for f in ("dp_min", "dp_max"):
            np.testing.assert_allclose(getattr(eng.index, f).numpy(), j[f"{f}_{i}"],
                                       atol=DP_ATOL, rtol=0, err_msg=f"step {i} {op}: {f}")
        s, ii, _ = eng.search(q, K)
        check_live_exact(s.numpy(), ii.numpy(), live, q, K)
    assert j["db_2"].shape[1] > j["index_db"].shape[1]          # the append ran


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tree_shards", [False, True], ids=["flat", "trees"])
def test_two_ranks_agree_with_each_other_and_one_process(mesh, tmp_path, tree_shards):
    rng = np.random.default_rng(7)
    rows = rng.normal(size=(301, D)).astype(np.float32)
    q = rng.normal(size=(5, D)).astype(np.float32)
    ops, args = mutation_script(rng, 301)
    inputs = dict(db=rows, q=q, n_shards=4, ks=np.asarray([K]), n_pivots=PIVOTS,
                  block_size=BLOCK, mesh_shape=np.asarray([2]), mesh_dims=np.asarray(["data"]),
                  parts=np.asarray(["online"]), tree_shards=tree_shards,
                  mut_ops=np.asarray(ops),
                  **{f"mut_arg_{i}": a for i, a in enumerate(args) if a is not None})
    outs = run_ranks(2, tmp_path, inputs)
    from tests.torch_dist_worker import run_mutations
    eng = SearchEngine.build(rows, mesh=mesh, n_shards=4, n_pivots=PIVOTS, block_size=BLOCK,
                             tree_shards=tree_shards, device="cpu")
    want = run_mutations(eng, inputs, K)
    for rank, out in enumerate(outs):
        for key, val in want.items():
            np.testing.assert_array_equal(out[key], np.asarray(val), err_msg=f"rank {rank} {key}")
        # each rank holds its own two shards of the one-process index
        np.testing.assert_array_equal(out["online_db"],
                                      eng.index.db[2 * rank:2 * rank + 2].numpy())


# ---------------------------------------------------------------------------
# rows near +-1 of their own shard's pivots
# ---------------------------------------------------------------------------

def shard_live(eng, s):
    """Shard ``s``'s live rows, ``{id: float64 row}``."""
    loc = local_shard(eng.index, s)
    v = loc.valid.numpy()
    return dict(zip(loc.row_ids.numpy()[v].tolist(), loc.db.double().numpy()[v]))


def planted_for(rng, eng, h, n_per_shard):
    """Rows at NEAR_PM1 cosines to the pivots of the shard each one's id
    meets first in the round robin."""
    n_shards = eng.index.db.shape[0]
    out = []
    for rid in range(h._next_id, h._next_id + n_per_shard * n_shards):
        piv = norm64(eng.index.pivots[rid % n_shards].numpy())
        j = rng.integers(len(piv))
        out.append(at_cosine(rng, piv[j], NEAR_PM1[rid // n_shards % len(NEAR_PM1)]))
    return np.asarray(out)


def assert_every_shard_sound(eng, rng):
    trees = eng._shard_tree if eng._shard_tree is not None else build_shard_trees(eng.index)
    for s in range(eng.index.db.shape[0]):
        loc = local_shard(eng.index, s)
        live_s = shard_live(eng, s)
        q = planted_queries(rng, norm64(loc.pivots.numpy()), live_s)
        assert_bounds_dominate(loc, trees.shard(loc, s), q)


@pytest.mark.parametrize("seed", [0, 1])
def test_rows_near_pm1_keep_every_shard_sound(mesh, seed):
    rng = np.random.default_rng(seed)
    n_shards = 4
    rows = rng.normal(size=(400, 6)).astype(np.float32)
    eng = SearchEngine.build(rows, mesh=mesh, n_shards=n_shards, n_pivots=PIVOTS,
                             block_size=BLOCK, tree_shards=True, device="cpu")
    q0 = rng.normal(size=(4, 6)).astype(np.float32)
    eng.search(q0, 3)
    h = eng.online(auto_reoptimize=False)
    live = {i: r for i, r in enumerate(rows)}

    def check():
        assert_every_shard_sound(eng, rng)
        q = np.concatenate([planted_queries(rng, norm64(eng.index.pivots[s].numpy()),
                                            shard_live(eng, s))[:40] for s in range(n_shards)])
        flat = SearchEngine(eng.index, mesh=mesh, tree_shards=False, device="cpu")
        for e in (eng, flat):
            exact_on(e, live, q, 5)

    # 1. into tombstones under the live trees: each row in its own shard
    dead = [100 * s + 2 * j + 1 for s in range(n_shards) for j in range(24)]
    h.delete(dead)
    for x in dead:
        del live[x]
    new = planted_for(rng, eng, h, 24)
    ids = h.insert(new)
    live.update(zip(ids, new))
    assert eng.index_epoch == 0 and all(h._id_pos[i][0] == i % n_shards for i in ids)
    check()
    # 2. past every tail: appended blocks on every shard
    new = planted_for(rng, eng, h, 12)
    free = sum(len(f) for f in h._free)
    new = np.concatenate([new, rng.normal(size=(free, 6))])
    ids = h.insert(new)
    live.update(zip(ids, new))
    assert eng.index_epoch == 1
    check()
    # 3. the per-shard repack
    h.reoptimize()
    check()
