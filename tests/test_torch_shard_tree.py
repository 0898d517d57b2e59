"""repro_torch's shard trees (``search/tree.py``: ``ShardTreeArrays``,
``build_shard_trees``, ``widen_shard_trees``) and the sharded search's tree
branch (``core/distributed.py:sharded_search_local(tree=...)``, the
``sharded`` backend with ``tree_shards``) on the CPU.

* ``build_shard_trees`` equals ``build_tree`` of each shard bit for bit,
  and every node interval holds the float64 pivot cosine of every valid
  row below it; a flat index is refused;
* ``widen_shard_trees`` after shape-stable inserts (and a delete that
  empties no block) equals ``build_shard_trees`` of the mutated index bit
  for bit; shards whose entries are masked are untouched;
* the tree branch through ``make_sharded_search`` and ``SearchEngine``
  equals ``repro.core.ref.brute_force_knn``, the flat branch and the
  single-device engine (tie-aware, 2e-5 / 1e-6), at k in {1, 8, 48} over
  blocks of 32 (the reference's test_sharded_tree corpus, 4,099 rows over
  8 uneven shards) and k in {1, 7, 80} over blocks of 64;
* the reference's ``make_sharded_search(..., tree=)`` on 8 virtual CPU
  devices in a subprocess, its trees built on the host index and then
  placed (``build_shard_trees`` on a placed index raises on jax 0.9.0):
  sims within 2e-5, ids tie-aware, the four weighted fractions within
  ``STATS_PAIRS`` (see there);
* per shard, the tree branch's pruned (query, block) pairs are at least
  the flat branch's, and the descent alone prunes at least the flat
  fraction (the reference's test_sharded_tree_prunes_at_least_flat);
* the fractions are the sums of per-shard counts over summed
  denominators, with uneven shards (a host replay of the branch);
* two and four gloo ranks (``tests/torch_dist_worker.py``) equal the
  one-process run bit for bit.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ref as j_ref  # noqa: E402
from repro_torch.core.distributed import (build_sharded_index, local_shard,  # noqa: E402
                                          make_sharded_search, sharded_index_from_reference)
from repro_torch.core.index import BlockIndex, pivot_cosines64  # noqa: E402
from repro_torch.dist.collectives import global_tau_merge  # noqa: E402
from repro_torch.search import (SearchEngine, ShardTreeArrays, build_shard_trees,  # noqa: E402
                                build_tree)
from repro_torch.search import backends as t_bk  # noqa: E402
from repro_torch.search import tree as t_tree  # noqa: E402
from repro_torch.search.tree import widen_shard_trees  # noqa: E402
from tests.test_torch_distributed import (BLOCK, KS, PIVOTS, ROOT, SHARDS,  # noqa: E402,F401
                                          assert_same_topk, corpus, mesh)
from tests.torch_dist_worker import run_ranks  # noqa: E402

#: the reference's test_sharded_tree ks over blocks of 32 (48 > 32: the
#: multi-block prescan and the mask-carrying τ merge engage)
REF_KS = (1, 8, 48)

#: the fractions against the reference's: the port's node tables come from
#: the sound dp_lo/dp_hi, the reference's from dp_min/dp_max, a few ulp
#: narrower; so a (query, block or node) pair whose bound lies within
#: those ulp of τ may be decided apart.  At most 2 such pairs of each
#: count's denominator; measured: 0 on every configuration here
STATS_PAIRS = 2


def ref_corpus():
    """The reference's test_sharded_tree corpus: clustered, 4,099 rows over
    8 shards (the last one short), 11 queries near rows."""
    rng = np.random.default_rng(11)
    c = j_ref.normalize(rng.normal(size=(6, 24)))
    db = j_ref.normalize(c[rng.integers(0, 6, 4099)]
                         + 0.05 * rng.normal(size=(4099, 24))).astype(np.float32)
    q = j_ref.normalize(db[::400] + 0.01 * rng.normal(size=(11, 24))).astype(np.float32)
    return db, q


@pytest.fixture(scope="module")
def ref_index():
    db, q = ref_corpus()
    return db, q, build_sharded_index(db, 8, n_pivots=8, block_size=32, device="cpu")


# ---------------------------------------------------------------------------
# the build and the widening
# ---------------------------------------------------------------------------

def assert_trees_equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def assert_nodes_hold_fp64(local, tree):
    """Every valid node's [lo, hi] holds the float64 pivot cosine of every
    valid row below it (clamped to [-1, 1], as the intervals are: a row
    equal to a pivot computes to 1 + 1 ulp)."""
    nb, bs, nl = local.n_blocks, local.block_size, tree.n_leaf_slots
    cos = np.clip(pivot_cosines64(local.db, local.pivots).numpy(), -1.0, 1.0)
    valid = local.valid.numpy()[:, None]
    lo = np.full((2 * nl, cos.shape[1]), np.inf)
    hi = np.full((2 * nl, cos.shape[1]), -np.inf)
    lo[nl:nl + nb] = np.where(valid, cos, np.inf).reshape(nb, bs, -1).min(1)
    hi[nl:nl + nb] = np.where(valid, cos, -np.inf).reshape(nb, bs, -1).max(1)
    sz = nl // 2
    while sz >= 1:
        lo[sz:2 * sz] = lo[2 * sz:4 * sz].reshape(sz, 2, -1).min(1)
        hi[sz:2 * sz] = hi[2 * sz:4 * sz].reshape(sz, 2, -1).max(1)
        sz //= 2
    node_valid = tree.node_valid.numpy()
    assert (node_valid[1:] == np.isfinite(lo[1:]).all(1)).all()
    assert (tree.node_lo.double().numpy()[node_valid] <= lo[node_valid]).all()
    assert (tree.node_hi.double().numpy()[node_valid] >= hi[node_valid]).all()


@pytest.mark.parametrize("n,shards,bs", [(4099, 8, 32), (25, 8, 16), (1000, 3, 16)],
                         ids=["4099_over_8", "all_padding_shard", "1000_over_3"])
def test_build_shard_trees_is_build_tree_per_shard(n, shards, bs):
    db, _ = corpus(seed=5, n=n)
    idx = build_sharded_index(db, shards, n_pivots=PIVOTS, block_size=bs, device="cpu")
    trees = build_shard_trees(idx)
    nb = idx.dp_min.shape[1]
    assert isinstance(trees, ShardTreeArrays)
    assert trees.node_lo.shape == (shards, 2 * (1 << (nb - 1).bit_length()),
                                   idx.pivots.shape[1])
    for s in range(shards):
        local = local_shard(idx, s)
        one = build_tree(local)
        assert_trees_equal(trees.shard(local, s)[1:], one[1:])
        assert trees.n_levels == one.n_levels
        assert_nodes_hold_fp64(local, one)
    if n == 25:
        assert not trees.node_valid[7].any()             # an all-padding shard


def test_build_shard_trees_refuses_a_flat_index():
    db, _ = corpus(seed=5, n=300)
    flat = local_shard(build_sharded_index(db, 2, n_pivots=4, block_size=16, device="cpu"), 0)
    with pytest.raises(ValueError, match="shard-stacked"):
        build_shard_trees(flat)


def test_widen_shard_trees_equals_a_rebuild_after_inserts(mesh):
    """The sharded handle widens the engine's live shard trees; while no
    block has lost its last row they equal a rebuild bit for bit."""
    db, q = corpus(seed=6, n=1500)
    eng = SearchEngine.build(db, mesh=mesh, n_shards=4, n_pivots=PIVOTS, block_size=16,
                             tree_shards=True, device="cpu")
    eng.search(q, 5)
    h = eng.online(auto_reoptimize=False)
    rng = np.random.default_rng(1)
    for step in range(3):
        h.insert(rng.normal(size=(5 + step, db.shape[1])).astype(np.float32))
        if step == 1:
            h.delete([3, 700])                  # empties no block
        assert eng.index_epoch == 0
        assert_trees_equal(eng._shard_tree, build_shard_trees(eng.index))


def test_widen_shard_trees_leaves_masked_shards_untouched(ref_index):
    _, _, idx = ref_index
    trees = build_shard_trees(idx)
    before = ShardTreeArrays(*(t.clone() for t in trees))
    rng = np.random.default_rng(2)
    n_shards, p = idx.db.shape[0], PIVOTS
    blocks = torch.from_numpy(rng.integers(0, idx.dp_min.shape[1], (n_shards, 3)))
    lo = torch.from_numpy(rng.uniform(-1, 0, (n_shards, 3, p)).astype(np.float32))
    hi = lo + 1.0
    mask = torch.zeros(n_shards, 3, dtype=torch.bool)
    mask[2, :2] = True                       # shard 2 takes two rows, the rest none
    mask[5, 0] = True
    out = widen_shard_trees(trees, blocks, lo, hi, mask)
    assert out is trees                      # in place, as widen_tree
    for s in range(n_shards):
        same = all(torch.equal(a[s], b[s]) for a, b in zip(trees, before))
        assert same == (s not in (2, 5)), s
    # the widened paths hold their rows' intervals from leaf to root
    nl = trees.node_valid.shape[1] // 2
    node = int(blocks[2, 0]) + nl
    while node >= 1:
        assert (trees.node_lo[2, node] <= lo[2, 0]).all()
        assert (trees.node_hi[2, node] >= hi[2, 0]).all() and trees.node_valid[2, node]
        node //= 2


# ---------------------------------------------------------------------------
# the tree branch against the brute force and the flat branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", REF_KS)
def test_tree_branch_matches_brute_and_flat(mesh, ref_index, k):
    db, q, idx = ref_index
    trees = build_shard_trees(idx)
    run = make_sharded_search(mesh, with_stats=True, element_stats=True,
                              warm_start=True, best_first=True)
    s, i, frac, efrac, tfrac, evfrac = run(idx, q, k, tree=trees)
    sref, iref = j_ref.brute_force_knn(q, db, k)
    assert_same_topk(s.numpy(), i.numpy(), sref, iref, 2e-5)
    s_f, i_f, frac_f, _ = run(idx, q, k)
    assert_same_topk(s.numpy(), i.numpy(), s_f.numpy(), i_f.numpy(), 1e-6)
    assert 0.0 < float(tfrac) <= float(frac) <= 1.0 and 0.0 < float(evfrac) <= 1.0
    assert float(frac) >= float(frac_f) and 0.0 < float(efrac) <= 1.0
    # the engine: tree_shards=True, and prune=False searches flat
    eng = SearchEngine(idx, mesh=mesh, tree_shards=True, device="cpu")
    s_e, i_e, st = eng.search(q, k, element_stats=True)
    assert torch.equal(s_e, s) and torch.equal(i_e, i)
    assert (float(st.block_prune_frac), float(st.elem_prune_frac), float(st.tree_prune_frac),
            float(st.tree_node_eval_frac)) == (float(frac), float(efrac), float(tfrac),
                                              float(evfrac))
    assert st.extras["tree_levels"] == trees.n_levels and st.tile_computed_frac is None
    s_n, i_n, st_n = eng.search(q, k, prune=False)
    assert_same_topk(s_n.numpy(), i_n.numpy(), sref, iref, 2e-5)
    assert st_n.tree_prune_frac is None and float(st_n.block_prune_frac) == 0.0


@pytest.mark.parametrize("k", KS)
def test_tree_engine_matches_brute_and_single_device(mesh, k):
    """Blocks of 64 over 8 shards of the flat tests' corpus (k = 80 takes
    the two-block beam and reseed)."""
    db, q = corpus()
    eng = SearchEngine.build(db, mesh=mesh, n_shards=SHARDS, n_pivots=PIVOTS,
                             block_size=BLOCK, tree_shards=True, device="cpu")
    single = SearchEngine.build(db, n_pivots=PIVOTS, block_size=BLOCK, backend="tree",
                                device="cpu")
    s, i, st = eng.search(q, k)
    sref, iref = j_ref.brute_force_knn(q, db, k)
    assert_same_topk(s.numpy(), i.numpy(), sref, iref, 2e-5)
    s1, i1, _ = single.search(q, k)
    assert_same_topk(s.numpy(), i.numpy(), s1.numpy(), i1.numpy(), 1e-6)
    assert 0.0 <= float(st.tree_prune_frac) <= float(st.block_prune_frac)


@pytest.mark.parametrize("k", REF_KS)
def test_tree_branch_prunes_at_least_flat_per_shard(mesh, ref_index, monkeypatch, k):
    """Each shard's scan prunes at least as many (query, block) pairs on the
    tree branch (global τ, descent mask) as on the flat one (local τ); the
    descent alone prunes at least the flat fraction."""
    db, q, idx = ref_index
    pruned = []
    scan = t_bk.scan_search

    def counted(*a, **kw):
        out = scan(*a, **kw)
        pruned.append(int(out[2]))
        return out

    monkeypatch.setattr(t_bk, "scan_search", counted)
    run = make_sharded_search(mesh, with_stats=True, warm_start=True, best_first=True)
    _, _, frac_f, _ = run(idx, q, k)
    flat, pruned[:] = list(pruned), []
    _, _, frac_t, _, tfrac, _ = run(idx, q, k, tree=build_shard_trees(idx))
    assert len(flat) == len(pruned) == idx.db.shape[0]
    assert all(t >= f for t, f in zip(pruned, flat)), (pruned, flat)
    assert float(frac_t) >= float(frac_f) and float(tfrac) >= float(frac_f)


@pytest.mark.parametrize("k,warm_start", [(8, True), (48, True), (8, False)])
def test_tree_stats_are_summed_over_uneven_shards(ref_index, k, warm_start):
    """A host replay of the branch, shard by shard: beam candidates ->
    global_tau_merge -> tree_search seeded with it; the reported fractions
    are the summed counts over the summed denominators."""
    db, q, idx = ref_index
    trees = build_shard_trees(idx)
    n_shards, m = idx.db.shape[0], len(q)
    locs = [local_shard(idx, s) for s in range(n_shards)]
    preps = [t_bk.prep_queries(loc, q) for loc in locs]
    ts = [trees.shard(loc, s) for s, loc in enumerate(locs)]
    tau = None
    if warm_start:
        cands = [t_tree.tree_warm_start_topk(
            t, qn, qp, k, t_bk.prescan_blocks(k, t.block_size, t.n_blocks, None))
            for t, (qn, qp) in zip(ts, preps)]
        tau = global_tau_merge(torch.stack([c[0] for c in cands]),
                               torch.stack([c[1] for c in cands]), k)
    sums = np.zeros(6)
    for t, (qn, qp) in zip(ts, preps):
        _, _, bp, ep, cut, ev = t_tree.tree_search(
            t, qn, qp, k, warm_start=warm_start, best_first=True, element_stats=True,
            tau_seed=tau)
        sums += [int(bp), int(ep), int(cut), int(ev), int(t.index.valid.sum()),
                 int(t.node_valid.sum())]
    nb_sum = n_shards * idx.dp_min.shape[1]
    _, _, frac, efrac, tfrac, evfrac = make_sharded_search(
        None, with_stats=True, element_stats=True, warm_start=warm_start,
        best_first=True)(idx, q, k, tree=trees)
    assert float(frac) == sums[0] / (m * nb_sum)
    assert float(efrac) == sums[1] / (m * sums[4])
    assert float(tfrac) == sums[2] / (m * nb_sum)
    assert float(evfrac) == sums[3] / (m * sums[5])
    # uneven: the short last shard holds fewer valid rows
    assert int(idx.valid[-1].sum()) < int(idx.valid[0].sum())


# ---------------------------------------------------------------------------
# against the JAX package's tree branch
# ---------------------------------------------------------------------------

#: (name, k, warm_start, best_first, n_pivots) of the reference's
#: make_sharded_search(with_stats=True, element_stats=True) with tree=
JAX_CONFIGS = (("warm_k1", 1, True, True, 0), ("warm_k8", 8, True, True, 0),
               ("warm_k48", 48, True, True, 0), ("cold_k8", 8, False, False, 0),
               ("joint_cap_k8", 8, True, True, 4))

JAX_RUN = """
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.core.distributed import (build_sharded_index, make_sharded_search,
                                        place_sharded_index)
    from repro.search import build_shard_trees
    inp = np.load(sys.argv[1])
    mesh = jax.make_mesh((8,), ("data",))
    host = build_sharded_index(inp["db"], 8, n_pivots=8, block_size=32)
    # the trees on the host index, then placed: build_shard_trees on a
    # placed index raises ShardingTypeError on jax 0.9.0
    sh = NamedSharding(mesh, P(("data",)))
    tree = jax.tree.map(lambda x: jax.device_put(x, sh), build_shard_trees(host))
    idx = place_sharded_index(host, mesh)
    out = {"index_" + f: np.asarray(getattr(host, f)) for f in host._fields
           if getattr(host, f) is not None}
    for name, k, ws, bf, npv in CONFIGS:
        run = make_sharded_search(mesh, with_stats=True, element_stats=True,
                                  warm_start=ws, best_first=bf, n_pivots=npv)
        res = run(idx, jnp.asarray(inp["q"]), k, tree)
        for part, x in zip(("s", "i", "frac", "efrac", "tfrac", "evfrac"), res):
            out[name + "_" + part] = np.asarray(x)
    np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    """The reference's tree branch on 8 virtual CPU devices."""
    tmp = tmp_path_factory.mktemp("jax_tree")
    db, q = ref_corpus()
    np.savez(tmp / "in.npz", db=db, q=q)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": str(ROOT / "src")}
    code = f"CONFIGS = {JAX_CONFIGS!r}\n" + textwrap.dedent(JAX_RUN)
    out = subprocess.run([sys.executable, "-c", code, str(tmp / "in.npz"),
                          str(tmp / "out.npz")], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return db, q, dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("config", JAX_CONFIGS, ids=[c[0] for c in JAX_CONFIGS])
def test_matches_jax_sharded_tree_search(jax_tree, config):
    db, q, j = jax_tree
    name, k, ws, bf, npv = config
    idx = sharded_index_from_reference(
        {f: j.get("index_" + f) for f in BlockIndex._fields}, "cpu")
    s, i, *stats = make_sharded_search(
        None, with_stats=True, element_stats=True, warm_start=ws, best_first=bf,
        n_pivots=npv)(idx, q, k, tree=build_shard_trees(idx))
    assert_same_topk(s.numpy(), i.numpy(), j[name + "_s"], j[name + "_i"], 2e-5)
    sref, iref = j_ref.brute_force_knn(q, db, k)
    assert_same_topk(s.numpy(), i.numpy(), sref, iref, 2e-5)
    m, n_shards, nb = len(q), idx.db.shape[0], idx.dp_min.shape[1]
    units = (m * n_shards * nb, m * int(idx.valid.sum()), m * n_shards * nb,
             m * int(build_shard_trees(idx).node_valid.sum()))
    for part, got, unit in zip(("frac", "efrac", "tfrac", "evfrac"), stats, units):
        want = float(j[name + "_" + part])
        # the reference's fractions are float32: half an ulp beside the pairs
        tol = STATS_PAIRS / unit + float(np.spacing(np.float32(want)))
        assert abs(float(got) - want) <= tol, (part, float(got), want)


# ---------------------------------------------------------------------------
# two and four ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,shape", [(2, (2,)), (4, (2, 2))], ids=["2_ranks", "4_ranks"])
def test_ranks_equal_the_one_process_run(tmp_path, world, shape):
    """Two ranks of two shards each, and four ranks of one on a 2 x 2 mesh:
    every rank's tree branch (make_sharded_search and the engine) equals
    the one-process run over the whole stacked index bit for bit."""
    db, q = corpus(seed=17, n=1300)
    ks = (1, 7, 80)
    inputs = dict(db=db, q=q, n_shards=4, ks=np.asarray(ks), n_pivots=PIVOTS,
                  block_size=16, mesh_shape=np.asarray(shape),
                  mesh_dims=np.asarray(["data", "model"][:len(shape)]),
                  parts=np.asarray(["tree"]))
    outs = run_ranks(world, tmp_path, inputs)
    whole = build_sharded_index(db, 4, n_pivots=PIVOTS, block_size=16, device="cpu")
    trees = build_shard_trees(whole)
    run = make_sharded_search(None, with_stats=True, element_stats=True, warm_start=True,
                              best_first=True)
    for k in ks:
        s, i, *stats = run(whole, q, k, tree=trees)
        sref, iref = j_ref.brute_force_knn(q, db, k)
        assert_same_topk(s.numpy(), i.numpy(), sref, iref, 2e-5)
        for out in outs:
            np.testing.assert_array_equal(out[f"tree_s{k}"], s.numpy())
            np.testing.assert_array_equal(out[f"tree_i{k}"], i.numpy())
            assert out[f"tree_stats{k}"].tolist() == [float(x) for x in stats]
    s, i, st = SearchEngine(whole, tree_shards=True, device="cpu").search(
        q, ks[-1], element_stats=True)
    want = [float(st.block_prune_frac), float(st.elem_prune_frac),
            float(st.tree_prune_frac), float(st.tree_node_eval_frac)]
    for out in outs:
        np.testing.assert_array_equal(out["tree_engine_s"], s.numpy())
        np.testing.assert_array_equal(out["tree_engine_i"], i.numpy())
        assert out["tree_engine_stats"].tolist() == want
