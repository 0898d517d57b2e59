"""The port's ``"sharded"`` backend through ``SearchEngine``, on the CPU.

* ``SearchEngine.build(db, mesh=...)`` on a one-rank mesh holding all 8
  shards picks ``"sharded"`` and equals ``repro.core.ref.brute_force_knn``
  and the port's single-device engine at k in {1, 7, 80}; its stats are
  the sharded layer's, with the reference's ``n_valid`` and ``n_slots``;
* the reference's two guards (a flat index on ``"sharded"``, a stacked
  one on any other backend), ``tree_shards`` turning the shard trees on
  and a sharded ``online()`` handing out a ``ShardedMutableIndex``, a mesh
  on another device type, and ``tree_shards``' auto rule searching deep
  shards through their trees;
* four ranks with one shard each on a 2 x 2 mesh
  (``tests/torch_dist_worker.py``, gloo through a file store): the
  process-local build bit for bit against ``build_sharded_index``'s
  slices, and every rank's answers and weighted stats, through
  ``make_sharded_search`` and both engine builds, against the brute force
  and the one-process run.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ref as j_ref  # noqa: E402
from repro_torch.core.distributed import (build_sharded_index,  # noqa: E402
                                          make_sharded_search)
from repro_torch.core.online import MutableIndex, ShardedMutableIndex  # noqa: E402
from repro_torch.search import SearchEngine, auto_backend  # noqa: E402
from tests.test_torch_distributed import (BLOCK, KS, PIVOTS, SHARDS,  # noqa: E402,F401
                                          assert_same_topk, corpus, mesh)
from tests.torch_dist_worker import run_ranks  # noqa: E402


@pytest.fixture(scope="module")
def engines(mesh):
    db, q = corpus(seed=9)
    eng = SearchEngine.build(db, mesh=mesh, n_shards=SHARDS, n_pivots=PIVOTS,
                             block_size=BLOCK, device="cpu")
    single = SearchEngine.build(db, n_pivots=PIVOTS, block_size=BLOCK, backend="scan",
                                device="cpu")
    return db, q, eng, single


@pytest.mark.parametrize("k", KS)
def test_engine_on_a_mesh_is_sharded_and_exact(engines, k):
    db, q, eng, single = engines
    assert eng.backend_name == "sharded" and eng.index.db.shape[0] == SHARDS
    s, i, st = eng.search(q, k, element_stats=True)
    sref, iref = j_ref.brute_force_knn(q, db, k)
    assert_same_topk(s.numpy(), i.numpy(), sref, iref, 2e-5)
    s1, i1, _ = single.search(q, k)
    assert_same_topk(s.numpy(), i.numpy(), s1.numpy(), i1.numpy(), 1e-6)
    # the engine's stats are the sharded layer's, per-shard block count
    want = make_sharded_search(None, with_stats=True, element_stats=True,
                               warm_start=True, best_first=True)(eng.index, q, k)
    assert torch.equal(s, want[0]) and torch.equal(i, want[1])
    assert float(st.block_prune_frac) == float(want[2])
    assert float(st.elem_prune_frac) == float(want[3]) > 0.0
    assert st.backend == "sharded" and st.n_blocks == eng.index.dp_min.shape[1]
    assert st.tree_prune_frac is None and st.tile_computed_frac is None
    per = -(-len(db) // SHARDS)
    assert eng.n_valid == len(db)
    assert eng.n_slots == SHARDS * (-(-per // BLOCK) * BLOCK)


def test_engine_k_past_every_slot_pads_minus_one(mesh):
    db, q = corpus(seed=2, n=100)
    eng = SearchEngine.build(db, mesh=mesh, n_shards=4, n_pivots=4, block_size=16,
                             device="cpu")
    # 4 shards of 25 rows, 32 slots each: k = 30 passes a shard's rows and
    # k = 140 every slot
    for k in (30, 140):
        s, i, _ = eng.search(q, k)
        assert s.shape == (len(q), k)
        sref, iref = j_ref.brute_force_knn(q, db, 100)
        kk = min(k, 100)
        assert_same_topk(s[:, :kk].numpy(), i[:, :kk].numpy(), sref[:, :kk],
                         iref[:, :kk], 2e-5)
        assert (i[:, 100:] == -1).all() and torch.isneginf(s[:, 100:]).all()


def test_engine_distributed_build_in_one_process(mesh, engines):
    db, q, eng, _ = engines
    local = SearchEngine.build(db, mesh=mesh, distributed=True, n_shards=SHARDS,
                               n_pivots=PIVOTS, block_size=BLOCK, device="cpu")
    for a, b in zip(local.index, eng.index):
        assert torch.equal(a, b)
    whole = build_sharded_index(db, SHARDS, n_pivots=PIVOTS, block_size=BLOCK,
                                device="cpu")
    for a, b in zip(whole, eng.index):
        assert torch.equal(a, b)


def test_engine_guards(mesh, engines):
    db, _, eng, single = engines
    with pytest.raises(ValueError, match="shard-stacked"):
        SearchEngine(single.index, backend="sharded", device="cpu")
    with pytest.raises(ValueError, match="sharded"):
        SearchEngine(eng.index, backend="scan", device="cpu")
    with pytest.raises(ValueError, match="sharded"):
        SearchEngine(eng.index, backend="kernel", mesh=mesh, device="cpu")
    assert auto_backend(single.index, mesh) == "sharded"
    # the shard trees are on where asked and off by the auto rule at 65
    # blocks a shard; a sharded engine's online handle is the sharded one
    assert eng.tree_shards is None and not eng._tree_shards_enabled
    assert SearchEngine(eng.index, mesh=mesh, tree_shards=True,
                        device="cpu")._tree_shards_enabled
    fresh = SearchEngine(eng.index, mesh=mesh, device="cpu")
    assert isinstance(fresh.online(), ShardedMutableIndex)
    with pytest.raises(TypeError, match="ShardedMutableIndex"):
        MutableIndex(fresh)
    with pytest.raises(ValueError, match="mesh="):
        SearchEngine.build(db, distributed=True, device="cpu")
    with pytest.raises(ValueError, match="mesh is on 'cuda'"):
        SearchEngine.build(db, mesh=types.SimpleNamespace(device_type="cuda"),
                           device="cpu")
    with pytest.raises(ValueError, match="do not split evenly"):
        SearchEngine.build(db, mesh=mesh, n_shards=0, device="cpu")
    # a flat engine ignores tree_shards, as the reference's does
    flat = SearchEngine(single.index, tree_shards=True, device="cpu")
    assert flat.backend_name == "scan" and not flat._tree_shards_enabled


def test_tree_shards_auto_searches_deep_shards_with_trees(mesh):
    """From 256 blocks a shard the reference's auto rule turns the shard
    trees on: the same result sets as the flat search, the tree's stats
    beside them, and at least the flat search's pruning."""
    db, q = corpus(seed=4, n=4096)
    eng = SearchEngine.build(db, mesh=mesh, n_shards=2, n_pivots=4, block_size=8,
                             device="cpu")
    assert eng.index.dp_min.shape[1] == 256 and eng.tree_shards is None
    assert eng._tree_shards_enabled
    s, i, st = eng.search(q, 10)
    sref, iref = j_ref.brute_force_knn(q, db, 10)
    assert_same_topk(s.numpy(), i.numpy(), sref, iref, 2e-5)
    assert 0.0 < float(st.tree_prune_frac) <= 1.0
    assert 0.0 < float(st.tree_node_eval_frac) <= 1.0
    assert st.extras["tree_levels"] == 8 and eng._shard_tree is not None
    flat = SearchEngine(eng.index, mesh=mesh, tree_shards=False, device="cpu")
    s_f, i_f, st_f = flat.search(q, 10)
    assert_same_topk(s.numpy(), i.numpy(), s_f.numpy(), i_f.numpy(), 1e-6)
    assert st_f.tree_prune_frac is None and st_f.tree_node_eval_frac is None
    assert float(st.block_prune_frac) >= float(st_f.block_prune_frac) > 0.0


# ---------------------------------------------------------------------------
# four ranks, one shard each, on a 2 x 2 mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    db, q = corpus(seed=13, n=1700)
    rng = np.random.default_rng(0)
    inputs = dict(db=db, q=q, n_shards=4, ks=np.asarray(KS), n_pivots=PIVOTS,
                  block_size=BLOCK, mesh_shape=np.asarray([2, 2]),
                  mesh_dims=np.asarray(["data", "model"]),
                  cand_s=rng.normal(size=(4, 3, 5)).astype(np.float32),
                  cand_i=np.arange(60, dtype=np.int32).reshape(4, 3, 5),
                  cand_v=np.ones((4, 3, 5), bool), merge_k=5)
    outs = run_ranks(4, tmp_path_factory.mktemp("four_ranks"), inputs)
    whole = build_sharded_index(db, 4, n_pivots=PIVOTS, block_size=BLOCK, device="cpu")
    return inputs, outs, whole


def test_four_ranks_local_build_is_bit_identical(four_ranks):
    inputs, outs, whole = four_ranks
    per = -(-len(inputs["db"]) // 4)
    for rank, out in enumerate(outs):
        assert tuple(out["position"]) == (4, rank)
        assert out["owned"].tolist() == [[rank, rank * per, min((rank + 1) * per,
                                                                len(inputs["db"]))]]
        for f, t in zip(whole._fields, whole):
            np.testing.assert_array_equal(out[f"index_{f}"], t[rank:rank + 1].numpy(),
                                          err_msg=f"rank {rank} {f}")
        # both engine builds hold this rank's shard alone
        np.testing.assert_array_equal(out["engine_db"], whole.db[rank:rank + 1].numpy())
        np.testing.assert_array_equal(out["engine_local_db"], out["engine_db"])


@pytest.mark.parametrize("k", KS)
def test_four_ranks_search_matches_brute_and_one_process(four_ranks, k):
    inputs, outs, whole = four_ranks
    db, q = inputs["db"], inputs["q"]
    s, i, frac, efrac = make_sharded_search(
        None, with_stats=True, element_stats=True, warm_start=True,
        best_first=True)(whole, q, k)
    sref, iref = j_ref.brute_force_knn(q, db, k)
    for out in outs:
        np.testing.assert_array_equal(out[f"s{k}"], s.numpy())
        np.testing.assert_array_equal(out[f"i{k}"], i.numpy())
        assert (float(out[f"frac{k}"]), float(out[f"efrac{k}"])) == (float(frac),
                                                                    float(efrac))
        assert_same_topk(out[f"s{k}"], out[f"i{k}"], sref, iref, 2e-5)


def test_four_ranks_engines_match_one_process(four_ranks):
    inputs, outs, whole = four_ranks
    db, q, k = inputs["db"], inputs["q"], KS[-1]
    one = SearchEngine(whole, device="cpu")
    s, i, st = one.search(q, k, element_stats=True)
    want = [float(st.block_prune_frac), float(st.elem_prune_frac), one.n_valid,
            one.n_slots]
    assert one.n_valid == len(db)
    for out in outs:
        for name in ("engine", "engine_local"):
            assert str(out[f"{name}_backend"]) == "sharded"
            np.testing.assert_array_equal(out[f"{name}_s"], s.numpy())
            np.testing.assert_array_equal(out[f"{name}_i"], i.numpy())
            assert out[f"{name}_stats"].tolist() == want
