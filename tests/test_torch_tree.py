"""repro_torch.search.tree against repro.search.tree, on the CPU, and the
tree and scan backends against the fp64 brute force.

Both packages search the identical index (the reference's, carried over
with ``index_from_reference``).  The port's node intervals contain the
reference's and lie within REF_SLACK of them; its Eq. 13 bounds over them
are held to the float64 truth and to the reference's within REF_SLACK away
from +-1 (test_torch_cuda.assert_bounds_against_reference), and its
descent equals the reference's descent run on the port's bounds.  Scores
(XLA's and torch's fp32 matmuls) within 1e-6; prune counts equal, or apart
only by decisions within 2·margin of τ (tests/test_torch_scan.py states
the rule).
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.index import build_index as j_build_index  # noqa: E402
from repro.search import SearchEngine as JEngine  # noqa: E402
from repro.search import auto_backend as j_auto_backend  # noqa: E402
from repro.search import backends as j_bk  # noqa: E402
from repro.search import tree as j_tree  # noqa: E402
from chip_smoke import tie_aware_mismatches  # noqa: E402
from repro_torch.core import ref  # noqa: E402
from repro_torch.core.index import build_index, index_from_reference  # noqa: E402
from repro_torch.kernels.bound_prune import block_bounds  # noqa: E402
from repro_torch.search import SearchEngine, TreeIndex, auto_backend, build_tree  # noqa: E402
from repro_torch.search import backends as t_bk  # noqa: E402
from repro_torch.search import tree as t_tree  # noqa: E402
from tests.conftest import clustered  # noqa: E402
from tests.test_torch_cuda import (MARGIN, REF_SLACK,  # noqa: E402
                                   assert_bounds_against_reference,
                                   assert_same_counts, scan_gaps)
from tests.test_torch_pivots_index import fields  # noqa: E402
from tests.test_torch_scan import (assert_same_topk, both_indexes,  # noqa: E402
                                   both_queries, make_corpus)


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        (a.view(np.uint8) == b.view(np.uint8)).all())


def with_holes(db, block_size, seed=0):
    """Both packages' indexes with a third of the rows and two whole
    blocks made invalid, so some leaves and subtrees are empty."""
    j_idx = j_build_index(jnp.asarray(db), n_pivots=16, block_size=block_size)
    valid = np.asarray(j_idx.valid).copy()
    valid &= np.random.default_rng(seed).uniform(size=valid.shape) > 0.3
    nb = j_idx.dp_min.shape[0]
    valid.reshape(nb, block_size)[[1, nb // 2]] = False
    j_idx = j_idx._replace(valid=jnp.asarray(valid))
    return j_idx, index_from_reference(fields(j_idx), "cpu")


# (corpus, n, block size): 2048 rows at 16 make 128 blocks (depth 7);
# 4100 at 16 make 257 blocks, past the reference's tree threshold (a leaf
# row of 512 slots, 255 of them empty)
SHAPES = {"clustered-128": ("clustered", 2048, 16),
          "uniform-32": ("uniform", 2048, 64),
          "clustered-257": ("clustered", 4100, 16)}


@pytest.fixture(scope="module", params=list(SHAPES))
def shape(request):
    kind, n, bs = SHAPES[request.param]
    db, q = make_corpus(kind, seed=1, n=n)
    j_idx, t_idx = both_indexes(db, bs)
    return db, q, j_idx, t_idx


# ---------------------------------------------------------------------------
# the tree's pieces against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("holes", [False, True], ids=["full", "holes"])
def test_build_tree_matches_reference(shape, holes):
    db, _, j_idx, t_idx = shape
    if holes:
        j_idx, t_idx = with_holes(db, t_idx.block_size)
    want, got = j_tree.build_tree(j_idx), build_tree(t_idx)
    assert isinstance(got, TreeIndex)
    assert bits_equal(got.node_valid.numpy(), want.node_valid)
    # the port's node intervals contain the reference's (float32) ones and
    # lie within REF_SLACK of them; the leaves hold every valid row's
    # float64 pivot cosine
    full = got.node_valid.numpy()
    lo_t, hi_t = got.node_lo.numpy()[full], got.node_hi.numpy()[full]
    lo_j, hi_j = np.asarray(want.node_lo)[full], np.asarray(want.node_hi)[full]
    assert (lo_t <= lo_j).all() and (hi_t >= hi_j).all()
    np.testing.assert_allclose(lo_t, lo_j, atol=REF_SLACK, rtol=0)
    np.testing.assert_allclose(hi_t, hi_j, atol=REF_SLACK, rtol=0)
    nb, bs, nl = t_idx.n_blocks, t_idx.block_size, got.n_leaf_slots
    piv = t_idx.pivots.double().numpy()
    x = t_idx.db.double().numpy()
    cos = np.clip((x @ piv.T) / np.maximum(np.linalg.norm(x, axis=1)[:, None]
                                           * np.linalg.norm(piv, axis=1)[None, :],
                                           1e-300), -1, 1)    # a cosine
    valid = t_idx.valid.numpy()
    blk = np.repeat(np.arange(nb), bs)
    leaf_lo, leaf_hi = got.node_lo.numpy()[nl + blk], got.node_hi.numpy()[nl + blk]
    assert ((leaf_lo <= cos) & (cos <= leaf_hi))[valid].all()
    assert (got.n_leaf_slots, got.n_levels, got.n_blocks, got.block_size) == (
        want.n_leaf_slots, want.n_levels, want.n_blocks, want.block_size)
    assert got.n_valid_nodes == want.n_valid_nodes
    # empty subtrees carry the inverted sentinel interval
    empty = ~got.node_valid[1:]
    assert bool((got.node_lo[1:][empty] == float("inf")).all())
    assert bool((got.node_hi[1:][empty] == float("-inf")).all())
    if holes:
        assert bool(empty.any())


@pytest.mark.parametrize("k,width", [(3, 1), (10, 2), (40, 4), (70, 3)])
def test_tree_warm_start_matches_reference(shape, k, width):
    _, q, j_idx, t_idx = shape
    (jqn, jqp), (tqn, tqp) = both_queries(j_idx, q)
    j_t, t_t = j_tree.build_tree(j_idx), build_tree(t_idx)
    s_j, v_j = j_tree.tree_warm_start_topk(j_t, jqn, jqp, k, width)
    s_t, v_t = t_tree.tree_warm_start_topk(t_t, tqn, tqp, k, width)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(np.isneginf(s_t.numpy()), np.isneginf(np.asarray(s_j)))
    fin = np.isfinite(np.asarray(s_j))
    np.testing.assert_allclose(s_t.numpy()[fin], np.asarray(s_j)[fin], atol=1e-6)
    tau_j = np.asarray(j_tree.tree_warm_start(j_t, jqn, jqp, k, width))
    tau_t = t_tree.tree_warm_start(t_t, tqn, tqp, k, width).numpy()
    np.testing.assert_allclose(tau_t, tau_j, atol=1e-6)
    sref, _ = ref.brute_force_knn(q, np.asarray(j_idx.db)[np.asarray(j_idx.valid)], k)
    assert (tau_t <= sref[:, -1] + 1e-6).all()           # a true lower bound


@pytest.mark.parametrize("seed", ["beam", "none"])
def test_tree_descend_matches_reference(shape, seed, monkeypatch):
    _, q, j_idx, t_idx = shape
    (jqn, jqp), (tqn, tqp) = both_queries(j_idx, q)
    j_t, t_t = j_tree.build_tree(j_idx), build_tree(t_idx)
    tau0 = (j_tree.tree_warm_start(j_t, jqn, jqp, 10, 1) if seed == "beam"
            else jnp.full((q.shape[0],), -jnp.inf, jnp.float32))
    _, ub_j, _ = j_tree.tree_descend(j_t, jqp, tau0, MARGIN)
    alive_t, ub_t, evals_t = t_tree.tree_descend(
        t_t, tqp, torch.from_numpy(np.asarray(tau0)), MARGIN)
    # the leaf bounds against the reference's, by the bound rule
    leaf = slice(t_t.n_leaf_slots, t_t.n_leaf_slots + t_idx.n_blocks)
    assert_bounds_against_reference(ub_t.numpy(), ub_j, tqp.numpy(),
                                    t_t.node_lo[leaf].numpy(), t_t.node_hi[leaf].numpy())

    # the reference's descent on the port's node bounds: the same frontier,
    # cuts and evaluation count
    def port_bounds(qp, lo, hi):
        base = lo.shape[0]
        return jnp.asarray(block_bounds(tqp, t_t.node_lo[base:2 * base],
                                        t_t.node_hi[base:2 * base]).numpy())

    monkeypatch.setattr(j_tree.kref, "block_bounds", port_bounds)
    alive_j, ub_jt, evals_j = j_tree.tree_descend(j_t, jqp, tau0, MARGIN)
    assert bits_equal(ub_t.numpy(), ub_jt)
    np.testing.assert_array_equal(alive_t.numpy(), np.asarray(alive_j))
    assert evals_t.dtype == torch.int64 and int(evals_t) == int(evals_j)
    # the leaf level is the flat bound matrix the scan would compute
    assert torch.equal(ub_t, block_bounds(tqp, t_idx.dp_lo, t_idx.dp_hi)
                       .masked_fill(~t_idx.valid.reshape(t_idx.n_blocks, -1).any(1),
                                    float("-inf")))
    if seed == "beam":
        assert not bool(alive_t.all())                   # the descent cuts


def test_tree_descend_single_block():
    """Depth 0: the root is the only leaf; one bound evaluation."""
    db, q = make_corpus("clustered", seed=2, n=100, m=5)
    j_idx, t_idx = both_indexes(db, 128, n_pivots=8)
    (jqn, jqp), (_, tqp) = both_queries(j_idx, q)
    j_t, t_t = j_tree.build_tree(j_idx), build_tree(t_idx)
    assert t_t.n_levels == 0
    tau0 = jnp.full((5,), 0.5, jnp.float32)
    want = j_tree.tree_descend(j_t, jqp, tau0)
    got = t_tree.tree_descend(t_t, tqp, torch.full((5,), 0.5))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert bits_equal(got[1].numpy(), want[1]) and int(got[2]) == int(want[2]) == 5


@pytest.mark.parametrize("knobs", [
    dict(), dict(best_first=False), dict(n_pivots=8), dict(warm_start=False),
    dict(prune=False), dict(warm_start_blocks=3)],
    ids=["default", "natural_order", "joint_cap", "cold", "no_prune", "wide_prescan"])
@pytest.mark.parametrize("k", [1, 10, 70])
def test_tree_search_matches_reference(shape, knobs, k):
    db, q, j_idx, t_idx = shape
    (jqn, jqp), (tqn, tqp) = both_queries(j_idx, q)
    kw = dict(dict(prune=True, warm_start=True, best_first=True, element_stats=True,
                   margin=MARGIN), **knobs)
    out_j = j_tree.tree_search(j_tree.build_tree(j_idx), jqn, jqp, k, **kw)
    out_t = t_tree.tree_search(build_tree(t_idx), tqn, tqp, k, **kw)
    assert_same_topk(out_j[0], out_j[1], out_t[0], out_t[1])
    assert [int(x) for x in out_t[4:]] == [int(x) for x in out_j[4:]]

    def replay():
        if not kw["prune"]:
            return scan_gaps(t_idx, tqn, tqp, k, prune=False, best_first=kw["best_first"])
        tau0, alive, leaf_ub, _ = t_tree._seed_and_descend(
            build_tree(t_idx), tqn, tqp, k, warm_start=kw["warm_start"],
            warm_start_blocks=kw.get("warm_start_blocks"), margin=MARGIN)
        if kw.get("n_pivots"):
            leaf_ub = torch.minimum(leaf_ub, t_bk.multipivot_block_cap(
                t_idx, tqn, n_pivots=kw["n_pivots"]))
        return scan_gaps(t_idx, tqn, tqp, k, best_first=kw["best_first"], tau0=tau0,
                         ub_all=leaf_ub, leaf_mask=alive)

    assert_same_counts((int(out_t[2]), int(out_t[3])), (int(out_j[2]), int(out_j[3])),
                       replay)
    sref, iref = ref.brute_force_knn(q, db, k)
    np.testing.assert_allclose(out_t[0].numpy(), sref, atol=3e-5)


def reference_prep(monkeypatch, j_idx):
    """Hand the port's engine the reference's normalized queries and pivot
    similarities.  Each package's own prep differs from the other's by an
    ulp here and there; a bound that moves by an ulp can swap two blocks of
    (nearly) equal batch-max bound in the best-first order, and then τ
    rises along another path, so the counts are compared on equal inputs."""
    def prep(index, queries):
        qn, qp = j_bk.prep_queries(j_idx, jnp.asarray(np.asarray(queries)))
        return torch.from_numpy(np.array(qn)), torch.from_numpy(np.array(qp))
    monkeypatch.setattr(t_bk, "prep_queries", prep)


@pytest.mark.parametrize("knobs", [dict(), dict(n_pivots=8), dict(best_first=False)],
                         ids=["default", "joint_cap", "natural_order"])
@pytest.mark.parametrize("k", [1, 10, 70])
def test_tree_engine_matches_reference(shape, knobs, k, monkeypatch):
    """The tree engines of both packages (the reference's with
    leaf_eval='scan', the port's only leaf stage) and every knob explicit:
    result sets equal, each preparing its own queries; on the reference's
    prepared queries, all four pruning fractions equal too."""
    db, q, j_idx, t_idx = shape
    kw = dict(dict(best_first=True, n_pivots=0, warm_start=True), **knobs)
    j_eng = JEngine(j_idx, backend="tree", leaf_eval="scan", **kw)
    s_j, i_j, st_j = j_eng.search(jnp.asarray(q), k, element_stats=True)
    s_t, i_t, _ = SearchEngine(t_idx, backend="tree", device="cpu", **kw).search(
        q, k, element_stats=True)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6)
    np.testing.assert_array_equal(np.sort(i_t.numpy(), 1), np.sort(np.asarray(i_j), 1))
    sref, iref = ref.brute_force_knn(q, db, k)
    np.testing.assert_array_equal(np.sort(i_t.numpy(), 1), np.sort(iref, 1))

    reference_prep(monkeypatch, j_idx)
    t_eng = SearchEngine(t_idx, backend="tree", device="cpu", **kw)
    s_t, i_t, st_t = t_eng.search(q, k, element_stats=True)
    np.testing.assert_array_equal(np.sort(i_t.numpy(), 1), np.sort(np.asarray(i_j), 1))
    m, nb = q.shape[0], t_idx.n_blocks
    counts = {}
    for name, st_ in (("port", st_t), ("reference", st_j)):
        counts[name] = tuple(round(float(st_[f]) * m * units) for f, units in (
            ("block_prune_frac", nb), ("elem_prune_frac", t_eng.n_valid),
            ("tree_prune_frac", nb), ("tree_node_eval_frac", t_eng._tree_valid_nodes)))
    assert counts["port"][2:] == counts["reference"][2:]
    tqn, tqp = t_bk.prep_queries(t_idx, q)

    def replay():
        tau0, alive, leaf_ub, _ = t_tree._seed_and_descend(
            t_eng._tree_index, tqn, tqp, k, warm_start=True, warm_start_blocks=None,
            margin=MARGIN)
        if kw["n_pivots"]:
            leaf_ub = torch.minimum(leaf_ub, t_bk.multipivot_block_cap(
                t_idx, tqn, n_pivots=kw["n_pivots"]))
        return scan_gaps(t_idx, tqn, tqp, k, best_first=kw["best_first"], tau0=tau0,
                         ub_all=leaf_ub, leaf_mask=alive)

    assert_same_counts(counts["port"][:2], counts["reference"][:2], replay)
    assert st_t.extras == {"tree_levels": st_j.extras["tree_levels"]}
    assert st_t.backend == "tree" and st_t.n_pivots == st_j.n_pivots == kw["n_pivots"]
    assert t_eng._tree_index is not None and t_eng._tree_valid_nodes > 0


@pytest.mark.parametrize("knobs", [dict(), dict(n_pivots=8), dict(best_first=False),
                                   dict(sort_queries=False)],
                         ids=["default", "joint_cap", "natural_order", "unsorted"])
@pytest.mark.parametrize("k", [1, 10])
def test_tree_kernel_leaves_match_reference(shape, knobs, k, monkeypatch):
    """The tree engines with the kernel leaf stage, the reference's
    _run_kernel_leaves (Pallas in interpret mode) and the port's
    (pruned_topk's plain version), on the reference's prepared queries:
    result sets equal each other and the fp64 brute force; the descent's
    fractions equal; the kernel's tile counts and element counts equal,
    since no decision of these inputs lies within REF_SLACK of τ (the
    port's bound over the query interval and the sound node intervals
    moves by at most that much here)."""
    db, q, j_idx, t_idx = shape
    kw = dict(dict(best_first=True, n_pivots=0, warm_start=True), **knobs)
    es = not kw["n_pivots"]             # the joint cap refines only without
    j_eng = JEngine(j_idx, backend="tree", leaf_eval="kernel", interpret=True,
                    bm=8, **kw)
    s_j, i_j, st_j = j_eng.search(jnp.asarray(q), k, element_stats=es)
    reference_prep(monkeypatch, j_idx)
    t_eng = SearchEngine(t_idx, backend="tree", leaf_eval="kernel", bm=8,
                         device="cpu", **kw)
    s_t, i_t, st_t = t_eng.search(q, k, element_stats=es)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6)
    np.testing.assert_array_equal(np.sort(i_t.numpy(), 1), np.sort(np.asarray(i_j), 1))
    assert_exact(s_t, i_t, q, db, np.arange(len(db)), k)
    for f in ("block_prune_frac", "tile_computed_frac", "tree_prune_frac",
              "tree_node_eval_frac", "elem_prune_frac"):
        a, b = st_j[f], st_t[f]
        assert (a is None) == (b is None), f
        if a is not None:
            assert abs(float(a) - float(b)) < 1e-6, (f, float(a), float(b))
    assert st_t.extras["tree_levels"] == st_j.extras["tree_levels"]
    assert 1 <= st_t.extras["n_keep"] <= t_idx.n_blocks
    assert st_t.backend == "tree" and t_eng.leaf_eval == "kernel"


def test_tree_kernel_leaves_run_only_where_the_reference_runs_them(shape):
    """leaf_eval='kernel' takes the scan leaf stage with pruning off or at
    k past the block (the kernel's tile), as the reference does; 'auto' is
    the scan on a CPU index.  An empty union of surviving leaves keeps
    block 0."""
    db, q, j_idx, t_idx = shape
    bs = t_idx.block_size
    kern = SearchEngine(t_idx, backend="tree", leaf_eval="kernel", device="cpu")
    scan = SearchEngine(t_idx, backend="tree", leaf_eval="scan", device="cpu")
    auto = SearchEngine(t_idx, backend="tree", device="cpu")
    for k, prune in ((bs + 1, True), (10, False)):
        s_k, i_k, st_k = kern.search(q, k, prune=prune)
        s_s, i_s, st_s = scan.search(q, k, prune=prune)
        assert torch.equal(s_k, s_s) and torch.equal(i_k, i_s)
        assert st_k.tile_computed_frac is None and "n_keep" not in st_k.extras
    assert "n_keep" in kern.search(q, 10)[2].extras
    assert "n_keep" not in auto.search(q, 10)[2].extras


def test_tree_kernel_leaves_empty_union_keeps_block_0(monkeypatch):
    """With every leaf cut, the kernel leaf stage still runs, over block 0,
    in both packages alike."""
    db, q = make_corpus("clustered", seed=1, n=1024, m=6)
    j_idx, t_idx = both_indexes(db, 32)

    def cut_all(orig):
        def run(*a, **kw):
            tau0, alive, ub, evals = orig(*a, **kw)
            return tau0, alive & False, ub, evals
        return run

    monkeypatch.setattr(j_tree, "_seed_and_descend", cut_all(j_tree._seed_and_descend))
    monkeypatch.setattr(t_tree, "_seed_and_descend", cut_all(t_tree._seed_and_descend))
    reference_prep(monkeypatch, j_idx)
    s_j, i_j, st_j = JEngine(j_idx, backend="tree", leaf_eval="kernel", interpret=True,
                             bm=8).search(jnp.asarray(q), 5)
    s_t, i_t, st_t = SearchEngine(t_idx, backend="tree", leaf_eval="kernel", bm=8,
                                  device="cpu").search(q, 5)
    assert st_t.extras["n_keep"] == 1
    assert_same_topk(s_j, i_j, s_t, i_t)
    # block 0's rows, or the τ seeds' -1 where its tile was skipped
    i_t_np = i_t.numpy()
    assert (np.isin(i_t_np, t_idx.row_ids.numpy()[:32]) | (i_t_np == -1)).all()
    assert abs(float(st_t.tile_computed_frac) - float(st_j.tile_computed_frac)) < 1e-6


def test_tree_engine_prune_off_leaves_tree_fractions_none(shape):
    db, q, j_idx, t_idx = shape
    j_eng = JEngine(j_idx, backend="tree", leaf_eval="scan", best_first=True)
    t_eng = SearchEngine(t_idx, backend="tree", device="cpu")
    _, i_j, st_j = j_eng.search(jnp.asarray(q), 10, prune=False)
    _, i_t, st_t = t_eng.search(q, 10, prune=False)
    assert st_t.tree_prune_frac is None and st_t.tree_node_eval_frac is None
    assert st_j.tree_prune_frac is None
    assert float(st_t.block_prune_frac) == 0.0
    np.testing.assert_array_equal(np.sort(i_t.numpy(), 1), np.sort(np.asarray(i_j), 1))


def test_tree_prunes_at_least_scan():
    """The tree's τ₀ is the max of the beam seed and the scan's flat seed,
    so it prunes at least what the scan prunes; the descent cuts subtrees
    with fewer evaluations than one per (query, node)."""
    rng = np.random.default_rng(0)
    db = clustered(rng, 4096, 32, n_centers=8, noise=0.04)
    q = db[rng.choice(4096, 32, replace=False)] + 0.02 * rng.normal(size=(32, 32))
    idx = build_index(db, n_pivots=16, block_size=64, device="cpu")
    _, _, st_s = SearchEngine(idx, backend="scan", device="cpu").search(q, 10)
    _, _, st_t = SearchEngine(idx, backend="tree", device="cpu").search(q, 10)
    assert float(st_t.block_prune_frac) >= float(st_s.block_prune_frac) - 1e-6
    assert float(st_t.tree_prune_frac) > 0.3
    assert float(st_t.tree_node_eval_frac) < 0.9


# ---------------------------------------------------------------------------
# the engine's rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,bs", [(200, 8, 32), (256, 8, 16), (2000, 8, 64),
                                    (256 * 32, 8, 32), (255 * 32, 8, 32),
                                    (300, 4100, 16), (600, 4100, 128)])
def test_auto_backend_follows_reference_on_cpu(n, d, bs):
    """On a CPU index the port picks what the reference picks off the TPU:
    brute up to 256 padded rows, then tree from 256 blocks, else scan, at
    any d (the scan and tree are exact near +-1 since their bound is
    sound: test_backends_exact_at_the_d2_bound_counterexample)."""
    db = np.random.default_rng(n + d).normal(size=(n, d)).astype(np.float32)
    j_idx = j_build_index(jnp.asarray(db), n_pivots=4, block_size=bs)
    want = j_auto_backend(j_idx)
    got = auto_backend(index_from_reference(fields(j_idx), "cpu"))
    assert want == ("brute" if j_idx.db.shape[0] <= 256 else
                    "tree" if j_idx.dp_min.shape[0] >= 256 else "scan")
    assert got == want


def test_build_tree_rejects_sharded_index():
    idx = build_index(np.random.default_rng(4).normal(size=(128, 8)), n_pivots=4,
                      block_size=32, device="cpu")
    with pytest.raises(ValueError, match="single-shard"):
        build_tree(idx._replace(db=idx.db[None]))


# ---------------------------------------------------------------------------
# exactness against the fp64 brute force
# ---------------------------------------------------------------------------

def adversarial(rng, n, d):
    """Tight duplicate-heavy clusters, exact duplicate rows and antipodal
    pairs: ties and near-ties wherever a seed, a cut or a merge could lose
    a candidate."""
    n_dup = n // 3
    base = clustered(rng, n - n_dup - n // 6, d, n_centers=4, noise=0.01)
    dup = base[rng.integers(0, len(base), n_dup)]
    dup[::2] += 1e-4 * rng.normal(size=dup[::2].shape).astype(np.float32)
    anti = -base[rng.integers(0, len(base), n // 6)]
    x = np.concatenate([base, dup, anti])
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def assert_exact(s, i, q, db, valid_rows, k):
    """Tie-aware result sets of the fp64 brute force over the valid rows:
    real, distinct rows in the first min(k, valid) slots (never a τ seed's
    -1), (-inf, -1) past them."""
    s, i = s.numpy(), i.numpy()
    kk = min(k, len(valid_rows))
    sref, iref = ref.brute_force_knn(q, db[valid_rows], kk)
    iref = valid_rows[iref]
    assert (i[:, :kk] >= 0).all(), "a seed slot (id -1) where a real row belongs"
    assert all(len(set(row)) == kk for row in i[:, :kk].tolist())
    assert (i[:, kk:] == -1).all() and np.isneginf(s[:, kk:]).all()
    np.testing.assert_allclose(s[:, :kk], sref, atol=3e-5)
    assert tie_aware_mismatches(s[:, :kk], i[:, :kk], sref, iref, 3e-5) == 0


@settings(max_examples=25, deadline=None, derandomize=True)
@given(st.integers(30, 700), st.integers(2, 24), st.integers(1, 40),
       st.integers(0, 1000), st.sampled_from(["scan", "tree"]))
def test_backends_match_fp64_brute_property(n, d, k, seed, backend):
    rng = np.random.default_rng(seed)
    kind = seed % 3
    db = (rng.normal(size=(n, d)).astype(np.float32) if kind == 0 else
          clustered(rng, n, d) if kind == 1 else adversarial(rng, n, d))
    q = np.concatenate([db[rng.integers(0, len(db), 3)],
                        rng.normal(size=(3, d)).astype(np.float32)])
    idx = build_index(db, n_pivots=min(4, n), block_size=16, device="cpu")
    eng = SearchEngine(idx, backend=backend, device="cpu", n_pivots=seed % 3)
    s, i, _ = eng.search(q, k)
    assert_exact(s, i, q, db, np.arange(len(db)), k)


@pytest.mark.parametrize("backend", ["scan", "tree"])
@pytest.mark.parametrize("case", ["duplicates", "antipodal", "k_past_valid", "holes"])
def test_backends_exact_on_adversarial_corpora(backend, case):
    rng = np.random.default_rng(7)
    d, k = 12, 10
    if case == "duplicates":
        db = np.repeat(clustered(rng, 60, d, n_centers=3, noise=0.02), 8, axis=0)
    elif case == "antipodal":
        half = clustered(rng, 300, d, n_centers=4, noise=0.05)
        db = np.concatenate([half, -half])
    else:
        db = adversarial(rng, 520, d)
    q = np.concatenate([db[::97], -db[5:7], rng.normal(size=(2, d)).astype(np.float32)])
    idx = build_index(db, n_pivots=8, block_size=16, device="cpu")
    valid_rows = np.arange(len(db))
    if case == "k_past_valid":
        idx = build_index(db[:40], n_pivots=8, block_size=16, device="cpu")
        db, valid_rows, k = db[:40], np.arange(40), 45
    elif case == "holes":
        keep = rng.uniform(size=idx.valid.shape[0]) > 0.4
        keep[:64] = False                                  # whole empty blocks
        idx = idx._replace(valid=idx.valid & torch.from_numpy(keep))
        row_ids = idx.row_ids.numpy()
        valid_rows = np.sort(row_ids[idx.valid.numpy()])
    for knobs in (dict(), dict(best_first=False, n_pivots=4), dict(warm_start=False)):
        eng = SearchEngine(idx, backend=backend, device="cpu", **knobs)
        s, i, _ = eng.search(q, k)
        assert_exact(s, i, q, db, valid_rows, k)


@settings(max_examples=30, deadline=None, derandomize=True)
@given(st.integers(20, 400), st.integers(2, 16), st.integers(0, 1000))
def test_node_bounds_dominate_descendants_fp64(n, d, seed):
    """The transitive bound's validity: every valid node's Eq. 13 bound
    (the descent's block_bounds over the node intervals) plus the margin is
    at least the fp64 similarity of every valid row below it, leaves
    included."""
    rng = np.random.default_rng(seed)
    db = clustered(rng, n, d) if seed % 2 else rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(3, d)).astype(np.float32)
    idx = build_index(db, n_pivots=min(4, n), block_size=32, device="cpu")
    tree = build_tree(idx)
    nb, bs, nl = idx.n_blocks, idx.block_size, tree.n_leaf_slots
    qn, qp = t_bk.prep_queries(idx, q)
    ub = block_bounds(qp, tree.node_lo, tree.node_hi).double().numpy()   # [m, 2nl]
    sims = qn.double().numpy() @ idx.db.double().numpy().T
    sims = np.where(idx.valid.numpy()[None, :], sims, -np.inf)
    best = np.full((sims.shape[0], 2 * nl), -np.inf)
    best[:, nl:nl + nb] = sims.reshape(-1, nb, bs).max(2)
    sz = nl // 2
    while sz >= 1:
        best[:, sz:2 * sz] = best[:, 2 * sz:4 * sz].reshape(-1, sz, 2).max(2)
        sz //= 2
    node_valid = tree.node_valid.numpy()
    short = node_valid[None, :] & (ub + MARGIN < best)
    short[:, 0] = False
    assert not short.any(), (
        f"n={n} d={d} seed={seed}: node {np.argwhere(short)[0][1]} (query "
        f"{np.argwhere(short)[0][0]}) bounds below a descendant's fp64 similarity "
        f"by {float((best[short] - ub[short] - MARGIN).max()):.3e}")


#: pivot similarities the near-+-1 test plants: 1e-3, 1e-5 and 0 from +-1
NEAR_PM1 = (1 - 1e-3, 1 - 1e-5, 1.0, -(1 - 1e-3), -(1 - 1e-5), -1.0)


def at_cosine(rng, p, c):
    """A unit vector at cosine ``c`` to the unit vector ``p`` (float64)."""
    v = rng.normal(size=p.shape)
    v -= (v @ p) * p
    v /= np.linalg.norm(v)
    return c * p + np.sqrt(max(0.0, 1 - c * c)) * v


def planted_near_pm1(rng, n, d):
    """A clustered corpus whose row 0 (the first maxmin pivot; its antipode,
    planted too, is the second) has rows planted at every cosine of
    NEAR_PM1 to it, three each."""
    base = clustered(rng, n, d).astype(np.float64)
    p = base[0]
    rows = [at_cosine(rng, p, c) for c in NEAR_PM1 for _ in range(3)]
    x = np.concatenate([base, np.array(rows)])
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def node_maxima_fp64(idx, tree, qn):
    """``[m, 2 nl]``: each node's largest float64 similarity of a valid row
    below it (-inf for empty nodes and node 0)."""
    nb, bs, nl = idx.n_blocks, idx.block_size, tree.n_leaf_slots
    sims = qn.double().numpy() @ idx.db.double().numpy().T
    sims = np.where(idx.valid.numpy()[None, :], sims, -np.inf)
    best = np.full((sims.shape[0], 2 * nl), -np.inf)
    best[:, nl:nl + nb] = sims.reshape(-1, nb, bs).max(2)
    sz = nl // 2
    while sz >= 1:
        best[:, sz:2 * sz] = best[:, 2 * sz:4 * sz].reshape(-1, sz, 2).max(2)
        sz //= 2
    return best


@settings(max_examples=12, deadline=None, derandomize=True)
@given(st.integers(40, 300), st.integers(2, 24), st.integers(1, 12),
       st.integers(0, 1000))
def test_bound_sound_and_backends_exact_near_pm1(n, d, k, seed):
    """Queries and rows planted at pivot similarities +-(1 - 1e-3),
    +-(1 - 1e-5) and +-1: every block's and tree node's bound plus the
    margin is at least the float64 similarity of every valid row below it,
    and kernel, scan and tree (both leaf stages) return the float64 brute
    force's result sets."""
    rng = np.random.default_rng(seed)
    db = planted_near_pm1(rng, n, d)
    idx = build_index(db, n_pivots=min(4, len(db)), block_size=16, device="cpu")
    piv = idx.pivots.double().numpy()
    piv /= np.linalg.norm(piv, axis=1, keepdims=True)
    q = np.array([at_cosine(rng, piv[j], c) for j in range(len(piv))
                  for c in NEAR_PM1]).astype(np.float32)
    qn, qp = t_bk.prep_queries(idx, q)
    planted = qp.numpy()[np.arange(len(q)), np.repeat(np.arange(len(piv)), len(NEAR_PM1))]
    np.testing.assert_allclose(planted, np.tile(NEAR_PM1, len(piv)), atol=1e-6)
    tree = build_tree(idx)
    ub = block_bounds(qp, tree.node_lo, tree.node_hi).double().numpy()
    short = tree.node_valid.numpy()[None, :] & (ub + MARGIN < node_maxima_fp64(idx, tree, qn))
    short[:, 0] = False
    assert not short.any(), f"a node bound + margin below a row's similarity at {np.argwhere(short)[0]}"
    leaf = block_bounds(qp, idx.dp_lo, idx.dp_hi).double().numpy()
    nl = tree.n_leaf_slots
    assert (leaf + MARGIN >= node_maxima_fp64(idx, tree, qn)[:, nl:nl + idx.n_blocks]).all()
    for backend, knobs in (("kernel", dict(bm=8)), ("scan", {}),
                           ("tree", dict(leaf_eval="scan")),
                           ("tree", dict(leaf_eval="kernel", bm=8))):
        eng = SearchEngine(idx, backend=backend, device="cpu", **knobs)
        s, i, _ = eng.search(q, k)
        assert_exact(s, i, q, db, np.arange(len(db)), k)


@pytest.mark.parametrize("backend", ["scan", "tree"])
def test_backends_exact_at_the_d2_bound_counterexample(backend):
    """The inputs on which test_node_bounds_dominate_descendants_fp64 finds
    the root's bound + margin below a row's similarity (n=124, d=2,
    seed=1; ROADMAP.md Queue 3): query 2 lies nearly antipodal to pivot 0
    (qp = -0.998), where fp32 rounding of the pivot similarities moves the
    Eq. 13 bound by more than the margin.  The brute force's nearest row
    (60) must come back at k = 1 on the engine's defaults."""
    rng = np.random.default_rng(1)
    db = clustered(rng, 124, 2)
    q = rng.normal(size=(3, 2)).astype(np.float32)
    idx = build_index(db, n_pivots=4, block_size=32, device="cpu")
    s, i, _ = SearchEngine(idx, backend=backend, device="cpu").search(q, 1)
    assert_exact(s, i, q, db, np.arange(len(db)), 1)
