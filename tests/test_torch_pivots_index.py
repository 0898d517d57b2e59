"""repro_torch core (bounds, pivots, fp64 oracle, index build) against the
JAX reference on identical numpy inputs, on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import bounds as jb  # noqa: E402
from repro.core import index as jidx  # noqa: E402
from repro.core import pivots as jpiv  # noqa: E402
from repro.core import ref as jref  # noqa: E402
from repro_torch.core import bounds as tb  # noqa: E402
from repro_torch.core import index as tidx  # noqa: E402
from repro_torch.core import pivots as tpiv  # noqa: E402
from repro_torch.core import ref as tref  # noqa: E402
from tests.conftest import clustered  # noqa: E402


def corpus(kind: str, n: int, d: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "clustered":
        return clustered(rng, n, d)
    return rng.normal(size=(n, d)).astype(np.float32)


def fields(idx) -> dict:
    return {f: None if getattr(idx, f) is None else np.asarray(getattr(idx, f))
            for f in idx._fields}


def assert_same_build(j: dict, t: dict, atol: float = 1e-6) -> None:
    """Build parity.  ``valid`` is identical; ``row_ids`` is identical except
    where the two fp32 matmuls order a near-tie of the reorder key
    differently: each such position must hold a row of the same nearest-pivot
    group whose key lies within ``atol`` of the reference's key there.  The
    per-row fields are compared row by row (aligned by original id)."""
    np.testing.assert_array_equal(j["valid"], t["valid"])
    np.testing.assert_allclose(j["pivots"], t["pivots"], atol=atol)
    np.testing.assert_allclose(j["ortho"], t["ortho"], atol=atol)
    for f in ("dp_min", "dp_max"):
        np.testing.assert_allclose(j[f], t[f], atol=atol, err_msg=f)
    jr, tr = j["row_ids"], t["row_ids"]
    diff = np.nonzero(jr != tr)[0]
    assert len(diff) <= max(4, len(jr) // 200), f"{len(diff)} rows moved"
    key = np.full(int(jr.max()) + 1, np.nan)
    key[jr[jr >= 0]] = j["dp"][jr >= 0].max(1)
    grp = np.full(int(jr.max()) + 1, -1)
    grp[jr[jr >= 0]] = j["dp"][jr >= 0].argmax(1)
    for pos in diff:
        assert grp[jr[pos]] == grp[tr[pos]], (pos, jr[pos], tr[pos])
        assert abs(key[jr[pos]] - key[tr[pos]]) <= atol, (pos, jr[pos], tr[pos])
    jo, to = np.argsort(jr), np.argsort(tr)
    for f in ("db", "dp", "beta", "beta_nsq"):
        np.testing.assert_allclose(j[f][jo], t[f][to], atol=atol, err_msg=f)


# ---------------------------------------------------------------------------
# bounds and the fp64 oracle
# ---------------------------------------------------------------------------

BOUND_FNS = ("lb_euclid", "lb_euclid_fast", "lb_arccos", "lb_mult",
             "lb_mult_fast1", "lb_mult_fast2", "ub_mult", "ub_euclid",
             "ub_arccos")


@pytest.mark.parametrize("name", BOUND_FNS)
def test_elementwise_bounds_match_reference(name):
    rng = np.random.default_rng(1)
    a = np.concatenate([rng.uniform(-1, 1, 500), [-1.0, 1.0, 0.0, 1.0]])
    b = np.concatenate([rng.uniform(-1, 1, 500), [1.0, -1.0, 0.0, 1.0]])
    a, b = a.astype(np.float32), b.astype(np.float32)
    want = np.asarray(getattr(jb, name)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tb, name)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)


def test_pivot_set_and_joint_bounds_match_reference():
    rng = np.random.default_rng(2)
    qp = rng.uniform(-1, 1, (16, 8)).astype(np.float32)
    dp = rng.uniform(-1, 1, (16, 8)).astype(np.float32)
    for name in ("pivot_lower_bound", "pivot_upper_bound"):
        want = np.asarray(getattr(jb, name)(jnp.asarray(qp), jnp.asarray(dp)))
        got = getattr(tb, name)(torch.from_numpy(qp), torch.from_numpy(dp)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)
    alpha = (0.3 * rng.normal(size=(5, 4))).astype(np.float32)
    beta = (0.3 * rng.normal(size=(9, 4))).astype(np.float32)
    bnsq = np.sum(beta * beta, 1).astype(np.float32)
    want = np.asarray(jb.joint_row_upper_bound(
        jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(bnsq)))
    got = tb.joint_row_upper_bound(torch.from_numpy(alpha), torch.from_numpy(beta),
                                   torch.from_numpy(bnsq)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert tb.JOINT_SLACK == jb.JOINT_SLACK
    assert sorted(tb.BOUND_PROVIDERS) == sorted(jb.BOUND_PROVIDERS)
    assert sorted(tb.LOWER_BOUNDS) == sorted(jb.LOWER_BOUNDS)


def test_fp64_oracle_copy_matches_reference():
    rng = np.random.default_rng(3)
    q, db = rng.normal(size=(7, 12)), rng.normal(size=(60, 12))
    s_t, i_t = tref.brute_force_knn(q, db, 9)
    s_j, i_j = jref.brute_force_knn(q, db, 9)
    np.testing.assert_array_equal(s_t, s_j)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(tref.normalize(q), jref.normalize(q))
    a, b = rng.uniform(-1, 1, 50), rng.uniform(-1, 1, 50)
    for name, fn in tref.LOWER_BOUNDS.items():
        np.testing.assert_array_equal(fn(a, b), jref.LOWER_BOUNDS[name](a, b))


# ---------------------------------------------------------------------------
# pivots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["clustered", "uniform"])
@pytest.mark.parametrize("n,d,p", [(500, 16, 8), (2000, 32, 16), (1200, 48, 24)])
def test_maxmin_pivots_identical(kind, n, d, p):
    db = corpus(kind, n, d, seed=n)
    want = np.asarray(jpiv.select_pivots_maxmin(jnp.asarray(db), p))
    got = tpiv.select_pivots_maxmin(torch.from_numpy(db), p).numpy()
    np.testing.assert_array_equal(got, want)


def test_maxmin_ties_pick_first_index():
    """Duplicate rows tie exactly; both packages take the first index."""
    rng = np.random.default_rng(4)
    base = rng.normal(size=(6, 8)).astype(np.float32)
    db = np.concatenate([base, base, base])           # every row thrice
    want = np.asarray(jpiv.select_pivots_maxmin(jnp.asarray(db), 6))
    got = tpiv.select_pivots_maxmin(torch.from_numpy(db), 6).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got < 6).all()


def test_random_pivots_and_basis_identical():
    for n, p, seed in [(100, 8, 0), (5, 9, 3), (1000, 16, 7)]:
        np.testing.assert_array_equal(
            tpiv.select_pivots_random(n, p, seed).numpy(),
            np.asarray(jpiv.select_pivots_random(n, p, seed)))
    rng = np.random.default_rng(5)
    z = tref.normalize(rng.normal(size=(6, 10)))
    z[3] = z[1]                                       # dependent pivots
    np.testing.assert_array_equal(tpiv.orthonormal_pivot_basis(z),
                                  jpiv.orthonormal_pivot_basis(z))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 100, 4096])
def test_suggest_bound_pivots_identical(n):
    """The joint bound's table depth, 7d/8 clamped to n - 1 and to at
    least 1, for every d of a grid that crosses both clamps."""
    for d in (1, 2, 7, 8, 9, 64, 100, 2048):
        assert tpiv.suggest_bound_pivots(n, d) == jpiv.suggest_bound_pivots(n, d), (n, d)


# ---------------------------------------------------------------------------
# index build and the bounds over it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["clustered", "uniform"])
@pytest.mark.parametrize("n,d,p,bs", [(4096, 32, 16, 128), (1000, 16, 8, 64),
                                      (2000, 48, 12, 128)])
def test_build_parity(kind, n, d, p, bs):
    db = corpus(kind, n, d, seed=d)
    j = fields(jidx.build_index(jnp.asarray(db), n_pivots=p, block_size=bs))
    t = fields(tidx.build_index(db, n_pivots=p, block_size=bs, device="cpu"))
    assert_same_build(j, t)


def test_build_random_pivots_parity():
    db = corpus("clustered", 700, 24, seed=9)
    j = fields(jidx.build_index(jnp.asarray(db), n_pivots=8, block_size=128,
                                pivot_method="random", seed=4))
    t = fields(tidx.build_index(db, n_pivots=8, block_size=128,
                                pivot_method="random", seed=4, device="cpu"))
    assert_same_build(j, t)


def test_reorder_perm_identical_on_identical_keys():
    """Given the same dp, the two stable sorts reproduce jnp.lexsort exactly,
    ties included."""
    rng = np.random.default_rng(6)
    dp = np.round(rng.uniform(-1, 1, (300, 5)), 1).astype(np.float32)  # ties
    valid = np.arange(300) < 280
    want = np.asarray(jidx.reorder_perm(jnp.asarray(dp), jnp.asarray(valid), 5))
    got = tidx.reorder_perm(torch.from_numpy(dp), torch.from_numpy(valid), 5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def shared_index():
    db = corpus("clustered", 1500, 32, seed=11)
    j = jidx.build_index(jnp.asarray(db), n_pivots=8, block_size=128)
    return db, j, tidx.index_from_reference(fields(j), "cpu")


def test_index_from_reference_round_trip(shared_index):
    _, j, t = shared_index
    for f, a in fields(j).items():
        np.testing.assert_array_equal(getattr(t, f).numpy(), a, err_msg=f)
    assert (t.n_blocks, t.block_size, t.n_pivots, t.bound_table_width) == (
        j.n_blocks, j.block_size, j.n_pivots, j.bound_table_width)
    assert t.row_ids.dtype == torch.int32 and t.valid.dtype == torch.bool


def test_interval_and_block_bounds_match_reference(shared_index):
    _, j, t = shared_index
    rng = np.random.default_rng(12)
    qp = rng.uniform(-1, 1, (20, 8)).astype(np.float32)
    lo = np.asarray(j.dp_min).copy()
    hi = np.asarray(j.dp_max).copy()
    lo[3], hi[3] = np.inf, -np.inf                    # empty-block sentinel
    want = np.asarray(jidx.interval_upper_bound(
        jnp.asarray(qp)[:, None, :], jnp.asarray(lo)[None], jnp.asarray(hi)[None]))
    got = tidx.interval_upper_bound(
        torch.from_numpy(qp)[:, None, :], torch.from_numpy(lo)[None],
        torch.from_numpy(hi)[None]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    for b in (0, 3):
        np.testing.assert_allclose(
            tidx.block_upper_bound(torch.from_numpy(qp), torch.from_numpy(lo[b]),
                                   torch.from_numpy(hi[b])).numpy(),
            np.asarray(jidx.block_upper_bound(jnp.asarray(qp), jnp.asarray(lo[b]),
                                              jnp.asarray(hi[b]))), atol=1e-6)


@pytest.mark.parametrize("depth", [1, 4, 8])
def test_multipivot_block_cap_matches_reference(shared_index, depth):
    db, j, t = shared_index
    q = tref.normalize(db[:12] + 0.05).astype(np.float32)
    want = np.asarray(jidx.multipivot_block_cap(j, jnp.asarray(q), n_pivots=depth))
    got = tidx.multipivot_block_cap(t, torch.from_numpy(q), n_pivots=depth).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_search_brute_matches_reference(shared_index):
    db, j, t = shared_index
    q = db[::150] + 0.01
    s_j, i_j = jidx.search_brute(j, jnp.asarray(q), 7)
    s_t, i_t = tidx.search_brute(t, q, 7)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6)
    np.testing.assert_array_equal(np.sort(i_t.numpy(), 1), np.sort(np.asarray(i_j), 1))


def test_removed_search_raises_type_error(shared_index):
    """``core.index.search``, the pre-engine entry point, raises TypeError
    as the reference's does, whatever it is given, and names the engine."""
    db, j, t = shared_index
    with pytest.raises(TypeError, match="repro.search.SearchEngine"):
        jidx.search(j, db[:4], 5)
    with pytest.raises(TypeError, match=r"repro_torch\.search\.SearchEngine"):
        tidx.search(t, db[:4], 5)
    with pytest.raises(TypeError, match="docs/search-api.md"):
        tidx.search()
