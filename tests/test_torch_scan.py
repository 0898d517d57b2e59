"""repro_torch's scan backend against repro.search's, on the CPU.

Both packages search the identical index (the reference's, carried over
with ``index_from_reference``) with the same normalized queries and pivot
similarities, so the Eq. 13 bound matrices are equal bit for bit and only
the fp32 score matmuls (XLA's and torch's) may differ by an ulp.  The
contract held here:

* sims within 1e-6, and positions equal wherever a score is finite and
  apart from its neighbours by more than 1e-6 (near-ties may swap);
* ``blk_pruned`` and ``elem_pruned`` equal.  A difference is accepted only
  for decisions whose gap (bound + margin - τ at the visit) lies within
  2·margin of τ, the rule ``chip_smoke.py`` applies to ``pruned_topk``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.index import build_index as j_build_index  # noqa: E402
from repro.search import SearchEngine as JEngine  # noqa: E402
from repro.search import backends as j_bk  # noqa: E402
from repro.search import tree as j_tree  # noqa: E402
from repro_torch.core import ref  # noqa: E402
from repro_torch.core.index import index_from_reference  # noqa: E402
from repro_torch.search import SearchEngine  # noqa: E402
from repro_torch.search import backends as t_bk  # noqa: E402
from tests.conftest import clustered  # noqa: E402
from tests.test_torch_cuda import MARGIN, assert_same_counts, scan_gaps  # noqa: E402
from tests.test_torch_pivots_index import fields  # noqa: E402

N, D, M = 2048, 32, 24


def make_corpus(kind: str, seed: int = 0, n: int = N, d: int = D, m: int = M):
    """Datastore and queries near datastore rows (where τ rises and blocks
    prune), as tests/test_torch_engine.py makes them."""
    rng = np.random.default_rng(seed)
    if kind == "clustered":
        db = clustered(rng, n, d, n_centers=8, noise=0.05)
    else:
        db = rng.normal(size=(n, d)).astype(np.float32)
    q = db[rng.choice(n, m, replace=False)] + 0.03 * rng.normal(size=(m, d))
    return db, ref.normalize(q).astype(np.float32)


def both_indexes(db, block_size, n_pivots=16):
    """The reference's index, and the port's copy of it on the CPU."""
    j_idx = j_build_index(jnp.asarray(db), n_pivots=n_pivots, block_size=block_size)
    return j_idx, index_from_reference(fields(j_idx), "cpu")


def both_queries(j_idx, q):
    """The reference's normalized queries and pivot similarities, as
    jax arrays and as torch tensors (the same numbers)."""
    qn, qp = j_bk.prep_queries(j_idx, jnp.asarray(q))
    return (qn, qp), (torch.from_numpy(np.asarray(qn)), torch.from_numpy(np.asarray(qp)))


def assert_same_topk(s_j, p_j, s_t, p_t):
    """Sims within 1e-6 (and -inf at the same slots); positions equal
    wherever a score is finite and more than 1e-6 from its neighbours."""
    s_j, p_j = np.asarray(s_j), np.asarray(p_j)
    s_t, p_t = s_t.numpy(), p_t.numpy()
    assert s_t.shape == s_j.shape
    np.testing.assert_array_equal(np.isneginf(s_t), np.isneginf(s_j))
    fin = np.isfinite(s_j)
    np.testing.assert_allclose(s_t[fin], s_j[fin], atol=1e-6)
    lone = fin.copy()
    step = np.abs(np.diff(np.where(fin, s_j, 0.0), axis=1)) <= 1e-6
    lone[:, 1:] &= ~step
    lone[:, :-1] &= ~step
    np.testing.assert_array_equal(p_t[lone], p_j[lone])
    np.testing.assert_array_equal(p_t[~fin], p_j[~fin])


# (k, block size, scan knobs): k = 70 exceeds the 64-row block, so the
# warm start scores two blocks per query
CASES = {
    "k1": (1, 64, dict()),
    "k10": (10, 64, dict()),
    "k70_past_block": (70, 64, dict()),
    "k10_no_prune": (10, 64, dict(prune=False)),
    "k10_natural_order": (10, 64, dict(best_first=False)),
    "k10_cold": (10, 64, dict(warm_start=False, best_first=False)),
    "k10_wide_prescan": (10, 32, dict(warm_start_blocks=3)),
    "k10_joint_cap": (10, 64, dict(n_pivots=8)),
    "k10_joint_cap_natural": (10, 64, dict(n_pivots=8, best_first=False)),
    "k10_no_prune_joint_cap": (10, 64, dict(prune=False, n_pivots=8)),
    "k1_block16": (1, 16, dict()),
}
DEFAULTS = dict(prune=True, warm_start=True, best_first=True, element_stats=True)


@pytest.fixture(scope="module", params=["clustered", "uniform"])
def corpus(request):
    db, q = make_corpus(request.param)
    cache = {}

    def indexes(block_size):
        if block_size not in cache:
            cache[block_size] = both_indexes(db, block_size)
        return cache[block_size]

    return request.param, db, q, indexes


@pytest.mark.parametrize("case", list(CASES))
def test_scan_search_matches_reference(corpus, case):
    kind, db, q, indexes = corpus
    k, bs, knobs = CASES[case]
    kw = dict(DEFAULTS, **knobs)
    j_idx, t_idx = indexes(bs)
    (jqn, jqp), (tqn, tqp) = both_queries(j_idx, q)
    s_j, p_j, blk_j, elem_j = j_bk.scan_search(j_idx, jqn, jqp, k, **kw)
    s_t, p_t, blk_t, elem_t = t_bk.scan_search(t_idx, tqn, tqp, k, **kw)
    assert blk_t.dtype == torch.int64 and elem_t.dtype == torch.int64
    assert_same_topk(s_j, p_j, s_t, p_t)
    replay_kw = {key: kw[key] for key in ("prune", "warm_start", "best_first")}
    replay_kw.update({key: knobs[key] for key in ("warm_start_blocks", "n_pivots")
                      if key in knobs})
    assert_same_counts((int(blk_t), int(elem_t)), (int(blk_j), int(elem_j)),
                       lambda: scan_gaps(t_idx, tqn, tqp, k, **replay_kw))
    sref, iref = ref.brute_force_knn(q, db, k)
    ids = t_idx.row_ids[p_t.long()].numpy()
    np.testing.assert_allclose(s_t.numpy(), sref, atol=3e-5)
    np.testing.assert_array_equal(np.sort(ids, 1), np.sort(iref, 1))
    if kw["prune"] and kind == "clustered" and k == 10:
        assert int(blk_t) > 0                              # the bound engages


def test_scan_replay_reproduces_the_counts(corpus):
    """The replay that explains a count difference makes the port's own
    decisions: its counts equal scan_search's."""
    _, _, q, indexes = corpus
    j_idx, t_idx = indexes(64)
    _, (tqn, tqp) = both_queries(j_idx, q)
    for kw in (dict(warm_start=True, best_first=True, n_pivots=8),
               dict(warm_start=False, best_first=False)):
        _, _, blk, elem = t_bk.scan_search(t_idx, tqn, tqp, 10, element_stats=True, **kw)
        got = scan_gaps(t_idx, tqn, tqp, 10, **kw)
        assert got[:2] == (int(blk), int(elem))


@pytest.mark.parametrize("k", [1, 10, 70])
def test_scan_search_hooks_match_reference(corpus, k):
    """The tree's hooks: the reference's own seed, leaf bound matrix and
    surviving-leaf mask go into both scans."""
    _, db, q, indexes = corpus
    j_idx, t_idx = indexes(64)
    (jqn, jqp), (tqn, tqp) = both_queries(j_idx, q)
    tree = j_tree.build_tree(j_idx)
    tau0, alive, leaf_ub, _ = j_tree._seed_and_descend(
        tree, jqn, jqp, k, warm_start=True, warm_start_blocks=None, margin=MARGIN)
    hooks_j = dict(tau0=tau0, ub_all=leaf_ub, leaf_mask=alive)
    hooks_t = {name: torch.from_numpy(np.asarray(v)) for name, v in hooks_j.items()}
    for best_first in (True, False):
        kw = dict(prune=True, warm_start=False, best_first=best_first,
                  element_stats=True)
        s_j, p_j, blk_j, elem_j = j_bk.scan_search(j_idx, jqn, jqp, k, **kw, **hooks_j)
        s_t, p_t, blk_t, elem_t = t_bk.scan_search(t_idx, tqn, tqp, k, **kw, **hooks_t)
        assert_same_topk(s_j, p_j, s_t, p_t)
        assert_same_counts(
            (int(blk_t), int(elem_t)), (int(blk_j), int(elem_j)),
            lambda: scan_gaps(t_idx, tqn, tqp, k, best_first=best_first, **hooks_t))
        assert int(blk_t) >= int((~hooks_t["leaf_mask"]).sum())
        sref, _ = ref.brute_force_knn(q, db, k)
        np.testing.assert_allclose(s_t.numpy(), sref, atol=3e-5)


@pytest.mark.parametrize("knobs", [dict(), dict(n_pivots=8), dict(best_first=False),
                                   dict(warm_start=False)],
                         ids=["default", "joint_cap", "natural_order", "cold"])
@pytest.mark.parametrize("k", [1, 10, 70])
def test_scan_engine_matches_reference(corpus, k, knobs):
    """The scan engines of both packages, each preparing its own queries,
    with every knob passed explicitly (on jax CPU the reference's tuned
    table would resolve best_first=False, the port's fallback True)."""
    _, db, q, indexes = corpus
    j_idx, t_idx = indexes(64)
    kw = dict(dict(best_first=True, n_pivots=0, warm_start=True), **knobs)
    j_eng = JEngine(j_idx, backend="scan", **kw)
    t_eng = SearchEngine(t_idx, backend="scan", device="cpu", **kw)
    assert (t_eng.best_first, t_eng.n_pivots, t_eng.warm_start_blocks) == (
        j_eng.best_first, j_eng.n_pivots, j_eng.warm_start_blocks)
    s_j, i_j, st_j = j_eng.search(jnp.asarray(q), k, element_stats=True)
    s_t, i_t, st_t = t_eng.search(q, k, element_stats=True)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6)
    np.testing.assert_array_equal(np.sort(i_t.numpy(), 1), np.sort(np.asarray(i_j), 1))
    m, nb = q.shape[0], t_idx.n_blocks
    got = (round(float(st_t.block_prune_frac) * m * nb),
           round(float(st_t.elem_prune_frac) * m * t_eng.n_valid))
    want = (round(float(st_j.block_prune_frac) * m * nb),
            round(float(st_j.elem_prune_frac) * m * t_eng.n_valid))
    tqn, tqp = t_bk.prep_queries(t_idx, q)
    assert_same_counts(got, want, lambda: scan_gaps(
        t_idx, tqn, tqp, k, warm_start=kw["warm_start"], best_first=kw["best_first"],
        n_pivots=kw["n_pivots"]))
    assert st_t.backend == "scan" and st_t.n_pivots == st_j.n_pivots == kw["n_pivots"]
    assert st_t.tree_prune_frac is None and st_t.tile_computed_frac is None
    sref, iref = ref.brute_force_knn(q, db, k)
    np.testing.assert_array_equal(np.sort(i_t.numpy(), 1), np.sort(iref, 1))
