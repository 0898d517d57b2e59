"""repro_torch.kernels.leaf_gather against repro.kernels.leaf_gather, on the
CPU.

Both packages search the identical index (the reference's, carried over
with ``index_from_reference``) with the reference's normalized queries and
pivot similarities; the reference runs its Pallas kernel in interpret mode,
the port ``pruned_topk``'s plain version.  ``keep`` takes all blocks, some,
one, and (for the port's guard) none; the index also runs with tombstoned
rows and at k = block_size.  Sims within 1e-6, positions equal away from
near-ties, empty slots ``(-inf, -1)``, and ``computed``/``elem`` equal:
the kernel's bound moved by at most REF_SLACK against the reference's
here, and no decision of these inputs lies that close to τ.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import leaf_gather as j_lg  # noqa: E402
from repro.search import tree as j_tree  # noqa: E402
from repro_torch.kernels import leaf_gather as t_lg  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.search import backends as t_bk  # noqa: E402
from tests.test_torch_cuda import MARGIN  # noqa: E402
from tests.test_torch_scan import (assert_same_topk, both_indexes,  # noqa: E402
                                   both_queries, make_corpus)
from tests.test_torch_tree import with_holes  # noqa: E402

BS = 32          # the index block, and so the kernel's tile
BM = 8           # three query tiles of the 24 queries


@pytest.fixture(scope="module", params=["full", "holes"])
def corpus(request):
    db, q = make_corpus("clustered", seed=3, n=2048)
    j_idx, t_idx = (both_indexes(db, BS) if request.param == "full"
                    else with_holes(db, BS, seed=3))
    (jqn, jqp), (tqn, tqp) = both_queries(j_idx, q)
    tau0 = np.asarray(j_tree.tree_warm_start(j_tree.build_tree(j_idx), jqn, jqp, 10, 1))
    return j_idx, t_idx, (jqn, jqp), (tqn, tqp), tau0


def keep_of(case: str, nb: int) -> np.ndarray:
    rng = np.random.default_rng(nb)
    if case == "all":
        return np.arange(nb, dtype=np.int32)
    if case == "some":
        return np.sort(rng.choice(nb, nb // 3, replace=False)).astype(np.int32)
    return np.array([nb // 2], np.int32)                  # one block


def run_both(j_idx, t_idx, jq, tq, keep, tau0, *, k, elem=False, best_first=True):
    jqn, jqp = jq
    tqn, tqp = tq
    want = j_lg.gathered_topk(
        j_idx, jnp.asarray(keep), jqn, jqp,
        None if tau0 is None else jnp.asarray(tau0), n_keep=len(keep), k=k,
        bm=BM, margin=MARGIN, interpret=True, element_stats=elem,
        best_first=best_first)
    got = t_lg.gathered_topk(
        t_idx, torch.from_numpy(keep), tqn, tqp,
        None if tau0 is None else torch.from_numpy(tau0), k=k, bm=BM,
        margin=MARGIN, element_stats=elem, best_first=best_first)
    return [None if x is None else np.asarray(x) for x in want], got


def assert_same(want, got):
    s_j, p_j, c_j, e_j = want
    s_t, p_t, c_t, e_t = got
    assert p_t.dtype == torch.int32 and tuple(c_t.shape) == c_j.shape
    assert_same_topk(s_j, p_j, s_t, p_t)
    assert (p_t.numpy()[np.isneginf(s_t.numpy())] == -1).all()
    np.testing.assert_array_equal(c_t.numpy(), c_j)
    assert (e_t is None) == (e_j is None)
    if e_t is not None:
        np.testing.assert_array_equal(e_t.numpy(), e_j)


@pytest.mark.parametrize("case", ["all", "some", "one"])
@pytest.mark.parametrize("k", [1, 10, BS], ids=["k1", "k10", "k_block"])
def test_gathered_topk_matches_reference(corpus, case, k):
    j_idx, t_idx, jq, tq, tau0 = corpus
    keep = keep_of(case, t_idx.n_blocks)
    want, got = run_both(j_idx, t_idx, jq, tq, keep, tau0 if k <= 10 else None, k=k)
    assert_same(want, got)
    # every position lies in a kept block, or is -1
    pos = got[1].numpy()
    assert np.isin(pos[pos >= 0] // BS, keep).all()
    if case == "one" and k == BS:
        # one block of 32 rows, some tombstoned: empty slots at the end
        assert np.isneginf(got[0].numpy()).any() == (not bool(
            t_idx.valid.view(-1, BS)[keep[0]].all()))


@pytest.mark.parametrize("knobs", [dict(elem=True), dict(best_first=False),
                                   dict(elem=True, best_first=False)],
                         ids=["elem", "natural_order", "elem_natural_order"])
def test_gathered_topk_options_match_reference(corpus, knobs):
    j_idx, t_idx, jq, tq, tau0 = corpus
    keep = keep_of("some", t_idx.n_blocks)
    want, got = run_both(j_idx, t_idx, jq, tq, keep, tau0, k=10, **knobs)
    assert_same(want, got)


def test_gathered_topk_row_out_returns_the_callers_order(corpus):
    """Sorted queries with row_out = perm come back in the caller's order,
    equal to the unsorted call on the same rows."""
    _, t_idx, _, (tqn, tqp), tau0 = corpus
    keep = torch.from_numpy(keep_of("some", t_idx.n_blocks))
    tau = torch.from_numpy(tau0)
    perm = t_bk.query_sort_perm(tqp).int()
    assert bool((perm != torch.arange(len(perm))).any())
    got = t_lg.gathered_topk(t_idx, keep, tqn[perm], tqp[perm], tau[perm], k=10,
                             bm=BM, margin=MARGIN, row_out=perm)
    plain = t_lg.gathered_topk(t_idx, keep, tqn, tqp, tau, k=10, bm=BM, margin=MARGIN)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


def test_gathered_topk_refuses_what_the_kernel_cannot_take(corpus):
    _, t_idx, _, (tqn, tqp), _ = corpus
    with pytest.raises(ValueError, match="no block"):
        t_lg.gathered_topk(t_idx, torch.zeros(0, dtype=torch.int32), tqn, tqp,
                           None, k=5)
    with pytest.raises(ValueError, match="block_size"):
        t_lg.gathered_topk(t_idx, torch.arange(3, dtype=torch.int32), tqn, tqp,
                           None, k=BS + 1)


def test_gathered_topk_reads_the_sound_intervals(corpus):
    """The kept tiles' bounds come from dp_lo/dp_hi, the intervals that hold
    every row's float64 cosine: with the float32 dp_min/dp_max replaced by
    a point far from every row, the results are the same."""
    _, t_idx, _, (tqn, tqp), tau0 = corpus
    keep = torch.from_numpy(keep_of("some", t_idx.n_blocks))
    tau = torch.from_numpy(tau0)
    want = t_lg.gathered_topk(t_idx, keep, tqn, tqp, tau, k=10, bm=BM, margin=MARGIN)
    far = torch.full_like(t_idx.dp_min, -1.0)
    moved = t_idx._replace(dp_min=far, dp_max=far)
    got = t_lg.gathered_topk(moved, keep, tqn, tqp, tau, k=10, bm=BM, margin=MARGIN)
    assert all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
    assert bool(want[2].any())                   # some tile computed
    a_lo, a_hi = kref.query_interval(tqp)
    assert bool((a_lo <= tqp).all() and (tqp <= a_hi).all())
