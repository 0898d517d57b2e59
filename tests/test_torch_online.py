"""repro_torch's online mutation (core/online.py, SearchEngine.online,
search/tree.py:widen_tree) against repro's, on the CPU.

A reference engine and the port's engine over the identical index
(``index_from_reference``) take the same interleavings of insert, delete
and reoptimize.  After every operation:

* the returned ids, ``row_ids``, ``valid``, ``db``, ``generation`` and
  ``decay_estimate`` are equal (``db`` within 1e-6 and ``row_ids`` up to
  near-tie swaps once a rebuild ran, ``assert_same_build``'s rule);
* ``dp``, ``dp_min`` and ``dp_max`` agree within 2 ulp of 1 (XLA's and
  torch's float32 products);
* ``dp_lo <= float64 cosine <= dp_hi`` for every valid row (the port's
  sound intervals, which the reference does not have);
* result sets equal the fp64 brute force over the live rows (ATOL 3e-5,
  the reference's rule) and the reference's.

Then the port alone: the widened tree equals a rebuilt one bit for bit,
node bounds dominate their rows in float64 after mutations, rows inserted
at pivot similarities near +-1 keep every bound sound and every backend
exact, and a kernel tile that mixes empty-sentinel and filled blocks.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.search import SearchEngine as JEngine  # noqa: E402
from repro_torch.core.index import index_from_reference  # noqa: E402
from repro_torch.kernels.bound_prune import block_bounds  # noqa: E402
from repro_torch.search import SearchEngine, build_tree  # noqa: E402
from repro_torch.search import backends as t_bk  # noqa: E402
from tests.conftest import clustered  # noqa: E402
from tests.test_torch_cuda import MARGIN  # noqa: E402
from tests.test_torch_pivots_index import assert_same_build, fields  # noqa: E402
from tests.test_torch_tree import NEAR_PM1, at_cosine, node_maxima_fp64  # noqa: E402

#: name -> (engine backend, engine knobs) on both packages
BACKENDS = {"scan": ("scan", {}), "brute": ("brute", {}),
            "tree_scan": ("tree", dict(leaf_eval="scan")),
            "tree_kernel": ("tree", dict(leaf_eval="kernel")),
            "kernel": ("kernel", {})}
#: the reference's test_online tolerance on similarities
ATOL = 3e-5
#: XLA's and torch's float32 pivot products: 2 ulp of 1
DP_ATOL = 2 * float(np.finfo(np.float32).eps)


def norm64(x):
    x = np.asarray(x, np.float64)
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.where(n == 0, 1.0, n)


def check_live_exact(sims, ids, live, q, k):
    """The reference's ``_check_live_exact``: sims equal the sorted fp64
    brute force over exactly the live rows, every returned id is live with
    its true similarity, past-the-corpus slots hold -1."""
    sims, ids = np.asarray(sims, np.float64), np.asarray(ids)
    live_ids = np.array(sorted(live))
    s = norm64(q) @ norm64(np.stack([live[i] for i in live_ids])).T
    kk = min(k, len(live_ids))
    np.testing.assert_allclose(sims[:, :kk], -np.sort(-s, axis=1)[:, :kk], atol=ATOL)
    assert (ids[:, kk:] == -1).all(), "past-the-corpus slots must pad -1"
    pos_of = {int(i): p for p, i in enumerate(live_ids)}
    for r in range(q.shape[0]):
        for c in range(kk):
            i = int(ids[r, c])
            assert i in pos_of, f"returned id {i} is not live"
            assert abs(s[r, pos_of[i]] - sims[r, c]) < ATOL, (i, s[r, pos_of[i]], sims[r, c])


def assert_sound(idx):
    """Every valid row's float64 pivot cosine and its float32 ``dp`` lie in
    its block's ``[dp_lo, dp_hi]``, which contains ``[dp_min, dp_max]``."""
    bs = idx.block_size
    v = idx.valid.numpy()
    # a true cosine lies in [-1, 1]; float64 rounding can step past it
    cos = np.clip(norm64(idx.db.numpy()) @ norm64(idx.pivots.numpy()).T, -1, 1)
    lo = np.repeat(idx.dp_lo.double().numpy(), bs, 0)[v]
    hi = np.repeat(idx.dp_hi.double().numpy(), bs, 0)[v]
    for what in (cos[v], idx.dp.double().numpy()[v]):
        assert (lo <= what).all() and (what <= hi).all(), "a row outside its sound interval"
    filled = ~(idx.dp_min > idx.dp_max)
    assert (idx.dp_lo[filled] <= idx.dp_min[filled]).all()
    assert (idx.dp_hi[filled] >= idx.dp_max[filled]).all()


class Pair:
    """A reference engine and the port's engine over the identical index,
    mutated in lockstep and compared after every operation."""

    def __init__(self, rows, backend, *, block_size=32, n_pivots=4, **online_kw):
        name, knobs = BACKENDS[backend]
        self.j = JEngine.build(rows, backend=name, block_size=block_size,
                               n_pivots=n_pivots, **knobs)
        self.t = SearchEngine(index_from_reference(fields(self.j.index), device="cpu"),
                              backend=name, device="cpu", **knobs)
        self.hj, self.ht = self.j.online(**online_kw), self.t.online(**online_kw)
        self.live = {i: rows[i] for i in range(len(rows))}
        self.rebuilt = False        # a reoptimize ran: db within 1e-6
        self.aligned = True         # row_ids equal position by position

    def insert(self, new):
        ids = self.hj.insert(new)
        assert self.ht.insert(new) == ids
        self.live.update(zip(ids, new))
        self.check()
        return ids

    def delete(self, ids):
        self.hj.delete(ids)
        self.ht.delete(ids)
        for i in ids:
            del self.live[int(i)]
        self.check()

    def reoptimize(self):
        self.hj.reoptimize()
        self.ht.reoptimize()
        self.check(rebuild=True)

    def check(self, rebuild=False):
        hj, ht = self.hj, self.ht
        assert (hj.generation, hj.decay_estimate, hj.n_live) == (
            ht.generation, ht.decay_estimate, ht.n_live)
        assert (self.j.index_epoch, self.j.n_slots, self.j.n_blocks, self.j.n_valid) == (
            self.t.index_epoch, self.t.n_slots, self.t.n_blocks, self.t.n_valid)
        jf, tf = fields(self.j.index), fields(self.t.index)
        # an explicit reoptimize, or one the threshold triggered
        if (rebuild or ht._mutations_since_opt == 0) and hj.n_live:
            assert_same_build(jf, tf)
            self.rebuilt = True
            self.aligned = np.array_equal(jf["row_ids"], tf["row_ids"])
        if self.aligned:
            np.testing.assert_array_equal(jf["row_ids"], tf["row_ids"])
            np.testing.assert_array_equal(jf["valid"], tf["valid"])
            assert hj._free == ht._free and hj._id_pos == ht._id_pos
            if self.rebuilt:
                np.testing.assert_allclose(jf["db"], tf["db"], atol=1e-6, rtol=0)
            else:
                np.testing.assert_array_equal(jf["db"], tf["db"])
            for f in ("dp", "dp_min", "dp_max"):
                np.testing.assert_allclose(jf[f], tf[f], atol=DP_ATOL, rtol=0, err_msg=f)
        else:
            # a rebuild swapped near-tie rows: compare row by external id
            for i in self.live:
                np.testing.assert_allclose(jf["db"][hj._id_pos[i]], tf["db"][ht._id_pos[i]],
                                           atol=1e-6, rtol=0)
        assert_sound(self.t.index)

    def search(self, q, k):
        """The port's results: equal to the fp64 brute force over the live
        rows, and to the reference's where its sims are finite (past the
        live rows the reference repeats an id in its ``-inf`` slots,
        ROADMAP.md Queue 3)."""
        s_t, i_t, st_t = self.t.search(q, k)
        s_j, i_j, _ = self.j.search(jnp.asarray(q), k)
        s_j, i_j = np.asarray(s_j), np.asarray(i_j)
        check_live_exact(s_t.numpy(), i_t.numpy(), self.live, q, k)
        fin = np.isfinite(s_j)
        np.testing.assert_array_equal(np.isfinite(s_t.numpy()), fin)
        np.testing.assert_allclose(s_t.numpy()[fin], s_j[fin], atol=1e-6)
        np.testing.assert_array_equal(np.sort(np.where(fin, i_t.numpy(), -1), 1),
                                      np.sort(np.where(fin, i_j, -1), 1))
        assert (st_t.generation, st_t.decay_estimate) == (self.ht.generation,
                                                          self.ht.decay_estimate)
        return s_t, i_t, st_t


# ---------------------------------------------------------------------------
# the reference's test_online.py cases, through both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_interleaved_mutations_match_reference(backend, seed):
    rng = np.random.default_rng(seed)
    n, d, k = 220, 12, 6
    rows = rng.normal(size=(n, d)).astype(np.float32)
    pair = Pair(rows, backend, auto_reoptimize=False)
    q = rng.normal(size=(5, d)).astype(np.float32)
    pair.search(q, k)                                  # warm: the tree builds here
    for _ in range(5):
        op = int(rng.integers(0, 3))
        if op == 0 or len(pair.live) < k + 8:
            pair.insert(rng.normal(size=(int(rng.integers(1, 9)), d)).astype(np.float32))
        elif op == 1:
            pair.delete([int(x) for x in rng.choice(sorted(pair.live), 5, replace=False)])
        else:
            pair.reoptimize()
        pair.search(q, k)
    assert pair.ht.generation == 5


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_tail_full_to_new_block_transition(backend, rng):
    """A full index appends a block on its first insert (epoch bump),
    fills it shape-stably, then crosses into the next."""
    n, d, bs = 128, 8, 32
    rows = rng.normal(size=(n, d)).astype(np.float32)
    pair = Pair(rows, backend, block_size=bs, auto_reoptimize=False)
    q = rng.normal(size=(3, d)).astype(np.float32)
    pair.search(q, 4)
    assert not pair.ht._free
    epoch0 = pair.t.index_epoch
    pair.insert(rng.normal(size=(1, d)).astype(np.float32))
    assert pair.t.index_epoch == epoch0 + 1 and pair.t.n_slots == (n // bs + 1) * bs
    pair.search(q, 4)
    pair.insert(rng.normal(size=(bs - 1, d)).astype(np.float32))
    assert pair.t.index_epoch == epoch0 + 1
    pair.insert(rng.normal(size=(2, d)).astype(np.float32))
    assert pair.t.index_epoch == epoch0 + 2
    pair.search(q, 4)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_search_after_delete_of_former_topk_member(backend, rng):
    n, d = 160, 8
    rows = rng.normal(size=(n, d)).astype(np.float32)
    pair = Pair(rows, backend, auto_reoptimize=False)
    q = rows[17][None] + np.float32(0.01) * rng.normal(size=(1, d)).astype(np.float32)
    _, ids, _ = pair.search(q, 3)
    assert int(ids[0, 0]) == 17
    pair.delete([17])
    _, ids, _ = pair.search(q, 3)
    assert 17 not in ids.numpy()


def test_reoptimize_preserves_ids_and_repacks(rng):
    n, d, bs = 96, 8, 32
    rows = rng.normal(size=(n, d)).astype(np.float32)
    pair = Pair(rows, "scan", block_size=bs, auto_reoptimize=False)
    pair.insert(rng.normal(size=(80, d)).astype(np.float32))
    pair.delete(list(range(0, n, 2)))
    slots_before = pair.t.n_slots
    assert pair.ht.decay_estimate > 0.5
    pair.reoptimize()
    assert pair.ht.decay_estimate == 0.0 and pair.t.n_slots <= slots_before
    q = rng.normal(size=(4, d)).astype(np.float32)
    pair.search(q, 5)
    assert pair.insert(rng.normal(size=(1, d)).astype(np.float32)) == [n + 80]
    pair.search(q, 5)


def test_auto_reoptimize_triggers_at_threshold(rng):
    n, d = 64, 8
    rows = rng.normal(size=(n, d)).astype(np.float32)
    pair = Pair(rows, "scan", reoptimize_threshold=0.25)
    epoch0 = pair.t.index_epoch
    pair.insert(rng.normal(size=(n // 4 + 1, d)).astype(np.float32))
    assert pair.ht.decay_estimate == 0.0 and pair.t.index_epoch > epoch0
    assert pair.t.n_valid == n + n // 4 + 1
    pair.search(rng.normal(size=(3, d)).astype(np.float32), 4)


def test_delete_unknown_id_raises_before_any_change(rng):
    rows = rng.normal(size=(64, 8)).astype(np.float32)
    eng = SearchEngine.build(rows, n_pivots=4, block_size=32, backend="scan", device="cpu")
    h = eng.online()
    with pytest.raises(KeyError, match="not in the live set"):
        h.delete([3, 99999])
    assert 3 in h and h.n_live == 64 and bool(eng.index.valid[h._id_pos[3]])
    with pytest.raises(KeyError, match="duplicate"):
        h.delete([5, 5])
    assert 5 in h and h.generation == 0


def test_online_handle_is_singleton(rng):
    rows = rng.normal(size=(64, 8)).astype(np.float32)
    eng = SearchEngine.build(rows, n_pivots=4, block_size=32, backend="scan", device="cpu")
    h = eng.online(auto_reoptimize=False)
    assert eng.online() is h
    with pytest.raises(ValueError, match="first call"):
        eng.online(auto_reoptimize=True)
    _, _, st = eng.search(rows[:2], 3)
    assert (st.generation, st.decay_estimate, st.retraces) == (0, 0.0, None)
    fresh = SearchEngine.build(rows, n_pivots=4, block_size=32, device="cpu")
    _, _, st = fresh.search(rows[:2], 3)
    assert (st.generation, st.decay_estimate) == (None, None)


@pytest.mark.parametrize("backend", ["kernel", "tree"])
def test_handle_owns_its_index(backend, rng):
    """Two engines over one index, each with a live tree where it has one:
    inserts and deletes through one engine's handle leave the shared index
    and the other engine as they were, and each engine stays exact over its
    own live rows."""
    from repro_torch.core.index import build_index

    db = clustered(rng, 300, 8)
    idx = build_index(db, n_pivots=4, block_size=32, device="cpu")
    before = [None if t is None else t.clone() for t in idx]
    a, b = (SearchEngine(idx, backend=backend, device="cpu") for _ in range(2))
    q = db[:6] + np.float32(0.01) * rng.normal(size=(6, 8)).astype(np.float32)
    for eng in (a, b):
        eng.search(q, 5)                                # trees build here
    h = a.online(auto_reoptimize=False)
    live = {i: db[i] for i in range(len(db))}
    new_ids = h.insert(q)                               # each query's own top-1
    h.delete([0, 1, 2])
    assert all(torch.equal(x, y) for x, y in zip(idx, before) if x is not None)
    assert b.index is idx and a.index is not idx
    check_live_exact(*(t.numpy() for t in b.search(q, 5)[:2]), live, q, 5)
    live.update(zip(new_ids, q))
    for i in (0, 1, 2):
        del live[i]
    check_live_exact(*(t.numpy() for t in a.search(q, 5)[:2]), live, q, 5)


def test_appended_block_records_exact_interval(rng):
    """An appended block's first rows record their exact interval from the
    empty-interval sentinel: dp_min/dp_max the rows' float32 extremes (the
    reference's rule), dp_lo/dp_hi their sound extremes."""
    n, d, bs = 64, 8, 32
    rows = rng.normal(size=(n, d)).astype(np.float32)
    pair = Pair(rows, "scan", block_size=bs, auto_reoptimize=False)
    assert not pair.ht._free
    piv0 = pair.t.index.pivots.numpy()[0]
    filled = n
    for count in (3, bs - 3):
        pair.insert((piv0[None] + 0.01 * rng.normal(size=(count, d))).astype(np.float32))
        filled += count
        idx = pair.t.index
        tail = idx.dp[n:filled]
        np.testing.assert_array_equal(idx.dp_min[-1].numpy(), tail.amin(0).numpy())
        np.testing.assert_array_equal(idx.dp_max[-1].numpy(), tail.amax(0).numpy())
        assert float(idx.dp_min[-1, 0]) > 0.5                  # no anchor at 0
        cos = norm64(idx.db[n:filled].numpy()) @ norm64(idx.pivots.numpy()).T
        lo, hi = idx.dp_lo[-1].double().numpy(), idx.dp_hi[-1].double().numpy()
        assert (lo <= cos.min(0)).all() and (hi >= cos.max(0)).all()
        # outward by at most the float32 rounding and one step each way
        assert (cos.min(0) - lo <= 3e-7).all() and (hi - cos.max(0) <= 3e-7).all()
    pair.search(rng.normal(size=(3, d)).astype(np.float32), 5)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_delete_all_reoptimize_insert_round_trip(backend, rng):
    n, d, k = 96, 8, 4
    rows = rng.normal(size=(n, d)).astype(np.float32)
    pair = Pair(rows, backend, auto_reoptimize=False)
    q = rng.normal(size=(3, d)).astype(np.float32)
    pair.search(q, k)
    pair.delete(list(range(n)))
    epoch0 = pair.t.index_epoch
    pair.reoptimize()
    assert pair.t.index_epoch == epoch0 + 1 and pair.t._tree_index is None
    assert pair.ht.n_live == 0 and pair.ht.decay_estimate == 0.0
    sims, ids, _ = pair.t.search(q, k)
    assert (ids.numpy() == -1).all() and np.isneginf(sims.numpy()).all()
    pair.insert(rng.normal(size=(10, d)).astype(np.float32))
    pair.search(q, k)


# ---------------------------------------------------------------------------
# the port alone: the widened tree, sound widening near +-1, mixed tiles
# ---------------------------------------------------------------------------

def bits_equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(a[1:], b[1:]))


@pytest.mark.parametrize("n,bs", [(1000, 16), (300, 32)])
def test_widen_tree_equals_build_tree_after_shape_stable_inserts(n, bs, rng):
    """Inserts into free slots under a live tree (the tail's, then
    tombstones of blocks that keep live rows): the widened node tables (each
    row's sound interval scatter-min/max'd along its path) equal build_tree
    of the new index bit for bit, and the tree serves the new index."""
    db = clustered(rng, n, 6)
    eng = SearchEngine.build(db, n_pivots=4, block_size=bs, backend="tree",
                             leaf_eval="scan", device="cpu")
    h = eng.online(auto_reoptimize=False)
    eng.search(db[:4], 3)                                   # the tree builds
    assert 1 < len(h._free) < bs
    row_ids = eng.index.row_ids.numpy()
    # one row of every third block: each block keeps live rows
    dead = [int(row_ids[b * bs]) for b in range(0, eng.n_blocks - 1, 3)]
    for step in ("tail", "delete", "tombstones"):
        if step == "delete":
            h.delete(dead)
        else:
            h.insert(clustered(rng, len(h._free), 6))
        assert eng.index_epoch == 0 and eng._tree_index.index is eng.index
        rebuilt = build_tree(eng.index)
        assert bits_equal_trees(eng._tree_index, rebuilt), step
        assert eng._tree_valid_nodes == int(rebuilt.node_valid.sum())


def mutation_stages(rng, n, d, bs, *, planted=False):
    """A tree engine through three stages, each yielded as ``(name, index,
    tree, live rows by id)``:

    * ``widened``: after deletes, a shape-stable insert into every free
      slot under the live tree (its node tables widened, not rebuilt);
    * ``appended``: then one appended block per (pivot, cosine of
      NEAR_PM1), and the tree the next search rebuilds;
    * ``widened_from_sentinels``: then every row deleted, a rebuild (every
      block and node at the empty sentinel), the tree built over it, and
      one block per (pivot, cosine) filled shape-stably under that tree.

    With ``planted`` every inserted row lies at that float64 cosine to that
    pivot (the first insert cycles through the pairs), so the appended
    blocks' intervals, and in the last stage the leaves' and their
    ancestors', end at planted rows."""
    db = clustered(rng, n, d)
    eng = SearchEngine.build(db, n_pivots=4, block_size=bs, backend="tree",
                             leaf_eval="scan", device="cpu")
    h = eng.online(auto_reoptimize=False)
    live = {i: db[i] for i in range(n)}
    eng.search(db[:2], 1)                                   # the tree builds
    piv = norm64(eng.index.pivots.numpy())
    pairs = [(j, c) for j in range(len(piv)) for c in NEAR_PM1]

    def insert(count, pick):
        if planted:
            new = np.array([at_cosine(rng, piv[j], c) for j, c in
                            (pairs[pick(i)] for i in range(count))], np.float32)
        else:
            new = clustered(rng, count, d)
        live.update(zip(h.insert(new), new))

    def delete(dead):
        h.delete(dead)
        for i in dead:
            del live[i]

    delete([int(x) for x in rng.choice(n, min(n // 2, 2 * bs), replace=False)])
    insert(len(h._free), lambda i: i % len(pairs))
    assert eng.index_epoch == 0 and not h._free
    yield "widened", eng.index, eng._tree_index, live
    for p in range(len(pairs)):
        insert(bs, lambda i: p)
    assert eng.index_epoch == len(pairs)
    eng.search(db[:2], 1)
    yield "appended", eng.index, eng._tree_index, live
    delete(sorted(live))
    h.reoptimize()
    eng.search(db[:2], 1)
    assert not bool(eng._tree_index.node_valid.any())
    for p in range(len(pairs)):
        insert(bs, lambda i: p)
    assert eng.index_epoch == len(pairs) + 1 and eng._tree_index is not None
    yield "widened_from_sentinels", eng.index, eng._tree_index, live


def planted_queries(rng, piv, live):
    """Queries at each cosine of NEAR_PM1 to each pivot, and queries in the
    plane of a pivot and one of the last 64 inserted rows, at 30-120
    degrees from the pivot: there an interval end off by an ulp near +-1
    moves the bound most, and the row attains it."""
    q = [at_cosine(rng, p, c) for p in piv for c in NEAR_PM1]
    for i in sorted(live)[-64:]:
        x = norm64(live[i])
        j = int(np.argmax(np.abs(piv @ x)))
        p = piv[j] * np.sign(piv[j] @ x)
        v = x - (x @ p) * p
        if np.linalg.norm(v) < 1e-9:
            continue
        v /= np.linalg.norm(v)
        for deg in (30, 60, 90, 120):
            t = np.deg2rad(deg)
            q.append(np.cos(t) * p + np.sin(t) * v)
    return np.array(q, np.float32)


def assert_bounds_dominate(idx, tree, q):
    """Every block's and every valid tree node's bound + margin is at least
    the float64 similarity of every valid row below it."""
    qn, qp = t_bk.prep_queries(idx, q)
    best = node_maxima_fp64(idx, tree, qn)
    nl = tree.n_leaf_slots
    leaf = block_bounds(qp, idx.dp_lo, idx.dp_hi).double().numpy()
    short = leaf + MARGIN < best[:, nl:nl + idx.n_blocks]
    assert not short.any(), f"a block bound short at {np.argwhere(short)[0]}: by " \
        f"{float((best[:, nl:nl + idx.n_blocks] - leaf - MARGIN)[short].max()):.3e}"
    ub = block_bounds(qp, tree.node_lo, tree.node_hi).double().numpy()
    short = tree.node_valid.numpy()[None, :] & (ub + MARGIN < best)
    short[:, 0] = False
    assert not short.any(), f"a node bound short at {np.argwhere(short)[0]}: by " \
        f"{float((best - ub - MARGIN)[short].max()):.3e}"


@settings(max_examples=10, deadline=None, derandomize=True)
@given(st.integers(40, 300), st.integers(2, 16), st.integers(0, 1000))
def test_node_bounds_dominate_descendants_fp64_after_mutations(n, d, seed):
    """test_torch_tree's fp64 domination on mutated indexes: the widened
    trees and the rebuilt one (mutation_stages)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(3, d)).astype(np.float32)
    for _, idx, tree, _ in mutation_stages(rng, n, d, 16):
        assert_bounds_dominate(idx, tree, q)


def exact_on(eng, live, q, k):
    s, i, _ = eng.search(q, k)
    check_live_exact(s.numpy(), i.numpy(), live, q, k)
    ids = np.array(sorted(live))
    s64 = norm64(q) @ norm64(np.stack([live[x] for x in ids])).T
    kk = min(k, len(ids))
    want = -np.sort(-s64, axis=1)[:, :kk]
    # the k-th best within float32 rounding, not within ATOL: a missed row
    # near +-1 differs from the k-th by far less than 3e-5
    np.testing.assert_allclose(s.numpy()[:, :kk], want, atol=2e-6, rtol=0)


@settings(max_examples=8, deadline=None, derandomize=True)
@given(st.integers(40, 200), st.integers(2, 8), st.integers(1, 8), st.integers(0, 1000))
def test_inserted_rows_near_pm1_keep_bounds_sound_and_backends_exact(n, d, k, seed):
    """Rows inserted at float64 cosines +-(1 - 1e-3), +-(1 - 1e-5) and +-1
    to the pivots (mutation_stages): at every stage every block bound and
    every node bound + margin reaches the float64 maximum below it, and
    scan, tree (both leaf stages) and kernel return the float64 brute
    force's results.  Widening the blocks or the tree with the float32 dp
    alone fails here: an interval then misses a row's float64 cosine, and
    the queries in the plane of that row and its pivot find the bound
    short by far more than the margin."""
    rng = np.random.default_rng(seed)
    for stage, idx, tree, live in mutation_stages(rng, n, d, 16, planted=True):
        piv = norm64(idx.pivots.numpy())
        q = planted_queries(rng, piv, live)
        assert_bounds_dominate(idx, tree, q)
        for backend, knobs in (("kernel", dict(bm=8)), ("scan", {}),
                               ("tree", dict(leaf_eval="scan")),
                               ("tree", dict(leaf_eval="kernel", bm=8))):
            exact_on(SearchEngine(idx, backend=backend, device="cpu", **knobs), live, q, k)


def test_kernel_tile_mixes_sentinel_and_filled_blocks(rng):
    """Blocks of 32 under kernel tiles of 128: after deleting every row and
    rebuilding, a 40-row insert fills blocks 0 and 1 of tile 0 and leaves
    blocks 2 and 3 at the empty sentinel.  The coarsened tile interval is
    the filled blocks' union, tile 1 stays inverted, and the kernel engine
    stays exact."""
    n, d, bs = 256, 8, 32
    rows = rng.normal(size=(n, d)).astype(np.float32)
    pair = Pair(rows, "kernel", block_size=bs, auto_reoptimize=False)
    q = rng.normal(size=(5, d)).astype(np.float32)
    pair.search(q, 4)
    pair.delete(list(range(n)))
    pair.reoptimize()
    pair.insert(rng.normal(size=(40, d)).astype(np.float32))
    idx = pair.t.index
    assert t_bk._resolve_bn(idx, pair.t.bn) == 4 * bs
    lo, hi = t_bk.coarsen_intervals(idx.dp_lo, idx.dp_hi, 4)
    assert torch.isinf(idx.dp_lo[2:]).all() and (idx.dp_lo[2:] > idx.dp_hi[2:]).all()
    assert torch.equal(lo[0], idx.dp_lo[:2].amin(0)) and torch.equal(hi[0], idx.dp_hi[:2].amax(0))
    assert (lo[1] > hi[1]).all()
    for k in (4, 40, 45):
        pair.search(q, k)
