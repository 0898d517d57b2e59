"""repro_torch.serve (ContinuousBatcher, KNNDatastore) and
repro_torch.models.lm.embed_hidden against repro's, on the CPU.

The batcher's answers equal the engine's own rows, it survives sequential
event loops, and a mutation through ``run`` between batches shows in the
next batch.  The datastore's ``knn_probs`` and ``interpolate`` equal the
reference's on the same pairs within 1e-6 (softmax and scatter-add over the
same neighbour sets, summed in another order), before and after
``add_pairs`` and ``delete``.  Every async test awaits under
``asyncio.wait_for(..., timeout=60)`` and closes its batcher, so a hung
worker fails one test.
"""
import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models.lm import embed_hidden as j_embed_hidden  # noqa: E402
from repro.serve.knnlm import KNNDatastore as JDatastore  # noqa: E402
from repro_torch.models.lm import embed_hidden  # noqa: E402
from repro_torch.search import SearchEngine  # noqa: E402
from repro_torch.serve import ContinuousBatcher, KNNDatastore  # noqa: E402
from tests.conftest import clustered  # noqa: E402
from tests.test_torch_online import check_live_exact  # noqa: E402

#: knn_probs against the reference's: the same weights summed in another order
PROBS_ATOL = 1e-6
TIMEOUT = 60


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=TIMEOUT))


def engine(rng, backend, n=600, d=16):
    db = clustered(rng, n, d)
    return db, SearchEngine.build(db, n_pivots=4, block_size=32, backend=backend,
                                  device="cpu")


@pytest.mark.parametrize("backend", ["kernel", "scan", "tree"])
def test_batcher_answers_equal_engine_search(backend, rng):
    """20 concurrent submits in microbatches of up to 8: each answer equals
    the engine's own search of that query."""
    db, eng = engine(rng, backend)
    q = db[:20] + np.float32(0.05) * rng.normal(size=(20, db.shape[1])).astype(np.float32)
    batcher = ContinuousBatcher(eng, k=5, max_batch=8, max_wait_ms=1.0)

    async def main():
        try:
            return await asyncio.gather(*(batcher.submit(x) for x in q))
        finally:
            await batcher.close()

    answers = run(main())
    want_s, want_i, _ = eng.search(q, 5)
    for (s, i), ws, wi in zip(answers, want_s.numpy(), want_i.numpy()):
        assert s.shape == (5,) and i.dtype == np.int32
        np.testing.assert_allclose(s, ws, atol=1e-6)
        np.testing.assert_array_equal(np.sort(i), np.sort(wi))
    assert batcher.n_queries == 20 and batcher.n_batches >= 3
    assert 0 < batcher.occupancy <= 1
    with pytest.raises(RuntimeError, match="closed"):
        run(batcher.submit(q[0]))


def test_batcher_searches_only_the_coalesced_rows(rng):
    """No microbatch is padded: the engine sees exactly the queries that
    coalesced, 1 to ``max_batch`` rows, and each answer is its own row's."""
    db, eng = engine(rng, "kernel")
    shapes = []

    class Recording:
        def search(self, q, k):
            shapes.append(np.asarray(q).shape)
            return eng.search(q, k)

    batcher = ContinuousBatcher(Recording(), k=3, max_batch=8, max_wait_ms=1.0)

    async def main():
        try:
            lone = await batcher.submit(db[0])
            burst = await asyncio.gather(*(batcher.submit(x) for x in db[1:12]))
            return [lone] + burst
        finally:
            await batcher.close()

    answers = run(main())
    assert shapes[0] == (1, db.shape[1])
    assert all(1 <= m <= 8 and d == db.shape[1] for m, d in shapes)
    assert sum(m for m, _ in shapes) == 12 == batcher.n_queries
    assert batcher.occupancy == 12 / (8 * len(shapes))
    assert [int(i[0]) for _, i in answers] == list(range(12))


def test_batcher_survives_sequential_event_loops(rng):
    """The reference's regression (tests/test_serve.py): a batcher reused
    across two sequential ``asyncio.run`` calls re-creates its worker and
    queue on the new loop instead of enqueuing onto the dead one."""
    db = rng.normal(size=(128, 16)).astype(np.float32)
    eng = SearchEngine.build(db, n_pivots=4, block_size=32, device="cpu")
    batcher = ContinuousBatcher(eng, k=3, max_batch=4, max_wait_ms=1.0)

    async def one(i):
        sims, ids = await batcher.submit(db[i])
        assert int(ids[0]) == i and sims.shape == (3,)

    async def round_trip(n):
        await asyncio.gather(*(one(i) for i in range(n)))

    run(round_trip(5))
    run(round_trip(5))
    assert batcher.n_queries == 10
    run(batcher.close())


@pytest.mark.parametrize("backend", ["kernel", "tree"])
def test_batcher_mutation_through_run_between_batches(backend, rng):
    """Answers before an insert and a delete made through ``batcher.run``
    hold to the rows live then, answers after to the rows live after."""
    db, eng = engine(rng, backend)
    h = eng.online(auto_reoptimize=False)
    live = {i: db[i] for i in range(len(db))}
    q = db[:12] + np.float32(0.02) * rng.normal(size=(12, db.shape[1])).astype(np.float32)
    new = clustered(rng, 40, db.shape[1])
    dead = list(range(0, 12, 2))
    batcher = ContinuousBatcher(eng, k=4, max_batch=8, max_wait_ms=1.0)

    async def main():
        try:
            first = await asyncio.gather(*(batcher.submit(x) for x in q))
            ids = await batcher.run(h.insert, new)
            await batcher.run(h.delete, dead)
            second = await asyncio.gather(*(batcher.submit(x) for x in q))
            return first, ids, second
        finally:
            await batcher.close()

    first, ids, second = run(main())
    check_live_exact(*map(np.stack, zip(*first)), live, q, 4)
    live.update(zip(ids, new))
    for i in dead:
        del live[i]
    s2, i2 = map(np.stack, zip(*second))
    check_live_exact(s2, i2, live, q, 4)
    assert not np.isin(i2, dead).any()


# ---------------------------------------------------------------------------
# the kNN-LM datastore and embed_hidden
# ---------------------------------------------------------------------------

def pairs(rng, d=32, per=50):
    """Embeddings around 3 unit prototypes, each mapped to its own token (the
    reference's test_knn_datastore_boosts_neighbor_tokens data)."""
    protos = rng.normal(size=(3, d)).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    embs = np.concatenate([p + 0.05 * rng.normal(size=(per, d)).astype(np.float32)
                           for p in protos])
    return protos, embs, np.repeat([7, 11, 23], per)


VOCAB = 64


def both_stores(rng, **kw):
    protos, embs, toks = pairs(rng)
    j = JDatastore.from_pairs(embs, toks, VOCAB, k=8, n_pivots=4, block_size=32, **kw)
    t = KNNDatastore.from_pairs(embs, toks, VOCAB, k=8, n_pivots=4, block_size=32,
                                device="cpu", **kw)
    return protos, embs, j, t


def assert_probs_equal(j, t, hidden):
    pj = np.asarray(j.knn_probs(jnp.asarray(hidden)))
    pt = t.knn_probs(hidden).numpy()
    np.testing.assert_allclose(pt, pj, atol=PROBS_ATOL, rtol=0)
    return pt


@pytest.mark.parametrize("backend", ["auto", "kernel", "scan"])
def test_knn_probs_and_interpolate_match_reference(backend, rng):
    protos, embs, j, t = both_stores(rng, backend=backend)
    assert t.values.dtype == torch.int32 and t.values.device == t.engine.device
    hidden = np.concatenate([protos, embs[::25]]).astype(np.float32)
    pt = assert_probs_equal(j, t, hidden)
    assert int(np.argmax(pt[1])) == 11
    np.testing.assert_allclose(pt.sum(1), 1.0, atol=1e-5)
    lm = np.full((len(hidden), VOCAB), 1.0 / VOCAB, np.float32)
    mixed_j = np.asarray(j.interpolate(jnp.asarray(hidden), jnp.asarray(lm), 0.5))
    mixed_t = t.interpolate(hidden, torch.from_numpy(lm), 0.5).numpy()
    np.testing.assert_allclose(mixed_t, mixed_j, atol=PROBS_ATOL, rtol=0)
    assert mixed_t[1, 11] > lm[1, 11]


def test_knn_add_pairs_and_delete_match_reference(rng):
    """add_pairs mints the reference's ids; a lookup of each added
    embedding returns its own id and token; deleted ids never come back;
    probs equal the reference's after each mutation."""
    protos, embs, j, t = both_stores(rng)
    d = embs.shape[1]
    new = clustered(rng, 40, d)
    toks = rng.integers(30, VOCAB, 40)
    ids = j.add_pairs(new, toks)
    assert t.add_pairs(new, toks) == ids == list(range(len(embs), len(embs) + 40))
    _, got_t, got_i = t.lookup(new)
    np.testing.assert_array_equal(got_i[:, 0].numpy(), ids)
    np.testing.assert_array_equal(got_t[:, 0].numpy(), toks)
    hidden = np.concatenate([protos, new[:5]]).astype(np.float32)
    assert_probs_equal(j, t, hidden)
    dead = ids[:10] + list(range(50, 60))
    j.delete(dead)
    t.delete(dead)
    _, _, got_i = t.lookup(np.concatenate([new, protos]).astype(np.float32))
    assert not np.isin(got_i.numpy(), dead).any()
    assert_probs_equal(j, t, hidden)


def test_knn_value_table_guards(rng):
    """An engine mutated outside the store, and pairs of unequal length,
    raise before anything is inserted."""
    _, embs, _, t = both_stores(rng)
    d = embs.shape[1]
    with pytest.raises(ValueError, match="next_tokens"):
        t.add_pairs(embs[:3], [1, 2])
    assert t.engine.online().n_live == len(embs)
    t.engine.online().insert(embs[:1])
    with pytest.raises(RuntimeError, match="value table"):
        t.add_pairs(rng.normal(size=(2, d)).astype(np.float32), [1, 2])
    assert t.engine.online().n_live == len(embs) + 1


def test_knn_datastore_wraps_a_bare_index_on_its_device(rng):
    protos, embs, j, t = both_stores(rng)
    bare = KNNDatastore(t.index, t.values.numpy(), VOCAB, k=8, backend="scan")
    assert bare.engine is not t.engine and bare.engine.device == t.index.device
    assert bare.engine.backend_name == "scan"
    assert_probs_equal(j, bare, protos)


def test_knn_frontend_serves_lookups(rng):
    protos, embs, _, t = both_stores(rng)
    batcher = t.frontend(max_batch=4, max_wait_ms=1.0)

    async def main():
        try:
            return await asyncio.gather(*(batcher.submit(x) for x in protos))
        finally:
            await batcher.close()

    answers = run(main())
    _, _, want = t.lookup(protos)
    for (_, i), w in zip(answers, want.numpy()):
        np.testing.assert_array_equal(np.sort(i), np.sort(w))


def test_embed_hidden_matches_reference(rng):
    h = rng.normal(size=(2, 5, 16)).astype(np.float32)
    h[0, 0] = 0.0                                            # the eps floor
    want = np.asarray(j_embed_hidden(None, jnp.asarray(h), None))
    got = embed_hidden(None, torch.from_numpy(h), None)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7, rtol=0)
