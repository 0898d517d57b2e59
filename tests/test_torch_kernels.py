"""repro_torch kernels against the Pallas kernels on identical operands.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
Pallas in interpret mode, as tests/test_kernels.py does.  The kernels
themselves are held against the plain versions on the card by
tests/test_torch_cuda.py, which also holds the shared operand builders.

The port's Eq. 13 bound runs over the query's float32 interval with
radicands (1 - s)(1 + s), so its bounds are held to the float64 truth and
to the reference's within REF_SLACK away from +-1
(test_torch_cuda.assert_bounds_against_reference), and what the engine
reduces from them to the reference's reduction of the same matrix.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.core import ref as jcref  # noqa: E402
from repro.kernels import ref as jkref  # noqa: E402
from repro.kernels.bound_prune import block_bounds as j_block_bounds  # noqa: E402
from repro.kernels.cosine_topk import pruned_topk as j_pruned_topk  # noqa: E402
from repro_torch.core import ref as cref  # noqa: E402
from repro_torch.kernels import ref as tkref  # noqa: E402
from repro_torch.kernels.bound_prune import (SELECT_MAX_N_PRE,  # noqa: E402
                                             block_bounds, block_bounds_plain,
                                             block_bounds_select)
from repro_torch.kernels.cosine_topk import (choose_splits,  # noqa: E402
                                             default_splits, merge_splits,
                                             merge_splits_plain, pruned_topk,
                                             pruned_topk_plain)
from tests.test_torch_cuda import (OPTIONS,  # noqa: E402
                                   assert_bounds_against_reference,
                                   assert_topk_match, assert_topk_sets_close,
                                   bound_operands, optional_operands,
                                   select_operands, topk_operands)

@pytest.mark.parametrize("m,nb,p", [(8, 4, 4), (37, 19, 12), (128, 64, 16),
                                    (256, 8, 8), (5, 100, 3)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("with_cap", [False, True], ids=["nocap", "cap"])
def test_block_bounds_matches_pallas(m, nb, p, dtype, with_cap):
    qp, lo, hi, cap = bound_operands(m, nb, p, dtype, seed=m * nb)
    cap_j = jnp.asarray(cap) if with_cap else None
    cap_t = torch.from_numpy(cap) if with_cap else None
    want = np.asarray(j_block_bounds(jnp.asarray(qp), jnp.asarray(lo),
                                     jnp.asarray(hi), cap_j, bm=32, bb=32,
                                     interpret=True))
    got = block_bounds(torch.from_numpy(qp), torch.from_numpy(lo),
                       torch.from_numpy(hi), cap_t).numpy()
    assert got.dtype == np.float32 and got.shape == (m, nb)
    # the port casts float64 operands to float32 first
    f32 = [x.astype(np.float32) for x in (qp, lo, hi)]
    away = assert_bounds_against_reference(got, want, *f32, cap if with_cap else None)
    assert away > 0
    assert np.isneginf(got[:, nb // 2]).all()


def test_block_bounds_oracle_matches_reference_oracle():
    qp, lo, hi, _ = bound_operands(40, 30, 6, np.float32, seed=1)
    want = np.asarray(jkref.block_bounds(jnp.asarray(qp), jnp.asarray(lo),
                                         jnp.asarray(hi)))
    got = tkref.block_bounds(torch.from_numpy(qp), torch.from_numpy(lo),
                             torch.from_numpy(hi)).numpy()
    assert assert_bounds_against_reference(got, want, qp, lo, hi) > 0
    # the chunked plain version is the same arithmetic, chunk by chunk
    import repro_torch.kernels.bound_prune as bp
    chunk = bp._PLAIN_CHUNK_ELEMS
    try:
        bp._PLAIN_CHUNK_ELEMS = 30 * 6 * 7          # 7 queries per chunk
        np.testing.assert_array_equal(
            block_bounds_plain(torch.from_numpy(qp), torch.from_numpy(lo),
                               torch.from_numpy(hi)).numpy(), got)
    finally:
        bp._PLAIN_CHUNK_ELEMS = chunk


def pallas_tile_choice(ub, *, bm, n_pre):
    """The reference's reduction of a bound matrix ``ub`` (numpy): the
    engine's ``lax.top_k`` for the warm start's blocks and the max over each
    -inf-padded query tile.  Returns (top_k indices, tile max) as numpy."""
    ub = jnp.asarray(ub)
    m, nb = ub.shape
    mp = -(-m // bm) * bm
    ub_p = jnp.concatenate([ub, jnp.full((mp - m, nb), -jnp.inf, ub.dtype)])
    return (np.asarray(lax.top_k(ub, n_pre)[1]),
            np.asarray(ub_p.reshape(mp // bm, bm, nb).max(1)))


@pytest.mark.parametrize("with_cap", [False, True], ids=["nocap", "cap"])
@pytest.mark.parametrize("bm", [8, 128])
@pytest.mark.parametrize("n_pre", [1, 3, 8])
def test_block_bounds_select_matches_pallas_tile_choice(n_pre, bm, with_cap):
    """150 queries (ragged at both bm), 90 blocks with empty-block
    sentinels, exact ties at bound 1 for the first 50 queries (blocks 3, 88
    and 89), and with the cap two rows at -inf everywhere.  The port's
    bound matrix against the Pallas kernel's by the bound rule; its
    reduction equal to the reference's reduction of that matrix: tile_max
    bit for bit, best index for index (ties to the lower block)."""
    qp, lo, hi, cap = select_operands(150, 90, 12, seed=n_pre + bm)
    cap = cap if with_cap else None
    ops = [None if a is None else torch.from_numpy(a) for a in (qp, lo, hi, cap)]
    ub_t = block_bounds_plain(*ops).numpy()
    ub_j = j_block_bounds(jnp.asarray(qp), jnp.asarray(lo), jnp.asarray(hi),
                          None if cap is None else jnp.asarray(cap), bm=32, bb=32,
                          interpret=True)
    assert assert_bounds_against_reference(ub_t, ub_j, qp, lo, hi, cap) > 0
    idx_j, tmax_j = pallas_tile_choice(ub_t, bm=bm, n_pre=n_pre)
    tile_max, best = block_bounds_select(*ops, bm=bm, n_pre=n_pre)
    assert tile_max.dtype == torch.float32 and best.dtype == torch.int64
    assert tile_max.shape == tmax_j.shape and best.shape == (150, n_pre)
    tile_max, best = tile_max.numpy(), best.numpy()
    np.testing.assert_array_equal(tile_max, tmax_j)
    np.testing.assert_array_equal(best, idx_j)
    if n_pre >= 3 and not with_cap:
        assert (best[:50, :3] == [3, 88, 89]).all()
    if with_cap:
        assert (best[[1, 148]] == np.arange(n_pre)).all()


def test_block_bounds_select_rejects_n_pre_past_its_limit():
    qp, lo, hi, _ = (torch.from_numpy(a)
                     for a in bound_operands(20, 200, 4, np.float32, seed=1))
    for n_pre in (0, SELECT_MAX_N_PRE + 1):
        with pytest.raises(ValueError, match="n_pre"):
            block_bounds_select(qp, lo, hi, bm=8, n_pre=n_pre)
    with pytest.raises(ValueError, match="n_pre"):
        block_bounds_select(qp, lo[:5], hi[:5], bm=8, n_pre=6)
    with pytest.raises(ValueError, match="bm"):
        block_bounds_select(qp, lo, hi, bm=0, n_pre=1)


def test_kernel_oracles_match_reference():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(9, 16)).astype(np.float32)
    db = rng.normal(size=(70, 16)).astype(np.float32)
    valid = rng.uniform(size=70) > 0.2
    s_j, i_j = jkref.cosine_topk(jnp.asarray(q), jnp.asarray(db), 5,
                                 jnp.asarray(valid))
    s_t, i_t = tkref.cosine_topk(torch.from_numpy(q), torch.from_numpy(db), 5,
                                 torch.from_numpy(valid))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(
        tkref.kth_value(s_t, 3).numpy(),
        np.asarray(jkref.kth_value(jnp.asarray(s_t.numpy()), 3)))
    np.testing.assert_allclose(
        tkref.l2_normalize(torch.from_numpy(q)).numpy(),
        np.asarray(jkref.l2_normalize(jnp.asarray(q))), atol=1e-7)
    qn, dn = cref.normalize(q).astype(np.float32), cref.normalize(db).astype(np.float32)
    piv = dn[:4]
    qp, dp = qn @ piv.T, dn @ piv.T
    lo, hi = dp.reshape(-1, 10, 4).min(1), dp.reshape(-1, 10, 4).max(1)
    *_, f_j = jkref.pruned_cosine_topk(*map(jnp.asarray, (q, db, qp, lo, hi)), 5)
    *_, f_t = tkref.pruned_cosine_topk(*map(torch.from_numpy, (q, db, qp, lo, hi)), 5)
    assert abs(float(f_t) - float(f_j)) < 1e-6


# ---------------------------------------------------------------------------
# pruned_topk
# ---------------------------------------------------------------------------

def run_both(ops, *, k, bm, bn, prune=True, elem=False, n_valid=None, **opt):
    """The Pallas kernel (interpret mode) and the port's wrapper on the same
    operands.  Returns (reference outputs, port outputs) as numpy."""
    n = ops["db"].shape[0]
    kw = optional_operands(ops, bm=bm, bn=bn, elem=elem, **opt)
    n_valid = n if n_valid is None else n_valid
    pos = (ops["q"], ops["db"], ops["qp"], ops["lo"], ops["hi"])
    ref = j_pruned_topk(*map(jnp.asarray, pos), n_valid,
                        **{a: None if v is None else jnp.asarray(v) for a, v in kw.items()},
                        k=k, bm=bm, bn=bn, prune=prune, element_stats=elem,
                        interpret=True)
    got = pruned_topk(*(torch.from_numpy(a) for a in pos), n_valid,
                      **{a: None if v is None else torch.from_numpy(v)
                         for a, v in kw.items()},
                      k=k, bm=bm, bn=bn, prune=prune, element_stats=elem)
    as_np = (lambda x: None if x is None else np.asarray(x))
    return [as_np(x) for x in ref], [None if x is None else x.cpu().numpy() for x in got]


SWEEP = [(512, 16, 4, 16, 128), (1024, 32, 9, 32, 256), (768, 48, 16, 8, 128)]
@pytest.mark.parametrize("n,d,k,bm,bn", SWEEP)
@pytest.mark.parametrize("opt", list(OPTIONS))
def test_pruned_topk_matches_pallas(n, d, k, bm, bn, opt):
    o = OPTIONS[opt]
    ops = topk_operands(n, d, 40, bn, 8, seed=n + d, holes=o.get("holes", False))
    ref, got = run_both(ops, k=k, bm=bm, bn=bn, **o)
    assert_topk_match(ref, got)
    sref, iref = cref.brute_force_knn(ops["q"], np.where(ops["valid"][:, None],
                                                         ops["db"], 0), k)
    np.testing.assert_allclose(got[0], sref, atol=3e-5)


@pytest.mark.parametrize("opt", ["plain", "all"])
def test_pruned_topk_bf16_db_matches_pallas(opt):
    """A bf16 db (the reference's test_cosine_topk_dtypes corpus shape: 512
    x 32, 16 queries, 8 pivots, k = 5, bm = 16): the same bf16 rows
    through the Pallas kernel in interpret mode and the port's plain
    version (both score fp32 queries against the rounded rows), sims
    within 1e-5, ids tie-aware; both within the reference's 2e-2 of the
    fp32 brute force."""
    o = OPTIONS[opt]
    ops = topk_operands(512, 32, 16, 128, 8, seed=29, holes=o.get("holes", False))
    n, k, bm, bn = 512, 5, 16, 128
    kw = optional_operands(ops, bm=bm, bn=bn, **o)
    pos = (ops["q"], ops["db"], ops["qp"], ops["lo"], ops["hi"])
    ref = j_pruned_topk(jnp.asarray(pos[0]), jnp.asarray(pos[1]).astype(jnp.bfloat16),
                        *map(jnp.asarray, pos[2:]), n,
                        **{a: None if v is None else jnp.asarray(v) for a, v in kw.items()},
                        k=k, bm=bm, bn=bn, prune=o.get("prune", True),
                        element_stats=o.get("elem", False), interpret=True)
    tpos = [torch.from_numpy(a) for a in pos]
    tpos[1] = tpos[1].bfloat16()
    got = pruned_topk(*tpos, n, **{a: None if v is None else torch.from_numpy(v)
                                   for a, v in kw.items()},
                      k=k, bm=bm, bn=bn, prune=o.get("prune", True),
                      element_stats=o.get("elem", False))
    ref = [None if x is None else np.asarray(x) for x in ref]
    got = [None if x is None else x.numpy() for x in got]
    assert_topk_match(ref, got, atol=1e-5)
    sref, _ = cref.brute_force_knn(ops["q"], np.where(ops["valid"][:, None], ops["db"], 0), k)
    for s in (ref[0], got[0]):
        np.testing.assert_allclose(s, sref, atol=2e-2)
    # the rows really were rounded: fp32 scores would sit within 3e-5
    assert np.abs(got[0] - sref).max() > 3e-5


@pytest.mark.parametrize("k", [1, 5, 32])
def test_pruned_topk_k_sweep(k):
    """k from 1 to bn (=32), with every option on."""
    ops = topk_operands(512, 16, 24, 32, 6, seed=k, holes=True)
    ref, got = run_both(ops, k=k, bm=8, bn=32, **OPTIONS["all"])
    assert_topk_match(ref, got)


def test_pruned_topk_prunes_tiles():
    """The operands make τ rise: most tiles skip, identically in both."""
    ops = topk_operands(1024, 32, 40, 128, 8, seed=3)
    ref, got = run_both(ops, k=5, bm=8, bn=128, tau=True)
    assert_topk_match(ref, got)
    assert 0 < got[2].mean() < 0.9


def test_pruned_topk_plain_gaps():
    """gaps=True leaves the four outputs as they were and adds the skip
    margins: a tile is computed exactly where its gap is >= 0, and near
    counts at most the tile's elements."""
    ops = topk_operands(1024, 32, 40, 128, 8, seed=3, holes=True)
    kw = optional_operands(ops, bm=8, bn=128, tau=True, elem=True, holes=True)
    args = [torch.from_numpy(ops[a]) for a in ("q", "db", "qp", "lo", "hi")]
    kw = {a: None if v is None else torch.from_numpy(v) for a, v in kw.items()}
    common = dict(k=5, bm=8, bn=128, element_stats=True)
    plain = pruned_topk_plain(*args, 1024, **kw, **common)
    *outs, gap, near = pruned_topk_plain(*args, 1024, **kw, **common, gaps=True)
    for a, b in zip(plain, outs):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert torch.equal(outs[2].bool(), gap >= 0)
    assert 0 < outs[2].float().mean() < 1
    assert bool(((near >= 0) & (near <= 8 * 128)).all())


def test_pruned_topk_empty_slots_carry_minus_one():
    """n_valid = 5 < k = 8: slots past the last valid row are (-inf, -1).
    The reference repeats an id there (ROADMAP Queue 3); only its finite
    slots are compared."""
    ops = topk_operands(256, 16, 8, 64, 4, seed=5)
    ref, got = run_both(ops, k=8, bm=8, bn=64, n_valid=5)
    assert_topk_match(ref, got)
    assert np.isneginf(got[0][:, 5:]).all() and (got[1][:, 5:] == -1).all()
    assert (np.sort(got[1][:, :5], 1) == np.arange(5)).all()


def test_pruned_topk_rejects_bad_arguments():
    ops = topk_operands(256, 16, 8, 64, 4, seed=6)
    args = [torch.from_numpy(ops[a]) for a in ("q", "db", "qp", "lo", "hi")]
    with pytest.raises(ValueError, match="k="):
        pruned_topk(*args, 256, k=65, bm=8, bn=64)
    with pytest.raises(ValueError, match="element_stats"):
        pruned_topk(*args, 256, k=4, bm=8, bn=64, element_stats=True)
    with pytest.raises(ValueError, match="whole tiles"):
        pruned_topk(*args, 256, k=4, bm=8, bn=48)




# ---------------------------------------------------------------------------
# pruned_topk with the db axis split (splits > 1)
# ---------------------------------------------------------------------------

def run_splits(ops, splits, *, k, bm, bn, prune=True, elem=False, **opt):
    """The port's wrapper on the CPU at ``splits`` and at 1, same operands."""
    n = ops["db"].shape[0]
    kw = optional_operands(ops, bm=bm, bn=bn, elem=elem, **opt)
    kw = {a: None if v is None else torch.from_numpy(v) for a, v in kw.items()}
    pos = [torch.from_numpy(ops[a]) for a in ("q", "db", "qp", "lo", "hi")]
    common = dict(k=k, bm=bm, bn=bn, prune=prune, element_stats=elem)
    got = pruned_topk(*pos, n, **kw, **common, splits=splits)
    one = pruned_topk(*pos, n, **kw, **common, splits=1)
    return ([None if x is None else x.numpy() for x in got],
            [None if x is None else x.numpy() for x in one])


def assert_splits_agree(got, one, *, prune=True):
    """Result sets equal the single pass (tie-aware at 1e-5); splits
    compute every tile the single pass computes, all of them without
    pruning, and prune no more elements than it."""
    assert_topk_sets_close(got[0], got[1], one[0], one[1], tol=1e-5)
    assert (got[2] >= one[2]).all()
    if not prune:
        np.testing.assert_array_equal(got[2], one[2])
        assert got[2].all()
    if one[3] is not None:
        assert (got[3] <= one[3]).all()


@pytest.mark.parametrize("splits", [2, 3, 4])
@pytest.mark.parametrize("n,d,k,bm,bn", SWEEP)
@pytest.mark.parametrize("opt", list(OPTIONS))
def test_pruned_topk_splits_match_one_pass(n, d, k, bm, bn, opt, splits):
    """768 / 128 = 6 db tiles: splits 4 leaves two short splits."""
    o = OPTIONS[opt]
    ops = topk_operands(n, d, 40, bn, 8, seed=n + d, holes=o.get("holes", False))
    got, one = run_splits(ops, splits, k=k, bm=bm, bn=bn, **o)
    assert_splits_agree(got, one, prune=o.get("prune", True))
    db0 = np.where(ops["valid"][:, None], ops["db"], 0)
    sref, iref = jcref.brute_force_knn(ops["q"], db0, k)
    np.testing.assert_allclose(got[0], sref, atol=3e-5)
    assert_topk_sets_close(got[0], got[1], sref.astype(np.float32),
                           iref.astype(np.int32), tol=3e-5)


@pytest.mark.parametrize("splits", [2, 3])
@pytest.mark.parametrize("k", [1, 5, 32])
def test_pruned_topk_splits_k_sweep(k, splits):
    """k from 1 to bn (=32), every option on, 16 db tiles."""
    ops = topk_operands(512, 16, 24, 32, 6, seed=k, holes=True)
    got, one = run_splits(ops, splits, k=k, bm=8, bn=32, **OPTIONS["all"])
    assert_splits_agree(got, one)


def test_pruned_topk_splits_one_query_tile_ragged():
    """mt = 1 (m <= bm) and nt = 7 tiles over 3 splits (7 % 3 != 0): the
    last split visits 2 tiles and takes a "no tile" step."""
    ops = topk_operands(7 * 64, 24, 20, 64, 5, seed=11, holes=True)
    got, one = run_splits(ops, 3, k=6, bm=32, bn=64, tau=True, order=True,
                          elem=True, holes=True)
    assert got[2].shape == (1, 7)
    assert_splits_agree(got, one)
    # every db tile is decided by its split (gap starts at 0; without τ
    # seeds a split's first visits see τ = -inf, a gap of +inf)
    *_, gap, near = pruned_topk_plain(
        *[torch.from_numpy(ops[a]) for a in ("q", "db", "qp", "lo", "hi")],
        7 * 64, k=6, bm=32, bn=64, splits=3, gaps=True)
    assert bool((gap != 0).all()) and int(torch.isinf(gap).sum()) == 3
    # splits = nt: every split holds one tile, nothing can prune
    got, one = run_splits(ops, 7, k=6, bm=32, bn=64)
    assert_splits_agree(got, one)
    assert got[2].all()


def test_pruned_topk_splits_equal_pallas_at_one():
    """splits=1 passed explicitly is the reference's pass, slot for slot."""
    ops = topk_operands(1024, 32, 40, 128, 8, seed=3)
    ref, got = run_both(ops, k=5, bm=8, bn=128, tau=True)
    _, one = run_splits(ops, 1, k=5, bm=8, bn=128, tau=True)
    assert_topk_match(ref, got)
    for a, b in zip(got, one):
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_pruned_topk_rejects_bad_splits():
    ops = topk_operands(256, 16, 8, 64, 4, seed=6)
    args = [torch.from_numpy(ops[a]) for a in ("q", "db", "qp", "lo", "hi")]
    for bad in (0, 5):
        with pytest.raises(ValueError, match="splits="):
            pruned_topk(*args, 256, k=4, bm=8, bn=64, splits=bad)


def test_merge_splits_tie_rule_and_empty_slots():
    """Score descending, then split, then slot; -inf slots keep id -1."""
    inf = float("-inf")
    part_s = torch.tensor([[[0.9, 0.5, 0.5, inf], [0.7, inf, inf, inf]],
                           [[0.5, 0.5, 0.1, inf], [inf, inf, inf, inf]],
                           [[0.9, 0.5, inf, inf], [inf, inf, inf, inf]]])
    part_i = torch.tensor([[[1, 2, 3, -1], [10, -1, -1, -1]],
                           [[4, 5, 6, -1], [-1, -1, -1, -1]],
                           [[7, 8, -1, -1], [-1, -1, -1, -1]]],
                          dtype=torch.int32)
    for fn in (merge_splits, merge_splits_plain):
        s, i = fn(part_s, part_i)
        assert torch.equal(s, torch.tensor([[0.9, 0.9, 0.5, 0.5],
                                            [0.7, inf, inf, inf]]))
        assert i.tolist() == [[1, 7, 2, 3], [10, -1, -1, -1]]
    # one split is the identity
    s, i = merge_splits_plain(part_s[:1], part_i[:1])
    assert torch.equal(s, part_s[0]) and torch.equal(i, part_i[0])


# ---------------------------------------------------------------------------
# row_out: results written back in the caller's query order
# ---------------------------------------------------------------------------

def row_out_case(seed):
    """40 queries at bm = 16 (a ragged last query tile of 8), 8 db tiles of
    32, every option on, and a seeded permutation of the 40 rows."""
    ops = topk_operands(256, 16, 40, 32, 6, seed=seed, holes=True)
    kw = optional_operands(ops, bm=16, bn=32, **OPTIONS["all"])
    kw = {a: None if v is None else torch.from_numpy(v) for a, v in kw.items()}
    pos = [torch.from_numpy(ops[a]) for a in ("q", "db", "qp", "lo", "hi")]
    perm = np.random.default_rng(seed).permutation(40).astype(np.int32)
    return ops, pos, kw, perm


@pytest.mark.parametrize("k", [1, 10, 32], ids=["k1", "k10", "k=bn"])
@pytest.mark.parametrize("splits", [1, 2, 3, 5])
def test_pruned_topk_plain_row_out_scatters(splits, k):
    """row_out=perm is the result without it, row r moved to row perm[r];
    computed and elem stay indexed by the query tiles as given."""
    _, pos, kw, perm = row_out_case(splits * 100 + k)
    common = dict(k=k, bm=16, bn=32, element_stats=True, splits=splits)
    plain = pruned_topk_plain(*pos, 256, **kw, **common)
    got = pruned_topk_plain(*pos, 256, **kw, **common, row_out=torch.from_numpy(perm))
    for a, b in zip(plain[:2], got[:2]):
        want = torch.empty_like(a)
        want[torch.from_numpy(perm).long()] = a
        assert torch.equal(b, want)
    for a, b in zip(plain[2:], got[2:]):
        assert torch.equal(a, b)
    # the wrapper takes the same path on the CPU
    wrapped = pruned_topk(*pos, 256, **kw, **common, row_out=torch.from_numpy(perm))
    for a, b in zip(got, wrapped):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [1, 5, 32])
def test_pruned_topk_row_out_equals_pallas_reordered(k):
    """At one split, row_out=perm equals the Pallas kernel (interpret mode)
    re-ordered the same way, ``out[perm] = ref``, as test_pruned_topk_
    matches_pallas holds the two: sims to 1e-6 (XLA and PyTorch sum the
    fp32 scores in other orders, 1 ulp apart), ids equal as sets wherever
    the sims are finite (the reference repeats an id in -inf slots),
    computed and elem exactly."""
    ops, pos, kw, perm = row_out_case(k)
    jkw = {a: None if v is None else jnp.asarray(v.numpy()) for a, v in kw.items()}
    ref = j_pruned_topk(*map(jnp.asarray, (ops["q"], ops["db"], ops["qp"], ops["lo"],
                                           ops["hi"])), 256, **jkw, k=k, bm=16, bn=32,
                        element_stats=True, interpret=True)
    got = pruned_topk(*pos, 256, **kw, k=k, bm=16, bn=32, element_stats=True,
                      splits=1, row_out=torch.from_numpy(perm))
    s_ref, i_ref = (np.empty_like(np.asarray(x)) for x in ref[:2])
    s_ref[perm], i_ref[perm] = np.asarray(ref[0]), np.asarray(ref[1])
    assert_topk_match((s_ref, i_ref, np.asarray(ref[2]), np.asarray(ref[3])),
                      [x.numpy() for x in got])


def test_pruned_topk_rejects_bad_row_out():
    _, pos, _, perm = row_out_case(7)
    call = dict(k=4, bm=16, bn=32)
    ro = torch.from_numpy(perm)
    with pytest.raises(ValueError, match="row_out has shape"):
        pruned_topk(*pos, 256, **call, row_out=ro[:-1])
    with pytest.raises(TypeError, match="row_out must be torch.int32"):
        pruned_topk(*pos, 256, **call, row_out=ro.long())
    for bad in (40, -1):
        with pytest.raises(ValueError, match="row_out holds rows outside"):
            pruned_topk(*pos, 256, **call, row_out=torch.where(ro == 3, bad, ro).int())
    order = torch.zeros(3, 8, dtype=torch.int32)
    order[1, 2] = 8
    with pytest.raises(ValueError, match="block_order holds tile ids"):
        pruned_topk(*pos, 256, **call, block_order=order)


@pytest.mark.parametrize("mt,nt,sms,ctas,want", [
    (79, 9247, 132, 2, 3),      # glove shape: 237 CTAs, one wave of 264
    (79, 9247, 132, 1, 3),      # one CTA per SM: 237 CTAs in 2 waves of 132
    (1, 9247, 132, 2, 230),     # one query tile: a wave within 15 %
    (1, 5, 132, 2, 5),          # never more splits than db tiles
    (264, 9247, 132, 2, 1),     # whole waves already
    (300, 9247, 132, 2, 4),     # 1,200 CTAs in 5 waves, not 300 in 2
])
def test_choose_splits(mt, nt, sms, ctas, want):
    s = choose_splits(mt, nt, sms, ctas)
    assert s == want
    slots = sms * ctas
    cost = [-(-mt * x // slots) / x for x in range(1, min(nt, slots) + 1)]
    assert cost[s - 1] <= 1.15 * min(cost)
    assert all(c > 1.15 * min(cost) for c in cost[:s - 1])


def test_choose_splits_rejects_empty():
    with pytest.raises(ValueError):
        choose_splits(0, 10, 132, 2)


def test_default_splits_is_one_on_cpu():
    assert default_splits(10_000, 1_183_616, 100, 16, bm=128, bn=128,
                          device="cpu") == 1
