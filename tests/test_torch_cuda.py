"""The hand-written CUDA kernels against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a GPU; on the card run
``python -m pytest -m cuda tests/test_torch_cuda.py``.  This file imports no
JAX, so it runs where only PyTorch is installed; it also holds the operand
builders that tests/test_torch_kernels.py feeds to the Pallas kernels.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ref as cref  # noqa: E402
from repro_torch.kernels.bound_prune import (SELECT_MAX_N_PRE,  # noqa: E402
                                             block_bounds, block_bounds_plain,
                                             block_bounds_select,
                                             block_bounds_select_plain,
                                             sqrt_mismatches)
from repro_torch.kernels.cosine_topk import (_launch, _operands,  # noqa: E402
                                             default_splits, merge_splits,
                                             merge_splits_plain, pruned_topk,
                                             pruned_topk_plain, scatter_rows)


def clustered(rng, n, d, n_centers=6, noise=0.07):
    """tests/conftest.py's corpus, repeated here: where another installed
    package is named ``tests``, it shadows this directory's imports."""
    c = rng.normal(size=(n_centers, d))
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    x = c[rng.integers(0, n_centers, n)] + noise * rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def bound_operands(m, nb, p, dtype, seed):
    """The test_bound_prune_sweep operands, plus two empty-block sentinels
    and a cap that is tighter than the interval bound in places."""
    rng = np.random.default_rng(seed)
    qp = np.clip(rng.normal(0, 0.5, size=(m, p)), -1, 1).astype(dtype)
    lo = np.clip(rng.uniform(-1, 0.5, size=(nb, p)), -1, 1).astype(dtype)
    hi = np.clip(lo + rng.uniform(0, 0.5, size=(nb, p)), -1, 1).astype(dtype)
    lo[nb // 2], hi[nb // 2] = np.inf, -np.inf
    lo[-1, 0], hi[-1, 0] = np.inf, -np.inf
    cap = rng.uniform(0.5, 1.2, size=(m, nb)).astype(np.float32)
    return qp, lo, hi, cap


def select_operands(m, nb, p, seed):
    """bound_operands plus deliberate ties and rows with no finite bound:
    block 3's intervals repeated in the middle of the second chunk of 128
    blocks and at the last block, and the first 50 queries at the centre of
    those intervals, so each bounds at 1 there (ties inside a chunk and
    across chunks, where the lower block must win); with the cap, rows 1
    and m - 2 bound at -inf everywhere (the first n_pre blocks win)."""
    qp, lo, hi, cap = bound_operands(m, nb, p, np.float32, seed)
    for b in (min(nb - 2, 192), nb - 1):
        lo[b], hi[b] = lo[3], hi[3]
    qp[:50] = (lo[3] + hi[3]) / 2
    cap[[1, m - 2]] = -np.inf
    return qp, lo, hi, cap


def nan_operands(m, nb, p, seed, *, nan_in_lo=True):
    """bound_operands with the inputs that make NaN or infinities: NaN in
    qp (row 5) and in the cap (row 9, block 11); qp = 0 against an interval
    [-inf, -inf] (block 13, which is not inverted: 0 * -inf is NaN at both
    ends); an inverted pivot beside an infinite end (block 19); with
    ``nan_in_lo``, NaN in lo (block 7) and an inverted pivot beside a NaN
    end (block 17): NaN bounds for every query."""
    qp, lo, hi, cap = bound_operands(m, nb, p, np.float32, seed)
    qp[5, 2] = np.nan
    cap[9, 11] = np.nan
    qp[20:30, 0] = 0.0
    lo[13, 0] = hi[13, 0] = -np.inf
    lo[19, 0], hi[19, 0], lo[19, 1] = np.inf, -np.inf, -np.inf
    if nan_in_lo:
        lo[7, 1] = np.nan
        lo[17, 0], hi[17, 0], lo[17, 2] = np.inf, -np.inf, np.nan
    return qp, lo, hi, cap


def topk_operands(n, d, m, bn, p, seed, *, holes=False):
    """Normalized db/queries (queries near db rows, so τ rises and tiles
    prune), pivot sims and tile intervals over the valid rows, and the
    optional operands: a τ seed that is a true lower bound, a valid
    per-(query, tile) cap, dp.  The τ
    seed sits below the 32nd best score: a true lower bound for k <= 32."""
    rng = np.random.default_rng(seed)
    db = clustered(rng, n, d, n_centers=4, noise=0.05)
    q = db[rng.choice(n, m, replace=False)] + 0.02 * rng.normal(size=(m, d))
    q = cref.normalize(q).astype(np.float32)
    piv = db[rng.choice(n, p, replace=False)]
    dp = (db @ piv.T).astype(np.float32)
    # rows grouped by nearest pivot, as the index reorders them: coherent
    # db tiles have tight intervals, so the bound prunes
    perm = np.lexsort((-dp.max(1), dp.argmax(1)))
    db, dp = db[perm], dp[perm]
    qp = (q @ piv.T).astype(np.float32)
    qperm = np.lexsort((-qp.max(1), qp.argmax(1)))  # coherent query tiles
    q, qp = q[qperm], qp[qperm]
    valid = np.ones(n, bool)
    if holes:
        valid[rng.choice(n, n // 8, replace=False)] = False
    nt = n // bn
    dpv = np.where(valid[:, None], dp, np.nan).reshape(nt, bn, p)
    lo, hi = np.nanmin(dpv, 1).astype(np.float32), np.nanmax(dpv, 1).astype(np.float32)
    scores = np.where(valid[None, :], q.astype(np.float64) @ db.T, -np.inf)
    return dict(q=q, db=db, qp=qp, dp=dp, lo=lo, hi=hi, valid=valid,
                tau=(np.sort(scores, 1)[:, -32] - 1e-3).astype(np.float32),
                cap=(scores.reshape(m, nt, bn).max(2) + 1e-3).astype(np.float32))


def optional_operands(ops, *, bm, bn, tau=False, order=False, cap=False,
                      elem=False, holes=False, prune=True):
    """The keyword operands an option set turns on (numpy); ``order`` is a
    seeded random visit order per query tile."""
    mt, nt = -(-ops["q"].shape[0] // bm), ops["db"].shape[0] // bn
    rng = np.random.default_rng(mt * nt)
    return dict(
        tau_init=ops["tau"] if tau else None,
        block_order=(np.stack([rng.permutation(nt) for _ in range(mt)])
                     .astype(np.int32) if order else None),
        dp=ops["dp"] if elem else None,
        ub_cap=ops["cap"] if cap else None,
        row_valid=ops["valid"] if holes else None)


def assert_topk_match(ref, got, *, atol=1e-6, computed=True):
    """Sims match at ``atol``; ids are equal as sets where sims are finite;
    computed/elem identical; slots that stay -inf carry id -1."""
    s_r, i_r, c_r, e_r = ref
    s_g, i_g, c_g, e_g = got
    np.testing.assert_array_equal(np.isneginf(s_g), np.isneginf(s_r))
    fin = np.isfinite(s_r)
    np.testing.assert_allclose(s_g[fin], s_r[fin], atol=atol)
    for row in range(s_r.shape[0]):
        assert set(i_g[row][fin[row]]) == set(i_r[row][fin[row]]), row
    assert (i_g[~fin] == -1).all()
    if computed:
        np.testing.assert_array_equal(c_g, c_r)
    if e_r is not None:
        np.testing.assert_array_equal(e_g, e_r)


def assert_topk_sets_close(s_g, i_g, s_w, i_w, *, tol):
    """Two top-k results agree up to fp32 summation order: the same -inf
    slots (with id -1 in ``i_g``), finite sims within ``tol``, and where a
    row's id sets differ, every id in one and not the other scores within
    ``tol`` of that row's k-th best (a near-tie)."""
    np.testing.assert_array_equal(np.isneginf(s_g), np.isneginf(s_w))
    fin = np.isfinite(s_w)
    np.testing.assert_allclose(s_g[fin], s_w[fin], atol=tol, rtol=0)
    assert (i_g[~fin] == -1).all()
    for r in range(s_w.shape[0]):
        a, b = set(i_g[r][fin[r]]), set(i_w[r][fin[r]])
        if a == b:
            continue
        score = dict(zip(i_w[r], s_w[r]))
        score.update(zip(i_g[r], s_g[r]))
        kth = min(s_g[r][fin[r]].min(), s_w[r][fin[r]].min())
        assert all(abs(score[i] - kth) <= tol for i in a ^ b), (r, a ^ b)


OPTIONS = {
    "plain": {},
    "tau": dict(tau=True),
    "order": dict(order=True),
    "cap": dict(cap=True),
    "elem": dict(elem=True),
    "holes": dict(holes=True),
    "noprune": dict(prune=False),
    "all": dict(tau=True, order=True, cap=True, elem=True, holes=True),
}



@pytest.mark.cuda
@pytest.mark.parametrize("with_cap", [False, True])
def test_block_bounds_kernel_matches_plain(cuda, with_cap):
    qp, lo, hi, cap = bound_operands(300, 700, 16, np.float32, seed=7)
    args = [torch.from_numpy(a).to(cuda) for a in (qp, lo, hi)]
    c = torch.from_numpy(cap).to(cuda) if with_cap else None
    before = block_bounds.launches
    got = block_bounds(*args, c)
    assert block_bounds.launches == before + 1
    want = block_bounds_plain(*args, c)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [3, 8, 12, 24, 64])
def test_block_bounds_kernel_pivot_counts_match_plain(cuda, p):
    """P <= 8 and <= 16 keep the column in registers (12 with 4 padding
    pivots); 24 and 64 in shared memory."""
    qp, lo, hi, cap = bound_operands(150, 300, p, np.float32, seed=p)
    args = [torch.from_numpy(a).to(cuda) for a in (qp, lo, hi, cap)]
    for c in (None, args[3]):
        torch.testing.assert_close(block_bounds(*args[:3], c),
                                   block_bounds_plain(*args[:3], c), atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [16, 24])
def test_block_bounds_kernel_nan_and_inf_match_plain(cuda, p):
    """NaN wherever the plain version has NaN, every other value equal."""
    args = [torch.from_numpy(a).to(cuda) for a in nan_operands(150, 300, p, seed=p)]
    for c in (None, args[3]):
        got, want = block_bounds(*args[:3], c), block_bounds_plain(*args[:3], c)
        # row 5 is NaN but where every pivot is inverted (block 150)
        assert int(torch.isnan(want[5]).sum()) == 299
        assert bool(torch.isnan(want[20:30, 13]).all() & torch.isnan(want[:, 7]).all())
        torch.testing.assert_close(got, want, atol=0, rtol=0, equal_nan=True)


def assert_select_equal(got, want, rows=slice(None)):
    """tile_max equal (NaN where the plain version has NaN) and best equal
    index for index on ``rows``."""
    torch.testing.assert_close(got[0], want[0], atol=0, rtol=0, equal_nan=True)
    assert got[1].dtype == torch.int64 and got[1].shape == want[1].shape
    assert torch.equal(got[1][rows], want[1][rows])


@pytest.mark.cuda
@pytest.mark.parametrize("with_cap", [False, True], ids=["nocap", "cap"])
@pytest.mark.parametrize("bm", [8, 128])
@pytest.mark.parametrize("n_pre", [1, 3, 8, 9, 128])
def test_block_bounds_select_kernel_matches_plain(cuda, n_pre, bm, with_cap):
    """300 queries (ragged at both bm), 700 blocks (a ragged last chunk of
    60), empty-block sentinels, ties inside and across chunks, and with the
    cap two rows that bound at -inf everywhere."""
    qp, lo, hi, cap = select_operands(300, 700, 16, seed=n_pre * bm)
    args = [torch.from_numpy(a).to(cuda) for a in (qp, lo, hi)]
    c = torch.from_numpy(cap).to(cuda) if with_cap else None
    before = block_bounds_select.launches, block_bounds.launches
    got = block_bounds_select(*args, c, bm=bm, n_pre=n_pre)
    assert (block_bounds_select.launches, block_bounds.launches) == (
        before[0] + 1, before[1])
    want = block_bounds_select_plain(*args, c, bm=bm, n_pre=n_pre)
    assert_select_equal(got, want)
    if with_cap:
        assert got[1][1].tolist() == list(range(n_pre))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [5, 24])
def test_block_bounds_select_kernel_pivot_counts_match_plain(cuda, p):
    qp, lo, hi, cap = select_operands(200, 260, p, seed=p)
    args = [torch.from_numpy(a).to(cuda) for a in (qp, lo, hi, cap)]
    assert_select_equal(block_bounds_select(*args, bm=64, n_pre=2),
                        block_bounds_select_plain(*args, bm=64, n_pre=2))


@pytest.mark.cuda
@pytest.mark.parametrize("nan_in_lo", [False, True], ids=["qp_cap", "qp_lo_cap"])
def test_block_bounds_select_kernel_nan_rows(cuda, nan_in_lo):
    """tile_max carries NaN where the plain version does.  best equals the
    plain version on every row whose bounds hold no NaN; on the others it
    ranks NaN first, lower block first (NaN in lo: every row)."""
    args = [torch.from_numpy(a).to(cuda)
            for a in nan_operands(150, 300, 16, seed=3, nan_in_lo=nan_in_lo)]
    got = block_bounds_select(*args, bm=32, n_pre=4)
    want = block_bounds_select_plain(*args, bm=32, n_pre=4)
    nan = torch.isnan(block_bounds_plain(*args))
    clean = ~nan.any(1)
    assert int(clean.sum()) == (0 if nan_in_lo else 138)
    assert_select_equal(got, want, rows=clean)
    for r in torch.nonzero(~clean)[:, 0].tolist():
        first = torch.nonzero(nan[r])[:4, 0].tolist()
        row = got[1][r].tolist()
        assert row[:len(first)] == first and len(set(row)) == 4, (r, row, first)
        assert all(0 <= b < 300 for b in row)


@pytest.mark.cuda
def test_block_bounds_select_kernel_rejects_bad_operands(cuda):
    qp, lo, hi, cap = (torch.from_numpy(a).to(cuda)
                       for a in bound_operands(20, 30, 4, np.float32, seed=1))
    with pytest.raises(TypeError, match="qp"):
        block_bounds_select(qp.double(), lo, hi, bm=8, n_pre=1)
    with pytest.raises(ValueError, match="ub_cap"):
        block_bounds_select(qp, lo, hi, cap[:, :5], bm=8, n_pre=1)
    with pytest.raises(ValueError, match="dp_min"):
        block_bounds_select(qp, lo.cpu(), hi, bm=8, n_pre=1)
    with pytest.raises(ValueError, match="contiguous"):
        block_bounds_select(qp, lo.t().contiguous().t(), hi, bm=8, n_pre=1)
    for n_pre in (0, 31):
        with pytest.raises(ValueError, match="n_pre"):
            block_bounds_select(qp, lo, hi, bm=8, n_pre=n_pre)
    qp, lo, hi, _ = (torch.from_numpy(a).to(cuda)
                     for a in bound_operands(20, 200, 4, np.float32, seed=1))
    with pytest.raises(ValueError, match="n_pre"):
        block_bounds_select(qp, lo, hi, bm=8, n_pre=SELECT_MAX_N_PRE + 1)
    with pytest.raises(ValueError, match="bm=129"):
        block_bounds_select(qp, lo, hi, bm=129, n_pre=1)


@pytest.mark.cuda
def test_branch_free_sqrt_equals_fsqrt_rn_everywhere(cuda):
    """The kernels' square root of a product of radicands equals the card's
    IEEE __fsqrt_rn for every float of its domain, and NaN gives NaN."""
    assert sqrt_mismatches(cuda) == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("opt", list(OPTIONS))
def test_pruned_topk_kernel_matches_plain(cuda, opt):
    o = OPTIONS[opt]
    ops = topk_operands(2048, 100, 300, 128, 16, seed=8,
                        holes=o.get("holes", False))
    pos = [torch.from_numpy(ops[a]).to(cuda) for a in ("q", "db", "qp", "lo", "hi")]
    kw = optional_operands(ops, bm=128, bn=128, **o)
    kw = {a: None if v is None else torch.from_numpy(v).to(cuda) for a, v in kw.items()}
    common = dict(k=10, bm=128, bn=128, prune=o.get("prune", True),
                  element_stats=o.get("elem", False))
    before = pruned_topk.launches
    got = [None if x is None else x.cpu().numpy()
           for x in pruned_topk(*pos, 2048, **kw, **common)]
    assert pruned_topk.launches == before + 1
    want = [None if x is None else x.cpu().numpy()
            for x in pruned_topk_plain(*pos, 2048, **kw, **common)]
    # fp32 sums in another order than cuBLAS: sims to 1e-5
    assert_topk_match(want, got, atol=1e-5)


@pytest.mark.cuda
def test_pruned_topk_kernel_k_equals_bn(cuda):
    ops = topk_operands(1024, 256, 70, 256, 8, seed=9, holes=True)
    pos = [torch.from_numpy(ops[a]).to(cuda) for a in ("q", "db", "qp", "lo", "hi")]
    rv = torch.from_numpy(ops["valid"]).to(cuda)
    kw = dict(row_valid=rv, k=256, bm=64, bn=256)
    got = [x.cpu().numpy() for x in pruned_topk(*pos, 1024, **kw)[:3]]
    want = [x.cpu().numpy() for x in pruned_topk_plain(*pos, 1024, **kw)[:3]]
    assert_topk_match(want + [None], got + [None], atol=1e-5)


@pytest.mark.cuda
def test_cuda_wrappers_reject_wrong_dtype(cuda):
    ops = topk_operands(256, 16, 8, 64, 4, seed=10)
    pos = [torch.from_numpy(ops[a]).to(cuda) for a in ("q", "db", "qp", "lo", "hi")]
    with pytest.raises(TypeError, match="float32 db"):
        pruned_topk(pos[0], pos[1].bfloat16(), *pos[2:], 256, k=4, bm=8, bn=64)
    with pytest.raises(TypeError, match="qn"):
        pruned_topk(pos[0].double(), *pos[1:], 256, k=4, bm=8, bn=64)
    with pytest.raises(TypeError, match="qp"):
        block_bounds(pos[2].double(), pos[3], pos[4])
    row_out = torch.arange(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="row_out"):
        pruned_topk(*pos, 256, k=4, bm=8, bn=64, row_out=row_out.long())
    for bad in (8, -1):
        with pytest.raises(ValueError, match="row_out holds rows outside"):
            pruned_topk(*pos, 256, k=4, bm=8, bn=64,
                        row_out=torch.where(row_out == 3, bad, row_out).int())


def run_kernel_and_plain(cuda, ops, splits, *, k, bm, bn, **o):
    """pruned_topk's kernel and plain version at the same ``splits`` ("chosen":
    the card's default), held together by chip_smoke's check_topk: sims
    within 1e-5, ids tie-aware, computed/elem equal or differing only
    where the plain version's decision gaps lie within 2·margin of τ."""
    from chip_smoke import check_topk, topk_ok

    n, d = ops["db"].shape
    m, p = ops["qp"].shape
    if splits == "chosen":
        splits = default_splits(m, n, d, p, bm=bm, bn=bn, device=cuda)
    pos = [torch.from_numpy(ops[a]).to(cuda) for a in ("q", "db", "qp", "lo", "hi")]
    kw = optional_operands(ops, bm=bm, bn=bn, **o)
    kw = {a: None if v is None else torch.from_numpy(v).to(cuda) for a, v in kw.items()}
    kw.update(k=k, bm=bm, bn=bn, prune=o.get("prune", True),
              element_stats=o.get("elem", False), splits=splits)
    args = (*pos, n)
    before = (pruned_topk.launches, merge_splits.launches)
    got = pruned_topk(*args, **kw)
    # one launch at any splits: the merge is the kernel's epilogue
    assert pruned_topk.launches == before[0] + 1
    assert merge_splits.launches == before[1]
    r = check_topk(got, pruned_topk_plain(*args, **kw), args, kw, 1e-5,
                   pruned_topk_plain)
    assert topk_ok(r, 1e-5), (splits, r)
    return splits, got


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 3, "chosen"])
@pytest.mark.parametrize("opt", list(OPTIONS))
def test_pruned_topk_kernel_splits_match_plain(cuda, opt, splits):
    o = OPTIONS[opt]
    ops = topk_operands(2048, 100, 300, 128, 16, seed=8,
                        holes=o.get("holes", False))
    run_kernel_and_plain(cuda, ops, splits, k=10, bm=128, bn=128, **o)


SMALL_CASES = {
    # D = 768: Q streams through the ring beside the db rows
    "d768": (dict(n=2048, d=768, m=300, bn=128, p=16), dict(k=10, bm=128),
             OPTIONS["all"]),
    # one query tile: the chosen splits approach nt
    "m50": (dict(n=2048, d=100, m=50, bn=128, p=16), dict(k=10, bm=128),
            dict(tau=True, order=True)),
    # k = bn over two 128-row sub-tiles per db tile
    "k=bn": (dict(n=1024, d=256, m=70, bn=256, p=8), dict(k=256, bm=64),
             dict(holes=True)),
    # D % 4 != 0: 4-byte copies; 7 db tiles, so 3 splits are ragged
    "d37": (dict(n=896, d=37, m=200, bn=128, p=5), dict(k=5, bm=128),
            dict(tau=True, cap=True, holes=True)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 3, "chosen"])
@pytest.mark.parametrize("case", list(SMALL_CASES))
def test_pruned_topk_kernel_small_cases(cuda, case, splits):
    shape, kk, o = SMALL_CASES[case]
    ops = topk_operands(shape["n"], shape["d"], shape["m"], shape["bn"],
                        shape["p"], seed=12, holes=o.get("holes", False))
    run_kernel_and_plain(cuda, ops, splits, bn=shape["bn"], **kk, **o)


@pytest.mark.cuda
def test_merge_splits_kernel_matches_plain(cuda):
    """Random descending lists with many equal scores and -inf tails."""
    rng = np.random.default_rng(13)
    s, m, k = 5, 300, 12
    vals = np.round(rng.uniform(size=(s, m, k)), 1).astype(np.float32)
    vals = -np.sort(-vals, axis=2)
    vals[:, :, 9:] = -np.inf
    ids = rng.integers(0, 10**6, size=(s, m, k)).astype(np.int32)
    ids[:, :, 9:] = -1
    part_s, part_i = torch.from_numpy(vals).to(cuda), torch.from_numpy(ids).to(cuda)
    before = merge_splits.launches
    got = merge_splits(part_s, part_i)
    assert merge_splits.launches == before + 1
    want = merge_splits_plain(part_s, part_i)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the fused merge: pruned_topk's epilogue against merge_splits_plain
# ---------------------------------------------------------------------------

FUSED_N, FUSED_D, FUSED_P, FUSED_BN = 2048, 32, 8, 128


@functools.lru_cache(maxsize=None)
def fused_operands(m):
    """m queries over 2,048 rows in 16 db tiles of 128, numpy.  Tiles 0 and
    1 hold the same rows, so at splits >= 2 (natural order: tile j goes to
    split j % S) equal scores meet from two splits; query 0 sits next to
    row 5, so its top-k holds such ties.  Row order by nearest pivot, so
    the bound prunes."""
    rng = np.random.default_rng(m)
    db = clustered(rng, FUSED_N, FUSED_D, n_centers=4, noise=0.05)
    piv = db[rng.choice(FUSED_N, FUSED_P, replace=False)]
    dp = db @ piv.T
    db = db[np.lexsort((-dp.max(1), dp.argmax(1)))]
    db[FUSED_BN:2 * FUSED_BN] = db[:FUSED_BN]
    q = db[rng.integers(0, FUSED_N, m)] + 0.02 * rng.normal(size=(m, FUSED_D))
    q[0] = db[5] + 1e-3 * rng.normal(size=FUSED_D)
    q = cref.normalize(q).astype(np.float32)
    dp = (db @ piv.T).astype(np.float32).reshape(-1, FUSED_BN, FUSED_P)
    return (q, db, (q @ piv.T).astype(np.float32), dp.min(1), dp.max(1))


def run_fused(cuda, m, splits, k, *, row_valid=None, seed=0):
    """pruned_topk's fused launch, with row_out the identity and a seeded
    permutation, each against merge_splits_plain of its own partial lists
    scattered by row_out: equal bit for bit, sims and ids.  Returns the
    splits, k and the identity run's outputs."""
    pos = [torch.from_numpy(a).to(cuda) for a in fused_operands(m)]
    nt = FUSED_N // FUSED_BN
    if splits == "chosen":
        splits = default_splits(m, FUSED_N, FUSED_D, FUSED_P, bm=128, bn=FUSED_BN,
                                device=cuda)
    splits = nt if splits == "nt" else splits
    k = FUSED_BN if k == "bn" else k
    perm = np.random.default_rng(seed).permutation(m).astype(np.int32)
    runs = []
    for row_out in (torch.arange(m, dtype=torch.int32, device=cuda),
                    torch.from_numpy(perm).to(cuda)):
        ops, kw = _operands(*pos, FUSED_N, row_valid=row_valid, k=k, bm=128,
                            bn=FUSED_BN, splits=splits, row_out=row_out)
        before = (pruned_topk.launches, merge_splits.launches)
        out = _launch(*ops, **kw)
        assert (pruned_topk.launches, merge_splits.launches) == (before[0] + 1,
                                                                 before[1])
        sims, idx = out.sims, out.idx
        want_s, want_i = merge_splits_plain(out.part_s, out.part_i)
        assert torch.equal(sims, scatter_rows(want_s, row_out)), (m, splits, k)
        assert torch.equal(idx, scatter_rows(want_i, row_out)), (m, splits, k)
        assert bool((idx[torch.isneginf(sims)] == -1).all())
        runs.append(out)
    return splits, k, runs[0]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 129, 10_000])
@pytest.mark.parametrize("k", [1, 10, 100, "bn"])
@pytest.mark.parametrize("splits", [1, 2, 3, "chosen", "nt"])
def test_fused_merge_equals_plain_merge_of_its_lists(cuda, splits, k, m):
    """Every splits from 1 to nt = 16, k from 1 to bn = 128, one row (a
    lone query tile), 129 rows (a ragged second tile) and 10,000 rows."""
    splits, k, out = run_fused(cuda, m, splits, k, seed=m)
    if splits >= 2 and k >= 2:
        # query 0's best score is row 5's and its copy's, row 133, which
        # different splits hold: the lower split's copy comes first
        s0, i0 = out.sims[0, :2].tolist(), out.idx[0, :2].tolist()
        assert s0[0] == s0[1] and i0 == [5, 5 + FUSED_BN], (s0, i0)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 3, "nt"])
def test_fused_merge_minus_inf_rows(cuda, splits):
    """No valid row: every row is -inf with id -1.  50 valid rows at
    k = 100: each row's last 50 slots are."""
    for valid, k in ((0, 10), (50, 100)):
        rv = torch.arange(FUSED_N, device=cuda) < valid
        *_, out = run_fused(cuda, 129, splits, k, row_valid=rv)
        sims, idx = out.sims, out.idx
        assert bool(torch.isneginf(sims[:, valid:]).all())
        assert bool((idx[:, valid:] == -1).all())
        assert bool(torch.isfinite(sims[:, :valid]).all())


@pytest.mark.cuda
def test_fused_merge_repeats_and_streams(cuda):
    """The arrival counters start at zero in every call: 50 launches in a
    row, and two launches on two streams at once, give identical
    results."""
    pos = [torch.from_numpy(a).to(cuda) for a in fused_operands(10_000)]
    perm = torch.from_numpy(
        np.random.default_rng(3).permutation(10_000).astype(np.int32)).to(cuda)
    kw = dict(k=10, bm=128, bn=FUSED_BN, splits=3, row_out=perm)
    first = pruned_topk(*pos, FUSED_N, **kw)
    for _ in range(50):
        again = pruned_topk(*pos, FUSED_N, **kw)
        assert all(torch.equal(a, b) for a, b in zip(first[:3], again[:3]))
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize(cuda)
    outs = []
    for st in streams:
        with torch.cuda.stream(st):
            outs.append(pruned_topk(*pos, FUSED_N, **kw))
    torch.cuda.synchronize(cuda)
    for out in outs:
        assert all(torch.equal(a, b) for a, b in zip(first[:3], out[:3]))


@pytest.mark.cuda
def test_engine_search_launches_no_merge_splits(cuda):
    """A SearchEngine search on the card launches pruned_topk once and
    merge_splits never, at more than one split, and equals brute force."""
    from repro_torch.search import SearchEngine

    rng = np.random.default_rng(21)
    db = clustered(rng, 20_000, 32, n_centers=8, noise=0.05)
    q = db[rng.integers(0, 20_000, 1_000)] + 0.03 * rng.normal(size=(1_000, 32))
    eng = SearchEngine.build(db, n_pivots=16, block_size=128, device=cuda)
    before = (pruned_topk.launches, merge_splits.launches)
    sims, ids, _ = eng.search(q.astype(np.float32), 10)
    assert (pruned_topk.launches, merge_splits.launches) == (before[0] + 1, before[1])
    qn = cref.normalize(q).astype(np.float32)
    s_b, i_b = cref.brute_force_knn(qn, db, 10)
    np.testing.assert_allclose(sims.cpu().numpy(), s_b, atol=1e-5)
    assert_topk_sets_close(sims.cpu().numpy(), ids.cpu().numpy(),
                           s_b.astype(np.float32), i_b.astype(np.int32), tol=1e-5)
