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
from repro_torch.core.index import build_index, multipivot_block_cap  # noqa: E402
from repro_torch.kernels.bound_prune import (SELECT_MAX_N_PRE,  # noqa: E402
                                             block_bounds, block_bounds_plain,
                                             block_bounds_select,
                                             block_bounds_select_plain,
                                             sqrt_mismatches)
from repro_torch.kernels.cosine_topk import (_launch, _operands,  # noqa: E402
                                             default_splits, merge_splits,
                                             merge_splits_plain, pruned_topk,
                                             pruned_topk_plain, scatter_rows)
from repro_torch.kernels.ref import box_bound, query_interval  # noqa: E402
from repro_torch.search import backends as t_bk  # noqa: E402

#: the engines' fp32 guard on every bound test
MARGIN = 4e-7
#: how far the port's Eq. 13 bound may lie from the reference's where no
#: pivot similarity of the (query, block) pair exceeds NEAR_ONE in
#: magnitude.  The port bounds over the query's float32 neighbours and the
#: block's float64 interval rounded outward (an ulp or two wider each way,
#: at a slope of at most 22 at 0.999), with radicands (1 - s)(1 + s); the
#: reference over the float32 point and interval with 1 - s*s.  Nearer to
#: +-1 the two may differ by more, and the port is held to the float64
#: truth instead (eq13_fp64).
REF_SLACK = 1e-5
NEAR_ONE = 0.999


def eq13_fp64(qp, lo, hi):
    """``[m, nb]`` float64: the Eq. 13 interval bound at the point ``qp``
    over ``[lo, hi]``, min over pivots, from the angles (``cos`` of the
    least angle between ``arccos(qp)`` and ``arccos([lo, hi])``), -inf for
    an inverted interval: what the reference's formula computes in exact
    arithmetic."""
    qp, lo, hi = (np.asarray(x, dtype=np.float64) for x in (qp, lo, hi))
    inv = lo > hi
    ta = np.arccos(np.clip(qp, -1, 1))[:, None, :]
    tl = np.arccos(np.clip(np.where(inv, 0, lo), -1, 1))[None]
    th = np.arccos(np.clip(np.where(inv, 0, hi), -1, 1))[None]
    gap = np.maximum(0.0, np.maximum(th - ta, ta - tl))
    return np.where(inv[None], -np.inf, np.cos(gap)).min(-1)


def assert_bounds_against_reference(got, want, qp, lo, hi, cap=None):
    """The port's bound matrix ``got`` against the reference's ``want`` (all
    numpy): -inf at the same places; ``got + MARGIN`` at least the float64
    truth (:func:`eq13_fp64`, min'd with ``cap``) everywhere; within
    REF_SLACK of ``want`` where no pivot of the pair lies past NEAR_ONE."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    truth = eq13_fp64(qp, lo, hi)
    if cap is not None:
        truth = np.minimum(truth, np.asarray(cap, np.float64))
    fin = np.isfinite(truth)
    short = fin & (got + MARGIN < truth)
    assert not short.any(), f"bound + margin below the float64 truth by " \
        f"{float((truth - got - MARGIN)[short].max()):.3e} at {np.argwhere(short)[0]}"
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)

    def past(x):
        return np.isfinite(x) & (np.abs(x) > NEAR_ONE)

    near = (past(np.asarray(qp, np.float64)).any(1)[:, None]
            | (past(lo) | past(hi)).any(1)[None, :])
    away = fin & ~near
    np.testing.assert_allclose(got[away], want[away], atol=REF_SLACK, rtol=0)
    return int(away.sum())


def clustered(rng, n, d, n_centers=6, noise=0.07):
    """tests/conftest.py's corpus, repeated here: where another installed
    package is named ``tests``, it shadows this directory's imports."""
    c = rng.normal(size=(n_centers, d))
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    x = c[rng.integers(0, n_centers, n)] + noise * rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def scan_gaps(idx, qn, qp, k, *, prune=True, margin=MARGIN, warm_start=False,
              best_first=False, warm_start_blocks=None, n_pivots=0, tau0=None,
              ub_all=None, leaf_mask=None):
    """Replay the scan's decisions with its own operands: ``(blk_pruned,
    elem_pruned, block gaps [m, nb], elem gaps [m, n_valid_rows])``, where
    a gap is bound + margin - τ at the visit (a decision prunes where the
    gap is negative).  A plain loop over the same steps as scan_search."""
    m = qn.shape[0]
    nb, bs = idx.n_blocks, idx.block_size
    cap = multipivot_block_cap(idx, qn, n_pivots=n_pivots) if prune and n_pivots else None
    if ub_all is None:
        ub_all = block_bounds(qp, idx.dp_lo, idx.dp_hi, cap)
    elif cap is not None:
        ub_all = torch.minimum(ub_all, cap)
    if tau0 is None:
        tau0 = torch.full((m,), float("-inf"))
        if warm_start:
            tau0 = t_bk.bound_ranked_tau(idx, qn, ub_all, k, t_bk.prescan_blocks(
                k, bs, nb, warm_start_blocks))
    order = (torch.argsort(-ub_all.amax(0), stable=True) if best_first
             else torch.arange(nb))
    valid = idx.valid.reshape(nb, bs)
    a_lo, a_hi = (a[:, None, :] for a in query_interval(qp))
    top = (tau0 - 1e-6)[:, None].expand(m, k)
    blk_gap = torch.full((m, nb), float("inf"))
    elem_gap = []
    for b in order.tolist():
        tau = top[:, -1]
        if prune:
            blk_gap[:, b] = ub_all[:, b] + margin - tau
        if leaf_mask is not None:       # a caller's proof, not a decision
            blk_gap[:, b] = blk_gap[:, b].masked_fill(~leaf_mask[:, b], float("inf"))
        needed = (blk_gap[:, b] >= 0) & (leaf_mask[:, b] if leaf_mask is not None else True)
        rows = slice(b * bs, (b + 1) * bs)
        dpb = idx.dp[rows][None]
        eub = box_bound(a_lo, a_hi, dpb, dpb).amin(-1)
        elem_gap.append((eub + margin - tau[:, None])[:, valid[b]])
        scores = (qn @ idx.db[rows].T).masked_fill(~(needed[:, None] & valid[b][None]),
                                                   float("-inf"))
        top = torch.sort(torch.cat([top, scores], 1), dim=1, descending=True,
                         stable=True).values[:, :k]
    elem_gap = torch.cat(elem_gap, 1)
    blk_pruned = int((blk_gap < 0).sum()) + (0 if leaf_mask is None
                                             else int((~leaf_mask).sum()))
    return blk_pruned, int((elem_gap < 0).sum()), blk_gap, elem_gap


def near_decisions(gaps, margin=MARGIN) -> int:
    return int((gaps.abs() <= 2 * margin).sum())


def assert_same_counts(got, want, replay):
    """``got`` / ``want``: (blk_pruned, elem_pruned) of the port and the
    reference.  Equal, or apart by no more than the decisions within
    2·margin of τ (``replay``: a thunk giving :func:`scan_gaps`)."""
    if got == want:
        return
    blk, elem, blk_gap, elem_gap = replay()
    assert (blk, elem) == got, "the replay does not reproduce the port's counts"
    assert abs(got[0] - want[0]) <= near_decisions(blk_gap), (got, want)
    assert abs(got[1] - want[1]) <= near_decisions(elem_gap), (got, want)


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
    [-inf, -inf] (block 13, which is not inverted; the query's interval is
    [-2^-149, 2^-149], so the corner is -2^-149 * -inf = +inf, and the other
    pivots decide); an inverted pivot beside an infinite end (block 19);
    with ``nan_in_lo``, NaN in lo (block 7) and an inverted pivot beside a
    NaN end (block 17): NaN bounds for every query."""
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
        assert bool(torch.isnan(want[:, 7]).all() & torch.isnan(want[:, 17]).all())
        assert bool(torch.isfinite(want[20:30, 13]).all())
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
    assert int(clean.sum()) == (0 if nan_in_lo else 148)
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
    with pytest.raises(TypeError, match="float32 or bfloat16 db"):
        pruned_topk(pos[0], pos[1].half(), *pos[2:], 256, k=4, bm=8, bn=64)
    before = pruned_topk.launches
    s_bf, _, _, _ = pruned_topk(pos[0], pos[1].bfloat16(), *pos[2:], 256, k=4, bm=8, bn=64)
    assert pruned_topk.launches == before + 1 and s_bf.shape == (8, 4)
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
@pytest.mark.parametrize("splits", [1, "chosen"])
@pytest.mark.parametrize("shape", [(2048, 100, 300, 16), (896, 37, 200, 5)],
                         ids=["d100", "d37"])
def test_pruned_topk_kernel_bf16_db_matches_plain(cuda, shape, splits):
    """The bf16 db through the kernel (bf16 panels, widened in fma_panel)
    against the plain version over the same rows (check_topk: sims within
    1e-5, ids tie-aware), at D = 100 and at D = 37, which is not a multiple
    of the 34-column K-step; and within the reference's 2e-2 of the fp32
    brute force."""
    from chip_smoke import check_topk, topk_ok

    n, d, m, p = shape
    ops = topk_operands(n, d, m, 128, p, seed=31, holes=True)
    pos = [torch.from_numpy(ops[a]).to(cuda) for a in ("q", "db", "qp", "lo", "hi")]
    pos[1] = pos[1].bfloat16()
    if splits == "chosen":
        splits = default_splits(m, n, d, p, bm=128, bn=128, device=cuda)
    kw = optional_operands(ops, bm=128, bn=128, **OPTIONS["all"])
    kw = {a: None if v is None else torch.from_numpy(v).to(cuda) for a, v in kw.items()}
    kw.update(k=10, bm=128, bn=128, element_stats=True, splits=splits)
    args = (*pos, n)
    before = pruned_topk.launches
    got = pruned_topk(*args, **kw)
    assert pruned_topk.launches == before + 1
    r = check_topk(got, pruned_topk_plain(*args, **kw), args, kw, 1e-5, pruned_topk_plain)
    assert topk_ok(r, 1e-5), (splits, r)
    s_w, _ = cref.brute_force_knn(ops["q"], np.where(ops["valid"][:, None], ops["db"], 0), 10)
    np.testing.assert_allclose(got[0].cpu().numpy(), s_w, atol=2e-2)


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


@pytest.mark.cuda
def test_sharded_engine_on_cuda_runs_the_kernels_per_shard(cuda, tmp_path):
    """SearchEngine.build(db, mesh=...) on a one-rank CUDA mesh holding 4
    shards: each search call launches pruned_topk and block_bounds_select
    once per shard, block_bounds never (no scan), and equals brute force;
    a 4-shard index in this process without a mesh gives the same."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.distributed import build_sharded_index
    from repro_torch.search import SearchEngine

    rng = np.random.default_rng(23)
    db = clustered(rng, 20_000, 32, n_centers=8, noise=0.05)
    q = db[rng.integers(0, 20_000, 1_000)] + 0.03 * rng.normal(size=(1_000, 32))
    qn = cref.normalize(q).astype(np.float32)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        torch.cuda.set_device(0)
        mesh = DeviceMesh("cuda", [0], mesh_dim_names=("shard",))
        eng = SearchEngine.build(db, mesh=mesh, n_shards=4, n_pivots=16, block_size=128)
        plain = SearchEngine(build_sharded_index(db, 4, n_pivots=16, block_size=128),
                             device=cuda)
        assert eng.backend_name == "sharded" and eng.index.db.device.type == "cuda"
        for k in (1, 10, 100):
            before = (pruned_topk.launches, block_bounds_select.launches,
                      block_bounds.launches)
            sims, ids, st = eng.search(qn, k)
            after = (pruned_topk.launches, block_bounds_select.launches,
                     block_bounds.launches)
            assert tuple(a - b for a, b in zip(after, before)) == (4, 4, 0)
            s_b, i_b = cref.brute_force_knn(qn, db, k)
            np.testing.assert_allclose(sims.cpu().numpy(), s_b, atol=1e-5)
            assert_topk_sets_close(sims.cpu().numpy(), ids.cpu().numpy(),
                                   s_b.astype(np.float32), i_b.astype(np.int32), tol=1e-5)
            assert 0.0 < float(st.block_prune_frac) < 1.0
            assert float(st.tile_computed_frac) == 1.0 - float(st.block_prune_frac)
            s2, i2, _ = plain.search(qn, k)
            assert torch.equal(s2, sims) and torch.equal(i2, ids)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_sharded_tree_engine_on_cuda_runs_the_tree_kernels_per_shard(cuda, tmp_path):
    """SearchEngine.build(db, mesh=..., tree_shards=True) on a one-rank CUDA
    mesh holding 4 shards of 40 blocks (6 levels): per call and shard one
    pruned_topk launch (under gathered_topk) and tree_levels + 1
    block_bounds launches (the descent and the kept tiles' best-first
    order), no select kernel; past k = block_size the scan leaf stage:
    tree_levels block_bounds launches and no pruned_topk.  Every answer
    equals the brute force, the flat sharded engine (up to k = 128, its
    kernel's tile) and the same tree branch on the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.distributed import build_sharded_index
    from repro_torch.search import SearchEngine

    rng = np.random.default_rng(24)
    db = clustered(rng, 20_000, 32, n_centers=8, noise=0.05)
    q = db[rng.integers(0, 20_000, 1_000)] + 0.03 * rng.normal(size=(1_000, 32))
    qn = cref.normalize(q).astype(np.float32)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        torch.cuda.set_device(0)
        mesh = DeviceMesh("cuda", [0], mesh_dim_names=("shard",))
        eng = SearchEngine.build(db, mesh=mesh, n_shards=4, n_pivots=16, block_size=128,
                                 tree_shards=True)
        flat = SearchEngine(eng.index, mesh=mesh, tree_shards=False)
        on_cpu = SearchEngine(build_sharded_index(db, 4, n_pivots=16, block_size=128,
                                                  device="cpu"), tree_shards=True,
                              device="cpu")
        assert eng._tree_shards_enabled and eng.n_blocks == 40
        for k in (1, 10, 100, 200):
            before = (pruned_topk.launches, block_bounds_select.launches,
                      block_bounds.launches)
            sims, ids, st = eng.search(qn, k)
            torch.cuda.synchronize()
            seen = tuple(a - b for a, b in zip((pruned_topk.launches,
                                                block_bounds_select.launches,
                                                block_bounds.launches), before))
            levels = st.extras["tree_levels"]
            kernel_leaves = k <= 128
            assert levels == 6 and seen == (4 * kernel_leaves, 0,
                                             4 * (levels + kernel_leaves)), (k, seen)
            s_b, i_b = cref.brute_force_knn(qn, db, k)
            np.testing.assert_allclose(sims.cpu().numpy(), s_b, atol=1e-5)
            assert_topk_sets_close(sims.cpu().numpy(), ids.cpu().numpy(),
                                   s_b.astype(np.float32), i_b.astype(np.int32), tol=1e-5)
            assert (st.tile_computed_frac is not None) == kernel_leaves
            assert 0.0 < float(st.tree_prune_frac) < 1.0
            # the flat kernel path takes k up to its tile (128) only
            for other in (flat, on_cpu) if kernel_leaves else (on_cpu,):
                s2, i2, _ = other.search(qn, k)
                assert_topk_sets_close(sims.cpu().numpy(), ids.cpu().numpy(),
                                       s2.cpu().numpy(), i2.cpu().numpy(), tol=1e-5)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_sharded_online_on_cuda_matches_cpu(cuda, deep_corpus):
    """The same inserts (under live shard trees, then past every tail),
    deletes and a reoptimize through the sharded handle of a CPU engine and
    a CUDA engine over copies of one 4-shard index: ids and placements
    equal; row_ids, valid and db equal; dp, dp_min, dp_max, dp_lo and dp_hi
    within 2 ulp of 1; the widened shard trees equal build_shard_trees bit
    for bit on the card; results equal the float64 brute force over the
    live rows."""
    from repro_torch.core.distributed import build_sharded_index
    from repro_torch.search import SearchEngine, build_shard_trees

    db, q = deep_corpus
    rng = np.random.default_rng(32)
    idx = build_sharded_index(db[:19_900], 4, n_pivots=16, block_size=64, device="cpu")
    engines = [SearchEngine(idx.to(dev), tree_shards=True, device=dev)
               for dev in ("cpu", cuda)]
    for eng in engines:
        eng.search(q[:8], 10)                               # the trees build
    handles = [eng.online(auto_reoptimize=False) for eng in engines]
    live = {i: db[i] for i in range(19_900)}
    steps = [("insert", db[19_900:19_940]), ("delete", list(range(0, 640, 4))),
             ("insert", clustered(rng, 300, 32)), ("insert", clustered(rng, 500, 32)),
             ("reoptimize", None)]
    for op, arg in steps:
        out = [getattr(h, op)(*(() if arg is None else (arg,))) for h in handles]
        if op == "insert":
            assert out[0] == out[1]
            live.update(zip(out[0], arg))
        elif op == "delete":
            for i in arg:
                del live[i]
        assert handles[0]._id_pos == handles[1]._id_pos
        cpu, gpu = (eng.index for eng in engines)
        for f in ("row_ids", "valid", "db"):
            assert torch.equal(getattr(cpu, f), getattr(gpu, f).cpu()), (op, f)
        for f in ("dp", "dp_min", "dp_max", "dp_lo", "dp_hi"):
            torch.testing.assert_close(getattr(gpu, f).cpu(), getattr(cpu, f),
                                       atol=2 * 1.2e-7, rtol=0)
        if engines[1]._shard_tree is not None:
            rebuilt = build_shard_trees(gpu)
            assert all(torch.equal(a, b) for a, b in zip(engines[1]._shard_tree, rebuilt))
        sims, ids, st = engines[1].search(q, 10)
        live_brute_check(sims, ids, live, q, 10)
        assert st.generation == handles[1].generation


def descent_near_decisions(eng, qn, qp, k) -> int:
    """(query, node) decisions of the tree engine's descent whose gap
    (bound + margin - τ₀) lies within 2·margin: where the descent of two
    devices, whose τ₀ seeds differ by fp32 rounding, may cut differently."""
    from repro_torch.search import tree as t_tree

    tree = eng._tree_index
    tau0 = t_tree.tree_warm_start(tree, qn, qp, k, t_bk.prescan_blocks(
        k, tree.block_size, tree.n_blocks, eng.warm_start_blocks))
    near = 0
    for level in range(1, tree.n_levels + 1):
        base = 1 << level
        ub = block_bounds(qp, tree.node_lo[base:2 * base], tree.node_hi[base:2 * base])
        near += near_decisions((ub + MARGIN - tau0[:, None])[:, tree.node_valid[base:2 * base]])
    return near


@pytest.fixture(scope="module")
def deep_corpus():
    """20,000 clustered rows at d = 32 in blocks of 64: 313 blocks, a tree
    of 9 levels; 300 queries near rows."""
    rng = np.random.default_rng(22)
    db = clustered(rng, 20_000, 32, n_centers=8, noise=0.05)
    q = db[rng.integers(0, 20_000, 300)] + 0.03 * rng.normal(size=(300, 32))
    return db, cref.normalize(q).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [dict(), dict(n_pivots=8, best_first=False)],
                         ids=["default", "joint_cap_natural_order"])
@pytest.mark.parametrize("backend", ["scan", "tree"])
def test_scan_and_tree_on_cuda_match_cpu(cuda, deep_corpus, backend, knobs,
                                         monkeypatch):
    """The scan and tree engines on the card against the same engines on the
    CPU, on the same prepared queries (so the bounds agree bit for bit and
    only the score matmuls differ): result sets equal, the stats equal up to
    the decisions within 2·margin of τ; and the launches: a tree call runs
    block_bounds once per level, a scan call once, and no other kernel."""
    from repro_torch.search import SearchEngine

    db, q = deep_corpus
    idx = build_index(db, n_pivots=16, block_size=64, device="cpu")
    # the tree's scan leaf stage by name: on a CUDA index "auto" is the kernel's
    if backend == "tree":
        knobs = dict(knobs, leaf_eval="scan")
    cpu = SearchEngine(idx, backend=backend, device="cpu", **knobs)
    s_c, i_c, st_c = cpu.search(q, 10, element_stats=True)
    qn, qp = t_bk.prep_queries(idx, q)
    monkeypatch.setattr(t_bk, "prep_queries", lambda index, queries: (
        qn.to(index.device), qp.to(index.device)))
    gpu = SearchEngine(idx, backend=backend, device=cuda, **knobs)
    kernels = (block_bounds, block_bounds_select, pruned_topk)
    for kern in kernels:
        kern.launches = 0
    s_g, i_g, st_g = gpu.search(q, 10, element_stats=True)
    torch.cuda.synchronize(cuda)
    launches = [kern.launches for kern in kernels]
    levels = st_c.extras.get("tree_levels", 1)
    assert launches == [levels, 0, 0] and (backend == "scan" or levels == 9)
    np.testing.assert_allclose(s_g.cpu().numpy(), s_c.numpy(), atol=1e-6)
    assert_topk_sets_close(s_g.cpu().numpy(), i_g.cpu().numpy(), s_c.numpy(),
                           i_c.numpy(), tol=1e-6)
    s_b, i_b = cref.brute_force_knn(q, db, 10)
    assert_topk_sets_close(s_g.cpu().numpy(), i_g.cpu().numpy(), s_b.astype(np.float32),
                           i_b.astype(np.int32), tol=1e-5)
    m, nb = q.shape[0], idx.n_blocks
    count = {name: (round(float(st.block_prune_frac) * m * nb),
                    round(float(st.elem_prune_frac) * m * cpu.n_valid))
             for name, st in (("gpu", st_g), ("cpu", st_c))}
    if backend == "tree":
        fracs = [(float(st.tree_prune_frac), float(st.tree_node_eval_frac))
                 for st in (st_g, st_c)]
        assert fracs[0] == fracs[1] or descent_near_decisions(cpu, qn, qp, 10) > 0, fracs

    def replay():
        from repro_torch.search import tree as t_tree

        if backend == "scan":
            return scan_gaps(idx, qn, qp, 10, warm_start=True,
                             best_first=cpu.best_first, n_pivots=cpu.n_pivots)
        tau0, alive, leaf_ub, _ = t_tree._seed_and_descend(
            cpu._tree_index, qn, qp, 10, warm_start=True, warm_start_blocks=None,
            margin=MARGIN)
        if cpu.n_pivots:
            leaf_ub = torch.minimum(leaf_ub, multipivot_block_cap(
                idx, qn, n_pivots=cpu.n_pivots))
        return scan_gaps(idx, qn, qp, 10, best_first=cpu.best_first, tau0=tau0,
                         ub_all=leaf_ub, leaf_mask=alive)

    assert_same_counts(count["gpu"], count["cpu"], replay)


# ---------------------------------------------------------------------------
# the bound near +-1, and the tree's kernel leaf stage
# ---------------------------------------------------------------------------

#: pivot similarities at and next to the ends of [-1, 1], zeros, the
#: smallest denormals and a middle value
EDGES = np.array([1, -1, 1 - 1e-3, -(1 - 1e-3), 1 - 1e-5, -(1 - 1e-5),
                  np.nextafter(np.float32(1), np.float32(0)),
                  np.nextafter(np.float32(-1), np.float32(0)), 0.0, -0.0,
                  1e-45, -1e-45, 0.5], np.float32)


def near_pm1_operands(m, nb, p, seed):
    """bound_operands with a third of qp and of the interval ends drawn from
    EDGES: intervals that end at or next to +-1, queries at or next to
    them, touching intervals (lo == hi), and the empty-block sentinels."""
    qp, lo, hi, cap = bound_operands(m, nb, p, np.float32, seed)
    rng = np.random.default_rng(seed + 1)

    def mix(x):
        pick = rng.uniform(size=x.shape) < 1 / 3
        return np.where(pick, rng.choice(EDGES, size=x.shape), x).astype(np.float32)

    a, b = mix(lo), mix(hi)
    sentinel = np.isinf(lo)
    lo = np.where(sentinel, lo, np.minimum(a, b))
    hi = np.where(sentinel, hi, np.maximum(a, b))
    return mix(qp), lo.astype(np.float32), hi.astype(np.float32), cap


@pytest.mark.cuda
@pytest.mark.parametrize("p", [16, 24])
def test_bound_kernels_match_plain_near_pm1(cuda, p):
    """block_bounds and block_bounds_select against their plain versions
    bit for bit where the query interval and the block ends reach +-1, 0
    and the denormals (every path of the kernels: fast, general, sentinel);
    the bounds dominate the float64 truth by the margin."""
    qp, lo, hi, cap = near_pm1_operands(300, 700, p, seed=p)
    args = [torch.from_numpy(a).to(cuda) for a in (qp, lo, hi, cap)]
    for c in (None, args[3]):
        got, want = block_bounds(*args[:3], c), block_bounds_plain(*args[:3], c)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
        truth = eq13_fp64(qp, lo, hi)
        if c is not None:
            truth = np.minimum(truth, cap)
        fin = np.isfinite(truth)
        assert (got.cpu().numpy()[fin] + MARGIN >= truth[fin]).all()
        for bm in (8, 128):
            assert_select_equal(block_bounds_select(*args[:3], c, bm=bm, n_pre=3),
                                block_bounds_select_plain(*args[:3], c, bm=bm, n_pre=3))


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, "chosen"])
def test_pruned_topk_kernel_matches_plain_near_pm1(cuda, splits):
    """The skip test and the element bound with a third of qp at EDGES:
    the kernel's decisions equal the plain version's (flips only within
    2·margin of τ), as do its results."""
    ops = topk_operands(2048, 100, 300, 128, 16, seed=13)
    rng = np.random.default_rng(13)
    pick = rng.uniform(size=ops["qp"].shape) < 1 / 3
    ops["qp"] = np.where(pick, rng.choice(EDGES, size=pick.shape),
                         ops["qp"]).astype(np.float32)
    run_kernel_and_plain(cuda, ops, splits, k=10, bm=128, bn=128, tau=True,
                         elem=True)


@pytest.fixture(scope="module")
def leaf_corpus():
    """4,096 clustered rows at d = 32 in blocks of 128 (32 blocks, 5 levels)
    with a tenth of the rows tombstoned, 300 queries near rows."""
    rng = np.random.default_rng(23)
    db = clustered(rng, 4096, 32, n_centers=8, noise=0.05)
    q = db[rng.integers(0, 4096, 300)] + 0.03 * rng.normal(size=(300, 32))
    idx = build_index(db, n_pivots=16, block_size=128, device="cpu")
    holes = torch.from_numpy(rng.uniform(size=idx.valid.shape[0]) > 0.1)
    return db, cref.normalize(q).astype(np.float32), idx._replace(valid=idx.valid & holes)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 128], ids=["k10", "k_block"])
def test_gathered_topk_on_cuda_matches_its_plain_route(cuda, leaf_corpus, k):
    """gathered_topk on CUDA tensors (the block_bounds and pruned_topk
    kernels, one launch each) against the same call on CPU tensors (their
    plain versions): sims within 1e-5, id sets equal up to near-ties, and
    the card's computed tiles a superset of the single pass's (its splits
    each keep their own τ)."""
    from repro_torch.kernels.leaf_gather import gathered_topk
    from repro_torch.search import tree as t_tree

    _, q, idx = leaf_corpus
    qn, qp = t_bk.prep_queries(idx, q)
    tau0 = t_tree.tree_warm_start(t_tree.build_tree(idx), qn, qp, k, 1)
    keep = torch.arange(1, idx.n_blocks, 2, dtype=torch.int32)
    want = gathered_topk(idx, keep, qn, qp, tau0, k=k)
    gpu = idx.to(cuda)
    before = (block_bounds.launches, pruned_topk.launches, block_bounds_select.launches)
    got = gathered_topk(gpu, keep.to(cuda), qn.to(cuda), qp.to(cuda), tau0.to(cuda), k=k)
    torch.cuda.synchronize(cuda)
    assert (block_bounds.launches, pruned_topk.launches, block_bounds_select.launches) == (
        before[0] + 1, before[1] + 1, before[2])
    s_g, i_g, c_g = (x.cpu().numpy() for x in got[:3])
    s_w, i_w, c_w = (x.numpy() for x in want[:3])
    assert_topk_sets_close(s_g, i_g, s_w, i_w, tol=1e-5)
    assert (c_g >= c_w).all()
    assert np.isin(i_g[i_g >= 0] // 128, keep.numpy()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [dict(), dict(n_pivots=8, best_first=False)],
                         ids=["default", "joint_cap_natural_order"])
def test_tree_kernel_leaves_on_cuda_match_cpu(cuda, deep_corpus, knobs, monkeypatch):
    """The tree engine with the kernel leaf stage on the card against the
    same engine on the CPU, on the same prepared queries: result sets equal
    each other and the float64 brute force; one pruned_topk launch per call,
    block_bounds once per tree level and, with best_first, once for the
    kept tiles' order, block_bounds_select never; the descent's fractions
    equal up to
    decisions within 2·margin of τ₀."""
    from repro_torch.search import SearchEngine

    db, q = deep_corpus
    idx = build_index(db, n_pivots=16, block_size=64, device="cpu")
    cpu = SearchEngine(idx, backend="tree", leaf_eval="kernel", device="cpu", **knobs)
    s_c, i_c, st_c = cpu.search(q, 10)
    qn, qp = t_bk.prep_queries(idx, q)
    monkeypatch.setattr(t_bk, "prep_queries", lambda index, queries: (
        qn.to(index.device), qp.to(index.device)))
    gpu = SearchEngine(idx, backend="tree", device=cuda, **knobs)
    assert gpu.leaf_eval == "auto"              # the kernel on a CUDA index
    kernels = (block_bounds, block_bounds_select, pruned_topk)
    for kern in kernels:
        kern.launches = 0
    s_g, i_g, st_g = gpu.search(q, 10)
    torch.cuda.synchronize(cuda)
    levels = st_g.extras["tree_levels"]
    order = 1 if gpu.best_first else 0
    assert [kern.launches for kern in kernels] == [levels + order, 0, 1] and levels == 9
    assert_topk_sets_close(s_g.cpu().numpy(), i_g.cpu().numpy(), s_c.numpy(),
                           i_c.numpy(), tol=1e-6)
    s_b, i_b = cref.brute_force_knn(q, db, 10)
    assert_topk_sets_close(s_g.cpu().numpy(), i_g.cpu().numpy(), s_b.astype(np.float32),
                           i_b.astype(np.int32), tol=1e-5)
    fracs = [(float(st.tree_prune_frac), float(st.tree_node_eval_frac))
             for st in (st_g, st_c)]
    assert fracs[0] == fracs[1] or descent_near_decisions(cpu, qn, qp, 10) > 0, fracs
    assert 0 < st_g.extras["n_keep"] <= idx.n_blocks


# ---------------------------------------------------------------------------
# online mutation and serving on the card
# ---------------------------------------------------------------------------

def live_brute_check(sims, ids, live, q, k, tol=1e-5):
    """Result sets of the float64 brute force over exactly the live rows
    (``live``: id -> row), tie-aware; every returned id live."""
    live_ids = np.array(sorted(live))
    rows = np.stack([live[i] for i in live_ids])
    s_b, i_b = cref.brute_force_knn(q, rows, k)
    s, i = sims.cpu().numpy(), ids.cpu().numpy()
    assert np.isin(i, live_ids).all(), "a returned id is not live"
    np.testing.assert_allclose(s, s_b, atol=tol)
    assert_topk_sets_close(s, i, s_b.astype(np.float32), live_ids[i_b].astype(np.int32),
                           tol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["kernel", "tree"])
def test_online_mutations_on_cuda_match_cpu(cuda, deep_corpus, backend):
    """The same inserts (into free slots under a live tree, then appending
    blocks), deletes and a reoptimize on a CPU engine and a CUDA engine
    over copies of one index: ids, row_ids, valid and db equal; dp, dp_min,
    dp_max, dp_lo and dp_hi within 2 ulp of 1 (float32 and float64
    products on two devices); the widened tree equals build_tree bit for
    bit on the card; results equal the float64 brute force over the live
    rows."""
    from repro_torch.search import SearchEngine, build_tree

    db, q = deep_corpus
    rng = np.random.default_rng(31)
    idx = build_index(db[:19_950], n_pivots=16, block_size=64, device="cpu")
    engines = [SearchEngine(idx.to(dev), backend=backend, device=dev)
               for dev in ("cpu", cuda)]
    for eng in engines:
        eng.search(q[:8], 10)                               # the tree builds
    handles = [eng.online(auto_reoptimize=False) for eng in engines]
    live = {i: db[i] for i in range(19_950)}
    steps = [("insert", db[19_950:19_990]), ("delete", list(range(0, 640, 4))),
             ("insert", clustered(rng, 300, 32)), ("insert", clustered(rng, 500, 32)),
             ("reoptimize", None)]
    for op, arg in steps:
        out = [getattr(h, op)(*(() if arg is None else (arg,))) for h in handles]
        if op == "insert":
            assert out[0] == out[1]
            live.update(zip(out[0], arg))
        elif op == "delete":
            for i in arg:
                del live[i]
        cpu, gpu = (eng.index for eng in engines)
        if op != "reoptimize":
            for f in ("row_ids", "valid", "db"):
                assert torch.equal(getattr(cpu, f), getattr(gpu, f).cpu()), (op, f)
            for f in ("dp", "dp_min", "dp_max", "dp_lo", "dp_hi"):
                torch.testing.assert_close(getattr(gpu, f).cpu(), getattr(cpu, f),
                                           atol=2 * 1.2e-7, rtol=0)
        if engines[1]._tree_index is not None:
            rebuilt = build_tree(gpu)
            assert all(torch.equal(a, b) for a, b in zip(engines[1]._tree_index[1:],
                                                          rebuilt[1:]))
        sims, ids, st = engines[1].search(q, 10)
        live_brute_check(sims, ids, live, q, 10)
        assert st.generation == handles[1].generation


@pytest.mark.cuda
def test_batcher_on_cuda_answers_equal_engine_search(cuda, deep_corpus):
    """ContinuousBatcher over a kernel engine on the card: microbatches of
    up to 32; every answer finite and equal to the engine's own search of
    the same queries."""
    import asyncio

    from repro_torch.search import SearchEngine
    from repro_torch.serve import ContinuousBatcher

    db, q = deep_corpus
    eng = SearchEngine.build(db, n_pivots=16, block_size=128, device=cuda)
    batcher = ContinuousBatcher(eng, k=10, max_batch=32, max_wait_ms=1.0)

    async def main():
        try:
            return await asyncio.gather(*(batcher.submit(x) for x in q[:100]))
        finally:
            await batcher.close()

    answers = asyncio.run(asyncio.wait_for(main(), timeout=60))
    want_s, want_i, _ = eng.search(q[:100], 10)
    s = np.stack([a[0] for a in answers])
    i = np.stack([a[1] for a in answers])
    assert np.isfinite(s).all()
    np.testing.assert_allclose(s, want_s.cpu().numpy(), atol=1e-6)
    assert_topk_sets_close(s, i, want_s.cpu().numpy(), want_i.cpu().numpy(), tol=1e-6)
    assert batcher.n_queries == 100 and batcher.n_batches >= 4


# ---------------------------------------------------------------------------
# the serving and data entry points take CUDA tensors
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_knn_datastore_takes_cuda_tensors(cuda):
    """KNNDatastore's values, from_pairs' embeddings and add_pairs' next
    tokens as CUDA tensors: the same store, ids and lookups as from the same
    numpy arrays; a store over a bare index takes CUDA values too."""
    from repro_torch.serve import KNNDatastore

    rng = np.random.default_rng(41)
    emb, toks = clustered(rng, 3000, 32), rng.integers(0, 500, 3000)
    new, new_toks = clustered(rng, 64, 32), rng.integers(0, 500, 64)
    stores = []
    for conv in (lambda a: a, lambda a: torch.from_numpy(a).to(cuda)):
        ds = KNNDatastore.from_pairs(conv(emb), conv(toks), 500, k=8, n_pivots=8,
                                     block_size=64, device=cuda)
        stores.append((ds, ds.add_pairs(conv(new), conv(new_toks))))
    (a, ids_a), (b, ids_b) = stores
    assert ids_a == ids_b == list(range(3000, 3064))
    assert b.values.device.type == "cuda" and torch.equal(a.values, b.values)
    assert torch.equal(a.index.db, b.index.db)
    q = torch.from_numpy(new).to(cuda)
    got = b.lookup(q)
    for x, y in zip(a.lookup(q), got):
        assert torch.equal(x, y)
    assert torch.equal(got[2][:, 0].cpu(), torch.tensor(ids_b, dtype=torch.int32))
    assert torch.equal(got[1][:, 0].cpu(), torch.from_numpy(new_toks).int())
    bare = KNNDatastore(b.index, b.values, 500, k=8)
    assert bare.engine.device.type == "cuda" and torch.equal(bare.values, b.values)


@pytest.mark.cuda
def test_batcher_submit_takes_cuda_tensors(cuda, deep_corpus):
    """ContinuousBatcher.submit of CUDA rows, with a numpy row in among
    them: every answer equals the engine's own search."""
    import asyncio

    from repro_torch.search import SearchEngine
    from repro_torch.serve import ContinuousBatcher

    db, q = deep_corpus
    eng = SearchEngine.build(db, n_pivots=16, block_size=128, device=cuda)
    rows = [torch.from_numpy(x).to(cuda) for x in q[:40]]
    rows[7] = q[7]
    batcher = ContinuousBatcher(eng, k=10, max_batch=16, max_wait_ms=1.0)

    async def main():
        try:
            return await asyncio.gather(*(batcher.submit(x) for x in rows))
        finally:
            await batcher.close()

    answers = asyncio.run(asyncio.wait_for(main(), timeout=60))
    want_s, want_i, _ = eng.search(q[:40], 10)
    s = np.stack([a[0] for a in answers])
    i = np.stack([a[1] for a in answers])
    np.testing.assert_allclose(s, want_s.cpu().numpy(), atol=1e-6)
    assert_topk_sets_close(s, i, want_s.cpu().numpy(), want_i.cpu().numpy(), tol=1e-6)
    assert batcher.n_queries == 40


@pytest.mark.cuda
def test_find_near_duplicates_takes_cuda_tensors(cuda):
    """CUDA embeddings give the pairs the same numpy embeddings give, and
    every planted near-duplicate pair."""
    from repro_torch.data.dedup import embed_tokens, find_near_duplicates

    rng = np.random.default_rng(43)
    tokens = rng.integers(0, 5000, (4000, 48))
    tokens[-200:] = tokens[:200]
    tokens[-200:, 0] = rng.integers(0, 5000, 200)
    emb = embed_tokens(tokens, dim=128)
    want, _ = find_near_duplicates(emb, threshold=0.95, device=cuda)
    got, stats = find_near_duplicates(torch.from_numpy(emb).to(cuda), threshold=0.95)
    assert got == want
    assert {(i, 3800 + i) for i in range(200)} <= set(got)
    assert stats.backend == "kernel"


@pytest.mark.cuda
def test_from_corpus_and_engine_on_cuda_match_cpu(cuda):
    """The smoke tinyllama-1.1b (float32) on the card and on the CPU with
    the same weights: from_corpus over the same tokens (CUDA hidden states
    straight into the store) gives keys within 1e-5 by row id and the same
    value table; greedy decoding with kNN on gives the CPU's tokens, and
    the launcher runs on the card."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import lm, model_fns
    from repro_torch.serve import KNNDatastore
    from repro_torch.serve.engine import Engine

    cfg = smoke_config("tinyllama-1.1b")
    fns = model_fns(cfg)
    cpu = lm.lm_init(0, cfg, device="cpu")
    gpu = lm.lm_init(0, cfg, device="cpu").to(cuda)
    rng = np.random.default_rng(44)
    corpus = [rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32) for _ in range(4)]
    prompt = rng.integers(0, cfg.vocab, (3, 16)).astype(np.int32)
    out = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, cuda)):
        batches = [{"tokens": torch.from_numpy(t).to(dev)} for t in corpus]
        ds = KNNDatastore.from_corpus(fns, model, batches, cfg.vocab, k=8, n_pivots=8,
                                      block_size=64, device=dev)
        eng = Engine(fns, model, max_seq=32, knn=ds)
        cache, clen, _ = eng.prefill({"tokens": torch.from_numpy(prompt).to(dev)})
        out[name] = ds, eng.decode(cache, clen, prompt[:, -1:], 8)[0].cpu()
    (ds_c, toks_c), (ds_g, toks_g) = out["cpu"], out["gpu"]
    assert ds_g.engine.backend_name == "kernel" and ds_g.values.device.type == "cuda"
    keys = []
    for idx in (ds_c.index, ds_g.index.to("cpu")):
        ids = idx.row_ids[idx.valid].long()
        k = torch.zeros(len(ids), idx.db.shape[1])
        k[ids] = idx.db[idx.valid]
        keys.append(k)
    torch.testing.assert_close(keys[1], keys[0], atol=1e-5, rtol=0)
    assert torch.equal(ds_c.values, ds_g.values.cpu())
    assert torch.equal(toks_c, toks_g)
    toks = launch_serve.main(["--smoke", "--knn", "--search-backend", "kernel",
                              "--requests", "2", "--prompt-len", "12", "--gen", "4"])
    assert toks.device.type == "cuda" and toks.shape == (2, 4)


#: one arch of each model family beyond the "attn" LM
FAMILY_ARCHS = ["granite-moe-1b-a400m", "zamba2-1.2b", "rwkv6-1.6b", "internvl2-1b",
                "whisper-small"]
#: float32 hidden states after the final norm (entries of order 1), TF32
#: off: the CPU's and the card's matmuls sum in other orders (~1e-6 a
#: layer, 4 to 6 layers)
FAMILY_FP32_ATOL = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_model_family_on_cuda_matches_cpu_and_decodes_deterministically(cuda, arch):
    """Each family's smoke model with the same weights on the CPU and on
    the card.  The cache-free forward's hidden states: in float32 within
    FAMILY_FP32_ATOL; in bf16 activations, the card no farther from the CPU
    than bf16 itself moves the CPU's result (max |card bf16 - CPU bf16| <=
    max |CPU bf16 - CPU float32|).  Then on the card in bf16, two greedy
    decodes from one prefilled cache give the same tokens (recurrent states
    are replaced, not written in place)."""
    import copy

    from repro_torch.configs import smoke_config
    from repro_torch.models import model_fns, synthetic_batch
    from repro_torch.serve.engine import Engine

    hidden = {}
    for dtype in ("float32", "bfloat16"):
        cfg = smoke_config(arch).replace(dtype=dtype)
        fns = model_fns(cfg)
        cpu = fns.init(0, device="cpu")
        gpu = copy.deepcopy(cpu).to(cuda)
        batch = synthetic_batch(cfg, 2, 24, seed=3, device="cpu")
        on_card = {n: v.to(cuda) for n, v in batch.items()}
        with torch.inference_mode():
            hidden[dtype] = (fns.forward(cpu, batch)[0].float(),
                             fns.forward(gpu, on_card)[0].float().cpu())
    (c32, g32), (c16, g16) = hidden["float32"], hidden["bfloat16"]
    assert torch.isfinite(g32).all() and torch.isfinite(g16).all()
    torch.testing.assert_close(g32, c32, atol=FAMILY_FP32_ATOL, rtol=0)
    bf16_error = float((c16 - c32).abs().max())
    assert float((g16 - c16).abs().max()) <= bf16_error, bf16_error
    eng = Engine(fns, gpu, max_seq=fns.loss_offset(batch) + 40)
    cache, clen, _ = eng.prefill(on_card)
    t1, _ = eng.decode(cache, clen, on_card["tokens"][:, -1:], 8)
    t2, _ = eng.decode(cache, clen, on_card["tokens"][:, -1:], 8)
    assert t1.device.type == "cuda" and torch.equal(t1, t2)
