"""The hand-written CUDA kernels against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a GPU; on the card run
``python -m pytest -m cuda tests/test_torch_cuda.py``.  This file imports no
JAX, so it runs where only PyTorch is installed; it also holds the operand
builders that tests/test_torch_kernels.py feeds to the Pallas kernels.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ref as cref  # noqa: E402
from repro_torch.kernels.bound_prune import (block_bounds,  # noqa: E402
                                             block_bounds_plain)
from repro_torch.kernels.cosine_topk import (pruned_topk,  # noqa: E402
                                             pruned_topk_plain)


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
