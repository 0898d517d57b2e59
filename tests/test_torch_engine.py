"""repro_torch.search.SearchEngine against repro.search.SearchEngine.

Both packages search the identical index (the reference's, carried over
with ``index_from_reference``), on the CPU: the port runs its kernels'
plain versions, the reference runs Pallas in interpret mode.  Result sets
must equal each other and the fp64 brute force, and the pruning stats must
agree.  Also: the port's own build, the guards (no JAX import anywhere in
the port, no silent CPU fallback) and the brute backend.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.index import build_index as j_build_index  # noqa: E402
from repro.search import SearchEngine as JEngine  # noqa: E402
from repro.search import defaults as j_defaults  # noqa: E402
from repro_torch.core import ref  # noqa: E402
from repro_torch.core.index import build_index, index_from_reference  # noqa: E402
from repro_torch.search import SearchEngine, auto_backend  # noqa: E402
from repro_torch.search import backends  # noqa: E402
from repro_torch.search import defaults as t_defaults  # noqa: E402
from tests.conftest import clustered  # noqa: E402
from tests.test_torch_pivots_index import assert_same_build, fields  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N, D, M = 2048, 32, 48
BM = 16            # several query tiles, so whole tiles can skip


def make_corpus(kind: str, seed: int = 0):
    """Datastore and queries near datastore rows (the kNN-LM / dedup regime,
    where τ rises and tiles prune)."""
    rng = np.random.default_rng(seed)
    if kind == "clustered":
        db = clustered(rng, N, D, n_centers=8, noise=0.05)
    else:
        db = rng.normal(size=(N, D)).astype(np.float32)
    q = db[rng.choice(N, M, replace=False)] + 0.03 * rng.normal(size=(M, D))
    return db, ref.normalize(q).astype(np.float32)


@pytest.fixture(scope="module", params=["clustered", "uniform"])
def shared(request):
    db, q = make_corpus(request.param)
    cache = {}

    def index(block_size):
        if block_size not in cache:
            cache[block_size] = j_build_index(jnp.asarray(db), n_pivots=16,
                                              block_size=block_size)
        return cache[block_size]

    return request.param, db, q, index


def assert_same_results(s_j, i_j, s_t, i_t, db, q, k):
    s_j, i_j = np.asarray(s_j), np.asarray(i_j)
    s_t, i_t = s_t.numpy(), i_t.numpy()
    np.testing.assert_allclose(s_t, s_j, atol=1e-6)
    np.testing.assert_array_equal(np.sort(i_t, 1), np.sort(i_j, 1))
    sref, iref = ref.brute_force_knn(q, db, k)
    np.testing.assert_allclose(s_t, sref, atol=3e-5)
    np.testing.assert_array_equal(np.sort(i_t, 1), np.sort(iref, 1))


# (k, index block size, kernel tile bn, extra engine knobs): k = 130
# exceeds the index block, so τ seeding gathers several index blocks per
# kernel tile, and warm_start_blocks=2 widens the prescan to two tiles
CASES = {
    "k1": (1, 128, None, {}),
    "k10": (10, 128, None, {}),
    "k130": (130, 64, 256, {}),
    "k130_wide_prescan": (130, 64, 256, dict(warm_start_blocks=2)),
    "k10_joint_cap": (10, 128, None, dict(n_pivots=8)),
    "k10_elem_stats": (10, 128, None, dict(element_stats=True)),
    "k10_natural_order": (10, 128, None, dict(best_first=False,
                                              warm_start=False)),
    # prescans on both sides of block_bounds_select's limit (8 tiles)
    "k10_prescan8": (10, 128, None, dict(warm_start_blocks=8)),
    "k10_prescan9": (10, 128, None, dict(warm_start_blocks=9)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_engine_matches_reference(shared, case):
    kind, db, q, index = shared
    k, bs, bn, knobs = CASES[case]
    j_idx = index(bs)
    j_eng = JEngine(j_idx, backend="kernel", interpret=True, bm=BM, bn=bn,
                    **knobs)
    t_eng = SearchEngine(index_from_reference(fields(j_idx), "cpu"),
                         backend="kernel", bm=BM, bn=bn, device="cpu", **knobs)
    assert (t_eng.best_first, t_eng.n_pivots, t_eng.warm_start_blocks) == (
        j_eng.best_first, j_eng.n_pivots, j_eng.warm_start_blocks)
    s_j, i_j, st_j = j_eng.search(jnp.asarray(q), k)
    s_t, i_t, st_t = t_eng.search(q, k)
    assert_same_results(s_j, i_j, s_t, i_t, db, q, k)
    for f in ("block_prune_frac", "tile_computed_frac", "elem_prune_frac"):
        a, b = st_j[f], st_t[f]
        assert (a is None) == (b is None), f
        if a is not None:
            assert abs(float(a) - float(b)) < 1e-6, (f, float(a), float(b))
    assert st_t.retraces is None and st_t.backend == "kernel"
    assert st_t.n_pivots == st_j.n_pivots and st_t.k == k
    if kind == "clustered" and case == "k10":
        assert float(st_t.block_prune_frac) > 0.2        # the bound engages


@pytest.mark.parametrize("sort_queries", [True, False], ids=["sorted", "unsorted"])
def test_kernel_engine_query_sort_matches_reference(shared, sort_queries):
    """With and without the query sort, the kernel backend equals the JAX
    package's, row for row, on queries that the sort moves across query
    tiles: pruned_topk writes each row back to its query (row_out=perm)
    where the reference gathers by argsort(perm)."""
    _, db, q, index = shared
    j_idx = index(128)
    idx = index_from_reference(fields(j_idx), "cpu")
    _, qp = backends.prep_queries(idx, torch.from_numpy(q))
    perm = backends.query_sort_perm(qp)
    assert bool((perm // BM != torch.arange(M) // BM).any())
    j_eng = JEngine(j_idx, backend="kernel", interpret=True, bm=BM,
                    sort_queries=sort_queries)
    t_eng = SearchEngine(idx, backend="kernel", bm=BM, device="cpu",
                         sort_queries=sort_queries)
    s_j, i_j, st_j = j_eng.search(jnp.asarray(q), 10)
    s_t, i_t, st_t = t_eng.search(q, 10)
    assert_same_results(s_j, i_j, s_t, i_t, db, q, 10)
    assert abs(float(st_j["tile_computed_frac"]) - float(st_t["tile_computed_frac"])) < 1e-6


@pytest.mark.parametrize("n_pivots", [0, 8], ids=["eq13", "joint_cap"])
@pytest.mark.parametrize("blocks", [None, 8, 9], ids=["prescan1", "prescan8", "prescan9"])
def test_kernel_inputs_select_route_equals_matrix_route(shared, blocks, n_pivots,
                                                        monkeypatch):
    """kernel_inputs through block_bounds_select (a prescan of up to 8
    tiles) or block_bounds and a sort (9) hands pruned_topk the same
    arguments, tau_init and block_order included, as the route it
    replaced: the whole bound matrix, its argsort and a padded copy of it
    (chip_smoke.matrix_route)."""
    from chip_smoke import kernel_inputs_by_route, kernel_inputs_equal, matrix_route

    _, _, q, index = shared
    idx = index_from_reference(fields(index(128)), "cpu")
    qn, qp = backends.prep_queries(idx, torch.from_numpy(q))
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(backends, "block_bounds_select",
                        spy("select", backends.block_bounds_select))
    monkeypatch.setattr(backends, "block_bounds", spy("matrix", backends.block_bounds))
    kw = dict(bm=BM, warm_start=True, best_first=True, warm_start_blocks=blocks,
              n_pivots=n_pivots)
    new = backends.kernel_inputs(idx, qn, qp, 10, **kw)
    assert calls == (["matrix"] if blocks == 9 else ["select"])
    old = kernel_inputs_by_route(backends.kernel_inputs, matrix_route, idx, qn, qp,
                                 10, **kw)
    assert kernel_inputs_equal(new, old)
    args, kwargs, _ = new
    assert kwargs["tau_init"].shape == (M,) and kwargs["block_order"].shape == (
        -(-M // BM), args[3].shape[0])
    assert (kwargs["ub_cap"] is None) == (n_pivots == 0)


def test_kernel_engine_prune_off_computes_everything(shared):
    _, db, q, index = shared
    t_eng = SearchEngine(index_from_reference(fields(index(128)), "cpu"),
                         backend="kernel", device="cpu")
    s, i, st = t_eng.search(q, 5, prune=False)
    assert float(st.tile_computed_frac) == 1.0
    sref, iref = ref.brute_force_knn(q, db, 5)
    np.testing.assert_array_equal(np.sort(i.numpy(), 1), np.sort(iref, 1))


def test_brute_engine_matches_reference(shared):
    _, db, q, index = shared
    j_eng = JEngine(index(128), backend="brute")
    t_eng = SearchEngine(index_from_reference(fields(index(128)), "cpu"),
                         backend="brute", device="cpu")
    s_j, i_j, _ = j_eng.search(jnp.asarray(q), 12, element_stats=True)
    s_t, i_t, st = t_eng.search(q, 12, element_stats=True)
    assert_same_results(s_j, i_j, s_t, i_t, db, q, 12)
    assert (st.block_prune_frac, st.elem_prune_frac, st.n_pivots) == (0.0, 0.0, None)


def test_engine_build_matches_reference_build():
    db, q = make_corpus("clustered", seed=3)
    t_eng = SearchEngine.build(db, n_pivots=16, block_size=128, device="cpu")
    j_idx = j_build_index(jnp.asarray(db), n_pivots=16, block_size=128)
    assert_same_build(fields(j_idx), fields(t_eng.index))
    # 16 blocks on a CPU index: the reference's choice off the TPU
    assert t_eng.backend_name == "scan" and t_eng.device.type == "cpu"
    s, i, _ = t_eng.search(q, 10)
    sref, iref = ref.brute_force_knn(q, db, 10)
    np.testing.assert_array_equal(np.sort(i.numpy(), 1), np.sort(iref, 1))


def test_k_past_valid_rows_pads_minus_one():
    rng = np.random.default_rng(4)
    db = ref.normalize(rng.normal(size=(100, 16))).astype(np.float32)
    q = db[:3]
    for backend, k in [("brute", 130), ("kernel", 110)]:
        eng = SearchEngine.build(db, n_pivots=8, block_size=32, backend=backend,
                                 device="cpu")
        s, i, _ = eng.search(q, k)
        s, i = s.numpy(), i.numpy()
        assert s.shape == (3, k)
        assert (i[:, 100:] == -1).all() and np.isneginf(s[:, 100:]).all()
        sref, iref = ref.brute_force_knn(q, db, 100)
        np.testing.assert_array_equal(np.sort(i[:, :100], 1), np.sort(iref, 1))


def test_auto_backend_and_defaults():
    rng = np.random.default_rng(5)
    small = build_index(rng.normal(size=(200, 8)), n_pivots=4, device="cpu")
    big = build_index(rng.normal(size=(600, 8)), n_pivots=4, device="cpu")
    # a CPU index follows the reference's rule off the TPU: scan below 256
    # blocks (600 rows make 5 of 128); a CUDA index keeps kernel
    assert auto_backend(small) == "brute" and auto_backend(big) == "scan"
    with pytest.raises(ValueError, match="leaf_eval"):
        SearchEngine(big, backend="tree", leaf_eval="pallas", device="cpu")
    assert SearchEngine(big, backend="tree", device="cpu").leaf_eval == "auto"
    # a shard-stacked index is the sharded backend's, and only its (the
    # reference's two guards)
    stacked = small._replace(db=small.db[None])
    assert auto_backend(stacked) == "sharded"
    with pytest.raises(ValueError, match="sharded"):
        SearchEngine(stacked, backend="scan", device="cpu")
    with pytest.raises(ValueError, match="shard-stacked"):
        SearchEngine(big, backend="sharded", device="cpu")
    assert t_defaults.REGIME_WIDTH_THRESHOLD == j_defaults.REGIME_WIDTH_THRESHOLD
    for knob, v in t_defaults.FALLBACK_DEFAULTS.items():
        assert j_defaults.FALLBACK_DEFAULTS[knob] == v
    for kind in ("clustered", "uniform"):
        db, _ = make_corpus(kind, seed=6)
        j_idx = j_build_index(jnp.asarray(db), n_pivots=16, block_size=128)
        assert t_defaults.detect_regime(
            index_from_reference(fields(j_idx), "cpu")) == j_defaults.detect_regime(j_idx)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "repro")


def port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", port_files(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path.name, node.lineno, name)


def test_port_modules_load_no_jax_and_no_reference():
    """Importing every module of repro_torch (the model, serving and launch
    modules included) and chip_smoke.py in a fresh interpreter loads
    neither jax nor repro: the AST scan above misses imports made through
    another module."""
    import os
    import subprocess
    import sys
    code = ("import importlib, pkgutil, sys\n"
            "import repro_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.')]\n"
            "for name in names: importlib.import_module(name)\n"
            "import chip_smoke\n"
            "assert 'repro_torch.launch.serve' in names, names\n"
            "print(sorted(n for n in sys.modules if n.split('.')[0] in "
            f"{FORBIDDEN!r}))\n")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_chip_smoke_refuses_without_gpu():
    """No GPU: chip_smoke.py exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs there")
    import os
    import subprocess
    import sys
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == "" and "no CUDA GPU" in out.stderr


def test_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    db = np.random.default_rng(7).normal(size=(300, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SearchEngine.build(db)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_index(db)
    idx = build_index(db, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SearchEngine(idx)
