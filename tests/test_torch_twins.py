"""The port's small twins against the reference, on the CPU:
repro_torch.core.vptree (a numpy copy: identical results),
repro_torch.kernels.ops (the legacy shims), repro_torch.data.dedup, the
search package's exports, and every public function and class of the
reference against a twin of the same name or a recorded reason."""
import ast
import importlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.search as j_search  # noqa: E402
from repro.core import vptree as j_vptree  # noqa: E402
from repro.data import dedup as j_dedup  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
import repro_torch.search as t_search  # noqa: E402
from repro_torch.core import VPTree  # noqa: E402
from repro_torch.core import vptree as t_vptree  # noqa: E402
from repro_torch.data import dedup as t_dedup  # noqa: E402
from repro_torch.kernels import bound_prune, ops  # noqa: E402
from repro_torch.search import backends as t_bk  # noqa: E402
from tests.conftest import clustered  # noqa: E402


@pytest.mark.parametrize("bound", sorted(j_vptree.UPPER_BOUNDS))
@pytest.mark.parametrize("kind", ["clustered", "uniform"])
def test_vptree_identical_to_reference(bound, kind, rng):
    """Same data, seed and leaf size: identical sims, ids and exact-score
    counts, query by query, for each upper bound."""
    assert sorted(t_vptree.UPPER_BOUNDS) == sorted(j_vptree.UPPER_BOUNDS)
    db = clustered(rng, 400, 12) if kind == "clustered" else \
        rng.normal(size=(400, 12)).astype(np.float32)
    q = rng.normal(size=(6, 12))
    j = j_vptree.VPTree(db, leaf_size=8, seed=3)
    t = VPTree(db, leaf_size=8, seed=3)
    for k in (1, 7):
        for a, b in zip(j.knn_batch(q, k, bound=bound), t.knn_batch(q, k, bound=bound)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_ops_block_bounds_is_bound_prune(rng):
    qp = rng.uniform(-1, 1, size=(9, 5)).astype(np.float32)
    lo = rng.uniform(-1, 0.5, size=(13, 5)).astype(np.float32)
    hi = np.minimum(lo + 0.4, 1).astype(np.float32)
    lo[3], hi[3] = np.inf, -np.inf                          # an empty block
    args = [torch.from_numpy(a) for a in (qp, lo, hi)]
    got = ops.block_bounds(*args)
    assert torch.equal(got, bound_prune.block_bounds(*args))
    assert torch.isneginf(got[:, 3]).all()
    assert ops.coarsen_intervals is t_bk.coarsen_intervals
    assert ops.cosine_topk.pruned_topk is not None


def test_ops_search_index_raises_like_reference():
    with pytest.raises(TypeError, match="SearchEngine"):
        j_ops.search_index()
    with pytest.raises(TypeError, match=r"SearchEngine\(index, backend='kernel'\)"):
        ops.search_index(None, None, k=3)
    with pytest.raises(TypeError, match="kernel_search"):
        ops.search_index()


def docs(rng, n=600, s=48, n_dup=40):
    """Token documents with ``n_dup`` planted near-duplicates (one token of
    ``s`` changed)."""
    tokens = rng.integers(0, 5000, size=(n, s))
    src = rng.choice(n - n_dup, n_dup, replace=False)
    tokens[n - n_dup:] = tokens[src]
    tokens[n - n_dup:, 0] = rng.integers(0, 5000, n_dup)
    return tokens


def test_embed_tokens_and_dedup_mask_identical(rng):
    tokens = docs(rng)
    for dim in (64, 256):
        np.testing.assert_array_equal(t_dedup.embed_tokens(tokens, dim=dim),
                                      j_dedup.embed_tokens(tokens, dim=dim))
    pairs = [(0, 5), (5, 9), (2, 3), (3, 2), (1, 7)]
    np.testing.assert_array_equal(t_dedup.dedup_mask(10, pairs),
                                  j_dedup.dedup_mask(10, pairs))


@pytest.mark.parametrize("dim", [64, 256])
def test_find_near_duplicates_matches_reference(dim, rng):
    """The planted pairs score ~0.97; no other pair comes near 0.95, so no
    tie among equal integer-valued scores decides a pair."""
    emb = t_dedup.embed_tokens(docs(rng), dim=dim)
    want, _ = j_dedup.find_near_duplicates(jnp.asarray(emb), threshold=0.95, k=8,
                                           n_pivots=8, block_size=32)
    got, stats = t_dedup.find_near_duplicates(emb, threshold=0.95, k=8,
                                              n_pivots=8, block_size=32, device="cpu")
    assert got == want and len(got) >= 30
    assert all(i < j for i, j in got) and stats.n_queries == len(emb)


def test_find_near_duplicates_needs_a_gpu_by_default(rng):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_dedup.find_near_duplicates(rng.normal(size=(300, 8)).astype(np.float32))


def test_search_exports_match_reference():
    """The port's search surface is the reference's, the shard trees'
    ``ShardTreeArrays`` and ``build_shard_trees`` included."""
    assert set(t_search.__all__) == set(j_search.__all__)
    for name in t_search.__all__:
        assert getattr(t_search, name) is not None


#: the reference's public functions and classes that have no twin, each
#: with its reason
NO_TWIN = {
    "repro.dist.compat.shard_map": "the port writes the collectives of its one shard_map "
                                   "body, the sharded MoE, by hand on local tensors",
    "repro.dist.compat.optimization_barrier": "eager torch runs ops in program order",
    "repro.dist.compat.multiprocess_cpu_init": "torch.distributed takes its gloo group "
                                               "from init_process_group",
    "repro.dist.compat.replicate_to_mesh": "a replicated DTensor is placement.distribute "
                                           "of the same data",
    "repro.launch.dryrun.collective_bytes": "it parses HLO; the port's Counter sees each "
                                            "collective as it runs",
    "repro.models.ssm.xf_d": "a one-line float32 cast, written .float() in place",
    "repro.search.defaults.tuned_default": "the tuned table binds only on jax CPU; the port "
                                           "resolves every knob to FALLBACK_DEFAULTS",
}


def test_every_reference_name_has_a_twin_or_a_reason():
    """Each module of src/repro/ has a twin under repro_torch, and each
    public function or class a module defines (read from its source, so
    no reference module is imported here) is an attribute of the twin, or
    is in NO_TWIN."""
    root = Path(__file__).resolve().parents[1] / "src" / "repro"
    missing = set()
    for f in sorted(root.rglob("*.py")):
        parts = f.relative_to(root).with_suffix("").parts
        parts = parts[:-1] if parts[-1] == "__init__" else parts
        names = [n.name for n in ast.parse(f.read_text()).body
                 if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")]
        twin = importlib.import_module(".".join(("repro_torch",) + parts))
        missing |= {".".join(("repro",) + parts + (n,)) for n in names if not hasattr(twin, n)}
    assert missing == set(NO_TWIN)
