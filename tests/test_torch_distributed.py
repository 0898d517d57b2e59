"""repro_torch's sharded layer against the reference and the brute force, on
the CPU: the top-k merges (``dist/collectives.py``), the sharded build and
the per-shard search (``core/distributed.py``).

* the merges against a numpy top-k of the candidates' union, with no
  group, on a one-rank gloo group and on two ranks;
* the build shard for shard against ``repro.core.distributed``'s
  (``assert_same_build``; ``valid`` and the global ``row_ids`` equal),
  with a short trailing shard and an all-padding one;
* one rank holding all 8 shards (the CPU's per-shard stage is the scan):
  result sets equal ``repro.core.ref.brute_force_knn`` and the port's
  single-device engine at k in {1, 7, 80}, blocks of 64 (k = 80 takes
  the multi-block τ prescan on every shard);
* the reference's ``make_sharded_search(with_stats=True)`` on 8 virtual
  devices, in a subprocess, on its own stacked index; the port searches
  that index (``sharded_index_from_reference``): sims within 2e-5, ids
  equal where sims are finite (tie-aware), both weighted prune fractions
  within 1e-6;
* two ranks with two shards each (``tests/torch_dist_worker.py``, gloo
  through a file store): the process-local build bit for bit against
  ``build_sharded_index``'s slices, every rank's answers and stats against
  the brute force and the one-process run.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402

from repro.core import distributed as j_dist  # noqa: E402
from repro.core import ref as j_ref  # noqa: E402
from repro_torch.core.distributed import (build_sharded_index, local_shard,  # noqa: E402
                                          make_sharded_search, place_sharded_index,
                                          sharded_index_from_reference)
from repro_torch.core.index import BlockIndex  # noqa: E402
from repro_torch.dist.collectives import (global_tau_merge, masked_topk_merge,  # noqa: E402
                                          topk_allgather_merge)
from repro_torch.search import SearchEngine  # noqa: E402
from tests.conftest import clustered  # noqa: E402
from tests.test_torch_pivots_index import assert_same_build, fields  # noqa: E402
from tests.torch_dist_worker import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N, D, M = 4097, 24, 12
SHARDS, PIVOTS, BLOCK = 8, 8, 64
KS = (1, 7, 80)


def corpus(seed=7, n=N):
    """Clustered rows and queries near rows (where τ rises and blocks
    prune), as the reference's sharded engine test makes them."""
    rng = np.random.default_rng(seed)
    db = clustered(rng, n, D, n_centers=6, noise=0.05)
    q = db[rng.choice(n, M, replace=False)] + 0.01 * rng.normal(size=(M, D))
    return db, j_ref.normalize(q).astype(np.float32)


def assert_same_topk(s_got, i_got, s_want, i_want, atol):
    """Sims within ``atol``; where they are finite the ids equal as sets,
    apart from ids scoring within ``atol`` of the row's k-th best (a
    near-tie either side may hold); ``(-inf, -1)`` elsewhere."""
    s_got, i_got, s_want, i_want = (np.asarray(x) for x in (s_got, i_got, s_want, i_want))
    np.testing.assert_allclose(s_got, s_want, atol=atol)
    fin = np.isfinite(s_want)
    assert (np.isfinite(s_got) == fin).all()
    assert (i_got[~fin] == -1).all()
    for r in range(len(s_want)):
        got = dict(zip(i_got[r][fin[r]], s_got[r][fin[r]]))
        want = dict(zip(i_want[r][fin[r]], s_want[r][fin[r]]))
        if not fin[r].any():
            continue
        kth = min(s_got[r][fin[r]].min(), s_want[r][fin[r]].min())
        for i in set(got) ^ set(want):
            assert abs({**got, **want}[i] - kth) <= atol, (r, i)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A one-rank CPU mesh in this process (gloo through a file store)."""
    store = tmp_path_factory.mktemp("store") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        yield DeviceMesh("cpu", [0], mesh_dim_names=("shard",))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the merges
# ---------------------------------------------------------------------------

def merge_case(seed=3, shards=4, m=6, k=5):
    """Per-shard candidate lists ``[S, m, k]`` with distinct scores, short
    shards (``(-inf, -1)`` tails) and a row whose union holds fewer than k
    real candidates."""
    rng = np.random.default_rng(seed)
    s = rng.permutation(shards * m * k).reshape(shards, m, k).astype(np.float32) / 97 - 1
    s = -np.sort(-s, axis=2)
    ids = np.arange(shards * m * k, dtype=np.int32).reshape(shards, m, k)
    real = np.ones_like(s, dtype=bool)
    real[1, :, 2:] = False                 # a short shard
    real[3, 2:, 1:] = False
    real[:, 0, 1:] = False                 # row 0: one candidate per shard
    s[~real], ids[~real] = -np.inf, -1
    return s, ids, real, k


def union_topk(s, ids, valid, k):
    """numpy: the k best of each row's union (masked entries at -inf),
    their ids, validity and the k-th real score or -inf."""
    m = s.shape[1]
    us = np.where(valid, s, -np.inf).transpose(1, 0, 2).reshape(m, -1)
    ui = ids.transpose(1, 0, 2).reshape(m, -1)
    uv = valid.transpose(1, 0, 2).reshape(m, -1)
    order = np.argsort(-us, axis=1, kind="stable")[:, :k]
    top_v = np.take_along_axis(uv, order, 1)
    top_s = np.take_along_axis(us, order, 1)
    return top_s, np.take_along_axis(ui, order, 1), top_v, np.where(
        top_v[:, -1], top_s[:, -1], -np.inf)


def check_merges(got_s, got_i, got_ms, got_mv, got_tau, s, ids, real, k):
    want_s, want_i, want_v, want_tau = union_topk(s, ids, real, k)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_ms, want_s)
    fin = np.isfinite(want_s)
    np.testing.assert_array_equal(got_i[fin], want_i[fin])
    assert (got_i[~fin] == -1).all()        # empty slots lose and stay (-inf, -1)
    np.testing.assert_array_equal(got_mv, want_v)
    np.testing.assert_array_equal(got_tau, want_tau)
    assert np.isneginf(got_tau[0]) and np.isfinite(got_tau[1:]).all()


@pytest.mark.parametrize("group", ["none", "one_rank"])
def test_merges_match_numpy_topk_of_the_union(mesh, group):
    s, ids, real, k = merge_case()
    g = None if group == "none" else dist.group.WORLD
    ts, ti, tv = torch.from_numpy(s), torch.from_numpy(ids), torch.from_numpy(real)
    got_s, got_i = topk_allgather_merge(ts, ti, k, g)
    got_ms, got_mv = masked_topk_merge(ts, tv, k, g)
    check_merges(got_s.numpy(), got_i.numpy(), got_ms.numpy(), got_mv.numpy(),
                 global_tau_merge(ts, tv, k, g).numpy(), s, ids, real, k)
    # one shard's [m, k] lists merge as a stack of one
    one_s, one_i = topk_allgather_merge(ts[0], ti[0], k, g)
    np.testing.assert_array_equal(one_s.numpy(), s[0])


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Two ranks on a 1-D mesh, two of four shards each."""
    db, q = corpus(seed=11, n=1500)
    s, ids, real, k = merge_case()
    inputs = dict(db=db, q=q, n_shards=4, ks=np.asarray(KS), n_pivots=PIVOTS,
                  block_size=BLOCK, mesh_shape=np.asarray([2]),
                  mesh_dims=np.asarray(["shard"]), cand_s=s, cand_i=ids, cand_v=real,
                  merge_k=k)
    outs = run_ranks(2, tmp_path_factory.mktemp("two_ranks"), inputs)
    return inputs, outs


def test_merges_on_two_ranks_match_numpy(two_ranks):
    inputs, outs = two_ranks
    for out in outs:
        check_merges(out["merge_s"], out["merge_i"], out["masked_s"], out["masked_v"],
                     out["tau"], inputs["cand_s"], inputs["cand_i"], inputs["cand_v"],
                     int(inputs["merge_k"]))


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,shards", [(N, SHARDS), (25, 8), (130, 3)],
                         ids=["4097_over_8", "all_padding_shard", "130_over_3"])
def test_build_matches_reference_per_shard(n, shards):
    """4,097 rows over 8 shards: a short trailing shard; 25 over 8: shard 6
    holds one row and shard 7 none (random pivots below P rows)."""
    db, _ = corpus(seed=5, n=n)
    j_idx = j_dist.build_sharded_index(db, shards, n_pivots=PIVOTS, block_size=BLOCK)
    t_idx = build_sharded_index(db, shards, n_pivots=PIVOTS, block_size=BLOCK, device="cpu")
    assert t_idx.db.shape == tuple(j_idx.db.shape)
    j_fields = fields(j_idx)
    per = -(-n // shards)
    for s in range(shards):
        j = {f: None if a is None else a[s] for f, a in j_fields.items()}
        t = fields(local_shard(t_idx, s))
        np.testing.assert_array_equal(t["valid"], j["valid"])
        np.testing.assert_array_equal(t["row_ids"], j["row_ids"])
        assert_same_build(j, t)
        n_valid = min(per, max(0, n - s * per))
        assert t["valid"].sum() == n_valid
        ids = np.sort(t["row_ids"][t["valid"]])
        np.testing.assert_array_equal(ids, np.arange(s * per, s * per + n_valid))
        assert (t["row_ids"][~t["valid"]] == -1).all()
        # the sound intervals never shrink the reference's
        assert (t["dp_lo"] <= t["dp_min"]).all() and (t["dp_hi"] >= t["dp_max"]).all()
    if n == 25:
        assert not t_idx.valid[7].any() and int(t_idx.valid[6].sum()) == 1


# ---------------------------------------------------------------------------
# one rank holding all 8 shards
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank(mesh):
    db, q = corpus()
    idx = place_sharded_index(
        build_sharded_index(db, SHARDS, n_pivots=PIVOTS, block_size=BLOCK, device="cpu"),
        mesh)
    single = SearchEngine.build(db, n_pivots=PIVOTS, block_size=BLOCK, backend="scan",
                                device="cpu")
    return db, q, idx, single


@pytest.mark.parametrize("k", KS)
def test_one_rank_search_matches_brute_and_single_device(mesh, one_rank, k):
    db, q, idx, single = one_rank
    assert idx.db.shape[0] == SHARDS
    run = make_sharded_search(mesh, with_stats=True, element_stats=True,
                              warm_start=True, best_first=True)
    s, i, frac, efrac = run(idx, q, k)
    sref, iref = j_ref.brute_force_knn(q, db, k)
    assert_same_topk(s.numpy(), i.numpy(), sref, iref, 2e-5)
    s1, i1, _ = single.search(q, k)
    assert_same_topk(s.numpy(), i.numpy(), s1.numpy(), i1.numpy(), 1e-6)
    assert 0.0 <= float(frac) <= 1.0 and 0.0 < float(efrac) <= 1.0
    # no mesh: the same shards in this process, the same answers
    s0, i0 = make_sharded_search(None, warm_start=True, best_first=True)(idx, q, k)
    assert torch.equal(s0, s) and torch.equal(i0, i)


# ---------------------------------------------------------------------------
# against the JAX package's sharded search
# ---------------------------------------------------------------------------

#: (name, k, warm_start, best_first, n_pivots) of the reference's
#: make_sharded_search (with_stats=True, element_stats=True)
JAX_CONFIGS = (("cold_k7", 7, False, False, 0), ("warm_k80", 80, True, True, 0),
               ("warm_k1", 1, True, True, 0), ("joint_cap_k7", 7, True, True, 4))

JAX_RUN = """
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.core.distributed import (build_sharded_index, make_sharded_search,
                                        place_sharded_index)
    inp = np.load(sys.argv[1])
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    idx = place_sharded_index(build_sharded_index(
        inp["db"], int(inp["shards"]), n_pivots=int(inp["pivots"]),
        block_size=int(inp["block"])), mesh)
    out = {"index_" + f: np.asarray(getattr(idx, f)) for f in idx._fields
           if getattr(idx, f) is not None}
    for name, k, ws, bf, npv in CONFIGS:
        run = make_sharded_search(mesh, with_stats=True, element_stats=True,
                                  warm_start=ws, best_first=bf, n_pivots=npv)
        res = run(idx, jnp.asarray(inp["q"]), k)
        for part, x in zip(("s", "i", "frac", "efrac"), res):
            out[name + "_" + part] = np.asarray(x)
    np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """The reference's sharded search on 8 virtual CPU devices."""
    tmp = tmp_path_factory.mktemp("jax_sharded")
    db, q = corpus()
    np.savez(tmp / "in.npz", db=db, q=q, shards=SHARDS, pivots=PIVOTS, block=BLOCK)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": str(ROOT / "src")}
    code = f"CONFIGS = {JAX_CONFIGS!r}\n" + textwrap.dedent(JAX_RUN)
    out = subprocess.run([sys.executable, "-c", code, str(tmp / "in.npz"),
                          str(tmp / "out.npz")], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return db, q, dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("config", JAX_CONFIGS, ids=[c[0] for c in JAX_CONFIGS])
def test_matches_jax_make_sharded_search(jax_sharded, config):
    db, q, j = jax_sharded
    name, k, ws, bf, npv = config
    idx = sharded_index_from_reference(
        {f: j.get("index_" + f) for f in BlockIndex._fields}, "cpu")
    assert idx.db.shape[0] == SHARDS and idx.dp_lo is not None
    s, i, frac, efrac = make_sharded_search(
        None, with_stats=True, element_stats=True, warm_start=ws, best_first=bf,
        n_pivots=npv)(idx, q, k)
    assert_same_topk(s.numpy(), i.numpy(), j[name + "_s"], j[name + "_i"], 2e-5)
    assert abs(float(frac) - float(j[name + "_frac"])) <= 1e-6
    assert abs(float(efrac) - float(j[name + "_efrac"])) <= 1e-6
    sref, iref = j_ref.brute_force_knn(q, db, k)
    assert_same_topk(s.numpy(), i.numpy(), sref, iref, 2e-5)
    if name == "warm_k80":
        assert float(frac) > 0.0            # the bound engages per shard


# ---------------------------------------------------------------------------
# two ranks, two shards each
# ---------------------------------------------------------------------------

def test_two_ranks_local_build_is_bit_identical(two_ranks):
    inputs, outs = two_ranks
    whole = build_sharded_index(inputs["db"], 4, n_pivots=PIVOTS, block_size=BLOCK,
                                device="cpu")
    for rank, out in enumerate(outs):
        assert tuple(out["position"]) == (2, rank)
        for f, t in zip(whole._fields, whole):
            np.testing.assert_array_equal(out[f"index_{f}"], t[2 * rank:2 * rank + 2].numpy(),
                                          err_msg=f"rank {rank} {f}")


@pytest.mark.parametrize("k", KS)
def test_two_ranks_search_matches_brute_and_one_process(two_ranks, k):
    inputs, outs = two_ranks
    db, q = inputs["db"], inputs["q"]
    whole = build_sharded_index(db, 4, n_pivots=PIVOTS, block_size=BLOCK, device="cpu")
    s, i, frac, efrac = make_sharded_search(
        None, with_stats=True, element_stats=True, warm_start=True,
        best_first=True)(whole, q, k)
    sref, iref = j_ref.brute_force_knn(q, db, k)
    for out in outs:
        np.testing.assert_array_equal(out[f"s{k}"], s.numpy())
        np.testing.assert_array_equal(out[f"i{k}"], i.numpy())
        assert float(out[f"frac{k}"]) == float(frac)
        assert float(out[f"efrac{k}"]) == float(efrac)
        assert_same_topk(out[f"s{k}"], out[f"i{k}"], sref, iref, 2e-5)
