"""The port's sharding rules and meshes against the reference
(``repro.dist.sharding``, ``repro.dist.elastic``).

* ``param_spec`` / ``sanitize`` equal the reference's for every leaf of
  every arch in ``ARCHS`` at full size, on the pod and the multipod mesh.
  The reference runs on ``jax.sharding.AbstractMesh`` (no 256 devices),
  the port on its own ``AbstractMesh``; the leaves' paths and shapes come
  from the port's ``registry.reference_paths`` / ``reference_shapes``,
  which must equal the reference's ``jax.eval_shape`` tree.
* The port keeps one tensor per layer: each parameter takes the
  reference's entries for the dims it has.  Where the reference puts the
  FSDP axes on a scanned run's stacked layer dim, the port has no such dim
  and shards the first of its own dims the rule picks
  (``launch.dryrun.param_specs``, option (b)).  Those departures, by arch
  and leaf, are ``FSDP_ON_LAYER_DIM``; there are no others.
* ``best_mesh`` equals the reference's for n = 1 ... 1024.
"""
from __future__ import annotations

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.dist import elastic as j_elastic  # noqa: E402
from repro.dist import sharding as j_shd  # noqa: E402
from repro.models import model_fns as j_model_fns  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.dist import elastic, sharding as shd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.dryrun import param_specs  # noqa: E402
from repro_torch.models import registry  # noqa: E402

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}

#: {mesh: {arch: {leaf path}}}: the reference's leaves whose FSDP axes land
#: on the stacked layer dim (dim 0 of a scanned run's [L, ...] leaf); the
#: port shards the first of its own dims the rule picks instead
_QWEN_LEAVES = {f"blocks/0/{n}" for n in (
    "attn/bk", "attn/bq", "attn/bv", "attn/wk", "attn/wo", "attn/wq", "attn/wv",
    "ln1/scale", "ln2/scale", "mlp/w_down", "mlp/w_gate", "mlp/w_up")}
FSDP_ON_LAYER_DIM = {
    "pod": {"qwen2.5-14b": _QWEN_LEAVES, "qwen2-72b": _QWEN_LEAVES},
    "multipod": {},
}


def _norm(spec) -> tuple:
    """A spec as a tuple of None / name / tuple of names, trailing None
    dropped (a PartitionSpec compares so with the port's tuples)."""
    out = [a if a is None or isinstance(a, str) else tuple(a) for a in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@functools.lru_cache(maxsize=None)
def reference_leaves(arch: str) -> dict:
    """{path: shape} of the reference's parameter tree of ``arch``."""
    abstract = jax.eval_shape(j_model_fns(J_ARCHS[arch]).init, jax.random.PRNGKey(0))
    leaves, _ = jax.tree_util.tree_flatten_with_path(abstract)
    return {j_shd.path_name(p): tuple(x.shape) for p, x in leaves}


@functools.lru_cache(maxsize=None)
def port_model(arch: str):
    cfg = ARCHS[arch]
    return registry.model_class(cfg)(cfg, device="meta"), cfg


def reference_specs(arch: str, mesh: str) -> dict:
    """{path: the reference's sanitized spec} on the mesh."""
    jmesh = JAbstractMesh(*MESHES[mesh])
    j_shd.set_rules(jmesh, j_shd.default_rules(fsdp=True, multi_pod=mesh == "multipod"))
    try:
        return {path: _norm(j_shd.sanitize(j_shd.param_spec(path.split("/"), shape), shape,
                                           jmesh))
                for path, shape in reference_leaves(arch).items()}
    finally:
        j_shd.set_rules(None, None)


@pytest.fixture
def rules():
    def install(mesh):
        m = shd.AbstractMesh(*MESHES[mesh])
        shd.set_rules(m, shd.default_rules(fsdp=True, multi_pod=mesh == "multipod"))
        return m
    yield install
    shd.set_rules(None, None)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reference_paths_and_shapes_are_the_reference_tree(arch):
    model, cfg = port_model(arch)
    paths = registry.reference_paths(model, cfg)
    shapes = registry.reference_shapes(model, cfg)
    ref = reference_leaves(arch)
    assert {paths[n]: shapes[n] for n in paths} == ref


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_spec_and_sanitize_equal_the_reference(arch, mesh, rules):
    m = rules(mesh)
    want = reference_specs(arch, mesh)
    got = {path: shd.sanitize(shd.param_spec(path, shape), shape, m)
           for path, shape in reference_leaves(arch).items()}
    assert got == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_port_placement_departs_only_on_the_layer_dim(mesh, rules):
    m = rules(mesh)
    departures = {}
    for arch in sorted(ARCHS):
        model, cfg = port_model(arch)
        paths = registry.reference_paths(model, cfg)
        shapes = registry.reference_shapes(model, cfg)
        ref = reference_specs(arch, mesh)
        got = param_specs(model, cfg, m)
        for name, p in model.named_parameters():
            stacked = len(shapes[name]) - p.ndim
            full = ref[paths[name]] + (None,) * (len(shapes[name]) - len(ref[paths[name]]))
            if stacked and full[0] is not None:
                departures.setdefault(arch, set()).add(paths[name])
                # option (b): the port's own dims under the same rule
                assert got[name] == shd.sanitize(shd.param_spec(paths[name], p.shape),
                                                 p.shape, m), name
                assert full[0] in got[name], name   # the FSDP axes stay on
            else:
                assert got[name] == _norm(full[stacked:]), (arch, name)
    assert departures == FSDP_ON_LAYER_DIM[mesh]


def test_attention_splits_dh_and_the_dense_mlp_is_fsdp_only(rules):
    """The reference's own layout, as the port places it: attention's dh on
    "model" (not its heads), the dense MLP FSDP only (its leaves' names
    are not among the tensor-parallel ones)."""
    m = rules("pod")
    model, cfg = port_model("tinyllama-1.1b")
    got = param_specs(model, cfg, m)
    assert got["blocks.0.attn.wq"] == ("data", None, "model")
    assert got["blocks.0.attn.wo"] == ("data", "model")
    assert got["blocks.0.mlp.w_up"] == ("data",)
    assert got["embed.table"] == ("model", "data")


def test_default_rules_and_sanitize_equal_the_reference():
    for kw in ({}, {"fsdp": True}, {"multi_pod": True, "fsdp": True}, {"pure_dp": True}):
        want = {k: v if v is None or isinstance(v, str) else tuple(v)
                for k, v in j_shd.default_rules(**kw).items()}
        assert shd.default_rules(**kw) == want
    jm, m = JAbstractMesh((2, 4), ("data", "model")), shd.AbstractMesh((2, 4), ("data", "model"))
    for spec, shape in ((("data", "model"), (4, 6)), ((("pod", "data"), None), (6, 4)),
                        ((None, "model", None), (3, 8, 5)), ((), (7,))):
        assert shd.sanitize(spec, shape, m) == _norm(
            j_shd.sanitize(jax.sharding.PartitionSpec(*spec), shape, jm))


def test_best_mesh_equals_the_reference():
    for n in range(1, 1025):
        assert elastic.best_mesh(n) == j_elastic.best_mesh(n), n
        for pm in (1, 2, 3, 8, 16):
            assert elastic.best_mesh(n, prefer_model=pm) == \
                j_elastic.best_mesh(n, prefer_model=pm), (n, pm)
    with pytest.raises(ValueError):
        elastic.best_mesh(0)


def test_batch_shardings_split_where_the_data_axes_divide(tmp_path):
    """The reference's rule (launch/dryrun.py:70-73): the first dim over the
    data axes where they divide it, else replicated; and the dry-run
    proper writes a cell's record (here a cell the reference skips, with
    its reason; tests/test_torch_dryrun.py runs one at rank 0 of 256)."""
    m = shd.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    batch = {"tokens": np.zeros((64, 8)), "odd": np.zeros((48, 8)), "scalar": np.zeros(())}
    got = dryrun.batch_shardings(batch, m, ("pod", "data"))
    assert {k: sh.spec for k, sh in got.items()} == {
        "tokens": (("pod", "data"),), "odd": (), "scalar": ()}
    rec = dryrun.run_cell("tinyllama-1.1b", "long_500k", "pod", out_dir=str(tmp_path),
                          device="cpu")
    written = json.loads((tmp_path / "pod" / "tinyllama-1.1b__long_500k.json").read_text())
    assert written == rec == {
        "arch": "tinyllama-1.1b", "shape": "long_500k", "mesh": {"data": 16, "model": 16},
        "skipped": True, "reason": "full attention is quadratic/unbounded-KV at 500k"}


def test_shard_is_the_identity_on_local_tensors(rules):
    rules("pod")
    x = torch.randn(4, 3, 2)
    assert shd.shard(x, "batch", None, "heads") is x
    assert np.array_equal(shd.shard(x).numpy(), x.numpy())
