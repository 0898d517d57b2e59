"""Multi-rank runs of the port's mesh training on CPU gloo, and its launcher
under the fake process group.

Used by tests/test_torch_mesh.py and tests/test_torch_mesh_train.py.
``tests.torch_dist_worker.run_ranks(..., worker=__file__)`` starts one
process of this module per rank (``rank world workdir``); each joins a
gloo group through a file store in ``workdir``, lays a ``DeviceMesh``
(``mesh_shape``, ``mesh_dims``) over the ranks and runs the case's
``parts``:

* ``train``: for each arch of ``archs``, with and without int8 gradient
  compression, the train state placed by ``launch.dryrun.param_shardings``
  under ``default_rules(fsdp=True)``, three steps over the global batches
  ``tokens_<i>`` / ``labels_<i>``, each rank's rows made a DTensor by
  ``make_process_local_array`` (the launcher's ``make_global``): the
  losses, the first step's gradients (as AdamW receives them) and the
  parameters after the three steps, gathered whole; this rank's parts of
  the parameters replicated over ``"model"``, its coordinates on the
  other axes, and the query head counts that reached ``flash_attention``
  (attention and the GLU MLP compute this rank's share of ``"model"``);
* ``replicated``: one step of the MoE arch (``archs[1]``) on the plain
  batch ``odd_tokens`` / ``odd_labels``, whose rows the data axes do not
  divide: every rank takes the whole batch and the MoE the local path
  (the reference's fall-back); the loss, the parameters after, and the
  ``_moe_sharded`` calls;
* ``moe``: ``moe_apply`` on this rank's rows of ``moe_x`` through
  ``_moe_sharded`` (weights ``moe_router`` ...), at ``no_drop`` and with
  drops;
* ``elastic``: the reference's elastic case (a placed ``[8, 8]`` leaf
  saved from the mesh, restored onto ``remesh`` of the first 3 ranks) and
  the dense arch's placed train state saved and restored the same way;
* ``search``: ``SearchEngine.build`` over ``db`` sharded on the mesh's
  ``("pod", "data")``, ``"model"`` replicated, searched at ``k``.

Rank 0 writes the gathered tensors; every rank writes its local results
to ``workdir/out_<rank>.npz``.

``fake world mesh workdir`` instead runs ``launch.train --mesh <mesh>
--smoke --device cpu --steps 2`` in one process under the fake process
group of ``world`` ranks and writes each parameter's local and global
shape and its ``param_specs`` entry to ``workdir/fake.json``.

This module imports torch and repro_torch only, never jax.
"""
from __future__ import annotations

import json
import logging
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np

ARCH_SEED = 0


def _full(t):
    import torch

    from repro_torch.dist import placement

    with torch.no_grad():
        return (t.full_tensor() if placement.is_dtensor(t) else t).detach().numpy().copy()


def train_part(inp, out, mesh, rank):
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.core.distributed import shard_layout
    from repro_torch.dist import placement
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.compat import make_process_local_array
    from repro_torch.launch.dryrun import param_shardings
    from repro_torch.models import layers, model_fns
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import init_state, make_train_step, place_state

    multi = "pod" in mesh.mesh_dim_names
    names = mesh.mesh_dim_names
    at = names.index("model")
    coord = mesh.get_coordinate()
    out["model_group"] = np.asarray([c for i, c in enumerate(coord) if i != at])
    shd.set_rules(mesh, shd.default_rules(fsdp=True, multi_pod=multi))
    dp = placement.dp_axes(mesh)
    n_dp, pos = shard_layout(mesh, dp)
    batch_sh = shd.NamedSharding(mesh, (dp,))
    captured = []
    update = adamw.update

    def spy(grads, *a, **kw):
        if not captured:
            captured.append({n: _full(g) for n, g in grads.items()})
        return update(grads, *a, **kw)

    flash, heads = layers.flash_attention, set()

    def seen(q, *a, **kw):
        heads.add(q.shape[2])
        return flash(q, *a, **kw)

    adamw.update, layers.flash_attention = spy, seen
    try:
        for arch in (str(a) for a in inp["archs"]):
            cfg = smoke_config(arch)
            fns = model_fns(cfg)
            for compress in (False, True):
                tag = f"{arch}|{int(compress)}"
                state = init_state(fns, ARCH_SEED, device="cpu", compress_grads=compress)
                state = place_state(state, param_shardings(state["params"], mesh, cfg))
                step = make_train_step(fns, cfg, compress_grads=compress)
                heads.clear()
                losses = []
                for i in range(int(inp["steps"])):
                    b = {k: inp[f"{k}_{i}"] for k in ("tokens", "labels")}
                    rows = b["tokens"].shape[0] // n_dp
                    b = {k: make_process_local_array(
                        batch_sh, torch.from_numpy(x[pos * rows:(pos + 1) * rows]), x.shape)
                        for k, x in b.items()}
                    state, m = step(state, b)
                    losses.append(float(m["loss"]))
                grads = captured.pop()
                params = {n: _full(p) for n, p in state["params"].named_parameters()}
                out[f"{tag}|loss"] = np.asarray(losses)
                out[f"{tag}|local"] = np.asarray(json.dumps(
                    {n: list(placement.local(p).shape)
                     for n, p in state["params"].named_parameters()}))
                out[f"{tag}|q_heads"] = np.asarray(sorted(heads), dtype=np.int64)
                for n, p in state["params"].named_parameters():
                    if p.placements[at].is_replicate():
                        out[f"{tag}|replicated|{n}"] = placement.local(p).detach().numpy().copy()
                if rank == 0:
                    for n in params:
                        out[f"{tag}|grad|{n}"] = grads[n]
                        out[f"{tag}|param|{n}"] = params[n]
                if arch == str(inp["archs"][0]) and not compress:
                    out["_dense_state"] = state
    finally:
        adamw.update, layers.flash_attention = update, flash
        shd.set_rules(None, None)


def replicated_part(inp, out, mesh, rank):
    from repro_torch.configs import smoke_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.dryrun import param_shardings
    from repro_torch.models import model_fns, moe
    from repro_torch.train.train_step import init_state, make_train_step, place_state

    cfg = smoke_config(str(inp["archs"][1]))
    fns = model_fns(cfg)
    calls, sharded = [], moe._moe_sharded

    def counted(*a, **kw):
        calls.append(1)
        return sharded(*a, **kw)

    shd.set_rules(mesh, shd.default_rules(fsdp=True))
    moe._moe_sharded = counted
    try:
        state = init_state(fns, ARCH_SEED, device="cpu")
        state = place_state(state, param_shardings(state["params"], mesh, cfg))
        state, m = make_train_step(fns, cfg)(state, {"tokens": inp["odd_tokens"],
                                                     "labels": inp["odd_labels"]})
    finally:
        moe._moe_sharded = sharded
        shd.set_rules(None, None)
    out["replicated_loss"] = np.asarray(float(m["loss"]))
    out["replicated_sharded_calls"] = np.asarray(len(calls))
    params = {n: _full(p) for n, p in state["params"].named_parameters()}
    if rank == 0:
        for n, p in params.items():
            out[f"replicated|param|{n}"] = p


def moe_part(inp, out, mesh):
    import torch

    from repro_torch.core.distributed import shard_layout
    from repro_torch.dist import placement
    from repro_torch.dist import sharding as shd
    from repro_torch.models import moe
    from repro_torch.models.config import MoEConfig
    from repro_torch.configs import smoke_config

    shd.set_rules(mesh, shd.default_rules(fsdp=True))
    try:
        dp = placement.dp_axes(mesh)
        n_dp, pos = shard_layout(mesh, dp)
        x = inp["moe_x"]
        rows = x.shape[0] // n_dp
        x = torch.from_numpy(x[pos * rows:(pos + 1) * rows])
        for cf, no_drop in ((float(inp["moe_cf_nodrop"]), True), (float(inp["moe_cf"]), False)):
            cfg = smoke_config("mixtral-8x22b").replace(
                dtype="float32", moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=cf))
            layer = moe.MoE(cfg, device="cpu")
            with torch.no_grad():
                layer.router.copy_(torch.from_numpy(inp["moe_router"]))
                for n in ("up", "gate", "down"):
                    layer.experts[n].copy_(torch.from_numpy(inp[f"moe_{n}"]))
            sh = {"router": shd.NamedSharding(mesh, shd.sanitize(
                shd.param_spec("router", layer.router.shape), layer.router.shape, mesh))}
            for n, w in layer.experts.items():
                sh[f"experts.{n}"] = shd.NamedSharding(mesh, shd.sanitize(
                    shd.param_spec(f"experts/{n}", w.shape), w.shape, mesh))
            placement.place_module(layer, sh)
            with placement.batch_split(mesh, dp):
                y, aux = moe.moe_apply(layer, x, cfg, no_drop=no_drop)
            out[f"moe_y_{int(no_drop)}"] = y.numpy()
            out[f"moe_aux_{int(no_drop)}"] = np.asarray(float(aux))
            out["moe_placements"] = np.asarray(str({n: str(p.placements)
                                                    for n, p in layer.named_parameters()}))
        out["moe_rows"] = np.asarray([pos * rows, (pos + 1) * rows])
    finally:
        shd.set_rules(None, None)


def elastic_part(inp, out, mesh, rank, world, workdir, dense_state):
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import smoke_config
    from repro_torch.dist import placement
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.elastic import remesh
    from repro_torch.launch.dryrun import param_shardings
    from repro_torch.models import model_fns
    from repro_torch.train.train_step import init_state

    # the reference's case: a [8, 8] leaf split on "model", saved from the mesh
    w = placement.distribute(torch.arange(64, dtype=torch.float32).reshape(8, 8), mesh,
                             shd.placements((None, "model"), mesh))
    cm = CheckpointManager(str(workdir / "ckpt"), async_save=False)
    cm.save(1, {"w": w})
    cm.save(2, dense_state)
    dist.barrier()
    new_mesh = remesh(range(world - 1), prefer_model=2, device_type="cpu")
    out["remesh_shape"] = np.asarray(new_mesh.mesh.shape)
    if new_mesh.get_coordinate() is None:
        return                              # the lost rank
    got, _, _ = cm.restore({"w": torch.zeros(8, 8)}, 1, device="cpu",
                           shardings={"w": shd.NamedSharding(new_mesh, (None, "model"))})
    out["elastic_w_local"] = placement.local(got["w"]).numpy()
    out["elastic_w"] = _full(got["w"])
    # the dense train state, onto the survivors' mesh by its own rules
    cfg = smoke_config(str(inp["archs"][0]))
    shd.set_rules(new_mesh, shd.default_rules(fsdp=True))
    try:
        target = init_state(model_fns(cfg), 0, abstract=True)
        sh = param_shardings(target["params"], new_mesh, cfg)
        shardings = {"params": sh, "opt": {"m": sh, "v": sh}}
        state, _, step = cm.restore(target, 2, device="cpu", shardings=shardings)
    finally:
        shd.set_rules(None, None)
    out["elastic_step"] = np.asarray(step)
    bad = []
    for n, p in state["params"].named_parameters():
        if not placement.is_dtensor(p) or p.device_mesh != new_mesh:
            bad.append(n)
    out["elastic_not_placed"] = np.asarray(bad, dtype=str)
    full = {f"params/{n}": _full(p) for n, p in state["params"].named_parameters()}
    full.update({f"opt/m/{n}": _full(t) for n, t in state["opt"]["m"].items()})
    if rank == 0:
        saved = np.load(workdir / "ckpt" / "step_00000002" / "shard_p0.npz")
        out["elastic_state_equal"] = np.asarray(all(
            np.array_equal(saved[k], v) for k, v in full.items()))


def search_part(inp, out, mesh):
    from repro_torch.search import SearchEngine

    eng = SearchEngine.build(inp["db"], mesh=mesh, axis_names=("pod", "data"),
                             n_shards=int(inp["n_shards"]), n_pivots=8, block_size=64,
                             device="cpu")
    s, i, _ = eng.search(inp["q"], int(inp["k"]))
    out["search_s"], out["search_i"] = s.numpy(), i.numpy()
    out["search_backend"] = np.asarray(eng.backend_name)


def main(rank: int, world: int, workdir: Path) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    inp = dict(np.load(workdir / "in.npz"))
    parts = {str(p) for p in inp["parts"]}
    out = {}
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    try:
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(tuple(inp["mesh_shape"])),
                          mesh_dim_names=tuple(str(a) for a in inp["mesh_dims"]))
        if "train" in parts:
            train_part(inp, out, mesh, rank)
        if "replicated" in parts:
            replicated_part(inp, out, mesh, rank)
        if "moe" in parts:
            moe_part(inp, out, mesh)
        if "search" in parts:
            search_part(inp, out, mesh)
        if "elastic" in parts:
            elastic_part(inp, out, mesh, rank, world, workdir, out.pop("_dense_state"))
        out.pop("_dense_state", None)
    finally:
        dist.destroy_process_group()
    np.savez(workdir / f"out_{rank}.npz",
             **{f: v.numpy() if isinstance(v, torch.Tensor) else v for f, v in out.items()})


def fake_launch(world: int, mesh: str, workdir: Path) -> None:
    """``launch.train --mesh <mesh>`` at rank 0 of ``world`` fake ranks."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.dist import placement
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import train
    from repro_torch.launch.dryrun import param_specs

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        from repro_torch.train import trainer as trainer_mod

        states, cls = [], trainer_mod.Trainer

        class Recording(cls):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                states.append(self)

        trainer_mod.Trainer = Recording
        try:
            out = train.main(["--smoke", "--device", "cpu", "--mesh", mesh, "--steps", "2",
                              "--ckpt-dir", str(workdir / "ckpt"), "--ckpt-every", "100"])
        finally:
            trainer_mod.Trainer = cls
        model = states[0].state["params"]
        specs = param_specs(model, model.cfg, shd.get_mesh())
        rec = {"final_step": out["final_step"], "mesh": list(shd.get_mesh().mesh.shape),
               "params": {n: [list(placement.local(p).shape), list(p.shape),
                              [a if a is None or isinstance(a, str) else list(a)
                               for a in specs[n]]]
                          for n, p in model.named_parameters()},
               "batch_local": list(states[0].make_global(
                   states[0].data.batch(0))["tokens"].to_local().shape)}
        shd.set_rules(None, None)
    finally:
        dist.destroy_process_group()
    (workdir / "fake.json").write_text(json.dumps(rec))


if __name__ == "__main__":
    if sys.argv[1] == "fake":
        fake_launch(int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
    else:
        main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
