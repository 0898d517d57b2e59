"""Multi-rank runs of the port's mesh training on CPU gloo, and its launcher
under the fake process group.

Used by tests/test_torch_mesh.py and tests/test_torch_mesh_train.py.
``tests.torch_dist_worker.run_ranks(..., worker=__file__)`` starts one
process of this module per rank (``rank world workdir``); each joins a
gloo group through a file store in ``workdir``, lays a ``DeviceMesh``
(``mesh_shape``, ``mesh_dims``) over the ranks and runs the case's
``parts``:

* ``train``: for each arch of ``archs`` (its smoke config in the
  activation dtype of ``dtypes``), with and without int8 gradient
  compression, the train state placed by ``launch.dryrun.param_shardings``
  under ``default_rules(fsdp=True)``, three steps over the global batches
  ``tokens_<i>`` / ``labels_<i>``, each rank's rows made a DTensor by
  ``make_process_local_array`` (the launcher's ``make_global``): the
  losses, the first step's gradients (as AdamW receives them) and the
  parameters after the three steps, gathered whole; this rank's parts of
  the parameters replicated over ``"model"``, its coordinates on the
  other axes, the query head counts that reached ``flash_attention``,
  rwkv6's WKV recurrence and the SSD's chunked scan, and the logit columns
  each chunk of the loss saw (attention, the GLU MLP, rwkv6's mixes, the
  SSD and the head compute this rank's share of ``"model"``); then three
  plain steps of the tied arch ``tied_arch`` with its ``embed.table``
  placed replicated over ``"model"`` (its data axes kept), whose head
  takes the table's rows while the lookup takes it whole: the losses, the
  first step's gradients and the parameters after (rank 0) and the
  table's local part;
* ``serve``: for each arch of ``serve_archs`` (smoke configs in
  ``launch.dryrun.ARCHS``), the dry-run's prefill and decode cells at
  ``serve_seq`` tokens and ``serve_batch`` rows (``build_cell`` with
  weights from ``ARCH_SEED``): the step's logits on this rank (whole,
  every rank), the query heads, ffn columns, rwkv6 and SSD heads and logit
  columns each rank computed, and, on rank 0, the same step in one
  process with no mesh
  (``fns.forward`` / ``decode_step`` and ``lm_head``) on the same inputs;
  then ``placement.gather_shares`` and ``take_share`` over the rank's
  ``"model"`` group on small tensors, with their gradients;
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


def spy_recurrent_heads(seen: dict):
    """Patches rwkv6's WKV recurrences and the SSD's chunked scan to add
    the head count each is given to ``seen["rwkv_heads"]`` /
    ``seen["ssd_heads"]``; returns the function that undoes it."""
    from repro_torch.models import rwkv, ssm

    saved = rwkv._wkv_scan, rwkv._wkv_chunked, ssm._ssd_chunked

    def spy(key, fn):
        def counted(x, *a, **kw):
            seen.setdefault(key, set()).add(x.shape[2])
            return fn(x, *a, **kw)
        return counted

    rwkv._wkv_scan, rwkv._wkv_chunked = (spy("rwkv_heads", f) for f in saved[:2])
    ssm._ssd_chunked = spy("ssd_heads", saved[2])

    def undo():
        rwkv._wkv_scan, rwkv._wkv_chunked, ssm._ssd_chunked = saved
    return undo


def train_part(inp, out, mesh, rank):
    from repro_torch.configs import smoke_config
    from repro_torch.core.distributed import shard_layout
    from repro_torch.dist import placement
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.dryrun import param_shardings, param_specs
    from repro_torch.models import layers, model_fns
    from repro_torch.optim import adamw
    from repro_torch.train import losses
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

    lse_gold, cols = losses._lse_gold, set()

    def seen_cols(logits, *a, **kw):
        cols.add(logits.shape[-1])
        return lse_gold(logits, *a, **kw)

    adamw.update, layers.flash_attention, losses._lse_gold = spy, seen, seen_cols
    recurrent: dict = {}
    undo = spy_recurrent_heads(recurrent)
    try:
        for arch, dtype in zip((str(a) for a in inp["archs"]), (str(d) for d in inp["dtypes"])):
            cfg = smoke_config(arch).replace(dtype=dtype)
            fns = model_fns(cfg)
            for compress in (False, True):
                tag = f"{arch}|{int(compress)}"
                state = init_state(fns, ARCH_SEED, device="cpu", compress_grads=compress)
                state = place_state(state, param_shardings(state["params"], mesh, cfg))
                step = make_train_step(fns, cfg, compress_grads=compress)
                heads.clear()
                cols.clear()
                recurrent.clear()
                out[f"{tag}|loss"] = np.asarray(run_steps(step, state, inp, batch_sh,
                                                          n_dp, pos))
                for key in ("rwkv_heads", "ssd_heads"):
                    out[f"{tag}|{key}"] = np.asarray(sorted(recurrent.get(key, ())),
                                                     dtype=np.int64)
                grads = captured.pop()
                params = {n: _full(p) for n, p in state["params"].named_parameters()}
                out[f"{tag}|local"] = np.asarray(json.dumps(
                    {n: list(placement.local(p).shape)
                     for n, p in state["params"].named_parameters()}))
                out[f"{tag}|q_heads"] = np.asarray(sorted(heads), dtype=np.int64)
                out[f"{tag}|vocab_cols"] = np.asarray(sorted(cols), dtype=np.int64)
                for n, p in state["params"].named_parameters():
                    if p.placements[at].is_replicate():
                        out[f"{tag}|replicated|{n}"] = placement.local(p).detach().numpy().copy()
                if rank == 0:
                    for n in params:
                        out[f"{tag}|grad|{n}"] = grads[n]
                        out[f"{tag}|param|{n}"] = params[n]
                if arch == str(inp["archs"][0]) and not compress:
                    out["_dense_state"] = state
        # the tied table replicated over "model": each rank's whole table
        # takes the lookup's gradient and the head's of every share
        cfg = smoke_config(str(inp["tied_arch"]))
        fns = model_fns(cfg)
        state = init_state(fns, ARCH_SEED, device="cpu")
        sh = param_shardings(state["params"], mesh, cfg)
        spec = tuple(None if a == "model" else a
                     for a in param_specs(state["params"], cfg, mesh)["embed.table"])
        sh["embed.table"] = shd.NamedSharding(mesh, spec)
        state = place_state(state, sh)
        tag = f"{cfg.name}|table_replicated"
        out[f"{tag}|loss"] = np.asarray(run_steps(make_train_step(fns, cfg), state, inp,
                                                  batch_sh, n_dp, pos))
        table = state["params"].embed["table"]
        assert table.placements[at].is_replicate()
        out[f"{tag}|replicated|embed.table"] = placement.local(table).detach().numpy().copy()
        grads = captured.pop()
        params = {n: _full(p) for n, p in state["params"].named_parameters()}
        if rank == 0:
            for n, p in params.items():
                out[f"{tag}|grad|{n}"] = grads[n]
                out[f"{tag}|param|{n}"] = p
    finally:
        adamw.update, layers.flash_attention, losses._lse_gold = update, flash, lse_gold
        undo()
        shd.set_rules(None, None)


def run_steps(step, state, inp, batch_sh, n_dp, pos) -> list:
    """``inp["steps"]`` train steps over the global batches ``tokens_<i>``
    / ``labels_<i>``, each rank's rows a DTensor; the losses."""
    import torch

    from repro_torch.dist.compat import make_process_local_array

    losses = []
    for i in range(int(inp["steps"])):
        b = {k: inp[f"{k}_{i}"] for k in ("tokens", "labels")}
        rows = b["tokens"].shape[0] // n_dp
        b = {k: make_process_local_array(
            batch_sh, torch.from_numpy(x[pos * rows:(pos + 1) * rows]), x.shape)
            for k, x in b.items()}
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return losses


def serve_part(inp, out, mesh, rank):
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import Shape, smoke_config
    from repro_torch.core.distributed import shard_layout
    from repro_torch.dist import placement
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.models import layers, lm, model_fns

    seq, bsz = int(inp["serve_seq"]), int(inp["serve_batch"])
    archs = [str(a) for a in inp["serve_archs"]]
    shapes = {"prefill_32k": Shape("prefill_32k", "prefill", seq, bsz),
              "decode_32k": Shape("decode_32k", "decode", seq, bsz)}
    n_dp, pos = shard_layout(mesh, placement.dp_axes(mesh))
    flash, shard = layers.flash_attention, shd.shard
    seen: dict = {}

    def heads(q, *a, **kw):
        seen.setdefault("heads", set()).add(q.shape[2])
        return flash(q, *a, **kw)

    def annotated(x, *names):
        for n in ("ffn", "vocab"):
            if n in names:
                seen.setdefault(n, set()).add(x.shape[-1])
        return shard(x, *names)

    saved = dryrun.ARCHS, dryrun.SHAPES
    dryrun.ARCHS = {**dryrun.ARCHS, **{a: smoke_config(a) for a in archs}}
    dryrun.SHAPES = {**dryrun.SHAPES, **shapes}
    try:
        for arch in archs:
            for name, shape in shapes.items():
                tag = f"serve|{arch}|{shape.kind}"
                gen = torch.Generator().manual_seed(11)
                with dryrun.cell_rules(name, mesh):
                    cell = dryrun.build_cell(arch, name, mesh, seed=ARCH_SEED)
                    local_tokens = cell.args["batch"]["tokens"]
                    tokens = torch.randint(0, cell.cfg.vocab, (bsz, local_tokens.shape[1]),
                                           generator=gen, dtype=local_tokens.dtype)
                    rows = local_tokens.shape[0]
                    local_tokens.copy_(tokens[pos * rows:(pos + 1) * rows] if rows < bsz
                                       else tokens)
                    whole_cache = None
                    if cell.cache is not None:
                        whole_cache = {}
                        for p, x in dryrun.cache_leaves(cell.cache).items():
                            t = torch.randn(x.shape, generator=gen, dtype=x.dtype) * 0.5
                            whole_cache[p] = t
                            placement.local(x).copy_(placement.local(distribute_tensor(
                                t, mesh, x.placements, src_data_rank=None)))
                    seen.clear()
                    layers.flash_attention, shd.shard = heads, annotated
                    undo = spy_recurrent_heads(seen)
                    try:
                        res = cell.step()
                    finally:
                        layers.flash_attention, shd.shard = flash, shard
                        undo()
                logits = res if cell.cache is None else res[0]
                out[f"{tag}|logits"] = logits.numpy().copy()
                for n in ("heads", "ffn", "vocab", "rwkv_heads", "ssd_heads"):
                    out[f"{tag}|{n}"] = np.asarray(sorted(seen.get(n, ())), dtype=np.int64)
                if rank != 0:
                    continue
                # the same step in one process, no mesh
                cfg = cell.cfg
                fns = model_fns(cfg)
                params = fns.init(ARCH_SEED, device="cpu")
                with torch.no_grad():
                    if whole_cache is None:
                        hidden, _, _ = fns.forward(params, {"tokens": tokens})
                        want = fns.lm_head(params, hidden[:, -1:])
                    else:
                        hcache = lm.lm_cache_init(cfg, bsz, shape.seq, device="cpu")
                        for p, t in dryrun.cache_leaves(hcache).items():
                            t.copy_(whole_cache[p])
                        hidden, _ = fns.decode_step(params, tokens, hcache, shape.seq - 1)
                        want = fns.lm_head(params, hidden)
                out[f"{tag}|one_process"] = want.numpy()
    finally:
        dryrun.ARCHS, dryrun.SHAPES = saved
    # the two share collectives alone, over this rank's "model" group
    part = placement._model_part(mesh)
    r, tp, _ = part
    x = torch.full((2, 3), float(r), requires_grad=True)
    y = placement.gather_shares(x, -1, part)
    (y * torch.arange(y.numel(), dtype=y.dtype).view_as(y)).sum().backward()
    out["model_index"] = np.asarray(r)
    out["gather_shares"], out["gather_shares_grad"] = y.detach().numpy(), x.grad.numpy()
    w = torch.arange(tp * 2 * 3, dtype=torch.float32).view(tp * 2, 3).requires_grad_(True)
    share = placement.take_share(w, 0, part)
    (share * (r + 1)).sum().backward()
    out["take_share"], out["take_share_grad"] = share.detach().numpy(), w.grad.numpy()


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
        if "serve" in parts:
            serve_part(inp, out, mesh, rank)
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
