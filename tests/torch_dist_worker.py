"""Multi-rank runs of the port's sharded layer on CPU gloo.

Used by tests/test_torch_distributed.py, tests/test_torch_sharded_engine.py,
tests/test_torch_shard_tree.py and tests/test_torch_sharded_online.py.
:func:`run_ranks` writes a case's inputs to ``workdir/in.npz`` and starts
one process of this module per rank; each joins a gloo group through a
file store in ``workdir`` (no TCP port), lays a ``DeviceMesh`` over the
ranks, runs the case's ``parts`` and writes its results to
``workdir/out_<rank>.npz``:

* ``flat`` (the default): the merges, the process-local build, the flat
  search and the engine's sharded builds;
* ``tree``: the shard trees' branch through ``make_sharded_search`` and
  the engine (``tree_shards=True``);
* ``online``: the engine's ``ShardedMutableIndex`` through the case's
  mutation script (:func:`run_mutations`).

This module imports torch and repro_torch only, never jax.
"""
from __future__ import annotations

import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def run_ranks(world: int, workdir, inputs: dict, timeout: float = 240,
              worker: str | None = None) -> list[dict]:
    """Run the case ``inputs`` on ``world`` ranks; every rank's results.
    ``worker``: the script each rank runs (default this one), called as
    ``worker rank world workdir``."""
    workdir = Path(workdir)
    np.savez(workdir / "in.npz", **inputs)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    procs, logs = [], []
    try:
        for rank in range(world):
            log = open(workdir / f"log_{rank}.txt", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, worker or __file__, str(rank), str(world), str(workdir)],
                env=env, stdout=log, stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, (
            f"rank {rank} exited {p.returncode}:\n"
            + (workdir / f"log_{rank}.txt").read_text()[-4000:])
    return [dict(np.load(workdir / f"out_{rank}.npz")) for rank in range(world)]


def run_mutations(eng, inp: dict, k: int) -> dict:
    """The mutation script of ``inp`` on ``eng.online()``: ``mut_ops`` names
    each step (``insert``: rows ``mut_arg_<i>``; ``delete``: ids
    ``mut_arg_<i>``; ``reoptimize``).  After every step: the returned ids,
    every live row's ``(id, shard, slot)``, the free slots per shard and
    the search at ``k`` over ``inp["q"]``."""
    h = eng.online(auto_reoptimize=False)
    out = {}
    for i, op in enumerate(str(x) for x in inp["mut_ops"]):
        if op == "insert":
            out[f"mut_ids_{i}"] = np.asarray(h.insert(inp[f"mut_arg_{i}"]))
        elif op == "delete":
            h.delete(inp[f"mut_arg_{i}"].tolist())
        else:
            h.reoptimize()
        out[f"mut_place_{i}"] = np.asarray(
            sorted((r, s, p) for r, (s, p) in h._id_pos.items()), np.int64)
        out[f"mut_free_{i}"] = np.asarray([len(f) for f in h._free])
        out[f"mut_s_{i}"], out[f"mut_i_{i}"], _ = eng.search(inp["q"], k)
    return out


def main(rank: int, world: int, workdir: Path) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.distributed import (build_sharded_index_local,
                                              local_shard_rows, make_sharded_search,
                                              shard_group, shard_layout)
    from repro_torch.search import SearchEngine, build_shard_trees

    inp = dict(np.load(workdir / "in.npz"))
    parts = {str(p) for p in inp.get("parts", ["flat"])}
    n_shards, ks = int(inp["n_shards"]), [int(k) for k in inp["ks"]]
    build_kw = dict(n_shards=n_shards, n_pivots=int(inp["n_pivots"]),
                    block_size=int(inp["block_size"]))
    db, q = inp["db"], inp["q"]
    out = {}
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    try:
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(tuple(inp["mesh_shape"])),
                          mesh_dim_names=tuple(str(a) for a in inp["mesh_dims"]))
        n_dev, pos = shard_layout(mesh)
        group = shard_group(mesh)
        out["position"] = np.asarray([n_dev, pos])

        _, owned = local_shard_rows(len(db), mesh, n_shards=n_shards)
        db_local = db[owned[0][1]:owned[-1][2]]
        out["owned"] = np.asarray(owned)
        idx = build_sharded_index_local(db_local, mesh, global_rows=len(db), **build_kw)
        if "flat" in parts:
            flat_part(inp, out, mesh, group, n_dev, pos, idx, db, db_local, q, ks, build_kw)
        if "tree" in parts:
            run = make_sharded_search(mesh, with_stats=True, element_stats=True,
                                      warm_start=True, best_first=True)
            tree = build_shard_trees(idx)
            for k in ks:
                (out[f"tree_s{k}"], out[f"tree_i{k}"], *stats) = run(idx, q, k, tree=tree)
                out[f"tree_stats{k}"] = np.asarray([float(x) for x in stats])
            eng = SearchEngine.build(db_local, mesh=mesh, distributed=True,
                                     global_rows=len(db), tree_shards=True, device="cpu",
                                     **build_kw)
            s, i, st = eng.search(q, ks[-1], element_stats=True)
            out["tree_engine_s"], out["tree_engine_i"] = s, i
            out["tree_engine_stats"] = np.asarray([
                float(st.block_prune_frac), float(st.elem_prune_frac),
                float(st.tree_prune_frac), float(st.tree_node_eval_frac)])
        if "online" in parts:
            eng = SearchEngine.build(db, mesh=mesh, tree_shards=bool(inp["tree_shards"]),
                                     device="cpu", **build_kw)
            out.update(run_mutations(eng, inp, ks[-1]))
            out["online_db"] = eng.index.db
    finally:
        dist.destroy_process_group()
    np.savez(workdir / f"out_{rank}.npz",
             **{f: v.numpy() if isinstance(v, torch.Tensor) else v for f, v in out.items()})


def flat_part(inp, out, mesh, group, n_dev, pos, idx, db, db_local, q, ks, build_kw):
    """The merges over this rank's slice of every shard's candidates, the
    flat search of the process-local build, and the engine's two builds."""
    import torch

    from repro_torch.core.distributed import make_sharded_search
    from repro_torch.dist.collectives import (global_tau_merge, masked_topk_merge,
                                              topk_allgather_merge)
    from repro_torch.search import SearchEngine

    per_rank = int(inp["n_shards"]) // n_dev
    mine = slice(pos * per_rank, (pos + 1) * per_rank)
    cs, ci, cv = (torch.from_numpy(inp[f][mine]) for f in ("cand_s", "cand_i", "cand_v"))
    mk = int(inp["merge_k"])
    out["merge_s"], out["merge_i"] = topk_allgather_merge(cs, ci, mk, group)
    out["masked_s"], out["masked_v"] = masked_topk_merge(cs, cv, mk, group)
    out["tau"] = global_tau_merge(cs, cv, mk, group)
    for f, t in zip(idx._fields, idx):
        out[f"index_{f}"] = t
    run = make_sharded_search(mesh, with_stats=True, element_stats=True,
                              warm_start=True, best_first=True)
    for k in ks:
        out[f"s{k}"], out[f"i{k}"], out[f"frac{k}"], out[f"efrac{k}"] = run(idx, q, k)
    # the engine: the whole datastore on every rank, and each rank's slice
    for name, eng in (
            ("engine", SearchEngine.build(db, mesh=mesh, device="cpu", **build_kw)),
            ("engine_local", SearchEngine.build(
                db_local, mesh=mesh, distributed=True, global_rows=len(db),
                device="cpu", **build_kw))):
        s, i, st = eng.search(q, ks[-1], element_stats=True)
        out[f"{name}_s"], out[f"{name}_i"] = s, i
        out[f"{name}_stats"] = np.asarray([
            float(st.block_prune_frac), float(st.elem_prune_frac), eng.n_valid,
            eng.n_slots])
        out[f"{name}_backend"] = np.asarray(eng.backend_name)
        out[f"{name}_db"] = eng.index.db


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
