"""One side of tests/test_torch_dryrun.py's comparison, in a process of
its own: ``python tests/torch_dryrun_worker.py ref|port|pod workdir``.

* ``ref`` runs the reference's ``repro.launch.dryrun.lower_cell`` on a
  ``(data 2, model 4)`` mesh of 8 of its host CPU devices (the module
  asks XLA for 512 when it is imported) for ``CELLS`` and the unrolled
  probe of ``PROBE``, and writes ``ref.json``: each cell's
  ``memory.argument_bytes``, the record's keys, the probe's
  ``cost.flops``.
* ``port`` places the same cells with ``repro_torch.launch.dryrun
  .build_cell`` under ``FakeTensorMode`` at rank 0 of a fake world of 8
  ranks (no step runs: the argument bytes are the placed state's), runs
  the probe's step (``lower_cell``: its FLOPs and its peak
  ``temp_bytes``) and writes ``port.json``.
* ``pod`` runs ``run_cell(POD_CELL, "pod")`` at rank 0 of a fake world of
  256 ranks and writes ``pod.json``.

The ``ref`` side imports jax; the other two import torch and repro_torch
only.
"""
from __future__ import annotations

import json
import logging
import sys
from pathlib import Path

#: (arch, shape) cells whose argument bytes are compared
CELLS = [("tinyllama-1.1b", "train_4k"), ("tinyllama-1.1b", "decode_32k"),
         ("granite-moe-1b-a400m", "train_4k"), ("zamba2-1.2b", "decode_32k")]
#: the cell whose unrolled probe's FLOPs are recorded beside the reference's
PROBE = ("tinyllama-1.1b", "train_4k")
#: the pod cell run end to end through run_cell
POD_CELL = ("tinyllama-1.1b", "decode_32k")


def ref(workdir: Path) -> None:
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from repro.launch import dryrun

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    out = {"argument_bytes": {}}
    for arch, shape in CELLS:
        rec = dryrun.lower_cell(arch, shape, mesh)
        out["argument_bytes"][f"{arch}:{shape}"] = rec["memory"]["argument_bytes"]
        out["keys"] = sorted(rec)
        out["memory_keys"] = sorted(rec["memory"])
    probe = dryrun.lower_cell(*PROBE, mesh, unrolled=True)
    out["probe_flops"] = probe["cost"]["flops"]
    out["probe_temp_bytes"] = probe["memory"]["temp_bytes"]
    (workdir / "ref.json").write_text(json.dumps(out))


def port(workdir: Path) -> None:
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import dryrun

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    out = {"argument_bytes": {}}
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        for arch, shape in CELLS:
            with dryrun.cell_rules(shape, mesh), FakeTensorMode(allow_non_fake_inputs=True):
                cell = dryrun.build_cell(arch, shape, mesh)
                out["argument_bytes"][f"{arch}:{shape}"] = dryrun.argument_bytes(cell)
        probe = dryrun.lower_cell(*PROBE, mesh, unrolled=True)
        out["probe_flops"] = probe["cost"]["flops"]
        out["probe_temp_bytes"] = probe["memory"]["temp_bytes"]
    finally:
        dist.destroy_process_group()
    (workdir / "port.json").write_text(json.dumps(out))


def pod(workdir: Path) -> None:
    from repro_torch.launch import dryrun

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    rec = dryrun.run_cell(*POD_CELL, "pod", out_dir=str(workdir / "records"), device="cpu")
    (workdir / "pod.json").write_text(json.dumps(rec))


if __name__ == "__main__":
    {"ref": ref, "port": port, "pod": pod}[sys.argv[1]](Path(sys.argv[2]))
