"""Async, integrity-checked checkpointing (counterpart of
:mod:`repro.checkpoint.manager`; no orbax dependency in either).

Layout (one directory per step), the reference's::

    <dir>/step_00000100/
        manifest.json          tree structure, shapes, dtypes, sha256 per leaf
        shard_p0.npz           the leaf arrays
        DONE                   commit marker (written last -> atomic)

* async save — ``save()`` copies every leaf to host memory before it
  returns (the reference's "fetch NOW"), then a background thread hashes
  and writes them, so training continues; the copy matters doubly here,
  since the optimizer updates the state's tensors in place and a CPU
  tensor's ``numpy()`` shares their storage;
* integrity — per-leaf sha256 in the manifest, verified on restore (the
  leaves are hashed in parallel threads: hashlib releases the GIL);
* GC — keep the newest ``keep`` checkpoints;
* crash safety — a step directory without DONE is ignored and reclaimed.

A tree is a dict / list / tuple of tensors, numpy arrays and
``nn.Module`` s (a module's leaves are its named parameters).  numpy has
no bfloat16 (without ``ml_dtypes``), so a bf16 leaf is stored as its
``uint16`` bits with ``"bfloat16"`` as its dtype in the manifest.

On a mesh (DTensor leaves, :mod:`repro_torch.dist.placement`) every rank
calls ``save``: each DTensor leaf is gathered whole (``full_tensor``, a
collective) and rank 0 of the process group writes ``shard_p0.npz``, so a
checkpoint holds full arrays, as the reference's does, whatever mesh wrote
it.  ``restore(shardings=...)`` places each leaf onto the given mesh
placements (the reference's elastic path; a DTensor target without one
keeps its own placement).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.dist import placement

__all__ = ["CheckpointManager"]


def _flatten(tree, prefix: str = "") -> dict:
    """{"/"-joined path: leaf}; a module's parameters by their names."""
    if isinstance(tree, nn.Module):
        return {f"{prefix}{n}": p for n, p in tree.named_parameters()}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of ``leaf`` (never a view of its storage) and its dtype
    name; bf16 as its uint16 bits.  A DTensor is gathered whole first (a
    collective: every rank of its mesh must call this)."""
    if isinstance(leaf, torch.Tensor):
        if placement.is_dtensor(leaf):
            with torch.no_grad():
                leaf = leaf.full_tensor()
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.array(leaf, copy=True)
    return a, str(a.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _digest(arr: np.ndarray) -> str:
    """sha256 of the array's bytes (the reference's ``tobytes()``, without
    the copy)."""
    return hashlib.sha256(np.ascontiguousarray(arr).reshape(-1).view(np.uint8)).hexdigest()


def _digests(arrays: dict) -> dict:
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        return dict(zip(arrays, pool.map(_digest, arrays.values())))


def _placed(t, dev):
    """``t`` itself, or new storage of its shape and dtype where it lies on
    the ``meta`` device or off ``dev``."""
    want = dev or (resolve_device(None) if t.is_meta else t.device)
    return t if (not t.is_meta and t.device == want) else torch.empty_like(t, device=want)


def _sharding(ref, sh):
    """(mesh, placements) a leaf is restored onto: ``sh`` (a
    NamedSharding), else a DTensor target's own; None for a plain leaf."""
    if sh is not None:
        return sh.mesh, sh.placements
    if placement.is_dtensor(ref):
        return ref.device_mesh, ref.placements
    return None


def _on_mesh(arr: torch.Tensor, ref, where):
    """The whole checkpointed ``arr`` as a DTensor placed by ``where``, in
    the target's dtype, on the mesh's device (each rank keeps its slice)."""
    mesh, placed = where
    return placement.distribute(arr.to(device=placement.local_device(mesh), dtype=ref.dtype),
                                mesh, placed)


def _fill(tree, prefix: str, load, leaves: dict, dev, shardings: dict):
    """``tree`` with each leaf's checkpointed values (``load(path, ref)``)
    written into it; see :meth:`CheckpointManager.restore`."""
    if isinstance(tree, nn.Module):
        if any(p.is_meta for p in tree.parameters()):
            tree.to_empty(device=dev or resolve_device(None))
        elif dev is not None and placement.mesh_of(tree) is None:
            tree.to(dev)
        for n, p in list(tree.named_parameters()):
            key = f"{prefix}{n}"
            full = _from_host(load(key, p), leaves[key]["dtype"])
            where = _sharding(p, shardings.get(key))
            if where is None:
                p.copy_(full)
                continue
            owner, _, leaf = n.rpartition(".")
            tree.get_submodule(owner)._parameters[leaf] = nn.Parameter(
                _on_mesh(full, p, where), requires_grad=p.requires_grad)
        return tree
    if isinstance(tree, dict):
        return {k: _fill(v, f"{prefix}{k}/", load, leaves, dev, shardings)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, f"{prefix}{i}/", load, leaves, dev, shardings)
                          for i, v in enumerate(tree))
    key = prefix[:-1]
    arr = load(key, tree)
    if not isinstance(tree, torch.Tensor):
        return arr.astype(np.asarray(tree).dtype)
    where = _sharding(tree, shardings.get(key))
    if where is not None:
        return _on_mesh(_from_host(arr, leaves[key]["dtype"]), tree, where)
    return _placed(tree, dev).copy_(_from_host(arr, leaves[key]["dtype"]))


def _writes() -> bool:
    """Whether this process writes the checkpoint files: rank 0 of the
    process group, or a process without one."""
    return not dist.is_initialized() or dist.get_rank() == 0


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, *, extra: dict | None = None,
             block: bool = False):
        """Snapshot ``tree`` at ``step``."""
        self.wait()                       # one in-flight save at a time
        host, dtypes = {}, {}
        for k, v in _flatten(tree).items():   # fetch NOW
            host[k], dtypes[k] = _to_host(v)
        if not _writes():
            return
        meta = {
            "step": step,
            "time": time.time(),
            "extra": extra or {},
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                       for k, v in host.items()},
        }

        def write():
            path = os.path.join(self.dir, f"step_{step:08d}")
            tmp = path + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "shard_p0.npz"), **host)
            for k, digest in _digests(host).items():
                meta["leaves"][k]["sha256"] = digest
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
            with open(os.path.join(tmp, "DONE"), "w") as f:
                f.write("ok")
            shutil.rmtree(path, ignore_errors=True)
            os.replace(tmp, path)
            self._gc()

        if self.async_save and not block:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # --------------------------------------------------------------- restore
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "DONE")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, target_tree, step: int | None = None, *, device=None,
                shardings=None, verify: bool = True):
        """Restore into the structure of ``target_tree``.

        Each leaf is written into the target's tensor in place (a module's
        parameters too), cast to its dtype; a target leaf on the ``meta``
        device (``init_state(abstract=True)``) is made on ``device``
        (``None`` means CUDA), and ``device`` moves every leaf there.
        ``shardings``: a tree of the target's structure (dicts by the same
        keys, a module's entry a dict by parameter name) with
        :class:`~repro_torch.dist.sharding.NamedSharding` leaves (or None):
        those leaves become DTensors placed on their mesh (a module's
        parameter is replaced by a DTensor parameter), the elastic path; a
        DTensor target leaf keeps its own placement.
        Returns (tree, extra, step).
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            meta = json.load(f)
        data = np.load(os.path.join(path, "shard_p0.npz"))
        dev = None if device is None else resolve_device(device)
        arrays = {}
        for key in _flatten(target_tree):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arrays[key] = data[key]
        if verify:
            for key, digest in _digests(arrays).items():
                if digest != meta["leaves"][key]["sha256"]:
                    raise IOError(f"integrity failure on leaf {key!r}")

        def load(key, ref):
            arr = arrays[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"shape mismatch {key}: {arr.shape} vs {ref.shape}")
            return arr

        flat_s = {} if shardings is None else _flatten(shardings)
        with torch.no_grad():
            tree = _fill(target_tree, "", load, meta["leaves"], dev,
                         {k: s for k, s in flat_s.items() if s is not None})
        return tree, meta.get("extra", {}), step

    # -------------------------------------------------------------------- gc
    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
        # reclaim dead tmp dirs
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)
