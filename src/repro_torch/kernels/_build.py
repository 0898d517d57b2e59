"""Build the CUDA sources in ``csrc/`` with ``nvcc`` on first use, and
check the operands handed to them.

Each ``csrc/<name>.cu`` is compiled into its own shared library with a
plain C interface and loaded with :mod:`ctypes` (no PyTorch headers, so a
build takes seconds).  Libraries go to ``build/repro_torch/`` at the root
of the checkout, named by a hash of their source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source is rebuilt and an unchanged one
is reused.  :func:`build` starts one
``nvcc`` per missing library, all at once, and waits for every one.

Nothing here runs at import time: importing the port needs no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "build", "library", "check_operand"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("pruned_topk", "block_bounds")
# no --use_fast_math: it makes sqrtf approximate, and the Eq. 13 value must
# stay an upper bound; -Xptxas -v reports registers and spills in the log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc); set CUDA_HOME")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # an edited header rebuilds
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every library of ``names`` that is not built yet.

    Returns ``{name: {"seconds": s, "log": nvcc output}}`` for the ones it
    compiled.  Raises with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    try:
        for name in names:
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            # nvcc is not a Python process; there is no JAX backend to pin
            procs[name] = (subprocess.Popen(  # repro-lint: disable=R003
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        done, errors = {}, []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                errors.append(f"nvcc failed for {name}.cu:\n{log}")
                continue
            os.replace(tmp, out)        # atomic: a concurrent build is safe
            done[name] = {"seconds": time.perf_counter() - t0, "log": log}
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def check_operand(name: str, t, shape: tuple, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: the C launchers take raw pointers and trust the layout."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
