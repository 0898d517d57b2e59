"""PyTorch/CUDA port of the exact cosine-search system in :mod:`repro`.

The JAX package is the reference; this package mirrors its module layout
(``core``, ``kernels``, ``search``) so each module's counterpart is found
under the same name.  Plain tensor code is PyTorch; the two Pallas kernels
on the search path (``pruned_topk`` and ``block_bounds``) are hand-written
CUDA for Hopper (``kernels/csrc``), built with ``nvcc`` on first use.

Entry points run on the GPU: ``device=None`` means ``"cuda"`` and raises
where no GPU is present, unless the caller passes ``device="cpu"``; on CPU
tensors every kernel wrapper runs its plain PyTorch version.

Importing this package needs neither ``nvcc`` nor a GPU.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
