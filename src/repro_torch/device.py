"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device raises where none is present.

    The port's entry points run on the GPU unless the caller asks for the
    CPU explicitly (``device="cpu"``, as the tests do): a silent CPU
    fallback would run the plain tensor versions of the kernels and report
    their times as the port's.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA GPU by default and none is available; "
            "pass device='cpu' to run the plain PyTorch versions instead")
    return dev
