"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA.  Raises when CUDA is asked for but absent: the
    port never falls back to the CPU on its own; callers that want the
    plain PyTorch versions pass `device="cpu"` explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels"
        )
    return dev
