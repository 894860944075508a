"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA.  Raises when CUDA is asked for but absent: the
    port never falls back to the CPU on its own; callers that want the
    plain PyTorch versions pass `device="cpu"` explicitly.

    Resolving a CUDA device switches TF32 off for the whole process:
    `torch.backends.cudnn.allow_tf32` (True by default, so the f32
    `F.conv2d` of the range and image branches would run in TF32) and
    `torch.backends.cuda.matmul.allow_tf32`.  The f32 paths are held to
    f32 tolerances, and a context manager around the forward would not be
    enough: the convolutions' backward runs later, inside autograd, under
    whatever the global flags are then."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels"
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
