"""Parameter freezing for staged recipes (port of
`taseg_tpu/utils/param_groups.py`).

The reference's `fix_part_param` (train.py:202-207; minkunet_ms_mm.py:
569-572 trains only the image / lidar-FOV / fusion modules of TIAF)
flips requires_grad; JAX keeps every parameter differentiated and puts
the real optimizer on the trainable ones only (`optax.multi_transform`
with `set_to_zero` on the rest).  The port does what JAX does: every
parameter keeps its gradient (the step's `grad_norm` covers them all),
and `optim.ClippedSGD(frozen=...)` clips, decays and moves only the
others.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn


def path_matches(name: str, prefixes: Sequence[str]) -> bool:
    """JAX's rule on a parameter path ('.' or '/' separated): it starts
    with a prefix, or a prefix follows one of its separators."""
    joined = name.replace(".", "/")
    return any(joined.startswith(p) or f"/{p}" in f"/{joined}" for p in prefixes)


def frozen_parameters(model: nn.Module, trainable_prefixes: Sequence[str]) -> list:
    """The parameters of `model` whose names match none of the prefixes
    (JAX `trainable_mask`'s False leaves)."""
    return [p for n, p in model.named_parameters() if not path_matches(n, trainable_prefixes)]
