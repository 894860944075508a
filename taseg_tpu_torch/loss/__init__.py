"""Loss combinator (port of `taseg_tpu/loss/__init__.py`): masked CE with
label smoothing and Lovász-softmax, summed with weights.  Points with
label == ignore_index or point_valid == False contribute nothing.  The
other loss types of the JAX package are not ported yet and raise.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .lovasz import lovasz_softmax
from .util import label_lp

__all__ = ["Losses", "cross_entropy", "lovasz_softmax"]

PORTED = ("CELoss", "LovLoss")


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    x = logits.float()
    x = x - x.max(-1, keepdim=True).values
    return x - torch.log(torch.exp(x).sum(-1, keepdim=True))


def cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    *,
    label_smoothing: float = 0.0,
    class_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked CE with torch semantics: mean over valid points, optional
    per-class weights (JAX loss/__init__.py:30)."""
    c = logits.shape[-1]
    lp = _log_softmax(logits)
    labels_c = labels.clamp(0, c - 1)
    nll = -label_lp(lp, labels_c)
    if label_smoothing > 0.0:
        smooth = -lp.mean(-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    w = valid.float()
    if class_weight is not None:
        w = w * class_weight[labels_c]
    return (nll * w).sum() / w.sum().clamp(min=1e-8)


class Losses:
    """Weighted sum of named losses over masked per-point logits:
    `losses(logits (N, C), labels (N,), point_valid (N,))`."""

    def __init__(
        self,
        loss_types: Sequence[str],
        loss_weights: Sequence[float],
        *,
        ignore_index: int = 0,
        label_smoothing: float = 0.0,
    ):
        if len(loss_types) != len(loss_weights):
            raise ValueError("one weight per loss type")
        missing = [t for t in loss_types if t not in PORTED]
        if missing:
            raise NotImplementedError(
                f"loss types not ported yet (ROADMAP Queue 1 item 6): {missing}; the port has {list(PORTED)}"
            )
        self.loss_types = list(loss_types)
        self.loss_weights = list(loss_weights)
        self.ignore_index = ignore_index
        self.label_smoothing = label_smoothing

    def __call__(
        self, logits: torch.Tensor, labels: torch.Tensor, point_valid: torch.Tensor
    ) -> torch.Tensor:
        valid = point_valid & (labels != self.ignore_index)
        total = torch.zeros((), dtype=torch.float32, device=logits.device)
        for name, w in zip(self.loss_types, self.loss_weights):
            if name == "CELoss":
                l = cross_entropy(
                    logits, labels, valid, label_smoothing=self.label_smoothing
                )
            else:
                l = lovasz_softmax(logits, labels, valid)
            total = total + w * l
        return total
