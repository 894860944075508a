"""Loss combinator (port of `taseg_tpu/loss/__init__.py`): the ten loss
types of JAX's `Losses`, summed with weights.  Points with label ==
ignore_index or point_valid == False contribute nothing (every loss
takes a validity mask instead of filtering, as in JAX).  EQLv2 carries
its gradient statistics from step to step (`Losses.init_state`,
`loss.eqlv2`): the engine's Trainer keeps them, saves them in the
checkpoint and, under MODEL.IF_DIST, sums them over the ranks.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .lovasz import lovasz_softmax
from .util import label_lp

__all__ = [
    "Losses", "cross_entropy", "dice_loss", "dice_loss_v1", "ell_loss", "focal_loss",
    "lovasz_softmax", "wce_weights",
]

LOSS_TYPES = (
    "CELoss", "LovLoss", "WCELoss", "FocalLoss", "DiceLossV0", "DiceLossV1", "ELLLoss",
    "EQLv2", "GroupSoftmax", "GroupSoftmax_fgbg_2",
)


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


def focal_loss(
    logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor, *, gamma: float = 0.5,
) -> torch.Tensor:
    """Focal loss (JAX loss/__init__.py:54; reference
    `pcseg/loss/focalloss.py:6-45`): gamma 0.5, pt detached, the sum over
    the valid points / (their count + 1e-5)."""
    c = logits.shape[-1]
    lp = _log_softmax(logits)
    logpt = label_lp(lp, labels.clamp(0, c - 1))
    pt = torch.exp(logpt.detach())
    loss = -((1.0 - pt) ** gamma) * logpt
    m = valid.float()
    return (loss * m).sum() / (m.sum() + 1e-5)


def _onehot(labels: torch.Tensor, c: int, m: torch.Tensor) -> torch.Tensor:
    """(N, C) f32 one-hot of the clipped labels, zero on the masked rows."""
    lc = labels.clamp(0, c - 1)
    return (torch.arange(c, device=labels.device)[None, :] == lc[:, None]).float() * m


def _kept(c: int, ignore_index: int, device) -> torch.Tensor:
    keep = torch.ones(c, dtype=torch.bool, device=device)
    keep[ignore_index] = False
    return keep


def dice_loss(
    logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor, *,
    ignore_index: int = 0, smooth: float = 1.0, exponent: float = 2.0,
) -> torch.Tensor:
    """Per-class binary dice over the softmax, averaged over all C classes
    with the ignored one 0 (JAX :74; reference `dice_loss_v0.py`)."""
    c = logits.shape[-1]
    probs = torch.exp(_log_softmax(logits))
    m = valid.float()[:, None]
    onehot = _onehot(labels, c, m)
    p = probs * m
    num = 2.0 * (p * onehot).sum(0) + smooth
    den = (p**exponent + onehot**exponent).sum(0) + smooth
    per_class = 1.0 - num / den
    return torch.where(_kept(c, ignore_index, logits.device), per_class, 0.0).sum() / c


def dice_loss_v1(
    logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor, *,
    ignore_index: int = 0, smooth: float = 1.0,
) -> torch.Tensor:
    """Soft multiclass dice over the valid points, averaged over the kept
    classes (JAX :252; reference `dice_loss_v1.py`)."""
    c = logits.shape[-1]
    probs = torch.exp(_log_softmax(logits))
    m = valid.float()[:, None]
    onehot = _onehot(labels, c, m)
    p = probs * m
    num = 2.0 * (p * onehot).sum(0) + smooth
    den = (p + onehot).sum(0) + smooth
    per_class = 1.0 - num / den
    keep = _kept(c, ignore_index, logits.device)
    return torch.where(keep, per_class, 0.0).sum() / keep.sum().clamp(min=1)


def ell_loss(
    logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor, *,
    ignore_index: int = 0, cls_weight: Optional[torch.Tensor] = None,
    w_dice: float = 0.8, w_cross: float = 0.2, gamma_dice: float = 1.0,
    gamma_cross: float = 1.0, smooth: float = 1.0, exponent: float = 2.0,
) -> torch.Tensor:
    """Exponential-logarithmic dice / CE hybrid (JAX :279; reference
    `pcseg/loss/ell_loss.py:36-90`): w_dice E[(-ln Dice_c)^g] + w_cross
    E[w_l (-ln p_gt)^g].  As JAX, the negatives of each class weigh
    min(1, 3 n_pos / n_neg) each, deterministically (the reference draws
    that many at random; this is its expectation, with no RNG)."""
    c = logits.shape[-1]
    lp = _log_softmax(logits)
    probs = torch.exp(lp)
    m = valid.float()
    onehot = _onehot(labels, c, m[:, None])
    n_pos = onehot.sum(0)
    n_neg = (m.sum() - n_pos).clamp(min=1.0)
    neg_w = torch.clamp(3.0 * n_pos / n_neg, max=1.0)
    sample_w = onehot + (m[:, None] - onehot) * neg_w[None, :]
    p = probs * m[:, None]
    num = 2.0 * (p * onehot * sample_w).sum(0) + smooth
    den = ((p**exponent + onehot) * sample_w).sum(0) + smooth
    dice_c = torch.clamp(num / den, 1e-6, 1.0)
    keep = _kept(c, ignore_index, logits.device)
    l_dice = torch.where(keep, (-torch.log(dice_c)) ** gamma_dice, 0.0).sum() / c
    labels_c = labels.clamp(0, c - 1)
    logpt = label_lp(lp, labels_c)
    wl = cls_weight[labels_c] if cls_weight is not None else 1.0
    l_cross = (wl * ((-logpt) ** gamma_cross) * m).sum() / m.sum().clamp(min=1e-8)
    return w_dice * l_dice + w_cross * l_cross


def wce_weights(
    cls_num_pts: Sequence[float], ignore_index: int = 0, normalize: bool = True
) -> np.ndarray:
    """1/sqrt(freq) class weights with the reference's double
    normalisation (JAX :99; reference `pcseg/loss/wce_loss.py:16-26`),
    float32 numpy."""
    n = np.asarray(cls_num_pts, np.float64)
    f = n / n.sum()
    w = 1.0 / np.sqrt(np.maximum(f, 1e-12))
    w[ignore_index] = 0.0
    if normalize:
        w = w / w.sum() * len(n)
    w = w / ((w * n).sum() / n.sum())
    return w.astype(np.float32)


class Losses:
    """Weighted sum of named losses over masked per-point logits:
    `losses(logits (N, C), labels (N,), point_valid (N,))`, the types and
    arguments of JAX's `Losses` (:114).  WCELoss needs `cls_num_pts` (it
    asserts without, as JAX); ELLLoss weighs its CE term by the
    unnormalised `wce_weights` where `cls_num_pts` is given;
    GroupSoftmax(_fgbg_2) needs `gs_groups` (and `gs_fg_classes`).  With
    EQLv2 the stack is stateful: `init_state` gives the statistics and a
    call takes and returns them, `(loss, new_state)`; `dist` (JAX's
    `axis_name`, MODEL.IF_DIST) sums the step's statistics over the
    ranks."""

    def __init__(
        self,
        loss_types: Sequence[str],
        loss_weights: Sequence[float],
        *,
        ignore_index: int = 0,
        label_smoothing: float = 0.0,
        cls_num_pts: Optional[Sequence[float]] = None,
        class_weight=None,
        gs_groups=None,
        gs_fg_classes=None,
        dist: bool = False,
    ):
        if len(loss_types) != len(loss_weights):
            raise ValueError("one weight per loss type")
        unknown = [t for t in loss_types if t not in LOSS_TYPES]
        if unknown:
            raise ValueError(f"unknown loss types {unknown}; the types are {list(LOSS_TYPES)}")
        self.loss_types = list(loss_types)
        self.loss_weights = list(loss_weights)
        self.ignore_index = ignore_index
        self.label_smoothing = label_smoothing
        as_t = lambda a: None if a is None else torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
        self.class_weight = as_t(class_weight)
        self.wce_w = as_t(None if cls_num_pts is None else wce_weights(cls_num_pts, ignore_index))
        self.ell_weight = as_t(
            None if cls_num_pts is None else wce_weights(cls_num_pts, ignore_index, normalize=False)
        )
        self.gs_groups = gs_groups
        self.gs_fg_classes = gs_fg_classes
        self.dist = dist
        self.stateful = "EQLv2" in self.loss_types

    def init_state(self, num_classes: int, device=None):
        """The EQLv2 statistics at the start (zeros), or None for a
        stateless stack (JAX :165)."""
        if not self.stateful:
            return None
        from .eqlv2 import EqlV2State

        return EqlV2State.init(num_classes, device)

    @staticmethod
    def _on(t: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
        return None if t is None else t.to(device)

    def __call__(
        self, logits: torch.Tensor, labels: torch.Tensor, point_valid: torch.Tensor,
        loss_state=None,
    ):
        """The scalar loss; for a stateful stack (EQLv2) (loss, the new
        state)."""
        dev = logits.device
        valid = point_valid & (labels != self.ignore_index)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        new_state = loss_state
        for name, w in zip(self.loss_types, self.loss_weights):
            if name in ("CELoss", "WCELoss"):
                cw = self.class_weight
                if name == "WCELoss":
                    assert self.wce_w is not None, "WCELoss needs cls_num_pts"
                    cw = self.wce_w
                l = cross_entropy(
                    logits, labels, valid, label_smoothing=self.label_smoothing,
                    class_weight=self._on(cw, dev),
                )
            elif name == "LovLoss":
                l = lovasz_softmax(logits, labels, valid)
            elif name == "FocalLoss":
                l = focal_loss(logits, labels, valid)
            elif name == "DiceLossV0":
                l = dice_loss(logits, labels, valid, ignore_index=self.ignore_index)
            elif name == "DiceLossV1":
                l = dice_loss_v1(logits, labels, valid, ignore_index=self.ignore_index)
            elif name == "ELLLoss":
                l = ell_loss(
                    logits, labels, valid, ignore_index=self.ignore_index,
                    cls_weight=self._on(self.ell_weight, dev),
                )
            elif name == "EQLv2":
                from .eqlv2 import eqlv2_loss

                assert loss_state is not None, "EQLv2 needs loss_state (Losses.init_state)"
                l, new_state = eqlv2_loss(logits, labels, valid, loss_state, dist=self.dist)
            elif name == "GroupSoftmax":
                from .eqlv2 import group_softmax_loss

                assert self.gs_groups, "GroupSoftmax needs gs_groups"
                l = group_softmax_loss(logits, labels, valid, self.gs_groups)
            else:  # GroupSoftmax_fgbg_2
                from .eqlv2 import group_softmax_fgbg_loss

                assert self.gs_groups and self.gs_fg_classes, (
                    "GroupSoftmax_fgbg_2 needs gs_groups + gs_fg_classes"
                )
                l = group_softmax_fgbg_loss(logits, labels, valid, self.gs_groups, self.gs_fg_classes)
            total = total + w * l
        if self.stateful:
            return total, new_state
        return total
