"""Segmentation metrics: confusion histogram + per-class IoU.

Port of `taseg_tpu/utils/metrics.py` (reference `fast_hist` /
`per_class_iu`, train.py:35-52).  `confusion_hist` runs on the device of
its inputs as one `torch.bincount` over the valid rows; JAX contracts
one-hot matrices instead, a workaround for the TPU's slow scatters.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_hist(
    pred: torch.Tensor,
    label: torch.Tensor,
    valid: torch.Tensor,
    num_classes: int,
) -> torch.Tensor:
    """(C, C) int64 histogram hist[gt, pred] over the valid rows whose
    label lies in [0, C); predictions are clipped to [0, C)."""
    ok = valid & (label >= 0) & (label < num_classes)
    gt = label[ok].long()
    pr = pred[ok].long().clamp(0, num_classes - 1)
    hist = torch.bincount(gt * num_classes + pr, minlength=num_classes**2)
    return hist.reshape(num_classes, num_classes)


def per_class_iou(hist: np.ndarray) -> np.ndarray:
    hist = np.asarray(hist, np.float64)
    tp = np.diag(hist)
    denom = hist.sum(1) + hist.sum(0) - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        return tp / denom


def miou_from_hist(hist: np.ndarray, ignore_index: int = 0) -> float:
    """Mean IoU over non-ignored classes, NaN-skipping like the reference
    (train.py:577-596 drops the ignore class then averages)."""
    iou = per_class_iou(np.asarray(hist))
    keep = np.ones(len(iou), bool)
    keep[ignore_index] = False
    vals = iou[keep]
    return float(np.nanmean(vals) * 100.0)


def format_confusion(hist, names, max_cols: int = 26) -> str:
    """Row-normalized confusion-matrix table (reference train.py:588-609,
    PrettyTable replaced with plain fixed-width text)."""
    h = np.asarray(hist, np.float64)
    rows = h / np.maximum(h.sum(axis=1, keepdims=True), 1.0)
    n = min(len(names), max_cols)
    short = [str(nm)[:6] for nm in names[:n]]
    head = " " * 12 + " ".join(f"{s:>6s}" for s in short)
    lines = [head]
    for i in range(n):
        vals = " ".join(f"{100 * rows[i, j]:6.1f}" for j in range(n))
        lines.append(f"{short[i]:>10s}: {vals}")
    return "\n".join(lines)
