"""Range-view (dense 2D) losses (port of `taseg_tpu/loss/range.py`;
reference `range/utils.py`, `salsanext.py:211-224, 251-270`): weighted
CE with the SemanticKITTI inverse-frequency table and optional top-k
pixel OHEM, the image Lovász-softmax and the boundary F1 loss over
max-pooled boundary maps.  Logits are NHWC; every pixel has a static
place, invalid ones weigh 0.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _log_softmax
from .lovasz import lovasz_softmax
from .util import label_lp

# SemanticKITTI per-class pixel frequencies (the constants of reference
# range/utils.py:344-367 ClassWeightSemikitti)
_KITTI_PIXEL_FREQ = np.array(
    [
        0.0,
        0.040818519255974316 + 0.001789309418528068,
        0.00016609538710764618,
        0.00039838616015114444,
        0.0020633612104619787 + 0.00010157861367183268,
        2.7879693665067774e-05 + 0.0016218197275284021
        + 0.00011351574470342043 + 4.3840131989471124e-05,
        0.00017698551338515307 + 0.00016059776092534436,
        1.1065903904919655e-08 + 0.00012709999297008662,
        5.532951952459828e-09 + 3.745553104802113e-05,
        0.1987493871255525 + 4.7084144280367186e-05,
        0.014717169549888214,
        0.14392298360372,
        0.0039048553037472045,
        0.1326861944777486,
        0.0723592229456223,
        0.26681502148037506,
        0.006035012012626033,
        0.07814222006271769,
        0.002855498193863172,
        0.0006155958086189918,
    ]
)


def semkitti_class_weights() -> np.ndarray:
    w = 1.0 / (_KITTI_PIXEL_FREQ + 0.001)
    w[0] = 0.0
    return w.astype(np.float32)


def range_class_weights(dataset: str, num_class: int, override=None) -> np.ndarray:
    """WCE weights: MODEL.LOSS_CONFIG.CLASS_WEIGHT where given, the KITTI
    inverse frequencies for the SemanticKITTI family (and the synthetic
    scans), else uniform with class 0 ignored (JAX :56-78)."""
    if override is not None:
        w = np.asarray(override, np.float32)
        if len(w) != num_class:
            raise ValueError(f"CLASS_WEIGHT has {len(w)} entries, model has {num_class}")
        return w
    if str(dataset).startswith(("semantickitti", "scribblekitti", "synthetic")):
        return semkitti_class_weights()[:num_class]
    w = np.ones(num_class, np.float32)
    w[0] = 0.0
    return w


def weighted_ce_image(
    logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor, *,
    class_weight: torch.Tensor, top_k_percent: float = 1.0,
) -> torch.Tensor:
    """Per-pixel weighted CE over logits (..., C): the weighted mean, or
    with top_k_percent < 1 the mean of the max(1, int(top_k_percent x
    pixels)) largest weighted losses (OHEM, reference
    salsanext.py:251-259)."""
    c = logits.shape[-1]
    flat_labels = labels.reshape(-1).long().clamp(0, c - 1)
    lp = _log_softmax(logits.reshape(-1, c))
    nll = -label_lp(lp, flat_labels)
    w = class_weight[flat_labels] * valid.reshape(-1).float()
    pixel_losses = nll * w
    if top_k_percent >= 1.0:
        return pixel_losses.sum() / torch.clamp(w.sum(), min=1e-8)
    k = max(1, int(top_k_percent * pixel_losses.shape[0]))
    return torch.topk(pixel_losses, k, sorted=False).values.mean()


def boundary_loss(
    logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor, *, theta0: int = 3
) -> torch.Tensor:
    """1 - the boundary F1 score, averaged over the images and classes
    (Bokhovkin et al.; reference range/utils.py:665-720): the boundary
    maps are the theta0 x theta0 max pool ("SAME", stride 1) of
    1 - one-hot and 1 - softmax, minus their input."""
    n, h, w, c = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = F.one_hot(labels.long().clamp(0, c - 1), c).float() * valid[..., None].float()

    def boundary(x):
        inv = (1.0 - x).permute(0, 3, 1, 2)
        pooled = F.max_pool2d(inv, theta0, stride=1, padding=theta0 // 2)
        return (pooled - inv).permute(0, 2, 3, 1).reshape(n, -1, c)

    gt_b, pr_b = boundary(onehot), boundary(probs)
    inter = (pr_b * gt_b).sum(1)
    precision = inter / (pr_b.sum(1) + 1e-7)
    recall = inter / (gt_b.sum(1) + 1e-7)
    f1 = 2 * precision * recall / (precision + recall + 1e-7)
    return (1.0 - f1).mean()


def salsanext_loss(
    logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor, *,
    class_weight: torch.Tensor, top_k_percent: float = 1.0, ls_weight: float = 3.0,
    bd_weight: float = 1.0,
) -> torch.Tensor:
    """WCE + ls_weight x Lovász (over the valid pixels of a class other
    than 0) + bd_weight x boundary (reference salsanext.py:270)."""
    loss = weighted_ce_image(
        logits, labels, valid, class_weight=class_weight, top_k_percent=top_k_percent
    )
    if ls_weight:
        c = logits.shape[-1]
        flat = labels.reshape(-1)
        loss = loss + ls_weight * lovasz_softmax(
            logits.reshape(-1, c), flat.long(), valid.reshape(-1) & (flat != 0)
        )
    if bd_weight:
        loss = loss + bd_weight * boundary_loss(logits, labels, valid)
    return loss
