"""Lovász-Softmax loss, masked static-shape form (port of
`taseg_tpu/loss/lovasz.py`): per class present in the labels, the
per-point errors |fg - p| sorted descending (a stable sort, as
`jnp.argsort`) against the gradient of the Lovász extension of the
Jaccard index.  Invalid rows have error 0 and fg 0, so they sort to the
tail and add nothing.
"""

from __future__ import annotations

import torch

from .util import permute_rows


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """(C, N) 0/1 indicators in descending error order -> the Lovász
    extension's gradient along the sorted axis."""
    gts = gt_sorted.sum(-1, keepdim=True)
    intersection = gts - torch.cumsum(gt_sorted, -1)
    union = gts + torch.cumsum(1.0 - gt_sorted, -1)
    jaccard = 1.0 - intersection / union.clamp(min=1e-9)
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]], -1)


def lovasz_softmax(
    logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Masked Lovász-softmax over (N, C) logits, averaged over the
    classes present in the valid labels."""
    n, c = logits.shape
    x = logits.float()
    probs = torch.exp(x - logits.max(-1, keepdim=True).values.float())
    probs = probs / probs.sum(-1, keepdim=True)

    labels = labels.clamp(0, c - 1)
    fg = (torch.arange(c, device=logits.device)[None, :] == labels[:, None]).float()
    fg = fg * valid[:, None].float()
    errors = (fg - probs).abs() * valid[:, None]

    order = torch.argsort(-errors.detach(), dim=0, stable=True)
    inv = torch.argsort(order, dim=0, stable=True)
    errors_sorted = permute_rows(errors, order, inv).t()
    fg_sorted = permute_rows(fg, order, inv).t()

    per_class = (errors_sorted * _lovasz_grad(fg_sorted)).sum(-1)
    present = fg.sum(0) > 0
    return torch.where(present, per_class, 0.0).sum() / present.float().sum().clamp(min=1.0)
