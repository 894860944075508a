"""EQLv2, GroupSoftmax and the geometric loss (port of
`taseg_tpu/loss/eqlv2.py`; reference `pcseg/loss/eqlv2.py:8-130`,
`group_softmax.py`, `group_softmax_fgbg_2.py`, `geo_loss.py`).

EQLv2 is a per-class sigmoid BCE whose positive and negative weights
follow the RUNNING ratio of the accumulated positive to negative gradient
magnitudes.  The reference keeps that ratio as mutable module state with
a `dist.all_reduce` each step; JAX threads it as an explicit `EqlV2State`
through the train step.  Here it is an `EqlV2State` of two tensors that
the caller keeps (the engine's Trainer carries it across steps and in
its checkpoint); `dist` sums a step's statistics over the ranks, as
JAX's `psum` over the mesh axis.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import parallel
from .util import label_lp


class EqlV2State(NamedTuple):
    pos_grad: torch.Tensor  # (C-1,) accumulated |grad| on positives
    neg_grad: torch.Tensor  # (C-1,) accumulated |grad| on negatives

    @staticmethod
    def init(num_classes: int, device=None) -> "EqlV2State":
        z = torch.zeros(num_classes - 1, dtype=torch.float32, device=device)
        return EqlV2State(pos_grad=z, neg_grad=z.clone())


def eqlv2_loss(
    logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor, state: EqlV2State,
    *, gamma: float = 12.0, mu: float = 0.8, alpha: float = 4.0, dist: bool = False,
) -> tuple[torch.Tensor, EqlV2State]:
    """(loss, updated state) (JAX eqlv2.py:33).  Class 0 (ignore /
    undefined) keeps unit weights, as the reference's [1:] slicing.  The
    statistics take no gradient; with `dist` the step's sums are added
    over the ranks in one all-reduce before they join the state."""
    c = logits.shape[-1]
    x = logits.float()
    target = (torch.arange(c, device=x.device)[None, :] == labels.clamp(0, c - 1)[:, None]).float()
    m = valid.float()[:, None]
    with torch.no_grad():
        pos_neg = state.pos_grad / (state.neg_grad + 1e-10)
        mapped = 1.0 / (1.0 + torch.exp(-gamma * (pos_neg - mu)))
        neg_w_c = torch.cat([torch.ones(1, device=x.device), mapped])
        pos_w_c = 1.0 + alpha * (1.0 - neg_w_c)
        weight = pos_w_c[None, :] * target + neg_w_c[None, :] * (1.0 - target)
    bce = torch.clamp(x, min=0) - x * target + torch.log1p(torch.exp(-x.abs()))
    loss = (bce * weight * m).sum() / (m[:, 0].sum() + 1e-10)
    with torch.no_grad():
        prob = torch.sigmoid(x)
        grad = (target * (prob - 1.0) + (1.0 - target) * prob).abs()
        pos_g = (grad * target * weight * m).sum(0)[1:]
        neg_g = (grad * (1.0 - target) * weight * m).sum(0)[1:]
        if dist:
            both = parallel.sum_over_ranks(torch.cat([pos_g, neg_g]))
            pos_g, neg_g = both[: c - 1], both[c - 1 :]
    return loss, EqlV2State(pos_grad=state.pos_grad + pos_g, neg_grad=state.neg_grad + neg_g)


def group_softmax_loss(
    logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor, groups: list,
    *, beta: float = 8.0,
) -> torch.Tensor:
    """GroupSoftmax (JAX eqlv2.py:74; reference `group_softmax.py:14-195`,
    'fine-grained'): each group of classes (class 0 its own) gets a
    softmax over [others, members...], `others` the logsumexp of the
    out-of-group logits plus log(1 / beta), and the out-of-group points
    weigh 1 / beta (the expectation of the reference's sampling)."""
    c = logits.shape[-1]
    dev = logits.device
    x = logits.float()
    labels_c = labels.clamp(0, c - 1)
    m = valid.float()
    total = torch.zeros((), device=dev)
    denom = torch.zeros((), device=dev)
    for group in [[0]] + list(groups):
        gids = torch.as_tensor(group, dtype=torch.long, device=dev)
        in_group = torch.isin(labels_c, gids)
        comp = torch.ones(c, dtype=torch.bool, device=dev)
        comp[gids] = False
        others = torch.logsumexp(torch.where(comp[None, :], x, float("-inf")), 1) + torch.log(
            torch.tensor(1.0 / beta, device=dev)
        )
        glogits = torch.cat([others[:, None], x[:, gids]], 1)
        hits = (labels_c[:, None] == gids[None, :]).int()
        slot = torch.argmax(hits, 1) + 1
        gtarget = torch.where(in_group, slot, 0)
        nll = -label_lp(torch.log_softmax(glogits, 1), gtarget)
        w = m * torch.where(in_group, 1.0, 1.0 / beta)
        total = total + (nll * w).sum()
        denom = denom + w.sum()
    return total / denom.clamp(min=1e-8)


def group_softmax_fgbg_loss(
    logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor, groups: list,
    fg_classes: list, *, beta: float = 8.0,
) -> torch.Tensor:
    """GroupSoftmax plus a foreground / background 2-way softmax over
    every valid point (JAX eqlv2.py:123; reference
    `group_softmax_fgbg_2.py`)."""
    base = group_softmax_loss(logits, labels, valid, groups, beta=beta)
    c = logits.shape[-1]
    dev = logits.device
    x = logits.float()
    labels_c = labels.clamp(0, c - 1)
    m = valid.float()
    fg = torch.zeros(c, dtype=torch.bool, device=dev)
    fg[torch.as_tensor(list(fg_classes), dtype=torch.long, device=dev)] = True
    fg_logit = torch.logsumexp(torch.where(fg[None, :], x, float("-inf")), 1)
    bg_logit = torch.logsumexp(torch.where(~fg[None, :], x, float("-inf")), 1)
    lp = torch.log_softmax(torch.stack([bg_logit, fg_logit], 1), 1)
    nll = -label_lp(lp, fg[labels_c].long())
    return base + (nll * m).sum() / m.sum().clamp(min=1e-8)


def geo_loss(
    logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor, xyz: torch.Tensor,
    *, nsample: int = 10, max_points: int = 4096, lam: float = 1.0, alpha: float = 0.5,
    perm: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Local-geometric-anisotropy weighted NLL (JAX eqlv2.py:158;
    reference `geo_loss.py`): each point's CE weighs (lam + alpha x the
    number of its `nsample` nearest valid neighbours with another label)
    / nsample, normalised to mean 1 over the valid points, on a subset of
    `max_points` rows (a brute-force distance matrix).  The subset is the
    first rows of `perm`, or of a permutation drawn from `generator`
    (JAX's `rng_key`), or the first rows; the neighbours are taken as
    `lax.top_k` takes them, the lower row first among equal distances."""
    n, c = logits.shape
    dev = logits.device
    if perm is None:
        perm = torch.arange(n, device=dev) if generator is None else torch.randperm(
            n, generator=generator, device=generator.device
        ).to(dev)
    sub = perm[:max_points].long()
    sv = valid[sub]
    sl = labels[sub].clamp(0, c - 1)
    sx = xyz[sub].float()
    d2 = ((sx[:, None, :] - sx[None, :, :]) ** 2).sum(-1)
    d2 = torch.where(sv[None, :], d2, float("inf"))
    d2.fill_diagonal_(float("inf"))
    nn_idx = torch.sort(d2, dim=1, stable=True).indices[:, :nsample]
    lga = (sl[nn_idx] != sl[:, None]).sum(1).float()
    w = (lam + alpha * lga) / nsample
    m = sv.float()
    w = w / ((w * m).sum() / m.sum().clamp(min=1.0))
    nll = -label_lp(torch.log_softmax(logits[sub].float(), 1), sl)
    return (nll * w * m).sum() / m.sum().clamp(min=1.0)


__all__ = [
    "EqlV2State", "eqlv2_loss", "geo_loss", "group_softmax_fgbg_loss", "group_softmax_loss",
]
