"""Label and permutation gathers of the losses (port of
`taseg_tpu/loss/util.py`).

`label_lp` keeps the JAX one-hot contraction, and `PermuteRows` the
custom VJP that gathers by the inverse permutation, so that both losses
compute what the JAX package computes, in the same order.
"""

from __future__ import annotations

import torch


def label_lp(lp: torch.Tensor, labels_c: torch.Tensor) -> torch.Tensor:
    """lp[i, labels_c[i]] as a one-hot contraction (JAX util.py:16)."""
    c = lp.shape[-1]
    onehot = torch.arange(c, device=lp.device)[None, :] == labels_c[:, None]
    return torch.where(onehot, lp, 0).sum(1)


class PermuteRows(torch.autograd.Function):
    """take_along_dim(x, perm, 0) whose gradient gathers by `inv`, the
    inverse permutation per column (JAX util.py:32 permute_rows)."""

    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(inv)
        return torch.take_along_dim(x, perm, 0)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return torch.take_along_dim(g, inv, 0), None, None


def permute_rows(x: torch.Tensor, perm: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    return PermuteRows.apply(x, perm, inv)
