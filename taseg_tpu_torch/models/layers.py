"""Sparse building blocks as `nn.Module`s (port of
`taseg_tpu/models/layers.py`, train and eval forms).

Every module works on a (V, C) feature matrix plus a rulebook or strided
table, never on a dynamically sized tensor.  Submodule and parameter
names follow the flax tree (`SparseConv_0/kernel`,
`MaskedBatchNorm_0/{scale,bias}` + `{mean,var}` buffers, ...), so
`utils.params_from_jax` maps the two one to one.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.sparse_conv import k3_conv
from ..ops.strided_conv import StridedTables, downsample_conv, upsample_conv


class SparseConv(nn.Module):
    """Sparse conv with weights (K, C_in, C_out); K = 1 is a plain matmul.

    Called with a (27, V) rulebook, or a tuple (rulebook, flipped
    rulebook, K4's pair lists) where a gradient is wanted, it runs the
    stride-1 conv (K2, backward K2 + K4); with `StridedTables` the
    ks=2/stride=2 pair (K3, backward K3 + K5), `transposed` picking the
    direction.  The weight is cast to the activation dtype first, so a
    bf16 stream stays bf16 (JAX layers.py:104-107), and its gradient
    comes back in that dtype."""

    def __init__(
        self, in_channels: int, out_channels: int, kernel_volume: int,
        transposed: bool = False, device=None,
    ):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_volume = kernel_volume
        self.transposed = transposed
        shape = (
            (in_channels, out_channels)
            if kernel_volume == 1
            else (kernel_volume, in_channels, out_channels)
        )
        self.kernel = nn.Parameter(torch.empty(shape, device=device))

    @property
    def fan(self) -> int:
        """Fan of the torchsparse init (`_conv_init` in the JAX layers)."""
        return self.out_channels if self.transposed else self.in_channels

    def forward(self, feats: torch.Tensor, rulebook=None) -> torch.Tensor:
        w = self.kernel.to(feats.dtype)
        if self.kernel_volume == 1:
            return feats @ w
        if isinstance(rulebook, StridedTables):
            apply = upsample_conv if self.transposed else downsample_conv
            return apply(feats, w.contiguous(), rulebook)
        if self.kernel_volume != 27:
            raise ValueError("only 27-point rulebook convs are supported")
        rb, rb_bwd, pairs = rulebook if isinstance(rulebook, tuple) else (rulebook, None, None)
        return k3_conv(feats, w.contiguous(), rb, rb_bwd, pairs)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the valid rows of a level (JAX layers.py:176-243).

    Train mode: batch statistics over the rows where `mask` is True, in
    f32; the running mean and (unbiased) var are buffers updated in place
    with `momentum` (torch convention, 0.1 by default; the models pass
    `MODEL.BN_MOMENTUM`) under `no_grad`; x is normalised in its own dtype,
    in the JAX order, and padding rows come out 0.  Eval mode: running
    statistics are constants, so the layer is one multiply-add `x * g + b`
    in the activation dtype (JAX layers.py:225-237) and padding rows are
    not reset (nothing reads them)."""

    def __init__(
        self, channels: int, epsilon: float = 1e-5, momentum: float = 0.1,
        device=None,
    ):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor, mask: torch.Tensor = None) -> torch.Tensor:
        if not self.training:
            inv = torch.rsqrt(self.var + self.epsilon)
            g = (self.scale * inv).to(x.dtype)
            b = (self.bias - self.mean * self.scale * inv).to(x.dtype)
            return x * g + b
        if mask is None:
            raise ValueError("MaskedBatchNorm in train mode needs the row mask")
        m = mask.float()[:, None]
        xf = x.float()
        cnt = m.sum().clamp(min=1.0)
        mean = (xf * m).sum(0) / cnt
        var = ((xf * xf * m).sum(0) / cnt - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
            mo = self.momentum
            self.mean.copy_((1 - mo) * self.mean + mo * mean)
            self.var.copy_((1 - mo) * self.var + mo * unbiased)
        eps = torch.tensor(self.epsilon, dtype=x.dtype, device=x.device)
        y = (x - mean.to(x.dtype)) * torch.rsqrt(var.to(x.dtype) + eps)
        y = y * self.scale.to(x.dtype) + self.bias.to(x.dtype)
        return torch.where(mask[:, None], y, 0.0)


class ConvBNReLU(nn.Module):
    """spnn.Conv3d -> BatchNorm -> ReLU (reference BasicConvolutionBlock /
    BasicDeconvolutionBlock, minkunet.py:31-80)."""

    def __init__(
        self, in_channels: int, out_channels: int, kernel_volume: int,
        transposed: bool = False, bn_momentum: float = 0.1, device=None,
    ):
        super().__init__()
        self.SparseConv_0 = SparseConv(
            in_channels, out_channels, kernel_volume, transposed, device=device
        )
        self.MaskedBatchNorm_0 = MaskedBatchNorm(
            out_channels, momentum=bn_momentum, device=device
        )

    def forward(self, feats, rulebook, mask=None):
        h = self.SparseConv_0(feats, rulebook)
        return torch.relu(self.MaskedBatchNorm_0(h, mask))


class ResidualBlock(nn.Module):
    """Two 3x3x3 sparse convs + BN with identity or 1x1-projected
    shortcut (reference minkunet.py:83-129)."""

    expansion = 1

    def __init__(
        self, in_channels: int, out_channels: int, bn_momentum: float = 0.1,
        device=None,
    ):
        super().__init__()
        bn = dict(momentum=bn_momentum, device=device)
        self.SparseConv_0 = SparseConv(in_channels, out_channels, 27, device=device)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(out_channels, **bn)
        self.SparseConv_1 = SparseConv(out_channels, out_channels, 27, device=device)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(out_channels, **bn)
        self.project = in_channels != out_channels
        if self.project:
            self.SparseConv_2 = SparseConv(in_channels, out_channels, 1, device=device)
            self.MaskedBatchNorm_2 = MaskedBatchNorm(out_channels, **bn)

    def forward(self, feats, rulebook, mask=None):
        h = torch.relu(self.MaskedBatchNorm_0(self.SparseConv_0(feats, rulebook), mask))
        h = self.MaskedBatchNorm_1(self.SparseConv_1(h, rulebook), mask)
        if self.project:
            short = self.MaskedBatchNorm_2(self.SparseConv_2(feats), mask)
        else:
            short = feats
        return torch.relu(h + short)


BLOCKS = {"ResBlock": ResidualBlock}
