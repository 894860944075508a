"""Sparse building blocks as `nn.Module`s (port of
`taseg_tpu/models/layers.py`, inference form).

Every module works on a (V, C) feature matrix plus a rulebook or strided
table, never on a dynamically sized tensor.  Submodule and parameter
names follow the flax tree (`SparseConv_0/kernel`,
`MaskedBatchNorm_0/{scale,bias}` + `{mean,var}` buffers, ...), so
`utils.params_from_jax` maps the two one to one.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.sparse_conv import sparse_conv_k3
from ..ops.strided_conv import (
    StridedTables,
    downsample_conv_apply,
    upsample_conv_apply,
)


class SparseConv(nn.Module):
    """Sparse conv with weights (K, C_in, C_out); K = 1 is a plain matmul.

    Called with a (27, V) rulebook it runs the stride-1 conv (K2); with
    `StridedTables` the ks=2/stride=2 pair (K3), `transposed` picking the
    direction.  The weight is cast to the activation dtype first, so a
    bf16 stream stays bf16 (JAX layers.py:104-107)."""

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
            apply = upsample_conv_apply if self.transposed else downsample_conv_apply
            return apply(feats, w.contiguous(), rulebook)
        if self.kernel_volume != 27:
            raise ValueError("only 27-point rulebook convs are supported")
        return sparse_conv_k3(feats, w.contiguous(), rulebook)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d at inference: running statistics are constants, so the
    layer is one multiply-add `x * g + b` in the activation dtype (JAX
    layers.py:225-237).  Padding rows are not reset: nothing reads them.
    The training form (masked batch statistics) is not ported yet."""

    def __init__(self, channels: int, epsilon: float = 1e-5, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm runs in eval mode only; call model.eval()"
            )
        inv = torch.rsqrt(self.var + self.epsilon)
        g = (self.scale * inv).to(x.dtype)
        b = (self.bias - self.mean * self.scale * inv).to(x.dtype)
        return x * g + b


class ConvBNReLU(nn.Module):
    """spnn.Conv3d -> BatchNorm -> ReLU (reference BasicConvolutionBlock /
    BasicDeconvolutionBlock, minkunet.py:31-80)."""

    def __init__(
        self, in_channels: int, out_channels: int, kernel_volume: int,
        transposed: bool = False, device=None,
    ):
        super().__init__()
        self.SparseConv_0 = SparseConv(
            in_channels, out_channels, kernel_volume, transposed, device=device
        )
        self.MaskedBatchNorm_0 = MaskedBatchNorm(out_channels, device=device)

    def forward(self, feats, rulebook):
        h = self.SparseConv_0(feats, rulebook)
        return torch.relu(self.MaskedBatchNorm_0(h))


class ResidualBlock(nn.Module):
    """Two 3x3x3 sparse convs + BN with identity or 1x1-projected
    shortcut (reference minkunet.py:83-129)."""

    expansion = 1

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.SparseConv_0 = SparseConv(in_channels, out_channels, 27, device=device)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(out_channels, device=device)
        self.SparseConv_1 = SparseConv(out_channels, out_channels, 27, device=device)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(out_channels, device=device)
        self.project = in_channels != out_channels
        if self.project:
            self.SparseConv_2 = SparseConv(in_channels, out_channels, 1, device=device)
            self.MaskedBatchNorm_2 = MaskedBatchNorm(out_channels, device=device)

    def forward(self, feats, rulebook):
        h = torch.relu(self.MaskedBatchNorm_0(self.SparseConv_0(feats, rulebook)))
        h = self.MaskedBatchNorm_1(self.SparseConv_1(h, rulebook))
        if self.project:
            short = self.MaskedBatchNorm_2(self.SparseConv_2(feats))
        else:
            short = feats
        return torch.relu(h + short)


BLOCKS = {"ResBlock": ResidualBlock}
