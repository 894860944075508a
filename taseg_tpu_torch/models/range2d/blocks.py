"""2D building blocks of the range-view branch, NHWC (port of
`taseg_tpu/models/range2d/blocks.py`, the reference's SalsaNext blocks,
`salsanext.py:9-175`).

Tensors stay NHWC at every module's boundary, as in JAX; each conv runs
as `F.conv2d` on the NCHW view of the NHWC tensor (channels-last
strides, which cuDNN takes as they are) and comes back NHWC.  Submodule
and parameter names follow the flax tree (`Conv_0/{kernel,bias}`,
`ConvActBN_1/BatchNorm_0/{scale,bias}` + `{mean,var}` buffers), so
`utils.params_from_jax` maps the two one to one.

The dtypes follow flax: `nn.Conv` has no dtype, so it promotes its input
against its f32 kernel and a bf16 input gives an f32 conv; every block
computes in f32 whatever the model's compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Dropout


def pixel_shuffle(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """NHWC depth-to-space as JAX splits it: channel c = (i * r + j) *
    C' + k goes to row y * r + i, column x * r + j, channel k (C' = C /
    r^2).  torch's PixelShuffle orders the channels (k, i, j) instead."""
    n, h, w, c = x.shape
    r = factor
    x = x.reshape(n, h, w, r, r, c // (r * r))
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.leaky_relu(x, 0.01)`: where(x >= 0, x, 0.01 x).  Its
    gradient at x = 0 is 1, where torch's `F.leaky_relu` gives 0.01; the
    range image's empty pixels (all channels 0) and the zero conv biases
    of the init make exact zeros common, so the difference shows in
    training."""
    return torch.where(x >= 0, x, 0.01 * x)


def same_pads(size: int, kernel: int, stride: int = 1, dilation: int = 1) -> tuple[int, int]:
    """flax "SAME" padding of one dimension: ceil(size / stride) outputs,
    the total padding they need, the odd one after (an even size at
    stride 2 pads (0, 1), where torch's symmetric `padding` cannot)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv(nn.Module):
    """flax `nn.Conv` (NHWC, "SAME" padding): kernel (kh, kw, C_in,
    C_out), bias (C_out,) where `use_bias`; input and parameters promoted
    to their common dtype first.  The padding follows the input's size
    (`same_pads`); an uneven one is applied with `F.pad` before the
    conv."""

    def __init__(
        self, in_features: int, features: int, kernel=(3, 3), dilation: int = 1,
        device=None, *, stride=1, use_bias: bool = True,
    ):
        super().__init__()
        self.dilation = dilation
        self.stride = _pair(stride)
        kh, kw = kernel
        self.kernel = nn.Parameter(torch.empty((kh, kw, in_features, features), device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.kernel.dtype)
        w = self.kernel.to(dt).permute(3, 2, 0, 1)
        b = None if self.bias is None else self.bias.to(dt)
        kh, kw = self.kernel.shape[:2]
        (t, bo), (l, r) = (
            same_pads(n, k, s, self.dilation)
            for n, k, s in zip(x.shape[1:3], (kh, kw), self.stride)
        )
        xc = x.to(dt).permute(0, 3, 1, 2)
        if (t, l) == (bo, r):
            pad = (t, l)
        else:
            xc, pad = F.pad(xc, (l, r, t, bo)), 0
        y = F.conv2d(xc, w, b, stride=self.stride, padding=pad, dilation=self.dilation)
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """flax `nn.ConvTranspose` ("SAME", no bias), as `lax.conv_transpose`
    computes it with `transpose_kernel=False`: the kernel (kh, kw, C_in,
    C_out) correlated, unflipped, with the stride-dilated input padded
    by (k + s - 2) split as lax splits it (k - 1 before where s > k - 1,
    else the ceiling half).  That is torch's `conv_transpose2d` of the
    flipped kernel with `padding` k - 1 - before, where the split is
    even (every call here: kernel (1, 4), strides (1, 2) pad (0, 0) and
    (2, 2), output 2W)."""

    def __init__(self, in_features: int, features: int, kernel=(1, 4), stride=(1, 2), device=None):
        super().__init__()
        self.stride = _pair(stride)
        kh, kw = kernel
        self.kernel = nn.Parameter(torch.empty((kh, kw, in_features, features), device=device))
        pads = []
        for k, s in zip(kernel, self.stride):
            total = k + s - 2
            before = k - 1 if s > k - 1 else -(-total // 2)
            if 2 * before != total:
                raise ValueError(f"kernel {k} at stride {s} pads unevenly")
            pads.append(k - 1 - before)
        self.padding = tuple(pads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.kernel.dtype)
        w = self.kernel.to(dt).permute(2, 3, 0, 1).flip((2, 3))
        y = F.conv_transpose2d(
            x.to(dt).permute(0, 3, 1, 2), w, stride=self.stride, padding=self.padding
        )
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm` over N, H, W (features last), epsilon 1e-5.

    Train mode: the batch mean and the biased variance E[x^2] - E[x]^2
    (clipped at 0) in f32, and the running statistics keep `momentum` of
    their value (flax's convention: 0.9 keeps 90%; the running variance
    is the biased one, where torch's BatchNorm2d keeps the unbiased).
    Both modes normalise as flax does: (x - mean) * (rsqrt(var + eps) *
    scale) + bias, in f32."""

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5, device=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = xf.mean(dims)
            var = ((xf * xf).mean(dims) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                mo = self.momentum
                self.mean.copy_(mo * self.mean + (1 - mo) * mean)
                self.var.copy_(mo * self.var + (1 - mo) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (xf - mean) * mul + self.bias


class ConvActBN(nn.Module):
    """Conv -> LeakyReLU(0.01) (`leaky_relu`) -> BatchNorm (momentum 0.9)."""

    def __init__(
        self, in_features: int, features: int, kernel=(3, 3), dilation: int = 1,
        use_bn: bool = True, device=None,
    ):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel, dilation, device=device)
        self.BatchNorm_0 = BatchNorm(features, device=device) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = leaky_relu(self.Conv_0(x))
        return x if self.BatchNorm_0 is None else self.BatchNorm_0(x)


class ResContextBlock(nn.Module):
    """1x1 shortcut + (3x3, 3x3 dilation 2) residual (salsanext.py:9-37)."""

    def __init__(self, in_features: int, features: int, device=None):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, (1, 1), device=device)
        self.ConvActBN_0 = ConvActBN(features, features, (3, 3), device=device)
        self.ConvActBN_1 = ConvActBN(features, features, (3, 3), 2, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = leaky_relu(self.Conv_0(x))
        return shortcut + self.ConvActBN_1(self.ConvActBN_0(shortcut))


def avg_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """flax `avg_pool(x, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)))`
    in NHWC: the padded zeros count (count_include_pad).  The pool runs on
    an NCHW-contiguous copy: on CUDA, torch 2.11's avg_pool2d backward
    returns a wrong input gradient for a channels-last input (the NCHW
    view of an NHWC tensor; tools/range_ops_check.py)."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2).contiguous(), 3, stride=2, padding=1, count_include_pad=True)
    return y.permute(0, 2, 3, 1)


class SalsaResBlock(nn.Module):
    """Three dilated branches, concatenated -> 1x1 fuse, plus a 1x1
    shortcut; dropout at `dropout_rate` (0.2, whatever the model's
    DROPOUT_P) where `drop_out`; 3x3/2 average pool where `pooling`
    (salsanext.py:40-115).  Returns (pooled, pre-pool) when pooling, else
    the features."""

    def __init__(
        self, in_features: int, features: int, dropout_rate: float = 0.2,
        pooling: bool = True, drop_out: bool = True, device=None,
    ):
        super().__init__()
        self.pooling = pooling
        f = features
        self.Conv_0 = Conv(in_features, f, (1, 1), device=device)
        self.ConvActBN_0 = ConvActBN(in_features, f, (3, 3), device=device)
        self.ConvActBN_1 = ConvActBN(f, f, (3, 3), 2, device=device)
        self.ConvActBN_2 = ConvActBN(f, f, (2, 2), 2, device=device)
        self.ConvActBN_3 = ConvActBN(3 * f, f, (1, 1), device=device)
        self.dropout = Dropout(dropout_rate) if drop_out else None

    def forward(self, x: torch.Tensor):
        shortcut = leaky_relu(self.Conv_0(x))
        a1 = self.ConvActBN_0(x)
        a2 = self.ConvActBN_1(a1)
        a3 = self.ConvActBN_2(a2)
        res = shortcut + self.ConvActBN_3(torch.cat([a1, a2, a3], dim=-1))
        out = res if self.dropout is None else self.dropout(res)
        if self.pooling:
            return avg_pool_3x3_s2(out), res
        return out


class SalsaUpBlock(nn.Module):
    """PixelShuffle x2 -> concat the skip -> dilated branches -> 1x1 fuse,
    with dropout at `dropout_rate` after the shuffle, the concat and the
    fuse where `drop_out` (salsanext.py:117-175)."""

    def __init__(
        self, in_features: int, skip_features: int, features: int,
        dropout_rate: float = 0.2, drop_out: bool = True, device=None,
    ):
        super().__init__()
        f = features
        cin = in_features // 4 + skip_features
        self.ConvActBN_0 = ConvActBN(cin, f, (3, 3), device=device)
        self.ConvActBN_1 = ConvActBN(f, f, (3, 3), 2, device=device)
        self.ConvActBN_2 = ConvActBN(f, f, (2, 2), 2, device=device)
        self.ConvActBN_3 = ConvActBN(3 * f, f, (1, 1), device=device)
        self.dropout = Dropout(dropout_rate) if drop_out else None

    def _drop(self, x):
        return x if self.dropout is None else self.dropout(x)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = self._drop(pixel_shuffle(x, 2))
        h = self._drop(torch.cat([up.to(torch.promote_types(up.dtype, skip.dtype)), skip], dim=-1))
        e1 = self.ConvActBN_0(h)
        e2 = self.ConvActBN_1(e1)
        e3 = self.ConvActBN_2(e2)
        return self._drop(self.ConvActBN_3(torch.cat([e1, e2, e3], dim=-1)))
