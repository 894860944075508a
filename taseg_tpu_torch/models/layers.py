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

from ..ops.sparse_conv import KTable, as_table, conv_k, k3_conv
from ..parallel import all_reduce_sum
from ..ops.strided_conv import StridedTables, downsample_conv, upsample_conv


class SparseConv(nn.Module):
    """Sparse conv with weights (K, C_in, C_out); K = 1 is a plain matmul.

    Called with a (K, V_out) rulebook or a `KTable` (a table with its row
    order and pair lists), or a tuple (forward table, reverse table) of
    either where a gradient is wanted.  K = 27 on a table with as many
    rows as the input (one level): the stride-1 3^3 conv
    (`k3_conv`, JAX's F3 and TGF routes; the route by dtype and widths:
    K2 at 27, backward K2 + K4, or in f32 the conv over K = 27 offsets on
    3xTF32).  Any other K, or 27 between two levels (SparseResNet's
    strided entry convs): the conv over K offsets (K2 at K, backward K2
    + K4 at K; JAX's `sparse_conv_apply`).  With `StridedTables` the
    ks=2/stride=2 pair (K3, backward K3 + K5), `transposed` picking the
    direction.  `transposed` also sets the init's fan (C_out,
    JAX layers.py:96).  The weight is cast to the activation dtype first,
    so a bf16 stream stays bf16 (JAX layers.py:104-107), and its gradient
    comes back in that dtype; where autograd records no graph (serving)
    the cast weight is kept until the kernel changes (`kernel_as`).
    `use_bias` adds a (C_out,) f32 bias after the conv, as JAX's
    `use_bias` (a bf16 output is promoted, as there)."""

    def __init__(
        self, in_channels: int, out_channels: int, kernel_volume: int,
        transposed: bool = False, use_bias: bool = False, device=None,
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
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        else:
            self.bias = None
        self._served = None

    @property
    def fan(self) -> int:
        """Fan of the torchsparse init (`_conv_init` in the JAX layers)."""
        return self.out_channels if self.transposed else self.in_channels

    def forward(self, feats: torch.Tensor, rulebook=None) -> torch.Tensor:
        out = self._conv(feats, rulebook)
        return out if self.bias is None else out + self.bias

    def kernel_as(self, dtype: torch.dtype) -> torch.Tensor:
        """The kernel in `dtype`: cast anew where autograd records the
        call, else kept (detached) while the kernel's version, storage and
        the dtype hold, so a served model casts each weight once and the
        conv wrappers pad it once (`sparse_conv.pad_weight`)."""
        k = self.kernel
        if torch.is_grad_enabled() and k.requires_grad:
            return k.to(dtype)
        key = (k._version, k.data_ptr(), k.device, dtype)
        if self._served is None or self._served[0] != key:
            self._served = (key, k.detach().to(dtype).contiguous())
        return self._served[1]

    def _conv(self, feats: torch.Tensor, rulebook) -> torch.Tensor:
        w = self.kernel_as(feats.dtype)
        if self.kernel_volume == 1:
            return feats @ w
        if isinstance(rulebook, StridedTables):
            apply = upsample_conv if self.transposed else downsample_conv
            return apply(feats, w.contiguous(), rulebook)
        pair = isinstance(rulebook, tuple) and not isinstance(rulebook, KTable)
        fwd, bwd = rulebook if pair else (rulebook, None)
        if self.kernel_volume == 27 and as_table(fwd).rb.shape[1] == feats.shape[0]:
            return k3_conv(feats, w.contiguous(), fwd, bwd)
        return conv_k(feats, w.contiguous(), fwd, bwd)


class Dense(nn.Module):
    """flax `nn.Dense`: kernel (C_in, C_out), bias (C_out,).  The input
    and the f32 parameters are promoted to their common dtype first, as
    flax promotes them, so a bf16 input gives an f32 product."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((in_features, out_features), device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.kernel.dtype)
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the valid rows of a level (JAX layers.py:176-243).

    Train mode: batch statistics over the rows where `mask` is True, in
    f32; the running mean and (unbiased) var are buffers updated in place
    with `momentum` (torch convention, 0.1 by default; the models pass
    `MODEL.BN_MOMENTUM`) under `no_grad`; x is normalised in its own dtype,
    in the JAX order, and padding rows come out 0; with `sync` (MODEL.
    IF_DIST, `parallel.sync_batchnorm`) the count, sum and sum of squares
    are summed over the ranks first.  Eval mode: running
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
        # sum the statistics over the ranks (`parallel.sync_batchnorm`)
        self.sync = False

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
        if self.sync:
            # count, sum and sum of squares summed over the ranks in one
            # all-reduce, whose backward sums the gradients too (JAX's
            # psum under shard_map)
            c = xf.shape[1]
            st = all_reduce_sum(torch.cat([m.sum().reshape(1), (xf * m).sum(0), (xf * xf * m).sum(0)]))
            cnt = st[0].clamp(min=1.0)
            mean = st[1 : c + 1] / cnt
            var = (st[c + 1 :] / cnt - mean * mean).clamp(min=0.0)
        else:
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


class Bottleneck(nn.Module):
    """1x1 -> BN -> 3x3x3 -> BN -> 1x1 to `out_channels * 4` -> BN, with
    an identity or 1x1-projected shortcut, then ReLU (JAX
    layers.py:301-332, reference minkunet.py:132-183; as there, no ReLU
    between the three convs).  The 1x1 convs are dense products; the 3^3
    conv takes the `ResidualBlock` route (`k3_conv`)."""

    expansion = 4

    def __init__(
        self, in_channels: int, out_channels: int, bn_momentum: float = 0.1,
        device=None,
    ):
        super().__init__()
        bn = dict(momentum=bn_momentum, device=device)
        c_exp = out_channels * self.expansion
        self.SparseConv_0 = SparseConv(in_channels, out_channels, 1, device=device)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(out_channels, **bn)
        self.SparseConv_1 = SparseConv(out_channels, out_channels, 27, device=device)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(out_channels, **bn)
        self.SparseConv_2 = SparseConv(out_channels, c_exp, 1, device=device)
        self.MaskedBatchNorm_2 = MaskedBatchNorm(c_exp, **bn)
        self.project = in_channels != c_exp
        if self.project:
            self.SparseConv_3 = SparseConv(in_channels, c_exp, 1, device=device)
            self.MaskedBatchNorm_3 = MaskedBatchNorm(c_exp, **bn)

    def forward(self, feats, rulebook, mask=None):
        h = self.MaskedBatchNorm_0(self.SparseConv_0(feats), mask)
        h = self.MaskedBatchNorm_1(self.SparseConv_1(h, rulebook), mask)
        h = self.MaskedBatchNorm_2(self.SparseConv_2(h), mask)
        if self.project:
            short = self.MaskedBatchNorm_3(self.SparseConv_3(feats), mask)
        else:
            short = feats
        return torch.relu(h + short)


BLOCKS = {"ResBlock": ResidualBlock, "Bottleneck": Bottleneck}


class Dropout(nn.Module):
    """flax `nn.Dropout`: in train mode each value is kept with
    probability 1 - rate and scaled by 1 / (1 - rate), else set to 0; the
    identity in eval mode and at rate 0.  The keep mask is
    `uniform < 1 - rate` drawn from `generator` (a `torch.Generator` on
    the input's device, which `seed_dropout` gives every Dropout of a
    model; None draws from torch's default generator).  The masks are
    torch's random numbers, not JAX's: tests hold the two models against
    each other with the dropout off and test this layer on its own."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return torch.where(u < keep, x / keep, 0.0)


def seed_dropout(model: nn.Module, seed: int) -> torch.Generator:
    """One generator on the model's device, seeded with `seed`, for every
    `Dropout` of `model` (the masks of a train step follow from the seed
    and the steps before it); returned so a caller can save its state."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = gen
    return gen
