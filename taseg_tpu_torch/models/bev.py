"""Global pools and the ToBEV family as `nn.Module`s (port of
`taseg_tpu/models/bev.py`; torchsparse `nn/modules/pooling.py` and
`nn/modules/bev.py`) over the static-capacity `SparseGrid`.

The parameterised modules hold `kernel` (n_kernels, C_in, C_out) and,
with `use_bias`, `bias` (C_out,), as the flax tree names them, so
`utils.params_from_jax` maps the two one to one.  Their kernels start
from uniform(-1/sqrt(C_in), 1/sqrt(C_in)) draws (the reference's init,
bev.py:84-86, 134-136; JAX `_kernel_init :33`) from the `generator`
given (torch's default where None), biases from 0.  Dense outputs are
NHWC, as in JAX.  The ops and the kernels they run: `ops/bev.py`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.bev import (
    _slice_kernel_matmul,
    bev_height_compression,
    bev_reduction,
    bev_sparse_conv,
    global_avg_pool,
    global_max_pool,
    to_dense_bev,
)
from ..ops.coords import GridBounds
from ..ops.sparse_tensor import SparseGrid


def kernel_init(shape: tuple, c_in: int, generator=None, device=None) -> torch.Tensor:
    """uniform(-1/sqrt(c_in), 1/sqrt(c_in)) of `shape` (JAX `_kernel_init`)."""
    std = 1.0 / math.sqrt(c_in)
    u = torch.rand(shape, generator=generator, device=device)
    return u * (2 * std) - std


class _Sliced(nn.Module):
    """The kernel (and bias) of a height-sliced FC."""

    def __init__(self, in_channels, out_channels, n_kernels, use_bias, generator, device):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        shape = (int(n_kernels), in_channels, out_channels)
        self.kernel = nn.Parameter(kernel_init(shape, in_channels, generator, device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device)) if use_bias else None


class GlobalAvgPool(nn.Module):
    """(B, C) batch-mean pool (ts `modules/pooling.py:11-14`)."""

    def __init__(self, batch_size: int):
        super().__init__()
        self.batch_size = batch_size

    def forward(self, grid: SparseGrid) -> torch.Tensor:
        return global_avg_pool(grid, self.batch_size)


class GlobalMaxPool(nn.Module):
    """(B, C) batch-max pool (ts `modules/pooling.py:17-20`)."""

    def __init__(self, batch_size: int):
        super().__init__()
        self.batch_size = batch_size

    def forward(self, grid: SparseGrid) -> torch.Tensor:
        return global_max_pool(grid, self.batch_size)


class ToBEVReduction(nn.Module):
    """Sparse BEV mean over the collapsed axis (ts bev.py:18-37)."""

    def __init__(self, dim: int = 2):
        super().__init__()
        self.dim = dim

    def forward(self, grid: SparseGrid, bounds: GridBounds) -> SparseGrid:
        return bev_reduction(grid, bounds, dim=self.dim)


class ToDenseBEVConvolution(_Sliced):
    """Height-sliced FC + dense BEV scatter-sum -> (B, H, W, C_out)
    (ts bev.py:40-110; NHWC)."""

    def __init__(
        self, in_channels: int, out_channels: int, shape: tuple, offset: tuple = (0, 0, 0),
        dim: int = 2, use_bias: bool = False, batch_size: int = 1, generator=None, device=None,
    ):
        super().__init__(in_channels, out_channels, shape[dim], use_bias, generator, device)
        self.shape, self.offset, self.dim, self.batch_size = tuple(shape), tuple(offset), dim, batch_size

    def forward(self, grid: SparseGrid) -> torch.Tensor:
        bev_dims = [i for i in range(3) if i != self.dim]
        feats = _slice_kernel_matmul(grid.feats, grid.coords, self.kernel, grid.stride, self.dim)
        if self.bias is not None:
            feats = feats + self.bias.to(feats.dtype)
        return to_dense_bev(
            grid, feats, self.batch_size,
            (int(self.shape[bev_dims[0]]), int(self.shape[bev_dims[1]])),
            offset=self.offset, dim=self.dim,
        )


class ToBEVConvolution(_Sliced):
    """Height-sliced FC + sparse column sum (ts bev.py:113-160)."""

    def __init__(
        self, in_channels: int, out_channels: int, n_kernels: int, stride: int = 1, dim: int = 2,
        use_bias: bool = False, generator=None, device=None,
    ):
        super().__init__(in_channels, out_channels, n_kernels, use_bias, generator, device)
        self.stride, self.dim = stride, dim

    def forward(self, grid: SparseGrid, bounds: GridBounds) -> SparseGrid:
        return bev_sparse_conv(
            grid, self.kernel, bounds, out_stride=self.stride, dim=self.dim, bias=self.bias,
        )


class ToBEVHeightCompression(nn.Module):
    """Flatten height into channels -> (B, H, W, D*C) (ts bev.py:163-210)."""

    def __init__(
        self, channels: int, shape: tuple, offset: tuple = (0, 0, 0), dim: int = 2,
        batch_size: int = 1,
    ):
        super().__init__()
        self.channels, self.shape, self.offset = channels, tuple(shape), tuple(offset)
        self.dim, self.batch_size = dim, batch_size

    def forward(self, grid: SparseGrid) -> torch.Tensor:
        return bev_height_compression(
            grid, self.batch_size, self.shape, offset=self.offset, dim=self.dim,
        )


__all__ = [
    "GlobalAvgPool", "GlobalMaxPool", "ToBEVConvolution", "ToBEVHeightCompression",
    "ToBEVReduction", "ToDenseBEVConvolution",
]
