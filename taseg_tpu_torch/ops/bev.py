"""Global pooling and BEV projection over static-capacity sparse grids
(port of `taseg_tpu/ops/bev.py`; torchsparse `nn/functional/pooling.py`
and the ToBEV module family, `nn/modules/bev.py:18-210`).

Every op runs on the port's hand kernels:

  * `global_avg_pool`: K6 (`segment_sum`) over per-batch segment tables,
    divided by the count, 0 for an empty batch (JAX takes a one-hot
    matmul in f32);
  * `global_max_pool`: K10 (`segment_max`) over the batch column; an
    empty batch gives 0, as JAX's `isfinite` mask does;
  * `bev_reduction`: `unique_coords` (one sort, as JAX's; K1 runs in
    the joins, not in a unique) and `voxelize_avg` (K6);
  * `_slice_kernel_matmul`: K2 at K offsets (`sparse_conv.conv_k`) over
    a (n_kernels, V) table whose only entry for row v is v itself, at the
    offset clip(coords[v, dim] // stride) (`slice_table`): every row has
    exactly one offset, so the table is its own reverse;
  * `to_dense_bev` and `bev_height_compression`: K6 over the segment
    tables of the flat cell ids into a dense (B·H·W[·D], C) f32 buffer
    (rows out of range or past `num` map to no segment, as JAX's
    out-of-range id is dropped), NHWC as in JAX; their gradient gathers
    each row's cell (K7's identity gather);
  * `bev_sparse_conv`: the slice matmul, then `unique_coords` and
    `voxelize_avg`, times the counts (JAX's sum of duplicate columns).

No TASeg recipe consumes these; they complete the engine's surface
(torchsparse's classification and BEV examples use them).
"""

from __future__ import annotations

import torch

from .coords import GridBounds
from .join import unique_coords
from .sparse_conv import conv_k
from .sparse_tensor import SparseGrid
from .voxelize import (
    SegmentTables,
    build_segment_tables,
    devoxelize_identity,
    segment_max,
    segment_sum,
    voxelize_avg,
)

# K2 at K offsets takes at most 32 offsets a call
MAX_SLICES = 32


class SegmentSumRows(torch.autograd.Function):
    """K6's sum of rows by segment (an (S, C) f32 result) with its
    gradient: each row gets its segment's gradient (K7's identity gather,
    0 for a dropped row), in the rows' dtype."""

    @staticmethod
    def forward(ctx, x, ids, tables):
        ctx.ids, ctx.dtype = ids, x.dtype
        return segment_sum(x, tables)

    @staticmethod
    def backward(ctx, g):
        return devoxelize_identity(g.float().contiguous(), ctx.ids).to(ctx.dtype), None, None


def segment_sum_rows(x: torch.Tensor, ids: torch.Tensor, tables: SegmentTables) -> torch.Tensor:
    """(V, C) f32: per id in [0, V) the sum of its rows of x, over
    `build_segment_tables(ids, V)`; rows with another id (-1) are
    dropped.  Differentiable in x."""
    if x.requires_grad and torch.is_grad_enabled():
        return SegmentSumRows.apply(x, ids, tables)
    return segment_sum(x, tables)


def _batch_ids(grid: SparseGrid, batch_size: int, drop: int) -> torch.Tensor:
    """The batch column of the valid rows, `drop` for the others."""
    b = grid.coords[:, 3].to(torch.int32)
    return torch.where(grid.valid_mask(), b, drop).to(torch.int32).contiguous()


def global_avg_pool(grid: SparseGrid, batch_size: int) -> torch.Tensor:
    """(B, C) per-batch mean over valid voxels (ts `pooling.py:9-17`), in
    the features' dtype."""
    bid = _batch_ids(grid, batch_size, -1)
    tables = build_segment_tables(bid, batch_size)
    sums = segment_sum_rows(grid.feats, bid, tables)
    n = tables.counts[:, None]
    mean = torch.where(n > 0, sums / n.clamp(min=1).float(), 0.0)  # an empty batch is 0, as in JAX
    return mean.to(grid.feats.dtype)


def global_max_pool(grid: SparseGrid, batch_size: int) -> torch.Tensor:
    """(B, C) per-batch max over valid voxels (ts `pooling.py:20-28`), in
    the features' dtype; an empty batch gives 0 (JAX's `isfinite`
    mask)."""
    bid = _batch_ids(grid, batch_size, batch_size)
    out = segment_max(grid.feats.float(), bid, batch_size + 1)[:batch_size]
    return torch.where(torch.isfinite(out), out, 0.0).to(grid.feats.dtype)


def bev_reduction(grid: SparseGrid, bounds: GridBounds, dim: int = 2) -> SparseGrid:
    """Collapse axis `dim` and average duplicate columns (ts
    `ToBEVReduction`, bev.py:18-37).  The output keeps the input
    capacity; `num` is the true column count."""
    coords = grid.coords.clone()
    coords[:, dim] = 0
    uc, num, inverse, _ = unique_coords(coords, grid.valid_mask(), bounds, grid.capacity)
    tables = build_segment_tables(inverse, grid.capacity)
    mean = voxelize_avg(grid.feats, inverse, tables)
    return SparseGrid(coords=uc, feats=mean, num=num, stride=grid.stride)


def slice_table(coords: torch.Tensor, n_kernels: int, stride: int, dim: int) -> torch.Tensor:
    """(n_kernels, V) int32 table of the slice matmul: rb[k, v] = v where
    k = clip(coords[v, dim] // stride, 0, n_kernels - 1) (floor
    division, as JAX's), else -1."""
    v = coords.shape[0]
    dev = coords.device
    z = torch.clamp(coords[:, dim].to(torch.int32) // int(stride), 0, n_kernels - 1)
    rows = torch.arange(v, dtype=torch.int32, device=dev)
    ks = torch.arange(n_kernels, dtype=torch.int32, device=dev)
    return torch.where(ks[:, None] == z[None, :], rows[None, :], -1).to(torch.int32)


def _slice_kernel_matmul(
    feats: torch.Tensor, coords: torch.Tensor, kernel: torch.Tensor, stride: int, dim: int,
) -> torch.Tensor:
    """Per-row FC with the kernel slice picked by the row's `dim`
    coordinate (ts bev.py:96-100, 147-151): out[v] = feats[v] @
    kernel[coords[v, dim] // stride], summed in f32 and rounded to feats'
    dtype once.  K2 at K offsets over `slice_table`, the table its own
    reverse; more than `MAX_SLICES` slices take one call per 32 (each row
    has its one product in one of them, the others add zeros)."""
    rb = slice_table(coords, kernel.shape[0], stride, dim)
    w = kernel.to(feats.dtype)
    out = None
    for k0 in range(0, kernel.shape[0], MAX_SLICES):
        t = rb[k0 : k0 + MAX_SLICES].contiguous()
        part = conv_k(feats, w[k0 : k0 + MAX_SLICES].contiguous(), t, t)
        out = part if out is None else out + part
    return out


def _bev_cells(grid: SparseGrid, offset, dim: int, shape2) -> tuple:
    """(cu, cv, in-map mask) of each row on the (H, W) plane of the axes
    other than `dim`, at the grid's stride."""
    h, w = shape2
    bev_dims = [i for i in range(3) if i != dim]
    off = torch.as_tensor(offset, dtype=torch.int32, device=grid.coords.device)
    c = grid.coords.to(torch.int32)
    cu = (c[:, bev_dims[0]] - off[bev_dims[0]]) // int(grid.stride)
    cv = (c[:, bev_dims[1]] - off[bev_dims[1]]) // int(grid.stride)
    ok = grid.valid_mask() & (cu >= 0) & (cu < h) & (cv >= 0) & (cv < w)
    return cu, cv, ok


def to_dense_bev(
    grid: SparseGrid, feats: torch.Tensor, batch_size: int, bev_shape: tuple,
    *, offset: tuple = (0, 0, 0), dim: int = 2,
) -> torch.Tensor:
    """Scatter-add per-voxel features onto a dense (B, H, W, C) BEV map
    (ts `ToDenseBEVConvolution.forward`, bev.py:96-110), NHWC; rows
    outside the map or past `num` are dropped."""
    h, w = (int(s) for s in bev_shape)
    cu, cv, ok = _bev_cells(grid, offset, dim, (h, w))
    b = grid.coords[:, 3].to(torch.int32)
    flat = torch.where(ok, (b * h + cu) * w + cv, -1).to(torch.int32)
    dense = segment_sum_rows(feats, flat, build_segment_tables(flat, batch_size * h * w))
    return dense.reshape(batch_size, h, w, -1).to(feats.dtype)


def bev_height_compression(
    grid: SparseGrid, batch_size: int, shape: tuple,
    *, offset: tuple = (0, 0, 0), dim: int = 2,
) -> torch.Tensor:
    """Flatten the `dim` axis into channels: (B, H, W, D*C) with D =
    shape[dim] (ts `ToBEVHeightCompression`, bev.py:163-210).  The height
    index is clamped into range like the reference (:200); NHWC."""
    shape = tuple(int(s) for s in shape)
    bev_dims = [i for i in range(3) if i != dim]
    h, w, d = shape[bev_dims[0]], shape[bev_dims[1]], shape[dim]
    cu, cv, ok = _bev_cells(grid, offset, dim, (h, w))
    off = int(torch.as_tensor(offset)[dim])
    cz = torch.clamp((grid.coords[:, dim].to(torch.int32) - off) // int(grid.stride), 0, d - 1)
    b = grid.coords[:, 3].to(torch.int32)
    flat = torch.where(ok, ((b * h + cu) * w + cv) * d + cz, -1).to(torch.int32)
    dense = segment_sum_rows(grid.feats, flat, build_segment_tables(flat, batch_size * h * w * d))
    c = grid.feats.shape[-1]
    return dense.reshape(batch_size, h, w, d * c).to(grid.feats.dtype)


def bev_sparse_conv(
    grid: SparseGrid, kernel: torch.Tensor, bounds: GridBounds,
    *, out_stride: int = 1, dim: int = 2, bias: torch.Tensor = None,
) -> SparseGrid:
    """Sparse-output BEV convolution (ts `ToBEVConvolution`,
    bev.py:113-160): per-slice FC by height, collapse `dim`, SUM duplicate
    columns (the mean of `voxelize_avg` times the counts), optional extra
    `out_stride` snap of the planar coords."""
    feats = _slice_kernel_matmul(grid.feats, grid.coords, kernel, grid.stride, dim)
    if bias is not None:
        feats = feats + bias.to(feats.dtype)
    ratio = grid.stride * out_stride
    coords = grid.coords.clone()
    coords[:, dim] = 0
    if out_stride > 1:
        coords[:, :3] = torch.div(coords[:, :3], ratio, rounding_mode="floor") * ratio
    uc, num, inverse, _ = unique_coords(coords, grid.valid_mask(), bounds, grid.capacity)
    tables = build_segment_tables(inverse, grid.capacity)
    mean = voxelize_avg(feats, inverse, tables)  # mean * count = sum
    sums = mean * tables.counts.clamp(min=1)[:, None].to(mean.dtype)
    return SparseGrid(coords=uc, feats=sums, num=num, stride=ratio)


__all__ = [
    "bev_height_compression", "bev_reduction", "bev_sparse_conv",
    "global_avg_pool", "global_max_pool", "segment_sum_rows", "slice_table", "to_dense_bev",
]
