"""Point<->voxel transforms and their gradients (port of
`taseg_tpu/ops/voxelize.py`).

  * `voxelize_avg`: segment mean of point features per voxel, over the
    sorted-segment layout of `build_segment_tables`; its backward gathers
    each voxel's gradient / count back to the points (plain torch);
  * `devoxelize`: the identity gather (integer points at stride 1) or the
    8-corner trilinear interpolation, the hand kernel K7
    (`csrc/devoxelize.cu`, one launch per call, bit-identical to the plain
    versions `_devox_identity` / `_devox_trilinear`) on CUDA tensors;
    their backwards are segment sums, over the point tables or over the
    (corner, point) pair table `DevoxTable.pairs`.

Every segment sum (the voxelize forward and both devoxelize backwards)
is `segment_sum`: the hand kernel K6 (`csrc/segment_sum.cu`, members
spread over lanes in fixed-size chunks and summed in a fixed order) on
CUDA tensors, the JAX package's mean-centred cumsum (`segment_sum_plain`)
on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import _build
from .coords import GridBounds
from .join import query_coords
from .rulebook import kernel_offsets
from .sparse_conv import DTYPE_CODES, wants_grad


class SegmentTables(NamedTuple):
    """Sorted-segment layout for segment reductions.

    perm:   (N,) int64 — row order grouping members by segment id
            (members of segment u occupy perm[starts[u]:starts[u+1]]).
    starts: (V+1,) int32 — exclusive prefix of segment sizes.
    counts: (V,) int32 — segment sizes.
    seg:    (N,) int32 — segment id of each sorted row (V for the dropped
            rows past starts[V]); K6 reads it, the plain version does not.
    """

    perm: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor
    seg: torch.Tensor


def build_segment_tables(ids: torch.Tensor, num_segments: int) -> SegmentTables:
    """ids: (N,) int32 segment id per row; out-of-range (e.g. -1) = drop.

    One sentinel row per segment is appended so every segment is
    non-empty (as in the JAX package); consumers pad their value rows with
    `num_segments` zero rows, and `counts` excludes the sentinels."""
    dev = ids.device
    ids_aug = torch.cat(
        [ids.to(torch.int32), torch.arange(num_segments, dtype=torch.int32, device=dev)]
    )
    in_range = (ids_aug >= 0) & (ids_aug < num_segments)
    key = torch.where(in_range, ids_aug, num_segments)
    seg, perm = torch.sort(key, stable=True)
    sizes = torch.zeros(num_segments + 1, dtype=torch.int32, device=dev)
    sizes.scatter_add_(0, key.long(), torch.ones_like(key))
    starts = torch.cat(
        [
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.cumsum(sizes[:num_segments], 0, dtype=torch.int32),
        ]
    )
    counts = starts[1:] - starts[:-1] - 1  # minus the sentinel row
    return SegmentTables(perm=perm, starts=starts, counts=counts, seg=seg)


def run_sums(rows_f32: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Sums of the contiguous runs [starts[u], starts[u+1]) of (N, C) f32
    rows, by a mean-centred cumsum (as the JAX package does: the centring
    keeps the prefixes, and so their rounding, small).  (V, C) out.

    The scan runs over the transposed (C, N) copy: a cumsum along dim 0
    of a narrow (N, C) tensor runs one thread per column on CUDA (23 ms
    per scan at N = 262144, C = 4 on an H100), along the contiguous dim
    it is a fast row scan."""
    center = rows_f32.mean(0, keepdim=True)
    cum = torch.cumsum((rows_f32 - center).t().contiguous(), 1)
    cum = torch.cat([cum.new_zeros((cum.shape[0], 1)), cum], 1)
    lo, hi = starts[:-1].long(), starts[1:].long()
    seg = (cum[:, hi] - cum[:, lo]).t().contiguous()
    return seg + (hi - lo)[:, None].float() * center


def segment_sum_plain(
    src: torch.Tensor, tables: SegmentTables, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K6's plain version, as JAX `_segment_sum_sorted`: the R = N - V
    real rows (row r reads src[r mod P], times weights[r]), zero-padded
    by the V sentinel rows, gathered to sorted order, run sums by a
    mean-centred cumsum.  (V, C) f32 (f64 for f64 input: a reference
    without the cumsum's rounding)."""
    v = tables.starts.shape[0] - 1
    r_real = tables.perm.shape[0] - v
    rows = src.to(torch.promote_types(src.dtype, torch.float32))
    if r_real != rows.shape[0]:
        rows = rows.repeat(r_real // rows.shape[0], 1)
    if weights is not None:
        rows = rows * weights.reshape(-1, 1).to(rows.dtype)
    vals = torch.cat([rows, rows.new_zeros((v, rows.shape[1]))])
    return run_sums(vals[tables.perm], tables.starts)


# sorted rows per warp of K6's first pass (kChunk, csrc/segment_sum.cu);
# each chunk writes up to two partial rows (its first and its last
# segment, where they cross a chunk boundary)
SEGMENT_CHUNK = 64


def segment_sum(
    src: torch.Tensor, tables: SegmentTables, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K6: per segment u of `tables` (V segments over N = R + V sorted
    rows, the last V the sentinels), out[u] = sum of weights[r] *
    src[r mod P] over its real member rows r < R.  src (P, C) f32 or
    bf16 with R a multiple of P; weights (R,) f32 or None (weight 1).
    (V, C) f32, each segment's members added in a fixed order (two
    launches: chunk sums, then the merge of the segments that span
    chunks)."""
    dev = src.device
    _build.check("src", src, (torch.float32, torch.bfloat16), 2, dev)
    _build.check("perm", tables.perm, (torch.int64,), 1, dev)
    _build.check("starts", tables.starts, (torch.int32,), 1, dev)
    v = tables.starts.shape[0] - 1
    r_real = tables.perm.shape[0] - v
    p, c = src.shape
    if r_real < 0 or (r_real and (not p or r_real % p)):
        raise ValueError(f"{r_real} table rows do not tile {p} source rows")
    if weights is not None:
        weights = weights.reshape(-1)
        _build.check("weights", weights, (torch.float32,), 1, dev)
        if weights.shape[0] != r_real:
            raise ValueError(f"weights: {weights.shape[0]} rows, tables have {r_real}")
    if r_real + v >= 2**31:
        raise ValueError("segment tables of 2^31 rows or more")
    if not _build.dispatch(src):
        return segment_sum_plain(src, tables, weights)
    _build.check("seg", tables.seg, (torch.int32,), 1, dev)
    n = tables.perm.shape[0]
    if tables.seg.shape[0] != n:
        raise ValueError(f"seg: {tables.seg.shape[0]} rows, perm has {n}")
    out = torch.empty((v, c), dtype=torch.float32, device=dev)
    if v == 0 or c == 0:
        return out
    if r_real == 0:
        return out.zero_()
    part = torch.empty((-(-n // SEGMENT_CHUNK), 2, c), dtype=torch.float32, device=dev)
    _build.launch(
        "taseg_segment_sum", ("segment_sum",),
        src.data_ptr(), None if weights is None else weights.data_ptr(),
        tables.perm.data_ptr(), tables.seg.data_ptr(), tables.starts.data_ptr(),
        out.data_ptr(), part.data_ptr(), v, c, r_real, p, n, DTYPE_CODES[src.dtype],
    )
    return out


def _voxelize_avg(point_feats, tables):
    sums = segment_sum(point_feats, tables)
    mean = sums / tables.counts.clamp(min=1)[:, None].float()
    return mean.to(point_feats.dtype)


class VoxelizeAvg(torch.autograd.Function):
    """Segment mean with the JAX `_voxelize_bwd` gradient: each point gets
    its voxel's gradient / count (plain torch gather)."""

    @staticmethod
    def forward(ctx, point_feats, inverse, tables):
        ctx.inverse, ctx.counts = inverse, tables.counts
        return _voxelize_avg(point_feats, tables)

    @staticmethod
    def backward(ctx, g):
        scaled = g / ctx.counts.clamp(min=1).to(g.dtype)[:, None]
        inv = ctx.inverse
        d_points = torch.where((inv >= 0)[:, None], scaled[inv.clamp(min=0).long()], 0)
        return d_points, None, None


def voxelize_avg(
    point_feats: torch.Tensor,
    inverse: torch.Tensor,
    tables: SegmentTables,
) -> torch.Tensor:
    """Average point features per voxel (reference `spvoxelize`); tables
    from `build_segment_tables(inverse, V)`."""
    if wants_grad(point_feats):
        return VoxelizeAvg.apply(point_feats, inverse, tables)
    return _voxelize_avg(point_feats, tables)


class DevoxTable(NamedTuple):
    """Trilinear interpolation table + its transpose structure.

    idx:     (8, P) int32 voxel index per corner, -1 missing.
    weights: (8, P) float32 normalized trilinear weights.
    pairs:   SegmentTables over the flattened (8P,) corner -> voxel ids,
             for the backward (None: forward only).
    """

    idx: torch.Tensor
    weights: torch.Tensor
    pairs: Optional[SegmentTables] = None


def trilinear_table(
    point_coords: torch.Tensor,
    point_valid: torch.Tensor,
    voxel_coords: torch.Tensor,
    num_voxels: torch.Tensor,
    stride: int,
    bounds: GridBounds,
    with_pairs: bool = True,
    corner_idx: Optional[torch.Tensor] = None,
) -> DevoxTable:
    """8-corner indices + weights (reference `voxel_to_point` /
    `calc_ti_weights`, minkunet/utils.py:69-105), plus the transposed
    pair layout for the backward unless `with_pairs` is False (its
    (8P + V)-row sort serves training only).  `corner_idx` (8, P) skips
    the corner joins when the caller already derived the corner rows
    (`backbone_context.build_unet_topology`)."""
    p = point_coords[:, :3].float()
    s = float(stride)
    pf = torch.floor(p / s) * s

    if corner_idx is not None:
        idx = corner_idx.contiguous()  # K7 reads (8, P) rows
    else:
        offs = torch.as_tensor(
            kernel_offsets(2, stride=stride), device=p.device
        )  # (8, 3); k = 4dx+2dy+dz
        corner = pf[None, :, :].to(torch.int32) + offs[:, None, :]
        b = point_coords[None, :, 3:4].to(torch.int32).expand(8, -1, 1)
        q = torch.cat([corner, b], dim=-1)
        q_valid = point_valid[None, :].expand(8, -1)
        idx = query_coords(q, q_valid, voxel_coords, num_voxels, bounds)

    frac = (p - pf) / s
    one = 1.0 - frac
    # corner bit pattern (k = 4*jx + 2*jy + jz)
    d = torch.tensor(
        [[(k >> 2) & 1, (k >> 1) & 1, k & 1] for k in range(8)],
        dtype=torch.bool, device=p.device,
    )
    w = torch.where(d[:, None, :], frac[None, :, :], one[None, :, :]).prod(-1)
    w = torch.where(idx >= 0, w, 0.0)
    w = w / (w.sum(0, keepdim=True) + 1e-8)
    pairs = (
        build_segment_tables(idx.reshape(-1), voxel_coords.shape[0])
        if with_pairs else None
    )
    return DevoxTable(idx=idx, weights=w, pairs=pairs)


class IdentityDevoxTable(NamedTuple):
    """Degenerate trilinear table for integer points at stride 1: the
    weights collapse to 1 on the containing voxel, so devoxelization is
    a gather by the point->voxel inverse map, and its gradient a segment
    sum over the point tables that the topology builds anyway."""

    inverse: torch.Tensor  # (P,) point -> voxel id (-1 invalid)
    tables: Optional[SegmentTables] = None  # segment tables over `inverse`


def _devox_identity(voxel_feats, inv):
    # K7's plain version
    g = voxel_feats[inv.clamp(min=0).long()]
    return torch.where((inv >= 0)[:, None], g, 0)


def _devox_trilinear(voxel_feats, table):
    # K7's plain version: per-corner multiply-accumulate in the feature
    # dtype, as the JAX package does
    out = None
    for k in range(table.idx.shape[0]):
        idx = table.idx[k]
        g = voxel_feats[idx.clamp(min=0).long()]
        g = torch.where((idx >= 0)[:, None], g, 0)
        c = g * table.weights[k][:, None].to(voxel_feats.dtype)
        out = c if out is None else out + c
    return out


def _launch_devox(name: str, voxel_feats, idx, weights) -> torch.Tensor:
    p = idx.shape[-1]
    c = voxel_feats.shape[1]
    out = torch.empty((p, c), dtype=voxel_feats.dtype, device=voxel_feats.device)
    if p == 0 or c == 0:
        return out
    ptrs = (voxel_feats.data_ptr(), idx.data_ptr())
    if weights is not None:
        ptrs += (weights.data_ptr(),)
    _build.launch(
        name, ("devoxelize",), *ptrs, out.data_ptr(), p, c,
        DTYPE_CODES[voxel_feats.dtype],
    )
    return out


def devoxelize_identity(voxel_feats: torch.Tensor, inverse: torch.Tensor) -> torch.Tensor:
    """K7 identity: out[p] = voxel_feats[inverse[p]], 0 where inverse[p]
    < 0; (V, C) f32 or bf16 and (P,) int32 -> (P, C)."""
    dev = voxel_feats.device
    _build.check("voxel_feats", voxel_feats, tuple(DTYPE_CODES), 2, dev)
    _build.check("inverse", inverse, (torch.int32,), 1, dev)
    if not _build.dispatch(voxel_feats):
        return _devox_identity(voxel_feats, inverse)
    return _launch_devox("taseg_devox_identity", voxel_feats, inverse, None)


def devoxelize_trilinear(voxel_feats: torch.Tensor, table: DevoxTable) -> torch.Tensor:
    """K7 trilinear: out[p] = sum over corners k of weights[k, p] *
    voxel_feats[idx[k, p]] (absent corners idx = -1 add 0), multiplied
    and added in the feature dtype in corner order, as the JAX package
    does; (V, C) f32 or bf16 -> (P, C)."""
    dev = voxel_feats.device
    _build.check("voxel_feats", voxel_feats, tuple(DTYPE_CODES), 2, dev)
    _build.check("idx", table.idx, (torch.int32,), 2, dev)
    _build.check("weights", table.weights, (torch.float32,), 2, dev)
    if table.idx.shape[0] != 8 or table.weights.shape != table.idx.shape:
        raise ValueError(
            f"idx {tuple(table.idx.shape)} / weights {tuple(table.weights.shape)}: "
            "expected (8, P) each"
        )
    if not _build.dispatch(voxel_feats):
        return _devox_trilinear(voxel_feats, table)
    return _launch_devox("taseg_devox_trilinear", voxel_feats, table.idx, table.weights)


class DevoxIdentity(torch.autograd.Function):
    """Identity devoxelize (K7); backward (JAX `_devox_id_bwd`): the
    segment sum of the point gradients per voxel, K6 over the point
    tables."""

    @staticmethod
    def forward(ctx, voxel_feats, table):
        if table.tables is None:
            raise ValueError("the identity devox table has no segment tables")
        ctx.table = table
        return devoxelize_identity(voxel_feats, table.inverse)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return segment_sum(g, ctx.table.tables).to(g.dtype), None


class DevoxTrilinear(torch.autograd.Function):
    """Trilinear devoxelize (K7); backward (JAX `_devox_bwd`): per voxel
    the weighted sum of the point gradients over its (corner, point)
    pairs, K6 over `pairs` with the corner weights."""

    @staticmethod
    def forward(ctx, voxel_feats, table):
        if table.pairs is None:
            raise ValueError(
                "the trilinear table has no pairs: build it with with_pairs=True"
            )
        ctx.table = table
        return devoxelize_trilinear(voxel_feats, table)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        t = ctx.table
        return segment_sum(g, t.pairs, t.weights.reshape(-1)).to(g.dtype), None


def devoxelize(voxel_feats: torch.Tensor, table) -> torch.Tensor:
    """Interpolate (V, C) voxel feats to (P, C) points (reference
    `spdevoxelize`); dispatches on the table type, and is differentiable
    in the voxel features where autograd asks."""
    identity = isinstance(table, IdentityDevoxTable)
    if wants_grad(voxel_feats):
        return (DevoxIdentity if identity else DevoxTrilinear).apply(voxel_feats, table)
    if identity:
        return devoxelize_identity(voxel_feats, table.inverse)
    return devoxelize_trilinear(voxel_feats, table)
