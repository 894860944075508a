"""Point<->voxel transforms, forward only (port of
`taseg_tpu/ops/voxelize.py`).

  * `voxelize_avg`: segment mean of point features per voxel, over the
    sorted-segment layout of `build_segment_tables` and a mean-centred
    cumsum, as in the JAX package;
  * `devoxelize`: the identity gather (integer points at stride 1) or the
    8-corner trilinear interpolation.

Plain PyTorch in this slice; their hand kernels are queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .coords import GridBounds
from .join import query_coords
from .rulebook import kernel_offsets


class SegmentTables(NamedTuple):
    """Sorted-segment layout for segment reductions.

    perm:   (N,) int64 — row order grouping members by segment id
            (members of segment u occupy perm[starts[u]:starts[u+1]]).
    starts: (V+1,) int32 — exclusive prefix of segment sizes.
    counts: (V,) int32 — segment sizes.
    """

    perm: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor


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
    key = torch.where(in_range, ids_aug, num_segments).long()
    _, perm = torch.sort(key, stable=True)
    sizes = torch.zeros(num_segments + 1, dtype=torch.int32, device=dev)
    sizes.scatter_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    starts = torch.cat(
        [
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.cumsum(sizes[:num_segments], 0, dtype=torch.int32),
        ]
    )
    counts = starts[1:] - starts[:-1] - 1  # minus the sentinel row
    return SegmentTables(perm=perm, starts=starts, counts=counts)


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


def _segment_sum_sorted(values: torch.Tensor, tables: SegmentTables) -> torch.Tensor:
    """Sum rows per segment: zero-pad to the sentinel-augmented length,
    gather to sorted order, run sums (each segment's run holds its count
    + 1 rows: the sentinel adds zero)."""
    pad = tables.perm.shape[0] - values.shape[0]
    vals = torch.cat(
        [values, values.new_zeros((pad,) + tuple(values.shape[1:]))]
    )
    return run_sums(vals[tables.perm].float(), tables.starts)


def voxelize_avg(
    point_feats: torch.Tensor,
    inverse: torch.Tensor,
    tables: SegmentTables,
) -> torch.Tensor:
    """Average point features per voxel (reference `spvoxelize`); tables
    from `build_segment_tables(inverse, V)`."""
    sums = _segment_sum_sorted(point_feats, tables)
    mean = sums / tables.counts.clamp(min=1)[:, None].float()
    return mean.to(point_feats.dtype)


class DevoxTable(NamedTuple):
    """Trilinear interpolation table (forward only).

    idx:     (8, P) int32 voxel index per corner, -1 missing.
    weights: (8, P) float32 normalized trilinear weights.
    """

    idx: torch.Tensor
    weights: torch.Tensor


def trilinear_table(
    point_coords: torch.Tensor,
    point_valid: torch.Tensor,
    voxel_coords: torch.Tensor,
    num_voxels: torch.Tensor,
    stride: int,
    bounds: GridBounds,
    corner_idx: Optional[torch.Tensor] = None,
) -> DevoxTable:
    """8-corner indices + weights (reference `voxel_to_point` /
    `calc_ti_weights`, minkunet/utils.py:69-105).  `corner_idx` (8, P)
    skips the corner joins when the caller already derived the corner
    rows (`backbone_context.build_unet_topology`)."""
    p = point_coords[:, :3].float()
    s = float(stride)
    pf = torch.floor(p / s) * s

    if corner_idx is not None:
        idx = corner_idx
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
    return DevoxTable(idx=idx, weights=w)


class IdentityDevoxTable(NamedTuple):
    """Degenerate trilinear table for integer points at stride 1: the
    weights collapse to 1 on the containing voxel, so devoxelization is
    a gather by the point->voxel inverse map."""

    inverse: torch.Tensor  # (P,) point -> voxel id (-1 invalid)


def devoxelize(voxel_feats: torch.Tensor, table) -> torch.Tensor:
    """Interpolate (V, C) voxel feats to (P, C) points (reference
    `spdevoxelize`); dispatches on the table type."""
    if isinstance(table, IdentityDevoxTable):
        inv = table.inverse
        g = voxel_feats[inv.clamp(min=0).long()]
        return torch.where((inv >= 0)[:, None], g, 0)
    # per-corner multiply-accumulate in the feature dtype, as the JAX
    # package does
    out = None
    for k in range(table.idx.shape[0]):
        idx = table.idx[k]
        g = voxel_feats[idx.clamp(min=0).long()]
        g = torch.where((idx >= 0)[:, None], g, 0)
        c = g * table.weights[k][:, None].to(voxel_feats.dtype)
        out = c if out is None else out + c
    return out
