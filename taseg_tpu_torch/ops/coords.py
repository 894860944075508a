"""Coordinate key packing for sparse voxel grids (port of
`taseg_tpu/ops/coords.py`).

A key is the int32 pair (hi, lo):
    hi = batch * extent_z + (z - origin_z)
    lo = (x - origin_x) * extent_y + (y - origin_y)
with origin/extent from a per-batch `GridBounds` padded by a margin that
covers every kernel offset at every stride level.  Padding rows and
out-of-bounds queries map to sentinels that sort after all valid keys and
never equal a valid reference key.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Sentinel for invalid rows in a *reference* set (padding voxels): sorts last.
REF_SENTINEL_HI = np.int32(2**31 - 1)
# Sentinel for invalid/out-of-bounds *query* keys: also sorts after all
# valid keys but is distinct from REF_SENTINEL so a padded reference row
# can never be "found" by an invalid query.
QUERY_SENTINEL_HI = np.int32(2**31 - 2)


@dataclass(frozen=True)
class GridBounds:
    """Axis-aligned integer bounding box (with margin) of a voxel grid."""

    origin: torch.Tensor  # (3,) int32 — min corner minus margin
    extent: torch.Tensor  # (3,) int32 — per-axis size including both margins


def compute_bounds(
    coords: torch.Tensor, valid: torch.Tensor, margin: int = 64
) -> GridBounds:
    """Bounds of the valid stride-1 coords, padded by `margin` voxels."""
    xyz = coords[:, :3].to(torch.int32)
    big = 2**24
    v = valid[:, None]
    mn = torch.where(v, xyz, big).amin(0) - margin
    mx = torch.where(v, xyz, -big).amax(0) + margin
    return GridBounds(origin=mn, extent=(mx - mn + 1).to(torch.int32))


def pack_keys(
    coords: torch.Tensor,
    bounds: GridBounds,
    valid: torch.Tensor,
    *,
    is_query: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack (N, 4) int coords (x, y, z, batch) into (hi, lo) int32 pairs.

    Rows with `valid == False`, coords outside `bounds`, or batch < 0 map
    to the appropriate sentinel (lo stays 0 so `join_keys` can fuse its
    ref/query tag into lo's low bit)."""
    coords = coords.to(torch.int32)
    xyz = coords[:, :3] - bounds.origin
    b = coords[:, 3]
    in_bounds = (
        valid
        & (b >= 0)
        & (xyz >= 0).all(1)
        & (xyz < bounds.extent).all(1)
    )
    hi = b * bounds.extent[2] + xyz[:, 2]
    lo = xyz[:, 0] * bounds.extent[1] + xyz[:, 1]
    sent_hi = int(QUERY_SENTINEL_HI if is_query else REF_SENTINEL_HI)
    hi = torch.where(in_bounds, hi, sent_hi).to(torch.int32)
    lo = torch.where(in_bounds, lo, 0).to(torch.int32)
    return hi, lo
