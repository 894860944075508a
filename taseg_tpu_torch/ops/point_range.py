"""Point <-> range-image transforms (port of `taseg_tpu/ops/point_range.py`,
the range_lib equivalents of RPVNet).

  * `point_to_range`: the per-pixel mean of point rows (range_lib
    `map_count` + `denselize`), a segment mean over linearized pixel ids:
    `voxelize_avg` over the pixel tables, so K6 sums the rows and K8 is
    its gradient;
  * `range_to_point`: the bilinear sample of an (H, W, C) image at each
    point's float pixel coordinates (the reference's `F.grid_sample`), a
    4-corner `DevoxTable`: K7 at 4 corners forward, K6 over the 4P
    (corner, point) pairs backward.

Both use the stacked-canvas convention of RPVNet's `build_rpv_context`:
the caller passes (B * H, W) as the image size where B scans share one
table.
"""

from __future__ import annotations

import torch

from .voxelize import (
    DevoxTable,
    SegmentTables,
    build_segment_tables,
    devoxelize,
    voxelize_avg,
)


def pixel_ids(px: torch.Tensor, py: torch.Tensor, valid: torch.Tensor, h: int, w: int):
    """Linearized pixel id per point (int32); -1 for invalid points and
    for pixels outside the (h, w) image."""
    ids = py.to(torch.int32) * w + px.to(torch.int32)
    ok = valid & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    return torch.where(ok, ids, -1)


def point_to_range_tables(
    px: torch.Tensor, py: torch.Tensor, valid: torch.Tensor, h: int, w: int
) -> tuple[torch.Tensor, SegmentTables]:
    """(pixel ids (P,) int32, their segment tables over the h * w pixels)."""
    ids = pixel_ids(px, py, valid, h, w)
    return ids, build_segment_tables(ids, h * w)


def point_to_range(
    point_feats: torch.Tensor,
    ids: torch.Tensor,
    tables: SegmentTables,
    h: int,
    w: int,
) -> torch.Tensor:
    """(P, C) -> (h, w, C) per-pixel mean (range_lib denselize semantics;
    pixels without points are 0 up to the rounding of the plain version's
    mean-centred cumsum, as in JAX)."""
    mean = voxelize_avg(point_feats, ids, tables)  # (h * w, C)
    return mean.reshape(h, w, point_feats.shape[-1])


def range_sample_table(
    pxf: torch.Tensor, pyf: torch.Tensor, valid: torch.Tensor, h: int, w: int,
    with_pairs: bool = True,
) -> DevoxTable:
    """Bilinear sampling table: 4 corner pixel ids (4, P) int32 and
    weights (4, P) f32 per point, corners (y0, x0), (y0, x1), (y1, x0),
    (y1, x1); invalid points have ids -1 and weights 0.  `pairs`, the
    transposed layout that only the backward reads, is left out where
    `with_pairs` is False (serving)."""
    x = torch.clamp(pxf, 0.0, w - 1.000001)
    y = torch.clamp(pyf, 0.0, h - 1.000001)
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = (x - x0).float()
    fy = (y - y0).float()
    idx = torch.stack([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1])
    idx = torch.where(valid[None, :], idx, -1).to(torch.int32).contiguous()
    weights = torch.stack(
        [(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy]
    )
    weights = torch.where(idx >= 0, weights, 0.0).contiguous()
    pairs = build_segment_tables(idx.reshape(-1), h * w) if with_pairs else None
    return DevoxTable(idx=idx, weights=weights, pairs=pairs)


def range_to_point(image: torch.Tensor, table: DevoxTable) -> torch.Tensor:
    """Sample an (H, W, C) image at the table's per-point corners ->
    (P, C) (reference rpvnet.py:32-44 grid_sample path)."""
    c = image.shape[-1]
    return devoxelize(image.reshape(-1, c), table)
