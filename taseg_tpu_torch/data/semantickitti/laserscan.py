"""Spherical (range-view) projection of LiDAR scans — host side; copy
of `taseg_tpu/data/semantickitti/laserscan.py`.

Functional re-design of the reference's stateful SemLaserScan class
(`pcseg/data/dataset/semantickitti/laserscan.py:174-240`): yaw/pitch ->
(u, v) image coords, then a depth-DESCENDING ordered write so the nearest
point wins each pixel (a z-buffer via overwrite).  Returns plain arrays
instead of mutating object attributes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class RangeProjection(NamedTuple):
    range_img: np.ndarray  # (H, W) float32, 0 where empty
    xyz: np.ndarray  # (H, W, 3)
    remission: np.ndarray  # (H, W)
    idx: np.ndarray  # (H, W) int32 point index, -1 where empty
    mask: np.ndarray  # (H, W) float32 occupancy
    proj_x: np.ndarray  # (N,) per-point column
    proj_y: np.ndarray  # (N,) per-point row
    unproj_range: np.ndarray  # (N,) per-point range


def project_scan(
    points: np.ndarray,
    remission: np.ndarray,
    *,
    h: int = 64,
    w: int = 2048,
    fov_up_deg: float = 3.0,
    fov_down_deg: float = -25.0,
) -> RangeProjection:
    fov_up = np.radians(fov_up_deg)
    fov_down = np.radians(fov_down_deg)
    fov = abs(fov_down) + abs(fov_up)

    depth = np.linalg.norm(points[:, :3], axis=1)
    depth = np.maximum(depth, 1e-8)
    yaw = -np.arctan2(points[:, 1], points[:, 0])
    pitch = np.arcsin(np.clip(points[:, 2] / depth, -1, 1))

    px = np.floor(0.5 * (yaw / np.pi + 1.0) * w)
    py = np.floor((1.0 - (pitch + abs(fov_down)) / fov) * h)
    px = np.clip(px, 0, w - 1).astype(np.int32)
    py = np.clip(py, 0, h - 1).astype(np.int32)

    order = np.argsort(depth)[::-1]  # far first; near overwrites
    oy, ox = py[order], px[order]

    range_img = np.zeros((h, w), np.float32)
    xyz = np.zeros((h, w, 3), np.float32)
    rem = np.zeros((h, w), np.float32)
    idx = np.full((h, w), -1, np.int32)
    range_img[oy, ox] = depth[order]
    xyz[oy, ox] = points[order, :3]
    rem[oy, ox] = remission[order]
    idx[oy, ox] = order.astype(np.int32)
    mask = (idx >= 0).astype(np.float32)
    return RangeProjection(
        range_img=range_img, xyz=xyz, remission=rem, idx=idx, mask=mask,
        proj_x=px, proj_y=py, unproj_range=depth.astype(np.float32),
    )


def project_labels(proj: RangeProjection, labels: np.ndarray) -> np.ndarray:
    """(H, W) label image from per-point labels via the projection index."""
    out = np.zeros(proj.idx.shape, np.int32)
    valid = proj.idx >= 0
    out[valid] = labels[proj.idx[valid]]
    return out
