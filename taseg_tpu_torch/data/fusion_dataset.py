"""Fusion (RPVNet) host pipeline: the voxel sample, the range image and
each voxel's pixel coordinates (port of `taseg_tpu/data/fusion_dataset.py`;
reference `semantickitti_fusion.py:64-114, 205-207`).

The scan is quantized for the voxel and point branches as `VoxelPipeline`
does, and projected spherically into a 6-channel range image (xyz / 50,
remission, range / 80, occupancy); every voxel row carries the float
(px, py) pixel coordinates of its (augmented) point for RPVNet's bilinear
range -> point sampling.  As in JAX, the image is projected from the
reader's scan as read, the pixel coordinates from the augmented points.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import numpy as np

from .augment import AugParams
from .semantickitti.laserscan import project_scan
from .voxel_dataset import VoxelPipeline, VoxelSample, collate_shard


@dataclass
class FusionSample(VoxelSample):
    """A `VoxelSample` with the scan's range image and its voxels' pixel
    coordinates (JAX keeps the voxel sample as a field instead)."""

    range_img: np.ndarray = None  # (H, W, 6) float32
    pxpy: np.ndarray = None  # (N_vox, 2) float32 pixel coords (px, py)


class FusionPipeline(VoxelPipeline):
    def __init__(
        self, *args, h: int = 64, w: int = 2048,
        fov_up: float = 3.0, fov_down: float = -25.0, **kw,
    ):
        super().__init__(*args, **kw)
        self.h = h
        self.w = w
        self.fov_up = fov_up
        self.fov_down = fov_down

    def __call__(self, sample: dict, aug: Optional[AugParams] = None) -> FusionSample:
        vox = super().__call__(sample, aug=aug)
        pts = vox.feats[:, :3]
        raw = sample["xyzret"][:, :4].astype(np.float32)
        proj = project_scan(
            raw[:, :3], raw[:, 3], h=self.h, w=self.w,
            fov_up_deg=self.fov_up, fov_down_deg=self.fov_down,
        )
        scan = np.concatenate(
            [
                proj.xyz / 50.0,
                proj.remission[..., None],
                proj.range_img[..., None] / 80.0,
                proj.mask[..., None],
            ],
            axis=-1,
        ).astype(np.float32)

        # float pixel coords of each voxel's representative point
        depth = np.maximum(np.linalg.norm(pts, axis=1), 1e-8)
        yaw = -np.arctan2(pts[:, 1], pts[:, 0])
        pitch = np.arcsin(np.clip(pts[:, 2] / depth, -1, 1))
        fov_up = np.radians(self.fov_up)
        fov_down = np.radians(self.fov_down)
        fov = abs(fov_down) + abs(fov_up)
        pxf = 0.5 * (yaw / np.pi + 1.0) * self.w
        pyf = (1.0 - (pitch + abs(fov_down)) / fov) * self.h
        pxpy = np.stack(
            [np.clip(pxf, 0, self.w - 1.001), np.clip(pyf, 0, self.h - 1.001)], axis=1
        ).astype(np.float32)
        base = {f.name: getattr(vox, f.name) for f in fields(VoxelSample)}
        return FusionSample(**base, range_img=scan, pxpy=pxpy)

    def collate(self, samples: list, point_capacity: int) -> dict:
        return collate_fusion_shard(samples, point_capacity)


def collate_fusion_shard(samples: list, point_capacity: int) -> dict:
    """`collate_shard` plus `range_image` (B, H, W, C) float32, the scans'
    images in a true batch dimension, and `range_pxpy` (point_capacity,
    2) float32, each voxel row's pixel coordinates with the row offset by
    its scan's index * H, so that one (B * H, W) canvas serves the shard
    (JAX `collate_fusion_batch` for one shard)."""
    arrays = collate_shard(samples, point_capacity)
    h, w, c = samples[0].range_img.shape
    imgs = np.zeros((len(samples), h, w, c), np.float32)
    pxpy = np.zeros((point_capacity, 2), np.float32)
    off = arrays["offsets"]
    for b, s in enumerate(samples):
        imgs[b] = s.range_img
        rc = s.pxpy.copy()
        rc[:, 1] += b * h
        pxpy[off[b] : off[b] + len(rc)] = rc
    arrays["range_image"] = imgs
    arrays["range_pxpy"] = pxpy
    return arrays
