"""Cylindrical-partition host pipeline (numpy): port of
`taseg_tpu/data/cylinder_dataset.py` (reference
`semantickitti_cylinder.py:19-265`).

Cartesian -> polar coordinates (rho, phi, z), a fixed voxel grid
(default 480 x 360 x 32 over rho [0, 50] m, phi [-pi, pi], z [-4, 2] m),
one row per voxel with the features of its first point (the 9 cylinder
channels [d-rho, d-phi, d-z to the voxel centre, rho, phi, z, x, y,
intensity]) and the voxel's MAJORITY label.  The output equals JAX's for
the same reader dict and `AugParams`.  JAX takes the majority in a Python
loop over voxels (`bincount(...).argmax()`, the smallest label on a tie);
here one sort of the (voxel, label) pairs and their counts gives the same
labels.

The rows come out in `sparse_quantize`'s lexicographic (rho, phi, z)
order, not in the device's key order, so the topology sorts them
(`sorted_points = False`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .augment import AugParams
from .quantize import sparse_quantize
from .voxel_dataset import VoxelSample, collate_shard

DEFAULT_GRID = (480, 360, 32)
DEFAULT_BOUNDS = ((0.0, 50.0), (-np.pi, np.pi), (-4.0, 2.0))


def grid_from_cfg(data_cfg) -> tuple:
    """The polar grid of a config's DATA, as JAX's `build_dataloader`
    reads it: GRID_SIZE, else CYLINDER_GRID_SIZE, else the default."""
    return tuple(data_cfg.get("GRID_SIZE", data_cfg.get("CYLINDER_GRID_SIZE", DEFAULT_GRID)))


def cart2polar(xyz: np.ndarray) -> np.ndarray:
    rho = np.sqrt(xyz[:, 0] ** 2 + xyz[:, 1] ** 2)
    phi = np.arctan2(xyz[:, 1], xyz[:, 0])
    return np.stack([rho, phi, xyz[:, 2]], axis=1)


def majority_labels(inverse: np.ndarray, labels: np.ndarray, n_vox: int) -> np.ndarray:
    """(n_vox,) int32: per voxel the label most of its points carry, the
    smallest such label on a tie (what `np.bincount(...).argmax()` picks).
    `labels` must be non-negative, as bincount requires."""
    n_lbl = int(labels.max(initial=0)) + 1
    pairs, counts = np.unique(inverse.astype(np.int64) * n_lbl + labels, return_counts=True)
    vox, lbl = np.divmod(pairs, n_lbl)
    # per voxel: the largest count first, then the smallest label
    order = np.lexsort((lbl, -counts, vox))
    first = np.ones(len(order), bool)
    first[1:] = vox[order][1:] != vox[order][:-1]
    maj = np.zeros(n_vox, np.int32)
    maj[vox[order][first]] = lbl[order][first]
    return maj


class CylinderPipeline:
    """reader dict -> VoxelSample on the polar grid."""

    # rows come out in quantize order; the topology sorts them
    sorted_points = False

    def __init__(
        self,
        grid=DEFAULT_GRID,
        bounds=DEFAULT_BOUNDS,
        *,
        training: bool = True,
        if_flip=True, if_scale=True, scale_range=(0.9, 1.1),
        if_jitter=True, if_rotate=True,
        seed: int = 0,
    ):
        self.grid = np.asarray(grid)
        self.lo = np.asarray([b[0] for b in bounds], np.float32)
        self.hi = np.asarray([b[1] for b in bounds], np.float32)
        self.cell = (self.hi - self.lo) / self.grid
        self.training = training
        self.aug_flags = dict(
            if_flip=if_flip, if_scale=if_scale, scale_range=scale_range,
            if_jitter=if_jitter, if_rotate=if_rotate,
        )
        self.rng = np.random.default_rng(seed)

    def __call__(self, sample: dict, aug: Optional[AugParams] = None) -> VoxelSample:
        pts = sample["xyzret"][:, :4].astype(np.float32)
        labels = np.asarray(sample["labels"]).reshape(-1).astype(np.int32)
        if self.training:
            aug = aug or AugParams.sample(self.rng, **self.aug_flags)
        if aug is not None:
            pts = pts.copy()
            pts[:, :3] = aug.apply(pts[:, :3])

        polar = cart2polar(pts[:, :3])
        polar_c = np.clip(polar, self.lo, self.hi - 1e-5)
        vox = ((polar_c - self.lo) / self.cell).astype(np.int32)
        vox = np.minimum(vox, self.grid - 1)
        _, index, inverse = sparse_quantize(
            vox, return_index=True, return_inverse=True
        )
        maj = majority_labels(inverse, labels, len(index))

        center = self.lo + (vox + 0.5) * self.cell
        feats = np.concatenate(
            [
                (polar_c - center).astype(np.float32),  # offset to center
                polar_c.astype(np.float32),
                pts[:, :2],  # x, y
                pts[:, 3:4],  # intensity
            ],
            axis=1,
        )
        return VoxelSample(
            coords=vox[index],
            feats=feats[index],
            labels=maj,
            inverse_map=inverse.astype(np.int32),
            raw_labels=labels,
            num_raw_points=len(pts),
            name=sample.get("path", ""),
        )

    def collate(self, samples: list, point_capacity: int) -> dict:
        """This pipeline's samples as one padded shard (`collate_shard`)."""
        return collate_shard(samples, point_capacity)
