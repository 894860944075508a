"""Voxel-modality host pipeline + static-capacity collate (numpy).

Copy of `VoxelSample`, `VoxelPipeline` and `collate_shard` from
`taseg_tpu/data/voxel_dataset.py` (reference `semantickitti_voxel.py:78-177`
semantics): per-sample aug -> round(xyz / voxel_size) -> shift to
nonnegative -> sparse_quantize dedup -> per-voxel (coords, feats, labels)
+ eval-side inverse map, then padding to a static point capacity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .augment import AugParams
from .quantize import sparse_quantize


@dataclass
class VoxelSample:
    """One quantized scan (host numpy)."""

    coords: np.ndarray  # (N, 3) int32 nonneg voxel coords
    feats: np.ndarray  # (N, C) float32 (xyz, intensity, ...)
    labels: np.ndarray  # (N,) int32 per-voxel train ids
    inverse_map: np.ndarray  # (N_raw,) raw point -> voxel row
    raw_labels: np.ndarray  # (N_raw,) train ids of the raw points
    num_raw_points: int
    name: str
    token: str = None


class VoxelPipeline:
    """Stateless per-scan transform: reader dict -> VoxelSample."""

    # samples come out key-sorted (z, x, y) per scan, so shards collated
    # from this pipeline can run the level-0 unique's assume_sorted path
    sorted_points = True

    def __init__(
        self,
        voxel_size: float = 0.05,
        *,
        training: bool = True,
        if_flip=True, if_scale=True, scale_range=(0.9, 1.1),
        if_jitter=True, if_rotate=True,
        in_feature_dim: int = 4,
        seed: int = 0,
    ):
        self.voxel_size = voxel_size
        self.training = training
        self.aug_flags = dict(
            if_flip=if_flip, if_scale=if_scale, scale_range=scale_range,
            if_jitter=if_jitter, if_rotate=if_rotate,
        )
        self.in_feature_dim = in_feature_dim
        self.rng = np.random.default_rng(seed)

    def __call__(
        self, sample: dict, aug: Optional[AugParams] = None
    ) -> VoxelSample:
        pts = sample["xyzret"][:, : self.in_feature_dim].astype(np.float32)
        labels = np.asarray(sample["labels"]).reshape(-1).astype(np.int32)

        if self.training:
            aug = aug or AugParams.sample(self.rng, **self.aug_flags)
        if aug is not None:
            pts = pts.copy()
            pts[:, :3] = aug.apply(pts[:, :3])

        vox = np.round(pts[:, :3] / self.voxel_size).astype(np.int32)
        vox -= vox.min(0, keepdims=True)
        _, index, inverse = sparse_quantize(
            vox, return_index=True, return_inverse=True
        )
        # deduped rows in (z, x, y) lexicographic order — the device key
        # order (ops/coords.py pack_keys) — with inverse_map composed with
        # the sort so raw-point mapping is unchanged
        cd = vox[index]
        order = np.lexsort((cd[:, 1], cd[:, 0], cd[:, 2])).astype(np.int32)
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order), dtype=np.int32)
        return VoxelSample(
            coords=cd[order],
            feats=pts[index][order],
            labels=labels[index][order],
            inverse_map=rank[inverse].astype(np.int32),
            raw_labels=labels,
            num_raw_points=len(pts),
            name=sample.get("path", ""),
            token=sample.get("token"),
        )


def collate_shard(
    samples: list[VoxelSample], point_capacity: int
) -> dict:
    """Concat scans with a batch-index column and pad to `point_capacity`.
    Returns host numpy arrays plus the eval-side metadata."""
    total = sum(len(s.coords) for s in samples)
    if total > point_capacity:
        raise ValueError(
            f"shard holds {total} voxels > capacity {point_capacity}; raise "
            f"DATA.NUM_POINTS or lower the per-shard batch size"
        )
    coords = np.zeros((point_capacity, 4), np.float32)
    feats_dim = samples[0].feats.shape[1]
    feats = np.zeros((point_capacity, feats_dim), np.float32)
    labels = np.zeros((point_capacity,), np.int32)
    offsets = [0]
    cursor = 0
    for b, s in enumerate(samples):
        n = len(s.coords)
        coords[cursor : cursor + n, :3] = s.coords
        coords[cursor : cursor + n, 3] = b
        feats[cursor : cursor + n] = s.feats
        labels[cursor : cursor + n] = s.labels
        cursor += n
        offsets.append(cursor)
    return {
        "point_coords": coords,
        "point_feats": feats,
        "labels": labels,
        "num_points": np.array([cursor], np.int32),
        "offsets": np.array(offsets, np.int32),
        "samples": samples,
    }
