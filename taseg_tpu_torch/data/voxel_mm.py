"""TIAF multi-modal voxel pipeline + collate (host side); port of
`taseg_tpu/data/voxel_mm.py` (reference `semantickitti_voxel_ms_mm.py:
1-319`).  Per scan it produces

  * the FSA main pair (frame + fused cloud, shared quantization origin);
  * the FOV sub-cloud — fused points that land in at least one window
    image's frustum — quantized on the SAME origin so FOV voxels align
    with main points for the fov->main interpolation tables;
  * per-FOV-voxel integer (row, col) image coordinates with rows offset
    by the image slot (the layout `models.voxel.minkunet_mm.UNet2D`
    gathers from);
  * the image stack + dilated 2D semantic targets.

The reader supplies projection results (fov_mask / fov_rowcol / images /
image_labels) computed BEFORE augmentation — image<->point correspondence
is by point identity, so geometric aug of the clouds leaves it intact.
`collate_mm_shard` is JAX's `collate_mm_batch` on one shard.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .augment import AugParams
from .voxel_dataset import MsVoxelPipeline, MsVoxelSample, VoxelSample, _fused_with_pairs, collate_shard


@dataclass
class MmVoxelSample:
    main: MsVoxelSample  # frame + fused (FSA pair)
    fov: VoxelSample  # FOV-cropped fused cloud (same origin)
    fov_rowcol: np.ndarray  # (N_fov_vox, 2) int32, row offset by image slot
    images: np.ndarray  # (n_img, H, W, 3) float32
    image_labels: np.ndarray  # (n_img, H, W) int32 dilated targets


class MsMmVoxelPipeline(MsVoxelPipeline):
    """Reader dict -> MmVoxelSample. Expects the TIAF reader contract:
    `xyzret_ms`/`labels_ms` plus `fov_mask` (N_ms,), `fov_rowcol`
    (N_fov, 2), `images`, `image_labels`."""

    def __call__(self, sample: dict, aug: Optional[AugParams] = None) -> MmVoxelSample:
        pts = sample["xyzret"][:, :4].astype(np.float32)
        pts_ms = sample["xyzret_ms"][:, : self.in_feature_dim].astype(np.float32)
        labels = np.asarray(sample["labels"]).reshape(-1).astype(np.int32)
        labels_ms = np.asarray(sample["labels_ms"]).reshape(-1).astype(np.int32)
        fov_mask = np.asarray(sample["fov_mask"]).reshape(-1)
        fov_rowcol = np.asarray(sample["fov_rowcol"], np.int32)

        if self.training:
            aug = aug or AugParams.sample(self.rng, **self.aug_flags)
        if aug is not None:
            pts, pts_ms = pts.copy(), pts_ms.copy()
            pts[:, :3] = aug.apply(pts[:, :3])
            pts_ms[:, :3] = aug.apply(pts_ms[:, :3])

        # clamp fused cloud to the frame's min bounds (shared quantization
        # origin, semantickitti_voxel_ms.py:121-125); keep the row mask so
        # the FOV projection stays aligned
        mn = pts[:, :3].min(0)
        keep = (pts_ms[:, :3] >= mn).all(1)
        pts_ms, labels_ms = pts_ms[keep], labels_ms[keep]
        fov_mask = fov_mask[keep]
        # fov_rowcol rows are per-FOV-point (pre-clamp); re-derive the
        # surviving subset
        if fov_rowcol.shape[0] == len(keep):
            fov_rowcol_kept = fov_rowcol[keep][fov_mask]
        else:  # rowcol already compacted to fov points (reader contract B)
            kept_of_fov = keep[np.asarray(sample["fov_mask"]).reshape(-1)]
            fov_rowcol_kept = fov_rowcol[kept_of_fov]

        origin = np.round(pts_ms[:, :3] / self.voxel_size).astype(np.int32).min(0, keepdims=True)
        frame = self._quantize(pts, labels, origin)
        fused = self._quantize(pts_ms, labels_ms, origin)
        frame.name = fused.name = sample.get("path", "")
        frame.token = fused.token = sample.get("token")
        main = MsVoxelSample(frame=frame, fused=fused, num_frame_points=len(pts))

        fov = self._quantize(pts_ms[fov_mask], labels_ms[fov_mask], origin)
        fov.name = frame.name
        # per-FOV-voxel rowcol: take the first contributing point's pixel
        vox_ids, first_idx = np.unique(fov.inverse_map, return_index=True)
        order = np.zeros(len(fov.coords), np.int64)
        order[vox_ids] = first_idx
        rowcol_vox = fov_rowcol_kept[order].astype(np.int32)

        return MmVoxelSample(
            main=main,
            fov=fov,
            fov_rowcol=rowcol_vox,
            images=np.asarray(sample["images"], np.float32),
            image_labels=np.asarray(sample["image_labels"], np.int32),
        )

    def collate(self, samples: list, point_capacity: int, fov_capacity: int) -> dict:
        """`collate_mm_shard` of this pipeline's samples."""
        return collate_mm_shard(samples, point_capacity, fov_capacity)


def collate_mm_shard(samples: list, point_capacity: int, fov_capacity: int) -> dict:
    """Collate MmVoxelSamples into one shard (JAX `collate_mm_batch`):
    the fused clouds' padded shard (`main`, its samples carrying their
    `ms_pair`) and the FOV clouds' (`fov`, at `fov_capacity` rows), the
    FOV rows' (row, col) padded to `fov_capacity` with rows re-offset by
    each scan's first image slot x H (`fov_rowcol`), the stacked images
    (`images` (n_img, H, W, 3)) and targets (`image_labels`), and the
    main shard's `offsets` and `samples` as the eval metadata."""
    main = collate_shard(_fused_with_pairs([m.main for m in samples]), point_capacity)
    fov = collate_shard([m.fov for m in samples], fov_capacity)
    n_img = sum(m.images.shape[0] for m in samples)
    h, w = samples[0].images.shape[1:3]
    images = np.zeros((n_img, h, w, 3), np.float32)
    image_labels = np.zeros((n_img, h, w), np.int32)
    rowcol = np.zeros((fov_capacity, 2), np.int32)
    f_off = fov["offsets"]
    img_base = 0
    for b, m in enumerate(samples):
        n_i = m.images.shape[0]
        images[img_base : img_base + n_i] = m.images
        image_labels[img_base : img_base + n_i] = m.image_labels
        rc = m.fov_rowcol.copy()
        rc[:, 0] += img_base * h  # rows pre-offset by in-scan slot
        rowcol[f_off[b] : f_off[b + 1]] = rc
        img_base += n_i
    offsets, fused = main.pop("offsets"), main.pop("samples")
    fov.pop("offsets"), fov.pop("samples")
    return {
        "main": main,
        "fov": fov,
        "fov_rowcol": rowcol,
        "images": images,
        "image_labels": image_labels,
        "offsets": offsets,
        "samples": fused,
    }
