"""Voxel-modality host pipelines + static-capacity collate (numpy).

Copy of `taseg_tpu/data/voxel_dataset.py` (reference
`semantickitti_voxel.py:78-177` semantics): per-sample aug ->
round(xyz / voxel_size) -> shift to nonnegative -> sparse_quantize dedup
-> per-voxel (coords, feats, labels) + eval-side inverse map, then
padding to a static point capacity.  Besides the single-scan
`VoxelPipeline`, the multi-scan pipelines of TASeg's temporal stages:
`MsVoxelPipeline` (FSA: the frame and the fused cloud quantized from one
origin, JAX :120) and `MsKdVoxelPipeline` (mask distillation: also the
teacher's GT-mask cloud, and the student/teacher pairs of matching
voxels, JAX :258), with their collates.
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

    def collate(self, samples: list, point_capacity: int) -> dict:
        """This pipeline's samples as one padded shard (`collate_shard`)."""
        return collate_shard(samples, point_capacity)


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


@dataclass
class MsVoxelSample:
    """One frame + fused-cloud pair (TLAD/FSA), both quantized coherently.

    `frame` is the single-scan sample (used for eval mapping); `fused` the
    multi-scan cloud the model consumes; `num_frame_points` the count of
    current-frame raw points leading the fused cloud (point_mask invariant,
    reference semantickitti_voxel_ms.py:189-212).
    """

    frame: VoxelSample
    fused: VoxelSample
    num_frame_points: int


class MsVoxelPipeline:
    """Coupled transform for (frame, fused) pairs: identical aug params on
    both clouds (reference aug_points_ms, seg_utils.py:102-200), clamp the
    fused cloud to the frame's min bounds so both share a quantization
    origin (semantickitti_voxel_ms.py:121-130), then dual quantization.
    The rows keep the order of `sparse_quantize` (JAX's), not key order."""

    sorted_points = False

    def __init__(
        self,
        voxel_size: float = 0.05,
        *,
        training: bool = True,
        if_flip=True, if_scale=True, scale_range=(0.9, 1.1),
        if_jitter=True, if_rotate=True,
        in_feature_dim: int = 5,
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

    def _quantize(self, pts, labels, origin) -> VoxelSample:
        vox = np.round(pts[:, :3] / self.voxel_size).astype(np.int32) - origin
        _, index, inverse = sparse_quantize(
            vox, return_index=True, return_inverse=True
        )
        return VoxelSample(
            coords=vox[index],
            feats=pts[index],
            labels=labels[index],
            inverse_map=inverse.astype(np.int32),
            raw_labels=labels,
            num_raw_points=len(pts),
            name="",
        )

    def __call__(
        self, sample: dict, aug: Optional[AugParams] = None
    ) -> MsVoxelSample:
        pts = sample["xyzret"][:, :4].astype(np.float32)
        pts_ms = sample["xyzret_ms"][:, : self.in_feature_dim].astype(np.float32)
        labels = np.asarray(sample["labels"]).reshape(-1).astype(np.int32)
        labels_ms = np.asarray(sample["labels_ms"]).reshape(-1).astype(np.int32)

        if self.training:
            aug = aug or AugParams.sample(self.rng, **self.aug_flags)
        if aug is not None:
            pts = pts.copy()
            pts_ms = pts_ms.copy()
            pts[:, :3] = aug.apply(pts[:, :3])
            pts_ms[:, :3] = aug.apply(pts_ms[:, :3])

        # clamp fused cloud to the frame's min bounds (shared quant origin)
        mn = pts[:, :3].min(0)
        keep = (pts_ms[:, :3] >= mn).all(1)
        pts_ms, labels_ms = pts_ms[keep], labels_ms[keep]

        vox_ms = np.round(pts_ms[:, :3] / self.voxel_size).astype(np.int32)
        origin = vox_ms.min(0, keepdims=True)
        frame = self._quantize(pts, labels, origin)
        fused = self._quantize(pts_ms, labels_ms, origin)
        frame.name = fused.name = sample.get("path", "")
        frame.token = fused.token = sample.get("token")
        # current-frame rows lead the fused cloud and always survive the
        # clamp (they define the min bound); the count equals the frame size
        return MsVoxelSample(
            frame=frame, fused=fused, num_frame_points=len(pts)
        )

    def collate(self, samples: list, point_capacity: int) -> dict:
        """The fused clouds as one padded shard; each fused sample of the
        metadata carries its pair (`ms_pair`), whose frame the eval maps
        to (JAX `data/__init__.py:388-395`)."""
        return collate_shard(_fused_with_pairs(samples), point_capacity)


def _fused_with_pairs(samples: list) -> list:
    fused = [s.fused for s in samples]
    for f, s in zip(fused, samples):
        f.ms_pair = s
    return fused


@dataclass
class KdVoxelSample:
    """Student (pseudo-mask) + teacher (GT-mask) fused clouds plus the
    host-computed coordinate-matched distillation pairs."""

    student: MsVoxelSample
    teacher: VoxelSample
    pair_student: np.ndarray  # (K,) rows into the student fused sample
    pair_teacher: np.ndarray  # (K,) matching rows in the teacher sample


def match_voxels(student: np.ndarray, teacher: np.ndarray) -> tuple:
    """(rows of `student`, rows of `teacher`) with equal coordinates, in
    student-row order: what JAX's dict loop (`voxel_dataset.py:311-318`)
    gives, on keys packed into int64 and one binary search.  Both inputs
    are (N, 3) nonnegative int32 coords without duplicates (quantized
    clouds)."""
    if len(student) == 0 or len(teacher) == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    dims = np.maximum(student.max(0), teacher.max(0)).astype(np.int64) + 1

    def pack(c):
        c = c.astype(np.int64)
        return (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]

    t_keys = pack(teacher)
    t_order = np.argsort(t_keys, kind="stable")
    t_sorted = t_keys[t_order]
    s_keys = pack(student)
    pos = np.minimum(np.searchsorted(t_sorted, s_keys), len(t_sorted) - 1)
    hit = t_sorted[pos] == s_keys
    return (
        np.nonzero(hit)[0].astype(np.int32),
        t_order[pos[hit]].astype(np.int32),
    )


class MsKdVoxelPipeline(MsVoxelPipeline):
    """KD-stage pipeline: coupled aug over frame / student-fused /
    teacher-fused clouds, dual quantization with a shared origin, and
    host-side voxel alignment (replacing the reference's on-device
    sphashquery, minkunet_ms_kd.py:613-615) sampled to <= max_voxel pairs.
    """

    def __init__(self, *args, max_voxel: int = 3000, **kw):
        super().__init__(*args, **kw)
        self.max_voxel = max_voxel

    def __call__(self, sample: dict, aug: Optional[AugParams] = None):
        pts = sample["xyzret"][:, :4].astype(np.float32)
        pts_ms = sample["xyzret_ms"][:, : self.in_feature_dim].astype(np.float32)
        pts_gt = sample["xyzret_ms_gt"][:, : self.in_feature_dim].astype(
            np.float32
        )
        labels = np.asarray(sample["labels"]).reshape(-1).astype(np.int32)
        labels_ms = np.asarray(sample["labels_ms"]).reshape(-1).astype(np.int32)
        labels_gt = np.asarray(sample["labels_ms_gt"]).reshape(-1).astype(
            np.int32
        )

        if self.training:
            aug = aug or AugParams.sample(self.rng, **self.aug_flags)
        if aug is not None:
            pts, pts_ms, pts_gt = pts.copy(), pts_ms.copy(), pts_gt.copy()
            pts[:, :3] = aug.apply(pts[:, :3])
            pts_ms[:, :3] = aug.apply(pts_ms[:, :3])
            pts_gt[:, :3] = aug.apply(pts_gt[:, :3])

        mn = pts[:, :3].min(0)
        keep = (pts_ms[:, :3] >= mn).all(1)
        pts_ms, labels_ms = pts_ms[keep], labels_ms[keep]
        keep_gt = (pts_gt[:, :3] >= mn).all(1)
        pts_gt, labels_gt = pts_gt[keep_gt], labels_gt[keep_gt]

        vox_ms = np.round(pts_ms[:, :3] / self.voxel_size).astype(np.int32)
        origin = np.minimum(
            vox_ms.min(0, keepdims=True),
            np.round(pts_gt[:, :3] / self.voxel_size).astype(np.int32).min(
                0, keepdims=True
            ),
        )
        frame = self._quantize(pts, labels, origin)
        fused = self._quantize(pts_ms, labels_ms, origin)
        teacher = self._quantize(pts_gt, labels_gt, origin)
        frame.name = fused.name = teacher.name = sample.get("path", "")
        frame.token = fused.token = teacher.token = sample.get("token")
        student = MsVoxelSample(
            frame=frame, fused=fused, num_frame_points=len(pts)
        )

        # host-side voxel alignment: match student voxel coords in the
        # teacher voxel set, then sample <= max_voxel pairs
        s_idx, t_idx = match_voxels(fused.coords, teacher.coords)
        if len(s_idx) > self.max_voxel:
            pick = self.rng.permutation(len(s_idx))[: self.max_voxel]
            s_idx, t_idx = s_idx[pick], t_idx[pick]
        return KdVoxelSample(
            student=student, teacher=teacher,
            pair_student=s_idx, pair_teacher=t_idx,
        )

    def collate(
        self, samples: list, point_capacity: int, teacher_capacity: int = None,
        max_voxel: int = None,
    ) -> dict:
        """`collate_kd_shard` at this pipeline's `max_voxel` unless given;
        the teacher's capacity defaults to the student's."""
        return collate_kd_shard(
            samples, point_capacity, teacher_capacity or point_capacity,
            max_voxel or self.max_voxel,
        )


def collate_kd_shard(
    samples: list, point_capacity: int, teacher_capacity: int, max_voxel: int
) -> dict:
    """Collate KD samples (JAX `collate_kd_batch`, one shard): the
    student's and the teacher's padded shards (`student`, `teacher`), the
    pair tables padded to max_voxel x scans rows with each sample's rows
    offset to its place in the shard (`kd_student_idx`, `kd_teacher_idx`,
    `kd_mask`), and the student's `offsets` and `samples` (fused, with
    their `ms_pair`) as the eval metadata."""
    s = collate_shard(_fused_with_pairs([k.student for k in samples]), point_capacity)
    t = collate_shard([k.teacher for k in samples], teacher_capacity)
    cap_pairs = max_voxel * len(samples)
    ps = np.zeros((cap_pairs,), np.int32)
    pt = np.zeros((cap_pairs,), np.int32)
    pm = np.zeros((cap_pairs,), bool)
    cur = 0
    for b, k in enumerate(samples):
        n = len(k.pair_student)
        ps[cur: cur + n] = k.pair_student + s["offsets"][b]
        pt[cur: cur + n] = k.pair_teacher + t["offsets"][b]
        pm[cur: cur + n] = True
        cur += n
    offsets, fused = s.pop("offsets"), s.pop("samples")
    t.pop("offsets"), t.pop("samples")
    return {
        "student": s,
        "teacher": t,
        "kd_student_idx": ps,
        "kd_teacher_idx": pt,
        "kd_mask": pm,
        "offsets": offsets,
        "samples": fused,
    }
