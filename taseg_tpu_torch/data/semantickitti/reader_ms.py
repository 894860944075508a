"""TLAD / FSA multi-scan SemanticKITTI reader — the TASeg core data path;
copy of `taseg_tpu/data/semantickitti/reader_ms.py`.

Capability match of the reference multi-scan reader
(`pcseg/data/dataset/semantickitti/semantickitti_ms.py:120-320`):

  * loads the current frame plus up to MULTISCAN neighbor frames
    (ONLY_HISTORY restricts to past frames — the causal window);
  * pose-compensates each neighbor into the current frame
    (`fuse_multi_scan` semantics, see poses.py);
  * Flexible Step Aggregation: class c of neighbor Δ is kept iff
    |Δ| % FLEXIBLE_STEPS[c] == 0, where the class comes from a *pseudo
    mask* (a prior model's predictions on disk) or the GT labels
    (`PSEUDO_MASK: mink_notta | gt`, semantickitti_ms.py:283-308);
  * appends the time-flag channel (1 = current frame, 0 = history) between
    reflectance and ring id (append_time_flag, :253-257);
  * coupled LaserMix/PolarMix: the same mix strategy is replayed on the
    single frame and the fused cloud (:182-237).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ...utils import storage
from ..augment import lasermix, polarmix
from .labels import remap_labels, train_to_raw
from .poses import load_sequence_poses, warp_to_frame
from .reader import POLARMIX_INSTANCE_CLASSES, SemanticKittiReader, ring_ids_from_yaw
from .smsa import moving2static, static2moving


class MultiScanKittiReader(SemanticKittiReader):
    """Yields frame + fused-cloud pairs:

    {'xyzret' (N,5), 'labels' (N,), 'xyzret_ms' (M,6: xyz r timeflag ring),
     'labels_ms' (M,), 'path'}.
    """

    def __init__(
        self,
        root_path: str,
        *,
        multiscan: int = 16,
        only_history: bool = True,
        flexible_steps=None,
        pseudo_mask: str = "gt",
        pseudo_label_root: str | None = None,
        **kw,
    ):
        super().__init__(root_path, **kw)
        self.multiscan = multiscan
        self.only_history = only_history
        # per-class temporal sampling step; 0 = never aggregate this class
        self.flexible_steps = (
            list(flexible_steps) if flexible_steps is not None else [1] * 20
        )
        assert pseudo_mask in ("gt", "mink_notta")
        self.pseudo_mask = pseudo_mask
        self.pseudo_label_root = pseudo_label_root
        self._poses_cache: dict[str, list[np.ndarray]] = {}

    # ---------------- pose / path helpers --------------------------------
    def _poses(self, seq: str) -> list[np.ndarray]:
        if seq not in self._poses_cache:
            self._poses_cache[seq] = load_sequence_poses(self.root_path / seq)
        return self._poses_cache[seq]

    @staticmethod
    def _seq_and_frame(path: Path) -> tuple[str, int]:
        return path.parent.parent.name, int(path.stem)

    def _pseudo_labels(self, scan_path: Path) -> np.ndarray:
        """Raw-id class labels used only for the flexible-step keep mask."""
        if self.pseudo_mask == "gt":
            lbl = Path(str(scan_path).replace("velodyne", "labels")[:-4] + ".label")
            return storage.load_bin(lbl, "uint32") & 0xFFFF
        assert self.pseudo_label_root, (
            "PSEUDO_MASK mink_notta needs DATA.PSEUDO_LABEL_ROOT (predictions "
            "written by a prior single-frame run + tta_remap)"
        )
        seq, frame = self._seq_and_frame(scan_path)
        p = Path(self.pseudo_label_root) / seq / "predictions" / f"{frame:06d}.label"
        return storage.load_bin(p, "uint32") & 0xFFFF

    # ---------------- fusion ---------------------------------------------
    def multiscan_fuse(
        self,
        scan_path: Path,
        pseudo_override: str | None = None,
        return_extras: bool = False,
    ):
        """Pose-compensated neighbor points with per-class flexible-step
        masks applied; returns (points (M,4), train labels (M,)) and, with
        return_extras, also (raw uint32 labels, instance ids, frame
        deltas) — the extra channels SMSA operates on."""
        seq, frame = self._seq_and_frame(scan_path)
        poses = self._poses(seq)
        pose0 = poses[frame]
        # raw-id set kept at each |delta| per the per-class steps
        step_arr = np.asarray(self.flexible_steps)
        pts_list, lbl_list, raw_list, delta_list = [], [], [], []
        deltas = range(-self.multiscan, 1 if self.only_history else self.multiscan)
        for delta in deltas:
            nb = frame + delta
            if delta == 0 or nb < 0 or nb >= len(poses):
                continue
            nb_path = scan_path.parent / f"{nb:06d}.bin"
            if not storage.exists(nb_path):
                continue
            pts = storage.load_bin(nb_path, "float32").reshape(-1, 4)
            raw_lbl = storage.load_bin(
                Path(str(nb_path).replace("velodyne", "labels")[:-4] + ".label"),
                "uint32",
            )
            if pseudo_override == "gt":
                pseudo = raw_lbl & 0xFFFF
            else:
                pseudo = self._pseudo_labels(nb_path)

            keep = np.zeros(len(pts), bool)
            for cls, step in enumerate(step_arr):
                if step == 0 or abs(delta) % step != 0:
                    continue
                keep |= pseudo == train_to_raw(np.array([cls]))[0]
            if not keep.any():
                continue
            warped = warp_to_frame(pts[keep], poses[nb], pose0)
            pts_list.append(warped)
            lbl_list.append(
                remap_labels(raw_lbl[keep], multiscan=self.multiscan_labels)
            )
            raw_list.append(raw_lbl[keep])
            delta_list.append(np.full(int(keep.sum()), delta, np.int32))
        if not pts_list:
            empty = (
                np.zeros((0, 4), np.float32), np.zeros((0,), np.int32),
            )
            if return_extras:
                return empty + (
                    np.zeros((0,), np.uint32), np.zeros((0,), np.int32),
                )
            return empty
        out = (
            np.concatenate(pts_list).astype(np.float32),
            np.concatenate(lbl_list).astype(np.int32),
        )
        if return_extras:
            return out + (
                np.concatenate(raw_list),
                np.concatenate(delta_list),
            )
        return out

    @staticmethod
    def _with_time_flag(frame_pts: np.ndarray, fused_pts: np.ndarray) -> np.ndarray:
        """(M, 5): xyz, reflectance, time flag (1 = current frame rows)."""
        flag = np.zeros((len(fused_pts), 1), fused_pts.dtype)
        flag[: len(frame_pts)] = 1.0
        return np.concatenate([fused_pts[:, :4], flag], axis=1)

    # ---------------- sample assembly ------------------------------------
    def _frame_with_fused(self, path: Path):
        """(frame (N,4), labels, fused-with-time-flag (M,5), fused labels).
        Current-frame rows come first in the fused cloud (the point_mask
        invariant used at eval; mixing may later reorder rows, which the
        reference also allows since masks are eval-only)."""
        pts, labels = self.load_scan(path)
        hist_pts, hist_labels = self.multiscan_fuse(path)
        fused = np.concatenate([pts, hist_pts])
        fused_labels = np.concatenate([labels, hist_labels])
        return pts, labels, self._with_time_flag(pts, fused), fused_labels

    def __getitem__(self, index: int) -> dict:
        path = self.scan_files[self.sample_idx[index]]
        pts, labels, fused_tf, fused_labels = self._frame_with_fused(path)

        if self.split.startswith("train") and self.augment.startswith("GlobalAugment"):
            coin = self.rng.integers(0, 2)
            other = self.scan_files[self.rng.integers(0, len(self.scan_files))]
            pts2, labels2, fused2_tf, fused2_labels = self._frame_with_fused(other)
            if coin == 1:
                pts, labels, strategy = lasermix(
                    pts, labels, pts2, labels2, rng=self.rng, return_strategy=True
                )
                fused_tf, fused_labels = lasermix(
                    fused_tf, fused_labels, fused2_tf, fused2_labels,
                    strategy=strategy,
                )
            else:
                alpha = (self.rng.random() - 1) * np.pi
                omega = [
                    self.rng.random() * np.pi * 2 / 3,
                    (self.rng.random() + 1) * np.pi * 2 / 3,
                ]
                pts, labels, swap_f, rot_f = polarmix(
                    pts, labels, pts2, labels2,
                    alpha=alpha, beta=alpha + np.pi,
                    instance_classes=POLARMIX_INSTANCE_CLASSES, omega=omega,
                    rng=self.rng, return_flags=True,
                )
                fused_tf, fused_labels = polarmix(
                    fused_tf, fused_labels, fused2_tf, fused2_labels,
                    alpha=alpha, beta=alpha + np.pi,
                    instance_classes=POLARMIX_INSTANCE_CLASSES, omega=omega,
                    swap_flag=swap_f, rotate_flag=rot_f,
                )

        ring = ring_ids_from_yaw(pts).reshape(-1, 1).astype(np.float32)
        ring_ms = ring_ids_from_yaw(fused_tf).reshape(-1, 1).astype(np.float32)
        return {
            "xyzret": np.concatenate([pts, ring], axis=1).astype(np.float32),
            "labels": labels.astype(np.int32),
            "xyzret_ms": np.concatenate([fused_tf, ring_ms], axis=1).astype(
                np.float32
            ),
            "labels_ms": fused_labels.astype(np.int32),
            "path": str(path),
        }


class MsKdKittiReader(MultiScanKittiReader):
    """KD-stage reader: the pseudo-mask fused cloud (student input) plus a
    GT-mask-selected fused cloud (teacher input) per sample (reference
    `semantickitti_ms_kd.py` — same multiscan fuse run under both masks).
    Mixing augmentations are disabled here, matching the staged KD recipe.
    """

    def __getitem__(self, index: int) -> dict:
        path = self.scan_files[self.sample_idx[index]]
        pts, labels = self.load_scan(path)

        hist_pts, hist_labels = self.multiscan_fuse(path)
        fused = np.concatenate([pts, hist_pts])
        fused_labels = np.concatenate([labels, hist_labels])
        fused_tf = self._with_time_flag(pts, fused)

        hist_pts_gt, hist_labels_gt = self.multiscan_fuse(
            path, pseudo_override="gt"
        )
        fused_gt = np.concatenate([pts, hist_pts_gt])
        fused_labels_gt = np.concatenate([labels, hist_labels_gt])
        fused_gt_tf = self._with_time_flag(pts, fused_gt)

        ring = ring_ids_from_yaw(pts).reshape(-1, 1).astype(np.float32)
        ring_ms = ring_ids_from_yaw(fused_tf).reshape(-1, 1).astype(np.float32)
        ring_gt = ring_ids_from_yaw(fused_gt_tf).reshape(-1, 1).astype(np.float32)
        return {
            "xyzret": np.concatenate([pts, ring], axis=1).astype(np.float32),
            "labels": labels.astype(np.int32),
            "xyzret_ms": np.concatenate([fused_tf, ring_ms], axis=1).astype(
                np.float32
            ),
            "labels_ms": fused_labels.astype(np.int32),
            "xyzret_ms_gt": np.concatenate(
                [fused_gt_tf, ring_gt], axis=1
            ).astype(np.float32),
            "labels_ms_gt": fused_labels_gt.astype(np.int32),
            "path": str(path),
        }


class SmsaKittiReader(MultiScanKittiReader):
    """SMSA reader (26-class multi-scan task): applies static2moving /
    moving2static instance switching on the frame + fused clouds before
    time-flagging (reference `semantickitti_ms_ms.py:149-171`).  Requires
    multiscan labels (moving classes 20..25) — construct with
    multiscan_labels=True."""

    def __getitem__(self, index: int) -> dict:
        path = self.scan_files[self.sample_idx[index]]
        pts = storage.load_bin(path, "float32").reshape(-1, 4)
        raw = storage.load_bin(
            Path(str(path).replace("velodyne", "labels")[:-4] + ".label"),
            "uint32",
        )
        frame_raw = (raw & 0xFFFF).astype(np.int64)
        frame_inst = (raw >> 16).astype(np.int32)

        fused_pts, _, fused_rawu, fused_delta = self.multiscan_fuse(
            path, return_extras=True
        )
        fused_raw = (fused_rawu & 0xFFFF).astype(np.int64)
        fused_inst = (fused_rawu >> 16).astype(np.int32)

        if self.split.startswith("train") and len(fused_pts):
            if ((frame_raw == 18) | (frame_raw == 20)).any():
                pts, frame_raw, fused_pts, fused_raw = static2moving(
                    pts, frame_raw, frame_inst,
                    fused_pts, fused_raw, fused_inst, fused_delta,
                    rng=self.rng,
                )
            if ((frame_raw == 253) | (frame_raw == 255)).any():
                pts, frame_raw, fused_pts, fused_raw = moving2static(
                    pts, frame_raw, frame_inst,
                    fused_pts, fused_raw, fused_inst, fused_delta,
                    rng=self.rng,
                )

        labels = remap_labels(frame_raw.astype(np.uint32), multiscan=True).astype(
            np.int32
        )
        fused_labels = remap_labels(
            fused_raw.astype(np.uint32), multiscan=True
        ).astype(np.int32)
        full = np.concatenate([pts, fused_pts])
        full_labels = np.concatenate([labels, fused_labels])
        fused_tf = self._with_time_flag(pts, full)
        ring = ring_ids_from_yaw(pts).reshape(-1, 1).astype(np.float32)
        ring_ms = ring_ids_from_yaw(fused_tf).reshape(-1, 1).astype(np.float32)
        return {
            "xyzret": np.concatenate([pts, ring], axis=1).astype(np.float32),
            "labels": labels,
            "xyzret_ms": np.concatenate([fused_tf, ring_ms], axis=1).astype(
                np.float32
            ),
            "labels_ms": full_labels,
            "path": str(path),
        }
