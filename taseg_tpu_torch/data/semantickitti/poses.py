"""KITTI odometry calibration / pose parsing; copy of
`taseg_tpu/data/semantickitti/poses.py`.

Semantics match the reference loaders (`semantickitti_ms.py:322-401`):
poses.txt rows are camera-frame 4x4 transforms; they are conjugated by the
velodyne->camera calibration Tr so that pose @ point maps velodyne points
of frame t into the sequence's world frame.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def parse_calibration(path) -> dict[str, np.ndarray]:
    calib = {}
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            continue
        key, content = line.split(":", 1)
        vals = np.fromstring(content, sep=" ")
        mat = np.eye(4)
        mat[:3, :4] = vals.reshape(3, 4)
        calib[key.strip()] = mat
    return calib


def parse_poses(path, calibration: dict) -> list[np.ndarray]:
    tr = calibration["Tr"]
    tr_inv = np.linalg.inv(tr)
    poses = []
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            continue
        vals = np.fromstring(line, sep=" ")
        mat = np.eye(4)
        mat[:3, :4] = vals.reshape(3, 4)
        poses.append((tr_inv @ mat @ tr).astype(np.float32))
    return poses


def load_sequence_poses(seq_dir) -> list[np.ndarray]:
    seq_dir = Path(seq_dir)
    calib = parse_calibration(seq_dir / "calib.txt")
    return parse_poses(seq_dir / "poses.txt", calib)


def warp_to_frame(points: np.ndarray, pose_src: np.ndarray, pose_dst: np.ndarray) -> np.ndarray:
    """Warp velodyne points from frame `src` into frame `dst` coordinates
    (reference `fuse_multi_scan`, semantickitti_ms.py:403-417): world = pose
    @ p, then express relative to dst pose (translation then rotation)."""
    xyz = points[:, :3]
    world = xyz @ pose_src[:3, :3].T + pose_src[:3, 3]
    rel = world - pose_dst[:3, 3]
    local = rel @ pose_dst[:3, :3]
    return np.concatenate([local.astype(points.dtype), points[:, 3:]], axis=1)
