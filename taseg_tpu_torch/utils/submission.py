"""Benchmark submission + pseudo-label I/O; copy of
`taseg_tpu/utils/submission.py`: SemanticKITTI's .label files and
nuScenes lidarseg's uint8 `lidarseg/test/<token>_lidarseg.bin` files with
their `submission.json`.

Replaces the reference's TTA save path (`train.py:471-528`) and the
`tta_remap.py` tool (LUT remap of .label files, tta_remap.py:96-156):
predictions are written as uint32 .label files under
`save_path/sequences/SS/predictions/NNNNNN.label`; train-id <-> raw-id
remapping uses the LUTs in data.semantickitti.labels and is byte-identical
(lower 16 bits semantics, upper 16 bits untouched instance ids).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from . import storage
from ..data.semantickitti.labels import (
    LEARNING_MAP_LUT,
    train_to_raw,
)


def prediction_path(save_root, seq: str, frame: int) -> Path:
    p = Path(save_root) / "sequences" / seq / "predictions"
    if not storage.is_remote(save_root):
        p.mkdir(parents=True, exist_ok=True)
    return p / f"{frame:06d}.label"


def save_predictions(
    save_root, scan_path: str, point_predict: np.ndarray, *, raw_ids: bool = True
) -> Path:
    """Write per-point predictions for one scan.  `point_predict` holds
    train ids; raw_ids=True remaps to the benchmark's raw label ids."""
    sp = Path(scan_path)
    seq = sp.parent.parent.name
    frame = int(sp.stem)
    out = prediction_path(save_root, seq, frame)
    labels = (
        train_to_raw(point_predict) if raw_ids
        else point_predict.astype(np.uint32)
    )
    storage.save_bin(out, labels.astype(np.uint32))
    return out


def save_logits(save_root, scan_path: str, logits: np.ndarray) -> Path:
    """--save_score analogue (train.py:489-494): float32 logits per point."""
    sp = Path(scan_path)
    out = prediction_path(save_root, sp.parent.parent.name, int(sp.stem))
    out = out.with_suffix(".bin")
    storage.save_bin(out, logits.astype(np.float32))
    return out


def remap_label_files(
    root, *, direction: str = "train_to_raw", inplace: bool = True
) -> int:
    """tta_remap.py equivalent: remap every predictions/NNNNNN.label under
    `root/sequences/**`.  direction 'train_to_raw' prepares submissions;
    'raw_to_train' prepares pseudo-mask directories for FSA training."""
    n = 0
    for f in sorted(Path(root).glob("sequences/*/predictions/*.label")):
        data = storage.load_bin(f, "uint32")
        if direction == "train_to_raw":
            out = train_to_raw(data & 0xFFFF) | (data & 0xFFFF0000)
        elif direction == "raw_to_train":
            sem = LEARNING_MAP_LUT[
                np.clip(data & 0xFFFF, 0, len(LEARNING_MAP_LUT) - 1)
            ].astype(np.uint32)
            out = sem | (data & 0xFFFF0000)
        else:
            raise ValueError(direction)
        storage.save_bin(
            f if inplace else f.with_suffix(".remap"), out.astype(np.uint32)
        )
        n += 1
    return n


# --------------------------- nuScenes lidarseg -----------------------------

NUSCENES_SUBMISSION_META = {
    "use_camera": False,
    "use_lidar": True,
    "use_radar": False,
    "use_map": False,
    "use_external": False,
}


def save_nuscenes_predictions(save_root, lidar_token: str, train_ids: np.ndarray) -> Path:
    """Write one scan's predictions in the nuScenes lidarseg challenge
    format: `<save_root>/lidarseg/test/<token>_lidarseg.bin`, uint8 class
    ids, one byte per point.  The benchmark rejects label 0 (ignore), so
    a 0 becomes the scan's most common other class (1 where there is
    none; reference train.py:508-528)."""
    out = Path(save_root) / "lidarseg" / "test"
    if not storage.is_remote(save_root):
        out.mkdir(parents=True, exist_ok=True)
    ids = np.asarray(train_ids).reshape(-1).astype(np.uint8)
    if (ids == 0).any():
        nz = ids[ids != 0]
        fill = np.uint8(np.bincount(nz).argmax()) if len(nz) else np.uint8(1)
        ids = np.where(ids == 0, fill, ids)
    path = out / f"{lidar_token}_lidarseg.bin"
    storage.save_bin(path, ids.reshape(-1, 1))
    return path


def write_nuscenes_submission_json(save_root) -> Path:
    """`submission.json` beside the lidarseg/ directory (train.py:545-559)."""
    path = Path(save_root) / "submission.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"meta": dict(NUSCENES_SUBMISSION_META)}, f)
    return path


def read_nuscenes_predictions(save_root, lidar_token: str) -> np.ndarray:
    p = Path(save_root) / "lidarseg" / "test" / f"{lidar_token}_lidarseg.bin"
    return storage.load_bin(p, "uint8")
