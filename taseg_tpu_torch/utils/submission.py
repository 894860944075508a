"""Benchmark submission + pseudo-label I/O (SemanticKITTI format); the
SemanticKITTI half of `taseg_tpu/utils/submission.py` (the nuScenes
writers wait for the nuScenes reader, ROADMAP Queue 1 item 6).

Replaces the reference's TTA save path (`train.py:471-528`) and the
`tta_remap.py` tool (LUT remap of .label files, tta_remap.py:96-156):
predictions are written as uint32 .label files under
`save_path/sequences/SS/predictions/NNNNNN.label`; train-id <-> raw-id
remapping uses the LUTs in data.semantickitti.labels and is byte-identical
(lower 16 bits semantics, upper 16 bits untouched instance ids).
"""

from __future__ import annotations

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
