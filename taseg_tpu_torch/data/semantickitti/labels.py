"""SemanticKITTI label taxonomy (dataset constants); copy of
`taseg_tpu/data/semantickitti/labels.py`.

Raw-id -> train-id learning map, its inverse, and class names, as defined by
the SemanticKITTI benchmark (reference
`pcseg/data/dataset/semantickitti/semantickitti_utils.py:75-141` and
`semantic-kitti-all.yaml`).  Stored as numpy LUTs for vectorized remapping
(the reference uses `np.vectorize(dict.__getitem__)` per scan — a LUT gather
is ~100x faster and byte-identical).
"""

from __future__ import annotations

import numpy as np

CLASS_NAMES = [
    "unlabeled",
    "car", "bicycle", "motorcycle", "truck", "other-vehicle",
    "person", "bicyclist", "motorcyclist",
    "road", "parking", "sidewalk", "other-ground",
    "building", "fence", "vegetation", "trunk", "terrain",
    "pole", "traffic-sign",
]

# (raw_id, train_id) pairs — single-scan 20-class task
_LEARNING_PAIRS = [
    (0, 0), (1, 0), (10, 1), (11, 2), (13, 5), (15, 3), (16, 5), (18, 4),
    (20, 5), (30, 6), (31, 7), (32, 8), (40, 9), (44, 10), (48, 11),
    (49, 12), (50, 13), (51, 14), (52, 0), (60, 9), (70, 15), (71, 16),
    (72, 17), (80, 18), (81, 19), (99, 0), (252, 1), (253, 7), (254, 6),
    (255, 8), (256, 5), (257, 5), (258, 4), (259, 5),
]

# train_id -> representative raw id (for submission files;
# reference semantickitti_utils LEARNING_MAP_INV)
_INV_PAIRS = [
    (0, 0), (1, 10), (2, 11), (3, 15), (4, 18), (5, 20), (6, 30), (7, 31),
    (8, 32), (9, 40), (10, 44), (11, 48), (12, 49), (13, 50), (14, 51),
    (15, 70), (16, 71), (17, 72), (18, 80), (19, 81),
]

# multi-scan 26-class task adds moving classes 252..259 -> 20..25
# (semantic-kitti-multiscan.yaml:109-173)
_MULTISCAN_EXTRA = [
    (252, 20), (253, 21), (254, 22), (255, 23), (256, 5), (257, 5),
    (258, 24), (259, 25),
]

MULTISCAN_CLASS_NAMES = CLASS_NAMES + [
    "moving-car", "moving-bicyclist", "moving-person",
    "moving-motorcyclist", "moving-truck", "moving-other-vehicle",
]


def _build_lut(pairs, size=260) -> np.ndarray:
    lut = np.zeros(size, np.int32)
    for raw, train in pairs:
        lut[raw] = train
    return lut


LEARNING_MAP_LUT = _build_lut(_LEARNING_PAIRS)
LEARNING_MAP_MS_LUT = _build_lut(_LEARNING_PAIRS + _MULTISCAN_EXTRA)
INV_LUT = _build_lut(_INV_PAIRS, size=32)

NUM_CLASSES = 20
NUM_CLASSES_MS = 26


def remap_labels(raw_labels: np.ndarray, multiscan: bool = False) -> np.ndarray:
    """uint32 .label values -> train ids; lower 16 bits are semantics,
    upper 16 bits the instance id (tta_remap.py:150-154 packing)."""
    sem = (raw_labels & 0xFFFF).astype(np.int64)
    lut = LEARNING_MAP_MS_LUT if multiscan else LEARNING_MAP_LUT
    return lut[np.clip(sem, 0, len(lut) - 1)]


def instance_ids(raw_labels: np.ndarray) -> np.ndarray:
    return (raw_labels >> 16).astype(np.int32)


def train_to_raw(train_labels: np.ndarray) -> np.ndarray:
    """Inverse remap for benchmark submissions (tta_remap.py:96-156)."""
    return INV_LUT[np.clip(train_labels, 0, len(INV_LUT) - 1)].astype(np.uint32)
