"""nuScenes lidarseg taxonomy (dataset constants); copy of
`taseg_tpu/data/nuscenes/labels.py`.

Raw (32-class) -> 16+1 train-id map and class names, as defined by the
nuScenes lidarseg benchmark (reference
`pcseg/data/dataset/nuscenes/nuscenes.yaml:36-90`).  Labels are uint8 on
disk (one byte per point).
"""

from __future__ import annotations

import numpy as np

CLASS_NAMES = [
    "noise", "barrier", "bicycle", "bus", "car", "construction_vehicle",
    "motorcycle", "pedestrian", "traffic_cone", "trailer", "truck",
    "driveable_surface", "other_flat", "sidewalk", "terrain", "manmade",
    "vegetation",
]

_PAIRS = [
    (0, 0), (1, 0), (5, 0), (7, 0), (8, 0), (10, 0), (11, 0), (13, 0),
    (19, 0), (20, 0), (29, 0), (31, 0),
    (9, 1), (14, 2), (15, 3), (16, 3), (17, 4), (18, 5), (21, 6),
    (2, 7), (3, 7), (4, 7), (6, 7), (12, 8), (22, 9), (23, 10),
    (24, 11), (25, 12), (26, 13), (27, 14), (28, 15), (30, 16),
]

LEARNING_MAP_LUT = np.zeros(32, np.int32)
for raw, train in _PAIRS:
    LEARNING_MAP_LUT[raw] = train

NUM_CLASSES = 17  # incl. ignore class 0


def remap_labels(raw: np.ndarray) -> np.ndarray:
    return LEARNING_MAP_LUT[np.clip(raw.astype(np.int64), 0, 31)]
