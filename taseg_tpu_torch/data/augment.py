"""Replayable augmentation parameters (numpy); copy of `AugParams` from
`taseg_tpu/data/augment.py` (without the TTA votes, which come with the
evaluation loop).

Rotate/scale/flip/jitter parameters are sampled once and can be applied
to any number of point clouds (reference
`tools/utils/common/seg_utils.py:43-200`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class AugParams:
    theta: float = 0.0  # z-rotation
    scale: float = 1.0
    flip_type: int = 0  # 0 none, 1 flip x, 2 flip y, 3 flip xy
    jitter: Optional[np.ndarray] = None  # (3,) translation

    @staticmethod
    def sample(
        rng: np.random.Generator,
        *,
        if_rotate=True,
        if_scale=True,
        scale_range=(0.9, 1.1),
        if_flip=True,
        if_jitter=True,
    ) -> "AugParams":
        return AugParams(
            theta=rng.uniform(0, 2 * np.pi) if if_rotate else 0.0,
            scale=rng.uniform(*scale_range) if if_scale else 1.0,
            flip_type=int(rng.integers(0, 4)) if if_flip else 0,
            jitter=rng.normal(0, 0.1, 3) if if_jitter else None,
        )

    def apply(self, xyz: np.ndarray) -> np.ndarray:
        out = xyz
        if self.theta != 0.0:
            c, s = np.cos(self.theta), np.sin(self.theta)
            rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
            out = out @ rot
        if self.scale != 1.0:
            out = out * self.scale
        if self.flip_type == 1:
            out = out * np.array([-1.0, 1.0, 1.0])
        elif self.flip_type == 2:
            out = out * np.array([1.0, -1.0, 1.0])
        elif self.flip_type == 3:
            out = out * np.array([-1.0, -1.0, 1.0])
        if self.jitter is not None:
            out = out + self.jitter
        return out
