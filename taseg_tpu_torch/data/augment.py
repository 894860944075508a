"""Host-side point-cloud augmentations (numpy); copy of
`taseg_tpu/data/augment.py`, so the port needs no module of the JAX
package.  The same seed gives the same arrays in both packages.

  * `AugParams` — rotate/scale/flip/jitter parameters are *sampled once*
    and can be applied to any number of point clouds (reference
    `tools/utils/common/seg_utils.py:43-200`), and the deterministic
    10-vote TTA table (seg_utils.py:58-61) that `VoxelLoader.iter_tta`
    and `engine.Trainer.evaluate_points` vote over.
  * `lasermix` — inclination-band swapping between two scans, with the band
    count as a parameter instead of four hard-coded strategy blocks
    (reference `LaserMix_semantickitti.py`); strategies are replayable.
  * `polarmix` — azimuth-sector swap + instance rotate-paste
    (reference `PolarMix_semantickitti.py:61-96`), flags replayable.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

# TTA rotation table: vote k rotates by angle_vec[k] * pi/8
TTA_ANGLE_STEPS = (0, 1, -1, 2, -2, 6, -6, 7, -7, 8)


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

    @staticmethod
    def tta_vote(
        num_vote: int, *, if_scale=True, scale_range=(0.95, 1.05),
        rng: Optional[np.random.Generator] = None,
    ) -> "AugParams":
        """Deterministic rotation + random scale, the reference TTA recipe
        (semantickitti_voxel.py:101-117)."""
        theta = TTA_ANGLE_STEPS[num_vote] * np.pi / 8.0
        scale = (
            rng.uniform(*scale_range) if (if_scale and rng is not None) else 1.0
        )
        return AugParams(theta=theta, scale=scale, flip_type=0, jitter=None)

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


def _inclination_deg(xyz: np.ndarray) -> np.ndarray:
    rho = np.sqrt(xyz[:, 0] ** 2 + xyz[:, 1] ** 2)
    return np.degrees(np.arctan2(xyz[:, 2], rho))


# Band edges (degrees) per strategy, derived from the reference's four
# inc{3,4,5,6}phi1 partitions of the [-20, 5] inclination range.
LASERMIX_STRATEGIES = {
    "inc3phi1": (-6.7, -13.4),
    "inc4phi1": (-5.0, -10.0, -15.0),
    "inc5phi1": (-4.0, -8.0, -12.0, -16.0),
    "inc6phi1": (-3.3, -6.6, -9.9, -13.2, -16.5),
}


def lasermix(
    points_a: np.ndarray,
    labels_a: np.ndarray,
    points_b: np.ndarray,
    labels_b: np.ndarray,
    *,
    strategy: Optional[str] = None,
    rng: Optional[np.random.Generator] = None,
    return_strategy: bool = False,
):
    """Swap alternating inclination bands between scans A and B.

    Matches the reference mixing rule: band 0 from A, band 1 from B,
    band 2 from A, ... (LaserMix_semantickitti.py 'mix_1').
    """
    if strategy is None:
        rng = rng or np.random.default_rng()
        strategy = rng.choice(sorted(LASERMIX_STRATEGIES))
    edges = LASERMIX_STRATEGIES[strategy]

    def band_index(xyz):
        inc = _inclination_deg(xyz)
        idx = np.zeros(len(xyz), np.int32)
        for e in edges:
            idx += (inc <= e).astype(np.int32)
        return idx

    ia, ib = band_index(points_a), band_index(points_b)
    take_a = ia % 2 == 0  # even bands from A
    take_b = ib % 2 == 1  # odd bands from B
    pts = np.concatenate([points_a[take_a], points_b[take_b]], axis=0)
    lbl = np.concatenate([labels_a[take_a], labels_b[take_b]], axis=0)
    if return_strategy:
        return pts, lbl, strategy
    return pts, lbl


def polarmix(
    points_a: np.ndarray,
    labels_a: np.ndarray,
    points_b: np.ndarray,
    labels_b: np.ndarray,
    *,
    alpha: float,
    beta: float,
    instance_classes: Sequence[int],
    omega: Sequence[float],
    swap_flag: Optional[bool] = None,
    rotate_flag: Optional[bool] = None,
    rng: Optional[np.random.Generator] = None,
    return_flags: bool = False,
):
    """PolarMix: azimuth-sector swap + rotate-pasted instances of B into A."""
    rng = rng or np.random.default_rng()
    if swap_flag is None:
        swap_flag = bool(rng.random() < 0.5)
    if rotate_flag is None:
        rotate_flag = True  # reference pastes with probability 1.0

    pts, lbl = points_a, labels_a
    if swap_flag:
        # reference PolarMix uses -arctan2 (PolarMix_semantickitti.py:13-14)
        yaw_a = -np.arctan2(points_a[:, 1], points_a[:, 0])
        yaw_b = -np.arctan2(points_b[:, 1], points_b[:, 0])
        in_a = (yaw_a > alpha) & (yaw_a < beta)
        in_b = (yaw_b > alpha) & (yaw_b < beta)
        pts = np.concatenate([points_a[~in_a], points_b[in_b]], axis=0)
        lbl = np.concatenate([labels_a[~in_a], labels_b[in_b]], axis=0)

    if rotate_flag:
        inst_mask = np.isin(labels_b, np.asarray(instance_classes))
        inst_pts, inst_lbl = points_b[inst_mask], labels_b[inst_mask]
        copies = [pts]
        copies_l = [lbl]
        for w in omega:
            c, s = np.cos(w), np.sin(w)
            rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
            rotated = inst_pts.copy()
            rotated[:, :3] = inst_pts[:, :3] @ rot
            copies.append(rotated)
            copies_l.append(inst_lbl)
        pts = np.concatenate(copies, axis=0)
        lbl = np.concatenate(copies_l, axis=0)

    if return_flags:
        return pts, lbl, swap_flag, rotate_flag
    return pts, lbl
