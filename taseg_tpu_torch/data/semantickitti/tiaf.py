"""TIAF data utilities — temporal image aggregation (host side); copy of
`taseg_tpu/data/semantickitti/tiaf.py`.

Capability match of the reference multi-modal reader pieces
(`semantickitti_ms_mm.py:298-461, 607-716`):

  * `project_to_image`: frustum projection of velodyne points through the
    calibration P2 @ Tr matrix, perspective divide, image crop, returning
    the surviving point mask and integer (row, col) coords;
  * `image_window`: the MULTISCAN_IMAGE/STEP_IMAGE frame-window selection
    with the speed-adaptive halving (`get_driving_dist`, :298-325) — fast
    ego motion halves the image step;
  * `color_jitter`: brightness / contrast / saturation jitter;
  * `dilate_semantic_map`: generates the dilated 2D semantic targets the
    reference loads from precomputed `semantic_map_dilate/*.npy`.
"""

from __future__ import annotations

import numpy as np


def projection_matrix(calib: dict) -> np.ndarray:
    """P2 @ [Tr; 0 0 0 1]: velodyne -> image plane (reference loads P2/Tr
    from calib.txt and composes them)."""
    p2 = np.asarray(calib["P2"])[:3].reshape(3, 4)
    tr = np.asarray(calib["Tr"])
    return p2 @ tr


def select_points_in_frustum(uv: np.ndarray, x0, y0, x1, y1) -> np.ndarray:
    return (
        (uv[:, 0] >= x0) & (uv[:, 0] < x1) & (uv[:, 1] >= y0) & (uv[:, 1] < y1)
    )


def project_to_image(
    points: np.ndarray,
    proj: np.ndarray,
    img_w: int,
    img_h: int,
    *,
    crop_h: int | None = None,
    crop_w: int | None = None,
):
    """Returns (keep_mask (N,), rowcol (M, 2) int32) for forward points that
    land inside the (optionally cropped) image (semantickitti_ms_mm.py:
    416-430, 446-457)."""
    crop_h = crop_h or img_h
    crop_w = crop_w or img_w
    keep = points[:, 0] > 0
    hom = np.concatenate(
        [points[keep, :3], np.ones((int(keep.sum()), 1), np.float32)], axis=1
    )
    uvz = (proj @ hom.T).T
    z = np.maximum(uvz[:, 2], 1e-6)
    uv = uvz[:, :2] / z[:, None]
    in_img = select_points_in_frustum(uv, 0, 0, img_w, img_h)
    keep[keep] = in_img
    rowcol = np.fliplr(uv[in_img]).astype(np.int32)  # (row, col)
    in_crop = (rowcol[:, 0] < crop_h) & (rowcol[:, 1] < crop_w)
    keep[keep.nonzero()[0][~in_crop]] = False
    return keep, rowcol[in_crop]


def driving_distance(poses: list, frame: int, window: int) -> float:
    """Ego displacement over the last `window` frames (get_driving_dist)."""
    lo = max(frame - window, 0)
    return float(
        np.linalg.norm(poses[frame][:3, 3] - poses[lo][:3, 3])
    )


def image_window(
    frame: int,
    *,
    multiscan_image: int = 48,
    step_image: int = 12,
    poses: list | None = None,
    speed_threshold: float = 30.0,
) -> list[int]:
    """History frame indices whose camera images are aggregated: every
    `step_image` frames over the `multiscan_image` window, with the step
    halved when the ego moved more than `speed_threshold` meters over the
    window (semantickitti_ms_mm.py:318-325)."""
    step = step_image
    if poses is not None and driving_distance(
        poses, frame, multiscan_image
    ) > speed_threshold:
        step = max(step_image // 2, 1)
    frames = [frame - d for d in range(0, multiscan_image + 1, step)]
    return [f for f in frames if f >= 0]


def color_jitter(
    image: np.ndarray, rng: np.random.Generator,
    brightness=0.4, contrast=0.4, saturation=0.4,
) -> np.ndarray:
    """Lightweight brightness/contrast/saturation jitter on float RGB
    (reference color_jitter, :607-716)."""
    out = image.astype(np.float32)
    if brightness:
        out = out * (1 + rng.uniform(-brightness, brightness))
    if contrast:
        mean = out.mean()
        out = (out - mean) * (1 + rng.uniform(-contrast, contrast)) + mean
    if saturation:
        gray = out.mean(-1, keepdims=True)
        out = gray + (out - gray) * (1 + rng.uniform(-saturation, saturation))
    return np.clip(out, 0, 255 if image.max() > 1.5 else 1.0)


def dilate_semantic_map(
    label_img: np.ndarray, iterations: int = 2
) -> np.ndarray:
    """Grow sparse projected labels into dense-ish 2D supervision targets
    (generator for the reference's precomputed semantic_map_dilate npy
    files): each unlabeled pixel takes any labeled 4-neighbor, repeated."""
    out = label_img.copy()
    for _ in range(iterations):
        empty = out == 0
        for shift, axis in ((1, 0), (-1, 0), (1, 1), (-1, 1)):
            neigh = np.roll(out, shift, axis=axis)
            take = empty & (out == 0) & (neigh != 0)
            out[take] = neigh[take]
    return out
