"""nuScenes 6-camera TIAF reader (disk-backed, devkit-free); copy of
`taseg_tpu/data/nuscenes/reader_mm.py`.

Capability match of the reference multi-view multi-modal dataset
(`pcseg/data/dataset/nuscenes/nuscenes_ms_mm.py:72-73, 194+`): on top of
the distance-based TLAD sweep fusion, the six surround cameras
(CAM_FRONT ... CAM_FRONT_LEFT) of the current keyframe — and, when
MULTISCAN_IMAGE > 0, of STEP_IMAGE-spaced past keyframes — are stacked
into one image tensor; the fused cloud is projected into every camera
via the per-camera sensor2lidar extrinsics + intrinsics recorded in the
info pkls (mmdet3d-style `cams` records), emitting the same
`MsMmVoxelPipeline` contract as SemanticKITTI TIAF: `fov_mask`,
`fov_rowcol` (rows offset by image slot), `images`, `image_labels`.

2D targets are generated by projecting the fused labels and dilating
(`semantickitti.tiaf.dilate_semantic_map`).  A camera whose record or
file is missing is skipped; with none, one blank image stands in.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ...utils import storage
from ..semantickitti.tiaf import color_jitter, dilate_semantic_map
from .reader import NuscenesMsReader, quaternion_matrix

CAMERAS = (
    "CAM_FRONT",
    "CAM_FRONT_RIGHT",
    "CAM_BACK_RIGHT",
    "CAM_BACK",
    "CAM_BACK_LEFT",
    "CAM_FRONT_LEFT",
)


def _load_image(path: Path, h: int, w: int) -> np.ndarray:
    """(h, w, 3) float32 RGB in [0, 1], resized where the file differs;
    Pillow is imported here only, so point-only runs never need it."""
    try:
        import PIL  # noqa: F401
    except ImportError as e:
        raise ImportError("nuScenes TIAF reader needs Pillow for camera images") from e
    img = storage.load_image(path)
    if img.size != (w, h):
        img = img.resize((w, h))
    return np.asarray(img, np.float32)[..., :3] / 255.0


def project_to_camera(
    pts_lidar: np.ndarray, cam: dict, img_h: int, img_w: int,
    scale_x: float = 1.0, scale_y: float = 1.0,
):
    """Project lidar-frame points into one camera.

    `cam`: mmdet3d-style record with `sensor2lidar_rotation` (3x3 or
    quaternion), `sensor2lidar_translation` (3,), `cam_intrinsic` (3x3).
    Returns (keep (N,) bool, rowcol (M, 2) int32)."""
    rot = np.asarray(cam["sensor2lidar_rotation"], np.float64)
    if rot.shape == (4,):
        rot = quaternion_matrix(rot)
    t = np.asarray(cam["sensor2lidar_translation"], np.float64)
    # lidar -> camera: the inverse of sensor2lidar, R^T applied row-wise
    pts_cam = (pts_lidar - t) @ rot
    k = np.asarray(cam["cam_intrinsic"], np.float64)
    z = pts_cam[:, 2]
    keep = z > 0.5
    uv = pts_cam[keep, :2] / z[keep, None]
    u = uv[:, 0] * k[0, 0] * scale_x + k[0, 2] * scale_x
    v = uv[:, 1] * k[1, 1] * scale_y + k[1, 2] * scale_y
    ok = (u >= 0) & (u < img_w) & (v >= 0) & (v < img_h)
    keep[keep] = ok
    rowcol = np.stack([v[ok], u[ok]], axis=1).astype(np.int32)
    return keep, rowcol


class NuscenesTiafReader(NuscenesMsReader):
    """Yields the nuScenes multi-sweep dict plus the 6-camera image
    tensors.  `img_rng` (seeded 0) draws the train split's colour
    jitter, in JAX's order."""

    def __init__(
        self,
        root_path,
        *,
        multiscan_image: int = 0,
        step_image: int = 7,
        image_height: int = 448,
        image_width: int = 800,
        image_jitter: bool = True,
        **kw,
    ):
        super().__init__(root_path, **kw)
        self.multiscan_image = multiscan_image
        self.step_image = step_image
        self.image_height = image_height
        self.image_width = image_width
        self.image_jitter = image_jitter
        self.img_rng = np.random.default_rng(0)

    def _keyframe_window(self, index: int) -> list[int]:
        """Keyframe indices whose cameras are aggregated: the current one
        plus STEP_IMAGE-spaced history when MULTISCAN_IMAGE > 0."""
        frames = [index]
        for d in range(self.step_image, self.multiscan_image + 1, self.step_image):
            if index - d >= 0:
                frames.append(index - d)
        return frames

    def __getitem__(self, index: int) -> dict:
        out = super().__getitem__(index)
        i0 = int(self.sample_idx[index])
        pts_ms = out["xyzret_ms"][:, :3].astype(np.float64)
        n = len(pts_ms)
        lab_ms = np.asarray(out["labels_ms"]).reshape(-1)
        h, w = self.image_height, self.image_width
        fov_mask = np.zeros(n, bool)
        rowcol_full = np.zeros((n, 2), np.int32)
        images, image_labels = [], []

        for kf in self._keyframe_window(index):
            info = self.infos[self.sample_idx[kf] if kf != index else i0]
            cams = info.get("cams", {})
            for cam_name in CAMERAS:
                cam = cams.get(cam_name)
                if cam is None:
                    continue
                img_path = self._rel(str(cam["data_path"]))
                if not Path(img_path).exists():
                    continue
                # the original resolution scales the intrinsics
                w0 = int(cam.get("width", 1600))
                h0 = int(cam.get("height", 900))
                keep, rowcol = project_to_camera(pts_ms, cam, h, w, scale_x=w / w0, scale_y=h / h0)
                new = keep & ~fov_mask
                rc = rowcol[new[keep]]
                rc[:, 0] += len(images) * h
                rowcol_full[new] = rc
                fov_mask |= new

                img = _load_image(Path(img_path), h, w)
                if self.image_jitter and self.split == "train":
                    img = color_jitter(img, self.img_rng)
                images.append(img.astype(np.float32))
                # 2D targets: the fused labels projected into this camera
                tgt = np.zeros((h, w), np.int32)
                tgt[rowcol[:, 0], rowcol[:, 1]] = lab_ms[keep]
                image_labels.append(dilate_semantic_map(tgt))

        if not images:
            images = [np.zeros((h, w, 3), np.float32)]
            image_labels = [np.zeros((h, w), np.int32)]
        out.update(
            fov_mask=fov_mask,
            fov_rowcol=rowcol_full[fov_mask],
            images=np.stack(images),
            image_labels=np.stack(image_labels),
        )
        return out
