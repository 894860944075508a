"""Disk-backed TIAF reader — SemanticKITTI multi-scan + camera window;
copy of `taseg_tpu/data/semantickitti/reader_mm.py`.

Capability match of the reference multi-modal dataset
(`pcseg/data/dataset/semantickitti/semantickitti_ms_mm.py:304-461`): on top
of the TLAD/FSA fused cloud it loads the MULTISCAN_IMAGE/STEP_IMAGE camera
window (speed-adaptive step), warps the fused cloud into each window
frame, projects it through P2 @ Tr into that frame's image, crops to the
training resolution, and emits the MsMmVoxelPipeline contract:
`fov_mask`, `fov_rowcol` (rows offset by image slot), `images`,
`image_labels`.

Design differences (documented, not omissions):
  * each fused point is assigned to its most recent containing image
    instead of being duplicated once per image — the fusion head sees one
    pixel per point either way;
  * 2D semantic targets load from `SEMANTIC_MAP_ROOT` when the reference's
    precomputed `semantic_map_dilate/*.npy` files exist, and are otherwise
    generated on the fly by projecting that frame's labels and dilating
    (`tiaf.dilate_semantic_map`) — no preprocessing step required.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ...utils import storage
from .labels import remap_labels
from .poses import parse_calibration
from .reader_ms import MultiScanKittiReader
from .tiaf import (
    color_jitter,
    dilate_semantic_map,
    image_window,
    project_to_image,
    projection_matrix,
)


def _load_image(path: Path) -> np.ndarray:
    """(H, W, 3) float32 RGB in [0, 1]; Pillow is imported here only, so
    point-only runs (and the synthetic TIAF reader) never need it."""
    try:
        import PIL  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "TIAF disk reader needs Pillow for camera images"
        ) from e
    img = np.asarray(storage.load_image(path), np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img[..., :3] / 255.0


class TiafKittiReader(MultiScanKittiReader):
    """Yields the multi-scan dict plus the image window tensors."""

    def __init__(
        self,
        root_path: str,
        *,
        multiscan_image: int = 48,
        step_image: int = 12,
        image_height: int = 384,
        image_width: int = 1280,
        image_jitter: bool = True,
        semantic_map_root: str | None = None,
        **kw,
    ):
        super().__init__(root_path, **kw)
        self.multiscan_image = multiscan_image
        self.step_image = step_image
        self.image_height = image_height
        self.image_width = image_width
        self.image_jitter = image_jitter
        self.semantic_map_root = semantic_map_root
        self._calib_cache: dict[str, np.ndarray] = {}
        self.rng = np.random.default_rng(0)

    def _proj(self, seq: str) -> np.ndarray:
        if seq not in self._calib_cache:
            calib = parse_calibration(
                self.root_path / seq / "calib.txt"
            )
            self._calib_cache[seq] = projection_matrix(calib)
        return self._calib_cache[seq]

    def _semantic_map(self, seq: str, frame: int, proj, shape) -> np.ndarray:
        if self.semantic_map_root is not None:
            p = (
                Path(self.semantic_map_root) / seq / f"{frame:06d}.npy"
            )
            if storage.exists(p):
                m = storage.load_npy(p).reshape(shape[0], shape[1])[
                    : self.image_height, : self.image_width
                ]
                out = np.zeros(
                    (self.image_height, self.image_width), np.int32
                )
                out[: m.shape[0], : m.shape[1]] = m
                return out
        # fall back: project this frame's own labels and dilate
        scan_path = (
            self.root_path / seq / "velodyne" / f"{frame:06d}.bin"
        )
        pts = storage.load_bin(scan_path, "float32").reshape(-1, 4)
        labels = self._frame_labels(seq, frame, len(pts))
        keep, rowcol = project_to_image(
            pts, proj, img_w=shape[1], img_h=shape[0],
            crop_h=self.image_height, crop_w=self.image_width,
        )
        out = np.zeros((self.image_height, self.image_width), np.int32)
        out[rowcol[:, 0], rowcol[:, 1]] = labels[keep]
        return dilate_semantic_map(out)

    def _frame_labels(self, seq: str, frame: int, n: int) -> np.ndarray:
        p = self.root_path / seq / "labels" / f"{frame:06d}.label"
        if not storage.exists(p):
            return np.zeros(n, np.int32)
        raw = storage.load_bin(p, "uint32")
        return remap_labels(raw).astype(np.int32)

    def __getitem__(self, index: int) -> dict:
        out = super().__getitem__(index)
        seq, frame = self._seq_and_frame(Path(out["path"]))
        poses = self._poses(seq)
        proj = self._proj(seq)
        window = image_window(
            frame,
            multiscan_image=self.multiscan_image,
            step_image=self.step_image,
            poses=poses,
        )

        pts_ms = out["xyzret_ms"][:, :3].astype(np.float32)
        n = len(pts_ms)
        fov_mask = np.zeros(n, bool)
        rowcol_full = np.zeros((n, 2), np.int32)
        images, image_labels = [], []
        pose0 = poses[frame]
        for slot, f in enumerate(window):
            img_path = self.root_path / seq / "image_2" / f"{f:06d}.png"
            if not img_path.exists():
                continue
            img = _load_image(img_path)
            h0, w0 = img.shape[:2]
            # warp the fused cloud (frame-0 coords) into frame f
            hom = np.concatenate(
                [pts_ms, np.ones((n, 1), np.float32)], axis=1
            )
            rel = np.linalg.inv(poses[f]) @ pose0
            pts_f = (rel @ hom.T).T[:, :3]
            keep, rowcol = project_to_image(
                pts_f, proj, img_w=w0, img_h=h0,
                crop_h=self.image_height, crop_w=self.image_width,
            )
            new = keep & ~fov_mask  # most-recent containing image wins
            sub = new[keep]
            rowcol_new = rowcol[sub]
            rowcol_new[:, 0] += len(images) * self.image_height
            rowcol_full[new] = rowcol_new
            fov_mask |= new

            if self.image_jitter and self.split == "train":
                img = color_jitter(img, self.rng)
            crop = np.zeros(
                (self.image_height, self.image_width, 3), np.float32
            )
            ch = min(self.image_height, h0)
            cw = min(self.image_width, w0)
            crop[:ch, :cw] = img[:ch, :cw]
            images.append(crop)
            image_labels.append(
                self._semantic_map(seq, f, proj, (h0, w0))
            )

        if not images:  # no camera data on disk
            images = [np.zeros(
                (self.image_height, self.image_width, 3), np.float32
            )]
            image_labels = [np.zeros(
                (self.image_height, self.image_width), np.int32
            )]
        out.update(
            fov_mask=fov_mask,
            fov_rowcol=rowcol_full[fov_mask],
            images=np.stack(images),
            image_labels=np.stack(image_labels),
        )
        return out
