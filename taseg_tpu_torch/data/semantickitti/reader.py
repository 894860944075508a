"""SemanticKITTI raw-scan reader (host side, numpy); copy of
`taseg_tpu/data/semantickitti/reader.py`.

Capability match of the reference reader
(`pcseg/data/dataset/semantickitti/semantickitti.py:19-196`): sequence
splits, .bin/.label parsing, 16-bit semantic/instance unpacking +
learning-map remap, ringID synthesis from yaw wrap-around, per-epoch
resampling, and LaserMix/PolarMix global augmentations.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ...utils import storage
from ..augment import lasermix, polarmix
from .labels import CLASS_NAMES, remap_labels

SPLIT_SEQS = {
    "train": ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"],
    "val": ["08"],
    "train_val": ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10", "08"],
    "test": ["11", "12", "13", "14", "15", "16", "17", "18", "19", "20", "21"],
}

POLARMIX_INSTANCE_CLASSES = [0, 1, 2, 3, 4, 5, 6, 7]


def ring_ids_from_yaw(points: np.ndarray) -> np.ndarray:
    """Synthesize per-point laser ring ids from azimuth wrap-arounds
    (reference semantickitti.py:97-107): KITTI scans are stored beam-major,
    so each yaw wrap 0.8->0.2 starts a new ring."""
    yaw = -np.arctan2(points[:, 1], -points[:, 0])
    px = 0.5 * (yaw / np.pi + 1.0)
    new_ring = np.zeros(len(px))
    wraps = np.nonzero((px[1:] < 0.2) & (px[:-1] > 0.8))[0] + 1
    new_ring[wraps] = 1
    return np.clip(np.cumsum(new_ring), 0, 63)


class SemanticKittiReader:
    """Yields dicts {'xyzret' (N,5 float32: x y z refl ring), 'labels'
    (N,) int32 train ids, 'path' str} — the reference reader contract."""

    def __init__(
        self,
        root_path: str,
        *,
        split: str = "train",
        augment: str = "GlobalAugment",
        samples_per_epoch: int = -1,
        seed: int = 0,
        multiscan_labels: bool = False,
        if_scribble: bool = False,
        sequences: list | None = None,
        split_file: str | None = None,
    ):
        self.root_path = Path(root_path)
        self.split = split
        self.augment = augment
        self.multiscan_labels = multiscan_labels
        # ScribbleKITTI weak labels (reference semantickitti.py:115-119):
        # same tree with 'SemanticKITTI'->'ScribbleKITTI' and
        # 'velodyne'->'scribbles'
        self.if_scribble = if_scribble
        self.class_names = CLASS_NAMES
        self.rng = np.random.default_rng(seed)

        # explicit sequence override: the reference's per-sequence
        # submission eval (`--seq`, train.py:75-76) restricts the split's
        # listing to one benchmark sequence at a time
        seqs = (
            [f"{int(s):02d}" for s in sequences]
            if sequences else SPLIT_SEQS[split]
        )
        self.scan_files: list[Path] = []
        for seq in seqs:
            vdir = self.root_path / seq / "velodyne"
            if vdir.is_dir():
                self.scan_files += sorted(vdir.glob("*.bin"))
        if split_file:
            # semi-supervised split list (the reference ships 1/10/20/50%
            # lists under pcseg/data/split/).  Lines end in
            # 'SS/velodyne/NNNNNN.bin'
            # (an absolute cluster prefix precedes them) — filter this
            # split's listing down to the named frames.
            # the port ships no split lists: SPLIT_FILE names a file
            sf = Path(split_file)
            if not sf.exists():
                raise FileNotFoundError(f"split file {split_file} not found")
            wanted = set()
            for line in sf.read_text().splitlines():
                line = line.strip()
                if line:
                    parts = Path(line).parts
                    wanted.add((parts[-3], parts[-1]))  # (seq, file)
            self.scan_files = [
                p for p in self.scan_files
                if (p.parent.parent.name, p.name) in wanted
            ]
        if not self.scan_files:
            raise FileNotFoundError(
                f"no SemanticKITTI scans under {self.root_path} for split {split}"
            )
        self._all_idx = np.arange(len(self.scan_files))
        self.samples_per_epoch = (
            samples_per_epoch
            if (samples_per_epoch > 0 and split.startswith("train"))
            else len(self.scan_files)
        )
        self.resample()

    def __len__(self) -> int:
        return len(self.sample_idx)

    def resample(self) -> None:
        """Re-draw the per-epoch sample subset (reference
        semantickitti.py:94-95)."""
        if self.samples_per_epoch != len(self.scan_files):
            self.sample_idx = self.rng.choice(
                self._all_idx, self.samples_per_epoch
            )
        else:
            self.sample_idx = self._all_idx

    def load_scan(self, path: Path) -> tuple[np.ndarray, np.ndarray]:
        pts = storage.load_bin(path, "float32").reshape(-1, 4)
        if self.split == "test":
            labels = np.zeros(len(pts), np.int32)
        else:
            if self.if_scribble:
                label_path = Path(
                    str(path)
                    .replace("SemanticKITTI", "ScribbleKITTI")
                    .replace("velodyne", "scribbles")[:-4] + ".label"
                )
            else:
                label_path = Path(
                    str(path).replace("velodyne", "labels")[:-4] + ".label"
                )
            raw = storage.load_bin(label_path, "uint32")
            labels = remap_labels(raw, multiscan=self.multiscan_labels).astype(
                np.int32
            )
        return pts, labels

    def __getitem__(self, index: int) -> dict:
        path = self.scan_files[self.sample_idx[index]]
        pts, labels = self.load_scan(path)

        if self.split.startswith("train") and self.augment.startswith("GlobalAugment"):
            mode = self.augment.removeprefix("GlobalAugment")  # '', '_L', '_P', '_LP'
            use_l = mode in ("_L", "_LP")
            use_p = mode in ("_P", "_LP")
            coin = self.rng.integers(0, 2)
            other = self.scan_files[self.rng.integers(0, len(self.scan_files))]
            if use_l and coin == 1:
                pts2, labels2 = self.load_scan(other)
                pts, labels = lasermix(
                    pts, labels, pts2, labels2, rng=self.rng
                )
            elif use_p and coin == 0:
                pts2, labels2 = self.load_scan(other)
                alpha = (self.rng.random() - 1) * np.pi
                omega = [
                    self.rng.random() * np.pi * 2 / 3,
                    (self.rng.random() + 1) * np.pi * 2 / 3,
                ]
                pts, labels = polarmix(
                    pts, labels, pts2, labels2,
                    alpha=alpha, beta=alpha + np.pi,
                    instance_classes=POLARMIX_INSTANCE_CLASSES,
                    omega=omega, rng=self.rng,
                )

        ring = ring_ids_from_yaw(pts).reshape(-1, 1).astype(np.float32)
        xyzret = np.concatenate([pts, ring], axis=1).astype(np.float32)
        return {"xyzret": xyzret, "labels": labels.astype(np.int32), "path": str(path)}
