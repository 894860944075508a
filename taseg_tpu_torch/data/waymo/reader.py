"""Waymo Open Dataset semantic-segmentation reader (preprocessed npy);
copy of `taseg_tpu/data/waymo/reader.py`.

Capability match of the reference reader
(`pcseg/data/dataset/waymo/waymo.py:7-108`) over the preprocessed per-frame
npy layout of the reference's preprocessing script
(`waymo/scripts/preprocess_waymo_data.py`): rows are
[range, intensity, elongation, x, y, z, ..., label]; the first- and
second-return files live under `first/` and `second/` and are
concatenated, with tanh-normalized intensity and elongation — a
5-feature xyzret cloud [x y z tanh(intensity) tanh(elongation)] the voxel
pipelines consume unchanged (23-class Waymo taxonomy, ignore 0).  The
frames come from the split lists (`train-0-31.txt`, `val-0-7.txt`) when
they exist, else from a glob of `<split>/first/*.npy`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ...utils import storage

WAYMO_CLASS_NAMES = [
    "undefined", "car", "truck", "bus", "other_vehicle", "motorcyclist",
    "bicyclist", "pedestrian", "sign", "traffic_light", "pole",
    "construction_cone", "bicycle", "motorcycle", "building", "vegetation",
    "tree_trunk", "curb", "road", "lane_marker", "other_ground", "walkable",
    "sidewalk",
]


class WaymoReader:
    def __init__(
        self,
        root_path: str,
        *,
        split: str = "train",
        split_file: str | None = None,
        samples_per_epoch: int = -1,
        seed: int = 0,
    ):
        self.root_path = Path(root_path)
        self.split = split
        self.class_names = WAYMO_CLASS_NAMES
        self.rng = np.random.default_rng(seed)
        if split_file is not None:
            split_files = [split_file]
        elif split == "train_val":  # the TRAINVAL recipe: both lists
            split_files = ["train-0-31.txt", "val-0-7.txt"]
        elif split == "train":
            split_files = ["train-0-31.txt"]
        else:
            split_files = ["val-0-7.txt"]
        listings = [self.root_path / f for f in split_files]
        if all(l.exists() for l in listings):
            self.files = [
                Path(l.strip())
                for listing in listings
                for l in listing.read_text().splitlines()
                if l.strip()
            ]
        else:  # the first-return directory's frames
            globs = ["train", "val"] if split == "train_val" else [split]
            self.files = sorted(
                p for g in globs for p in (self.root_path / g / "first").glob("*.npy")
            )
        if not self.files:
            raise FileNotFoundError(f"no Waymo frames under {self.root_path}")
        self._all_idx = np.arange(len(self.files))
        self.samples_per_epoch = (
            samples_per_epoch
            if samples_per_epoch > 0 and split.startswith("train")
            else len(self.files)
        )
        self.resample()

    def __len__(self):
        return len(self.sample_idx)

    def resample(self):
        if self.samples_per_epoch != len(self.files):
            self.sample_idx = self.rng.choice(self._all_idx, self.samples_per_epoch)
        else:
            self.sample_idx = self._all_idx

    @staticmethod
    def _load_return(path: Path):
        arr = storage.load_npy(path)
        xyz = arr[:, 3:6].astype(np.float32)
        inten_elong = arr[:, 1:3].astype(np.float32)
        labels = arr[:, -1].astype(np.int32)
        return np.concatenate([xyz, inten_elong], 1), labels

    def __getitem__(self, index: int) -> dict:
        path = self.files[self.sample_idx[index]]
        first, lbl1 = self._load_return(path)
        second_path = Path(str(path).replace("first/", "second/"))
        if second_path.exists():
            second, lbl2 = self._load_return(second_path)
            pts = np.concatenate([first, second])
            labels = np.concatenate([lbl1, lbl2])
        else:
            pts, labels = first, lbl1
        pts[:, 3:5] = np.tanh(pts[:, 3:5])
        if self.split == "test":
            labels = np.zeros(len(pts), np.int32)
        return {
            "xyzret": pts.astype(np.float32),
            "labels": labels.astype(np.int32),
            "path": str(path),
        }
