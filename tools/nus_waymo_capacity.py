#!/usr/bin/env python3
"""Per-level voxel occupancy of the nuScenes and Waymo recipes on the
sensor-sized synthetic trees (numpy only, no card).

    python3 tools/nus_waymo_capacity.py [--augment 2]

Writes the trees of `chip_smoke.py`'s phase 5k
(`tests/torch_nuscenes_fixture.make_card_trees`: one nuScenes scene of 9
keyframes with 9 sweeps of ~34 000 points between each pair, the ego at
5 m/s; Waymo frames of 150 000 + 20 000 returns) into a temporary
directory and runs every scan of each recipe's reader through its host
pipeline, unaugmented (serving) and `--augment` (2) times with the training
augmentation (the train step).  For every recipe it prints the largest
count of each UNet level (the cylinder recipe: of each polar level) over
the samples as a fraction of the recipe's point capacity per scan
(`MODEL.POINTS_PER_SCAN`, else 131 072 rows), beside the raw points; for
TIAF also the FOV cloud's, as fractions of its capacity
(DATA.FOV_NUM_POINTS, else half the point capacity).  These fractions are what each recipe's CAPACITY_SCHEDULE and
TRAIN_CAPACITY_SCHEDULE hold with headroom (`taseg_tpu_torch/configs.py`).
The camera images are seeded arrays (the decode is replaced; the
occupancy does not read them).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from taseg_tpu_torch.configs import RECIPES  # noqa: E402
from taseg_tpu_torch.data import build_reader  # noqa: E402
from taseg_tpu_torch.data.cylinder_dataset import CylinderPipeline, grid_from_cfg  # noqa: E402
from taseg_tpu_torch.data.nuscenes import reader_mm  # noqa: E402
from taseg_tpu_torch.data.voxel_dataset import MsVoxelPipeline, VoxelPipeline  # noqa: E402
from taseg_tpu_torch.data.voxel_mm import MsMmVoxelPipeline  # noqa: E402
from taseg_tpu_torch.engine import POINTS_PER_SCAN, fov_points  # noqa: E402
from taseg_tpu_torch.models.voxel.cylinder3d import CYL_STRIDES  # noqa: E402
from torch_nuscenes_fixture import make_card_trees  # noqa: E402

NEW_RECIPES = (
    "tools/cfgs/voxel/nuscenes/minkunet_mk34_cr10.yaml",
    "tools/cfgs/voxel/nuscenes/minkunet_mk34_cr10_fsa.yaml",
    "tools/cfgs/voxel/nuscenes/minkunet_mk34_cr10_fsa_tiaf.yaml",
    "tools/cfgs/voxel/waymo/minkunet_mk34_cr10.yaml",
    "tools/cfgs/voxel/waymo/minkunet_mk18_cr10.yaml",
    "tools/cfgs/voxel/waymo/cylinder_cy480_cr10.yaml",
    "tools/cfgs/fusion/waymo/spvcnn_mk18_cr10.yaml",
    "tools/cfgs/fusion/waymo/rpvnet_mk18_cr10.yaml",
)


def seeded_image(path, h: int, w: int) -> np.ndarray:
    """A (h, w, 3) float32 image in [0, 1] seeded by the file's name."""
    rng = np.random.default_rng(abs(hash(Path(path).name)) % 2**32)
    return rng.random((h, w, 3), dtype=np.float32)


def voxel_levels(coords: np.ndarray, levels: int = 5) -> list:
    return [len(np.unique(coords >> l, axis=0)) for l in range(levels)]


def cylinder_levels(coords: np.ndarray) -> list:
    return [len(np.unique(coords // np.asarray(s), axis=0)) for s in CYL_STRIDES]


def pipelines(cfg: dict, training: bool):
    """The recipe's host pipeline (as `engine.make_pipeline` builds it)."""
    m, d = cfg["MODEL"], cfg["DATA"]
    if m["NAME"] == "Cylinder_TS":
        return CylinderPipeline(grid=grid_from_cfg(d), training=training, seed=0)
    kw = dict(voxel_size=d["VOXEL_SIZE"], training=training,
              in_feature_dim=m.get("IN_FEATURE_DIM", 4), seed=0)
    if m["NAME"] == "MinkUNetMs":
        return MsVoxelPipeline(**kw)
    if m["NAME"].startswith("MinkUNetMsMm"):
        return MsMmVoxelPipeline(**kw)
    return VoxelPipeline(**kw)


def occupancy(path: str, roots: dict, augment: int) -> None:
    cfg = RECIPES[path]
    data = {**cfg["DATA"], "DATA_PATH": str(roots[cfg["DATA"]["DATASET"].split("_")[0]])}
    cap = int(cfg["MODEL"].get("POINTS_PER_SCAN", POINTS_PER_SCAN))
    count = cylinder_levels if cfg["MODEL"]["NAME"] == "Cylinder_TS" else voxel_levels
    worst = {}
    raw = []
    for training, reps in ((False, 1), (True, augment)):
        reader = build_reader(data, training)
        pipe = pipelines(cfg, training)
        for i in range(len(reader)):
            s = reader[i]
            raw.append(len(s.get("xyzret_ms", s["xyzret"])))
            for _ in range(reps):
                out = pipe(s)
                clouds = {"main": out}
                if hasattr(out, "fov"):
                    clouds = {"main": out.main.fused, "fov": out.fov}
                elif hasattr(out, "fused"):
                    clouds = {"main": out.fused}
                for k, c in clouds.items():
                    key = (k, "train" if training else "serve")
                    n = np.asarray(count(c.coords))
                    worst[key] = np.maximum(worst.get(key, 0), n)
    print(f"{path}: raw points {min(raw)}-{max(raw)}, point capacity {cap}")
    for (k, mode), n in sorted(worst.items()):
        c = cap if k == "main" else fov_points(cfg, cap)
        frac = ", ".join(f"{v / c:.4f}" for v in n)
        print(f"  {k:4s} {mode:5s} voxels {n.tolist()} -> ({frac}) of {c} rows", flush=True)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--augment", type=int, default=2, help="augmented samples per train scan")
    args = p.parse_args()
    reader_mm._load_image = seeded_image
    with tempfile.TemporaryDirectory() as tmp:
        nus, waymo = make_card_trees(Path(tmp))
        roots = {"nuscenes": nus, "waymo": waymo}
        for path in NEW_RECIPES:
            occupancy(path, roots, args.augment)


if __name__ == "__main__":
    main()
