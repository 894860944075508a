#!/usr/bin/env python3
"""Per-level voxel occupancy of the fused multi-scan clouds (numpy only).

    python3 tools/ms_capacity.py [--scans 24] [--points 120000] [--history 3] \
        [--voxel 0.05] [--capacity 262144]

Draws `--scans` samples of `SyntheticMsKittiReader(n_points, history,
kd=True)` (the train reader's seed and the eval reader's, half each) and
runs each through the port's host pipelines at voxel `--voxel`: the FSA
pipeline without augmentation (serving), and the KD pipeline with the
training augmentation (the student's fused cloud and the teacher's GT-mask
cloud, both as the train step sees them).  For every cloud it counts the
distinct voxels of each UNet level (stride 2^l: coords >> l, as the
topology builds them) and prints the largest count of each level over the
samples as a fraction of the point capacity (`--capacity`, 262 144 rows
per scan), beside the raw points and the distillation pairs.  These
fractions are what the recipes' CAPACITY_SCHEDULE and
TRAIN_CAPACITY_SCHEDULE must hold with headroom (taseg_tpu_torch/configs.py).

    python3 tools/ms_capacity.py --tiaf [--scans 12]

does the same for TIAF: `SyntheticTiafReader` samples (5 images of 384 x
1280, the recipe's window) through the MsMmVoxelPipeline unaugmented and augmented,
and prints the largest level counts of the main and of the FOV clouds as
fractions of the point capacity and of half of it (the FOV capacity).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from taseg_tpu_torch.data.synthetic import SyntheticMsKittiReader, SyntheticTiafReader  # noqa: E402
from taseg_tpu_torch.data.voxel_dataset import MsKdVoxelPipeline, MsVoxelPipeline  # noqa: E402
from taseg_tpu_torch.data.voxel_mm import MsMmVoxelPipeline  # noqa: E402

LEVELS = 5


def level_counts(coords: np.ndarray) -> list:
    return [len(np.unique(coords >> l, axis=0)) for l in range(LEVELS)]


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--scans", type=int, default=24)
    p.add_argument("--points", type=int, default=120_000)
    p.add_argument("--history", type=int, default=3)
    p.add_argument("--capacity", type=int, default=262_144)
    p.add_argument("--voxel", type=float, default=0.05)
    p.add_argument("--max_voxel", type=int, default=3000)
    p.add_argument("--tiaf", action="store_true", help="the TIAF main and FOV clouds")
    args = p.parse_args()
    if args.tiaf:
        tiaf(args)
        return

    serve = MsVoxelPipeline(voxel_size=args.voxel, training=False)
    train = MsKdVoxelPipeline(voxel_size=args.voxel, training=True, max_voxel=args.max_voxel, seed=0)
    worst = {k: np.zeros(LEVELS, np.int64) for k in ("serve", "student", "teacher")}
    raw = {"frame": [], "fused": [], "gt": [], "pairs": []}
    for i in range(args.scans):
        seed = i % 2  # the train reader's seed 0, the eval reader's 1
        reader = SyntheticMsKittiReader(
            length=args.scans, n_points=args.points, history=args.history, seed=seed, kd=True
        )
        s = reader[i // 2]
        raw["frame"].append(len(s["xyzret"]))
        raw["fused"].append(len(s["xyzret_ms"]))
        raw["gt"].append(len(s["xyzret_ms_gt"]))
        ms = serve(s)
        kd = train(s)
        raw["pairs"].append(len(kd.pair_student))
        for k, c in (("serve", ms.fused.coords), ("student", kd.student.fused.coords),
                     ("teacher", kd.teacher.coords)):
            n = np.asarray(level_counts(c))
            worst[k] = np.maximum(worst[k], n)
        print(
            f"scan {i}: raw frame {raw['frame'][-1]} fused {raw['fused'][-1]} gt {raw['gt'][-1]}; "
            f"serve {level_counts(ms.fused.coords)} frame voxels {len(ms.frame.coords)}; "
            f"train student {level_counts(kd.student.fused.coords)} "
            f"teacher {level_counts(kd.teacher.coords)} pairs {raw['pairs'][-1]}",
            flush=True,
        )
    print(f"over {args.scans} samples (largest per level, fraction of {args.capacity} rows):")
    for k, n in worst.items():
        frac = ", ".join(f"{v / args.capacity:.4f}" for v in n)
        print(f"  {k:8s} voxels {n.tolist()} -> ({frac})")
    print(
        "  raw points: frame " + f"{min(raw['frame'])}-{max(raw['frame'])}, fused "
        f"{min(raw['fused'])}-{max(raw['fused'])}, gt {min(raw['gt'])}-{max(raw['gt'])}; "
        f"pairs {min(raw['pairs'])}-{max(raw['pairs'])}"
    )


def tiaf(args) -> None:
    pipes = (
        MsMmVoxelPipeline(voxel_size=args.voxel, training=False),
        MsMmVoxelPipeline(voxel_size=args.voxel, training=True, seed=0),
    )
    worst = {k: np.zeros(LEVELS, np.int64) for k in ("main", "fov")}
    for i in range(args.scans):
        reader = SyntheticTiafReader(
            length=args.scans, n_points=args.points, history=args.history, seed=i % 2,
            n_images=5, img_h=384, img_w=1280,
        )
        s = reader[i // 2]
        for pipe in pipes:
            m = pipe(s)
            counts = {"main": level_counts(m.main.fused.coords), "fov": level_counts(m.fov.coords)}
            for k, n in counts.items():
                worst[k] = np.maximum(worst[k], n)
            print(f"scan {i} fov points {int(s['fov_mask'].sum())}: {counts}", flush=True)
    print(f"over {args.scans} samples x 2 (largest per level):")
    for k, cap in (("main", args.capacity), ("fov", args.capacity // 2)):
        frac = ", ".join(f"{v / cap:.4f}" for v in worst[k])
        print(f"  {k:5s} voxels {worst[k].tolist()} -> ({frac}) of {cap} rows")


if __name__ == "__main__":
    main()
