"""A tiny SemanticKITTI tree on disk for the port's multi-scan tests.

After `tests/test_data_kitti.py:31 kitti_root` (a copy with more of the
label taxonomy): sequences 00 and 08 of N_FRAMES scans each, with
`calib.txt` (a Tr with an offset), `poses.txt` (a drive along x with a
slow yaw), `times.txt`, velodyne `.bin` scans of uniform points and
`.label` files whose raw ids include the classes the flexible steps and
SMSA act on (truck 18, other-vehicle 20, moving bicyclist 253 and
motorcyclist 255, moving car 252) with instance ids in the upper 16 bits;
and, under `<root>/../pseudo`, pseudo-label files of raw ids as a prior
single-frame run writes them (`<seq>/predictions/<frame>.label`).
"""

from pathlib import Path

import numpy as np

N_FRAMES = 6
N_POINTS = 1500
RAW_IDS = [10, 40, 48, 50, 70, 81, 30, 18, 20, 253, 255, 252]


def make_kitti_root(base: Path, seed: int = 0) -> Path:
    """Writes the tree under `base`; returns its `sequences` directory."""
    root = base / "sequences"
    pseudo = base / "pseudo"
    rng = np.random.default_rng(seed)
    for seq in ("00", "08"):
        seq_dir = root / seq
        (seq_dir / "velodyne").mkdir(parents=True)
        (seq_dir / "labels").mkdir()
        (pseudo / seq / "predictions").mkdir(parents=True)
        tr = np.eye(4)
        tr[:3, 3] = [0.1, -0.05, 0.2]
        lines = [f"{key}: " + " ".join(["0"] * 12) for key in ("P0", "P1", "P2", "P3")]
        lines.append("Tr: " + " ".join(str(v) for v in tr[:3].reshape(-1)))
        (seq_dir / "calib.txt").write_text("\n".join(lines))
        poses = []
        for t in range(N_FRAMES):
            c, s = np.cos(0.05 * t), np.sin(0.05 * t)
            pose = np.eye(4)
            pose[:2, :2] = [[c, -s], [s, c]]
            pose[:3, 3] = [2.0 * t, 0.1 * t, 0.0]
            poses.append(pose)
        (seq_dir / "poses.txt").write_text(
            "\n".join(" ".join(str(v) for v in p[:3].reshape(-1)) for p in poses)
        )
        (seq_dir / "times.txt").write_text("\n".join(str(0.1 * t) for t in range(N_FRAMES)))
        for t in range(N_FRAMES):
            pts = rng.uniform(-20, 20, (N_POINTS, 4)).astype(np.float32)
            pts[:, 3] = rng.uniform(0, 1, N_POINTS)
            pts.tofile(seq_dir / "velodyne" / f"{t:06d}.bin")
            raw_ids = rng.choice(RAW_IDS, N_POINTS)
            inst = rng.integers(0, 5, N_POINTS).astype(np.uint32) << 16
            (raw_ids.astype(np.uint32) | inst).tofile(seq_dir / "labels" / f"{t:06d}.label")
            # a prior model's predictions: the truth with 20% of the points
            # relabelled
            pred = raw_ids.copy()
            flip = rng.random(N_POINTS) < 0.2
            pred[flip] = rng.choice(RAW_IDS, int(flip.sum()))
            pred.astype(np.uint32).tofile(pseudo / seq / "predictions" / f"{t:06d}.label")
    return root
