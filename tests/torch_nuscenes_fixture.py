"""nuScenes and Waymo trees on disk for the port's tests and for
`chip_smoke.py`'s phase 5k (numpy only; Pillow only where JPEGs are
written).

`make_nuscenes_root` follows `tests/test_nuscenes.py:24 nusc_root`: the
info pickles (`nuscenes_infos_<split>.pkl` with `infos`, `..._sweep.pkl`
with `infos_sweep`, `global_indexes`, `local_indexes`, `scene_tokens`)
over `.bin` sweeps of five float32 columns and uint8 lidarseg labels, one
scene whose ego drives along x (a slow yaw on the keyframes' ego pose),
sweeps between the keyframes relative to their keyframe, and six camera
records (`cams`) per keyframe around the car, with their image files.
`make_waymo_root` follows `tests/test_waymo_roundtrip.py:32 waymo_root`:
`<split>/{first,second}/<idx>.npy` returns of [range, intensity,
elongation, x, y, z, label] rows and the split lists.

The default clouds are uniform points (the JAX fixtures' small trees);
`static_world` makes the sweeps samples of one raycast street
(`data.synthetic.synthetic_scan`) seen from the moving ego, for trees at
a sensor's real size.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

CAMERAS = (
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_RIGHT", "CAM_BACK", "CAM_BACK_LEFT", "CAM_FRONT_LEFT",
)
# nuScenes' camera yaws (degrees, lidar frame: x forward, y left) and
# its 1600 x 900 images with a ~1266 px focal length
CAM_YAW = (0.0, -55.0, -110.0, 180.0, 110.0, 55.0)
CAM_SIZE = (1600, 900)
CAM_K = np.array([[1266.4, 0.0, 816.3], [0.0, 1266.4, 491.5], [0.0, 0.0, 1.0]])
# the synthetic scene's classes (data/synthetic.py: car 1, road 9,
# building 13, vegetation 15, pole 18) as nuScenes raw lidarseg ids
# (car 17, driveable_surface 24, manmade 28, vegetation 30) and as Waymo
# classes (car 1, road 18, building 14, vegetation 15, pole 10)
NUSC_RAW = {1: 17, 9: 24, 13: 28, 15: 30, 18: 28}
WAYMO_IDS = {1: 1, 9: 18, 13: 14, 15: 15, 18: 10}


def _lut(table: dict) -> np.ndarray:
    lut = np.zeros(32, np.int64)
    for k, v in table.items():
        lut[k] = v
    return lut


def yaw_quat(theta: float) -> list:
    return [np.cos(theta / 2), 0.0, 0.0, np.sin(theta / 2)]


def uniform_cloud(rng: np.random.Generator, n: int, x: float = 0.0):
    """(n, 5) float32 points uniform in a 20 m cube and raw labels (the
    JAX fixture's clouds; `x`, the ego position, is not used)."""
    pts = rng.uniform(-10, 10, (n, 5)).astype(np.float32)
    return pts, rng.integers(0, 31, n).astype(np.uint8)


def static_world(seed: int, n_world: int = 200_000, labels: dict = NUSC_RAW):
    """A sampler of sweeps of one static raycast street: the world is one
    `synthetic_scan` of `n_world` points; a sweep at ego position x draws
    `n` of them (each sweep its own subset, 1.5 cm of range noise), in its
    own lidar frame (x subtracted), with intensity in 0-255 and the ring
    in column 4, and the points' `labels` ids."""
    from taseg_tpu_torch.data.synthetic import synthetic_scan

    world, lbl = synthetic_scan(np.random.default_rng(seed), n_world)
    lut = _lut(labels)

    def sample(rng: np.random.Generator, n: int, x: float = 0.0):
        idx = rng.choice(len(world), n, replace=False)
        pts = np.zeros((n, 5), np.float32)
        pts[:, :3] = world[idx, :3] + rng.normal(0, 0.015, (n, 3))
        pts[:, 0] -= x
        pts[:, 3] = world[idx, 3] * 255.0
        pts[:, 4] = rng.integers(0, 32, n)
        return pts, lut[lbl[idx]].astype(np.uint8)

    return sample


def _camera(rng, root: Path, k: int, name: str, yaw_deg: float, jpeg_hw) -> dict:
    """A camera record at the lidar's origin looking along `yaw_deg`, and
    its image: a random JPEG of `jpeg_hw` (Pillow), else an empty
    placeholder file (the reader only needs the file to exist where the
    caller replaces the decode)."""
    path = root / "samples" / name / f"{k:04d}.jpg"
    path.parent.mkdir(parents=True, exist_ok=True)
    if jpeg_hw is not None:
        from PIL import Image

        Image.fromarray(rng.integers(0, 255, (*jpeg_hw, 3), dtype=np.uint8)).save(path)
    else:
        path.write_bytes(b"")
    a = np.deg2rad(yaw_deg)
    fwd = np.array([np.cos(a), np.sin(a), 0.0])
    right = np.array([np.sin(a), -np.cos(a), 0.0])
    down = np.array([0.0, 0.0, -1.0])
    # columns: the camera's x (right), y (down), z (forward) in the lidar frame
    rot = np.stack([right, down, fwd], axis=1)
    return {
        "data_path": str(path),
        "sensor2lidar_rotation": rot,
        "sensor2lidar_translation": np.array([0.0, 0.0, -0.2]),
        "cam_intrinsic": CAM_K,
        "width": CAM_SIZE[0],
        "height": CAM_SIZE[1],
    }


def _pseudo(rng, root: Path, token: str, n: int) -> None:
    (root / "pseudo").mkdir(exist_ok=True)
    rng.integers(0, 17, n).astype(np.uint8).tofile(root / "pseudo" / f"{token}_lidarseg.bin")


def make_nuscenes_root(
    base: Path,
    *,
    n_key: int = 4,
    sweeps_between: int = 4,
    n_points: int = 1000,
    n_sweep_points: int = 800,
    spacing: float = 0.5,
    speed: float = 10.0,
    yaw_rate: float = 0.05,
    splits=("val",),
    cameras: bool = True,
    jpeg_hw=(48, 64),
    sampler=uniform_cloud,
    pseudo: bool = False,
    seed: int = 0,
) -> Path:
    """Writes the tree under `base` and returns it.  Keyframe k sits at
    x = k (sweeps_between + 1) spacing; the sweeps before it at every
    `spacing` meters, recorded relative to it; time runs at `speed` m/s;
    keyframe k's ego pose turns by k `yaw_rate` radians (0 for a static
    world's sampler, whose sweeps it would misalign).  The keyframes carry lidarseg labels and (`cameras`) six camera
    records; the first 20 points of each keyframe lie in the ego box.
    Every split in `splits` gets the same info files.  `pseudo`: a prior
    run's predictions (uint8 train ids) for every sweep and keyframe under
    `<base>/pseudo/<token>_lidarseg.bin`."""
    root = Path(base).absolute()  # the infos hold absolute paths, as the reference's do
    (root / "samples").mkdir(parents=True, exist_ok=True)
    (root / "sweeps").mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    stride = (sweeps_between + 1) * spacing
    infos, infos_sweep, gidx, lidx, scenes = [], [], [], [], []
    t0 = 1_000_000_000.0
    for k in range(n_key):
        xk = k * stride
        for s in range(sweeps_between if k > 0 else 0):
            x = (k - 1) * stride + (s + 1) * spacing
            path = f"sweeps/sweep_{k}_{s}.bin"
            pts, _ = sampler(rng, n_sweep_points, x)
            pts.tofile(root / path)
            if pseudo:
                _pseudo(rng, root, f"sw_{k}_{s}", len(pts))
            infos_sweep.append({
                "data_path": str(root / path),
                "sensor2lidar_rotation": np.eye(3),
                "sensor2lidar_translation": np.array([x - xk, 0.0, 0.0]),
                "timestamp": t0 + x / speed * 1e6,
                "sample_data_token": f"sw_{k}_{s}",
            })
            lidx.append(k)
            scenes.append("scene0")
        path = f"samples/key_{k}.bin"
        pts, raw = sampler(rng, n_points, xk)
        pts[:20, 0] = rng.uniform(-0.5, 0.5, 20)
        pts[:20, 1] = rng.uniform(-1.0, 1.0, 20)
        pts.tofile(root / path)
        lbl_path = f"samples/key_{k}_lidarseg.bin"
        raw.tofile(root / lbl_path)
        if pseudo:
            _pseudo(rng, root, f"key_{k}", len(pts))
        info = {
            "lidar_path": str(root / path),
            "lidarseg_path": str(root / lbl_path),
            "token": f"key_{k}",
            "timestamp": t0 + xk / speed * 1e6,
            "lidar2ego_rotation": yaw_quat(0.0),
            "lidar2ego_translation": [0.0, 0.0, 1.8],
            "ego2global_rotation": yaw_quat(yaw_rate * k),
            "ego2global_translation": [xk, 0.0, 0.0],
        }
        if cameras:
            info["cams"] = {
                name: _camera(rng, root, k, name, yaw, jpeg_hw) for name, yaw in zip(CAMERAS, CAM_YAW)
            }
        infos.append(info)
        gidx.append(len(infos_sweep))
        infos_sweep.append(dict(info))
        lidx.append(k)
        scenes.append("scene0")
    for split in splits:
        with open(root / f"nuscenes_infos_{split}.pkl", "wb") as f:
            pickle.dump({"infos": infos}, f)
        with open(root / f"nuscenes_infos_{split}_sweep.pkl", "wb") as f:
            pickle.dump({
                "infos_sweep": infos_sweep, "global_indexes": gidx,
                "local_indexes": lidx, "scene_tokens": scenes,
            }, f)
    return root


def waymo_rows(xyz: np.ndarray, intensity, elongation, labels) -> np.ndarray:
    """(N, 7) float32 rows [range, intensity, elongation, x, y, z, label]
    (`tools/scripts/preprocess_waymo.py:frame_rows`)."""
    return np.concatenate([
        np.linalg.norm(xyz, axis=1, keepdims=True), np.reshape(intensity, (-1, 1)),
        np.reshape(elongation, (-1, 1)), xyz, np.reshape(labels, (-1, 1)),
    ], axis=1).astype(np.float32)


def make_waymo_root(
    base: Path,
    *,
    frames=(("train", 4), ("val", 2)),
    n_first: int = 3000,
    n_second: int = 750,
    synthetic: bool = False,
    seed: int = 0,
) -> Path:
    """Writes `<split>/{first,second}/<idx:08d>.npy` per frame and the
    split lists (`train-0-31.txt`, `val-0-7.txt`) under `base`.  Uniform
    points in a 60 m cube by default; `synthetic`: each frame a
    `synthetic_scan` of `n_first` points, its second return `n_second` of
    them 0.3-1.5 m further along the ray."""
    root = Path(base)
    rng = np.random.default_rng(seed)
    listed = {}
    for split, n_frames in frames:
        listed[split] = []
        for idx in range(n_frames):
            if synthetic:
                from taseg_tpu_torch.data.synthetic import synthetic_scan

                pts, lbl = synthetic_scan(rng, n_first)
                lbl = _lut(WAYMO_IDS)[lbl]
                xyz = pts[:, :3]
                pick = rng.choice(n_first, n_second, replace=False)
                ray = xyz[pick] / np.linalg.norm(xyz[pick], axis=1, keepdims=True)
                xyz2 = xyz[pick] + ray * rng.uniform(0.3, 1.5, (n_second, 1))
                first = waymo_rows(xyz, pts[:, 3] * 2000.0, rng.uniform(0, 2, n_first), lbl)
                second = waymo_rows(xyz2, rng.uniform(0, 500, n_second), rng.uniform(0, 2, n_second),
                                    lbl[pick])
            else:
                def mk(n):
                    xyz = rng.uniform(-30, 30, (n, 3))
                    return waymo_rows(xyz, rng.uniform(0, 5000, n), rng.uniform(0, 2, n),
                                      rng.integers(0, 23, n))
                first, second = mk(n_first), mk(n_second)
            for name, rows in (("first", first), ("second", second)):
                d = root / split / name
                d.mkdir(parents=True, exist_ok=True)
                np.save(d / f"{idx:08d}.npy", rows)
            listed[split].append(root / split / "first" / f"{idx:08d}.npy")
    for split, listing in (("train", "train-0-31.txt"), ("val", "val-0-7.txt")):
        if split in listed:
            (root / listing).write_text("\n".join(str(p) for p in listed[split]))
    return root


# the trees of `chip_smoke.py`'s phase 5k and `tools/nus_waymo_capacity.py`,
# at the sensors' sizes: nuScenes' 32-beam lidar at 20 Hz (~34 000
# points a sweep) with keyframes at 2 Hz (9 sweeps between), the ego at
# 5 m/s (0.25 m a sweep), so STEP 1.0 m picks ~15 sweeps over 3 s; a
# Waymo frame's top lidar (a 64 x 2650 range image: ~150 000 first and
# ~20 000 second returns)
NUS_CARD = dict(
    n_key=9, sweeps_between=9, n_points=34_000, n_sweep_points=34_000, spacing=0.25,
    speed=5.0, yaw_rate=0.0, splits=("train", "val"),
)
WAYMO_CARD = dict(frames=(("train", 4), ("val", 3)), n_first=150_000, n_second=20_000, synthetic=True)


def make_card_trees(base: Path, jpeg_hw=None, seed: int = 0) -> tuple:
    """(nuScenes root, Waymo root) at the sensors' sizes under `base`; the
    nuScenes sweeps sample one static street (`static_world`), the camera
    files are empty placeholders unless `jpeg_hw` is given."""
    nus = make_nuscenes_root(
        Path(base) / "nuscenes", jpeg_hw=jpeg_hw, sampler=static_world(seed), seed=seed, **NUS_CARD,
    )
    return nus, make_waymo_root(Path(base) / "waymo", seed=seed, **WAYMO_CARD)
