"""nuScenes lidarseg readers — devkit-free, info-pkl driven; copy of
`taseg_tpu/data/nuscenes/reader.py`.

Capability match of the reference nuScenes data path
(`pcseg/data/dataset/nuscenes/nuscenes.py:15-167`, `nuscenes_ms.py:226-373`)
without the nuscenes-devkit / pyquaternion dependencies: quaternions are
expanded with a local helper, and the keyframe / sweep metadata comes
entirely from the info pickles (`nuscenes_infos_{split}.pkl` with
`infos`, and `nuscenes_infos_{split}_sweep.pkl` with `infos_sweep` /
`global_indexes` / `local_indexes` / `scene_tokens`).  Label files are
located via a `lidarseg_path` info field when present, falling back to
the standard `lidarseg/<version>/<token>_lidarseg.bin` layout.

The TLAD variant implements the reference's *distance-based* sweep
selection: walk back through sweeps accumulating ego displacement and keep
one sweep per STEP meters up to MULTISCAN rings, caching the selection per
sample token; ego-box points are removed and a per-sweep time-lag channel
replaces channel 4 (nuscenes_ms.py:238-320).  Every generator draws in
JAX's order, so the same tree and seed give the same arrays.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ...utils import storage
from .labels import CLASS_NAMES, remap_labels


def quaternion_matrix(q) -> np.ndarray:
    """(w, x, y, z) -> 3x3 rotation matrix (pyquaternion replacement)."""
    w, x, y, z = [float(v) for v in q]
    n = (w * w + x * x + y * y + z * z) ** 0.5
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def transform_between(info0: dict, info: dict) -> tuple[np.ndarray, np.ndarray]:
    """(R, T) such that p0 = p @ R + T maps `info` lidar points into
    `info0`'s lidar frame via ego/global chains (reference
    nuscenes_ms.py:352-373)."""
    l2e_r = quaternion_matrix(info0["lidar2ego_rotation"])
    e2g_r = quaternion_matrix(info0["ego2global_rotation"])
    l2e_t = np.asarray(info0["lidar2ego_translation"])
    e2g_t = np.asarray(info0["ego2global_translation"])

    l2e_r_s = quaternion_matrix(info["lidar2ego_rotation"])
    e2g_r_s = quaternion_matrix(info["ego2global_rotation"])
    l2e_t_s = np.asarray(info["lidar2ego_translation"])
    e2g_t_s = np.asarray(info["ego2global_translation"])

    inv = np.linalg.inv(e2g_r).T @ np.linalg.inv(l2e_r).T
    r = (l2e_r_s.T @ e2g_r_s.T) @ inv
    t = (l2e_t_s @ e2g_r_s.T + e2g_t_s) @ inv
    t = t - (e2g_t @ inv + l2e_t @ np.linalg.inv(l2e_r).T)
    return r, t


def ego_box_mask(pts: np.ndarray) -> np.ndarray:
    """The points outside the ego vehicle's box (|x| < 1 m, |y| < 1.5 m),
    which the multi-sweep readers drop (nuscenes_ms.py:288-290)."""
    return ~((np.abs(pts[:, 0]) < 1.0) & (np.abs(pts[:, 1]) < 1.5))


class NuscenesReader:
    """Single-keyframe lidarseg reader.

    Yields {'xyzret' (N, 5: xyz intensity ring), 'labels' (N,) train
    ids, 'path', 'token'} — the SemanticKITTI readers' contract, so the
    voxel pipelines apply unchanged; the token names the scan's
    submission file."""

    def __init__(
        self,
        root_path: str,
        *,
        split: str = "train",
        info_path: str | None = None,
        samples_per_epoch: int = -1,
        seed: int = 0,
    ):
        self.root_path = Path(root_path)
        self.split = split
        self.class_names = CLASS_NAMES
        self.rng = np.random.default_rng(seed)
        if info_path is not None:
            info_paths = [info_path]
        elif split == "train_val":
            # TRAINVAL: the info generation writes one pickle a split, so
            # train + val are concatenated
            info_paths = ["nuscenes_infos_train.pkl", "nuscenes_infos_val.pkl"]
        else:
            info_paths = [f"nuscenes_infos_{split}.pkl"]
        self.infos = []
        for ip in info_paths:
            self.infos.extend(storage.load_pkl(self.root_path / ip)["infos"])
        self._all_idx = np.arange(len(self.infos))
        self.samples_per_epoch = (
            samples_per_epoch
            if samples_per_epoch > 0 and split.startswith("train")
            else len(self.infos)
        )
        self.resample()

    def __len__(self):
        return len(self.sample_idx)

    def resample(self):
        if self.samples_per_epoch != len(self.infos):
            self.sample_idx = self.rng.choice(self._all_idx, self.samples_per_epoch)
        else:
            self.sample_idx = self._all_idx

    def _rel(self, path: str) -> Path:
        """An info's path under the root: an absolute path is re-anchored
        at its `samples` / `sweeps` part (the reference strips a 16-char
        absolute prefix, nuscenes_ms.py:285)."""
        p = Path(path)
        if p.is_absolute():
            for anchor in ("samples", "sweeps"):
                if anchor in p.parts:
                    return self.root_path / Path(*p.parts[p.parts.index(anchor):])
        return self.root_path / p

    def load_points(self, info: dict) -> np.ndarray:
        return storage.load_bin(self._rel(info["lidar_path"]), "float32").reshape(-1, 5)

    def load_labels(self, info: dict, n: int) -> np.ndarray:
        if "lidarseg_path" in info:
            p = self._rel(info["lidarseg_path"])
        else:
            token = info.get("lidar_token", info.get("token"))
            p = self.root_path / "lidarseg" / "v1.0-trainval" / f"{token}_lidarseg.bin"
        if not storage.exists(p):
            return np.zeros(n, np.int32)  # test split: no labels
        return remap_labels(storage.load_bin(p, "uint8")).astype(np.int32)

    def __getitem__(self, index: int) -> dict:
        info = self.infos[self.sample_idx[index]]
        pts = self.load_points(info)
        labels = self.load_labels(info, len(pts))
        return {
            "xyzret": pts.astype(np.float32),
            "labels": labels,
            "path": str(info.get("lidar_path", index)),
            "token": str(info.get("lidar_token", info.get("token", index))),
        }


class NuscenesMsReader(NuscenesReader):
    """TLAD reader: distance-based sweep aggregation with per-class
    flexible steps over pseudo labels.  Yields the keyframe's points and
    labels (`xyzret`, `labels`, ego box removed, time lag 0) and the fused
    cloud (`xyzret_ms`, `labels_ms`: the keyframe first, then the
    selected sweeps, each with its time lag in column 4)."""

    def __init__(
        self,
        root_path: str,
        *,
        multiscan: int = 15,
        step: float = 1.0,
        flexible_steps=None,
        pseudo_label_root: str | None = None,
        sweep_info_path: str | None = None,
        **kw,
    ):
        super().__init__(root_path, **kw)
        self.multiscan = multiscan
        self.step = step
        self.flexible_steps = list(flexible_steps) if flexible_steps is not None else [1] * 17
        self.pseudo_label_root = pseudo_label_root
        sweep_info_path = sweep_info_path or f"nuscenes_infos_{self.split}_sweep.pkl"
        sweep = storage.load_pkl(self.root_path / sweep_info_path)
        self.infos_sweep = sweep["infos_sweep"]
        self.global_indexes = sweep["global_indexes"]
        self.local_indexes = sweep["local_indexes"]
        self.scene_tokens = sweep["scene_tokens"]
        self._sample_list_cache: dict = {}

    def _select_sweeps(self, index: int) -> list[int]:
        """Pick ~one sweep per `step` meters of ego displacement, up to
        `multiscan` rings, and every keyframe inside the window
        (reference nuscenes_ms.py:238-276); cached per keyframe."""
        gi = self.global_indexes[index]
        if gi in self._sample_list_cache:
            return self._sample_list_cache[gi]
        info0 = self.infos_sweep[gi]
        scene0 = self.scene_tokens[gi]

        deltas, dists = [], []
        delta = 0
        while not dists or dists[-1] <= self.multiscan * self.step:
            delta -= 1
            if gi + delta < 0:
                break
            info = self.infos_sweep[gi + delta]
            if self.scene_tokens[gi + delta] != scene0:
                break
            origin = np.zeros((1, 5))
            if "data_path" in info:
                origin[:, :3] = origin[:, :3] @ np.asarray(info["sensor2lidar_rotation"]).T
                origin[:, :3] += np.asarray(info["sensor2lidar_translation"])
            if self.local_indexes[gi + delta] != index:
                father = self.infos[self.local_indexes[gi + delta]]
                r, t = transform_between(info0, father)
                origin[:, :3] = origin[:, :3] @ r + t
            deltas.append(delta)
            dists.append(float(np.linalg.norm(origin[0, :2])))

        picked = []
        ring = 1
        for i in range(len(deltas)):
            nxt = dists[i + 1] if i + 1 < len(dists) else float("inf")
            if dists[i] - ring * self.step > 0 or (
                dists[i] < nxt and abs(dists[i] - ring * self.step) < abs(nxt - ring * self.step)
            ):
                picked.append(deltas[i])
                ring += 1
            if ring > self.multiscan:
                break
        # the keyframes inside the window (they carry labels)
        for d in deltas:
            if "lidar_path" in self.infos_sweep[gi + d]:
                picked.append(d)
        picked = sorted(set(picked))
        self._sample_list_cache[gi] = picked
        return picked

    def _pseudo(self, token: str, n: int) -> np.ndarray:
        if not self.pseudo_label_root:
            return np.zeros(n, np.int32)
        p = Path(self.pseudo_label_root) / f"{token}_lidarseg.bin"
        if not storage.exists(p):
            return np.zeros(n, np.int32)
        return storage.load_bin(p, "uint8").astype(np.int32)

    def multiscan_fuse(self, index: int):
        """The selected sweeps' points in the keyframe's lidar frame and
        their labels (a sweep's 0), ego box removed, time lag in column
        4, each kept where its pseudo class's flexible step divides its
        order (every point without PSEUDO_LABEL_ROOT)."""
        gi = self.global_indexes[index]
        info0 = self.infos_sweep[gi]
        pts_list, lbl_list = [], []
        for order, delta in enumerate(self._select_sweeps(index)):
            info = self.infos_sweep[gi + delta]
            if "lidar_path" in info:
                pts = storage.load_bin(self._rel(info["lidar_path"]), "float32").reshape(-1, 5)
                labels = self.load_labels(info, len(pts))
                r, t = transform_between(info0, info)
                pts[:, :3] = pts[:, :3] @ r + t
            else:
                pts = storage.load_bin(self._rel(info["data_path"]), "float32").reshape(-1, 5)
                pts[:, :3] = pts[:, :3] @ np.asarray(info["sensor2lidar_rotation"]).T + np.asarray(
                    info["sensor2lidar_translation"]
                )
                if self.local_indexes[gi + delta] != index:
                    father = self.infos[self.local_indexes[gi + delta]]
                    r, t = transform_between(info0, father)
                    pts[:, :3] = pts[:, :3] @ r + t
                labels = np.zeros(len(pts), np.int32)
            # ego-box removal + time-lag channel (nuscenes_ms.py:288-306)
            no_ego = ego_box_mask(pts)
            pts = pts[no_ego]
            labels = labels[no_ego]
            pts[:, 4] = info0["timestamp"] / 1e6 - info["timestamp"] / 1e6

            token = info.get("sample_data_token", info.get("token", ""))
            pseudo = self._pseudo(token, len(pts) + int((~no_ego).sum()))
            if len(pseudo) == len(no_ego):
                pseudo = pseudo[no_ego]
            keep = np.zeros(len(pts), bool)
            for cls, st in enumerate(self.flexible_steps):
                if st == 0 or (order + 1) % st != 0:
                    continue
                keep |= pseudo[: len(pts)] == cls
            if not self.pseudo_label_root:
                keep[:] = True  # no pseudo masks configured: keep all
            pts_list.append(pts[keep])
            lbl_list.append(labels[keep])
        if not pts_list:
            return np.zeros((0, 5), np.float32), np.zeros((0,), np.int32)
        return (
            np.concatenate(pts_list).astype(np.float32),
            np.concatenate(lbl_list).astype(np.int32),
        )

    def __getitem__(self, index: int) -> dict:
        i = self.sample_idx[index]
        info = self.infos[i]
        pts = self.load_points(info)
        no_ego = ego_box_mask(pts)
        pts = pts[no_ego]
        labels = self.load_labels(info, len(pts))
        if len(labels) == len(no_ego):
            labels = labels[no_ego]
        pts[:, 4] = 0.0  # keyframe time lag

        hist_pts, hist_labels = self.multiscan_fuse(i)
        return {
            "xyzret": pts.astype(np.float32),
            "labels": labels.astype(np.int32),
            "xyzret_ms": np.concatenate([pts, hist_pts]).astype(np.float32),
            "labels_ms": np.concatenate([labels, hist_labels]).astype(np.int32),
            "path": str(info.get("lidar_path", i)),
            "token": str(info.get("sample_data_token", info.get("token", i))),
        }
