"""Synthetic LiDAR scenes — deterministic stand-in for SemanticKITTI.

Copy of `taseg_tpu/data/synthetic.py:1-164` (the scan generator) and of
its `SyntheticMsKittiReader` (:167), `SyntheticKittiReader` (:221-246) and
`SyntheticTiafReader` (:249), so the port needs no module of the JAX
package.  The same seed gives the same arrays in both packages.

Point clouds are generated with a *raycast beam model* (64 beams x ~2048
azimuth steps, first-hit against an analytic scene of ground plane, walls,
boxes and poles), so the density falls off with range like a real spinning
LiDAR and surfaces are coherent: voxel-occupancy statistics (per-level
unique counts, neighbor densities) match real SemanticKITTI scans closely,
which matters both for benchmark honesty and for the sparse-conv kernel's
capacity tables.  The reference has no equivalent (it assumes real data on
disk); this is part of our test pyramid (SURVEY.md §4 implications).

Class ids: 9 road (ground), 13 building (walls), 1 car (boxes),
18 pole (sticks), 15 vegetation (scatter blobs).
"""

from __future__ import annotations

import numpy as np


def _raycast_scene(rng: np.random.Generator, n_beams: int, n_az: int):
    """First-hit raycast of a rotating LiDAR against an analytic scene.

    Returns (xyz (M, 3) float32, labels (M,) int32) for rays that hit.
    """
    # sensor at origin, z=0 (i.e. 1.7 m above ground plane z=-1.7)
    elev = np.linspace(np.deg2rad(2.0), np.deg2rad(-24.8), n_beams)
    az = np.linspace(-np.pi, np.pi, n_az, endpoint=False)
    az = az + rng.uniform(0, 2 * np.pi / n_az)
    E, A = np.meshgrid(elev, az, indexing="ij")
    ce = np.cos(E)
    d = np.stack([ce * np.cos(A), ce * np.sin(A), np.sin(E)], -1).reshape(-1, 3)
    n_rays = d.shape[0]

    t_hit = np.full(n_rays, np.inf, np.float32)
    lbl = np.zeros(n_rays, np.int32)

    def consider(t, mask, label):
        m = mask & (t > 0.5) & (t < t_hit)
        t_hit[m] = t[m]
        lbl[m] = label

    # ground plane z = -1.7
    dz = d[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_g = np.where(dz < -1e-6, -1.7 / dz, np.inf)
    r_g = t_g * np.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2)
    consider(t_g.astype(np.float32), r_g < 55.0, 9)

    # 4 axis-aligned walls (building fronts) at random distances, height 7 m
    for axis in (0, 1):
        for sign in (1.0, -1.0):
            dist = rng.uniform(18, 45)
            dd = d[:, axis] * sign
            with np.errstate(divide="ignore", invalid="ignore"):
                t_w = np.where(dd > 1e-6, dist / dd, np.inf).astype(np.float32)
            p = t_w[:, None] * d
            other = 1 - axis
            ok = (
                (np.abs(p[:, other]) < 48)
                & (p[:, 2] > -1.7)
                & (p[:, 2] < 5.5)
            )
            consider(t_w, ok, 13)

    # boxes (cars): axis-aligned, 4.4 x 1.8 x 1.5 on the ground
    n_boxes = 14
    centers = rng.uniform(-28, 28, (n_boxes, 2))
    yaws = rng.uniform(0, np.pi, n_boxes)
    for b in range(n_boxes):
        cx, cy = centers[b]
        c, s = np.cos(yaws[b]), np.sin(yaws[b])
        # transform rays into box frame (rotate about z)
        ox = -(cx * c + cy * s)
        oy = -(-cx * s + cy * c)
        dxl = d[:, 0] * c + d[:, 1] * s
        dyl = -d[:, 0] * s + d[:, 1] * c
        dzl = d[:, 2]
        # slab test
        with np.errstate(divide="ignore", invalid="ignore"):
            tx1 = (-2.2 - ox) / dxl
            tx2 = (2.2 - ox) / dxl
            ty1 = (-0.9 - oy) / dyl
            ty2 = (0.9 - oy) / dyl
            tz1 = (-1.7 - 0.0) / dzl
            tz2 = (-0.2 - 0.0) / dzl
        tmin = np.maximum(
            np.maximum(np.minimum(tx1, tx2), np.minimum(ty1, ty2)),
            np.minimum(tz1, tz2),
        )
        tmax = np.minimum(
            np.minimum(np.maximum(tx1, tx2), np.maximum(ty1, ty2)),
            np.maximum(tz1, tz2),
        )
        consider(tmin.astype(np.float32), (tmax > tmin) & (tmin > 0), 1)

    # poles: vertical cylinders r=0.12, height to 4 m
    n_sticks = 18
    pole_xy = rng.uniform(-35, 35, (n_sticks, 2))
    for pxy in pole_xy:
        ox, oy = -pxy[0], -pxy[1]
        a = d[:, 0] ** 2 + d[:, 1] ** 2
        bq = 2 * (ox * d[:, 0] + oy * d[:, 1])
        cq = ox * ox + oy * oy - 0.12**2
        disc = bq * bq - 4 * a * cq
        with np.errstate(divide="ignore", invalid="ignore"):
            t_p = np.where(disc > 0, (-bq - np.sqrt(np.maximum(disc, 0))) / (2 * a), np.inf)
        z = t_p * d[:, 2]
        consider(t_p.astype(np.float32), (z > -1.7) & (z < 4.0), 18)

    # vegetation: ellipsoidal blobs that scatter (hit with probability)
    n_blobs = 12
    blob_xy = rng.uniform(-40, 40, (n_blobs, 2))
    for bxy in blob_xy:
        ox, oy, oz = -bxy[0], -bxy[1], 0.3
        rx = ry = 2.5
        rz = 2.0
        a = (d[:, 0] / rx) ** 2 + (d[:, 1] / ry) ** 2 + (d[:, 2] / rz) ** 2
        bq = 2 * (ox * d[:, 0] / rx**2 + oy * d[:, 1] / ry**2 + oz * d[:, 2] / rz**2)
        cq = (ox / rx) ** 2 + (oy / ry) ** 2 + (oz / rz) ** 2 - 1.0
        disc = bq * bq - 4 * a * cq
        with np.errstate(divide="ignore", invalid="ignore"):
            t_v = np.where(disc > 0, (-bq - np.sqrt(np.maximum(disc, 0))) / (2 * a), np.inf)
        # foliage is porous: only some rays stop, with depth jitter
        porous = rng.random(n_rays) < 0.65
        t_v = t_v * rng.uniform(1.0, 1.25, n_rays)
        consider(t_v.astype(np.float32), porous, 15)

    hit = np.isfinite(t_hit)
    t = t_hit[hit, None]
    xyz = (t * d[hit]).astype(np.float32)
    # range noise (~1.5 cm) like a real sensor
    xyz += rng.normal(0, 0.015, xyz.shape).astype(np.float32) * np.clip(
        t / 20.0, 0.5, 3.0
    )
    return xyz, lbl[hit]


def synthetic_scan(
    rng: np.random.Generator, n_points: int = 120_000, num_classes: int = 20
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (points (N, 4) float32 xyz+intensity, labels (N,) int32).

    Raycast with enough azimuth resolution to reach ~n_points, then
    resampled to exactly n_points (with replacement when short), mirroring
    how readers resample real scans to a fixed budget.
    """
    n_beams = 64
    n_az = max(256, int(n_points / n_beams * 1.35))
    xyz, lbl = _raycast_scene(rng, n_beams, n_az)
    m = len(xyz)
    if m >= n_points:
        idx = rng.choice(m, n_points, replace=False)
    else:
        idx = np.concatenate(
            [np.arange(m), rng.choice(m, n_points - m, replace=True)]
        )
    xyz, lbl = xyz[idx], lbl[idx]
    intensity = (0.05 * lbl[:, None] + rng.uniform(0, 0.2, (len(lbl), 1))).astype(
        np.float32
    )
    pts = np.concatenate([xyz, intensity], axis=1)
    perm = rng.permutation(len(pts))
    return pts[perm], lbl[perm].astype(np.int32)


class SyntheticMsKittiReader:
    """Synthetic multi-scan reader matching the TLAD/FSA reader contract
    (frame + pose-jittered history copies with the time-flag channel)."""

    def __init__(
        self, length: int = 16, n_points: int = 60_000, history: int = 3,
        seed: int = 0, kd: bool = False,
    ):
        self.length = length
        self.n_points = n_points
        self.history = history
        self.seed = seed
        self.kd = kd  # also emit a GT-mask cloud (teacher input, KD stage)
        self.class_names = [f"class_{i}" for i in range(20)]

    def __len__(self):
        return self.length

    def resample(self):
        pass

    def __getitem__(self, index: int) -> dict:
        rng = np.random.default_rng(self.seed * 99991 + index)
        pts, labels = synthetic_scan(rng, self.n_points)
        hist_parts, hist_labels = [], []
        for h in range(self.history):
            shift = rng.normal(0, 0.5, 3).astype(np.float32)
            keep = rng.random(len(pts)) < 0.3  # flexible-step style thinning
            moved = pts[keep].copy()
            moved[:, :3] += shift
            hist_parts.append(moved)
            hist_labels.append(labels[keep])
        fused = np.concatenate([pts] + hist_parts)
        fused_labels = np.concatenate([labels] + hist_labels)
        flag = np.zeros((len(fused), 1), np.float32)
        flag[: len(pts)] = 1.0
        ring = np.zeros((len(pts), 1), np.float32)
        ring_ms = np.zeros((len(fused), 1), np.float32)
        out = {
            "xyzret": np.concatenate([pts, ring], axis=1),
            "labels": labels,
            "xyzret_ms": np.concatenate([fused[:, :4], flag, ring_ms], axis=1),
            "labels_ms": fused_labels,
            "path": f"synthetic_ms/08/velodyne/{index:06d}.bin",
        }
        if self.kd:
            # GT-mask cloud: a differently-thinned fusion (teacher input)
            keep = rng.random(len(fused)) < 0.8
            keep[: len(pts)] = True
            out["xyzret_ms_gt"] = out["xyzret_ms"][keep]
            out["labels_ms_gt"] = fused_labels[keep]
        return out


class SyntheticKittiReader:
    """Reader-contract-compatible synthetic dataset (JAX
    `data/synthetic.py:221`): scan `index` is drawn from a generator
    seeded with `seed * 100_003 + index`, and carries the path of a
    SemanticKITTI sequence-08 scan, so the submission writers treat it as
    one."""

    def __init__(
        self, length: int = 64, n_points: int = 120_000, seed: int = 0
    ):
        self.length = length
        self.n_points = n_points
        self.seed = seed
        self.class_names = [f"class_{i}" for i in range(20)]

    def __len__(self) -> int:
        return self.length

    def resample(self) -> None:
        pass

    def __getitem__(self, index: int) -> dict:
        rng = np.random.default_rng(self.seed * 100_003 + index)
        pts, labels = synthetic_scan(rng, self.n_points)
        ring = np.zeros((len(pts), 1), np.float32)
        return {
            "xyzret": np.concatenate([pts, ring], axis=1),
            "labels": labels,
            "path": f"synthetic/08/velodyne/{index:06d}.bin",
        }


class SyntheticTiafReader(SyntheticMsKittiReader):
    """Synthetic TIAF reader: the multi-scan contract plus a rendered
    image window (one fake camera per aggregated frame), frustum masks and
    per-point pixel coords — the `semantickitti_ms_mm`-shaped dict the
    MsMmVoxelPipeline consumes, with no files on disk."""

    def __init__(self, *args, n_images: int = 2, img_h: int = 32,
                 img_w: int = 64, **kw):
        super().__init__(*args, **kw)
        self.n_images = n_images
        self.img_h = img_h
        self.img_w = img_w

    def __getitem__(self, index: int) -> dict:
        out = super().__getitem__(index)
        rng = np.random.default_rng(self.seed * 77791 + index)
        pts = out["xyzret_ms"][:, :3]
        h, w, n_img = self.img_h, self.img_w, self.n_images
        # simple pinhole looking down +x: u = f*(-y/x)+cx, v = f*(-z/x)+cy
        f = w / 2.0
        n = len(pts)
        fov_mask = np.zeros(n, bool)
        rowcol = np.zeros((n, 2), np.int32)
        # split history points across the image slots round-robin to mimic
        # per-frame projection
        slot = rng.integers(0, n_img, n)
        with np.errstate(divide="ignore", invalid="ignore"):
            u = f * (-pts[:, 1] / pts[:, 0]) + w / 2
            v = f * (-pts[:, 2] / pts[:, 0]) + h / 2
        ok = (pts[:, 0] > 1.0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        fov_mask[ok] = True
        rowcol[ok, 0] = v[ok].astype(np.int32) + slot[ok] * h
        rowcol[ok, 1] = u[ok].astype(np.int32)
        images = rng.uniform(0, 1, (n_img, h, w, 3)).astype(np.float32)
        image_labels = np.zeros((n_img, h, w), np.int32)
        lab = out["labels_ms"]
        for s in range(n_img):
            sel = ok & (slot == s)
            image_labels[s, rowcol[sel, 0] - s * h, rowcol[sel, 1]] = lab[sel]
        out.update(
            fov_mask=fov_mask,
            fov_rowcol=rowcol[fov_mask],
            images=images,
            image_labels=image_labels,
        )
        return out
