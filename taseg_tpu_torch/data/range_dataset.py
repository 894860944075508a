"""Range-view host pipeline and its augmentations (port of
`taseg_tpu/data/range_dataset.py`; reference `semantickitti_rv.py:15-360`).

Each scan is projected spherically (`laserscan.project_scan`) into a
6-channel image [x/50, y/50, z/3, intensity, range/80, mask] with
per-pixel train-id labels and the occupancy mask; each point keeps its
pixel (`proj_x`, `proj_y`) and its range for the KNN clean-up.  In
training, as in JAX:

  * RangeShift: a circular column roll at a random split;
  * RangeMix: alternating cells of a (rows, cols) grid swapped with a
    second scan (`RANGE_MIX_GRIDS`, the MixTeacher grid), one of the two
    complements kept at random;
  * RangePaste: the rare classes' pixels of the second scan pasted in;
  * RangeUnion: the empty pixels filled from the second scan;

each taken with probability 0.5 where its flag is set (a truthy flag: the
recipes' 0.9 is a flag, as JAX reads it), drawing from the pipeline's own
numpy generator in JAX's order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .semantickitti.laserscan import project_labels, project_scan

# rare / thing classes of RangePaste (train ids; reference rv.py:215-280)
RANGE_PASTE_CLASSES = (2, 3, 4, 5, 6, 7, 8, 12, 16, 18, 19)
# the MixTeacher 'mixtureV2' grids, (rows, cols) (reference
# semantickitti_rv.py:388)
RANGE_MIX_GRIDS = (
    (3, 1), (4, 1), (5, 1), (6, 1),
    (3, 2), (4, 2), (5, 2), (6, 2),
    (3, 3), (4, 3), (5, 3), (6, 3),
    (3, 4), (4, 4), (5, 4), (6, 4),
    (4, 6),
)


def range_shift(scan, label, mask, split: int):
    roll = lambda a: np.concatenate([a[:, split:], a[:, :split]], axis=1)
    return roll(scan), roll(label), roll(mask)


def range_paste(scan, label, mask, scan_b, label_b, mask_b, min_pixels=20):
    out_s, out_l, out_m = scan.copy(), label.copy(), mask.copy()
    for cls in RANGE_PASTE_CLASSES:
        pix = label_b == cls
        if pix.sum() > min_pixels:
            out_s[pix] = scan_b[pix]
            out_l[pix] = label_b[pix]
            out_m[pix] = mask_b[pix]
    return out_s, out_l, out_m


def range_union(scan, label, mask, scan_b, label_b, mask_b):
    empty = mask == 0
    out_s, out_l, out_m = scan.copy(), label.copy(), mask.copy()
    out_s[empty] = scan_b[empty]
    out_l[empty] = label_b[empty]
    out_m[empty] = mask_b[empty]
    return out_s, out_l, out_m


def range_mix(scan, label, mask, scan_b, label_b, mask_b, rows: int, cols: int):
    """Both complements, (A-major, B-major), each a (scan, label, mask)
    triple: the odd cells of the (rows, cols) grid taken from the other
    scan (reference semantickitti_rv.py:368-380)."""
    h, w = label.shape
    a = (scan.copy(), label.copy(), mask.copy())
    b = (scan_b.copy(), label_b.copy(), mask_b.copy())
    src_a = (scan, label, mask)
    src_b = (scan_b, label_b, mask_b)
    r_edges = np.linspace(0, h, rows + 1).astype(int)
    c_edges = np.linspace(0, w, cols + 1).astype(int)
    for i in range(rows):
        for j in range(cols):
            if (i + j) % 2 == 1:
                rs, re = r_edges[i], r_edges[i + 1]
                cs, ce = c_edges[j], c_edges[j + 1]
                for out, src in zip(a, src_b):
                    out[rs:re, cs:ce] = src[rs:re, cs:ce]
                for out, src in zip(b, src_a):
                    out[rs:re, cs:ce] = src[rs:re, cs:ce]
    return a, b


@dataclass
class RangeSample:
    scan: np.ndarray  # (H, W, 6) float32
    label: np.ndarray  # (H, W) int32
    mask: np.ndarray  # (H, W) float32
    # per point, for the mapping back and the KNN clean-up
    proj_x: np.ndarray  # (N,) int32
    proj_y: np.ndarray  # (N,) int32
    unproj_range: np.ndarray  # (N,) float32
    point_labels: np.ndarray  # (N,) train ids
    name: str


class RangeViewPipeline:
    """Reader dict (`xyzret`, `labels`, `path`) -> `RangeSample`; in
    training with an optional second reader dict for the mixes."""

    sorted_points = False

    def __init__(
        self, h: int = 64, w: int = 2048, *, training: bool = True, fov_up: float = 3.0,
        fov_down: float = -25.0, if_shift=True, if_mix=True, if_paste=True, if_union=True,
        seed: int = 0,
    ):
        self.h, self.w = h, w
        self.fov_up, self.fov_down = fov_up, fov_down
        self.training = training
        self.if_shift, self.if_mix = if_shift, if_mix
        self.if_paste, self.if_union = if_paste, if_union
        self.rng = np.random.default_rng(seed)

    @classmethod
    def from_cfg(cls, data_cfg: dict, training: bool, seed: int = 0) -> "RangeViewPipeline":
        """The pipeline of a DATA block: DATA.H x DATA.W images (64 x
        2048 by default) and the mixes' flags (JAX data/__init__.py:494-503)."""
        return cls(
            h=data_cfg.get("H", 64), w=data_cfg.get("W", 2048), training=training, seed=seed,
            if_shift=data_cfg.get("IF_RANGE_SHIFT", True), if_mix=data_cfg.get("IF_RANGE_MIX", True),
            if_paste=data_cfg.get("IF_RANGE_PASTE", True), if_union=data_cfg.get("IF_RANGE_UNION", True),
        )

    def _project(self, sample: dict):
        pts = sample["xyzret"]
        labels = np.asarray(sample["labels"]).reshape(-1)
        proj = project_scan(
            pts[:, :3], pts[:, 3], h=self.h, w=self.w,
            fov_up_deg=self.fov_up, fov_down_deg=self.fov_down,
        )
        label_img = project_labels(proj, labels)
        scan = np.concatenate(
            [
                proj.xyz / np.array([50.0, 50.0, 3.0], np.float32),
                proj.remission[..., None],
                proj.range_img[..., None] / 80.0,
                proj.mask[..., None],
            ],
            axis=-1,
        ).astype(np.float32)
        return scan, label_img, proj

    def __call__(self, sample: dict, sample_b: dict | None = None) -> RangeSample:
        scan, label, proj = self._project(sample)
        mask = proj.mask
        if self.training:
            if self.if_shift and self.rng.random() < 0.5:
                lo = min(100, self.w // 4)
                split = int(self.rng.integers(lo, max(self.w - lo, lo + 1)))
                scan, label, mask = range_shift(scan, label, mask, split)
            if sample_b is not None and (self.if_mix or self.if_paste or self.if_union):
                scan_b, label_b, proj_b = self._project(sample_b)
                mask_b = proj_b.mask
                if self.if_mix and self.rng.random() < 0.5:
                    rows, cols = RANGE_MIX_GRIDS[self.rng.integers(0, len(RANGE_MIX_GRIDS))]
                    mix_a, mix_b = range_mix(scan, label, mask, scan_b, label_b, mask_b, rows, cols)
                    # keep one complement at random (rv.py:170-175)
                    scan, label, mask = mix_a if self.rng.random() < 0.5 else mix_b
                if self.if_paste and self.rng.random() < 0.5:
                    scan, label, mask = range_paste(scan, label, mask, scan_b, label_b, mask_b)
                if self.if_union and self.rng.random() < 0.5:
                    scan, label, mask = range_union(scan, label, mask, scan_b, label_b, mask_b)
        return RangeSample(
            scan=scan, label=label.astype(np.int32), mask=mask,
            proj_x=proj.proj_x, proj_y=proj.proj_y, unproj_range=proj.unproj_range,
            point_labels=np.asarray(sample["labels"]).reshape(-1),
            name=sample.get("path", ""),
        )

    def collate(self, samples: list) -> dict:
        """One shard (`collate_range_shard`)."""
        return collate_range_shard(samples)


def collate_range_shard(samples: list) -> dict:
    """The images of one shard stacked, (B, H, W, 6) `scan`, (B, H, W)
    `label` and `mask`, and its points concatenated scan after scan:
    `px`, `py` (int32), `unproj_range` (f32), `img` (each point's scan,
    int32), with `offsets` (B + 1,) and the `samples`."""
    counts = [len(s.proj_x) for s in samples]
    return {
        "scan": np.stack([s.scan for s in samples]),
        "label": np.stack([s.label for s in samples]),
        "mask": np.stack([s.mask for s in samples]),
        "px": np.concatenate([s.proj_x for s in samples]).astype(np.int32),
        "py": np.concatenate([s.proj_y for s in samples]).astype(np.int32),
        "unproj_range": np.concatenate([s.unproj_range for s in samples]).astype(np.float32),
        "img": np.repeat(np.arange(len(samples), dtype=np.int32), counts),
        "offsets": np.concatenate([[0], np.cumsum(counts)]).astype(np.int64),
        "samples": list(samples),
    }


def collate_range_batch(shards: list) -> tuple[dict, list]:
    """JAX's form: (R, B, H, W, C) images, (R, B, H, W) labels and masks,
    and per shard {"samples": ...}."""
    arrays = {
        k: np.stack([np.stack([getattr(s, k) for s in shard]) for shard in shards])
        for k in ("scan", "label", "mask")
    }
    return arrays, [{"samples": shard} for shard in shards]
