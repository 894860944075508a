"""Host-side (numpy) data layer of the port: dataset dispatch and a
threaded, prefetching loader.

Port of the voxel half of `taseg_tpu/data/__init__.py` (reference
`pcseg/data/__init__.py:61-182`, torch DataLoader + DistributedSampler).
`VoxelLoader` iterates `(arrays, meta)`: `arrays` holds one collated
shard (`point_coords`, `point_feats`, `labels`, `num_points`; one device
per process), `meta` a one-element list with that shard's `offsets`,
`samples` and `padded` flags, the layout of JAX's shard-indexed eval
code.  A background thread prefetches batches (double-buffered) to
overlap the host pipeline with the device, as JAX's does
(`taseg_tpu/data/__init__.py:429-457`).

The multi-scan datasets of TASeg's temporal stages are ported: FSA
(`semantickitti_ms`, `synthetic_ms`) on `MsVoxelPipeline`, SMSA
(`semantickitti_ms_ms`, the 26-class task) on the same, and mask
distillation (`semantickitti_ms_kd`, `synthetic_ms_kd`) on
`MsKdVoxelPipeline`, whose shard also carries the teacher's cloud and the
distillation pairs (`loader.teacher_capacity`, `loader.kd_max_voxel`), and
TIAF (`semantickitti_ms_mm`, `synthetic_ms_mm`) on `MsMmVoxelPipeline`,
whose shard also carries the FOV cloud (`loader.fov_capacity` rows), its
pixel coordinates and the camera images with their targets.
The range view (`MODALITY: range`, SalsaNext, FIDNet, CENet, RangeNet)
runs on `RangeViewPipeline`: its shard holds the (B, H, W, 6) images,
their labels and masks and each point's pixel and range; in training
each scan's mixes draw their second scan from the loader's generator,
as JAX's `_make_batch` does.
nuScenes (`nuscenes`, its TLAD `nuscenes_ms` on `MsVoxelPipeline` and
its 6-camera TIAF `nuscenes_ms_mm` on `MsMmVoxelPipeline`) and Waymo
(`waymo`) read the info-pickle and per-frame `.npy` layouts
(`data/nuscenes`, `data/waymo`).
"""

from __future__ import annotations

import copy
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from .augment import AugParams
from .cylinder_dataset import CylinderPipeline, grid_from_cfg
from .fusion_dataset import FusionPipeline
from .nuscenes.reader import NuscenesMsReader, NuscenesReader
from .range_dataset import RangeViewPipeline
from .semantickitti.reader import SemanticKittiReader
from .semantickitti.reader_ms import MsKdKittiReader, MultiScanKittiReader, SmsaKittiReader
from .synthetic import SyntheticKittiReader, SyntheticMsKittiReader, SyntheticTiafReader
from .voxel_dataset import MsKdVoxelPipeline, MsVoxelPipeline, VoxelPipeline
from .voxel_mm import MsMmVoxelPipeline
from .waymo.reader import WaymoReader


def build_reader(data_cfgs, training: bool):
    dataset = data_cfgs.get("DATASET", "synthetic")
    # reference DATA.TRAINVAL: the submission recipe trains on train+val
    train_split = (
        "train_val" if data_cfgs.get("TRAINVAL", False) else "train"
    )
    # DATA.EVAL_SPLIT ('val'|'test') + DATA.SEQUENCES drive the benchmark
    # submission workflow (reference --seq per-sequence test-split TTA,
    # train.py:75-76, semantickitti_ms.py:284-290)
    eval_split = str(data_cfgs.get("EVAL_SPLIT", "val"))
    eval_seqs = data_cfgs.get("SEQUENCES", None)
    if dataset in ("semantickitti", "scribblekitti"):
        return SemanticKittiReader(
            data_cfgs["DATA_PATH"],
            split=train_split if training else eval_split,
            sequences=None if training else eval_seqs,
            split_file=data_cfgs.get("SPLIT_FILE") if training else None,
            augment=data_cfgs.get("AUGMENT", "GlobalAugment"),
            samples_per_epoch=data_cfgs.get("SAMPLES_PER_EPOCH", -1),
            if_scribble=(dataset == "scribblekitti"),
        )
    if dataset in ("semantickitti_ms", "semantickitti_ms_kd", "semantickitti_ms_ms"):
        # the KD and SMSA readers run without the mixing augmentations, as
        # in JAX (data/__init__.py:74-125)
        cls = {
            "semantickitti_ms": MultiScanKittiReader,
            "semantickitti_ms_kd": MsKdKittiReader,
            "semantickitti_ms_ms": SmsaKittiReader,
        }[dataset]
        kw = {"multiscan_labels": True} if dataset == "semantickitti_ms_ms" else {}
        return cls(
            data_cfgs["DATA_PATH"],
            split=train_split if training else eval_split,
            sequences=None if training else eval_seqs,
            split_file=data_cfgs.get("SPLIT_FILE") if training else None,
            augment=(
                data_cfgs.get("AUGMENT", "GlobalAugment")
                if dataset == "semantickitti_ms" else "NoAug"
            ),
            samples_per_epoch=data_cfgs.get("SAMPLES_PER_EPOCH", -1),
            multiscan=data_cfgs.get("MULTISCAN", 16),
            only_history=data_cfgs.get("ONLY_HISTORY", True),
            flexible_steps=data_cfgs.get("FLEXIBLE_STEPS", None),
            pseudo_mask=data_cfgs.get("PSEUDO_MASK", "gt"),
            pseudo_label_root=data_cfgs.get("PSEUDO_LABEL_ROOT", None),
            **kw,
        )
    if dataset == "semantickitti_ms_mm":
        from .semantickitti.reader_mm import TiafKittiReader

        return TiafKittiReader(
            data_cfgs["DATA_PATH"],
            split=train_split if training else eval_split,
            sequences=None if training else eval_seqs,
            split_file=data_cfgs.get("SPLIT_FILE") if training else None,
            augment=data_cfgs.get("AUGMENT", "GlobalAugment"),
            samples_per_epoch=data_cfgs.get("SAMPLES_PER_EPOCH", -1),
            multiscan=data_cfgs.get("MULTISCAN", 16),
            only_history=data_cfgs.get("ONLY_HISTORY", True),
            flexible_steps=data_cfgs.get("FLEXIBLE_STEPS", None),
            pseudo_mask=data_cfgs.get("PSEUDO_MASK", "gt"),
            pseudo_label_root=data_cfgs.get("PSEUDO_LABEL_ROOT", None),
            multiscan_image=data_cfgs.get("MULTISCAN_IMAGE", 48),
            step_image=data_cfgs.get("STEP_IMAGE", 12),
            image_height=data_cfgs.get("IMAGE_HEIGHT", 384),
            image_width=data_cfgs.get("IMAGE_WIDTH", 1280),
            semantic_map_root=data_cfgs.get("SEMANTIC_MAP_ROOT", None),
        )
    if dataset == "nuscenes":
        return NuscenesReader(
            data_cfgs["DATA_PATH"],
            split=train_split if training else eval_split,
            samples_per_epoch=data_cfgs.get("SAMPLES_PER_EPOCH", -1),
        )
    if dataset in ("nuscenes_ms", "nuscenes_ms_mm"):
        kw = dict(
            split=train_split if training else eval_split,
            samples_per_epoch=data_cfgs.get("SAMPLES_PER_EPOCH", -1),
            multiscan=data_cfgs.get("MULTISCAN", 15),
            step=data_cfgs.get("STEP", 1.0),
            flexible_steps=data_cfgs.get("FLEXIBLE_STEPS", None),
            pseudo_label_root=data_cfgs.get("PSEUDO_LABEL_ROOT", None),
        )
        if dataset == "nuscenes_ms":
            return NuscenesMsReader(data_cfgs["DATA_PATH"], **kw)
        from .nuscenes.reader_mm import NuscenesTiafReader

        return NuscenesTiafReader(
            data_cfgs["DATA_PATH"], **kw,
            multiscan_image=data_cfgs.get("MULTISCAN_IMAGE", 0),
            step_image=data_cfgs.get("STEP_IMAGE", 7),
            image_height=data_cfgs.get("IMAGE_HEIGHT", 448),
            image_width=data_cfgs.get("IMAGE_WIDTH", 800),
        )
    if dataset == "waymo":
        return WaymoReader(
            data_cfgs["DATA_PATH"],
            split=train_split if training else eval_split,
            samples_per_epoch=data_cfgs.get("SAMPLES_PER_EPOCH", -1),
        )
    if dataset == "synthetic":
        return SyntheticKittiReader(
            length=data_cfgs.get("LENGTH", 64),
            n_points=data_cfgs.get("N_RAW_POINTS", 120_000),
            seed=0 if training else 1,
        )
    if dataset in ("synthetic_ms", "synthetic_ms_kd"):
        return SyntheticMsKittiReader(
            length=data_cfgs.get("LENGTH", 16),
            n_points=data_cfgs.get("N_RAW_POINTS", 60_000),
            seed=0 if training else 1,
            kd=dataset == "synthetic_ms_kd",
        )
    if dataset == "synthetic_ms_mm":
        return SyntheticTiafReader(
            length=data_cfgs.get("LENGTH", 16),
            n_points=data_cfgs.get("N_RAW_POINTS", 60_000),
            seed=0 if training else 1,
            n_images=data_cfgs.get("N_IMAGES", 2),
            img_h=data_cfgs.get("IMG_H", 32),
            img_w=data_cfgs.get("IMG_W", 64),
        )
    raise NotImplementedError(f"dataset {dataset!r}")


_LABEL_FIELDS = ("labels", "raw_labels", "label", "point_labels", "image_labels")
# the sub-samples of a multi-scan (frame, fused), a KD (student, teacher)
# and a TIAF (main, fov) sample, and a fused sample's back-reference to
# its pair
_NESTED_FIELDS = ("frame", "fused", "student", "teacher", "main", "fov", "ms_pair")


def _as_padding(sample, _memo=None):
    """Shallow-copy a sample with every label array zeroed (train id 0 is
    the ignore class), its nested samples too, so padded repeats of the
    final partial batch add nothing to confusion histograms.
    `evaluate_points` additionally skips them via meta['padded'], keeping
    n_scans == len(dataset) — the reference pads its eval sampler to world
    size and merges back to exactly len(dataset) results
    (`pcseg/data/__init__.py:38-58`, `common_utils.py:200-221`)."""
    _memo = {} if _memo is None else _memo
    if id(sample) in _memo:  # ms_pair back-references form cycles
        return _memo[id(sample)]
    s = copy.copy(sample)
    _memo[id(sample)] = s
    for f in _LABEL_FIELDS:
        v = getattr(s, f, None)
        if isinstance(v, np.ndarray):
            setattr(s, f, np.zeros_like(v))
    for f in _NESTED_FIELDS:
        v = getattr(s, f, None)
        if v is not None and not isinstance(v, np.ndarray):
            setattr(s, f, _as_padding(v, _memo))
    return s


class VoxelLoader:
    """Iterates (arrays dict of one shard, [shard metadata])."""

    def __init__(
        self,
        reader,
        pipeline: VoxelPipeline,
        *,
        n_shards: int = 1,
        scans_per_shard: int,
        point_capacity: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
        process_index: int = 0,
        process_count: int = 1,
    ):
        """One shard per process (one device each).  On several
        processes, every process builds the same global epoch order
        (same seed) and takes its own contiguous slice of each global
        batch — the reference's DistributedSampler semantics
        (`pcseg/data/__init__.py:134-141`) without any communication."""
        if n_shards != 1:
            raise ValueError(
                f"n_shards={n_shards}: the port runs one device per process; "
                f"several cards run one process each (process_index, "
                f"process_count; the CLI's --distributed)"
            )
        self.reader = reader
        self.pipeline = pipeline
        self.n_shards = n_shards
        self.scans_per_shard = scans_per_shard
        self.point_capacity = point_capacity
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.rng = np.random.default_rng(seed)
        self.epoch = 0
        # KD-stage extras (set by build_dataloader for the kd pipeline)
        self.teacher_capacity = None
        self.kd_max_voxel = 3000
        # TIAF extra (set by build_dataloader for the mm pipeline)
        self.fov_capacity = None
        # when set, every sample is transformed with this exact AugParams —
        # the deterministic TTA-vote path (reference
        # semantickitti_voxel.py:101-117)
        self.fixed_aug = None

    @property
    def scans_per_batch(self) -> int:
        """Process-LOCAL scans per step (local shards x scans/shard)."""
        return self.n_shards * self.scans_per_shard

    @property
    def global_scans_per_batch(self) -> int:
        return self.scans_per_batch * self.process_count

    def __len__(self) -> int:
        g = self.global_scans_per_batch
        n = len(self.reader) // g
        if not self.drop_last and len(self.reader) % g:
            n += 1
        return n

    def _epoch_order(self):
        order = np.arange(len(self.reader))
        if self.shuffle:
            self.rng.shuffle(order)
        return order

    def _local_slice(self, global_idxs):
        """This process's contiguous slice of one global batch.  Returns
        (idxs, n_real): `idxs` always holds scans_per_batch entries —
        positions >= n_real are borrowed padding sources whose labels get
        zeroed (every process must emit a batch each step even when the
        final partial global batch leaves it empty)."""
        l = self.scans_per_batch
        lo = self.process_index * l
        local = list(global_idxs[lo: lo + l])
        n_real = len(local)
        src = list(global_idxs) or [0]
        while len(local) < l:
            local.append(src[len(local) % len(src)])
        return local, n_real

    def _pad_and_shard(self, samples, n_real):
        """Pad to the local batch size with repeats, convert every
        position >= n_real into a label-zeroed padding sample, split into
        per-shard lists."""
        while len(samples) < self.scans_per_batch:
            samples.append(samples[len(samples) % max(n_real, 1)])
        samples = [
            s if i < n_real else _as_padding(s)
            for i, s in enumerate(samples)
        ]
        return [
            samples[r * self.scans_per_shard: (r + 1) * self.scans_per_shard]
            for r in range(self.n_shards)
        ]

    def _mark_padding(self, out, n_real):
        """meta[r]['padded'][b] is True for repeated padding samples."""
        arrays, meta = out
        for r, m in enumerate(meta):
            base = r * self.scans_per_shard
            m["padded"] = [
                base + b >= n_real for b in range(len(m["samples"]))
            ]
        return arrays, meta

    def _make_batch(self, idxs, n_real=None):
        n_real = len(idxs) if n_real is None else n_real
        if isinstance(self.pipeline, RangeViewPipeline):
            # the mixes' second scan, drawn from the loader's generator in
            # training (JAX data/__init__.py:346-359)
            samples = []
            for i in idxs:
                other = (
                    self.reader[int(self.rng.integers(0, len(self.reader)))]
                    if self.pipeline.training else None
                )
                samples.append(self.pipeline(self.reader[int(i)], other))
            (shard,) = self._pad_and_shard(samples, n_real)
            c = self.pipeline.collate(shard)
            meta = [{"offsets": c.pop("offsets"), "samples": c.pop("samples")}]
            return self._mark_padding((c, meta), n_real)
        samples = [
            self.pipeline(self.reader[int(i)], aug=self.fixed_aug)
            for i in idxs
        ]
        (shard,) = self._pad_and_shard(samples, n_real)
        if isinstance(self.pipeline, MsKdVoxelPipeline):
            c = self.pipeline.collate(
                shard, self.point_capacity, self.teacher_capacity, self.kd_max_voxel
            )
        elif isinstance(self.pipeline, MsMmVoxelPipeline):
            c = self.pipeline.collate(shard, self.point_capacity, self.fov_capacity)
        else:
            c = self.pipeline.collate(shard, self.point_capacity)
        meta = [{"offsets": c.pop("offsets"), "samples": c.pop("samples")}]
        return self._mark_padding((c, meta), n_real)

    def iter_tta(self, votes: int, rng_seed: int = 0):
        """Deterministic TTA iteration (public API): yields, per scan-batch,
        the list of `votes` collated (arrays, meta) pairs, one per
        deterministic rotation vote (reference seg_utils.py:58-61 table,
        semantickitti_voxel.py:101-117 fixed-transform path).  Ordering is
        the unshuffled reader order; pipeline augmentation state is
        restored afterwards."""
        was_training = self.pipeline.training
        self.pipeline.training = False
        base_rng = np.random.default_rng(rng_seed)
        tables = [AugParams.tta_vote(v, rng=base_rng) for v in range(votes)]
        order = np.arange(len(self.reader))
        g = self.global_scans_per_batch
        try:
            for step in range(len(self)):
                idxs, n_real = self._local_slice(
                    order[step * g: (step + 1) * g]
                )
                per_vote = []
                for aug in tables:
                    self.fixed_aug = aug
                    per_vote.append(self._make_batch(idxs, n_real))
                yield per_vote
        finally:
            self.fixed_aug = None
            self.pipeline.training = was_training

    def __iter__(self) -> Iterator:
        order = self._epoch_order()
        g = self.global_scans_per_batch
        steps = len(self)
        work = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                for s in range(steps):
                    idxs, n_real = self._local_slice(
                        order[s * g: (s + 1) * g]
                    )
                    work.put(self._make_batch(idxs, n_real))
            except Exception as e:  # surface worker errors to the consumer
                work.put(e)
            finally:
                work.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = work.get()
            if item is sentinel:
                break
            if isinstance(item, Exception):
                raise item
            yield item
        self.epoch += 1
        if hasattr(self.reader, "resample"):
            self.reader.resample()




def feature_columns(data_cfgs) -> int:
    """The reader columns the loader's voxel-family pipelines keep on a
    dataset (`build_dataloader`, as JAX `data/__init__.py:546-553`):
    DATA.IN_FEATURE_DIM (5) on the multi-scan datasets (`_ms`, `_ms_kd`,
    `_ms_mm`), 4 (xyz and intensity) on the others, whatever the model's
    IN_FEATURE_DIM.  JAX's `init` takes the stem's width from them, so
    `models.build_segmentor` builds no wider a stem."""
    dataset = str(data_cfgs.get("DATASET", "synthetic"))
    if dataset.endswith(("_ms", "_ms_kd", "_ms_mm")):
        return int(data_cfgs.get("IN_FEATURE_DIM", 5))
    return 4


def build_dataloader(
    data_cfgs,
    *,
    training: bool,
    n_shards: int = 1,
    scans_per_shard: int,
    point_capacity: Optional[int] = None,
    modality: str = "voxel",
    pipeline_kind: Optional[str] = None,
    process_index: int = 0,
    process_count: int = 1,
) -> VoxelLoader:
    """The `range` pipeline (the range view: DATA.H x DATA.W images,
    64 x 2048 by default, the mixes' flags DATA.IF_RANGE_SHIFT / _MIX /
    _PASTE / _UNION read as truthy flags, point capacity 0, as JAX
    :492-507), the `voxel` pipeline, the `fusion` one (RPVNet: the voxel sample,
    the DATA.H x DATA.W range image and the voxels' pixel coordinates),
    the `cylinder` one (Cylinder_TS: the polar grid DATA.GRID_SIZE, else
    CYLINDER_GRID_SIZE, else 480 x 360 x 32, with JAX's default
    augmentation flags, as JAX builds it), the `kd` one (a `_ms_kd`
    dataset) or the `mm` one (TIAF, a `_ms_mm` dataset), over
    `build_reader`'s reader (JAX `data/__init__.py:462`).
    On the `voxel` kind a dataset whose name ends in `_ms` takes the
    multi-scan pipeline, and the multi-scan pipelines read
    DATA.IN_FEATURE_DIM (5) features; the `kd` loader's teacher capacity
    is DATA.TEACHER_NUM_POINTS (default the point capacity) and its pairs
    per scan DATA.MAX_VOXEL (3000), as in JAX (:546-590); the `mm`
    loader's FOV capacity is DATA.FOV_NUM_POINTS, else half the point
    capacity (JAX :589).  The point capacity defaults to JAX's,
    DATA.NUM_POINTS x scans_per_shard."""
    if pipeline_kind is None:
        dataset_name = str(data_cfgs.get("DATASET", "synthetic"))
        if modality in ("range", "cylinder"):
            pipeline_kind = modality
        elif dataset_name.endswith("_ms_kd"):
            pipeline_kind = "kd"
        elif dataset_name.endswith("_ms_mm"):
            pipeline_kind = "mm"
        else:
            pipeline_kind = "voxel"
    if pipeline_kind not in ("voxel", "fusion", "cylinder", "kd", "mm", "range"):
        raise NotImplementedError(f"pipeline kind {pipeline_kind!r}")
    reader = build_reader(data_cfgs, training)
    shard = dict(
        n_shards=n_shards, scans_per_shard=scans_per_shard, shuffle=training,
        drop_last=training, process_index=process_index, process_count=process_count,
    )
    if pipeline_kind == "range":
        pipeline = RangeViewPipeline.from_cfg(data_cfgs, training)
        return VoxelLoader(reader, pipeline, point_capacity=0, **shard)
    kw = dict(
        voxel_size=data_cfgs.get("VOXEL_SIZE", 0.05),
        training=training,
        if_flip=data_cfgs.get("FLIP_AUG", True),
        if_scale=data_cfgs.get("SCALE_AUG", True),
        scale_range=tuple(data_cfgs.get("SCALE_AUG_RANGE", (0.9, 1.1))),
        if_jitter=data_cfgs.get("TRANSFORM_AUG", True),
        if_rotate=data_cfgs.get("ROTATE_AUG", True),
    )
    is_ms = str(data_cfgs.get("DATASET", "synthetic")).endswith("_ms")
    if is_ms or pipeline_kind in ("kd", "mm"):
        kw["in_feature_dim"] = data_cfgs.get("IN_FEATURE_DIM", 5)
    if pipeline_kind == "fusion":
        pipeline = FusionPipeline(h=data_cfgs.get("H", 64), w=data_cfgs.get("W", 2048), **kw)
    elif pipeline_kind == "cylinder":
        pipeline = CylinderPipeline(grid=grid_from_cfg(data_cfgs), training=training)
    elif pipeline_kind == "kd":
        pipeline = MsKdVoxelPipeline(max_voxel=int(data_cfgs.get("MAX_VOXEL", 3000)), **kw)
    elif pipeline_kind == "mm":
        pipeline = MsMmVoxelPipeline(**kw)
    elif is_ms:
        pipeline = MsVoxelPipeline(**kw)
    else:
        pipeline = VoxelPipeline(**kw)
    cap = point_capacity or int(
        data_cfgs.get("NUM_POINTS", 80_000) * scans_per_shard
    )
    loader = VoxelLoader(reader, pipeline, point_capacity=cap, **shard)
    if pipeline_kind == "kd":
        loader.teacher_capacity = int(data_cfgs.get("TEACHER_NUM_POINTS", cap))
        loader.kd_max_voxel = int(data_cfgs.get("MAX_VOXEL", 3000))
    if pipeline_kind == "mm":
        loader.fov_capacity = int(data_cfgs.get("FOV_NUM_POINTS", cap // 2))
    return loader
