"""Entry points of the port: `Segmenter` (inference) and `Trainer` (the
train step and the harness around it).

`Segmenter` is the counterpart of the eval path of
`taseg_tpu/engine.py:693-747` and of what `bench.py:131-333` measures.

`Segmenter(cfg, params, device=None).predict(scans)` takes reader dicts
(`xyzret` (N, >=4) float32, `labels` (N,)) and returns, per scan, the
per-raw-point logits and labels.  A batch goes through four stages:

  1. host:     VoxelPipeline(training=False) + collate_shard (numpy); for
               RPVNet the FusionPipeline, which adds each scan's range
               image and its voxels' pixel coordinates; for Cylinder_TS
               the CylinderPipeline (polar grid, majority labels); for
               MinkUNetMs / MinkUNetMsKd (FSA) the MsVoxelPipeline over
               the fused multi-scan cloud (`xyzret_ms`, 5 features); for
               MinkUNetMsMm(Nus) (TIAF) the MsMmVoxelPipeline, which adds the
               FOV cloud, its pixel coordinates and the camera images;
  2. topology: build_unet_topology(assume_sorted_points=True), with the
               model's `point_voxel_strides` (SPVCNN's and RPVNet's point
               branch); for RPVNet also its point <-> range tables
               (`models.fusion.rpvnet.rpv_inputs`, JAX
               `parallel/fusion_step.py:_unpack`); for Cylinder_TS
               `build_cylinder_topology`; for MinkUNetMsMm(Nus) the
               `TiafInputs` (`models.voxel.minkunet_mm.tiaf_inputs`, JAX
               `parallel/tiaf.py:_unpack`): both topologies, the FOV ->
               main tables and the pixel table;
  3. forward:  the model (`models.build_segmentor` on MODEL.NAME:
               MinkUNet, SPVCNN, RPVNet, Cylinder_TS or MinkUNetMsMm(Nus)) in
               eval mode, in the compute dtype (Cylinder_TS and
               MinkUNetMsMm: f32; TIAF's logits with the replace
               ensemble);
  4. mapping:  logits[offsets[b]:offsets[b+1]][inverse_map] per scan;
               for a fused cloud only the current frame's points, the
               first `num_frame_points` (JAX engine.py:700-710).

A config of a range model (SalsaNext, FIDNet, CENet, RangeNet) gets a
`range_step.RangeSegmenter` from `Segmenter(...)` and a
`range_step.RangeTrainer` from `Trainer(...)`: images, no topology, and
K9's clean-up at the points.

`Trainer`'s evaluation runs stages 2-4 through the same functions
(`model_topology`, `eval_logits`, `point_logits`) on its own model,
switched to eval mode and back (`eval_mode`).

A level whose voxel count exceeds its capacity raises (engine.py:607
only warns; a serving path must not return degraded labels, and an
epoch must not train on them).

`Trainer` is the counterpart of one call of the JAX step
(`taseg_tpu/parallel/__init__.py:120 make_train_step`, and for
MinkUNetMsKd `parallel/kd.py:52 make_kd_train_step`, for MinkUNetMsMm
`parallel/tiaf.py:73 make_tiaf_train_step`) on one device,
wired as `taseg_tpu/engine.py:179-228` wires it, and of JAX's harness
around it (`engine.py:539-911`): epochs over a `data.VoxelLoader`,
checkpoints, voxel- and point-level evaluation, TTA votes and
submission files; see its docstring.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch

from . import parallel
from ._device import resolve_device
from .data.cylinder_dataset import CylinderPipeline, grid_from_cfg
from .data.fusion_dataset import FusionPipeline
from .data.range_dataset import RangeViewPipeline
from .data.voxel_dataset import MsKdVoxelPipeline, MsVoxelPipeline, VoxelPipeline
from .data.voxel_mm import MsMmVoxelPipeline
from .loss import Losses
from .models.fusion.rpvnet import RpvInputs, rpv_inputs
from .models.layers import seed_dropout
from .models.voxel.cylinder3d import CylinderTS, build_cylinder_topology
from .models.voxel.backbone_context import UNetCapacities, build_unet_topology, host_nonneg
from .models.voxel.minkunet_mm import TRAINABLE_PREFIXES, TiafInputs, tiaf_inputs
from .models import RANGE_SEGMENTORS, TIAF_MODELS, build_segmentor
from .optim import build_optimizer, head_parameters
from .utils import storage
from .utils.common import StepTimer, create_logger
from .utils.param_groups import frozen_parameters
from .utils.metrics import confusion_hist, format_confusion, miou_from_hist, per_class_iou
from .utils.params_from_jax import init_params_numpy, load_flax_params
from .utils.submission import (
    save_logits,
    save_nuscenes_predictions,
    save_predictions,
    write_nuscenes_submission_json,
)
from .utils.tb import MetricsWriter

# padded points per scan: 120k-point scans with ~9% headroom (bench.py);
# a recipe's MODEL.POINTS_PER_SCAN replaces it (the fused multi-scan
# clouds: 262144)
POINTS_PER_SCAN = 131072
# the models that read the fused multi-scan cloud (FSA, and KD's student)
MS_MODELS = ("MinkUNetMs", "MinkUNetMsKd")
# the arrays of a collated KD shard beside the student's and teacher's
KD_KEYS = ("kd_student_idx", "kd_teacher_idx", "kd_mask")
# the arrays of a collated TIAF shard beside the main and FOV shards
TIAF_KEYS = ("fov_rowcol", "images")
# TIAF's five loss terms, in MODEL.LOSS_WEIGHT's order (JAX
# parallel/tiaf.py:95-96)
TIAF_TERMS = ("loss_lidar", "loss_fusion", "loss_image_s", "loss_image_d", "loss_image_lidar")


def points_per_scan(cfg: dict) -> int:
    return int(cfg["MODEL"].get("POINTS_PER_SCAN", POINTS_PER_SCAN))


def fov_points(cfg: dict, point_capacity: int) -> int:
    """TIAF's FOV rows per shard: DATA.FOV_NUM_POINTS, else half the
    point capacity (JAX `data/__init__.py:589`)."""
    return int(cfg["DATA"].get("FOV_NUM_POINTS", point_capacity // 2))


def check_capacity(
    topo, caps: UNetCapacities, fov_caps: UNetCapacities = None, over_ranks: bool = False
) -> list:
    """The per-level voxel counts of a topology (a UNet topology, an
    `RpvInputs`' or a `CylTopology`; of a `TiafInputs`, the main one's,
    its FOV topology held to `fov_caps`); raises where one exceeds its
    capacity (the JAX engine only warns and drops the excess voxels).
    `over_ranks`: the counts' max over the ranks of the process group
    (JAX's pmax), so every rank checks and reports the same."""
    if isinstance(topo, RpvInputs):
        topo = topo.topo
    if isinstance(topo, TiafInputs):
        _check_levels(topo.fov_topo, fov_caps, "FOV ", over_ranks)
        topo = topo.topo
    return _check_levels(topo, caps, "", over_ranks)


def _check_levels(topo, caps: UNetCapacities, what: str, over_ranks: bool = False) -> list:
    nums = torch.stack([l.num for l in topo.levels])
    nums = (parallel.max_over_ranks(nums) if over_ranks else nums).tolist()
    for l, (n, cap) in enumerate(zip(nums, caps.voxels)):
        if n > cap:
            raise RuntimeError(
                f"{what}capacity overflow at level {l}: {n} voxels > {cap}; "
                f"raise the point capacity or lower the batch size"
            )
    return nums


# the arrays of a collated fusion shard that the device reads
FUSION_KEYS = ("range_image", "range_pxpy")


def is_range_model(model: torch.nn.Module) -> bool:
    """Whether `model` is one of the range view's 2D segmentors."""
    return isinstance(model, tuple(RANGE_SEGMENTORS.values()))


def to_device(arrays: dict, device, keys=("point_coords", "point_feats")) -> dict:
    """Add `<key>_t` device tensors of the collated numpy arrays (and of
    the range images and pixel coordinates of a fusion shard), and
    `num_points_t` (a 0-dim int32).  A KD shard's student and teacher
    shards each get theirs (the teacher's without labels), and its pair
    tables `<kd key>_t`; a TIAF shard's main and FOV shards theirs, and its
    pixel coordinates and images (and, with the labels, the image
    labels)."""
    if "student" in arrays:
        to_device(arrays["student"], device, keys)
        to_device(arrays["teacher"], device)
        for k in KD_KEYS:
            arrays[k + "_t"] = torch.from_numpy(arrays[k]).to(device)
        return arrays
    if "main" in arrays:
        to_device(arrays["main"], device, keys)
        to_device(arrays["fov"], device, keys)
        for k in TIAF_KEYS + (("image_labels",) if "labels" in keys else ()):
            arrays[k + "_t"] = torch.from_numpy(arrays[k]).to(device)
        return arrays
    keys = tuple(keys) + tuple(k for k in FUSION_KEYS if k in arrays)
    for k in keys:
        arrays[k + "_t"] = torch.from_numpy(arrays[k]).to(device)
    arrays["num_points_t"] = torch.from_numpy(arrays["num_points"].reshape(())).to(device)
    return arrays


@contextlib.contextmanager
def eval_mode(model: torch.nn.Module):
    """`model` in eval mode inside the block, its own mode after it."""
    was_training = model.training
    model.eval()
    try:
        yield model
    finally:
        model.train(was_training)


def make_pipeline(cfg: dict, model: torch.nn.Module, training: bool, seed: int = 0):
    """The host pipeline of `model`: the CylinderPipeline for Cylinder_TS
    (the polar grid DATA.GRID_SIZE, 480 x 360 x 32 by default, as JAX's
    `build_dataloader`), the FusionPipeline (DATA.H x DATA.W range images,
    64 x 2048 by default) for a model that reads range images (RPVNet),
    the MsVoxelPipeline for the models of the fused cloud (MS_MODELS; the
    MsKdVoxelPipeline with DATA.MAX_VOXEL pairs per scan to train
    MinkUNetMsKd), the MsMmVoxelPipeline for TIAF (TIAF_MODELS), the
    VoxelPipeline otherwise; the RangeViewPipeline (DATA.H x DATA.W,
    64 x 2048 by default, and the mixes' flags) for the range models."""
    if is_range_model(model):
        return RangeViewPipeline.from_cfg(cfg.get("DATA", {}), training, seed)
    if isinstance(model, CylinderTS):
        return CylinderPipeline(grid=grid_from_cfg(cfg["DATA"]), training=training, seed=seed)
    kw = dict(
        voxel_size=cfg["DATA"]["VOXEL_SIZE"], training=training,
        in_feature_dim=cfg["MODEL"].get("IN_FEATURE_DIM", 4), seed=seed,
    )
    name = cfg["MODEL"].get("NAME")
    if training and name == "MinkUNetMsKd":
        return MsKdVoxelPipeline(max_voxel=int(cfg["DATA"].get("MAX_VOXEL", 3000)), **kw)
    if name in MS_MODELS:
        return MsVoxelPipeline(**kw)
    if name in TIAF_MODELS:
        return MsMmVoxelPipeline(**kw)
    if getattr(model, "range_view", False):
        return FusionPipeline(h=cfg["DATA"].get("H", 64), w=cfg["DATA"].get("W", 2048), **kw)
    return VoxelPipeline(**kw)


def model_topology(
    model: torch.nn.Module, arrays: dict, caps: UNetCapacities, *,
    sorted_points: bool, devox_pairs: bool = False, fov_caps: UNetCapacities = None,
):
    """Stage 2: the topology with the model's point -> voxel tables
    (`point_voxel_strides`), the tables only the backward reads where
    `devox_pairs`, and K3-down's child tables, built without a host read
    where the host arrays' coordinates are non-negative (`host_nonneg`);
    for a model that reads range images (RPVNet) an
    `RpvInputs` that adds its point <-> range tables and the images; for
    Cylinder_TS its own `CylTopology` (JAX's `topology_fn`,
    engine.py:272-284); for TIAF the `TiafInputs`, its FOV topology at
    `fov_caps`."""
    if getattr(model, "tiaf", False):
        return tiaf_inputs(arrays, caps, fov_caps, train=devox_pairs)
    if isinstance(model, CylinderTS):
        return build_cylinder_topology(
            arrays["point_coords_t"], arrays["num_points_t"], caps, train=devox_pairs
        )
    topo = build_unet_topology(
        arrays["point_coords_t"], arrays["num_points_t"], caps,
        devox_pairs=devox_pairs, assume_sorted_points=sorted_points,
        point_voxel_strides=model.point_voxel_strides,
        nonneg_coords=host_nonneg(arrays["point_coords"]),
    )
    if getattr(model, "range_view", False):
        return rpv_inputs(topo, arrays, with_pairs=devox_pairs)
    return topo


@torch.no_grad()
def eval_logits(model: torch.nn.Module, arrays: dict, topo) -> torch.Tensor:
    """Stage 3: per-row logits (P, C) f32 of an eval-mode `model` (TIAF:
    of the main cloud's rows, the replace ensemble applied)."""
    if isinstance(topo, TiafInputs):
        return model(arrays["main"]["point_feats_t"], topo)["logits"]
    return model(arrays["point_feats_t"], topo)


def point_logits(logits: torch.Tensor, offsets, samples, padded=None):
    """Stage 4: yields (sample, per-raw-point logits on the device) for
    every sample of a shard that is not a padding repeat.  A fused
    multi-scan sample (one with an `ms_pair`) yields its frame and the
    logits of the current frame's points only, which lead the fused cloud
    (FSA's point_mask, reference semantickitti_voxel_ms.py:204-210)."""
    for b, s in enumerate(samples):
        if padded and padded[b]:
            continue
        rows = logits[int(offsets[b]) : int(offsets[b + 1])]
        pt = rows[torch.from_numpy(s.inverse_map).to(logits.device).long()]
        ms = getattr(s, "ms_pair", None)
        if ms is not None:
            yield ms.frame, pt[: ms.num_frame_points]
        else:
            yield s, pt


def save_scan(save_path, sample, pred: np.ndarray, logits: np.ndarray = None) -> None:
    """Write one scan's predicted train ids in its dataset's submission
    format (JAX `engine.py:714 _save_scan`, reference train.py:476-559):
    a sample with a nuScenes token as uint8 `lidarseg/test/<token>_
    lidarseg.bin` beside `submission.json` (an FSA sample's frame: the
    keyframe's points only), else a SemanticKITTI .label file of raw ids
    (and `logits`, where given, as a float32 .bin)."""
    if getattr(sample, "token", None) is not None:
        save_nuscenes_predictions(save_path, sample.token, pred)
        write_nuscenes_submission_json(save_path)
        return
    if logits is not None:
        save_logits(save_path, sample.name, logits)
    save_predictions(save_path, sample.name, pred)


class Segmenter:
    """Inference on one device of the model that MODEL.NAME names
    (MinkUNet, SPVCNN, RPVNet, Cylinder_TS, MinkUNetMs, MinkUNetMsKd or
    MinkUNetMsMm(Nus); the last three take reader dicts with the fused cloud,
    `xyzret_ms` (TIAF's also with the camera window: `fov_mask`,
    `fov_rowcol`, `images`, `image_labels`), and return the current
    frame's points).  A range model's config (SalsaNext, FIDNet, CENet,
    RangeNet) gets a `range_step.RangeSegmenter`.

    cfg: dict with the YAML's layout (`configs.py`).  params: the flax
    variables as numpy trees, `{"params": ..., "batch_stats": ...}`
    (`utils.params_from_jax.init_params_numpy` draws them from a seed).
    The point capacity defaults to MODEL.POINTS_PER_SCAN (else 131072)
    rows per scan; TIAF's FOV capacity to `fov_points`, at JAX's default
    schedule (`engine.py:230`).
    """

    def __new__(cls, cfg: dict, *args, **kwargs):
        if cls is Segmenter and cfg["MODEL"].get("NAME") in RANGE_SEGMENTORS:
            from .range_step import RangeSegmenter

            cls = RangeSegmenter
        return super().__new__(cls)

    def __init__(
        self,
        cfg: dict,
        params: dict,
        device=None,
        *,
        compute_dtype: str = None,
        batch_size: int = 1,
        point_capacity: int = None,
    ):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.point_capacity = point_capacity or points_per_scan(cfg) * batch_size
        # MODEL.CAPACITY_SCHEDULE: per-level voxel-capacity fractions of
        # the point capacity, as in the JAX engine
        self.caps = UNetCapacities.for_points(
            self.point_capacity,
            schedule=cfg["MODEL"].get("CAPACITY_SCHEDULE"),
        )
        self.fov_capacity = fov_points(cfg, self.point_capacity)
        self.fov_caps = UNetCapacities.for_points(self.fov_capacity)
        self.model = build_segmentor(cfg, device=self.device, compute_dtype=compute_dtype)
        load_flax_params(self.model, params["params"], params["batch_stats"])
        self.model.eval()
        self.pipeline = make_pipeline(cfg, self.model, training=False)

    def collate(self, scans: list) -> dict:
        """Host stage: quantize, dedup, key-sort and pad the scans into
        one shard (with their range images for RPVNet; with the FOV shard
        and the camera images for TIAF), and move the arrays to the
        device."""
        samples = [self.pipeline(s) for s in scans]
        if isinstance(self.pipeline, MsMmVoxelPipeline):
            arrays = self.pipeline.collate(samples, self.point_capacity, self.fov_capacity)
        else:
            arrays = self.pipeline.collate(samples, self.point_capacity)
        return to_device(arrays, self.device)

    def topology(self, arrays: dict):
        return model_topology(
            self.model, arrays, self.caps, sorted_points=self.pipeline.sorted_points,
            fov_caps=self.fov_caps,
        )

    def check_capacity(self, topo) -> None:
        check_capacity(topo, self.caps, self.fov_caps)

    def forward(self, arrays: dict, topo) -> torch.Tensor:
        return eval_logits(self.model, arrays, topo)

    def map_to_points(self, arrays: dict, logits: torch.Tensor) -> list:
        return [
            {
                "logits": pt.cpu().numpy(),
                "labels": pt.argmax(1).to(torch.int32).cpu().numpy(),
            }
            for _, pt in point_logits(logits, arrays["offsets"], arrays["samples"])
        ]

    def predict(self, scans: list) -> list:
        """Per-raw-point {"logits": (N, C) float32, "labels": (N,) int32}
        for every reader dict in `scans`, `batch_size` scans at a time."""
        results = []
        for i in range(0, len(scans), self.batch_size):
            arrays = self.collate(scans[i : i + self.batch_size])
            topo = self.topology(arrays)
            self.check_capacity(topo)
            logits = self.forward(arrays, topo)
            results.extend(self.map_to_points(arrays, logits))
        return results


def _leaf_name(prefix: str, key) -> str:
    return prefix + str(key).replace(".", "/")


def _flatten(tree: dict, prefix: str = "") -> dict:
    """{"a/b/c": leaf} of a nested dict or a flat state dict ("a.b.c")."""
    flat = {}
    for k, v in tree.items():
        name = _leaf_name(prefix, k)
        if isinstance(v, dict):
            flat.update(_flatten(v, name + "/"))
        else:
            flat[name] = v
    return flat


def load_matching_params(dst: dict, src: dict, *, strict: bool = False, logger=None) -> dict:
    """Name+shape partial load with wrapper-scope tolerance (JAX
    `engine.py:56`): a dst leaf matches the src leaf with the identical
    path, or — when scopes differ (e.g. TIAF wraps the backbone under
    `main/`) — the unique src leaf whose path is a suffix of the dst path
    with the same shape.  Trees are nested dicts (the flax layout of
    `utils.params_from_jax.export_flax_params`) or flat state dicts whose
    "."-separated names read as "/" paths; leaves are arrays or tensors.
    Returns a tree of dst's structure."""
    flat_src = _flatten(src)
    by_suffix: dict = {}
    for k, v in flat_src.items():
        parts = k.split("/")
        for i in range(len(parts)):
            by_suffix.setdefault("/".join(parts[i:]), []).append(v)
    counts = {"loaded": 0, "skipped": 0}

    def pick(key, leaf):
        shape = tuple(leaf.shape)
        cand = flat_src.get(key)
        if cand is None:
            # wrapper-scope match: dst suffix must identify ONE src leaf
            parts = key.split("/")
            for i in range(1, len(parts)):
                hits = [
                    v for v in by_suffix.get("/".join(parts[i:]), [])
                    if tuple(v.shape) == shape
                ]
                if len(hits) == 1:
                    cand = hits[0]
                    break
        if cand is not None and tuple(cand.shape) == shape:
            counts["loaded"] += 1
            return cand
        if strict:
            raise KeyError(f"missing/mismatched param {key}")
        counts["skipped"] += 1
        return leaf

    def walk(tree, prefix):
        out = {}
        for k, v in tree.items():
            name = _leaf_name(prefix, k)
            out[k] = walk(v, name + "/") if isinstance(v, dict) else pick(name, v)
        return out

    out = walk(dst, "")
    if logger is not None:
        logger.info(f"pretrained load: {counts['loaded']} matched, {counts['skipped']} kept")
    return out


class _NullWriter:
    """The metrics writer of a rank other than 0."""

    def scalar(self, *args, **kwargs) -> None:
        pass

    def scalars(self, *args, **kwargs) -> None:
        pass

    def flush(self) -> None:
        pass


class Trainer:
    """The train step on one device of the model that MODEL.NAME names
    (MinkUNet, SPVCNN, RPVNet, Cylinder_TS, MinkUNetMs, MinkUNetMsKd or
    MinkUNetMsMm), and the harness around it.

    cfg: dict with the YAML's layout (`configs.py`, or a `utils.config.
    Config`), including OPTIM; MODEL.TRAIN_CAPACITY_SCHEDULE, where
    present, replaces CAPACITY_SCHEDULE for training (augmented scans fill
    the coarse levels more); evaluation uses CAPACITY_SCHEDULE, as
    `Segmenter` does.  params: the flax variables as numpy trees, as for
    `Segmenter`; None draws them with `init_params_numpy` from cfg's SEED
    (default 0).  The LR is OPTIM.LR_PER_SAMPLE x `batch_size` (scans per
    step), on the warmup-cosine schedule over `iters_per_epoch` x
    `total_epochs` steps.  With a `train_loader` (`data.VoxelLoader`),
    `iters_per_epoch`, `batch_size` and `point_capacity` default to its
    length, global scans per batch and point capacity, as in JAX
    (`engine.py:179-193`); `total_epochs` defaults to OPTIM.NUM_EPOCHS.
    Without a loader the point capacity defaults to MODEL.POINTS_PER_SCAN
    (else 131072) rows per scan.

    `step(scans)` runs, for `batch_size` reader dicts:
      1. host:      VoxelPipeline(training=True) (RPVNet: FusionPipeline,
                    Cylinder_TS: CylinderPipeline) with a numpy generator
                    seeded by `seed`, then its collate;
      2. topology:  `model_topology(devox_pairs=True)`: the train
                    topology with the model's point_voxel_strides, and
                    RPVNet's point <-> range tables (Cylinder_TS: its
                    CylTopology with the reverse tables); a level over
                    capacity raises;
      3. forward:   the model in train mode (masked batch statistics), then
                    the criterion (MODEL.LOSS_CONFIG: CE with label
                    smoothing + Lovász, ignore MODEL.IGNORE_LABEL);
      4. backward:  autograd through the hand kernels' Functions;
      5. optimizer: global-norm clip, weight decay, SGD with Nesterov
                    (`optim.ClippedSGD`),
    and returns {"loss", "grad_norm" (before the clip), "lr" (the LR this
    step applied), "level_nums"}.  `train_on(arrays)` runs stages 2-5 on
    a collated shard.  Every Dropout of the model (MODEL.DROPOUT_P, and
    RPVNet's range branch at 0.2) draws its masks from one generator on
    the device seeded by `seed` (`dropout_generator`).

    MinkUNetMsKd trains the `kd` kind (JAX `parallel/kd.py:52`, wired as
    `engine.py:289-320`): its pipeline is the MsKdVoxelPipeline, whose
    shard holds the student's pseudo-mask cloud, the teacher's GT-mask
    cloud and the pairs of their matching voxels.  The teacher, a frozen
    copy of the architecture installed by `set_teacher` / `load_teacher`
    (MODEL.TEACHER_CKPT in the CLI), runs in eval mode (BN on its running
    statistics) under `torch.no_grad` on its own topology
    (`teacher_topology`, at `teacher_capacity` rows: the loader's, else
    the point capacity) with `return_features`; the student in train
    mode with `return_features`; the loss is the criterion plus
    MODEL.FEAT_KD_WEIGHT (10) x the MSE of their tri-scale features over
    the pairs, and `train_on` also returns "loss_seg" and "loss_feat_kd".
    The teacher's parameters and buffers are in no optimizer and in no
    checkpoint; a step without a teacher raises.

    MinkUNetMsMm(Nus) trains the `tiaf` kind (JAX `parallel/tiaf.py:73`, wired
    as `engine.py:229-251, 321-337`): its pipeline is the
    MsMmVoxelPipeline, whose shard holds the main fused cloud, the FOV
    cloud (`fov_capacity` rows: the loader's, else `fov_points`, at JAX's
    default schedule), the FOV rows' pixels and the camera images with
    their targets; the topology stage builds `TiafInputs`; the loss is
    MODEL.LOSS_WEIGHT ([lidar, fusion, image_s, image_d, image_lidar],
    default [0, 1, 0.5, 0.5, 1]) over the criterion on the main logits,
    the fusion logits (on the overlap), the image logits at the FOV rows,
    the dense image logits and the FOV branch's logits, and `train_on`
    also returns the five terms (`TIAF_TERMS`).  With MODEL.FIX_PART_PARAM
    only the parameters under MODEL.TRAINABLE_PREFIXES (default: the
    image and lidar-FOV branches and the two classifiers) are in the
    optimizer's chain (`utils.param_groups`): every parameter keeps its
    gradient and "grad_norm" covers them all, as in JAX; the clip covers
    the trainable ones; the frozen ones do not move, while `main`'s BN
    runs in train mode and its running statistics move.

    Under a `torch.distributed` process group (`parallel`, one process
    per card, the CLI's `--distributed`) each rank steps on its slice of
    the global batch (`batch_size` is the global one, as the LR's): the
    gradients are averaged in one all-reduce before the optimizer, the
    reported loss too, the level counts are maxed before the capacity
    check, with MODEL.IF_DIST every masked BN sums its statistics over the
    ranks, each rank's dropout generator is seeded from (seed, rank), rank
    0 alone writes checkpoints and metrics (every rank resumes from the
    same file), and the evaluation histograms are summed (JAX
    `parallel/__init__.py:120-254`).

    A range model's config (SalsaNext, FIDNet, CENet, RangeNet) gets a
    `range_step.RangeTrainer`, the `range` kind (JAX
    `parallel/range_step.py`, wired as `engine.py:350-373`).

    The harness (JAX `engine.py:539-911`): `train(eval_interval=)` runs
    `train_one_epoch` over the train loader (its prefetch thread runs the
    host stage), saves `checkpoint_epoch_<n>` under CKPT_DIR or
    `output_dir/ckpt` and evaluates every `eval_interval` epochs;
    `resume_latest`, `load_pretrained`; `evaluate()` (voxel-level
    confusion histogram and per-class IoU) and `evaluate_points()`
    (raw-point histogram, TTA votes, submission files) over the val
    loader.
    """

    def __new__(cls, cfg: dict, *args, **kwargs):
        if cls is Trainer and cfg["MODEL"].get("NAME") in RANGE_SEGMENTORS:
            from .range_step import RangeTrainer

            cls = RangeTrainer
        return super().__new__(cls)

    def __init__(
        self,
        cfg: dict,
        params: dict = None,
        device=None,
        *,
        iters_per_epoch: int = None,
        total_epochs: int = None,
        batch_size: int = None,
        seed: int = 0,
        compute_dtype: str = None,
        point_capacity: int = None,
        train_loader=None,
        val_loader=None,
        output_dir="output",
        logger=None,
        teacher_capacity: int = None,
    ):
        m, optim = cfg["MODEL"], cfg["OPTIM"]
        self.cfg = cfg
        self.device = resolve_device(device)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.logger = logger or create_logger()
        if train_loader is not None:
            if len(train_loader) == 0:
                raise ValueError(
                    f"empty train loader: {len(train_loader.reader)} scans < one "
                    f"global batch of {train_loader.global_scans_per_batch} scans"
                )
            iters_per_epoch = iters_per_epoch or len(train_loader)
            batch_size = batch_size or train_loader.global_scans_per_batch
            point_capacity = point_capacity or train_loader.point_capacity
            teacher_capacity = teacher_capacity or getattr(train_loader, "teacher_capacity", None)
        if iters_per_epoch is None:
            raise TypeError("Trainer needs iters_per_epoch or a train_loader")
        self.batch_size = batch_size = batch_size or 1
        self.total_epochs = int(total_epochs or optim["NUM_EPOCHS"])
        self.num_class = int(m.get("NUM_CLASS", 20))
        self.point_capacity = point_capacity or points_per_scan(cfg) * batch_size
        train_schedule = m.get("TRAIN_CAPACITY_SCHEDULE", m.get("CAPACITY_SCHEDULE"))
        self.caps = UNetCapacities.for_points(self.point_capacity, schedule=train_schedule)
        name = m.get("NAME")
        self.kind = "kd" if name == "MinkUNetMsKd" else "tiaf" if name in TIAF_MODELS else "voxel"
        self.teacher_capacity = teacher_capacity or self.point_capacity
        self.teacher_caps = UNetCapacities.for_points(self.teacher_capacity, schedule=train_schedule)
        self.teacher = None
        self.feat_kd_weight = float(m.get("FEAT_KD_WEIGHT", 10.0))
        self.compute_dtype = compute_dtype
        self.eval_caps = UNetCapacities.for_points(
            val_loader.point_capacity if val_loader is not None else self.point_capacity,
            schedule=m.get("CAPACITY_SCHEDULE"),
        )
        self.fov_capacity = (
            getattr(train_loader, "fov_capacity", None) or fov_points(cfg, self.point_capacity)
        )
        self.fov_caps = UNetCapacities.for_points(self.fov_capacity)
        self.eval_fov_caps = UNetCapacities.for_points(
            getattr(val_loader, "fov_capacity", None) or self.fov_capacity
        )
        self.loss_weight = tuple(float(w) for w in m.get("LOSS_WEIGHT", (0.0, 1.0, 0.5, 0.5, 1.0)))
        self.model = build_segmentor(cfg, device=self.device, compute_dtype=compute_dtype)
        self.rank, self.seed = parallel.rank(), seed
        if m.get("IF_DIST", False):
            parallel.sync_batchnorm(self.model)
        self.pipeline = make_pipeline(cfg, self.model, training=True, seed=seed)
        self.dropout_generator = seed_dropout(self.model, parallel.rank_seed(seed, self.rank))
        if params is None:
            p, s = init_params_numpy(cfg, seed=int(cfg.get("SEED", 0)))
            params = {"params": p, "batch_stats": s}
        load_flax_params(self.model, params["params"], params["batch_stats"])
        self.model.train()
        frozen = []
        if m.get("FIX_PART_PARAM", False):
            # staged-recipe freezing (reference fix_part_param, JAX
            # engine.py:237-251)
            trainable = list(m.get("TRAINABLE_PREFIXES", TRAINABLE_PREFIXES))
            frozen = frozen_parameters(self.model, trainable)
            self.logger.info(f"fix_part_param: training only {trainable}")
        lr = float(optim["LR_PER_SAMPLE"]) * batch_size
        self.optimizer = build_optimizer(
            self.model.parameters(), {**optim, "LR": lr}, iters_per_epoch,
            self.total_epochs, clip_grad_norm=float(optim.get("GRAD_NORM_CLIP", 10.0)),
            frozen=frozen, head=head_parameters(self.model),
        )
        loss_cfg = m.get(
            "LOSS_CONFIG",
            {"LOSS_TYPES": ["CELoss", "LovLoss"], "LOSS_WEIGHTS": [1.0, 1.0]},
        )
        self.loss_state = self._next_loss_state = None
        self.build_criterion(cfg, loss_cfg)
        self.output_dir = Path(output_dir)
        ckpt_root = str(cfg.get("CKPT_DIR", "") or "")
        if storage.is_remote(ckpt_root):  # s3:// on the Petrel backend
            self.ckpt_dir = ckpt_root.rstrip("/")
        else:
            self.ckpt_dir = (Path(ckpt_root) if ckpt_root else self.output_dir / "ckpt").absolute()
        self.ckptr = storage.CheckpointIO()
        self.start_epoch = 0
        self._writer = None

    def build_criterion(self, cfg: dict, loss_cfg: dict) -> None:
        """The criterion of MODEL.LOSS_CONFIG (LOSS_TYPES, LOSS_WEIGHTS,
        GS_GROUPS, GS_FG_CLASSES), ignoring MODEL.IGNORE_LABEL, with
        MODEL.LABEL_SMOOTHING, as JAX's engine builds it
        (engine.py:195-207); under MODEL.IF_DIST EQLv2 sums its
        statistics over the ranks.  A stateful criterion's statistics
        start in `loss_state` (JAX `TrainState.loss_state`)."""
        m = cfg["MODEL"]
        self.criterion = Losses(
            loss_cfg["LOSS_TYPES"], loss_cfg["LOSS_WEIGHTS"],
            ignore_index=int(m.get("IGNORE_LABEL", 0)),
            label_smoothing=float(m.get("LABEL_SMOOTHING", 0.0)),
            gs_groups=loss_cfg.get("GS_GROUPS"),
            gs_fg_classes=loss_cfg.get("GS_FG_CLASSES"),
            dist=bool(m.get("IF_DIST", False)),
        )
        if self.criterion.stateful and self.kind != "voxel":
            raise ValueError(
                f"EQLv2 carries its statistics through the plain train step only, as JAX's "
                f"make_train_step; the {self.kind} step takes a stateless criterion"
            )
        self.loss_state = self.criterion.init_state(self.num_class, self.device)

    @property
    def writer(self) -> MetricsWriter:
        """`output_dir/metrics` (JSONL, and TensorBoard where importable),
        opened at first use; rank 0's alone under a process group (the
        others write nothing)."""
        if self._writer is None:
            self._writer = (
                MetricsWriter(self.output_dir / "metrics") if self.rank == 0 else _NullWriter()
            )
        return self._writer

    # ---------------- the KD teacher (JAX engine.py:377-393) ----------------
    def set_teacher(self, params: dict, batch_stats: dict) -> None:
        """Install the frozen KD teacher from flax-layout numpy trees (a
        second copy of the architecture, in eval mode, outside the
        optimizer; it replaces the reference's stem -> stem_gt key
        remapping, minkunet_ms_kd.py:680-717)."""
        teacher = build_segmentor(self.cfg, device=self.device, compute_dtype=self.compute_dtype)
        load_flax_params(teacher, params, batch_stats)
        self.teacher = teacher.eval().requires_grad_(False)

    def load_teacher(self, path: str) -> None:
        """The KD teacher from a checkpoint of a Trainer of the same
        architecture (e.g. the FSA stage's MinkUNetMs), or from a file of
        flax-layout {"params", "batch_stats"} trees."""
        payload = self.ckptr.restore(path, map_location="cpu")
        if "model" in payload:
            teacher = build_segmentor(self.cfg, device=self.device, compute_dtype=self.compute_dtype)
            teacher.load_state_dict(payload["model"])
            self.teacher = teacher.eval().requires_grad_(False)
        else:
            self.set_teacher(payload["params"], payload["batch_stats"])
        self.logger.info(f"loaded frozen KD teacher from {path}")

    # ---------------- the step ---------------------------------------------
    def shard_to_device(self, arrays: dict) -> dict:
        """A collated shard's arrays on the device, its labels with them."""
        return to_device(arrays, self.device, ("point_coords", "point_feats", "labels"))

    def collate(self, scans: list) -> dict:
        """Host stage: augment, quantize, dedup, key-sort and pad the scans
        into one shard (with their range images for RPVNet; with the
        teacher's shard and the pairs for KD; with the FOV shard and the
        camera images for TIAF), and move the arrays to the device."""
        samples = [self.pipeline(s) for s in scans]
        if self.kind == "kd":
            arrays = self.pipeline.collate(samples, self.point_capacity, self.teacher_capacity)
        elif self.kind == "tiaf":
            arrays = self.pipeline.collate(samples, self.point_capacity, self.fov_capacity)
        else:
            arrays = self.pipeline.collate(samples, self.point_capacity)
        return self.shard_to_device(arrays)

    def topology(self, arrays: dict):
        """The train topology of the shard (of the student's, for KD; the
        `TiafInputs` for TIAF)."""
        return model_topology(
            self.model, arrays.get("student", arrays), self.caps, devox_pairs=True,
            sorted_points=self.pipeline.sorted_points, fov_caps=self.fov_caps,
        )

    def teacher_topology(self, arrays: dict):
        """The KD teacher's eval topology of its shard at its capacities;
        a level over capacity raises."""
        t = arrays["teacher"]
        topo = build_unet_topology(
            t["point_coords_t"], t["num_points_t"], self.teacher_caps,
            nonneg_coords=host_nonneg(t["point_coords"]),
        )
        check_capacity(topo, self.teacher_caps)
        return topo

    def forward(self, arrays: dict, topo, teacher_topo=None) -> torch.Tensor:
        """The loss of the shard (f32 scalar, with its graph); for KD the
        criterion plus FEAT_KD_WEIGHT x the masked feature MSE (JAX
        kd.py:94-108), with its two terms kept in `kd_terms` (detached),
        the teacher's topology built here unless given; for TIAF the
        weighted five terms (`tiaf_loss`)."""
        if self.kind == "tiaf":
            return self.tiaf_loss(arrays, topo)
        a = arrays.get("student", arrays)
        if self.kind != "kd":
            logits = self.model(a["point_feats_t"], topo)
        else:
            if self.teacher is None:
                raise RuntimeError(
                    "the KD stage needs MODEL.TEACHER_CKPT (or set_teacher / "
                    "load_teacher) before training"
                )
            if teacher_topo is None:
                teacher_topo = self.teacher_topology(arrays)
            with torch.no_grad():
                _, t_feats = self.teacher(
                    arrays["teacher"]["point_feats_t"], teacher_topo, return_features=True
                )
            logits, s_feats = self.model(a["point_feats_t"], topo, return_features=True)
        p = logits.shape[0]
        pvalid = torch.arange(p, device=self.device) < a["num_points_t"]
        if self.criterion.stateful:
            # the statistics after this step, taken by `train_on` with
            # the update (JAX's step returns them in the new TrainState)
            loss, self._next_loss_state = self.criterion(
                logits, a["labels_t"].long(), pvalid, self.loss_state
            )
            return loss
        loss = self.criterion(logits, a["labels_t"].long(), pvalid)
        if self.kind == "kd":
            fs = s_feats[arrays["kd_student_idx_t"].long()]
            ft = t_feats[arrays["kd_teacher_idx_t"].long()]
            m = arrays["kd_mask_t"].float()[:, None]
            loss_kd = (((fs - ft) ** 2) * m).sum() / torch.clamp(m.sum() * fs.shape[-1], min=1.0)
            self.kd_terms = (loss.detach(), loss_kd.detach())
            loss = loss + self.feat_kd_weight * loss_kd
        return loss

    def tiaf_loss(self, arrays: dict, inputs: TiafInputs) -> torch.Tensor:
        """TIAF's loss (JAX `parallel/tiaf.py:100-135`): LOSS_WEIGHT x
        (criterion on the main logits over the valid main rows, on the
        fusion logits over the valid rows in the overlap, on the image
        logits at the FOV rows and on the FOV branch's logits over the
        valid FOV rows, on the dense image logits over every pixel), the
        terms kept in `tiaf_terms` (detached)."""
        main, fov = arrays["main"], arrays["fov"]
        out = self.model(main["point_feats_t"], inputs)
        labels = main["labels_t"].long()
        fov_labels = fov["labels_t"].long()
        pvalid = torch.arange(labels.shape[0], device=self.device) < main["num_points_t"]
        fvalid = torch.arange(fov_labels.shape[0], device=self.device) < fov["num_points_t"]
        img_labels = arrays["image_labels_t"].reshape(-1).long()
        nc = out["image_logits"].shape[-1]
        terms = (
            self.criterion(out["logits"], labels, pvalid),
            self.criterion(out["fusion_logits"], labels, pvalid & out["overlap"]),
            self.criterion(out["image_point_logits"], fov_labels, fvalid),
            self.criterion(
                out["image_logits"].reshape(-1, nc), img_labels,
                torch.ones_like(img_labels, dtype=torch.bool),
            ),
            self.criterion(out["fov_point_logits"], fov_labels, fvalid),
        )
        self.tiaf_terms = dict(zip(TIAF_TERMS, (t.detach() for t in terms)))
        loss = None
        for w, t in zip(self.loss_weight, terms):
            loss = w * t if loss is None else loss + w * t
        return loss

    def backward(self, loss: torch.Tensor) -> None:
        """The gradients of `loss`, averaged over the ranks under a process
        group (one all-reduce, before the optimizer's clip)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        parallel.average_gradients(self.model.parameters())

    def update(self):
        """(global grad norm before the clip, LR applied)."""
        return self.optimizer.step()

    def train_topology(self, arrays: dict):
        """(the train topology, its level counts maxed over the ranks); a
        level over capacity raises."""
        topo = self.topology(arrays)
        return topo, check_capacity(topo, self.caps, self.fov_caps, over_ranks=True)

    def train_on(self, arrays: dict) -> dict:
        """Topology, forward, loss, backward and update on a collated
        shard (`collate`)."""
        topo, level_nums = self.train_topology(arrays)
        loss = self.forward(arrays, topo)
        self.backward(loss)
        g_norm, lr = self.update()
        if self._next_loss_state is not None:
            self.loss_state, self._next_loss_state = self._next_loss_state, None
        out = {
            "loss": float(parallel.mean_over_ranks(loss.detach())), "grad_norm": float(g_norm),
            "lr": lr, "level_nums": level_nums,
        }
        if self.kind == "kd":
            out["loss_seg"], out["loss_feat_kd"] = (float(t) for t in self.kd_terms)
        elif self.kind == "tiaf":
            out.update({k: float(v) for k, v in self.tiaf_terms.items()})
        return out

    def step(self, scans: list) -> dict:
        """One train step on `batch_size` reader dicts."""
        return self.train_on(self.collate(scans))

    # ---------------- checkpoints (reference train.py:326-362) ---------------
    def save_checkpoint(self, epoch: int, max_keep: int = 30) -> None:
        """`checkpoint_epoch_<epoch>`: the model's state dict (parameters
        and BN running statistics), the optimizer's (momentum traces and
        its step count), the dropout generator's state, EQLv2's
        statistics where the criterion has them, and the epoch; keeps the
        newest `max_keep`."""
        if self.rank == 0:  # the ranks hold the same state: one writes it
            path = f"{str(self.ckpt_dir).rstrip('/')}/checkpoint_epoch_{epoch}"
            payload = {
                "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "dropout_rng": self.dropout_generator.get_state(),
                "epoch": epoch,
            }
            if self.loss_state is not None:  # EQLv2's statistics
                payload["loss_state"] = tuple(t.detach().cpu() for t in self.loss_state)
            self.ckptr.save(path, payload)
            kept = self.ckptr.list_epochs(self.ckpt_dir)
            for _, old in kept[:-max_keep]:
                self.ckptr.remove(old)
            self.logger.info(f"saved checkpoint {path}")
        parallel.barrier()

    def resume_latest(self) -> bool:
        """Auto-resume from the newest checkpoint (train.py:232-242)."""
        found = self.ckptr.list_epochs(self.ckpt_dir)
        if not found:
            return False
        payload = self.ckptr.restore(found[-1][1], map_location=self.device)
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        if self.loss_state is not None and "loss_state" in payload:
            self.loss_state = type(self.loss_state)(*(t.to(self.device) for t in payload["loss_state"]))
        if "dropout_rng" in payload and self.rank == 0:
            self.dropout_generator.set_state(payload["dropout_rng"].cpu())
        elif self.rank:
            # the checkpoint holds rank 0's generator: the others draw
            # their own masks, from (seed, epoch) and the rank
            self.dropout_generator.manual_seed(
                parallel.rank_seed(self.seed + int(payload["epoch"]) + 1, self.rank)
            )
        self.start_epoch = int(payload["epoch"]) + 1
        self.logger.info(
            f"resumed from {found[-1][1]} (epoch {self.start_epoch - 1})"
        )
        return True

    def load_pretrained(self, path: str, strict: bool = False) -> None:
        """Partial name+shape-matched load (reference
        base_segmentors.py:16-26) of a checkpoint of this Trainer, or of a
        file holding flax-layout {"params", "batch_stats"} trees (e.g.
        `export_flax_params`), across wrapper scopes
        (`load_matching_params`).  `strict` holds for the parameters; the
        BN running statistics are matched where present."""
        payload = self.ckptr.restore(path, map_location="cpu")
        if "model" in payload:
            src = _flatten(payload["model"])
        elif "params" in payload:
            src = {**_flatten(payload["params"]), **_flatten(payload.get("batch_stats") or {})}
        else:
            src = _flatten(payload)
        params = dict(self.model.named_parameters())
        buffers = dict(self.model.named_buffers())
        new = {
            **load_matching_params(params, src, strict=strict, logger=self.logger),
            **load_matching_params(buffers, src, strict=False, logger=self.logger),
        }
        self.model.load_state_dict(
            {k: torch.as_tensor(np.asarray(v)) if isinstance(v, np.ndarray) else v
             for k, v in new.items()}
        )

    # ---------------- loops ------------------------------------------------
    def train_one_epoch(self, epoch: int) -> dict:
        """One pass over the train loader.  Returns {"loss": the mean loss,
        "steps": each step's `train_on` result with "data_s" (the wait for
        the batch, its copy to the device included) and "step_s"}.  A
        level over capacity raises (JAX warns and counts)."""
        writer = self.writer  # opened before the first step's clock starts
        timer = StepTimer()
        steps = []
        n = len(self.train_loader)
        for it, (arrays, _meta) in enumerate(self.train_loader):
            arrays = self.shard_to_device(arrays)
            timer.data_done()
            out = self.train_on(arrays)
            timer.step_done()
            out.update(data_s=timer.d_time.val, step_s=timer.f_time.val)
            steps.append(out)
            step = self.optimizer.count
            for k in ("loss", "grad_norm", "lr", "loss_seg", "loss_feat_kd", *TIAF_TERMS):
                if k in out:
                    writer.scalar(f"train/{k}", out[k], step)
            if it % max(n // 4, 1) == 0:
                self.logger.info(
                    f"epoch {epoch} it {it}/{n} loss {out['loss']:.4f} "
                    f"d_time {timer.d_time.avg:.3f}s f_time {timer.f_time.avg:.3f}s "
                    f"b_time {timer.b_time.avg:.3f}s"
                )
        losses = [s["loss"] for s in steps]
        return {"loss": float(np.mean(losses)) if losses else float("nan"), "steps": steps}

    def train(self, *, eval_interval: int = 0) -> list:
        """Epochs start_epoch .. total_epochs - 1, each saved; returns
        each epoch's `train_one_epoch` result."""
        history = []
        for epoch in range(self.start_epoch, self.total_epochs):
            stats = self.train_one_epoch(epoch)
            history.append(stats)
            self.logger.info(f"epoch {epoch} mean loss {stats['loss']:.4f}")
            self.save_checkpoint(epoch)
            if (
                eval_interval
                and self.val_loader is not None
                and (epoch + 1) % eval_interval == 0
            ):
                self.evaluate()
        self.writer.flush()
        return history

    # ------------- evaluation: the same stages as Segmenter ----------------
    def _eval_batches(self, batches):
        """(arrays of the logits' rows on the device, meta, per-row
        logits) of each batch, through `Segmenter`'s stages 2-3 on this
        model in eval mode (for KD, the student alone on its shard; for
        TIAF, the main shard's rows)."""
        sorted_points = self.val_loader.pipeline.sorted_points
        with eval_mode(self.model):
            for arrays, meta in batches:
                arrays = self.shard_to_device(arrays)
                arrays = arrays.get("student", arrays)
                topo = model_topology(
                    self.model, arrays, self.eval_caps, sorted_points=sorted_points,
                    fov_caps=self.eval_fov_caps,
                )
                check_capacity(topo, self.eval_caps, self.eval_fov_caps, over_ranks=True)
                yield arrays.get("main", arrays), meta, eval_logits(self.model, arrays, topo)

    def _eval_rows(self, arrays: dict, logits: torch.Tensor):
        """(predicted labels, labels, valid) of a batch's rows."""
        labels = arrays["labels_t"]
        valid = torch.arange(labels.shape[0], device=self.device) < arrays["num_points_t"]
        return logits.argmax(-1), labels, valid

    def _point_hist(self, pred: torch.Tensor, sample) -> torch.Tensor:
        labels = torch.from_numpy(sample.raw_labels).to(pred.device)
        return confusion_hist(pred, labels, labels != 0, self.num_class)

    def _point_predictions(self, tta_votes: int, save_score: bool):
        """Yields (sample, predicted labels, logits to save or None) of
        each val scan; with tta_votes > 0 the argmax of its votes."""
        if tta_votes <= 0:
            for _, meta, logits in self._eval_batches(self.val_loader):
                for m in meta:
                    for sample, pt in point_logits(logits, m["offsets"], m["samples"], m.get("padded")):
                        yield sample, pt.argmax(-1), pt if save_score else None
            return
        for per_vote in self.val_loader.iter_tta(tta_votes):
            votes: dict = {}
            scans: dict = {}
            for _, meta, logits in self._eval_batches(per_vote):
                for m in meta:
                    for sample, pt in point_logits(logits, m["offsets"], m["samples"], m.get("padded")):
                        prob = torch.softmax(pt.float(), dim=-1)
                        votes[sample.name] = votes[sample.name] + prob if sample.name in votes else prob
                        scans[sample.name] = sample
            for name, prob in votes.items():
                yield scans[name], prob.argmax(-1), None

    def evaluate_points(
        self,
        *,
        tta_votes: int = 0,
        save_path=None,
        save_score: bool = False,
    ) -> dict:
        """Per-raw-point evaluation over the val loader (JAX
        `engine.py:750`); with tta_votes > 0, deterministic rotation votes
        (`VoxelLoader.iter_tta`) are softmaxed in f32 and summed per scan,
        one batch of scans at a time (reference train.py:452-611).  With
        `save_path`, each scan's predictions are written in its dataset's
        submission format (`save_scan`).  Padding repeats of the last
        batch are skipped."""
        hist = torch.zeros((self.num_class, self.num_class), dtype=torch.int64, device=self.device)
        n_scans = 0

        for sample, pred, logits in self._point_predictions(tta_votes, save_score):
            hist += self._point_hist(pred, sample)
            if save_path is not None:
                save_scan(save_path, sample, pred.cpu().numpy(),
                          None if logits is None else logits.cpu().numpy())
            n_scans += 1
        hist = parallel.sum_over_ranks(hist).cpu().numpy()
        n_scans = int(parallel.sum_over_ranks(torch.tensor(n_scans, device=self.device)))
        miou = miou_from_hist(hist, ignore_index=0)
        self.logger.info(f"point-eval mIoU {miou:.2f} over {n_scans} scans")
        return {"miou": miou, "hist": hist}

    def evaluate(self, class_names=None) -> dict:
        """Voxel-level confusion histogram over the val loader, summed per
        batch, with the per-class IoU and confusion tables in the log."""
        hist = torch.zeros((self.num_class, self.num_class), dtype=torch.int64, device=self.device)
        t0 = time.perf_counter()
        n_batches = 0
        for arrays, _meta, logits in self._eval_batches(self.val_loader):
            pred, labels, valid = self._eval_rows(arrays, logits)
            hist += confusion_hist(pred, labels, valid & (labels != 0), self.num_class)
            n_batches += 1
        hist = parallel.sum_over_ranks(hist).cpu().numpy()
        dt = time.perf_counter() - t0
        iou = per_class_iou(hist)
        miou = miou_from_hist(hist, ignore_index=0)
        self.writer.scalar("eval/miou", miou, self.optimizer.count)
        names = class_names or [f"class_{i}" for i in range(self.num_class)]
        lines = [
            f"  {names[i]:<20s} IoU {100 * iou[i]:6.2f}"
            for i in range(1, self.num_class)
            if np.isfinite(iou[i])
        ]
        self.logger.info(
            "eval per-class IoU:\n" + "\n".join(lines) + f"\nmIoU {miou:.2f} "
            f"({n_batches} batches, {dt:.1f}s)"
        )
        self.logger.info(
            "row-normalized confusion matrix:\n" + format_confusion(hist, names)
        )
        return {"miou": miou, "hist": hist, "iou": iou}
