"""Entry points of the port: `Segmenter` (inference) and `Trainer` (the
train step).

`Segmenter` is the counterpart of the eval path of
`taseg_tpu/engine.py:693-747` and of what `bench.py:131-333` measures.

`Segmenter(cfg, params, device=None).predict(scans)` takes reader dicts
(`xyzret` (N, >=4) float32, `labels` (N,)) and returns, per scan, the
per-raw-point logits and labels.  A batch goes through four stages:

  1. host:     VoxelPipeline(training=False) + collate_shard (numpy);
  2. topology: build_unet_topology(assume_sorted_points=True);
  3. forward:  MinkUNet in the compute dtype;
  4. mapping:  logits[offsets[b]:offsets[b+1]][inverse_map] per scan.

A level whose voxel count exceeds its capacity raises (engine.py:607
only warns; a serving path must not return degraded labels).

`Trainer` is the counterpart of one call of the JAX step
(`taseg_tpu/parallel/__init__.py:120 make_train_step`) on one device,
wired as `taseg_tpu/engine.py:179-228` wires it; see its docstring.
"""

from __future__ import annotations

import torch

from ._device import resolve_device
from .data.voxel_dataset import VoxelPipeline, collate_shard
from .loss import Losses
from .models.voxel.backbone_context import UNetCapacities, build_unet_topology
from .models.voxel.minkunet import MinkUNet
from .optim import build_optimizer
from .utils.params_from_jax import load_flax_params

# padded points per scan: 120k-point scans with ~9% headroom (bench.py)
POINTS_PER_SCAN = 131072


def check_capacity(topo, caps: UNetCapacities) -> list:
    """The per-level voxel counts; raises where one exceeds its
    capacity (the JAX engine only warns and drops the excess voxels)."""
    nums = torch.stack([l.num for l in topo.levels]).tolist()
    for l, (n, cap) in enumerate(zip(nums, caps.voxels)):
        if n > cap:
            raise RuntimeError(
                f"capacity overflow at level {l}: {n} voxels > {cap}; "
                f"raise the point capacity or lower the batch size"
            )
    return nums


def to_device(arrays: dict, device, keys=("point_coords", "point_feats")) -> dict:
    """Add `<key>_t` device tensors of the collated numpy arrays, and
    `num_points_t` (a 0-dim int32)."""
    for k in keys:
        arrays[k + "_t"] = torch.from_numpy(arrays[k]).to(device)
    arrays["num_points_t"] = torch.from_numpy(arrays["num_points"].reshape(())).to(device)
    return arrays


class Segmenter:
    """MinkUNet inference on one device.

    cfg: dict with the YAML's layout (`configs.py`).  params: the flax
    variables as numpy trees, `{"params": ..., "batch_stats": ...}`
    (`utils.params_from_jax.init_params_numpy` draws them from a seed).
    """

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
        self.point_capacity = point_capacity or POINTS_PER_SCAN * batch_size
        # MODEL.CAPACITY_SCHEDULE: per-level voxel-capacity fractions of
        # the point capacity, as in the JAX engine
        self.caps = UNetCapacities.for_points(
            self.point_capacity,
            schedule=cfg["MODEL"].get("CAPACITY_SCHEDULE"),
        )
        self.pipeline = VoxelPipeline(
            voxel_size=cfg["DATA"]["VOXEL_SIZE"],
            training=False,
            in_feature_dim=cfg["MODEL"].get("IN_FEATURE_DIM", 4),
        )
        self.model = MinkUNet.from_cfg(
            cfg, device=self.device, compute_dtype=compute_dtype
        )
        load_flax_params(self.model, params["params"], params["batch_stats"])
        self.model.eval()

    def collate(self, scans: list) -> dict:
        """Host stage: quantize, dedup, key-sort and pad the scans into
        one shard, and move the arrays to the device."""
        arrays = collate_shard(
            [self.pipeline(s) for s in scans], self.point_capacity
        )
        return to_device(arrays, self.device)

    def topology(self, arrays: dict):
        return build_unet_topology(
            arrays["point_coords_t"], arrays["num_points_t"], self.caps,
            assume_sorted_points=self.pipeline.sorted_points,
        )

    def check_capacity(self, topo) -> None:
        check_capacity(topo, self.caps)

    @torch.no_grad()
    def forward(self, arrays: dict, topo) -> torch.Tensor:
        return self.model(arrays["point_feats_t"], topo)

    def map_to_points(self, arrays: dict, logits: torch.Tensor) -> list:
        out = []
        offsets = arrays["offsets"]
        for b, s in enumerate(arrays["samples"]):
            rows = logits[int(offsets[b]) : int(offsets[b + 1])]
            inv = torch.from_numpy(s.inverse_map).to(self.device).long()
            pt = rows[inv]
            out.append(
                {
                    "logits": pt.cpu().numpy(),
                    "labels": pt.argmax(1).to(torch.int32).cpu().numpy(),
                }
            )
        return out

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


class Trainer:
    """The MinkUNet train step on one device.

    cfg: dict with the YAML's layout (`configs.py`), including OPTIM;
    MODEL.TRAIN_CAPACITY_SCHEDULE, where present, replaces
    CAPACITY_SCHEDULE (augmented scans fill the coarse levels more).
    params: the flax variables as numpy trees, as for `Segmenter`.  The
    LR is OPTIM.LR_PER_SAMPLE x `batch_size` (scans per step), on the
    warmup-cosine schedule over `iters_per_epoch` x `total_epochs` steps.

    `step(scans)` runs, for `batch_size` reader dicts:
      1. host:      VoxelPipeline(training=True) with a numpy generator
                    seeded by `seed`, then collate_shard;
      2. topology:  build_unet_topology(devox_pairs=True,
                    assume_sorted_points=True); a level over capacity
                    raises;
      3. forward:   MinkUNet in train mode (masked batch statistics), then
                    the criterion (MODEL.LOSS_CONFIG: CE with label
                    smoothing + Lovász, ignore MODEL.IGNORE_LABEL);
      4. backward:  autograd through the hand kernels' Functions;
      5. optimizer: global-norm clip, weight decay, SGD with Nesterov
                    (`optim.ClippedSGD`),
    and returns {"loss", "grad_norm" (before the clip), "lr" (the LR this
    step applied), "level_nums"}.  Dropout p > 0 is not ported and
    raises.
    """

    def __init__(
        self,
        cfg: dict,
        params: dict,
        device=None,
        *,
        iters_per_epoch: int,
        total_epochs: int,
        batch_size: int = 1,
        seed: int = 0,
        compute_dtype: str = None,
        point_capacity: int = None,
    ):
        m, optim = cfg["MODEL"], cfg["OPTIM"]
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.point_capacity = point_capacity or POINTS_PER_SCAN * batch_size
        self.caps = UNetCapacities.for_points(
            self.point_capacity,
            schedule=m.get("TRAIN_CAPACITY_SCHEDULE", m.get("CAPACITY_SCHEDULE")),
        )
        self.pipeline = VoxelPipeline(
            voxel_size=cfg["DATA"]["VOXEL_SIZE"],
            training=True,
            in_feature_dim=m.get("IN_FEATURE_DIM", 4),
            seed=seed,
        )
        self.model = MinkUNet.from_cfg(
            cfg, device=self.device, compute_dtype=compute_dtype
        )
        if self.model.dropout_p > 0:
            raise NotImplementedError(
                f"MODEL.DROPOUT_P = {self.model.dropout_p}: training with "
                f"Dropout is not ported; p = 0 is"
            )
        load_flax_params(self.model, params["params"], params["batch_stats"])
        self.model.train()
        lr = float(optim["LR_PER_SAMPLE"]) * batch_size
        self.optimizer = build_optimizer(
            self.model.parameters(), {**optim, "LR": lr}, iters_per_epoch,
            total_epochs, clip_grad_norm=float(optim.get("GRAD_NORM_CLIP", 10.0)),
        )
        loss_cfg = m.get(
            "LOSS_CONFIG",
            {"LOSS_TYPES": ["CELoss", "LovLoss"], "LOSS_WEIGHTS": [1.0, 1.0]},
        )
        self.criterion = Losses(
            loss_cfg["LOSS_TYPES"], loss_cfg["LOSS_WEIGHTS"],
            ignore_index=int(m.get("IGNORE_LABEL", 0)),
            label_smoothing=float(m.get("LABEL_SMOOTHING", 0.0)),
        )

    def collate(self, scans: list) -> dict:
        """Host stage: augment, quantize, dedup, key-sort and pad the scans
        into one shard, and move the arrays to the device."""
        arrays = collate_shard(
            [self.pipeline(s) for s in scans], self.point_capacity
        )
        return to_device(arrays, self.device, ("point_coords", "point_feats", "labels"))

    def topology(self, arrays: dict):
        return build_unet_topology(
            arrays["point_coords_t"], arrays["num_points_t"], self.caps,
            devox_pairs=True, assume_sorted_points=self.pipeline.sorted_points,
        )

    def forward(self, arrays: dict, topo) -> torch.Tensor:
        """The loss of the shard (f32 scalar, with its graph)."""
        logits = self.model(arrays["point_feats_t"], topo)
        p = logits.shape[0]
        pvalid = torch.arange(p, device=self.device) < arrays["num_points_t"]
        return self.criterion(logits, arrays["labels_t"].long(), pvalid)

    def backward(self, loss: torch.Tensor) -> None:
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()

    def update(self):
        """(global grad norm before the clip, LR applied)."""
        return self.optimizer.step()

    def train_on(self, arrays: dict) -> dict:
        """Topology, forward, loss, backward and update on a collated
        shard (`collate`)."""
        topo = self.topology(arrays)
        level_nums = check_capacity(topo, self.caps)
        loss = self.forward(arrays, topo)
        self.backward(loss)
        g_norm, lr = self.update()
        return {
            "loss": float(loss.detach()), "grad_norm": float(g_norm), "lr": lr,
            "level_nums": level_nums,
        }

    def step(self, scans: list) -> dict:
        """One train step on `batch_size` reader dicts."""
        return self.train_on(self.collate(scans))
