"""Inference entry point of the port (counterpart of the eval path of
`taseg_tpu/engine.py:693-747` and of what `bench.py:131-333` measures).

`Segmenter(cfg, params, device=None).predict(scans)` takes reader dicts
(`xyzret` (N, >=4) float32, `labels` (N,)) and returns, per scan, the
per-raw-point logits and labels.  A batch goes through four stages:

  1. host:     VoxelPipeline(training=False) + collate_shard (numpy);
  2. topology: build_unet_topology(assume_sorted_points=True);
  3. forward:  MinkUNet in the compute dtype;
  4. mapping:  logits[offsets[b]:offsets[b+1]][inverse_map] per scan.

A level whose voxel count exceeds its capacity raises (engine.py:607
only warns; a serving path must not return degraded labels).
"""

from __future__ import annotations

import torch

from ._device import resolve_device
from .data.voxel_dataset import VoxelPipeline, collate_shard
from .models.voxel.backbone_context import UNetCapacities, build_unet_topology
from .models.voxel.minkunet import MinkUNet
from .utils.params_from_jax import load_flax_params

# padded points per scan: 120k-point scans with ~9% headroom (bench.py)
POINTS_PER_SCAN = 131072


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
        for k in ("point_coords", "point_feats"):
            arrays[k + "_t"] = torch.from_numpy(arrays[k]).to(self.device)
        arrays["num_points_t"] = torch.from_numpy(
            arrays["num_points"].reshape(())
        ).to(self.device)
        return arrays

    def topology(self, arrays: dict):
        return build_unet_topology(
            arrays["point_coords_t"], arrays["num_points_t"], self.caps,
            assume_sorted_points=self.pipeline.sorted_points,
        )

    def check_capacity(self, topo) -> None:
        nums = torch.stack([l.num for l in topo.levels]).tolist()
        for l, (n, cap) in enumerate(zip(nums, self.caps.voxels)):
            if n > cap:
                raise RuntimeError(
                    f"capacity overflow at level {l}: {n} voxels > {cap}; "
                    f"raise the point capacity or lower the batch size"
                )

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
