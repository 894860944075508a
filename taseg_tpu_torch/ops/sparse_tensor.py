"""Static-capacity sparse tensors (port of `taseg_tpu/ops/sparse_tensor.py`).

`SparseGrid` is one stride level of a batch of sparse voxels and
`PointSet` a padded batch of points: fixed row capacities, valid rows
first, a 0-dim int32 count.  JAX's frozen pytrees become frozen
dataclasses; `stride` stays a plain int.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class SparseGrid:
    """A batch of sparse voxels at one stride level.

    coords: (V, 4) int32 (x, y, z, batch); rows past `num` are zero padding.
    feats:  (V, C)
    num:    () int32 — number of valid rows (valid rows come first).
    stride: tensor stride (voxel edge length in stride-1 units).
    """

    coords: torch.Tensor
    feats: torch.Tensor
    num: torch.Tensor
    stride: int = 1

    @property
    def capacity(self) -> int:
        return self.coords.shape[0]

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, dtype=torch.int32, device=self.coords.device) < self.num

    def with_feats(self, feats: torch.Tensor) -> "SparseGrid":
        return replace(self, feats=feats)


@dataclass(frozen=True)
class PointSet:
    """A padded batch of points (pre-voxelization / interpolation targets).

    coords: (P, 4) float32 (x, y, z, batch) in stride-1 voxel units.
    feats:  (P, C)
    num:    () int32 — number of valid rows.
    """

    coords: torch.Tensor
    feats: torch.Tensor
    num: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.coords.shape[0]

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, dtype=torch.int32, device=self.coords.device) < self.num
