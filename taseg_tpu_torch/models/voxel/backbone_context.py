"""Per-batch topology precomputation for sparse UNet backbones (port of
`taseg_tpu/models/voxel/backbone_context.py`).

`build_unet_topology` builds every integer structure of a MinkUNet
forward once, from the input coordinates alone: the unique voxel set of
each stride level, the same-level 3^3 rulebooks, the parent relation
between levels (the strided conv pair) and the point<->voxel tables.
The forward then touches only gathers, segment sums and matmuls.

With `devox_pairs=True` (training) it also builds the backward-only
tables: one flipped rulebook per level (`rb_k3_bwd`, the JAX
`ConvPlan.rb_bwd`, built once per step and shared by every conv of the
level), the level's present pairs of it compacted per offset
(`k3_pairs`, the pair lists of K4's tensor-core route, likewise shared),
the parent relation's pairs compacted per slot (`StridedTables.pairs`,
the pair lists of K5's tensor-core route, shared by the level's down and
up conv) and the trilinear pair tables.  Left out against the JAX package:
the TGF gather plans (the port's conv takes the rulebook directly) and
SPVCNN's `point_vox` tables.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from ...ops.coords import GridBounds, compute_bounds
from ...ops.f3conv import PairLists, k3_pair_lists
from ...ops.join import unique_coords
from ...ops.rulebook import build_rulebook_k3, spdownsample
from ...ops.sparse_conv import flip_rulebook
from ...ops.strided_conv import StridedTables, build_strided_tables, slot_pair_lists
from ...ops.voxelize import (
    IdentityDevoxTable,
    SegmentTables,
    build_segment_tables,
    trilinear_table,
)


@dataclass(frozen=True)
class UNetCapacities:
    """Static row capacities. `points` bounds the padded input point
    count; `voxels[l]` bounds the unique voxel count at stride 2**l.
    Overflow shows as LevelTopo.num > capacity."""

    points: int
    voxels: tuple

    # stride-level occupancy fractions of the padded point capacity
    DEFAULT_SCHEDULE = (1.0, 0.60, 0.22, 0.09, 0.035)

    @staticmethod
    def for_points(
        points: int, num_levels: int = 5, schedule=None
    ) -> "UNetCapacities":
        sched = schedule or UNetCapacities.DEFAULT_SCHEDULE
        voxels = tuple(
            max(
                512,
                (int(points * sched[min(l, len(sched) - 1)]) + 255)
                // 256
                * 256,
            )
            for l in range(num_levels)
        )
        return UNetCapacities(points=points, voxels=voxels)

    @staticmethod
    def fit(points: int, level_nums, margin: float = 1.15) -> "UNetCapacities":
        """Capacities fitted to measured per-level voxel counts + margin
        (256-aligned, never above the point capacity)."""
        voxels = tuple(
            min(
                max(512, (int(n * margin) + 255) // 256 * 256),
                (points + 255) // 256 * 256,
            )
            for n in level_nums
        )
        return UNetCapacities(points=points, voxels=voxels)


@dataclass(frozen=True)
class LevelTopo:
    coords: torch.Tensor  # (V_l, 4) int32, key-sorted valid-first
    num: torch.Tensor  # () int32
    rb_k3: torch.Tensor  # (27, V_l) same-level 3^3 rulebook
    # parent relation to the 2x-finer level: serves the down conv INTO
    # this level and the transposed conv back out of it; None at level 0
    strided: Optional[StridedTables] = None
    # flip_rulebook(rb_k3) for the backward; None in inference topologies
    rb_k3_bwd: Optional[torch.Tensor] = None
    # k3_pair_lists(rb_k3_bwd): K4's pair lists; None in inference
    k3_pairs: Optional[PairLists] = None


@dataclass(frozen=True)
class UNetTopology:
    levels: tuple  # LevelTopo per stride 1, 2, 4, ..., 2^(L-1)
    point_inverse: torch.Tensor  # (P,) point -> level-0 voxel id (-1)
    point_tables: SegmentTables  # for the initial average voxelization
    devox: dict  # stride (1, 4, 16) -> devox table of the head
    bounds: GridBounds


def _pattern_cols(m: int) -> list:
    """Rulebook columns of the trilinear corners under delta0 pattern m;
    corner k = 4*jx + 2*jy + jz (kernel_offsets(2) enumeration), column
    = x-fastest (o+1) with o = delta0 + j."""
    d0 = (-((m >> 2) & 1), -((m >> 1) & 1), -(m & 1))
    return [
        (d0[0] + ((k >> 2) & 1) + 1)
        + 3 * (d0[1] + ((k >> 1) & 1) + 1)
        + 9 * (d0[2] + (k & 1) + 1)
        for k in range(8)
    ]


def build_unet_topology(
    point_coords: torch.Tensor,
    num_points: torch.Tensor,
    caps: UNetCapacities,
    *,
    devox_pairs: bool = False,
    assume_sorted_points: bool = False,
) -> UNetTopology:
    """Build the MinkUNet topology from point coords (P, 4) on their
    device: one level per entry of `caps.voxels`, devox tables for the
    head's strides 1, 4 and 16.  `num_points` is a 0-dim int32 tensor.
    The points are integer voxel coords (the host pipeline's contract),
    so stride 1 devoxelizes by the identity gather.  `devox_pairs` adds
    the tables that only the backward reads (training)."""
    num_levels = len(caps.voxels)
    dev = point_coords.device
    p = point_coords.shape[0]
    num_points = torch.as_tensor(num_points, dtype=torch.int32, device=dev)
    valid = torch.arange(p, dtype=torch.int32, device=dev) < num_points
    vox0 = torch.cat(
        [
            torch.floor(point_coords[:, :3]).to(torch.int32),
            point_coords[:, 3:4].to(torch.int32),
        ],
        dim=1,
    )
    bounds = compute_bounds(vox0, valid, margin=64)

    # assume_sorted_points: the host pipeline emits key-sorted scans, so
    # the level-0 unique skips its sort (and checks the order)
    coords0, num0, inverse, _ = unique_coords(
        vox0, valid, bounds, caps.voxels[0], assume_sorted=assume_sorted_points
    )
    point_tables = build_segment_tables(inverse, caps.voxels[0])

    def level(coords, num, stride, strided=None):
        rb = build_rulebook_k3(coords, num, stride, bounds)
        if not devox_pairs:
            return LevelTopo(coords=coords, num=num, rb_k3=rb, strided=strided)
        rb_bwd = flip_rulebook(rb)
        return LevelTopo(
            coords=coords, num=num, rb_k3=rb, strided=strided,
            rb_k3_bwd=rb_bwd, k3_pairs=k3_pair_lists(rb_bwd),
        )

    levels = [level(coords0, num0, 1)]
    prev_coords, prev_num = coords0, num0
    for l in range(1, num_levels):
        s_prev = 2 ** (l - 1)
        coords_l, num_l, parent, counts, perm = spdownsample(
            prev_coords, prev_num, 2, s_prev, bounds, caps.voxels[l],
            return_inverse=True,
        )
        strided = build_strided_tables(
            prev_coords, prev_num, parent, counts, perm, s_prev
        )
        if devox_pairs:
            strided = replace(strided, pairs=slot_pair_lists(strided))
        levels.append(level(coords_l, num_l, 2**l, strided))
        prev_coords, prev_num = coords_l, num_l

    # point -> coarse-voxel corner rows without joins: chase the parent
    # chain, then read the 8 trilinear corners out of the level's k3
    # rulebook.  Runs per level-0 voxel (floor(x/s) == floor(floor(x)/s))
    # and is gathered to points through `inverse` once.
    ancestors = [torch.arange(coords0.shape[0], dtype=torch.int32, device=dev)]
    for l in range(1, num_levels):
        prev = ancestors[-1]
        parent = levels[l].strided.parent
        ancestors.append(
            torch.where(prev >= 0, parent[prev.clamp(min=0).long()], -1)
        )
    pattern_cols = torch.tensor(
        [_pattern_cols(m) for m in range(8)], dtype=torch.int64, device=dev
    )

    def corner_v(l: int) -> torch.Tensor:
        """(V0, 8) rulebook corner rows per level-0 voxel (-1 absent).
        delta0 = (floor - trunc) ancestor mismatch per axis is in {-1, 0},
        so one of 8 column patterns applies."""
        s = 2**l
        anc = ancestors[l]
        safe = anc.clamp(min=0).long()
        pf = (coords0[:, :3] // s) * s  # floor division: exact at negatives
        t = levels[l].coords[safe, :3]
        delta0 = (pf - t) // s  # {-1, 0} per axis
        pat = (-delta0[:, 0]) * 4 + (-delta0[:, 1]) * 2 + (-delta0[:, 2])
        pat = pat.clamp(0, 7)  # rows with anc < 0 are masked below
        block = levels[l].rb_k3.t()[safe]  # (V0, 27)
        cv = torch.gather(block, 1, pattern_cols[pat.long()])
        return torch.where((anc >= 0)[:, None], cv, -1)

    # host-deduped integer points: trilinear at stride 1 collapses to the
    # identity gather through the inverse map
    devox = {1: IdentityDevoxTable(inverse=inverse, tables=point_tables)}
    corner_strides = (4, 16)
    cat = torch.cat([corner_v(s.bit_length() - 1) for s in corner_strides], dim=1)
    g = cat[inverse.clamp(min=0).long()]  # (P, 8 * strides)
    g = torch.where(((inverse >= 0) & valid)[:, None], g, -1)
    for i, s in enumerate(corner_strides):
        l = s.bit_length() - 1
        devox[s] = trilinear_table(
            point_coords, valid, levels[l].coords, levels[l].num, s, bounds,
            with_pairs=devox_pairs, corner_idx=g[:, 8 * i : 8 * (i + 1)].t(),
        )

    return UNetTopology(
        levels=tuple(levels),
        point_inverse=inverse,
        point_tables=point_tables,
        devox=devox,
        bounds=bounds,
    )
