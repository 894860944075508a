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
up conv), the trilinear pair tables and the head's three pair tables
stacked for one K6 backward (`devox_head`).  Every topology carries each
level's row order (`k3_order`, `mask_row_order` of the 3^3 rulebook),
which the tensor-core routes of the 3^3 convs read (K2's wgmma tile in
bf16, K2 and K4 at K = 27 on 3xTF32 in f32, `sparse_conv.k3_conv`), and
between two levels the child table of K3-down with its row order
(`StridedTables.child`, `child_order`: K3-down as a conv over 8 offsets,
shared by the down conv and the up conv's input gradient) and the up
table of K3-up with its row order (`StridedTables.up`, `up_order`: K3-up
as a conv over 8 offsets, shared by the up conv and the down conv's
input gradient).  With
`point_voxel_strides`
(SPVCNN's (1, 4, 16)) it adds the point -> voxel tables of the point
branch (`UNetTopology.point_vox`).  Left out against the JAX package: the
TGF gather plans (the port's conv takes the rulebook directly).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from ...ops.coords import GridBounds, compute_bounds
from ...ops.f3conv import PairLists, k3_pair_lists
from ...ops.join import unique_coords
from ...ops.rulebook import build_rulebook_k3, spdownsample
from ...ops.sparse_conv import KTable, flip_rulebook, mask_row_orders
from ...ops.strided_conv import (
    StridedTables,
    build_strided_tables,
    slot_child_table,
    slot_pair_lists,
    slot_up_table,
)
from ...ops.voxelize import (
    IdentityDevoxTable,
    SegmentTables,
    StackedDevox,
    build_segment_tables,
    stack_devox_tables,
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
    # mask_row_order(rb_k3), shared by rb_k3_bwd (a flip maps equal
    # offset masks to equal masks)
    k3_order: Optional[torch.Tensor] = None


@dataclass(frozen=True)
class UNetTopology:
    levels: tuple  # LevelTopo per stride 1, 2, 4, ..., 2^(L-1)
    point_inverse: torch.Tensor  # (P,) point -> level-0 voxel id (-1)
    point_tables: SegmentTables  # for the initial average voxelization
    devox: dict  # stride (1, 4, 16) -> devox table of the head
    bounds: GridBounds
    num_points: torch.Tensor  # () int32: the valid point rows
    # stride -> (inverse (P,) int32 point -> voxel of that stride or -1,
    # its SegmentTables); empty unless built with point_voxel_strides
    point_vox: dict
    # the head's pair tables at strides (16, 4, 1) stacked for one K6
    # backward (`stack_devox_tables`); None in inference topologies
    devox_head: Optional[StackedDevox] = None


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


def host_nonneg(point_coords) -> bool:
    """Whether every row of a collated (P, 4) numpy coordinate array,
    padding rows (zeros) included, has non-negative x, y and z: read on
    the host before the upload, so `build_unet_topology(nonneg_coords=)`
    reads nothing back from the device."""
    return bool((point_coords[:, :3] >= 0).all())


def build_unet_topology(
    point_coords: torch.Tensor,
    num_points: torch.Tensor,
    caps: UNetCapacities,
    *,
    devox_pairs: bool = False,
    assume_sorted_points: bool = False,
    point_voxel_strides: tuple = (),
    nonneg_coords: bool = False,
) -> UNetTopology:
    """Build the MinkUNet topology from point coords (P, 4) on their
    device: one level per entry of `caps.voxels`, devox tables for the
    head's strides 1, 4 and 16.  `num_points` is a 0-dim int32 tensor.
    The points are integer voxel coords (the host pipeline's contract),
    so stride 1 devoxelizes by the identity gather.  `devox_pairs` adds
    the tables that only the backward reads (training).  Each level's
    `k3_order`, child table order and up table order take one batched
    stable sort per level size, on the device.  `nonneg_coords` says the caller's coordinates
    are non-negative (`host_nonneg`; the host pipelines shift them): every
    coarse cell then has at most one child per slot and each child table
    is one scatter with nothing read back; else its rounds are counted
    with one host read per level.  `point_voxel_strides` (a subset of
    SPVCNN's (1, 4, 16)) adds, per stride s, each point's stride-s voxel
    (the floor voxel, corner 0 of its trilinear corners) and the segment
    tables over it (JAX `backbone_context.py:326-337`)."""
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
        child = slot_child_table(strided, rounds=1 if nonneg_coords else None)
        strided = replace(strided, child=child, up=slot_up_table(strided))
        levels.append(level(coords_l, num_l, 2**l, strided))
        prev_coords, prev_num = coords_l, num_l
    # one batched sort per level size: a level's 3^3 rulebook, the
    # one-round child table into it (V_l rows) and the up table out of the
    # next level into it (V_l fine rows) share it (a child table of several
    # rounds takes K3-down's round kernels, which read no order)
    ordered = [l for l in range(1, num_levels) if levels[l].strided.child.shape[0] == 1]
    orders = mask_row_orders(
        [lt.rb_k3 for lt in levels]
        + [levels[l].strided.child[0] for l in ordered]
        + [lt.strided.up for lt in levels[1:]]
    )
    levels = [replace(lt, k3_order=o) for lt, o in zip(levels, orders)]
    child_orders = dict(zip(ordered, orders[num_levels : num_levels + len(ordered)]))
    up_orders = orders[num_levels + len(ordered) :]
    for l in range(1, num_levels):
        levels[l] = replace(levels[l], strided=replace(
            levels[l].strided, child_order=child_orders.get(l), up_order=up_orders[l - 1],
        ))

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

    # point -> stride-s voxel: the containing (floor) voxel is corner 0
    # of the trilinear corners, already gathered for strides 4 and 16
    point_vox = {}
    for s in point_voxel_strides:
        if s == 1:
            point_vox[s] = (inverse, point_tables)
            continue
        if s not in corner_strides:
            raise ValueError(f"point_voxel_strides: {s} is not one of 1, {corner_strides}")
        inv_s = g[:, 8 * corner_strides.index(s)].contiguous()
        rows = levels[s.bit_length() - 1].coords.shape[0]
        point_vox[s] = (inv_s, build_segment_tables(inv_s, rows))

    return UNetTopology(
        levels=tuple(levels),
        point_inverse=inverse,
        point_tables=point_tables,
        devox=devox,
        bounds=bounds,
        num_points=num_points,
        point_vox=point_vox,
        devox_head=stack_devox_tables(head_tables(devox)) if devox_pairs else None,
    )


def head_tables(devox: dict) -> tuple:
    """The MinkUNet head's devox tables, in its scale order (x4 at
    stride 16, y2 at 4, y4 at 1)."""
    return devox[16], devox[4], devox[1]


def conv_tables(topo: UNetTopology, train: bool) -> list:
    """Each level's 3^3 conv tables as the conv modules take them:
    `KTable(rb_k3, k3_order)`, in training with the reverse table
    `KTable(rb_k3_bwd, k3_order, k3_pairs)` beside it (the topology needs
    `devox_pairs=True` then)."""
    fwd = [KTable(l.rb_k3, l.k3_order) for l in topo.levels]
    if not train:
        return fwd
    return [(f, KTable(l.rb_k3_bwd, l.k3_order, l.k3_pairs)) for f, l in zip(fwd, topo.levels)]
