"""Cylinder3D (torchsparse variant) — polar-grid asymmetric sparse UNet
(port of `taseg_tpu/models/voxel/cylinder3d.py`, train and eval forms;
reference `pcseg/model/segmentor/voxel/cylinder3d/cylinder_ts.py`).

  * a point MLP pre-net (BN / Dense stack to 256) and a 16-channel
    compression, max-pooled into the level-0 voxels (`ops.voxelize.
    segment_max`, JAX's `jax.ops.segment_max` with its gradient);
  * asymmetric-kernel blocks: context and residual blocks run (1,3,3) and
    (3,1,3) convs (K = 9); a sigmoid-gated ReconBlock of (3,1,1), (1,3,1)
    and (1,1,3) convs (K = 3);
  * anisotropic pooling: 4 levels at tensor strides `CYL_STRIDES`, the
    last two pooling only in (rho, phi) — pooling convs with the kernel
    equal to the step (K = 8, then 4), transposed convs back over the
    reverse tables;
  * a 3^3 conv head with a bias (K = 27, JAX's F3 route) on the
    concatenated ReconBlock output and last decoder feature, and a
    point-refinement head on the voxel features gathered to the rows.

Every conv other than the 1x1 projections, the 3^3 head included, is the
conv over K offsets (`ops.sparse_conv.conv_k`: K2 at K forward, K2 at K
and K4 at K backward), called with `KTable`s: each table with its row
order (`mask_row_order`) and, in train topologies, the pair lists of the
tables a weight gradient reads.  The model runs in f32, as JAX's (which
casts nothing); `models.build_segmentor` refuses another compute dtype.
Module and parameter names follow the flax tree (`downCntx/a_conv0/kernel`,
`res2/res/b_bn1/scale`, `up0_deconv/kernel`, `ReconNet/branch2/kernel`,
`logits/bias`, `pp_fc0/kernel`, ...), so `utils.params_from_jax` maps
the two one to one.

In train mode (`model.train()`) every BN takes its level's row mask and
the convs take (rulebook, reverse rulebook) pairs, so the topology must
come from `build_cylinder_topology(..., train=True)`, which adds the
flipped tables of the same-level convs (the pooling and transposed convs
read each other's table) and the pair lists.  Left out against JAX's
topology: the level-0 segment tables (nothing reads them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..._device import resolve_device
from ...ops.coords import GridBounds, compute_bounds
from ...ops.join import unique_coords
from ...ops.rulebook import (
    build_reverse_rulebook,
    build_rulebook,
    build_rulebook_k3,
    kernel_offsets,
    spdownsample,
)
from ...ops.f3conv import pair_lists_many
from ...ops.sparse_conv import KTable, flip_rulebook, mask_row_orders
from ...ops.voxelize import segment_max
from ..layers import Dense, MaskedBatchNorm, SparseConv
from ..range2d.blocks import leaky_relu

# per-level tensor strides: the last two stages pool only rho / phi
CYL_STRIDES = ((1, 1, 1), (2, 2, 2), (4, 4, 4), (8, 8, 4), (16, 16, 4))
ASYM_KERNELS = ((1, 3, 3), (3, 1, 3))
RECON_KERNELS = ((3, 1, 1), (1, 3, 1), (1, 1, 3))


def pool_step(l: int) -> tuple:
    """The pooling step into level `l` (1..4): (2,2,2) or (2,2,1)."""
    return tuple(CYL_STRIDES[l][d] // CYL_STRIDES[l - 1][d] for d in range(3))


@dataclass(frozen=True)
class CylLevel:
    coords: torch.Tensor  # (V_l, 4) int32, key-sorted, valid rows first
    num: torch.Tensor  # () int32
    rb_asym: tuple  # (9, V_l) rulebooks of ASYM_KERNELS
    # the pooling conv INTO this level, (K, V_l) over the finer level's
    # rows, and its reverse (K, V_finer) over this level's rows (the
    # transposed conv's forward table); None at level 0
    rb_down: Optional[torch.Tensor] = None
    rb_up: Optional[torch.Tensor] = None
    # flip_rulebook of each of rb_asym; None in inference topologies
    rb_asym_bwd: Optional[tuple] = None
    # the same tables as KTables (row orders; pair lists of the tables a
    # weight gradient reads in train topologies): rb_asym's, rb_asym_bwd's
    # (the order of rb_asym's table: a flip keeps rows with equal masks
    # equal), rb_down's and rb_up's
    asym: tuple = ()
    asym_bwd: Optional[tuple] = None
    down: Optional[KTable] = None
    up: Optional[KTable] = None


@dataclass(frozen=True)
class CylTopology:
    levels: tuple  # CylLevel per entry of CYL_STRIDES
    rb_recon: tuple  # level-0 (3, V_0) rulebooks of RECON_KERNELS
    rb_head: torch.Tensor  # level-0 (27, V_0) 3^3 rulebook
    point_inverse: torch.Tensor  # (P,) row -> level-0 voxel (-1)
    bounds: GridBounds
    num_points: torch.Tensor  # () int32: the valid rows
    # flipped rb_recon and rb_head; None in inference topologies
    rb_recon_bwd: Optional[tuple] = None
    rb_head_bwd: Optional[torch.Tensor] = None
    # KTables of rb_recon, rb_recon_bwd, rb_head, rb_head_bwd (as CylLevel's)
    recon: tuple = ()
    recon_bwd: Optional[tuple] = None
    head: Optional[KTable] = None
    head_bwd: Optional[KTable] = None


def build_cylinder_topology(
    point_coords: torch.Tensor,
    num_points: torch.Tensor,
    caps,
    *,
    train: bool = False,
) -> CylTopology:
    """Cylinder3D's topology from the rows' polar voxel coords (P, 4)
    (JAX `build_cylinder_topology`): the level-0 unique voxels, 4 pooled
    levels at `CYL_STRIDES` (capacities `caps.voxels`), per level the two
    asymmetric rulebooks, the pooling table and its reverse, and at level
    0 the three recon rulebooks and the 3^3 head rulebook (from the 9
    floor queries of `build_rulebook_k3`, equal to JAX's general build),
    each with its row order.  `train` adds the flipped tables that the
    backward reads and the pair lists of every table a weight gradient
    reads.  Everything stays on the device: nothing is read back."""
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
    coords0, num0, inverse, _ = unique_coords(vox0, valid, bounds, caps.voxels[0])

    def asym(coords, num, stride):
        return tuple(
            build_rulebook(coords, num, coords, num, kernel_offsets(ks, stride=stride), bounds)
            for ks in ASYM_KERNELS
        )

    raw = [(coords0, num0, asym(coords0, num0, CYL_STRIDES[0]), None, None)]
    prev_c, prev_n = coords0, num0
    for l in range(1, len(CYL_STRIDES)):
        s_prev = CYL_STRIDES[l - 1]
        step = pool_step(l)
        coords_l, num_l = spdownsample(prev_c, prev_n, step, s_prev, bounds, caps.voxels[l])
        offs = kernel_offsets(step, stride=s_prev)  # kernel = step
        rb_down = build_rulebook(coords_l, num_l, prev_c, prev_n, offs, bounds)
        rb_up = build_reverse_rulebook(prev_c, prev_n, coords_l, num_l, offs, bounds)
        raw.append((coords_l, num_l, asym(coords_l, num_l, CYL_STRIDES[l]), rb_down, rb_up))
        prev_c, prev_n = coords_l, num_l

    rb_recon = tuple(
        build_rulebook(coords0, num0, coords0, num0, kernel_offsets(ks, stride=1), bounds)
        for ks in RECON_KERNELS
    )
    rb_head = build_rulebook_k3(coords0, num0, 1, bounds)

    # every table's row order, and (train) the pair lists of every table a
    # weight gradient reads: the flipped same-level tables and both
    # pooling tables (each the other direction's reverse), batched by row
    # count.  A flipped table shares its table's order.
    same = [r for lv in raw for r in lv[2]] + [*rb_recon, rb_head]
    pools = [r for lv in raw[1:] for r in lv[3:]]
    orders = mask_row_orders(same + pools)
    n = len(same)
    if train:
        flips = [flip_rulebook(r) for r in same]
        lists = pair_lists_many(flips + pools)
        bwd = [KTable(f, o, p) for f, o, p in zip(flips, orders, lists)]
    else:
        lists = [None] * (n + len(pools))
        bwd = [None] * n
    fwd = [KTable(r, o) for r, o in zip(same, orders)]
    pooled = [KTable(r, o, p) for r, o, p in zip(pools, orders[n:], lists[n:])]

    levels = []
    for l, (coords, num, rbs, rb_down, rb_up) in enumerate(raw):
        a, b = fwd[2 * l : 2 * l + 2], bwd[2 * l : 2 * l + 2]
        levels.append(CylLevel(
            coords=coords, num=num, rb_asym=rbs, rb_down=rb_down, rb_up=rb_up,
            rb_asym_bwd=tuple(t.rb for t in b) if train else None,
            asym=tuple(a), asym_bwd=tuple(b) if train else None,
            down=pooled[2 * l - 2] if l else None, up=pooled[2 * l - 1] if l else None,
        ))
    i = 2 * len(raw)
    recon, recon_bwd = tuple(fwd[i : i + 3]), tuple(bwd[i : i + 3])
    return CylTopology(
        levels=tuple(levels), rb_recon=rb_recon, rb_head=rb_head,
        point_inverse=inverse, bounds=bounds, num_points=num_points,
        rb_recon_bwd=tuple(t.rb for t in recon_bwd) if train else None,
        rb_head_bwd=bwd[i + 3].rb if train else None,
        recon=recon, recon_bwd=recon_bwd if train else None,
        head=fwd[i + 3], head_bwd=bwd[i + 3],
    )


class AsymResContext(nn.Module):
    """Two parallel (1,3,3) -> (3,1,3) / (3,1,3) -> (1,3,3) paths of
    conv, BN and leaky ReLU, summed (cylinder_ts.py:88-156)."""

    def __init__(self, in_channels: int, features: int, device=None):
        super().__init__()
        for name in ("a", "b"):
            for i in range(2):
                c_in = in_channels if i == 0 else features
                self.add_module(f"{name}_conv{i}", SparseConv(c_in, features, 9, device=device))
                self.add_module(f"{name}_bn{i}", MaskedBatchNorm(features, device=device))

    def forward(self, x, rbs, mask):
        def path(order, name):
            h = x
            for i, k in enumerate(order):
                h = getattr(self, f"{name}_conv{i}")(h, rbs[k])
                h = leaky_relu(getattr(self, f"{name}_bn{i}")(h, mask))
            return h

        return path((0, 1), "a") + path((1, 0), "b")


class AsymResBlock(nn.Module):
    """AsymResContext plus the input, projected by a 1x1 conv where the
    widths differ."""

    def __init__(self, in_channels: int, features: int, device=None):
        super().__init__()
        self.res = AsymResContext(in_channels, features, device=device)
        self.proj = (
            SparseConv(in_channels, features, 1, device=device)
            if in_channels != features else None
        )

    def forward(self, x, rbs, mask):
        h = self.res(x, rbs, mask)
        return h + (x if self.proj is None else self.proj(x))


class ReconBlock(nn.Module):
    """Sigmoid-gated sum of three 1-D asymmetric conv branches
    (cylinder_ts.py:337-385)."""

    def __init__(self, features: int, device=None):
        super().__init__()
        for i in range(len(RECON_KERNELS)):
            self.add_module(f"branch{i}", SparseConv(features, features, 3, device=device))
            self.add_module(f"bn{i}", MaskedBatchNorm(features, device=device))

    def forward(self, x, rbs, mask):
        gate = None
        for i, rb in enumerate(rbs):
            h = torch.sigmoid(getattr(self, f"bn{i}")(getattr(self, f"branch{i}")(x, rb), mask))
            gate = h if gate is None else gate + h
        return gate * x


# the feature columns of the cylinder pipeline's rows
# (`data/cylinder_dataset.py`: offsets to the cell centre, rho, phi, z,
# x, y, intensity)
POINT_FEATURES = 9


class CylinderTS(nn.Module):
    """Cylinder_TS: `forward(point_feats (P, in_dim) f32, CylTopology)`
    -> per-row logits (P, num_classes) f32.  The pre-net reads
    min(in_dim, POINT_FEATURES) columns: JAX slices `feats[:, :in_dim]`
    of the pipeline's 9 and its layers take their widths from that slice
    (`cylinder3d.py:220`), so a recipe's IN_FEATURE_DIM of 10 (Waymo's)
    gives JAX 9-wide parameters, and the port the same."""

    def __init__(
        self,
        num_classes: int,
        in_dim: int = 9,
        init_size: int = 32,
        point_refinement: bool = True,
        device=None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.in_dim = in_dim = min(in_dim, POINT_FEATURES)
        self.point_refinement = point_refinement
        b = init_size
        add = self.add_module
        add("pp_bn0", MaskedBatchNorm(in_dim, device=dev))
        ch = in_dim
        for i, width in enumerate((64, 128, 256)):
            add(f"pp_fc{i}", Dense(ch, width, device=dev))
            add(f"pp_bn{i + 1}", MaskedBatchNorm(width, device=dev))
            ch = width
        add("pp_fc3", Dense(256, 256, device=dev))
        add("fea_compression", Dense(256, 16, device=dev))
        add("downCntx", AsymResContext(16, b, device=dev))
        widths = (2 * b, 4 * b, 8 * b, 16 * b)
        enc_ch = [b]
        ch = b
        for l in range(1, 5):
            k = int(np.prod(pool_step(l)))
            add(f"pool{l}", SparseConv(ch, widths[l - 1], k, device=dev))
            add(f"pool_bn{l}", MaskedBatchNorm(widths[l - 1], device=dev))
            add(f"res{l + 1}", AsymResBlock(widths[l - 1], widths[l - 1], device=dev))
            ch = widths[l - 1]
            enc_ch.append(ch)
        for i, l in enumerate((4, 3, 2, 1)):
            k = int(np.prod(pool_step(l)))
            out = (16 * b, 8 * b, 4 * b, 2 * b)[i]
            add(f"up{i}_deconv", SparseConv(ch, out, k, transposed=True, device=dev))
            add(f"up_bn{i}", MaskedBatchNorm(out, device=dev))
            add(f"up{i}_res", AsymResBlock(out + enc_ch[l - 1], out, device=dev))
            ch = out
        add("ReconNet", ReconBlock(2 * b, device=dev))
        add("logits", SparseConv(4 * b, num_classes, 27, use_bias=True, device=dev))
        if point_refinement:
            add("change_dim", Dense(4 * b, 256, device=dev))
            add("pr_bn", MaskedBatchNorm(256, device=dev))
            add("point_logits", Dense(256, num_classes, device=dev))

    def forward(self, point_feats: torch.Tensor, topo: CylTopology) -> torch.Tensor:
        levels = topo.levels
        p = point_feats.shape[0]
        pvalid = torch.arange(p, device=point_feats.device) < topo.num_points
        if self.training:
            masks = [
                torch.arange(l.coords.shape[0], device=l.num.device) < l.num
                for l in levels
            ]
            asym = [tuple(zip(l.asym, l.asym_bwd)) for l in levels]
            recon = tuple(zip(topo.recon, topo.recon_bwd))
            head = (topo.head, topo.head_bwd)
        else:
            masks = [None] * len(levels)
            asym = [l.asym for l in levels]
            recon = topo.recon
            head = topo.head

        # point pre-net (cylinder_ts.py:401-418)
        h = self.pp_bn0(point_feats[:, : self.in_dim], pvalid)
        for i in range(3):
            h = torch.relu(getattr(self, f"pp_bn{i + 1}")(getattr(self, f"pp_fc{i}")(h), pvalid))
        h = torch.relu(self.fea_compression(self.pp_fc3(h)))

        # max-pooled initial voxelization; the padding rows go to a dummy
        # segment, and an empty voxel (a padding row's) is 0
        v0 = levels[0].coords.shape[0]
        inv = topo.point_inverse
        seg = torch.where(inv >= 0, inv, v0)
        x0 = segment_max(torch.where(pvalid[:, None], h, float("-inf")), seg, v0 + 1)[:-1]
        x0 = torch.where(torch.isfinite(x0), x0, 0.0)

        x = self.downCntx(x0, asym[0], masks[0])
        enc = [x]
        for l in range(1, 5):
            lv = levels[l]
            x = getattr(self, f"pool{l}")(x, (lv.down, lv.up))
            x = leaky_relu(getattr(self, f"pool_bn{l}")(x, masks[l]))
            x = getattr(self, f"res{l + 1}")(x, asym[l], masks[l])
            enc.append(x)

        y = enc[4]
        for i, l in enumerate((4, 3, 2, 1)):
            lv = levels[l]
            y = getattr(self, f"up{i}_deconv")(y, (lv.up, lv.down))
            y = leaky_relu(getattr(self, f"up_bn{i}")(y, masks[l - 1]))
            y = torch.cat([y, enc[l - 1]], dim=-1)
            y = getattr(self, f"up{i}_res")(y, asym[l - 1], masks[l - 1])

        fused = torch.cat([self.ReconNet(y, recon, masks[0]), y], dim=-1)
        voxel_logits = self.logits(fused, head)

        # per-row logits: the voxel logits gathered at each row's voxel.
        # The padding rows (masked to 0 after the gather) read distinct
        # rows, not all row 0: the gather's backward then scatters no long
        # run of one repeated index (an advanced-indexing backward over
        # ~10^5 repeats of row 0 took 86 ms per step on the card)
        hit = (inv >= 0)[:, None]
        spread = torch.arange(p, device=inv.device) % v0
        rows = torch.where(inv >= 0, inv, spread).long()
        out = torch.where(hit, voxel_logits.index_select(0, rows), 0.0)
        if self.point_refinement:
            pr = self.change_dim(torch.where(hit, fused.index_select(0, rows), 0.0))
            pr = leaky_relu(self.pr_bn(pr, pvalid))
            out = out + self.point_logits(pr)
        return out.float()
