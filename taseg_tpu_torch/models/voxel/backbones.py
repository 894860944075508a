"""torchsparse's demo backbones, SparseResNet21D and SparseResUNet42
(port of `taseg_tpu/models/voxel/backbones.py`; torchsparse
`backbones/{resnet.py,unet.py}`), train and eval forms.

No TASeg recipe builds them; they complete the engine's backbone
surface, and the machinery they force is real: SparseResNet21D
downsamples with kernel 3 at stride 2 and ends with an anisotropic
(1, 3, 1) kernel at stride (1, 2, 1), torchsparse's GENERAL output rule
(`nn/functional/downsample.py:25-52`): the candidates are every input
coordinate plus every kernel offset, kept where they land on the
sample-stride grid at or above the per-axis minimum of the input, then
made unique.  Here that is one masked `unique_coords` (one sort of
their packed keys) over the (K·V, 4) candidate table
(`general_downsample`); K1 runs in the tables' joins.

`build_resnet_topology` builds the stages' coordinates and tables once,
outside the forward: per stage the entry conv's table from the stage
before (`build_rulebook`, offsets at the INPUT tensor stride, as
torchsparse's kmap) and its reverse (`build_reverse_rulebook`), and the
same-level 3^3 table of the residual blocks; each as a `KTable` with its
row order, and in the train form with the reverse tables' pair lists.
The entry convs between two stages (V_in != V_out) run K2 at K offsets
(and K4 at K in the backward, `SparseConv` picks the route by the
table's shape); the 3^3 convs of a stage K2 at 27 (or K2 / K4 at 27 on
3xTF32 in f32).  SparseResUNet42 is a kernel-2 / stride-2 UNet and rides
the standard `UNetTopology` unchanged: K2, K3 both ways, K4, K5.

Module and parameter names follow the flax tree (`stage1_conv/
SparseConv_0/kernel`, `stage4_res1/MaskedBatchNorm_1/scale`,
`enc2_down/...`, `dec0_fuse1/...`), so `utils.params_from_jax` maps the
two one to one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..._device import resolve_device
from ...ops.coords import GridBounds, compute_bounds
from ...ops.f3conv import pair_lists_many
from ...ops.join import unique_coords
from ...ops.rulebook import build_reverse_rulebook, build_rulebook, kernel_offsets, make_ntuple
from ...ops.sparse_conv import KTable, flip_rulebook, mask_row_orders
from ...ops.voxelize import SegmentTables, build_segment_tables
from ..layers import ConvBNReLU, ResidualBlock
from .backbone_context import UNetTopology, conv_tables

# (num_blocks, out_channels, kernel_size, stride) per stage,
# ts backbones/resnet.py:57-69
RESNET21D_BLOCKS = (
    (3, 16, 3, 1),
    (3, 32, 3, 2),
    (3, 64, 3, 2),
    (3, 128, 3, 2),
    (1, 128, (1, 3, 1), (1, 2, 1)),
)


def general_downsample(
    coords: torch.Tensor, num: torch.Tensor, kernel_size, stride, tensor_stride,
    bounds: GridBounds, capacity: int,
):
    """Output coordinates of a strided conv with kernel != stride (ts
    `nn/functional/downsample.py:31-52`): the unique {c + d} over the
    kernel offsets d, kept where every axis is a multiple of stride x
    tensor_stride and at or above the input's minimum on that axis.
    Returns the key-sorted coords padded to `capacity` and the true
    count (a 0-dim int32; above `capacity` means overflow)."""
    ts = make_ntuple(tensor_stride)
    st = make_ntuple(stride)
    dev = coords.device
    offs = torch.as_tensor(kernel_offsets(make_ntuple(kernel_size), stride=ts), device=dev)
    k, v = offs.shape[0], coords.shape[0]
    valid = torch.arange(v, dtype=torch.int32, device=dev) < num
    ss = torch.tensor([st[i] * ts[i] for i in range(3)], dtype=torch.int32, device=dev)
    c = coords.to(torch.int32)
    cmin = torch.where(valid[:, None], c[:, :3], 2**30).amin(0)
    cand_xyz = c[None, :, :3] + offs[:, None, :]  # (K, V, 3)
    cand = torch.cat([cand_xyz, c[None, :, 3:4].expand(k, v, 1)], -1)
    ok = valid[None, :] & (cand_xyz % ss == 0).all(-1) & (cand_xyz >= cmin).all(-1)
    out, n_out, _, _ = unique_coords(cand.reshape(-1, 4), ok.reshape(-1), bounds, capacity)
    return out, n_out


@dataclass(frozen=True)
class ResNetStageTopo:
    coords: torch.Tensor  # (V_s, 4) int32, key-sorted valid-first
    num: torch.Tensor  # () int32
    rb_entry: torch.Tensor  # (K_e, V_s) entry-conv rulebook from the stage before
    rb_entry_bwd: torch.Tensor  # (K_e, V_prev) its reverse (gradient) table
    rb_res: Optional[torch.Tensor] = None  # (27, V_s) for the residual blocks
    # the tables with their row orders (and, train form, the reverse
    # tables' pair lists) as the conv modules take them
    entry: Optional[KTable] = None
    entry_bwd: Optional[KTable] = None
    res: Optional[KTable] = None
    res_bwd: Optional[KTable] = None

    def conv_table(self):
        """The entry conv's table, with its reverse where the topology is
        the train form (a gradient can then be taken in either mode)."""
        return self.entry if self.entry_bwd is None else (self.entry, self.entry_bwd)

    def res_table(self):
        return self.res if self.res_bwd is None else (self.res, self.res_bwd)


@dataclass(frozen=True)
class ResNetTopology:
    stages: tuple  # ResNetStageTopo per stage
    bounds: GridBounds
    # input row -> stage-0 row (-1 invalid) and its segment tables: place
    # the input features with `voxelize_avg(feats, point_inverse,
    # point_tables)`
    point_inverse: torch.Tensor = None
    point_tables: Optional[SegmentTables] = None


def build_resnet_topology(
    coords: torch.Tensor, num, capacities: Sequence[int], blocks=RESNET21D_BLOCKS,
    *, train: bool = False,
) -> ResNetTopology:
    """Stage coordinates and tables of a SparseResNet ladder, on the
    coords' device.  `coords` are integer voxel coords (N, 4) with zero
    padding rows; they are made unique and key-sorted into stage 0 here,
    and `point_inverse` maps the input rows to stage-0 rows.
    `capacities[s]` bounds stage s's voxels.  The entry table of stage s
    queries stage s-1 at the kernel offsets scaled by the INPUT tensor
    stride (ts `nn/functional/conv.py:156-176`).  `train` adds the pair
    lists that the weight gradients read."""
    if len(capacities) != len(blocks):
        raise ValueError(f"{len(capacities)} capacities for {len(blocks)} stages")
    dev = coords.device
    n = coords.shape[0]
    num = torch.as_tensor(num, dtype=torch.int32, device=dev)
    valid = torch.arange(n, dtype=torch.int32, device=dev) < num
    coords = coords.to(torch.int32)
    bounds = compute_bounds(coords, valid, margin=64)
    coords0, num0, inverse, _ = unique_coords(coords, valid, bounds, capacities[0])
    point_tables = build_segment_tables(inverse, capacities[0])

    raw = []
    prev_coords, prev_num = coords0, num0
    ts = (1, 1, 1)
    for (n_blocks, _c, ks, st), cap in zip(blocks, capacities):
        ks_t, st_t = make_ntuple(ks), make_ntuple(st)
        if all(x == 1 for x in st_t):
            cur_coords, cur_num, ts_out = prev_coords, prev_num, ts
        else:
            cur_coords, cur_num = general_downsample(prev_coords, prev_num, ks_t, st_t, ts, bounds, cap)
            ts_out = tuple(ts[i] * st_t[i] for i in range(3))
        offs = kernel_offsets(ks_t, stride=ts)
        rb_entry = build_rulebook(cur_coords, cur_num, prev_coords, prev_num, offs, bounds)
        rb_entry_bwd = build_reverse_rulebook(prev_coords, prev_num, cur_coords, cur_num, offs, bounds)
        rb_res = None
        if n_blocks > 1:  # the residual blocks: same-level 3^3 at ts_out
            rb_res = build_rulebook(
                cur_coords, cur_num, cur_coords, cur_num, kernel_offsets(3, stride=ts_out), bounds,
            )
        raw.append((cur_coords, cur_num, rb_entry, rb_entry_bwd, rb_res))
        prev_coords, prev_num, ts = cur_coords, cur_num, ts_out

    # every table's row order in one batched sort per row count; the
    # reverse tables' pair lists likewise (a flipped 3^3 table shares its
    # table's order)
    entries = [r[2] for r in raw]
    entry_bwds = [r[3] for r in raw]
    res = [r[4] for r in raw if r[4] is not None]
    orders = iter(mask_row_orders(entries + entry_bwds + res))
    e_ord = [next(orders) for _ in entries]
    b_ord = [next(orders) for _ in entry_bwds]
    r_ord = list(orders)
    if train:
        flips = [flip_rulebook(r) for r in res]
        lists = iter(pair_lists_many(entry_bwds + flips))
        b_lists = [next(lists) for _ in entry_bwds]
        r_lists = list(lists)
    r_i = 0
    stages = []
    for s, (c, nm, rb_e, rb_b, rb_r) in enumerate(raw):
        kw = dict(entry=KTable(rb_e, e_ord[s]))
        if train:
            kw["entry_bwd"] = KTable(rb_b, b_ord[s], b_lists[s])
        if rb_r is not None:
            kw["res"] = KTable(rb_r, r_ord[r_i])
            if train:
                kw["res_bwd"] = KTable(flips[r_i], r_ord[r_i], r_lists[r_i])
            r_i += 1
        stages.append(ResNetStageTopo(
            coords=c, num=nm, rb_entry=rb_e, rb_entry_bwd=rb_b, rb_res=rb_r, **kw,
        ))
    return ResNetTopology(
        stages=tuple(stages), bounds=bounds, point_inverse=inverse, point_tables=point_tables,
    )


def _mask(coords: torch.Tensor, num: torch.Tensor) -> torch.Tensor:
    return torch.arange(coords.shape[0], dtype=torch.int32, device=coords.device) < num


class SparseResNet(nn.Module):
    """Strided sparse ResNet feature ladder (ts `backbones/resnet.py:14-54`):
    per stage one strided conv block, then kernel-3 residual blocks; the
    features of every stage come out.  The input features live at
    `topo.stages[0]` rows (stage 0 has stride 1: the input voxels).  A
    gradient needs the train form of the topology (`train=True`), in
    train or eval mode."""

    def __init__(
        self, in_channels: int = 4, blocks=RESNET21D_BLOCKS, width_multiplier: float = 1.0,
        device=None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.blocks = tuple(blocks)
        c_prev = in_channels
        for s, (n_blocks, ch, ks, _st) in enumerate(self.blocks):
            ch = int(ch * width_multiplier)
            kv = int(np.prod(make_ntuple(ks)))
            self.add_module(f"stage{s}_conv", ConvBNReLU(c_prev, ch, kv, device=dev))
            for i in range(1, n_blocks):
                self.add_module(f"stage{s}_res{i}", ResidualBlock(ch, ch, device=dev))
            c_prev = ch

    def forward(self, feats: torch.Tensor, topo: ResNetTopology) -> list:
        outputs = []
        x = feats
        for s, (n_blocks, *_rest) in enumerate(self.blocks):
            stage = topo.stages[s]
            mask = _mask(stage.coords, stage.num)
            x = getattr(self, f"stage{s}_conv")(x, stage.conv_table(), mask)
            for i in range(1, n_blocks):
                x = getattr(self, f"stage{s}_res{i}")(x, stage.res_table(), mask)
            outputs.append(x)
        return outputs


class SparseResNet21D(SparseResNet):
    """4-stage isotropic stride-2 ladder + a (1, 3, 1) / (1, 2, 1)
    finisher (ts `backbones/resnet.py:57-69`)."""


class SparseResUNet42(nn.Module):
    """Residual sparse UNet (ts `backbones/unet.py:16-125`): 2-conv stem,
    four [strided conv + 2 residual blocks] encoder stages, four
    [transposed conv + skip concat + 2 residual blocks] decoder stages;
    all nine stage outputs in the reference's order [stem, enc1..enc4,
    dec1..dec4].  On the standard `UNetTopology`; a gradient needs its
    train form (`devox_pairs=True`), in train or eval mode.  The input
    features live at `topo.levels[0]` rows."""

    def __init__(
        self, in_channels: int = 4, stem_channels: int = 32,
        encoder_channels: Sequence[int] = (32, 64, 128, 256),
        decoder_channels: Sequence[int] = (256, 128, 96, 96),
        width_multiplier: float = 1.0, device=None,
    ):
        super().__init__()
        dev = resolve_device(device)
        nc = [
            int(width_multiplier * c)
            for c in [stem_channels, *encoder_channels, *decoder_channels]
        ]
        self.nc = nc
        self.stem_0 = ConvBNReLU(in_channels, nc[0], 27, device=dev)
        self.stem_1 = ConvBNReLU(nc[0], nc[0], 27, device=dev)
        for k in range(4):
            self.add_module(f"enc{k}_down", ConvBNReLU(nc[k], nc[k], 8, device=dev))
            self.add_module(f"enc{k}_res0", ResidualBlock(nc[k], nc[k + 1], device=dev))
            self.add_module(f"enc{k}_res1", ResidualBlock(nc[k + 1], nc[k + 1], device=dev))
        c_prev = nc[4]
        for k in range(4):
            c = nc[k + 5]
            self.add_module(f"dec{k}_up", ConvBNReLU(c_prev, c, 8, transposed=True, device=dev))
            self.add_module(f"dec{k}_fuse0", ResidualBlock(c + nc[3 - k], c, device=dev))
            self.add_module(f"dec{k}_fuse1", ResidualBlock(c, c, device=dev))
            c_prev = c

    def forward(self, feats: torch.Tensor, topo: UNetTopology) -> list:
        levels = topo.levels
        masks = [_mask(l.coords, l.num) for l in levels]
        k3 = conv_tables(topo, train=levels[0].rb_k3_bwd is not None)
        x = self.stem_0(feats, k3[0], masks[0])
        x = self.stem_1(x, k3[0], masks[0])
        outs = [x]
        for k in range(4):
            x = getattr(self, f"enc{k}_down")(x, levels[k + 1].strided, masks[k + 1])
            for i in range(2):
                x = getattr(self, f"enc{k}_res{i}")(x, k3[k + 1], masks[k + 1])
            outs.append(x)
        y = outs[4]
        for k in range(4):
            lvl = 4 - k
            u = getattr(self, f"dec{k}_up")(y, levels[lvl].strided, masks[lvl - 1])
            h = torch.cat([u, outs[lvl - 1]], dim=-1)
            y = getattr(self, f"dec{k}_fuse0")(h, k3[lvl - 1], masks[lvl - 1])
            y = getattr(self, f"dec{k}_fuse1")(y, k3[lvl - 1], masks[lvl - 1])
            outs.append(y)
        return outs


__all__ = [
    "RESNET21D_BLOCKS", "ResNetStageTopo", "ResNetTopology", "SparseResNet", "SparseResNet21D",
    "SparseResUNet42", "build_resnet_topology", "general_downsample",
]
