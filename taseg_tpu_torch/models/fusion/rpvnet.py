"""RPVNet — range + point + voxel three-branch fusion segmentor (port of
`taseg_tpu/models/fusion/rpvnet.py`, train and eval forms; reference
`rpvnet.py:632-716`).

The three branches meet at four fusion points, and after each fusion the
summed point features are scattered into the next range stage
(`point_to_range`, a per-pixel mean) as they are re-voxelized into the
next voxel stage:

    stem_v(x0)   ‖ stem_r(image)                -> fuse0 (z0)  full res
    voxel enc    ‖ range enc(scatter z0)        -> fuse1 (z1)  1/16
    voxel up1-2  ‖ range up1-2(scatter z1)      -> fuse2 (z2)  1/4
    voxel up3-4  ‖ range up3-4(scatter z2)      -> fuse3 (z3)  full res

Each range stage comes back to the points by the bilinear sample
`range_to_point` at its scale (K7 at 4 corners); the voxel stages by
`devoxelize` at strides 1, 16, 4 and 1; the head is 'concat', 'sum' or
'se' over (z1, z2, z3).

The dtypes follow JAX: the voxel stages run in the compute dtype; the
range branch's flax convs promote to f32, so every range stage and every
sample of it is f32; z0-z3 are f32 (bf16 devoxelized rows plus f32
ones), are voxelized in f32 and then cast to the compute dtype, and are
scattered to the range image in f32 and then rounded to the compute
dtype before the range stage reads them.  The range branch's dropout is
hard-wired at 0.2 (`range2d.blocks`), the voxel branch's is DROPOUT_P.

Inputs: the point features, and an `RpvInputs`: the UNet topology (with
the point -> voxel tables at strides 1, 4 and 16), the `RpvContext`
(the point <-> range tables at scales 1, 4 and 16) and the (B, H, W, C)
range images; `rpv_inputs` builds it from a collated shard's arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Sequence

import torch
from torch import nn

from ..._device import resolve_device
from ...ops.point_range import point_to_range, point_to_range_tables, range_sample_table
from ...ops.voxelize import devoxelize, voxelize_avg
from ..layers import BLOCKS, ConvBNReLU, Dense, Dropout
from ..range2d.blocks import ResContextBlock, SalsaResBlock, SalsaUpBlock
from ..voxel.backbone_context import UNetTopology, conv_tables
from ..voxel.minkunet import _DTYPES
from .spvcnn import PointTransform

FUSION_SCALES = (1, 4, 16)  # full res, after up2, encoder bottom
# the range image's channels (data/fusion_dataset.py: xyz / 50,
# remission, range / 80, occupancy)
RANGE_CHANNELS = 6


@dataclass
class RpvContext:
    """The point <-> range tables at every fusion scale.  `h`, `w` are
    one scan's image size and `b` the scans of the shard: the tables
    index the stacked (b * hs, ws) canvas (row = scan * hs + y), while
    the 2D branch sees a true (b, hs, ws, C) batch, so no conv or pool
    mixes two scans.  scatter: s -> (pixel ids (P,), SegmentTables);
    sample: s -> the 4-corner DevoxTable."""

    h: int
    w: int
    b: int = 1
    scatter: dict = field(default_factory=dict)
    sample: dict = field(default_factory=dict)


def build_rpv_context(
    pxf: torch.Tensor, pyf: torch.Tensor, valid: torch.Tensor, h: int, w: int,
    *, batch: int = 1, with_pairs: bool = True,
) -> RpvContext:
    """pxf / pyf: (P,) f32 pixel coordinates in the stacked full-res
    canvas (rows offset by scan index * h, `data.fusion_dataset.
    collate_fusion_shard`).  `with_pairs` False leaves out the sample
    tables' backward layout (serving)."""
    scatter, sample = {}, {}
    band = torch.clamp(torch.floor(pyf / max(h, 1)).to(torch.int32), 0, batch - 1)
    for s in FUSION_SCALES:
        hs, ws = max(h // s, 1), max(w // s, 1)
        pxs = pxf / s
        # y clamped inside the point's own scan band, so no bilinear
        # corner lands in a neighbouring scan's rows (where the band has
        # two rows or more; at one row the clamp's bound is below 0)
        y_local = torch.clamp(pyf / s - band * hs, 0.0, hs - 1.000001)
        pys = band * hs + y_local
        scatter[s] = point_to_range_tables(
            torch.floor(pxs).to(torch.int32), torch.floor(pys).to(torch.int32),
            valid, batch * hs, ws,
        )
        sample[s] = range_sample_table(pxs, pys, valid, batch * hs, ws, with_pairs)
    return RpvContext(h=h, w=w, b=batch, scatter=scatter, sample=sample)


class RpvInputs(NamedTuple):
    """What RPVNet reads besides the point features."""

    topo: UNetTopology
    rpv: RpvContext
    range_image: torch.Tensor  # (B, H, W, C_img) f32


def rpv_inputs(topo: UNetTopology, arrays: dict, *, with_pairs: bool) -> RpvInputs:
    """The counterpart of JAX `parallel/fusion_step.py:_unpack` on one
    shard: `arrays` holds the device tensors `range_image_t` (B, H, W, C)
    and `range_pxpy_t` (P, 2) of a collated fusion shard."""
    img = arrays["range_image_t"]
    b, h, w, _ = img.shape
    pxpy = arrays["range_pxpy_t"]
    valid = torch.arange(pxpy.shape[0], device=pxpy.device) < topo.num_points
    rpv = build_rpv_context(
        pxpy[:, 0].contiguous(), pxpy[:, 1].contiguous(), valid, h, w,
        batch=b, with_pairs=with_pairs,
    )
    return RpvInputs(topo=topo, rpv=rpv, range_image=img)


class RangeStem(nn.Module):
    def __init__(self, in_features: int, base: int = 32, device=None):
        super().__init__()
        self.ResContextBlock_0 = ResContextBlock(in_features, base, device=device)
        self.ResContextBlock_1 = ResContextBlock(base, base, device=device)

    def forward(self, img):
        return self.ResContextBlock_1(self.ResContextBlock_0(img))


class RangeEncoder(nn.Module):
    """Four pooled SalsaNext stages and an unpooled mid stage (reference
    range_branch.stage1-4 + mid_stage): full res -> 1/16."""

    def __init__(self, in_features: int, base: int = 32, mid: int = 256, device=None):
        super().__init__()
        b = base
        kw = dict(device=device)
        self.SalsaResBlock_0 = SalsaResBlock(in_features, 2 * b, pooling=True, drop_out=False, **kw)
        self.SalsaResBlock_1 = SalsaResBlock(2 * b, 4 * b, pooling=True, **kw)
        self.SalsaResBlock_2 = SalsaResBlock(4 * b, 8 * b, pooling=True, **kw)
        self.SalsaResBlock_3 = SalsaResBlock(8 * b, 8 * b, pooling=True, **kw)
        self.SalsaResBlock_4 = SalsaResBlock(8 * b, mid, pooling=False, **kw)

    def forward(self, x):
        x, s1 = self.SalsaResBlock_0(x)
        x, s2 = self.SalsaResBlock_1(x)
        x, s3 = self.SalsaResBlock_2(x)
        x, s4 = self.SalsaResBlock_3(x)
        return self.SalsaResBlock_4(x), (s1, s2, s3, s4)


class RangeDecoderTop(nn.Module):
    """up1 + up2: 1/16 -> 1/4 (reference range_branch.up1/up2)."""

    def __init__(self, in_features: int, skip3: int, skip4: int, c_up1: int, c_up2: int, device=None):
        super().__init__()
        self.SalsaUpBlock_0 = SalsaUpBlock(in_features, skip4, c_up1, device=device)
        self.SalsaUpBlock_1 = SalsaUpBlock(c_up1, skip3, c_up2, device=device)

    def forward(self, x, skips):
        _, _, s3, s4 = skips
        return self.SalsaUpBlock_1(self.SalsaUpBlock_0(x, s4), s3)


class RangeDecoderBottom(nn.Module):
    """up3 + up4: 1/4 -> full res (reference range_branch.up3/up4)."""

    def __init__(self, in_features: int, skip1: int, skip2: int, c_up3: int, c_up4: int, device=None):
        super().__init__()
        self.SalsaUpBlock_0 = SalsaUpBlock(in_features, skip2, c_up3, device=device)
        self.SalsaUpBlock_1 = SalsaUpBlock(c_up3, skip1, c_up4, drop_out=False, device=device)

    def forward(self, x, skips):
        s1, s2, _, _ = skips
        return self.SalsaUpBlock_1(self.SalsaUpBlock_0(x, s2), s1)


class RPVNet(nn.Module):
    # the strides of the point branch's voxelizations
    point_voxel_strides = (1, 4, 16)
    # reads range images: the engine builds its inputs with `rpv_inputs`
    range_view = True

    def __init__(
        self,
        num_classes: int,
        in_dim: int = 4,
        planes: Sequence[int] = (32, 32, 64, 128, 256, 256, 128, 96, 96),
        num_layer: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2),
        block: str = "ResBlock",
        cr: float = 1.0,
        compute_dtype: str = "float32",
        dropout_p: float = 0.3,
        multi_scale: str = "concat",
        device=None,
    ):
        super().__init__()
        dev = resolve_device(device)
        if multi_scale not in ("concat", "sum", "se"):
            raise ValueError(f"multi_scale {multi_scale!r}: one of concat, sum, se")
        if block not in BLOCKS:
            raise ValueError(f"block {block!r} is not ported; have {sorted(BLOCKS)}")
        if BLOCKS[block].expansion != 1:
            # JAX's RPVNet adds its point branch (cs widths) to the voxel
            # stages, so only blocks without expansion fit it there too
            raise ValueError(f"RPVNet takes blocks without expansion, not {block!r}")
        self.in_dim = in_dim
        self.dropout_p = dropout_p
        self.multi_scale = multi_scale
        self.num_layer = tuple(num_layer)
        self.compute_dtype = _DTYPES[compute_dtype]
        blk = BLOCKS[block]
        cs = [int(cr * x) for x in planes]
        add = self.add_module
        # every BN of the voxel and point branches at momentum 0.1: JAX
        # builds RPVNet without the model's bn_momentum
        kw = dict(device=dev)
        add("v_stem0", ConvBNReLU(in_dim, cs[0], 27, **kw))
        add("v_stem1", ConvBNReLU(cs[0], cs[0], 27, **kw))
        add("range_stem", RangeStem(RANGE_CHANNELS, cs[0], **kw))
        add("pt0", PointTransform(in_dim, cs[0], **kw))
        ch = cs[0]
        enc_ch = [ch]
        for l in range(1, 5):
            add(f"down{l}", ConvBNReLU(ch, ch, 8, **kw))
            for i in range(self.num_layer[l - 1]):
                add(f"stage{l}_{i}", blk(ch if i == 0 else cs[l], cs[l], **kw))
            ch = cs[l]
            enc_ch.append(ch)
        b = cs[0]
        add("range_encoder", RangeEncoder(cs[0], base=b, mid=cs[4], **kw))
        add("pt1", PointTransform(cs[0], cs[4], **kw))
        # the decoder's inputs: the re-voxelized z1 (before up1) and z2
        # (before up3), the previous stage's output elsewhere
        ins = (cs[4], cs[5], cs[6], cs[7])
        for k, lvl in enumerate((4, 3, 2, 1), start=1):
            out_ch = cs[4 + k]
            add(f"up{k}_deconv", ConvBNReLU(ins[k - 1], out_ch, 8, transposed=True, **kw))
            for i in range(self.num_layer[3 + k]):
                c_in = out_ch + enc_ch[lvl - 1] if i == 0 else out_ch
                add(f"up{k}_blocks_{i}", blk(c_in, out_ch, **kw))
        add("range_dec_top", RangeDecoderTop(cs[4], 8 * b, 8 * b, cs[5], cs[6], **kw))
        add("pt2", PointTransform(cs[4], cs[6], **kw))
        add("range_dec_bottom", RangeDecoderBottom(cs[6], 2 * b, 4 * b, cs[7], cs[8], **kw))
        add("pt3", PointTransform(cs[6], cs[8], **kw))
        self.dropout = Dropout(dropout_p)
        cat = cs[4] + cs[6] + cs[8]
        if multi_scale == "sum":
            add("l1", Dense(cs[4], cs[8], **kw))
            add("l2", Dense(cs[6], cs[8], **kw))
            add("classifier", Dense(cs[8], num_classes, **kw))
        else:
            if multi_scale == "se":
                add("attn", Dense(cat, cat, **kw))
            add("classifier", Dense(cat, num_classes, **kw))

    def _stack(self, x, name, n, rulebook, mask):
        for i in range(n):
            x = getattr(self, f"{name}_{i}")(x, rulebook, mask)
        return x

    def forward(self, point_feats: torch.Tensor, inputs: RpvInputs) -> torch.Tensor:
        """point_feats (P, C) f32 -> per-point logits (P, num_classes) f32."""
        topo, rpv, range_image = inputs
        levels = topo.levels
        if self.training:
            masks = [
                torch.arange(l.coords.shape[0], device=l.num.device) < l.num
                for l in levels
            ]
        else:
            masks = [None] * len(levels)
        rb = conv_tables(topo, self.training)
        missing = set(self.point_voxel_strides) - set(topo.point_vox)
        if missing:
            raise ValueError(
                f"the topology has no point_vox tables at strides {sorted(missing)}: "
                f"build it with point_voxel_strides={self.point_voxel_strides}"
            )
        pvalid = torch.arange(point_feats.shape[0], device=point_feats.device) < topo.num_points
        cdt = self.compute_dtype
        h, w = rpv.h, rpv.w

        def revoxelize(z, s, drop=False):
            inv, tables = topo.point_vox[s]
            x = voxelize_avg(z, inv, tables).to(cdt)
            return self.dropout(x) if drop else x

        def to_range(z, s):
            ids, tables = rpv.scatter[s]
            hs, ws = max(h // s, 1), max(w // s, 1)
            img = point_to_range(z, ids, tables, rpv.b * hs, ws)
            return img.reshape(rpv.b, hs, ws, -1).to(cdt)

        def to_point(img, s):
            # (B, hs, ws, C) row-major == the stacked canvas's rows
            return devoxelize(img.reshape(-1, img.shape[-1]).contiguous(), rpv.sample[s])

        def up(x, k, lvl):
            hh = getattr(self, f"up{k}_deconv")(x, levels[lvl].strided, masks[lvl - 1])
            hh = torch.cat([hh, enc[lvl - 1]], dim=-1)
            return self._stack(
                hh, f"up{k}_blocks", self.num_layer[3 + k], rb[lvl - 1], masks[lvl - 1]
            )

        feats = point_feats[:, : self.in_dim].contiguous()
        # ---- stems (rpvnet.py:645-647)
        x0 = voxelize_avg(feats, topo.point_inverse, topo.point_tables).to(cdt)
        x0 = self.v_stem1(self.v_stem0(x0, rb[0], masks[0]), rb[0], masks[0])
        r_x0 = self.range_stem(range_image.to(cdt))  # (B, H, W, C_img)
        # ---- fusion 0 (rpvnet.py:649-651)
        z0 = devoxelize(x0, topo.devox[1]) + to_point(r_x0, 1) + self.pt0(feats, pvalid)
        # ---- encoders (rpvnet.py:653-664)
        x = revoxelize(z0, 1)
        enc = [x0]
        for l in range(1, 5):
            x = getattr(self, f"down{l}")(x, levels[l].strided, masks[l])
            x = self._stack(x, f"stage{l}", self.num_layer[l - 1], rb[l], masks[l])
            enc.append(x)
        r_x4, r_skips = self.range_encoder(to_range(z0, 1))
        # ---- fusion 1 (rpvnet.py:665-668)
        z1 = devoxelize(enc[4], topo.devox[16]) + to_point(r_x4, 16) + self.pt1(z0, pvalid)
        y2 = up(up(revoxelize(z1, 16, drop=True), 1, 4), 2, 3)
        r_y2 = self.range_dec_top(to_range(z1, 16), r_skips)
        # ---- fusion 2 (rpvnet.py:683-686)
        z2 = devoxelize(y2, topo.devox[4]) + to_point(r_y2, 4) + self.pt2(z1, pvalid)
        y4 = up(up(revoxelize(z2, 4, drop=True), 3, 2), 4, 1)
        r_y4 = self.range_dec_bottom(to_range(z2, 4), r_skips)
        # ---- fusion 3 (rpvnet.py:701-704)
        z3 = devoxelize(y4, topo.devox[1]) + to_point(r_y4, 1) + self.pt3(z2, pvalid)

        if self.multi_scale == "sum":
            zsum = self.l1(z1.float()) + self.l2(z2.float()) + z3.float()
            return self.classifier(zsum)
        zcat = torch.cat([z1, z2, z3], dim=-1).float()
        if self.multi_scale == "se":
            attn = torch.where(pvalid[:, None], zcat, 0.0).mean(0)
            attn = attn / pvalid.sum().clamp(min=1)
            attn = torch.sigmoid(self.attn(attn))
            zcat = zcat * attn[None, :]
        return self.classifier(zcat)
