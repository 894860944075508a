"""SPVCNN — sparse point-voxel CNN (port of
`taseg_tpu/models/fusion/spvcnn.py`, train and eval forms).

MinkUNet's voxel UNet interleaved with a per-point branch: after each
devoxelize, a Linear + masked BN + ReLU of the previous point features
is added, and the sum is re-voxelized to seed the next voxel stage.  The
topology must carry the point -> voxel tables at strides 1, 4 and 16
(`build_unet_topology(..., point_voxel_strides=SPVCNN.point_voxel_strides)`).
Every conv and the masked BN are MinkUNet's (`models/layers.py`); the
voxel stages run in the compute dtype.

The dtypes follow JAX: flax's `nn.Dense` promotes a bf16 input against
its f32 kernel, so each `PointTransform` computes in f32, and z1, z2 and
z3 (a devoxelized bf16 row plus an f32 one) are f32; they are voxelized
in f32 and only then cast to the compute dtype.  So in bf16 the gradient
of the voxelize mean (K8) takes bf16 rows at stride 1 and f32 rows at
strides 16 and 4.  The classifier is one f32 Dense over concat(z1, z2,
z3) (`MULTI_SCALE` "concat", the default) or over z3.  Dropout (after the
two re-voxelizations) is the identity at eval and at p = 0, the value of
every SPVCNN YAML; at p > 0 it draws its masks as MinkUNet's does.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..._device import resolve_device
from ...ops.voxelize import devoxelize, voxelize_avg
from ..layers import BLOCKS, ConvBNReLU, Dense, Dropout, MaskedBatchNorm
from ..voxel.backbone_context import UNetTopology, conv_tables
from ..voxel.minkunet import _DTYPES


class PointTransform(nn.Module):
    """Dense -> BN over the valid points -> ReLU (JAX spvcnn.py:26-37).
    The BN keeps momentum 0.1 whatever MODEL.BN_MOMENTUM says: JAX builds
    it without the model's `bn_momentum`."""

    def __init__(self, in_features: int, features: int, device=None):
        super().__init__()
        self.Dense_0 = Dense(in_features, features, device=device)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features, device=device)

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.MaskedBatchNorm_0(self.Dense_0(x), valid))


class SPVCNN(nn.Module):
    # the strides of the point branch's voxelizations
    point_voxel_strides = (1, 4, 16)

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
        bn_momentum: float = 0.1,
        device=None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.in_dim = in_dim
        self.dropout_p = dropout_p
        self.multi_scale = multi_scale
        self.num_layer = tuple(num_layer)
        self.compute_dtype = _DTYPES[compute_dtype]
        if block not in BLOCKS:
            raise ValueError(f"block {block!r} is not ported; have {sorted(BLOCKS)}")
        blk = BLOCKS[block]
        self.dropout = Dropout(dropout_p)
        exp = blk.expansion
        cs = [int(cr * x) for x in planes]
        add = self.add_module
        kw = dict(bn_momentum=bn_momentum, device=dev)
        add("stem_0", ConvBNReLU(in_dim, cs[0], 27, **kw))
        add("stem_1", ConvBNReLU(cs[0], cs[0], 27, **kw))
        ch = cs[0]
        enc_ch = [ch]
        for l in range(1, 5):
            add(f"down{l}", ConvBNReLU(ch, ch, 8, **kw))
            for i in range(self.num_layer[l - 1]):
                add(f"stage{l}_{i}", blk(ch if i == 0 else cs[l] * exp, cs[l], **kw))
            ch = cs[l] * exp
            enc_ch.append(ch)
        # the decoder's inputs: the re-voxelized z1 (before up1) and z2
        # (before up3), the previous stage's output elsewhere
        point_ch = (cs[4] * exp, cs[6] * exp, cs[8] * exp)
        ins = (point_ch[0], cs[5] * exp, point_ch[1], cs[7] * exp)
        for k, lvl in enumerate((4, 3, 2, 1), start=1):
            out_ch = cs[4 + k]
            add(f"up{k}_deconv", ConvBNReLU(ins[k - 1], out_ch, 8, transposed=True, **kw))
            for i in range(self.num_layer[3 + k]):
                c_in = out_ch + enc_ch[lvl - 1] if i == 0 else out_ch * exp
                add(f"up{k}_blocks_{i}", blk(c_in, out_ch, **kw))
        prev = cs[0]
        for i, c in enumerate(point_ch):
            add(f"point_transform_{i}", PointTransform(prev, c, device=dev))
            prev = c
        head_in = sum(point_ch) if multi_scale == "concat" else point_ch[2]
        add("classifier", Dense(head_in, num_classes, device=dev))

    def _stack(self, x, name, n, rulebook, mask):
        for i in range(n):
            x = getattr(self, f"{name}_{i}")(x, rulebook, mask)
        return x

    def forward(self, point_feats: torch.Tensor, topo: UNetTopology) -> torch.Tensor:
        """point_feats (P, C) f32 -> per-point logits (P, num_classes) f32."""
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

        def revoxelize(z, s, drop=False):
            inv, tables = topo.point_vox[s]
            x = voxelize_avg(z, inv, tables).to(cdt)
            return self.dropout(x) if drop else x

        x0 = voxelize_avg(
            point_feats[:, : self.in_dim].contiguous(), topo.point_inverse, topo.point_tables
        ).to(cdt)
        x0 = self.stem_1(self.stem_0(x0, rb[0], masks[0]), rb[0], masks[0])
        z0 = devoxelize(x0, topo.devox[1])

        x = revoxelize(z0, 1)
        enc = [x0]
        for l in range(1, 5):
            x = getattr(self, f"down{l}")(x, levels[l].strided, masks[l])
            x = self._stack(x, f"stage{l}", self.num_layer[l - 1], rb[l], masks[l])
            enc.append(x)

        def up(x, k, lvl):
            h = getattr(self, f"up{k}_deconv")(x, levels[lvl].strided, masks[lvl - 1])
            h = torch.cat([h, enc[lvl - 1]], dim=-1)
            return self._stack(
                h, f"up{k}_blocks", self.num_layer[3 + k], rb[lvl - 1], masks[lvl - 1]
            )

        z1 = devoxelize(enc[4], topo.devox[16]) + self.point_transform_0(z0, pvalid)
        y2 = up(up(revoxelize(z1, 16, drop=True), 1, 4), 2, 3)
        z2 = devoxelize(y2, topo.devox[4]) + self.point_transform_1(z1, pvalid)
        y4 = up(up(revoxelize(z2, 4, drop=True), 3, 2), 4, 1)
        z3 = devoxelize(y4, topo.devox[1]) + self.point_transform_2(z2, pvalid)
        z = torch.cat([z1, z2, z3], dim=-1) if self.multi_scale == "concat" else z3
        return self.classifier(z.float())
