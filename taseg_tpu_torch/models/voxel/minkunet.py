"""MinkUNet — sparse-voxel 3D UNet segmentor (port of
`taseg_tpu/models/voxel/minkunet.py`, train and eval forms).

Stem + four stride-2 encoder stages + four transposed-conv decoder
stages with skip concatenation, and the tri-scale point head
`Linear(cat(z1, z2, z3))` with the projection pushed to the voxel side.
Topology arrives precomputed in a `UNetTopology`.  The dtype flow
follows the JAX model: voxelize in f32, then the compute dtype; each
conv casts its weight to the activation dtype and accumulates in f32;
BN folds into one multiply-add in the activation dtype; the head takes
its dots with f32 accumulation and sums the scales in f32.

In train mode (`model.train()`) every BN takes its level's row mask
(`arange(V_l) < num_l`) and the convs take (rulebook, flipped rulebook)
pairs, so the topology must come from `build_unet_topology(...,
devox_pairs=True)`.  Dropout (after x4 and y2) is the identity at eval
and at p = 0, the flagship's value; a train forward with p > 0 raises
(its random bits could not be held against JAX's anyway).  `Bottleneck`
blocks and `return_features` are left out.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..._device import resolve_device
from ...ops.voxelize import devoxelize, voxelize_avg
from ..layers import BLOCKS, ConvBNReLU
from .backbone_context import UNetTopology

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _TriScaleHead(nn.Module):
    """logits = sum_s devox(x_s @ K_s) + b, where [K_1; K_2; K_3] is the
    row partition of the classifier kernel (linear maps commute with the
    interpolation).  `kernel` / `bias` keep the `nn.Dense` shapes."""

    def __init__(self, widths: Sequence[int], num_classes: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty((sum(widths), num_classes), device=device)
        )
        self.bias = nn.Parameter(torch.zeros(num_classes, device=device))

    def forward(self, voxel_feats, tables) -> torch.Tensor:
        out = None
        off = 0
        for x, table in zip(voxel_feats, tables):
            k = self.kernel[off : off + x.shape[-1]].to(x.dtype)
            off += x.shape[-1]
            # bf16 operands, f32 accumulation (products are exact in f32)
            zc = x.float() @ k.float()
            c = devoxelize(zc.to(x.dtype), table).float()
            out = c if out is None else out + c
        return out + self.bias


class MinkUNet(nn.Module):
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
        bn_momentum: float = 0.1,
        device=None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.in_dim = in_dim
        self.dropout_p = dropout_p
        self.num_layer = tuple(num_layer)
        self.compute_dtype = _DTYPES[compute_dtype]
        if block not in BLOCKS:
            raise ValueError(f"block {block!r} is not ported; have {sorted(BLOCKS)}")
        blk = BLOCKS[block]
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
                add(f"stage{l}_{i}", blk(ch if i == 0 else cs[l], cs[l], **kw))
            ch = cs[l]
            enc_ch.append(ch)
        for k, lvl in enumerate((4, 3, 2, 1), start=1):
            out_ch = cs[4 + k]
            add(f"up{k}_deconv", ConvBNReLU(ch, out_ch, 8, transposed=True, **kw))
            for i in range(self.num_layer[3 + k]):
                c_in = out_ch + enc_ch[lvl - 1] if i == 0 else out_ch
                add(f"up{k}_blocks_{i}", blk(c_in, out_ch, **kw))
            ch = out_ch
        # head widths: x4 (stride 16), y2 (stride 4), y4 (stride 1)
        add("classifier", _TriScaleHead((cs[4], cs[6], cs[8]), num_classes, device=dev))

    @staticmethod
    def from_cfg(cfg: dict, device=None, compute_dtype=None) -> "MinkUNet":
        """Build from a config dict with the YAML's layout (`MODEL.PLANES`,
        `NUM_LAYER`, `cr`, `NUM_CLASS`, `IN_FEATURE_DIM`, `BLOCK`,
        `COMPUTE_DTYPE`, `DROPOUT_P`, `BN_MOMENTUM`), defaults as in
        `taseg_tpu.models.build_model`."""
        m = cfg["MODEL"]
        if m.get("NAME", "MinkUNet") != "MinkUNet":
            raise ValueError(f"the port runs MinkUNet only, not {m['NAME']}")
        return MinkUNet(
            num_classes=m["NUM_CLASS"],
            in_dim=m.get("IN_FEATURE_DIM", 4),
            planes=tuple(m.get("PLANES", (32, 32, 64, 128, 256, 256, 128, 96, 96))),
            num_layer=tuple(m.get("NUM_LAYER", (2, 3, 4, 6, 2, 2, 2, 2))),
            block=m.get("BLOCK", "Bottleneck"),
            cr=m.get("cr", 1.0),
            compute_dtype=compute_dtype or m.get("COMPUTE_DTYPE", "float32"),
            dropout_p=float(m.get("DROPOUT_P", 0.3)),
            bn_momentum=float(m.get("BN_MOMENTUM", 0.1)),
            device=device,
        )

    def _stack(self, x, name, n, rulebook, mask):
        for i in range(n):
            x = getattr(self, f"{name}_{i}")(x, rulebook, mask)
        return x

    def forward(self, point_feats: torch.Tensor, topo: UNetTopology) -> torch.Tensor:
        """point_feats (P, C) f32 -> per-point logits (P, num_classes) f32."""
        levels = topo.levels
        if self.training:
            if self.dropout_p > 0:
                raise NotImplementedError(
                    f"Dropout p={self.dropout_p} in training is not ported; p = 0 is"
                )
            masks = [
                torch.arange(l.coords.shape[0], device=l.num.device) < l.num
                for l in levels
            ]
            rb = [(l.rb_k3, l.rb_k3_bwd, l.k3_pairs) for l in levels]
        else:
            masks = [None] * len(levels)
            rb = [l.rb_k3 for l in levels]
        x0 = voxelize_avg(
            point_feats[:, : self.in_dim], topo.point_inverse, topo.point_tables
        ).to(self.compute_dtype)
        x0 = self.stem_1(self.stem_0(x0, rb[0], masks[0]), rb[0], masks[0])

        enc = [x0]
        x = x0
        for l in range(1, 5):
            x = getattr(self, f"down{l}")(x, levels[l].strided, masks[l])
            x = self._stack(x, f"stage{l}", self.num_layer[l - 1], rb[l], masks[l])
            enc.append(x)
        x4 = enc[4]

        def up(x, k, lvl):
            h = getattr(self, f"up{k}_deconv")(x, levels[lvl].strided, masks[lvl - 1])
            h = torch.cat([h, enc[lvl - 1]], dim=-1)
            return self._stack(
                h, f"up{k}_blocks", self.num_layer[3 + k], rb[lvl - 1], masks[lvl - 1]
            )

        y1 = up(x4, 1, 4)
        y2 = up(y1, 2, 3)
        y3 = up(y2, 3, 2)
        y4 = up(y3, 4, 1)
        tables = (topo.devox[16], topo.devox[4], topo.devox[1])
        return self.classifier((x4, y2, y4), tables)
