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
devox_pairs=True)`.  Dropout (`layers.Dropout`, after x4 and y2, whose
pre-dropout values feed the head, as in JAX) is the identity at eval and
at p = 0, the flagship's value; in training at p > 0 its masks come from
the generator that `layers.seed_dropout` gives it (the `Trainer` seeds
it), not from JAX's bits.  `forward(..., return_features=True)` also
returns the tri-scale point features `cat(devox(x4), devox(y2),
devox(y4))` at full width in f32 (256 + 128 + 96 = 480 at cr 1.0), the
mask-distillation target (JAX :192-199).  `block` is "ResBlock" or
"Bottleneck" (JAX's default: 1-3-1 with expansion 4, so every stage and
the head are 4x wider: 1024 / 512 / 384 head channels at cr 1.0).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..._device import resolve_device
from ...ops.voxelize import devoxelize_multi, voxelize_avg
from ..layers import BLOCKS, ConvBNReLU, Dropout
from .backbone_context import UNetTopology, conv_tables, head_tables

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _TriScaleHead(nn.Module):
    """logits = sum_s devox(x_s @ K_s) + b, where [K_1; K_2; K_3] is the
    row partition of the classifier kernel (linear maps commute with the
    interpolation), the three devox, their f32 sum and the bias in one K7
    launch (`devoxelize_multi`).  `kernel` / `bias` keep the `nn.Dense`
    shapes."""

    def __init__(self, widths: Sequence[int], num_classes: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty((sum(widths), num_classes), device=device)
        )
        self.bias = nn.Parameter(torch.zeros(num_classes, device=device))

    def forward(self, voxel_feats, tables, stacked=None) -> torch.Tensor:
        zs = []
        off = 0
        for x in voxel_feats:
            k = self.kernel[off : off + x.shape[-1]].to(x.dtype)
            off += x.shape[-1]
            # bf16 operands, f32 accumulation (products are exact in f32)
            zs.append((x.float() @ k.float()).to(x.dtype))
        # one K7 launch: each scale's devox in the feature dtype, their f32
        # casts summed in scale order, plus the bias; its backward one K6
        # over the stacked pair tables (`stacked`, train topologies)
        return devoxelize_multi(zs, tables, bias=self.bias, stacked=stacked)


class MinkUNet(nn.Module):
    # the model takes no point -> voxel tables (SPVCNN's point branch does)
    point_voxel_strides = ()

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
        exp = blk.expansion  # a block of width c outputs c * exp channels
        self.dropout = Dropout(dropout_p)
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
        for k, lvl in enumerate((4, 3, 2, 1), start=1):
            out_ch = cs[4 + k]
            add(f"up{k}_deconv", ConvBNReLU(ch, out_ch, 8, transposed=True, **kw))
            for i in range(self.num_layer[3 + k]):
                c_in = out_ch + enc_ch[lvl - 1] if i == 0 else out_ch * exp
                add(f"up{k}_blocks_{i}", blk(c_in, out_ch, **kw))
            ch = out_ch * exp
        # head widths: x4 (stride 16), y2 (stride 4), y4 (stride 1)
        self.head_widths = (cs[4] * exp, cs[6] * exp, cs[8] * exp)
        add("classifier", _TriScaleHead(self.head_widths, num_classes, device=dev))

    @staticmethod
    def from_cfg(cfg: dict, device=None, compute_dtype=None) -> "MinkUNet":
        """Build from a config dict with the YAML's layout, through
        `models.build_segmentor` (which builds every ported model by
        `MODEL.NAME`); raises where the config names another model."""
        from .. import build_segmentor

        name = cfg["MODEL"].get("NAME", "MinkUNet")
        if name != "MinkUNet":
            raise ValueError(
                f"MODEL.NAME is {name!r}: build it with models.build_segmentor"
            )
        return build_segmentor(cfg, device=device, compute_dtype=compute_dtype)

    def _stack(self, x, name, n, rulebook, mask):
        for i in range(n):
            x = getattr(self, f"{name}_{i}")(x, rulebook, mask)
        return x

    def forward(
        self, point_feats: torch.Tensor, topo: UNetTopology, return_features: bool = False
    ):
        """point_feats (P, C) f32 -> per-point logits (P, num_classes) f32;
        with `return_features`, (logits, the tri-scale point features (P,
        C_x4 + C_y2 + C_y4) f32)."""
        levels = topo.levels
        if self.training:
            masks = [
                torch.arange(l.coords.shape[0], device=l.num.device) < l.num
                for l in levels
            ]
        else:
            masks = [None] * len(levels)
        rb = conv_tables(topo, self.training)
        x0 = voxelize_avg(
            point_feats[:, : self.in_dim].contiguous(), topo.point_inverse, topo.point_tables
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

        y1 = up(self.dropout(x4), 1, 4)
        y2 = up(y1, 2, 3)
        y3 = up(self.dropout(y2), 3, 2)
        y4 = up(y3, 4, 1)
        tables = head_tables(topo.devox)
        logits = self.classifier((x4, y2, y4), tables, topo.devox_head)
        if return_features:
            # reference minkunet_ms_kd.py:568, 605: each scale devoxelized
            # in the compute dtype (one K7 launch into its columns), the
            # concatenation in f32
            z = devoxelize_multi((x4, y2, y4), tables).float()
            return logits, z
        return logits
