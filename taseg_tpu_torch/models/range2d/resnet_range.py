"""CENet and FIDNet, the ResNet-34-style range-view segmentors, NHWC
(port of `taseg_tpu/models/range2d/resnet_range.py`; reference
`cenet.py:125-330`, `fidnet.py:197-340`).

Both share `MultiScaleResNetBackbone`: a stem of ConvBNLeaky layers,
four BasicBlock stages [3, 4, 6, 3] of 128 channels at strides 1, 2, 2,
2, and the stem's and the stages' outputs concatenated at full
resolution (the last three upsampled bilinearly).  CENet: stem 64 / 128
/ 128, the 640-channel concat -> 3x3 256 -> 3x3 128 -> 1x1 head, and
three 1x1 aux heads on the upsampled stages (their parameters exist in
eval too; their logits come out in train only, JAX :109-118).  FIDNet:
stem 64 / 128 / 256 / 512, the 1024-channel concat -> 1x1 512 -> 1x1 128
-> head.  Every conv but the heads has no bias; BN is flax's (momentum
0.9, `blocks.BatchNorm`); the stride-2 convs pad as flax's "SAME" (0, 1)
on even sizes (`blocks.same_pads`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BatchNorm, Conv, leaky_relu


def bilinear_resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """`jax.image.resize(x, (N, h, w, C), "bilinear")` for upsampling, in
    NHWC: half-pixel centres, where torch clamps a source coordinate
    below 0 (or past the last pixel) to the edge and JAX drops the
    outside tap and renormalises, which gives the same edge value."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


class ConvBNLeaky(nn.Module):
    """Conv (no bias, "SAME") -> BatchNorm -> LeakyReLU(0.01) where `relu`."""

    def __init__(
        self, in_features: int, features: int, kernel=(3, 3), stride=1, relu: bool = True,
        device=None,
    ):
        super().__init__()
        self.relu = relu
        self.Conv_0 = Conv(in_features, features, kernel, stride=stride, use_bias=False, device=device)
        self.BatchNorm_0 = BatchNorm(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        return leaky_relu(x) if self.relu else x


class BasicBlock2d(nn.Module):
    """Two ConvBNLeaky (the second without its activation) plus the
    input, through a 1x1 ConvBNLeaky (no activation) where the stride or
    the width changes, then LeakyReLU."""

    def __init__(self, in_features: int, features: int, stride: int = 1, device=None):
        super().__init__()
        kw = dict(device=device)
        self.ConvBNLeaky_0 = ConvBNLeaky(in_features, features, stride=stride, **kw)
        self.ConvBNLeaky_1 = ConvBNLeaky(features, features, relu=False, **kw)
        self.project = stride != 1 or in_features != features
        if self.project:
            self.ConvBNLeaky_2 = ConvBNLeaky(
                in_features, features, (1, 1), stride=stride, relu=False, **kw
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ConvBNLeaky_1(self.ConvBNLeaky_0(x))
        if self.project:
            x = self.ConvBNLeaky_2(x)
        return leaky_relu(h + x)


class MultiScaleResNetBackbone(nn.Module):
    """Stem + four BasicBlock stages + the multi-scale concat.  Returns
    (concat (B, H, W, stem[-1] + 4 * stage_channels), [stem, stage 1,
    stages 2-4 upsampled])."""

    def __init__(
        self, in_channels: int, stem_channels: Sequence[int], stage_channels: int = 128,
        layers: Sequence[int] = (3, 4, 6, 3), device=None,
    ):
        super().__init__()
        c = in_channels
        for i, s in enumerate(stem_channels):
            self.add_module(f"ConvBNLeaky_{i}", ConvBNLeaky(c, s, device=device))
            c = s
        self.n_stem = len(stem_channels)
        self.stages = []
        j = 0
        for n, stride in zip(layers, (1, 2, 2, 2)):
            names = []
            for i in range(n):
                name = f"BasicBlock2d_{j}"
                self.add_module(
                    name, BasicBlock2d(c, stage_channels, stride if i == 0 else 1, device=device)
                )
                c = stage_channels
                names.append(name)
                j += 1
            self.stages.append(names)
        self.out_channels = stem_channels[-1] + len(layers) * stage_channels

    def forward(self, x: torch.Tensor):
        for i in range(self.n_stem):
            x = getattr(self, f"ConvBNLeaky_{i}")(x)
        h, w = x.shape[1], x.shape[2]
        feats = [x]
        cur = x
        for names in self.stages:
            for name in names:
                cur = getattr(self, name)(cur)
            feats.append(cur)
        ups = feats[:2] + [bilinear_resize(f, h, w) for f in feats[2:]]
        return torch.cat(ups, dim=-1), ups


class CENet(nn.Module):
    """Logits (B, H, W, num_classes) f32; in train mode with `aux` also
    the three aux heads' logits, (logits, [aux1, aux2, aux3])."""

    def __init__(self, num_classes: int, in_channels: int = 6, aux: bool = True, device=None):
        super().__init__()
        kw = dict(device=device)
        self.aux = aux
        self.MultiScaleResNetBackbone_0 = MultiScaleResNetBackbone(in_channels, (64, 128, 128), **kw)
        self.ConvBNLeaky_0 = ConvBNLeaky(self.MultiScaleResNetBackbone_0.out_channels, 256, **kw)
        self.ConvBNLeaky_1 = ConvBNLeaky(256, 128, **kw)
        self.semantic_output = Conv(128, num_classes, (1, 1), **kw)
        if aux:
            for i in range(3):
                self.add_module(f"aux_head{i + 1}", Conv(128, num_classes, (1, 1), **kw))

    def forward(self, scan: torch.Tensor):
        concat, ups = self.MultiScaleResNetBackbone_0(scan)
        out = self.ConvBNLeaky_1(self.ConvBNLeaky_0(concat))
        logits = self.semantic_output(out.float())
        if self.aux and self.training:
            return logits, [getattr(self, f"aux_head{i + 1}")(ups[2 + i].float()) for i in range(3)]
        return logits


class FIDNet(nn.Module):
    """Logits (B, H, W, num_classes) f32."""

    def __init__(self, num_classes: int, in_channels: int = 6, device=None):
        super().__init__()
        kw = dict(device=device)
        self.MultiScaleResNetBackbone_0 = MultiScaleResNetBackbone(
            in_channels, (64, 128, 256, 512), **kw
        )
        self.ConvBNLeaky_0 = ConvBNLeaky(self.MultiScaleResNetBackbone_0.out_channels, 512, (1, 1), **kw)
        self.ConvBNLeaky_1 = ConvBNLeaky(512, 128, (1, 1), **kw)
        self.semantic_output = Conv(128, num_classes, (1, 1), **kw)

    def forward(self, scan: torch.Tensor) -> torch.Tensor:
        concat, _ = self.MultiScaleResNetBackbone_0(scan)
        h = self.ConvBNLeaky_1(self.ConvBNLeaky_0(concat))
        return self.semantic_output(h.float())
