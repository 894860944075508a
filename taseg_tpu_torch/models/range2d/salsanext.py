"""SalsaNext, the range-view 2D UNet segmentor, NHWC (port of
`taseg_tpu/models/range2d/salsanext.py`; reference
`salsanext.py:177-280`): three ResContext stems, five ResBlocks (four
pooled), four PixelShuffle up blocks with skips, the 1x1 `logits` conv
in f32.  Widths base, 2, 4, 8, 8 x base (32 / 64 / 128 / 256 / 256 at
the recipe's base 32).  Submodules are named as flax names them
(`ResContextBlock_0`, `SalsaResBlock_3`, `SalsaUpBlock_1`, `logits`).
"""

from __future__ import annotations

import torch
from torch import nn

from .blocks import Conv, ResContextBlock, SalsaResBlock, SalsaUpBlock


class SalsaNext(nn.Module):
    """(B, H, W, in_channels) -> logits (B, H, W, num_classes) f32, in
    train mode (batch statistics, dropout 0.2 in the blocks that have it)
    or eval mode."""

    def __init__(self, num_classes: int, in_channels: int = 6, base: int = 32, device=None):
        super().__init__()
        b, kw = base, dict(device=device)
        self.ResContextBlock_0 = ResContextBlock(in_channels, b, **kw)
        self.ResContextBlock_1 = ResContextBlock(b, b, **kw)
        self.ResContextBlock_2 = ResContextBlock(b, b, **kw)
        self.SalsaResBlock_0 = SalsaResBlock(b, 2 * b, pooling=True, drop_out=False, **kw)
        self.SalsaResBlock_1 = SalsaResBlock(2 * b, 4 * b, pooling=True, **kw)
        self.SalsaResBlock_2 = SalsaResBlock(4 * b, 8 * b, pooling=True, **kw)
        self.SalsaResBlock_3 = SalsaResBlock(8 * b, 8 * b, pooling=True, **kw)
        self.SalsaResBlock_4 = SalsaResBlock(8 * b, 8 * b, pooling=False, **kw)
        self.SalsaUpBlock_0 = SalsaUpBlock(8 * b, 8 * b, 4 * b, **kw)
        self.SalsaUpBlock_1 = SalsaUpBlock(4 * b, 8 * b, 4 * b, **kw)
        self.SalsaUpBlock_2 = SalsaUpBlock(4 * b, 4 * b, 2 * b, **kw)
        self.SalsaUpBlock_3 = SalsaUpBlock(2 * b, 2 * b, b, drop_out=False, **kw)
        self.logits = Conv(b, num_classes, (1, 1), **kw)

    def forward(self, scan: torch.Tensor) -> torch.Tensor:
        x = self.ResContextBlock_2(self.ResContextBlock_1(self.ResContextBlock_0(scan)))
        d0c, d0b = self.SalsaResBlock_0(x)
        d1c, d1b = self.SalsaResBlock_1(d0c)
        d2c, d2b = self.SalsaResBlock_2(d1c)
        d3c, d3b = self.SalsaResBlock_3(d2c)
        d5c = self.SalsaResBlock_4(d3c)
        u4 = self.SalsaUpBlock_0(d5c, d3b)
        u3 = self.SalsaUpBlock_1(u4, d2b)
        u2 = self.SalsaUpBlock_2(u3, d1b)
        u1 = self.SalsaUpBlock_3(u2, d0b)
        return self.logits(u1.float())
