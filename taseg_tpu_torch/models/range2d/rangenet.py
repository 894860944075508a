"""RangeNet++ with its darknet backbone, NHWC (port of
`taseg_tpu/models/range2d/rangenet.py`; reference `rangenet/module/
darknet.py`): a darknet residual encoder that halves the width only
(3x3 convs at strides (1, 2), flax "SAME": H pads (1, 1), W (0, 1)), a
decoder of width-doubling transposed convs (kernel (1, 4), strides
(1, 2), `blocks.ConvTranspose`) with the encoder's inputs added where
the shapes match, `Dropout(0.01)` and a 1x1 head.  Submodules are named
as flax numbers them: `Conv_<i>` / `BatchNorm_<i>` for the five
downsampling convs, `ConvTranspose_<i>` / `BatchNorm_<5 + i>` for the
five upsampling ones, `DarkResidual_<j>` in creation order (encoder,
then decoder), `head`.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..layers import Dropout
from .blocks import BatchNorm, Conv, ConvTranspose, leaky_relu
from .resnet_range import ConvBNLeaky

# the darknet depths (JAX `layers`; darknet53 is the default)
DARKNET53 = (1, 2, 8, 8, 4)
DARKNET21 = (1, 1, 2, 2, 1)


class DarkResidual(nn.Module):
    """x + ConvBNLeaky 3x3 (ConvBNLeaky 1x1 to half the width (x))."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.ConvBNLeaky_0 = ConvBNLeaky(features, features // 2, (1, 1), device=device)
        self.ConvBNLeaky_1 = ConvBNLeaky(features // 2, features, (3, 3), device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.ConvBNLeaky_1(self.ConvBNLeaky_0(x))


class RangeNet(nn.Module):
    """(B, H, W, in_channels) -> logits (B, H, W, num_classes) f32; W a
    multiple of 2 ** len(layers) gives every skip its addition."""

    def __init__(
        self, num_classes: int, in_channels: int = 6, layers: Sequence[int] = DARKNET53,
        base: int = 32, device=None,
    ):
        super().__init__()
        kw = dict(device=device)
        self.n_levels = len(layers)
        self.ConvBNLeaky_0 = ConvBNLeaky(in_channels, base, **kw)
        ch, j = base, 0
        self.down_res, self.up_res = [], []
        for i, n in enumerate(layers):
            self.add_module(f"Conv_{i}", Conv(ch, 2 * ch, (3, 3), stride=(1, 2), use_bias=False, **kw))
            ch *= 2
            self.add_module(f"BatchNorm_{i}", BatchNorm(ch, **kw))
            names = []
            for _ in range(n):
                self.add_module(f"DarkResidual_{j}", DarkResidual(ch, **kw))
                names.append(f"DarkResidual_{j}")
                j += 1
            self.down_res.append(names)
        for i in range(len(layers)):
            self.add_module(f"ConvTranspose_{i}", ConvTranspose(ch, ch // 2, **kw))
            ch //= 2
            self.add_module(f"BatchNorm_{len(layers) + i}", BatchNorm(ch, **kw))
            self.add_module(f"DarkResidual_{j}", DarkResidual(ch, **kw))
            self.up_res.append(f"DarkResidual_{j}")
            j += 1
        self.dropout = Dropout(0.01)
        self.head = Conv(base, num_classes, (1, 1), **kw)

    def forward(self, scan: torch.Tensor) -> torch.Tensor:
        cur = self.ConvBNLeaky_0(scan)
        skips = []
        for i, names in enumerate(self.down_res):
            skips.append(cur)
            cur = leaky_relu(getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(cur)))
            for name in names:
                cur = getattr(self, name)(cur)
        for i, (skip, name) in enumerate(zip(reversed(skips), self.up_res)):
            cur = getattr(self, f"ConvTranspose_{i}")(cur)
            cur = leaky_relu(getattr(self, f"BatchNorm_{self.n_levels + i}")(cur))
            cur = getattr(self, name)(cur)
            if skip.shape == cur.shape:
                cur = cur + skip
        return self.head(self.dropout(cur).float())
