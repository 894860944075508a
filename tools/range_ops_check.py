#!/usr/bin/env python3
"""RPVNet's range-branch ops on the card against the CPU, op by op.

    python3 tools/range_ops_check.py

For each op of `taseg_tpu_torch/models/range2d/blocks.py` as the port
calls it (NHWC tensors, the convs and the pool on their NCHW views), one
f32 forward and backward on the same inputs and output gradients on the
card and on the CPU, TF32 off: the relative L2 gaps of the output, the
input gradient and the parameter gradients.  Also the average pool on
the channels-last view directly (`F.avg_pool2d` of `x.permute(0, 3, 1,
2)`), the call that the port's `avg_pool_3x3_s2` avoids.  Needs a GPU.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import subprocess

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from taseg_tpu_torch.models.range2d import blocks as B

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip(), "| torch", torch.__version__)
    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn(1, 16, 64, 32, generator=gen)

    def conv(k, d):
        return B.Conv(32, 48, (k, k), d, device="cpu")

    ops = {
        "F.avg_pool2d on the channels-last view": lambda: (
            lambda x: F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1, count_include_pad=True).permute(0, 2, 3, 1)
        ),
        "avg_pool_3x3_s2": lambda: B.avg_pool_3x3_s2,
        "Conv 1x1": lambda: conv(1, 1),
        "Conv 3x3": lambda: conv(3, 1),
        "Conv 3x3 dilation 2": lambda: conv(3, 2),
        "Conv 2x2 dilation 2": lambda: conv(2, 2),
        "leaky_relu": lambda: B.leaky_relu,
        "BatchNorm (train)": lambda: B.BatchNorm(32, device="cpu").train(),
        "pixel_shuffle": lambda: (lambda x: B.pixel_shuffle(x, 2)),
        "SalsaResBlock (train, no dropout)": lambda: B.SalsaResBlock(32, 16, drop_out=False, device="cpu").train(),
    }
    for name, make in ops.items():
        op = make()
        if isinstance(op, torch.nn.Module):
            with torch.no_grad():
                for q in op.parameters():
                    q.copy_(torch.randn(q.shape, generator=gen) * 0.1)
        res = {}
        for dev in ("cpu", "cuda"):
            m = op.to(dev) if isinstance(op, torch.nn.Module) else op
            x = x0.detach().to(dev).clone().requires_grad_()
            y = m(x)
            ys = y if isinstance(y, tuple) else (y,)
            gs = [torch.randn(t.shape, generator=torch.Generator().manual_seed(1)).to(dev) for t in ys]
            torch.autograd.backward(list(ys), gs)
            params = list(m.parameters()) if isinstance(m, torch.nn.Module) else []
            res[dev] = ([t.detach().cpu() for t in ys], x.grad.detach().cpu(), [q.grad.detach().cpu() for q in params])
            if params:
                m.zero_grad(set_to_none=True)
                m.to("cpu")

        def rel(a, b):
            return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()

        fw = max(rel(a, b) for a, b in zip(res["cuda"][0], res["cpu"][0]))
        gx = rel(res["cuda"][1], res["cpu"][1])
        gw = max([rel(a, b) for a, b in zip(res["cuda"][2], res["cpu"][2])] or [0.0])
        print(f"{name:40s} output {fw:.3e}  d input {gx:.3e}  d params {gw:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
