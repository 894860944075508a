"""Time K8 (`voxelize_bwd`, the gradient of the voxelize mean) in each of
its layouts on the card: the rows layout (one thread a (point, piece),
the piece the widest of 16 / 8 / 4 / 2 bytes the row allows), the flat
layout (16 bytes of the flat output a thread), the first K8 kernel (the
wrapper's pick, `voxelize.voxelize_bwd_plan`, is printed beside), and
one `index_select` of g's rows divided by their counts beforehand:
`cuda_ms` (CUDA events over 20 calls, the host's cost a launch
included) and the device time (torch.profiler).

The shapes are SPVCNN cr 1.6's point widths (51 bf16, 204 and 409 f32,
153 bf16) and cr 1.0's (32 and 96 bf16, 256 f32) on 120 000 points over
seeded random voxel maps (5% of the points without a voxel); every
layout is checked bit-equal to the plain version first.  Prints one line
per shape and, last, one JSON object with every time.

    python3 tools/k8_layouts.py

Needs the card (the kernels build at first use).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SHAPES = [  # (dtype, C, voxels)
    ("bfloat16", 51, 80_000), ("float32", 204, 20_000), ("float32", 409, 5_000), ("bfloat16", 153, 5_000),
    ("bfloat16", 32, 80_000), ("bfloat16", 96, 20_000), ("float32", 256, 5_000),
]
POINTS = 120_000


def cuda_ms(fn, iters: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, iters: int = 20):
    """Mean device time per call of fn's kernels (torch.profiler), None
    where the profiler caught fewer kernels than calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    ev = [e for e in prof.key_averages() if e.device_type != torch.autograd.DeviceType.CPU]
    if sum(e.count for e in ev) < iters:
        return None
    return sum(e.self_device_time_total for e in ev) / 1e3 / iters


def main() -> int:
    import numpy as np
    import torch

    from taseg_tpu_torch.ops import _build
    from taseg_tpu_torch.ops import voxelize as vx
    from taseg_tpu_torch.ops.sparse_conv import DTYPE_CODES
    from taseg_tpu_torch.ops.voxelize import K8_LAYOUTS

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lib = _build.get_lib()
    rng = np.random.default_rng(0)
    res = []
    for dt_name, c, v in SHAPES:
        dt = getattr(torch, dt_name)
        inv = rng.integers(0, v, POINTS).astype(np.int32)
        inv[rng.random(POINTS) < 0.05] = -1
        inv_t = torch.from_numpy(inv).cuda()
        counts = torch.bincount(inv_t[inv_t >= 0].long(), minlength=v).int()
        g = torch.from_numpy(rng.normal(size=(v, c)).astype(np.float32)).cuda().to(dt)
        want = vx._voxelize_bwd_plain(g, inv_t, counts)
        out = torch.empty_like(want)

        def run(layout):
            err = lib.taseg_voxelize_bwd(
                g.data_ptr(), inv_t.data_ptr(), counts.data_ptr(), out.data_ptr(), POINTS, c,
                DTYPE_CODES[dt], layout, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if err:
                raise RuntimeError(f"layout {layout}: CUDA error {err}")

        row = {"dtype": dt_name, "c": c, "voxels": v, "points": POINTS, "row_bytes": c * g.element_size(),
               "picked": vx.voxelize_bwd_plan(c, g.element_size(), g.data_ptr() % 16, POINTS * c)[0]}
        for name, layout in K8_LAYOUTS.items():
            run(layout)
            if not torch.equal(out.view(torch.int16 if dt == torch.bfloat16 else torch.int32),
                               want.view(torch.int16 if dt == torch.bfloat16 else torch.int32)):
                raise AssertionError(f"{dt_name} C={c} layout {name}: differs from the plain version")
            row[f"{name}_ms"] = cuda_ms(lambda: run(layout))
            row[f"{name}_device_ms"] = device_ms(lambda: run(layout))
        scaled = torch.cat([g / counts.clamp(min=1).to(dt)[:, None], g.new_zeros(1, c)])
        idx = torch.where(inv_t >= 0, inv_t, v).long()
        row["index_select_ms"] = cuda_ms(lambda: torch.index_select(scaled, 0, idx))
        row["index_select_device_ms"] = device_ms(lambda: torch.index_select(scaled, 0, idx))
        used = int((counts > 0).sum())
        nbytes = POINTS * c * g.element_size() + used * (c * g.element_size() + 4) + POINTS * 4
        row["bound_ms"] = nbytes / 3.35e12 * 1e3
        print(" ".join(f"{k}={val:.4f}" if isinstance(val, float) else f"{k}={val}" for k, val in row.items()),
              flush=True)
        res.append(row)
    print(json.dumps({"card": smi, "k8_layouts": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
