#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one GPU.

    python3 tools/profile_port.py [--scans 3] [--dtype bfloat16] [--top 30]

Runs `Segmenter` (MinkUNet mk34 cr1.0, seeded weights) on synthetic
120 000-point scans, warms up, then traces topology + forward of every
scan with `torch.profiler` and prints:
  * device time per kernel name (top N), summed over the traced scans
    and divided by their number;
  * device busy time (the sum of all kernel times: one stream, so they
    do not overlap) and its share of the traced wall time;
  * per-stage device time (topology, forward) from CUDA events.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=3)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import make_scans
    from taseg_tpu_torch.configs import MINKUNET_MK34_CR10
    from taseg_tpu_torch.engine import Segmenter
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    cfg = MINKUNET_MK34_CR10
    params, stats = init_params_numpy(cfg, seed=0)
    seg = Segmenter(cfg, {"params": params, "batch_stats": stats}, compute_dtype=args.dtype)
    scans = make_scans(args.scans)
    batches = [seg.collate([s]) for s in scans]
    for a in batches:  # warm-up: kernel build, allocator, cuBLAS handles
        seg.forward(a, seg.topology(a))
    torch.cuda.synchronize()

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    topo_ms = fwd_ms = 0.0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for a in batches:
            ev[0].record()
            tp = seg.topology(a)
            ev[1].record()
            seg.forward(a, tp)
            ev[2].record()
            torch.cuda.synchronize()
            topo_ms += ev[0].elapsed_time(ev[1])
            fwd_ms += ev[1].elapsed_time(ev[2])
        wall_ms = (time.perf_counter() - t0) * 1e3
    n = len(batches)

    # device-side events only (kernels, copies, fills): a CPU op's own
    # "self device time" repeats the time of the kernels it launched
    rows = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        dev_us = e.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3 / n, e.count // n, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"{smi}; dtype {args.dtype}; {n} scans traced")
    print(f"per scan: topology {topo_ms / n:.3f} ms, forward {fwd_ms / n:.3f} ms (CUDA events)")
    print(
        f"per scan: device busy {busy:.3f} ms of {wall_ms / n:.3f} ms traced wall "
        f"({100 * busy / (wall_ms / n):.1f}% busy)"
    )
    print(f"{'ms/scan':>10} {'calls':>6}  kernel")
    for ms, calls, key in rows[: args.top]:
        print(f"{ms:10.4f} {calls:6d}  {key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
