#!/usr/bin/env python3
"""What sets the pace of K2's tensor-core kernel, on one GPU.

    python3 tools/k2_pace.py

Captures every distinct K2 shape of the main path (MinkUNet mk34 cr1.0,
bf16, one synthetic 120 000-point scan, seeded weights) and times the
kernel (CUDA events, mean of 20 launches) on four rulebooks of each shape:

  real    the path's rulebook;
  local   the same present (offset, row) entries, each pointing at the
          output row itself: the same stages and bytes as `real`, but
          every gather reads contiguous rows;
  dense   every offset present for every row with a valid voxel: 27
          stages per C_in chunk in every such tile, contiguous rows;
  empty   no offset present: table load, presence scan and store only.

For each it prints the tile-level operations (64 rows x C_in x the
block's columns, for every offset that some row of a 64-row tile needs)
and the rate reached, per shape and summed over a scan, beside the card's
name and power limit.  Imports no JAX.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BM, BK = 64, 32  # csrc/gather_mma.cuh kBM, kBK


def tile_n(c_out: int) -> int:
    """csrc/gather_mma.cuh with_tile_n."""
    for bn in (32, 64, 96):
        if c_out <= bn:
            return bn
    return 128


def tile_ops(rb, c_in: int, c_out: int) -> float:
    """Operations the kernel issues for this rulebook."""
    import torch

    v = rb.shape[1]
    pad = (-v) % BM
    hit = torch.nn.functional.pad((rb >= 0).to(torch.int8), (0, pad))
    present = hit.reshape(27, -1, BM).amax(-1) > 0
    bn = tile_n(c_out)
    cols = -(-c_out // bn) * bn
    return 2.0 * BM * int(present.sum()) * (-(-c_in // BK) * BK) * cols


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from chip_smoke import Capture, cuda_ms, make_scans
    from taseg_tpu_torch.configs import MINKUNET_MK34_CR10
    from taseg_tpu_torch.engine import Segmenter
    from taseg_tpu_torch.ops.sparse_conv import route, sparse_conv_k3
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    params, stats = init_params_numpy(MINKUNET_MK34_CR10, seed=0)
    seg = Segmenter(
        MINKUNET_MK34_CR10, {"params": params, "batch_stats": stats},
        compute_dtype="bfloat16",
    )
    arrays = seg.collate(make_scans(1))
    topo = seg.topology(arrays)
    cap = Capture(seg.model)
    seg.forward(arrays, topo)
    cap.remove()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    variants = ("real", "local", "dense", "empty")
    tot = {k: [0.0, 0.0] for k in variants}  # ms, ops per scan
    print(
        "rows C_in C_out x/scan blocks | " + " | ".join(
            f"{k} ms TFLOP/s" for k in variants
        )
    )
    for key, (feats, w32, rb) in sorted(cap.seen.items(), key=lambda kv: str(kv[0])):
        name, rows, c_in, c_out = key
        if name != "sparse_conv_k3" or route(torch.bfloat16, c_in, c_out) != "mma":
            continue
        count = cap.count[key]
        x = feats.to(torch.bfloat16).contiguous()
        w = w32.to(torch.bfloat16).contiguous()
        own = torch.arange(rows, dtype=torch.int32, device=rb.device).expand(27, rows)
        valid = (rb >= 0).any(0, keepdim=True).expand(27, rows)
        rbs = {
            "real": rb,
            "local": torch.where(rb >= 0, own, -1).contiguous(),
            "dense": torch.where(valid, own, -1).contiguous(),
            "empty": torch.full_like(rb, -1),
        }
        blocks = -(-rows // BM) * -(-c_out // tile_n(c_out))
        cells = []
        for k in variants:
            ms = cuda_ms(lambda: sparse_conv_k3(x, w, rbs[k]), iters=20)
            ops = tile_ops(rbs[k], c_in, c_out)
            tot[k][0] += count * ms
            tot[k][1] += count * ops
            cells.append(f"{ms:.4f} {ops / ms / 1e9:.1f}")
        print(f"{rows} {c_in} {c_out} x{count} {blocks} ({blocks / n_sm:.2f}/SM) | " + " | ".join(cells))
    print(
        "per scan (tensor-core launches): " + ", ".join(
            f"{k} {ms:.3f} ms {ops / 1e9:.1f} GFLOP {ops / ms / 1e9:.1f} TFLOP/s"
            for k, (ms, ops) in tot.items()
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
