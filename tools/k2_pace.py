"""What sets the pace of K2's wgmma kernel, on one GPU.

    python3 tools/k2_pace.py [--splits]

Captures every distinct K2 shape of the main path (MinkUNet mk34 cr1.0,
bf16, one synthetic 120 000-point scan, seeded weights) and times the
wgmma kernel (CUDA events, mean of 20 launches) on four rulebooks of
each shape, each over its row order (`mask_row_order`) and in table
order (the identity order):

  real    the path's rulebook;
  local   the same present (offset, row) entries, each pointing at the
          output row itself: the same stages and bytes as `real`, but
          every gather reads contiguous rows;
  dense   every offset present for every row with a valid voxel: 27
          stages per C_in chunk in every such tile, contiguous rows;
  empty   no offset present: table load, presence scan and store only;

and the mma.sync tile it replaced (`taseg_sparse_conv_k3_mma`, table order) on
`real`.  For each it prints the tile-level operations (64 rows x C_in x
C_out, for every offset that some row of a 64-row tile needs:
`sparse_conv.tile_work`) and the rate reached, per shape and summed over
a scan, with the blocks the card keeps resident per SM and the grid's
blocks per SM (split chains included), beside the card's name and power
limit.  With --splits it also prints, from the profiler's device events
(no host cost), each K2 shape's time over the real table with its chain
cut into 1, 2, 3, 4, 6 and 8 parts (`sparse_conv.wgmma_splits` fixed to
each), and each K3-down shape of the path (the down convs and, on W^T,
the up convs' input gradients) on the wgmma route at 1 and 2 parts
beside the mma.sync round tile and one `torch.mm` (what chose the split
rule).
Imports no JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def sweep(cap, torch) -> None:
    """--splits: device ms (profiler) of every K2 and K3-down shape of
    the path at fixed part counts, beside the mma.sync tiles."""
    from chip_smoke import device_ms, gathered_rows, old_call
    from taseg_tpu_torch.ops import sparse_conv as tsc
    from taseg_tpu_torch.ops import strided_conv as tst

    frags = ("sparse_conv_wgmma",)
    rule = tsc.wgmma_splits
    try:
        for key, (feats, w32, table) in sorted(cap.seen.items(), key=lambda kv: str(kv[0])):
            name, rows, c_in, c_out = key
            if name == "sparse_conv_k3" and tsc.route(torch.bfloat16, c_in, c_out) == "wgmma":
                x = feats.to(torch.bfloat16).contiguous()
                w = w32.to(torch.bfloat16).contiguous()
                cells = []
                for s in (1, 2, 3, 4, 6, 8):
                    tsc.wgmma_splits = lambda *shape, s=s: s
                    ms = device_ms(lambda: tsc.sparse_conv_k3(x, w, table.rb, order=table.order), frags, 5)
                    cells.append(f"{s}: {ms:.4f}")
                tsc.wgmma_splits = rule
                old = device_ms(lambda: old_call(name, x, w, table.rb), ("k3_conv_mma",), 5)
                print(f"K2 {rows} {c_in}->{c_out} x{cap.count[key]} rule {rule(rows, 27, c_in)} device ms by parts "
                      + ", ".join(cells) + f"; mma.sync tile {old:.4f}")
            elif name in ("strided_down", "strided_up"):
                # the down conv, or (on W^T) the up conv's input gradient
                w = w32.to(torch.bfloat16).contiguous()
                if name == "strided_up":
                    w = w.transpose(1, 2).contiguous()
                v_fine = table.parent.shape[0]
                x = torch.randn(v_fine, w.shape[1], device=w.device).to(torch.bfloat16)
                cells = []
                for s in (1, 2):
                    tsc.wgmma_splits = lambda *shape, s=s: s
                    ms = device_ms(lambda: tst.downsample_conv_apply(x, w, table), frags, 5)
                    cells.append(f"{s}: {ms:.4f}")
                tsc.wgmma_splits = rule
                old = device_ms(lambda: old_call("strided_down", x, w, table), ("strided_down",), 5)
                a = gathered_rows(x, table.child[0])
                b = w.reshape(-1, w.shape[2])
                lib = device_ms(lambda: torch.mm(a, b), ("",), 5)  # every kernel of the call
                what = "down" if name == "strided_down" else "up's input gradient"
                print(f"K3-down ({what}) {v_fine}->{table.starts.shape[0] - 1} {w.shape[1]}->{w.shape[2]} "
                      f"rule {rule(table.starts.shape[0] - 1, 8, w.shape[1])} device ms by parts "
                      + ", ".join(cells) + f"; round tile {old:.4f}; torch.mm {lib:.4f}")
    finally:
        tsc.wgmma_splits = rule


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splits", action="store_true", help="also the split sweep and K3-down")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from chip_smoke import Capture, cuda_ms, make_scans, old_call
    from taseg_tpu_torch.configs import MINKUNET_MK34_CR10
    from taseg_tpu_torch.engine import Segmenter
    from taseg_tpu_torch.ops import _build
    from taseg_tpu_torch.ops.sparse_conv import (
        mask_row_order,
        route,
        sparse_conv_k3,
        tile_work,
        wgmma_splits,
    )
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

    variants = [(k, o) for k in ("real", "local", "dense", "empty") for o in ("order", "table")]
    tot = {v: [0.0, 0.0] for v in variants + [("real", "mma.sync tile")]}  # ms, ops per scan
    print(
        "rows C_in C_out x/scan resident/SM grid/SM | " + " | ".join(
            f"{k} {o} ms TFLOP/s" for k, o in tot
        )
    )
    for key, (feats, w32, table) in sorted(cap.seen.items(), key=lambda kv: str(kv[0])):
        name, rows, c_in, c_out = key
        if name != "sparse_conv_k3" or route(torch.bfloat16, c_in, c_out) != "wgmma":
            continue
        rb = table.rb
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
        ident = torch.arange(rows, dtype=torch.int32, device=rb.device)
        resident = _build.wgmma_blocks_per_sm(c_in, c_out, 27)
        grid = -(-rows // 64) * max(1, -(-c_out // 256)) * wgmma_splits(rows, 27, c_in)
        cells = []
        for k, o in variants:
            order = mask_row_order(rbs[k]) if o == "order" else ident
            ms = cuda_ms(lambda: sparse_conv_k3(x, w, rbs[k], order=order), iters=20)
            ops = 2.0 * tile_work(rbs[k], order) * c_in * c_out
            tot[(k, o)][0] += count * ms
            tot[(k, o)][1] += count * ops
            cells.append(f"{ms:.4f} {ops / ms / 1e9:.1f}")
        ms = cuda_ms(lambda: old_call("sparse_conv_k3", x, w, rb), iters=20)
        ops = 2.0 * tile_work(rb) * c_in * c_out
        tot[("real", "mma.sync tile")][0] += count * ms
        tot[("real", "mma.sync tile")][1] += count * ops
        cells.append(f"{ms:.4f} {ops / ms / 1e9:.1f}")
        print(f"{rows} {c_in} {c_out} x{count} {resident} {grid / n_sm:.2f} | " + " | ".join(cells))
    print(
        "per scan: " + ", ".join(
            f"{k} {o} {ms:.3f} ms {ops / 1e9:.1f} GFLOP {ops / ms / 1e9:.1f} TFLOP/s"
            for (k, o), (ms, ops) in tot.items()
        )
    )
    if args.splits:
        sweep(cap, torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
