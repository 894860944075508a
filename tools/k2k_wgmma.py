#!/usr/bin/env python3
"""Chain splits of K2 at K's 3xTF32 wgmma tile (`csrc/wgmma_tf32.cuh`) at
every call of Cylinder_TS cy480 cr1.0, on one GPU.

    python3 tools/k2k_wgmma.py

Captures every distinct K2-at-K call of Cylinder_TS (f32, seeded weights,
one synthetic 120 000-point scan): the serving forward's and one train
step's input gradients, with the topology's row orders.  Each call runs
through `sparse_conv.launch_k_tf32` (the weight's split operand kept, as
a served weight keeps it) at 1, 2, 4 and 8 chain splits, checked against
the plain version (within 1e-5 of the largest sum of |terms|), and its
device time is read from torch.profiler (`chip_smoke.device_ms`, the
tile and its split reduction).  Prints per call the tile's plan
(`sparse_conv.tf32_tile`: columns a block, column blocks, blocks an SM,
stages an offset),
its row tiles and each split count's time, then the sums over a forward
plus its input gradients for each fixed split count, for the shipped
rule (`sparse_conv.k_splits`) and for the best count per call, beside the
card's name and power limit.  Imports no JAX.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SPLITS = (1, 2, 4, 8)


def main() -> int:
    import torch

    import chip_smoke as cs
    from taseg_tpu_torch.configs import CYLINDER_CY480_CR10
    from taseg_tpu_torch.engine import Segmenter, Trainer
    from taseg_tpu_torch.ops import sparse_conv
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cfg = CYLINDER_CY480_CR10
    params, stats = init_params_numpy(cfg, seed=cs.SEED)
    variables = {"params": params, "batch_stats": stats}
    scans = cs.make_scans(1)
    seg = Segmenter(cfg, variables)
    a = seg.collate(scans)
    cap = cs.cylinder_calls(lambda: seg.forward(a, seg.topology(a)))
    trainer = Trainer(cfg, variables, iters_per_epoch=4, total_epochs=10, seed=cs.SEED)
    cap_train = cs.cylinder_calls(lambda: trainer.step(scans))
    calls = {k: (v, cap.count[k]) for k, v in cap.seen.items() if k[0] == "sparse_conv_k"}
    calls.update({k: (v, cap_train.count[k]) for k, v in cap_train.seen.items() if k[0] == "sparse_conv_k_dgrad"})
    frags = cs.KERNEL_NAMES["sparse_conv_k"]
    sums = {s: 0.0 for s in SPLITS}
    sums.update(shipped=0.0, best=0.0)
    for key, ((args, kw), n) in sorted(calls.items(), key=lambda kv: str(kv[0])):
        x, w, rb = args[:3]
        w = w.detach().clone()  # no gradient: the launch keeps its split operand
        order = kw.get("order")
        if order is None:
            order = sparse_conv.mask_row_order(rb)
        k, v_out = rb.shape
        c_in, c_out = w.shape[1], w.shape[2]
        x = x[:, :c_in].contiguous()
        ci, co = sparse_conv.padded_width(torch.float32, c_in), sparse_conv.padded_width(torch.float32, c_out)
        xp, wp = sparse_conv.pad_cols(x, ci), sparse_conv.pad_weight(w, ci, co)
        want = sparse_conv.sparse_conv_plain(x, w, rb)
        scale = sparse_conv.sparse_conv_plain(x.abs(), w.abs(), rb).abs().max().item()
        out = torch.empty_like(want)
        ms = {}
        for s in SPLITS:
            def run(s=s):
                sparse_conv.launch_k_tf32(xp, wp, rb, order, out, (), splits=s)
            run()
            err = (out - want).abs().max().item()
            if not err <= 1e-5 * scale:
                raise AssertionError(f"{key} S={s}: max|err| {err:.3e} > {1e-5 * scale:.3e}")
            ms[s] = cs.device_ms(run, frags, iters=5)
        plan = sparse_conv.tf32_tile(ci, co, k)
        tiles = -(-v_out // sparse_conv.K_TILE_ROWS)
        shipped = sparse_conv.k_splits(v_out)
        if any(v is None for v in ms.values()):
            print(f"{key}: a device time was not measured {ms}", flush=True)
            continue
        for s in SPLITS:
            sums[s] += n * ms[s]
        sums["shipped"] += n * ms[shipped]
        sums["best"] += n * min(ms.values())
        print(f"{key} x{n}: {tiles} row tiles x {plan.column_blocks} column blocks of {plan.bn}, "
              f"{plan.blocks_per_sm} blocks/SM, {plan.chunks} stages an offset; device ms "
              + " ".join(f"S={s} {ms[s]:.4f}" for s in SPLITS) + f"; shipped S={shipped}", flush=True)
    print(f"{smi}: sums over a forward and its input gradients (device ms): "
          + " ".join(f"S={s} {sums[s]:.4f}" for s in SPLITS)
          + f" shipped {sums['shipped']:.4f} best per call {sums['best']:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
