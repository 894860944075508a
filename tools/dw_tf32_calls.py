#!/usr/bin/env python3
"""Per-call table of the f32 weight gradients on their 3xTF32 wgmma tile
(`csrc/wgmma_tf32_dw.cuh`: K4 at K offsets, K5 in f32) on one GPU.

    python3 tools/dw_tf32_calls.py [--only cylinder|tiaf]

Captures one train step of Cylinder_TS cy480 cr1.0 (f32, one synthetic
120 000-point scan) and one of TIAF (the _fsa_tiaf recipe in f32 on one
sample of 5 images of 384 x 1280, as chip_smoke.py's phase 5g), and at
every distinct call of K4 at K (`f3conv.sparse_conv_dw`, the topology's
pair lists) and of K5 in f32 (`strided_conv.strided_dw`, the level's
slot lists), at the widths the wrappers pad to, prints beside the card's
name and power limit:

  the call's key, its count in the step and its present pairs; the
  tile's plan (`f3conv.dw_tf32_plan`: columns a block, blocks a piece,
  target); device ms (torch.profiler, mean of 5 calls, no host cost) of
  the tile with the pieces' target at 1, 2, 4 and 8 waves of the SMs
  (`waves`: 1 is the shipped plan when `f3conv.DW_TF32_WAVES` is 1) and
  with every list in one piece (`one`), of the mma.sync 3xTF32 tile it
  replaced (through its C entry), and the bound (inputs read once, d_W
  written once; present-pair operations at 3xTF32's rate);

then the sums over each step for every variant, for the shipped plan and
for the best variant per call.  Every result is held to the plain version
first (1e-4 of the largest sum of |terms|).  Imports no JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

WAVES = (1, 2, 4, 8)
NEW = ("dw_tf32_wgmma_kernel",)


def calls_of(cap) -> list:
    """[(key, count, arguments, keywords)] of the K4-at-K and K5 calls of
    one captured step."""
    return [(key, cap.count[key], a, kw) for key, (a, kw) in sorted(cap.seen.items(), key=lambda kv: str(kv[0]))
            if key[0] in ("sparse_conv_dw", "strided_dw")]


def main() -> int:
    import torch

    import chip_smoke as cs
    from taseg_tpu_torch.configs import CYLINDER_CY480_CR10, MINKUNET_MK34_CR10_FSA_TIAF
    from taseg_tpu_torch.engine import Trainer
    from taseg_tpu_torch.ops import f3conv, strided_conv
    from taseg_tpu_torch.ops.sparse_conv import pad_cols, padded_width
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("cylinder", "tiaf"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    paths = []
    if args.only in (None, "cylinder"):
        cfg = CYLINDER_CY480_CR10
        params, stats = init_params_numpy(cfg, seed=cs.SEED)
        scans = cs.make_scans(1)
        tr = Trainer(cfg, {"params": params, "batch_stats": stats}, iters_per_epoch=4, total_epochs=10,
                     seed=cs.SEED)
        paths.append(("cylinder", calls_of(cs.cylinder_calls(lambda: tr.step(scans)))))
        del tr
    if args.only in (None, "tiaf"):
        base = MINKUNET_MK34_CR10_FSA_TIAF
        cfg = {**base, "MODEL": {**base["MODEL"], "FIX_PART_PARAM": True}}
        params, stats = init_params_numpy(cfg, seed=cs.SEED)
        scans = cs.tiaf_scans(1)
        tr = Trainer(cfg, {"params": params, "batch_stats": stats}, iters_per_epoch=2,
                     total_epochs=cfg["OPTIM"]["NUM_EPOCHS"], seed=cs.SEED)
        paths.append(("tiaf", calls_of(cs.tiaf_calls(tr, scans))))
        del tr
    torch.cuda.empty_cache()

    for path, calls in paths:
        variants = [f"waves={w}" for w in WAVES] + ["one", "mma.sync"]
        sums = {v: 0.0 for v in variants + ["shipped", "best", "bound"]}
        for key, n, a, kw in calls:
            x, y = a[0].detach(), a[1].detach()
            if key[0] == "sparse_conv_dw":
                rb = a[2]
                k, v_in = rb.shape
                lists = kw.get("pairs") if kw.get("pairs") is not None else f3conv.pair_lists(rb)
                n_out, max_pairs, capacity, mode, entry = k, v_in, k * v_in, k, "taseg_sparse_conv_dw_tf32"
                want, ref = f3conv.k3_conv_dw_plain(x, y, rb), f3conv.k3_conv_dw_plain(x.abs(), y.abs(), rb)
                old = lambda: cs.old_dw_tf32(x, y, rb, lists)  # noqa: E731
            else:
                t, up = a[2], (a[3] if len(a) > 3 else kw["up"])
                lists = t.pairs if t.pairs is not None else strided_conv.slot_pair_lists(t)
                n_out, max_pairs, capacity, mode, entry = 8, t.parent.shape[0], t.parent.shape[0], int(up), \
                    "taseg_strided_dw_tf32"
                want = strided_conv.strided_dw_plain(x, y, t, up)
                ref = strided_conv.strided_dw_plain(x.abs(), y.abs(), t, up)
                old = lambda: cs.old_k5_tf32(x, y, t, up)  # noqa: E731
            c_in, c_out = x.shape[1], y.shape[1]
            ci, co = padded_width(torch.float32, c_in), padded_width(torch.float32, c_out)
            xp, yp = pad_cols(x, ci), pad_cols(y, co)
            plan = f3conv.dw_tf32_plan(ci, co)
            res = f3conv.dw_tf32_resident(plan.bn)
            plans = {f"waves={w}": plan._replace(target=-(-w * f3conv.K4_SMS * res // plan.tiles))
                     for w in WAVES}
            plans["one"] = plan._replace(target=0, per_min=max(max_pairs, 1))
            ms = {}
            for name, p in plans.items():
                def run(p=p):
                    return f3conv.launch_dw_tf32(entry, "", xp, yp, lists, n_out, max_pairs, capacity, mode,
                                                 plan=p)[:, :c_in, :c_out]
                cs.check_close(f"{path} {key} {name}", run(), want, ref, "float32", 1e-4)
                ms[name] = cs.device_ms(run, NEW, iters=5)
            cs.check_close(f"{path} {key} mma.sync", old(), want, ref, "float32", 1e-4)
            ms["mma.sync"] = cs.device_ms(old, cs.OLD_DW_KERNELS, iters=5)
            pairs = int(lists.starts[-1] - lists.starts[0])
            nbytes = (x.numel() + y.numel() + 2 * pairs + n_out * c_in * c_out) * 4
            bound, by = cs.bound_ms(nbytes, 2.0 * pairs * c_in * c_out, "tf32x3")
            print(f"{path} {key} x{n} pairs={pairs} bn={plan.bn} tiles={plan.tiles} target={plan.target}: "
                  + " ".join(f"{v} {cs.fmt_ms(ms[v])}" for v in variants) + f" bound {bound:.4f} ({by})",
                  flush=True)
            if any(ms[v] is None for v in variants):
                print(f"{path} {key}: a device time was not measured, left out of the sums", flush=True)
                continue
            for v in variants:
                sums[v] += n * ms[v]
            sums["shipped"] += n * ms[f"waves={f3conv.DW_TF32_WAVES}"]
            sums["best"] += n * min(ms[v] for v in variants if v != "mma.sync")
            sums["bound"] += n * bound
        print(f"{smi}: {path} step sums (device ms): " + " ".join(f"{v} {t:.4f}" for v, t in sums.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
