"""Per-call tables of K4 (`k3_conv_dw`) and K3-up (`upsample_conv_apply`)
on one GPU.

    python3 tools/k4_calls.py [--variants] [--fsa]

Builds MinkUNet mk34 cr1.0 in bf16 (seeded weights; with --fsa the FSA
recipe, MinkUNetMs mk34 cr1.0, on a fused cloud of
SyntheticMsKittiReader at 262 144 rows, as chip_smoke.py's phase 5f),
captures one train step on a synthetic 120 000-point scan and one
serving forward, and
prints, beside the card's name and power limit, one row per distinct
call, each time from the profiler's device events (mean of 10 calls, no
host cost):

  K4    level, V, present pairs, widths, its count in the step; the wgmma
        route with its plan (`f3conv.k4_plan`: consumer warpgroups,
        columns, tiles, pairs per split, live blocks), the same call with
        every list in one piece (`f3conv.k4_one_split`: no partials and no
        sum of pieces), the mma.sync tile it replaced (through its C
        entry), one `torch.mm` over the rows gathered beforehand, and the
        bound (inputs read once, d_W written once; present-pair
        operations at the bf16 rate); the bytes the pieces move (each
        split's partial written, read and summed by the last block) and
        their time at the HBM rate;
  K3-up level, V_fine, widths, forward or input gradient, its count; the
        wgmma route over the up table, the mma.sync tile it replaced, one
        `torch.mm` over gathered rows, the bound, and the tile work over
        present rows (over the up table's order, and in table order).

and the sums over a step.  With --variants it also times every K4 call
at the other consumer-warpgroup count (1 <-> 2, with its own target), to
show where the 128-row tile pays, and at twice the plan's target (two
waves of shorter pieces).
Every kernel's result is held to its plain version first.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def piece_bytes(pairs, plan, c_in: int, c_out: int) -> int:
    """Bytes the pieces of one K4 call move through device memory: each
    split of a list of several writes its (C_in, C_out) f32 partial, and
    the last block reads them all and writes the sum (the pairs per split
    as `lists::split_pairs` takes them from the lists' lengths)."""
    from taseg_tpu_torch.ops import f3conv as tf3

    s = pairs.starts.tolist()
    per = tf3.k4_split_pairs(s, plan.per_min, plan.target)
    out = 0
    for k in range(27):
        live = max(1, -(-(s[k + 1] - s[k]) // per))
        if live > 1:
            out += (2 * live + 1) * c_in * c_out * 4
    return out


def variants(plan, c_in: int, c_out: int) -> list:
    """(label, plan) of the --variants columns: the other warpgroup count
    with its own one-wave target, and the plan's tile at twice its
    target."""
    from taseg_tpu_torch.ops import f3conv as tf3

    cw = 3 - plan.cw
    tiles = tf3.k4_tiles(c_in, c_out, cw, plan.bn)
    other = plan._replace(cw=cw, target=-(-tf3.K4_SMS * tf3.k4_resident(cw, plan.bn) // tiles))
    return [(f"cw {cw}", other), ("two waves", plan._replace(target=2 * plan.target))]


def k4_rows(cap, caps, torch, more: bool) -> None:
    import chip_smoke as cs
    from taseg_tpu_torch.ops import f3conv as tf3

    frags = cs.KERNEL_NAMES["k3_conv_dw"]
    head = ("| level | V | pairs | C_in -> C_out | x/step | plan (cw, bn, tiles, per, blocks) | wgmma ms "
            "| one piece ms | old ms | torch.mm ms | bound ms | pieces' bytes MB (ms at HBM) |")
    if more:
        head += " other cw ms | two waves ms |"
    print(head)
    print("|" + " --- |" * (head.count("|") - 1))
    tot = {"new": 0.0, "one": 0.0, "old": 0.0, "mm": 0.0, "bound": 0.0, "cw": 0.0, "target": 0.0}
    for key, (a, kw) in sorted(cap.seen.items(), key=lambda kv: str(kv[0])):
        if key[0] != "k3_conv_dw":
            continue
        x, g, rb, pairs = a[0], a[1], a[2], kw.get("pairs")
        v, ci = x.shape
        co = g.shape[1]
        if tf3.dw_route(x.dtype, ci, co) != "wgmma":
            continue
        n = cap.count[key]
        got = tf3.k3_conv_dw_wgmma(x, g, pairs)
        cs.check_close(f"K4 {key}", got, tf3.k3_conv_dw_plain(x, g, rb),
                       tf3.k3_conv_dw_plain(x.abs(), g.abs(), rb), "float32", 1e-4)
        plan, one = tf3.k4_plan(v, ci, co), tf3.k4_one_split(v, ci, co)
        present = int(pairs.starts[-1])
        s = pairs.starts.tolist()
        per = tf3.k4_split_pairs(s, plan.per_min, plan.target)
        tiles = tf3.k4_tiles(ci, co, plan.cw, plan.bn)
        blocks = tiles * sum(max(1, -(-(s[k + 1] - s[k]) // per)) for k in range(27))
        new = cs.device_ms(lambda: tf3.k3_conv_dw_wgmma(x, g, pairs), frags)
        single = cs.device_ms(lambda: tf3.k3_conv_dw_wgmma(x, g, pairs, one), frags)
        old = cs.device_ms(lambda: cs.old_k4(x, g, pairs), ("K3Lists",))
        mm = cs.device_ms(cs.dw_library("k3_conv_dw", x, g, rb), ("",))
        b, by = cs.bound_ms(v * (ci + co) * 2 + rb.numel() * 4 + 27 * ci * co * 4,
                            2.0 * present * ci * co, "bfloat16")
        pb = piece_bytes(pairs, plan, ci, co)
        row = (
            f"| {caps.index(v) if v in caps else '?'} | {v} | {present} | {ci} -> {co} | {n} | "
            f"({plan.cw}, {plan.bn}, {tiles}, {per}, {blocks}) | {cs.fmt_ms(new)} | "
            f"{cs.fmt_ms(single)} | {cs.fmt_ms(old)} | {cs.fmt_ms(mm)} | {b:.4f} ({by}) | "
            f"{pb / 1e6:.2f} ({pb / cs.HBM_BYTES_PER_S * 1e3:.4f}) |"
        )
        if more:
            for (label, alt), k in zip(variants(plan, ci, co), ("cw", "target")):
                cs.check_close(f"K4 {key} {label}", tf3.k3_conv_dw_wgmma(x, g, pairs, alt), got,
                               tf3.k3_conv_dw_plain(x.abs(), g.abs(), rb), "float32", 1e-4)
                o = cs.device_ms(lambda: tf3.k3_conv_dw_wgmma(x, g, pairs, alt), frags)
                row += f" {cs.fmt_ms(o)} ({label}) |"
                tot[k] += n * (o or 0.0)
        print(row, flush=True)
        for k, val in (("new", new), ("one", single), ("old", old), ("mm", mm), ("bound", b)):
            tot[k] += n * (val or 0.0)
    print(
        f"K4 wgmma per step (47 calls): {tot['new']:.4f} ms device; one piece per list "
        f"{tot['one']:.4f}; the mma.sync tile {tot['old']:.4f}; torch.mm {tot['mm']:.4f}; "
        f"bound {tot['bound']:.4f}"
        + (f"; other cw {tot['cw']:.4f}; two waves {tot['target']:.4f}" if more else "")
    )


def up_rows(calls, torch) -> None:
    import chip_smoke as cs
    from taseg_tpu_torch.ops import sparse_conv as tsc
    from taseg_tpu_torch.ops import strided_conv as tst

    head = ("| level (fine) | V_fine | C_in -> C_out | call | x | wgmma ms | old ms | torch.mm ms "
            "| bound ms | tile work (table order) |")
    print(head)
    print("|" + " --- |" * (head.count("|") - 1))
    tot = {}
    for what, caps, n, x, w, t in calls:
        v = t.parent.shape[0]
        ci, co = w.shape[1], w.shape[2]
        got = tst.upsample_conv_apply(x, w, t)
        want, ref = tst.upsample_conv_plain(x, w, t), tst.upsample_conv_plain(x.abs(), w.abs(), t)
        cs.check_close(f"K3-up {what} {v} {ci}->{co}", got, want, ref, "bfloat16", 1e-5)
        cs.check_close(f"K3-up old {what}", cs.old_call("strided_up", x, w, t), want, ref, "bfloat16", 1e-5)
        new = cs.device_ms(lambda: tst.upsample_conv_apply(x, w, t), ("UpSlots",))
        old = cs.device_ms(lambda: cs.old_call("strided_up", x, w, t), ("strided_up_mma",))
        a = cs.gathered_rows(x, t.up)
        b2 = w.reshape(-1, co)
        mm = cs.device_ms(lambda: torch.mm(a, b2), ("",))
        del a
        live = int((t.parent >= 0).sum())
        nbytes = (x.numel() + w.numel() + v * co) * 2 + 4 * (3 * v + t.starts.shape[0])
        b, by = cs.bound_ms(nbytes, 2.0 * live * ci * co, "bfloat16")
        work, before = tsc.tile_work(t.up, t.up_order), tsc.tile_work(t.up)
        print(
            f"| {caps.index(v) if v in caps else '?'} | {v} | {ci} -> {co} | {what} | {n} | {cs.fmt_ms(new)} | "
            f"{cs.fmt_ms(old)} | {cs.fmt_ms(mm)} | {b:.4f} ({by}) | {work / max(live, 1):.2f}x "
            f"({before / max(live, 1):.2f}x) |", flush=True,
        )
        r = tot.setdefault(what, [0.0, 0.0, 0.0, 0.0])
        for i, val in enumerate((new, old, mm, b)):
            r[i] += n * (val or 0.0)
    for what, (new, old, mm, b) in tot.items():
        print(f"K3-up {what}: wgmma {new:.4f} ms device, the mma.sync tile {old:.4f}, torch.mm {mm:.4f}, "
              f"bound {b:.4f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", action="store_true",
                    help="also time K4 at the other warpgroup count and at two waves of pieces")
    ap.add_argument("--fsa", action="store_true", help="the FSA recipe on a fused cloud")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: tools/k4_calls.py needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from taseg_tpu_torch.configs import MINKUNET_MK34_CR10, MINKUNET_MK34_CR10_FSA
    from taseg_tpu_torch.engine import Segmenter, Trainer
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    cfg = MINKUNET_MK34_CR10_FSA if args.fsa else MINKUNET_MK34_CR10
    print("FSA, MinkUNetMs mk34 cr1.0" if args.fsa else "MinkUNet mk34 cr1.0")
    params, stats = init_params_numpy(cfg, seed=cs.SEED)
    variables = {"params": params, "batch_stats": stats}
    scans = cs.fsa_scans(1) if args.fsa else cs.make_scans(1)
    trainer = Trainer(cfg, variables, iters_per_epoch=cs.TRAIN_STEPS,
                      total_epochs=cfg["OPTIM"]["NUM_EPOCHS"], compute_dtype="bfloat16", seed=cs.SEED)
    trainer.step(scans)  # warm: the build and the first step's allocations
    cap = cs.capture_train_calls(trainer, scans)
    k4_rows(cap, list(trainer.caps.voxels), torch, args.variants)

    seg = Segmenter(cfg, variables, compute_dtype="bfloat16")
    arrays = seg.collate(scans)
    topo = seg.topology(arrays)
    fwd = cs.Capture(seg.model)
    seg.forward(arrays, topo)
    fwd.remove()
    calls = [
        ("forward", list(seg.caps.voxels), fwd.count[key], feats.to(torch.bfloat16).contiguous(),
         w32.to(torch.bfloat16).contiguous(), table)
        for key, (feats, w32, table) in sorted(fwd.seen.items(), key=lambda kv: str(kv[0]))
        if key[0] == "strided_up"
    ]
    calls += [
        ("input gradient", list(trainer.caps.voxels), cap.count[key], a[0], a[1], a[2])
        for key, (a, kw) in sorted(cap.seen.items(), key=lambda kv: str(kv[0]))
        if key[0] == "strided_up"
    ]
    up_rows(calls, torch)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
