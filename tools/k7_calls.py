"""Per-call device times of K7 (`devoxelize`) and of the MinkUNet head's
point side on one GPU.

    python3 tools/k7_calls.py [--pkg DIR]

`--pkg DIR` times the `taseg_tpu_torch` package under DIR (default: this
checkout), so a parent's copy unpacked beside it (`git archive`) is
timed by the same script: run parent, change, change, parent in one
call.  On one synthetic 120 000-point scan, at the flagship's real head
tables (MinkUNet mk34 cr1.0, P = 131 072 rows, the trilinear tables at
strides 16 and 4 and the identity at 1), it prints the card's name and
power limit, then, each time the profiler's device time per call (mean
of 20 calls, no host cost) beside its bound (each input read once, the
output written once, at 3.35 TB/s):

  * K7 per call at the widths the paths run: C = 20 bf16 (the head), 256
    / 128 bf16 at strides 16 / 4 and 96 at 1 (SPVCNN's z1 / z2, KD's
    features), 128 / 64 / 48 f32 (TIAF's FOV taps, on these tables);
  * the head per scan: the former sequence (three K7 calls, each cast to
    f32 and added, then the bias) and, where the package has it, the
    multi-scale entry's one launch, with every kernel of the call and
    their number;
  * KD's features: three K7 calls, `torch.cat` and the f32 cast, against
    the multi-scale cat and the cast;
  * the head's backward on a train topology: three K6 calls against one
    over the stacked pair table (`UNetTopology.devox_head`).

Every K7 result is held to its plain version's bits first; where this
call built the kernels, the compiler's report for `devoxelize.cu`
(registers, stack frame, spills) is printed first.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
ITERS = 20


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", default=str(REPO))
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs  # its timing helpers, from this checkout

    sys.path.insert(0, str(Path(args.pkg).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("k7_calls.py needs a GPU", file=sys.stderr)
        return 1
    import taseg_tpu_torch
    from taseg_tpu_torch.configs import MINKUNET_MK34_CR10
    from taseg_tpu_torch.engine import Segmenter, Trainer
    from taseg_tpu_torch.ops import voxelize as vx
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"package {Path(taseg_tpu_torch.__file__).parent}")
    from taseg_tpu_torch.ops import _build

    _build.get_lib()
    section = _build.build_info.get("log", "").split("== devoxelize.cu")[-1].split("\n== ")[0]
    for line in section.splitlines():  # ptxas: registers, stack frame, spills per kernel
        if "devox" in line or "registers" in line or "stack" in line:
            print(f"  {line.strip()[:160]}")
    cfg = MINKUNET_MK34_CR10
    p, s = init_params_numpy(cfg, seed=0)
    variables = {"params": p, "batch_stats": s}
    seg = Segmenter(cfg, variables, compute_dtype="bfloat16")
    arrays = seg.collate(cs.make_scans(1))
    topo = seg.topology(arrays)
    tables = (topo.devox[16], topo.devox[4], topo.devox[1])
    rows = [topo.levels[l].coords.shape[0] for l in (4, 2, 0)]
    pts = tables[2].inverse.shape[0]
    dev = arrays["point_feats_t"].device
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda v, c, dt: torch.randn(v, c, device=dev, generator=gen).to(dt)
    every = ("",)  # every kernel of the call
    multi = getattr(vx, "devoxelize_multi_kernel", None)

    def table_bytes(t):
        return pts * (4 if isinstance(t, vx.IdentityDevoxTable) else 64)

    def bound(nbytes):
        return cs.bound_ms(nbytes, 0.0, "float32")[0]

    def kernels_per_call(fn):
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                fn()
            torch.cuda.synchronize()
        return sum(
            e.count for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU
        ) / ITERS

    print("K7 per call (device ms; bound)")
    for dtype, widths in ((torch.bfloat16, (20, 20, 20)), (torch.bfloat16, (256, 128, 96)),
                          (torch.float32, (128, 64, 48))):
        esz = torch.finfo(dtype).bits // 8
        for stride, t, v, c in zip((16, 4, 1), tables, rows, widths):
            z = rnd(v, c, dtype)
            cs.devox_check(z, t)
            ms = cs.device_ms(lambda: vx.devoxelize(z, t), ("devox",), ITERS)
            b = bound(table_bytes(t) + v * c * esz + pts * c * esz)
            print(f"  stride {stride:2d} C={c:3d} {str(dtype)[6:]:8s} {cs.fmt_ms(ms)} bound {b:.4f} ms")

    print("the head per scan (C = 20 bf16, every kernel of the call)")
    zs = [rnd(v, 20, torch.bfloat16) for v in rows]
    bias = torch.randn(20, device=dev, generator=gen)

    def sequence():
        out = None
        for z, t in zip(zs, tables):
            c = vx.devoxelize(z, t).float()
            out = c if out is None else out + c
        return out + bias

    want = sequence()
    b = bound(sum(table_bytes(t) for t in tables) + sum(v * 20 * 2 for v in rows) + pts * 20 * 4)
    runs = [("three calls + f32 glue", sequence)]
    if multi is not None:
        runs.append(("multi-scale sum, one launch", lambda: multi(zs, tables, bias)))
    for label, fn in runs:
        if not cs.bits(fn()).equal(cs.bits(want)):
            raise AssertionError(f"{label}: differs from the three calls' bits")
        ms = cs.device_ms(fn, every, ITERS)
        print(f"  {label:30s} {cs.fmt_ms(ms)} in {kernels_per_call(fn):.0f} kernels; bound {b:.4f} ms")

    print("KD's features (256 / 128 / 96 bf16, cast to f32)")
    xs = [rnd(v, c, torch.bfloat16) for v, c in zip(rows, (256, 128, 96))]
    runs = [("three calls + cat + cast", lambda: torch.cat(
        [vx.devoxelize(x, t) for x, t in zip(xs, tables)], dim=-1).float())]
    if multi is not None:
        runs.append(("multi-scale cat + cast", lambda: multi(xs, tables).float()))
    want = runs[0][1]()
    b = bound(sum(table_bytes(t) for t in tables) + sum(v * c * 2 for v, c in zip(rows, (256, 128, 96)))
              + pts * 480 * 2)
    for label, fn in runs:
        if not cs.bits(fn()).equal(cs.bits(want)):
            raise AssertionError(f"{label}: differs from the three calls' bits")
        ms = cs.device_ms(fn, every, ITERS)
        print(f"  {label:30s} {cs.fmt_ms(ms)} in {kernels_per_call(fn):.0f} kernels; "
              f"bound (K7's part, bf16 out) {b:.4f} ms")

    print("the head's backward (K6, g (P, 20) bf16)")
    tr = Trainer(cfg, variables, iters_per_epoch=1, total_epochs=1, compute_dtype="bfloat16")
    tt = tr.topology(tr.collate(cs.make_scans(1)))
    ttab = (tt.devox[16], tt.devox[4], tt.devox[1])
    g = rnd(pts, 20, torch.bfloat16)

    def three():
        out = []
        for t in ttab:
            if isinstance(t, vx.IdentityDevoxTable):
                out.append(vx.segment_sum(g, t.tables))
            else:
                out.append(vx.segment_sum(g, t.pairs, t.weights.reshape(-1)))
        return torch.cat(out)

    runs = [("three K6 calls", three)]
    st = getattr(tt, "devox_head", None)
    if st is not None:
        runs.append(("one K6 over the stacked table", lambda: vx.segment_sum(g, st.tables, st.weights)))
    want = three()
    for label, fn in runs:
        got = fn()
        err = (got - want).abs().max().item()
        ms = cs.device_ms(fn, ("segment_sum",), ITERS)
        print(f"  {label:30s} {cs.fmt_ms(ms)}; max|diff| against three calls {err:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
