#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`taseg_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's main path — `Segmenter.predict` of MinkUNet mk34 cr1.0
(tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10.yaml) in bf16 on
synthetic 120 000-point scans, weights drawn from a seed — and checks it:

  1. the card's name and power limit (nvidia-smi);
  2. the kernel build from the sources in the checkout, with its time;
  3. one phase per kernel at the main path's real shapes (captured from
     a real forward): K1 join_scan bit-exact against its plain version,
     K2 sparse_conv_k3 and K3 strided down/up within stated tolerances,
     with kernel, plain and library times;
  4. the main path on 3 scans: finite logits of the right shape, every
     kernel's launch count above 0, bf16/f32 argmax agreement, agreement
     of the card's f32 path with the CPU's plain path on a small scan,
     and scans/s with the topology / forward split;
  5. one JSON line listing the kernels.

The last line is {"ok": true, "device": {...}}.  Any failure raises and
the exit code is not 0.  Without CUDA, or without the package beside
this file, it exits non-zero and prints no result.  It imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
N_POINTS = 120_000
N_SCANS = 3
ROUNDS = 14  # throughput samples: ROUNDS * N_SCANS scans, 10+ beyond p75
SEED = 0

# published H100 SXM peaks (NVIDIA data sheet), dense
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device time of `fn` over `iters` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_scans(n: int, n_points: int = N_POINTS, seed: int = SEED) -> list:
    import numpy as np

    from taseg_tpu_torch.data.synthetic import synthetic_scan

    rng = np.random.default_rng(seed)
    scans = []
    for _ in range(n):
        pts, labels = synthetic_scan(rng, n_points)
        ring = np.zeros((len(pts), 1), np.float32)
        scans.append(
            {"xyzret": np.concatenate([pts, ring], 1), "labels": labels}
        )
    return scans


class Capture:
    """Forward pre-hooks on every SparseConv: the first input of each
    distinct (kind, rows, C_in, C_out), and how often each occurs."""

    def __init__(self, model):
        from taseg_tpu_torch.models.layers import SparseConv
        from taseg_tpu_torch.ops.strided_conv import StridedTables

        self.seen: dict = {}
        self.count: dict = {}
        self.handles = []
        self._strided = StridedTables
        for m in model.modules():
            if isinstance(m, SparseConv) and m.kernel_volume > 1:
                self.handles.append(m.register_forward_pre_hook(self._hook))

    def _hook(self, module, args):
        feats, table = args
        if isinstance(table, self._strided):
            kind = "strided_up" if module.transposed else "strided_down"
        else:
            kind = "sparse_conv_k3"
        key = (kind, feats.shape[0], module.in_channels, module.out_channels)
        self.count[key] = self.count.get(key, 0) + 1
        if key not in self.seen:
            self.seen[key] = (feats, module.kernel.detach(), table)

    def remove(self):
        for h in self.handles:
            h.remove()


def check_close(name, got, want, ref_abs, dtype: str, rel: float) -> float:
    """max |got - want|, raising above rel * max|sum of |terms|| (f32
    summation order) plus, in bf16, one rounding of the output."""
    err = (got.float() - want.float()).abs().max().item()
    tol = rel * ref_abs.float().abs().max().item()
    if dtype == "bfloat16":
        tol += 2.0**-7 * want.float().abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: max |err| {err:.3e} > tol {tol:.3e}")
    return err


def phase_join_scan(topo, results: dict) -> None:
    """K1 on the 5 levels' unions of the real topology; both modes
    bit-exact against the plain (cummax) version on the card."""
    import torch

    from taseg_tpu_torch.ops.coords import QUERY_SENTINEL_HI
    from taseg_tpu_torch.ops.join import sorted_union
    from taseg_tpu_torch.ops.join_scan import join_scan, join_scan_plain
    from taseg_tpu_torch.ops.rulebook import k3_floor_queries

    qsent = int(QUERY_SENTINEL_HI)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for l, lt in enumerate(topo.levels):
        hi, lo, q_hi, q_lo = k3_floor_queries(lt.coords, lt.num, 2**l, topo.bounds)
        shi, slo2, srow = sorted_union(hi, lo, q_hi, q_lo)
        v, n = hi.shape[0], shi.shape[0]
        num = lt.num.reshape(1).to(torch.int32)
        for mode in (0, 1):
            got = join_scan(shi, slo2, srow, num, v, qsent, mode)
            want = join_scan_plain(shi, slo2, srow, num, v, qsent, mode)
            if not torch.equal(got, want):
                bad = (got != want).sum().item()
                raise AssertionError(f"join_scan level {l} mode {mode}: {bad} rows differ")
        ms = cuda_ms(lambda: join_scan(shi, slo2, srow, num, v, qsent, 1))
        plain = cuda_ms(lambda: join_scan_plain(shi, slo2, srow, num, v, qsent, 1))
        # library yardstick: the three cummax calls of the plain version
        # on its masked arrays
        pos = torch.arange(n, dtype=torch.int32, device=shi.device)
        differs = torch.ones(n, dtype=torch.bool, device=shi.device)
        differs[1:] = (shi[1:] != shi[:-1]) | ((slo2[1:] >> 1) != (slo2[:-1] >> 1))
        masked = (
            torch.where(differs, pos, -1),
            torch.where(srow < v, pos, -1),
            torch.where((srow < v) & (srow < num), srow, -1),
        )
        lib = cuda_ms(lambda: [torch.cummax(x, 0) for x in masked])
        b, _ = bound_ms(16.0 * n, 0.0, "float32")  # 3 int32 in, 1 out
        log(
            f"K1 join_scan level {l}: n={n} bit-exact (modes 0,1) "
            f"kernel {ms:.4f} ms plain {plain:.4f} ms cummax x3 {lib:.4f} ms "
            f"bound {b:.4f} ms"
        )
        for k, x in (("ms", ms), ("plain_ms", plain), ("bound_ms", b), ("library_ms", lib)):
            tot[k] += x
    results["join_scan"] = dict(tot, max_abs_err=0.0, bound_by="bytes")


def phase_convs(cap: Capture, results: dict) -> None:
    """K2 and K3 on every distinct shape of the path, bf16 (the path's
    dtype) and f32; per-scan totals weight each shape by its count."""
    import torch

    from taseg_tpu_torch.ops import sparse_conv, strided_conv

    kernels = {
        "sparse_conv_k3": (sparse_conv.sparse_conv_k3, sparse_conv.sparse_conv_plain, 1e-5),
        # the plain down path sums with a mean-centred cumsum
        "strided_down": (strided_conv.downsample_conv_apply, strided_conv.downsample_conv_plain, 1e-4),
        "strided_up": (strided_conv.upsample_conv_apply, strided_conv.upsample_conv_plain, 1e-5),
    }
    for name in kernels:
        results[name] = {
            "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
            "library_ms": None, "_bound_parts": [0.0, 0.0],
        }
    for key, (feats, w32, table) in sorted(cap.seen.items(), key=lambda kv: str(kv[0])):
        name, rows, c_in, c_out = key
        kern, plain, rel = kernels[name]
        count = cap.count[key]
        for dtype, tdt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            x = feats.to(tdt).contiguous()
            w = w32.to(tdt).contiguous()
            got = kern(x, w, table)
            want = plain(x, w, table)
            ref_abs = plain(x.abs(), w.abs(), table)
            err = check_close(f"{name} {key[1:]} {dtype}", got, want, ref_abs, dtype, rel)
            if dtype != "bfloat16":
                log(f"  {name} rows={rows} {c_in}->{c_out} f32 max|err| {err:.3e}")
                continue
            ms = cuda_ms(lambda: kern(x, w, table))
            pms = cuda_ms(lambda: plain(x, w, table), iters=3)
            esz = x.element_size()
            if name == "sparse_conv_k3":
                pairs = int((table >= 0).sum().item())
                out_rows = rows
                nbytes = rows * c_in * esz + w.numel() * esz + table.numel() * 4 + rows * c_out * esz
            else:
                fine = int((table.parent >= 0).sum().item())
                pairs = fine
                out_rows = table.starts.shape[0] - 1 if name == "strided_down" else table.parent.shape[0]
                nbytes = (
                    rows * c_in * esz + w.numel() * esz
                    + 4 * (3 * table.parent.shape[0] + table.starts.shape[0])
                    + out_rows * c_out * esz
                )
            ops = 2.0 * pairs * c_in * c_out
            b, by = bound_ms(nbytes, ops, dtype)
            log(
                f"{name} rows={rows} {c_in}->{c_out} x{count}/scan bf16 "
                f"max|err| {err:.3e} kernel {ms:.4f} ms plain {pms:.4f} ms "
                f"bound {b:.4f} ms ({by}) pairs={pairs}"
            )
            r = results[name]
            r["ms"] += count * ms
            r["plain_ms"] += count * pms
            r["bound_ms"] += count * b
            r["_bound_parts"][0 if by == "bytes" else 1] += count * b
            r["max_abs_err"] = max(r["max_abs_err"], err)
    for name in kernels:
        r = results[name]
        parts = r.pop("_bound_parts")
        r["bound_by"] = "bytes" if parts[0] >= parts[1] else "operations"


def main() -> int:
    if not (REPO / "taseg_tpu_torch" / "__init__.py").is_file():
        print("taseg_tpu_torch is not beside chip_smoke.py", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import numpy as np

    from taseg_tpu_torch.configs import MINKUNET_MK34_CR10
    from taseg_tpu_torch.engine import Segmenter
    from taseg_tpu_torch.ops import _build
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # 2. the build
    _build.get_lib()
    info = _build.build_info
    log(f"build: {info['seconds']:.1f} s (fresh={info['fresh']}) {info['path']}")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  {line.strip()}")

    # main-path objects: seeded weights, bf16 and f32 segmenters
    cfg = MINKUNET_MK34_CR10
    params, stats = init_params_numpy(cfg, seed=SEED)
    variables = {"params": params, "batch_stats": stats}
    seg = Segmenter(cfg, variables, compute_dtype="bfloat16")
    seg32 = Segmenter(cfg, variables, compute_dtype="float32")
    t0 = time.perf_counter()
    scans = make_scans(N_SCANS)
    log(f"scans: {N_SCANS} x {N_POINTS} points in {time.perf_counter() - t0:.1f} s")

    # one forward with hooks: the real inputs of every conv shape
    arrays = seg.collate(scans[:1])
    topo = seg.topology(arrays)
    seg.check_capacity(topo)
    log(f"level voxels {[int(l.num) for l in topo.levels]} caps {list(seg.caps.voxels)}")
    cap = Capture(seg.model)
    seg.forward(arrays, topo)
    cap.remove()
    torch.cuda.synchronize()

    # 3. kernel phases
    results: dict = {}
    phase_join_scan(topo, results)
    phase_convs(cap, results)
    del cap

    # 4. the main path, counted
    _build.reset_launches()
    out = seg.predict(scans)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"main path launches: {launches}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    for s, o in zip(scans, out):
        n_raw = s["xyzret"].shape[0]
        if o["logits"].shape != (n_raw, cfg["MODEL"]["NUM_CLASS"]):
            raise AssertionError(f"logits shape {o['logits'].shape}")
        if not np.isfinite(o["logits"]).all():
            raise AssertionError("non-finite logits")
    out32 = seg32.predict(scans)
    agree = float(np.mean(np.concatenate(
        [a["labels"] == b["labels"] for a, b in zip(out, out32)]
    )))
    log(f"bf16 vs f32 per-point argmax agreement {agree:.5f}")
    if agree < 0.97:
        raise AssertionError(f"bf16/f32 argmax agreement {agree:.4f} < 0.97")

    # the card's f32 path against the CPU's plain path on a small scan
    # (a sparse small scan fills every level: capacities at the point count)
    small = make_scans(1, n_points=8000, seed=SEED + 1)
    cfg_small = {**cfg, "MODEL": {**cfg["MODEL"], "CAPACITY_SCHEDULE": (1.0,) * 5}}
    gpu_small, cpu_small = (
        Segmenter(cfg_small, variables, device=dev, compute_dtype="float32",
                  point_capacity=8192).predict(small)[0]
        for dev in ("cuda", "cpu")
    )
    d = np.abs(gpu_small["logits"] - cpu_small["logits"]).max()
    scale = max(1.0, float(np.abs(cpu_small["logits"]).max()))
    log(f"small scan f32 card vs cpu plain: max|dlogit| {d:.3e} (scale {scale:.3e})")
    if not d <= 1e-3 * scale:
        raise AssertionError("card and CPU logits disagree on the small scan")

    # throughput: host / topology / forward split, after warm-up; one
    # scan per sample, ROUNDS passes over the scans
    torch.cuda.reset_peak_memory_stats()
    samples = {"end_to_end": [], "host": [], "topology": [], "forward": []}
    e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(ROUNDS):
        for s in scans:
            t0 = time.perf_counter()
            a = seg.collate([s])
            t1 = time.perf_counter()
            e[0].record()
            tp = seg.topology(a)
            e[1].record()
            lg = seg.forward(a, tp)
            e[2].record()
            seg.map_to_points(a, lg)  # copies to the host: synchronises
            samples["end_to_end"].append((time.perf_counter() - t0) * 1e3)
            samples["host"].append((t1 - t0) * 1e3)
            samples["topology"].append(e[0].elapsed_time(e[1]))
            samples["forward"].append(e[1].elapsed_time(e[2]))
    summary = {
        k: (float(np.median(v)), float(np.percentile(v, 75))) for k, v in samples.items()
    }
    n = len(samples["end_to_end"])
    log(
        f"throughput over {n} scans (ms per scan, median / p75): "
        + ", ".join(f"{k} {m:.3f} / {q:.3f}" for k, (m, q) in summary.items())
        + f"; {1e3 / summary['end_to_end'][0]:.4f} scans/s end to end, "
        f"{1e3 / (summary['topology'][0] + summary['forward'][0]):.4f} scans/s on the "
        f"card (topology + forward); peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )

    # 5. the kernels line
    meta = {
        "join_scan": ("csrc/join_scan.cu", "taseg_tpu/ops/join_scan.py:134"),
        "sparse_conv_k3": ("csrc/sparse_conv.cu", "taseg_tpu/ops/tgf.py:216"),
        "strided_down": ("csrc/strided_conv.cu", "taseg_tpu/ops/strided_conv.py:123"),
        "strided_up": ("csrc/strided_conv.cu", "taseg_tpu/ops/strided_conv.py:152"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"taseg_tpu_torch/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
