#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`taseg_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's main path — `Segmenter.predict` of MinkUNet mk34 cr1.0
(tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10.yaml) in bf16 on
synthetic 120 000-point scans, weights drawn from a seed — and checks it:

  1. the card's name and power limit (nvidia-smi);
  2. the kernel build from the sources in the checkout, with its time;
  3. one phase per kernel at the main path's real shapes (captured from
     a real forward): K1 join_scan (one launch per call) bit-exact against
     its plain version, K2 sparse_conv_k3 and K3 strided down/up within
     stated tolerances, with kernel, plain and library times.  bf16 takes
     the tensor-core route of K2 and K3 wherever the widths allow it, f32
     the CUDA-core route; each per-shape line names its route.  The real
     topology's child tables take one round at every level;
  4. the main path on 3 scans: finite logits of the right shape, every
     kernel's launch count above 0, 47 of the 48 K2 launches, 4 of the 4
     K3-down and 4 of the 4 K3-up launches of each scan on the
     tensor-core route, bf16/f32 argmax agreement, agreement of the card's
     f32 path with the CPU's plain path on a small scan, and scans/s with
     the topology / forward split;
  5. each kernel's device time per scan on the main path (torch.profiler
     device events), and the plain point<->voxel ops (voxelize_avg,
     devoxelize) with their bounds and library calls;
  6. one JSON line listing the kernels, K2 and K3 with their launches per
     route.

The last line is {"ok": true, "device": {...}}.  Any failure raises and
the exit code is not 0.  Without CUDA, or without the package beside
this file, it exits non-zero and prints no result.  It imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

REPO = Path(__file__).resolve().parent
N_POINTS = 120_000
N_SCANS = 3
ROUNDS = 14  # throughput samples: ROUNDS * N_SCANS scans, 10+ beyond p75
SEED = 0
# launches per scan of the main path: (all, tensor-core route); only the
# stem's first conv (C_in = 4) takes K2's CUDA-core route
K2_PER_SCAN = (48, 47)
DOWN_PER_SCAN = (4, 4)
UP_PER_SCAN = (4, 4)
# each wrapper's kernels, by a fragment of their names in the profiler
KERNEL_NAMES = {
    "join_scan": "join_scan_kernel",
    "sparse_conv_k3": "k3_conv",
    "strided_down": "strided_down",
    "strided_up": "strided_up",
}

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


def device_ms(fn, frag: str, iters: int = 10):
    """Mean device time per call of `fn`'s kernels whose names hold
    `frag`, from torch.profiler's device events over `iters` calls after
    one warm-up (a second try where the first records none); None where
    neither does.  Unlike `cuda_ms` it leaves out the host's cost per
    launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(
            e.self_device_time_total for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU and frag in e.key
        )
        if us:
            return us / 1e3 / iters
    return None


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


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


def k1_call(topo, l: int):
    """K1's floor-mode call at level `l` of the main path, on the sorted
    union that `build_rulebook_k3` scans there."""
    import torch

    from taseg_tpu_torch.ops.coords import QUERY_SENTINEL_HI
    from taseg_tpu_torch.ops.join import sorted_union
    from taseg_tpu_torch.ops.join_scan import join_scan
    from taseg_tpu_torch.ops.rulebook import k3_floor_queries

    lt = topo.levels[l]
    hi, lo, q_hi, q_lo = k3_floor_queries(lt.coords, lt.num, 2**l, topo.bounds)
    shi, slo2, srow = sorted_union(hi, lo, q_hi, q_lo)
    num = lt.num.reshape(1).to(torch.int32)
    return partial(join_scan, shi, slo2, srow, num, hi.shape[0], int(QUERY_SENTINEL_HI), 1)


def down_call(kern, rows: int, c_in: int, w, table):
    """A K3-down call at a main-path shape, on seeded random features
    (its time does not depend on their values)."""
    import torch

    gen = torch.Generator(device=w.device).manual_seed(SEED)
    x = torch.randn(rows, c_in, device=w.device, generator=gen).to(w.dtype)
    return partial(kern, x, w, table)


def phase_join_scan(topo, results: dict, probes: list) -> None:
    """K1 on the 5 levels' unions of the real topology; both modes
    bit-exact against the plain (cummax) version on the card.  Each
    level's call goes into `probes` (as a function that makes it) for its
    device time."""
    import torch

    from taseg_tpu_torch.ops.join_scan import join_scan, join_scan_plain

    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for l in range(len(topo.levels)):
        call = k1_call(topo, l)
        shi, slo2, srow, num, v, qsent, _ = call.args
        n = shi.shape[0]
        for mode in (0, 1):
            got = join_scan(shi, slo2, srow, num, v, qsent, mode)
            want = join_scan_plain(shi, slo2, srow, num, v, qsent, mode)
            if not torch.equal(got, want):
                bad = (got != want).sum().item()
                raise AssertionError(f"join_scan level {l} mode {mode}: {bad} rows differ")
        ms = cuda_ms(call)
        probes.append(("join_scan", f"K1 join_scan level {l}", partial(k1_call, topo, l)))
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
            f"kernel {ms:.4f} ms plain {plain:.4f} ms "
            f"cummax x3 {lib:.4f} ms bound {b:.4f} ms"
        )
        for k, x in (("ms", ms), ("plain_ms", plain), ("bound_ms", b), ("library_ms", lib)):
            tot[k] += x
    results["join_scan"] = dict(tot, max_abs_err=0.0, bound_by="bytes")


def phase_convs(cap: Capture, results: dict, probes: list) -> None:
    """K2 and K3 on every distinct shape of the path, bf16 (the path's
    dtype) and f32; per-scan totals weight each shape by its count.  The
    bf16 K3-down calls go into `probes` for their device time."""
    import torch

    from taseg_tpu_torch.ops import sparse_conv, strided_conv

    kernels = {
        "sparse_conv_k3": (sparse_conv.sparse_conv_k3, sparse_conv.sparse_conv_plain, 1e-5),
        # the plain down path sums with a mean-centred cumsum
        "strided_down": (strided_conv.downsample_conv_apply, strided_conv.downsample_conv_plain, 1e-4),
        "strided_up": (strided_conv.upsample_conv_apply, strided_conv.upsample_conv_plain, 1e-5),
    }
    routes = {
        "sparse_conv_k3": sparse_conv.route,
        "strided_down": strided_conv.downsample_route,
        "strided_up": strided_conv.upsample_route,
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
            route = routes[name](tdt, c_in, c_out)
            if dtype != "bfloat16":
                log(f"  {name} rows={rows} {c_in}->{c_out} f32 route {route} max|err| {err:.3e}")
                continue
            ms = cuda_ms(lambda: kern(x, w, table))
            if name == "strided_down":
                probes.append((
                    name, f"{name} rows={rows} {c_in}->{c_out}",
                    partial(down_call, kern, rows, c_in, w, table),
                ))
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
                f"{name} rows={rows} {c_in}->{c_out} x{count}/scan bf16 route {route} "
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


def check_child_rounds(topo) -> None:
    """The host pipeline's coordinates are non-negative, so every coarse
    cell has at most one child per slot: the down kernel's child table
    takes one round at every level of the path."""
    from taseg_tpu_torch.ops.strided_conv import slot_child_table

    rounds = [slot_child_table(lt.strided).shape[0] for lt in topo.levels[1:]]
    log(f"K3-down child rounds per level 1-4: {rounds}")
    if rounds != [1] * len(rounds):
        raise AssertionError(f"expected one child round per level, got {rounds}")


def phase_profile(seg, scans, results: dict, calls: dict, probes: list) -> None:
    """Device time per scan of each kernel on the main path (topology +
    forward), from torch.profiler's device events as
    tools/profile_port.py sums them; K1 must launch one kernel per call
    (`calls`: wrapper calls per scan).  Then the device time per call of
    each of `probes` (K1 per level, K3-down per shape; each makes its call
    only now, so that its inputs do not stay on the card through the
    throughput samples).  Runs after those samples: a profiler session
    before them slowed the launch-bound topology stage by 4-6 ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batches = [seg.collate([s]) for s in scans]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for a in batches:
            seg.forward(a, seg.topology(a))
        torch.cuda.synchronize()
    n = len(batches)
    dev = {k: [0.0, 0] for k in KERNEL_NAMES}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        for k, frag in KERNEL_NAMES.items():
            if frag in e.key and e.self_device_time_total > 0:
                dev[k][0] += e.self_device_time_total / 1e3 / n
                dev[k][1] += e.count
    for k, (ms, count) in dev.items():
        per_call = count / (n * calls[k]) if calls[k] else 0.0
        log(
            f"profiler {k}: {ms:.4f} ms per scan on the device, "
            f"{count / n:g} kernel launches per scan, {per_call:g} per wrapper call"
        )
        results[k]["device_ms"] = ms if count else None
    k1_count = dev["join_scan"][1]
    if k1_count and k1_count != n * calls["join_scan"]:
        raise AssertionError(
            f"K1: {k1_count} kernel launches for {n * calls['join_scan']} calls"
        )
    results["join_scan"]["kernel_launches_per_call"] = 1 if k1_count else None
    if not k1_count:
        log("profiler: no device events for K1 (launches per call not measured)")
    for name, label, make in probes:
        log(f"profiler {label}: device {fmt_ms(device_ms(make(), KERNEL_NAMES[name]))} per call")


def phase_point_ops(seg, arrays, topo, k: int) -> None:
    """voxelize_avg and the head's devoxelize calls, plain torch on the
    main path: time per scan, bound (bytes: each input read once, the
    output written once) and, where one PyTorch call computes the same
    function, that call's time.  The head devoxelizes (V, k) bf16 rows
    (k classes)."""
    import torch

    from taseg_tpu_torch.ops import voxelize as vx

    feats = arrays["point_feats_t"][:, : seg.model.in_dim].contiguous()
    inv, tables = topo.point_inverse, topo.point_tables
    v, (p, c) = tables.counts.shape[0], feats.shape
    want = vx.voxelize_avg(feats, inv, tables)
    ms = cuda_ms(lambda: vx.voxelize_avg(feats, inv, tables))
    # row v takes the dropped points; include_self=False leaves rows
    # without points at 0
    idx = torch.where(inv >= 0, inv, v).long()[:, None].expand(p, c).contiguous()
    buf = torch.zeros(v + 1, c, device=feats.device)
    lib = cuda_ms(lambda: buf.scatter_reduce_(0, idx, feats, "mean", include_self=False))
    # the plain version's mean-centred f32 cumsum rounds by up to ~2e-4
    # of the feature scale over 131 072 points
    err = (buf[:v] - want).abs().max().item()
    if not err <= 1e-3 * max(1.0, want.abs().max().item()):
        raise AssertionError(f"scatter_reduce mean differs from voxelize_avg by {err:.3e}")
    b, _ = bound_ms(p * c * 4 + p * 4 + v * c * 4, 0.0, "float32")
    log(
        f"voxelize_avg P={p} V={v} C={c} x1/scan: plain {ms:.4f} ms, "
        f"scatter_reduce_ mean {lib:.4f} ms, bound {b:.4f} ms (bytes)"
    )

    gen = torch.Generator(device=feats.device).manual_seed(SEED)
    z = torch.randn(topo.levels[0].coords.shape[0], k, device=feats.device, generator=gen)
    z = z.to(torch.bfloat16)
    ident = topo.devox[1]
    want = vx.devoxelize(z, ident)
    ms = cuda_ms(lambda: vx.devoxelize(z, ident))
    zpad = torch.cat([z, z.new_zeros(1, k)])
    gidx = torch.where(ident.inverse >= 0, ident.inverse, z.shape[0]).long()
    lib = cuda_ms(lambda: torch.index_select(zpad, 0, gidx))
    if not torch.equal(torch.index_select(zpad, 0, gidx), want):
        raise AssertionError("index_select differs from the identity devoxelize")
    pts = ident.inverse.shape[0]
    b, _ = bound_ms(pts * 4 + z.numel() * 2 + pts * k * 2, 0.0, "float32")
    log(
        f"devoxelize identity P={pts} V={z.shape[0]} C={k} x1/scan: plain {ms:.4f} ms, "
        f"index_select {lib:.4f} ms, bound {b:.4f} ms (bytes)"
    )
    for s in (4, 16):
        tab = topo.devox[s]
        lvl = topo.levels[s.bit_length() - 1]
        zs = torch.randn(lvl.coords.shape[0], k, device=feats.device, generator=gen)
        zs = zs.to(torch.bfloat16)
        ms = cuda_ms(lambda: vx.devoxelize(zs, tab))
        pts = tab.idx.shape[1]
        b, _ = bound_ms(8 * pts * 8 + zs.numel() * 2 + pts * k * 2, 0.0, "float32")
        log(
            f"devoxelize trilinear stride {s} P={pts} V={zs.shape[0]} C={k} x1/scan: "
            f"plain {ms:.4f} ms, library none, bound {b:.4f} ms (bytes)"
        )


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
    probes: list = []
    phase_join_scan(topo, results, probes)
    phase_convs(cap, results, probes)
    check_child_rounds(topo)
    phase_point_ops(seg, arrays, topo, cfg["MODEL"]["NUM_CLASS"])
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
    per_scan = (
        ("sparse_conv_k3", K2_PER_SCAN), ("strided_down", DOWN_PER_SCAN),
        ("strided_up", UP_PER_SCAN),
    )
    for name, (total, mma) in per_scan:
        got = (launches[name], launches[f"{name}_mma"])
        if got != (total * N_SCANS, mma * N_SCANS):
            raise AssertionError(
                f"{name}: (all, tensor-core) launches {got}, expected "
                f"{(total * N_SCANS, mma * N_SCANS)} over {N_SCANS} scans"
            )
    log(
        f"tensor-core route per scan: K2 {K2_PER_SCAN[1]} of {K2_PER_SCAN[0]}, "
        f"K3-down {DOWN_PER_SCAN[1]} of {DOWN_PER_SCAN[0]}, "
        f"K3-up {UP_PER_SCAN[1]} of {UP_PER_SCAN[0]}"
    )
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

    # 5. device time per kernel on the main path
    phase_profile(seg, scans, results, {k: launches[k] / N_SCANS for k in KERNEL_NAMES}, probes)

    # 6. the kernels line
    meta = {
        "join_scan": ("csrc/join_scan.cu", "taseg_tpu/ops/join_scan.py:134"),
        "sparse_conv_k3": ("csrc/sparse_conv.cu", "taseg_tpu/ops/tgf.py:216"),
        "strided_down": ("csrc/strided_conv.cu", "taseg_tpu/ops/strided_conv.py:123"),
        "strided_up": ("csrc/strided_conv.cu", "taseg_tpu/ops/strided_conv.py:152"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        r = results[name]
        entry = {
            "name": name, "route": "cuda", "source": f"taseg_tpu_torch/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        }
        if f"{name}_mma" in launches:
            mma = launches[f"{name}_mma"]
            entry["launches_by_route"] = {"mma": mma, "simt": launches[name] - mma}
        if name == "join_scan":
            entry["kernel_launches_per_call"] = r["kernel_launches_per_call"]
        entry["device_ms_per_scan"] = r["device_ms"]
        kernels.append(entry)
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
