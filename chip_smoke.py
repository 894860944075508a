#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`taseg_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's two main paths — `Segmenter.predict` and
`Trainer.step` of MinkUNet mk34 cr1.0
(tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10.yaml) in bf16 on
synthetic 120 000-point scans, weights drawn from a seed — and checks
them:

  1. the card's name and power limit (nvidia-smi);
  2. the kernel build from the sources in the checkout, with its time;
  3. one phase per kernel at the main path's real shapes (captured from
     a real forward): K1 join_scan (one launch per call) bit-exact against
     its plain version, K2 sparse_conv_k3 and K3 strided down/up within
     stated tolerances, with kernel, plain and library times.  bf16 takes
     the tensor-core route of K2 and K3 wherever the widths allow it, f32
     the CUDA-core route; each per-shape line names its route.  The real
     topology's child tables take one round at every level.  voxelize_avg
     (K6) and the head's three devoxelize calls (K7) at the real tables,
     bit-identical to the plain versions, with kernel, plain, bound and
     library (index_select, embedding_bag) times;
  4. the main path on 3 scans: finite logits of the right shape, every
     kernel's launch count above 0, 47 of the 48 K2 launches, 4 of the 4
     K3-down and 4 of the 4 K3-up launches of each scan on the
     tensor-core route, 3 K7 launches per scan, bf16/f32 argmax agreement, agreement of the card's
     f32 path with the CPU's plain path on a small scan, and scans/s with
     the topology / forward split;
  5. the train path, `Trainer` of the same model in bf16: the backward
     kernels K4 k3_conv_dw (tensor cores over the level's pair lists in
     bf16, CUDA cores in f32 and for the stem's 4 -> 32), K5 strided_dw
     (tensor cores over the level's per-slot pair lists in bf16, CUDA
     cores in f32), K6 segment_sum (each of its 4 calls named and timed),
     and the input-gradient calls of K2 and K3 on both routes, at every
     shape that one real step gives them, against their plain versions
     (and bit-identical on a repeat call), K7 bit-identical to its plain
     version in the train forward; what the pair lists cost the
     topology; a small-scan f32 step on the card
     against the CPU's plain path; 4 full-width steps on 120 000-point
     scans with finite loss, grad norm and parameters and the launches of
     every kernel per step; ms per step by stage and peak memory;
  6. each kernel's device time per scan (inference) and per step (train)
     on the main paths (torch.profiler device events), and the train
     step's largest plain-torch kernels;
  7. one JSON line listing the kernels, K2, K3, K4 and K5 with their
     launches per route, K2, K3 and K7 with their train launches.  Beside
     each kernel and plain time stands one PyTorch call of the same
     function (`library_ms`): K1 three cummax, K6 one index_add_, K7
     index_select and embedding_bag, the convs one torch.mm on rows
     gathered beforehand.

The last line is {"ok": true, "device": {...}}.  Any failure raises and
the exit code is not 0.  Without CUDA, or without the package beside
this file, it exits non-zero and prints no result.  It imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import replace
from functools import partial
from types import SimpleNamespace
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
# the inference path's kernels
INFER_KERNELS = (
    "join_scan", "sparse_conv_k3", "sparse_conv_k3_mma", "strided_down",
    "strided_down_mma", "strided_up", "strided_up_mma", "segment_sum",
    "devoxelize",
)
DEVOX_PER_SCAN = 3  # the head's strides 1, 4 and 16
# each wrapper's kernels, by fragments of their names in the profiler
KERNEL_NAMES = {
    "join_scan": ("join_scan_kernel",),
    "sparse_conv_k3": ("k3_conv",),
    "strided_down": ("strided_down",),
    "strided_up": ("strided_up",),
    "segment_sum": ("segment_sum_",),
    "k3_conv_dw": ("PairsK3", "K3Lists"),
    "strided_dw": ("PairsStrided", "SlotLists"),
    "devoxelize": ("devox_kernel",),
}
TRAIN_STEPS = 4
# launches per train step (bf16, batch 1): K2 48 forward + 47 input
# gradients (the stem's first conv takes none), all but the stem's
# forward on tensor cores; K3 4 + 4 each way; K4 one per k3 conv, all but
# the stem's first (4 -> 32) on tensor cores, K5 one per strided conv, all
# on tensor cores; K6 the voxelize forward and the 3 devox backwards; K7
# the 3 devox forwards
TRAIN_PER_STEP = {
    "join_scan": 5,
    "sparse_conv_k3": 95, "sparse_conv_k3_mma": 94,
    "sparse_conv_k3_dgrad": 47, "sparse_conv_k3_dgrad_mma": 47,
    "strided_down": 8, "strided_down_mma": 8,
    "strided_down_dgrad": 4, "strided_down_dgrad_mma": 4,
    "strided_up": 8, "strided_up_mma": 8,
    "strided_up_dgrad": 4, "strided_up_dgrad_mma": 4,
    "k3_conv_dw": 48, "k3_conv_dw_mma": 47, "strided_dw": 8, "strided_dw_mma": 8,
    "segment_sum": 4, "devoxelize": 3,
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


def named(key: str, frags) -> bool:
    return any(f in key for f in frags)


def device_ms(fn, frags, iters: int = 10):
    """Mean device time per call of `fn`'s kernels whose names hold one
    of `frags`, from torch.profiler's device events over `iters` calls after
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
            if e.device_type != torch.autograd.DeviceType.CPU and named(e.key, frags)
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


def gathered_rows(x, idx):
    """(V, K * C): row v holds x[idx[k, v]] for k = 0..K-1 side by side,
    zero where idx is -1 (the rows a gather-GEMM reads, laid out for one
    dense matrix product)."""
    import torch

    g = x[idx.clamp(min=0).long()]
    g = torch.where((idx >= 0)[:, :, None], g, 0)
    return g.permute(1, 0, 2).reshape(idx.shape[1], -1)


def slot_rows(tables):
    """(8, V_fine) int32: the parent of each fine row at its slot, -1 at
    the other slots and where it has none."""
    import torch

    par, slot = tables.parent, (tables.slot & 7).long()
    idx = torch.full((8, par.shape[0]), -1, dtype=torch.int32, device=par.device)
    cols = torch.arange(par.shape[0], device=par.device)
    idx[slot, cols] = par
    return idx


def conv_library_ms(name: str, x, w, table) -> float:
    """One torch.mm that computes a conv call of K2 / K3 (forward or input
    gradient) on rows gathered beforehand: (rows x K C_in) @ W reshaped
    to (K C_in x C_out); K = 27 offsets, or the 8 slots."""
    import torch

    from taseg_tpu_torch.ops.strided_conv import slot_child_table

    if name == "sparse_conv_k3":
        idx = table
    elif name == "strided_down":
        idx = slot_child_table(table)[0]  # one round on the path
    else:
        idx = slot_rows(table)
    a = gathered_rows(x, idx)
    b = w.reshape(-1, w.shape[2])
    ms = cuda_ms(lambda: torch.mm(a, b))
    del a
    return ms


def dw_library_ms(name: str, x, y, table, up: bool = False) -> float:
    """One torch.mm that computes a weight gradient of K4 / K5: x^T @ the
    cotangent rows gathered per offset or slot side by side (zero where
    absent)."""
    import torch

    from taseg_tpu_torch.ops.strided_conv import slot_child_table

    if name == "k3_conv_dw":
        b = gathered_rows(y, table)
    elif up:  # x coarse rows, y fine rows: the children per slot
        b = gathered_rows(y, slot_child_table(table)[0])
    else:  # x fine rows, y coarse rows at each fine row's slot
        b = gathered_rows(y, slot_rows(table))
    ms = cuda_ms(lambda: torch.mm(x.t(), b))
    del b
    return ms


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
            "library_ms": 0.0, "_bound_parts": [0.0, 0.0],
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
            lib = conv_library_ms(name, x, w, table)
            log(
                f"{name} rows={rows} {c_in}->{c_out} x{count}/scan bf16 route {route} "
                f"max|err| {err:.3e} kernel {ms:.4f} ms plain {pms:.4f} ms "
                f"bound {b:.4f} ms ({by}) one torch.mm {lib:.4f} ms pairs={pairs}"
            )
            r = results[name]
            r["library_ms"] += count * lib
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
        for k, frags in KERNEL_NAMES.items():
            if named(e.key, frags) and e.self_device_time_total > 0:
                dev[k][0] += e.self_device_time_total / 1e3 / n
                dev[k][1] += e.count
    for k, (ms, count) in dev.items():
        per_call = count / (n * calls[k]) if calls[k] else 0.0
        log(
            f"profiler {k}: {ms:.4f} ms per scan on the device, "
            f"{count / n:g} kernel launches per scan, {per_call:g} per wrapper call"
        )
        results.setdefault(k, {})["device_ms"] = ms if count else None
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


def phase_point_ops(seg, arrays, topo, k: int, results: dict, probes: list) -> None:
    """voxelize_avg (K6's segment sum, then the mean) and the head's
    three devoxelize calls (K7, held bit-identical to its plain version)
    on the main path's tables: time per scan, bound (bytes: each input
    read once, the output written once) and, where one PyTorch call
    computes the same function, that call's time.  The head devoxelizes
    (V, k) bf16 rows (k classes).  Each K7 call goes into `probes` for
    its device time."""
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
        f"voxelize_avg (K6 segment sum + mean) P={p} V={v} C={c} x1/scan: {ms:.4f} ms, "
        f"scatter_reduce_ mean {lib:.4f} ms, bound {b:.4f} ms (bytes)"
    )
    # its backward (JAX _voxelize_bwd, plain torch, off the path: the
    # point features take no gradient) at the same shapes
    g = torch.randn(v, c, device=feats.device, generator=torch.Generator(feats.device).manual_seed(SEED))
    ctx = SimpleNamespace(inverse=inv, counts=tables.counts)
    ms = cuda_ms(lambda: vx.VoxelizeAvg.backward(ctx, g))
    b, _ = bound_ms(v * c * 4 + p * 4 + p * c * 4, 0.0, "float32")
    log(f"voxelize_avg backward (plain torch) P={p} V={v} C={c}: plain {ms:.4f} ms, bound {b:.4f} ms (bytes)")

    gen = torch.Generator(device=feats.device).manual_seed(SEED)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "max_abs_err": 0.0}
    for s in (1, 4, 16):
        tab = topo.devox[s]
        lvl = topo.levels[s.bit_length() - 1]
        z = torch.randn(lvl.coords.shape[0], k, device=feats.device, generator=gen)
        z = z.to(torch.bfloat16)
        ms, pms, lib, lib_err, pts = devox_times(z, tab)
        corners = 1 if s == 1 else 8
        b, _ = bound_ms(corners * pts * (4 if s == 1 else 8) + z.numel() * 2 + pts * k * 2, 0.0, "float32")
        yardstick = "index_select" if s == 1 else "embedding_bag"
        log(
            f"K7 devoxelize {'identity' if s == 1 else 'trilinear'} stride {s} P={pts} "
            f"V={z.shape[0]} C={k} x1/scan: bit-identical, kernel {ms:.4f} ms plain {pms:.4f} ms "
            f"{yardstick} {lib:.4f} ms (max|diff| {lib_err:.3e}) bound {b:.4f} ms (bytes)"
        )
        for key, x in (("ms", ms), ("plain_ms", pms), ("bound_ms", b), ("library_ms", lib)):
            tot[key] += x
        probes.append(("devoxelize", f"K7 devoxelize stride {s}", partial(devox_call, topo, s, k)))
    results["devoxelize"] = dict(tot, bound_by="bytes")


def devox_call(topo, s: int, k: int):
    """K7's call at head stride `s` of the main path, on seeded random
    (V, k) bf16 rows (its time does not depend on their values)."""
    import torch

    from taseg_tpu_torch.ops import voxelize as vx

    rows = topo.levels[s.bit_length() - 1].coords.shape[0]
    gen = torch.Generator(device=topo.bounds.origin.device).manual_seed(SEED)
    z = torch.randn(rows, k, device=gen.device, generator=gen).to(torch.bfloat16)
    return partial(vx.devoxelize, z, topo.devox[s])


def bits(t):
    """The raw bits of a f32 or bf16 tensor (tells -0 from +0)."""
    import torch

    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def devox_check(z, table) -> None:
    """K7 on (V, C) rows `z` and a head table: the same bits as the plain
    version."""
    from taseg_tpu_torch.ops import voxelize as vx

    if isinstance(table, vx.IdentityDevoxTable):
        got, want = vx.devoxelize_identity(z, table.inverse), vx._devox_identity(z, table.inverse)
    else:
        got, want = vx.devoxelize_trilinear(z, table), vx._devox_trilinear(z, table)
    if not bits(got).equal(bits(want)):
        bad = (bits(got) != bits(want)).sum().item()
        raise AssertionError(f"K7 devoxelize: {bad} values differ from the plain version")


def devox_times(z, table):
    """K7 against its plain version on one head call: (kernel ms, plain
    ms, library ms, library max |diff|, points).  The library call is
    `index_select` for the identity (exact) and `F.embedding_bag` (sum
    with per-sample weights) for the trilinear, both over a zero row
    appended for absent corners; embedding_bag sums in f32 and rounds
    once, where K7 rounds each of its 15 products and sums to bf16, so
    it is held within 2^-5 of the largest sum of |terms|."""
    import torch
    import torch.nn.functional as F

    from taseg_tpu_torch.ops import voxelize as vx

    devox_check(z, table)
    k = z.shape[1]
    zpad = torch.cat([z, z.new_zeros(1, k)])
    ms = cuda_ms(lambda: vx.devoxelize(z, table))
    if isinstance(table, vx.IdentityDevoxTable):
        inv = table.inverse
        pms = cuda_ms(lambda: vx._devox_identity(z, inv))
        gidx = torch.where(inv >= 0, inv, z.shape[0]).long()
        lib = cuda_ms(lambda: torch.index_select(zpad, 0, gidx))
        if not bits(torch.index_select(zpad, 0, gidx)).equal(bits(vx._devox_identity(z, inv))):
            raise AssertionError("index_select differs from the identity devoxelize")
        return ms, pms, lib, 0.0, inv.shape[0]
    pms = cuda_ms(lambda: vx._devox_trilinear(z, table))
    eidx = torch.where(table.idx >= 0, table.idx, z.shape[0]).t().contiguous()
    ew = table.weights.t().contiguous().to(z.dtype)
    lib = cuda_ms(lambda: F.embedding_bag(eidx, zpad, per_sample_weights=ew, mode="sum"))
    want = vx._devox_trilinear(z, table).float()
    err = (F.embedding_bag(eidx, zpad, per_sample_weights=ew, mode="sum").float() - want).abs().max().item()
    ref = F.embedding_bag(eidx, zpad.float().abs(), per_sample_weights=ew.float().abs(), mode="sum")
    if not err <= 2.0**-5 * ref.max().item():
        raise AssertionError(f"embedding_bag differs from the trilinear devoxelize by {err:.3e}")
    return ms, pms, lib, err, table.idx.shape[1]


class CallCapture:
    """Wraps module-level functions for one train step: the first call of
    each distinct key (from `key_fn` of the call's arguments; None skips
    the call) is kept with its arguments, and every key is counted."""

    def __init__(self):
        self.seen: dict = {}
        self.count: dict = {}
        self._restore = []

    def patch(self, module, name, key_fn):
        orig = getattr(module, name)

        def wrapper(*args, **kwargs):
            key = key_fn(*args, **kwargs)
            if key is not None:
                self.count[key] = self.count.get(key, 0) + 1
                self.seen.setdefault(key, (args, kwargs))
            return orig(*args, **kwargs)

        setattr(module, name, wrapper)
        self._restore.append((module, name, orig))

    def remove(self):
        for module, name, orig in self._restore:
            setattr(module, name, orig)
        self._restore.clear()


def capture_train_calls(trainer, scans) -> CallCapture:
    """One real train step with the backward kernels' wrappers wrapped:
    the inputs of K4, K5, K6, of the input-gradient calls of K2 and K3
    and of the forward's K7 calls at every shape the step gives them."""
    from taseg_tpu_torch.ops import f3conv, strided_conv, voxelize

    cap = CallCapture()
    cap.patch(
        f3conv, "k3_conv_dw",
        lambda f, g, rb, out_dtype=None, pairs=None: ("k3_conv_dw", *f.shape, g.shape[1]),
    )
    cap.patch(
        strided_conv, "strided_dw",
        lambda x, y, t, up, out_dtype=None: (
            "strided_dw", "up" if up else "down", t.parent.shape[0], x.shape[1], y.shape[1]
        ),
    )
    cap.patch(
        voxelize, "segment_sum",
        lambda src, t, w=None: (
            "segment_sum", t.perm.shape[0] - t.starts.shape[0] + 1, t.starts.shape[0] - 1,
            src.shape[1], w is not None,
        ),
    )
    cap.patch(
        f3conv, "sparse_conv_k3",
        lambda x, w, rb, dgrad=False: ("sparse_conv_k3", *x.shape, w.shape[2]) if dgrad else None,
    )
    for name in ("downsample_conv_apply", "upsample_conv_apply"):
        kind = "strided_down" if name.startswith("down") else "strided_up"
        cap.patch(
            strided_conv, name,
            lambda x, w, t, dgrad=False, kind=kind: (kind, *x.shape, w.shape[2]) if dgrad else None,
        )
    cap.patch(
        voxelize, "devoxelize_trilinear",
        lambda v, t: ("devoxelize", "trilinear", t.idx.shape[1], *v.shape),
    )
    cap.patch(
        voxelize, "devoxelize_identity",
        lambda v, inv: ("devoxelize", "identity", inv.shape[0], *v.shape),
    )
    trainer.step(scans)
    cap.remove()
    return cap


def twice_same(name, fn):
    """fn() twice on the same inputs: the results must be bit-identical."""
    import torch

    a, b = fn(), fn()
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    return a


def phase_train_kernels(cap: CallCapture, results: dict) -> None:
    """K4, K5, K6 and the input-gradient calls of K2 and K3 at every
    shape of one bf16 train step, against their plain versions, bit-
    identical on repeat (K7's forward calls bit-identical to its plain
    version); each kernel also once in f32 (K2 and K3: every
    shape in f32, their CUDA-core route).  Per-step totals weight each
    shape by its count in the step.  K4 and K5 sum up to all V rows in
    f32 in another order than the plain matmuls: 1e-4 of the largest sum
    of |terms|; K6 (against its plain version in f64) and the K2/K3 input
    gradients 1e-5 (K3-down 1e-4: its plain version sums by a
    mean-centred cumsum).  K4 in bf16 reads the level's pair lists as the
    step passed them, and must give the same bits when its wrapper builds
    them itself; its f32 call takes the CUDA-core route; K5 likewise
    over the level's per-slot pair lists.  Each K6 call is
    named by its place in the step, so the stride-16 call shows."""
    import torch

    from taseg_tpu_torch.ops import f3conv, sparse_conv, strided_conv, voxelize

    def k4(a, kw, x, g):
        rb, pairs = a[2], kw.get("pairs")
        if x.dtype == torch.bfloat16 and pairs is None:
            raise AssertionError("K4 was called without the level's pair lists")
        return (
            lambda: f3conv.k3_conv_dw(x, g, rb, pairs=pairs),
            lambda: f3conv.k3_conv_dw_plain(x, g, rb),
            lambda: f3conv.k3_conv_dw_plain(x.abs(), g.abs(), rb),
        )

    def k5(a, kw, x, y):
        t, up = a[2], (a[3] if len(a) > 3 else kw["up"])
        return (
            lambda: strided_conv.strided_dw(x, y, t, up),
            lambda: strided_conv.strided_dw_plain(x, y, t, up),
            lambda: strided_conv.strided_dw_plain(x.abs(), y.abs(), t, up),
        )

    def k6(a, kw, x, _):
        # held against the plain version in f64: the f32 cumsum's rounding
        # over ~10^6 rows is above K6's own error at these small sums
        t, w = a[1], (a[2] if len(a) > 2 else kw.get("weights"))
        w64 = None if w is None else w.double()
        return (
            lambda: voxelize.segment_sum(x, t, w),
            lambda: voxelize.segment_sum_plain(x.double(), t, w64),
            lambda: voxelize.segment_sum_plain(x.double().abs(), t, None if w is None else w64.abs()),
            lambda: voxelize.segment_sum_plain(x, t, w),
        )

    def dgrad(kern, plain):
        def make(a, kw, x, w):
            t = a[2]
            return (
                lambda: kern(x, w, t, dgrad=True),
                lambda: plain(x, w, t),
                lambda: plain(x.abs(), w.abs(), t),
            )
        return make

    makers = {
        "k3_conv_dw": (k4, 1e-4),
        "strided_dw": (k5, 1e-4),
        "segment_sum": (k6, 1e-5),
        "sparse_conv_k3": (dgrad(sparse_conv.sparse_conv_k3, sparse_conv.sparse_conv_plain), 1e-5),
        "strided_down": (dgrad(strided_conv.downsample_conv_apply, strided_conv.downsample_conv_plain), 1e-4),
        "strided_up": (dgrad(strided_conv.upsample_conv_apply, strided_conv.upsample_conv_plain), 1e-5),
    }
    routes = {
        "sparse_conv_k3": sparse_conv.route,
        "strided_down": strided_conv.downsample_route,
        "strided_up": strided_conv.upsample_route,
    }
    tot = {
        k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
            "library_ms": 0.0, "_parts": [0.0, 0.0], "f32_checked": False}
        for k in makers
    }
    for key in sorted((k for k in cap.seen if k[0] == "devoxelize"), key=str):
        (v, t), _ = cap.seen.pop(key)
        table = t if key[1] == "trilinear" else voxelize.IdentityDevoxTable(inverse=t)
        devox_check(v, table)
        log(f"devoxelize {key[1:]} x{cap.count[key]}/step (train forward): bit-identical to the plain version")
    k6_names = k6_call_names([k for k in cap.seen if k[0] == "segment_sum"])
    for key, (a, kw) in sorted(cap.seen.items(), key=lambda kv: str(kv[0])):
        name = key[0]
        make, rel = makers[name]
        count = cap.count[key]
        r = tot[name]
        x, second = a[0], a[1]
        f32_cases = name in routes or not r["f32_checked"]
        for dtype in ("bfloat16", "float32") if f32_cases else ("bfloat16",):
            tdt = getattr(torch, dtype)
            xd = x.to(tdt).contiguous()
            sd = second.to(tdt).contiguous() if name != "segment_sum" else None
            kern, want, ref, *timed = make(a, kw, xd, sd)
            plain = timed[0] if timed else want
            got = twice_same(f"{key} {dtype}", kern)
            err = check_close(f"{key} {dtype}", got, want(), ref(), "float32" if name in ("k3_conv_dw", "strided_dw", "segment_sum") else dtype, rel)
            label = f"{name} {key[1:]} x{count}/step {dtype}"
            if name == "segment_sum":
                label = f"{name} ({k6_names[key]}) {key[1:]} x{count}/step {dtype}"
            if name in routes:
                label += f" route {routes[name](tdt, x.shape[1], second.shape[2])}"
            if name == "k3_conv_dw":
                route = f3conv.dw_route(tdt, x.shape[1], second.shape[1])
                label += f" route {route}"
                if route == "mma" and not torch.equal(f3conv.k3_conv_dw(xd, sd, a[2]), got):
                    raise AssertionError(f"{key}: K4 differs with pair lists built by the wrapper")
            if name == "strided_dw":
                route = f3conv.dw_route(tdt, x.shape[1], second.shape[1])
                label += f" route {route}"
                t, up = a[2], (a[3] if len(a) > 3 else kw["up"])
                if route == "mma":
                    if t.pairs is None:
                        raise AssertionError("K5 was called without the level's pair lists")
                    bare = replace(t, pairs=None)
                    if not torch.equal(strided_conv.strided_dw(xd, sd, bare, up), got):
                        raise AssertionError(f"{key}: K5 differs with pair lists built by the wrapper")
            if dtype == "float32":
                r["f32_checked"] = True
                log(f"  {label} max|err| {err:.3e} (bit-identical on repeat)")
                continue
            ms = cuda_ms(kern)
            pms = cuda_ms(plain, iters=3)
            nbytes, ops, lib = train_cost(name, a, kw, xd, sd)
            b, by = bound_ms(nbytes, ops, dtype)
            log(
                f"{label} max|err| {err:.3e} kernel {ms:.4f} ms plain {pms:.4f} ms "
                f"bound {b:.4f} ms ({by}) "
                + ("index_add_" if name == "segment_sum" else "one torch.mm") + f" {lib:.4f} ms"
            )
            r["ms"] += count * ms
            r["plain_ms"] += count * pms
            r["bound_ms"] += count * b
            r["_parts"][0 if by == "bytes" else 1] += count * b
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["library_ms"] += count * lib
    for name, r in tot.items():
        parts = r.pop("_parts")
        r.pop("f32_checked")
        r["bound_by"] = "bytes" if parts[0] >= parts[1] else "operations"
        key = name if name in ("k3_conv_dw", "strided_dw", "segment_sum") else name + "_dgrad"
        results.setdefault(key, {}).update(r)


def k6_call_names(keys) -> dict:
    """Where each captured K6 call ("segment_sum", R, V, C, weighted)
    sits in the step: the unweighted call seen first is the voxelize
    forward (the forward runs first), the other the identity devoxelize
    backward; of the trilinear backwards the one over more voxels is at
    stride 4, the other at stride 16."""
    plain = [k for k in keys if not k[4]]
    tri = sorted((k for k in keys if k[4]), key=lambda k: -k[2])
    names = dict(zip(plain, ("voxelize forward", "devox identity backward, stride 1")))
    names.update(zip(tri, ("devox trilinear backward, stride 4", "devox trilinear backward, stride 16")))
    return names


def train_cost(name, a, kw, x, second):
    """(bytes, operations, library ms) of one captured call: each input
    read once and the output written once; operations on the pairs that
    this call's tables hold.  K6's yardstick is one `index_add_` of its
    (weighted) rows into the segments, on rows prepared beforehand; the
    others' one torch.mm on rows gathered beforehand."""
    import torch

    esz = x.element_size()
    if name == "k3_conv_dw":
        rb = a[2]
        v, ci, co = x.shape[0], x.shape[1], second.shape[1]
        pairs = int((rb >= 0).sum())
        return (v * (ci + co) * esz + rb.numel() * 4 + 27 * ci * co * 4,
                2.0 * pairs * ci * co, dw_library_ms(name, x, second, rb))
    if name == "strided_dw":
        t, up = a[2], (a[3] if len(a) > 3 else kw["up"])
        ci, co = x.shape[1], second.shape[1]
        live = int((t.parent >= 0).sum())
        return ((x.numel() + second.numel()) * esz + 8 * t.parent.shape[0] + 8 * ci * co * 4,
                2.0 * live * ci * co, dw_library_ms(name, x, second, t, up))
    if name == "segment_sum":
        t = a[1]
        w = a[2] if len(a) > 2 else kw.get("weights")
        v = t.starts.shape[0] - 1
        r_real = t.perm.shape[0] - v
        p, c = x.shape
        nbytes = t.perm.numel() * 8 + (v + 1) * 4 + x.numel() * esz + v * c * 4
        if w is not None:
            nbytes += r_real * 4
        # segment id of each sorted real row, and its (weighted) source row
        seg = torch.repeat_interleave(torch.arange(v, device=x.device), (t.starts[1:] - t.starts[:-1]).long())
        members = t.perm[: seg.shape[0]]
        keep = members < r_real
        rows_idx = members[keep]
        rows = x[rows_idx % p].float()
        if w is not None:
            rows = rows * w.reshape(-1)[rows_idx][:, None]
        ids = seg[keep]
        out = torch.zeros(v, c, device=x.device)
        lib = cuda_ms(lambda: out.zero_().index_add_(0, ids, rows))
        return nbytes, 2.0 * r_real * c, lib
    # input-gradient calls of K2 / K3: the forward kernels' costs
    w, t = second, a[2]
    rows, ci = x.shape
    co = w.shape[2]
    lib = conv_library_ms(name, x, w, t)
    if name == "sparse_conv_k3":
        pairs = int((t >= 0).sum())
        return (rows * (ci + co) * esz + w.numel() * esz + t.numel() * 4, 2.0 * pairs * ci * co, lib)
    live = int((t.parent >= 0).sum())
    out_rows = t.starts.shape[0] - 1 if name == "strided_down" else t.parent.shape[0]
    nbytes = (rows * ci + w.numel() + out_rows * co) * esz + 4 * (3 * t.parent.shape[0] + t.starts.shape[0])
    return nbytes, 2.0 * live * ci * co, lib


def phase_pair_lists(trainer, scans) -> None:
    """What the pair lists of K4 and K5 cost the topology stage: per
    level of one train topology, the present pairs, the buffer and the
    time of `k3_pair_lists` (one per level and step) and of
    `slot_pair_lists` (one per level but the first).  The pipeline's random
    state is put back, so the timed steps see the augmentations they
    would see without this phase."""
    from taseg_tpu_torch.ops import f3conv, strided_conv

    rng = trainer.pipeline.rng.bit_generator
    state = rng.state
    topo = trainer.topology(trainer.collate(scans[:1]))
    rng.state = state
    tot = 0.0
    for l, lt in enumerate(topo.levels):
        ms = cuda_ms(lambda: f3conv.k3_pair_lists(lt.rb_k3_bwd))
        v, n = lt.rb_k3_bwd.shape[1], int(lt.k3_pairs.starts[-1])
        log(
            f"K4 pair lists level {l}: V={v} voxels={int(lt.num)} pairs={n} "
            f"({n / max(1, int(lt.num)):.2f} per voxel), {8 * 27 * v / 2**20:.1f} MiB, "
            f"built in {ms:.4f} ms"
        )
        tot += ms
    log(f"K4 pair lists: {tot:.4f} ms per step in the topology stage")
    tot = 0.0
    for l, lt in enumerate(topo.levels[1:], start=1):
        ms = cuda_ms(lambda: strided_conv.slot_pair_lists(lt.strided))
        log(
            f"K5 pair lists level {l}: V_fine={lt.strided.parent.shape[0]} "
            f"pairs={int(lt.strided.pairs.starts[-1])}, built in {ms:.4f} ms"
        )
        tot += ms
    log(f"K5 pair lists: {tot:.4f} ms per step in the topology stage")


def phase_small_train_step(cfg, variables) -> None:
    """The same small scan and weights through 2 f32 train steps on the
    card and on the CPU (plain versions): step 0 at LR * 1e-5, step 1 at
    the full LR (warmup of one step).  Loss within 1e-4 relative, grad
    norm within 1e-3, and the parameters' updates within 3e-2 of the
    update's L2 norm (measured 4.2e-4 and 1.3e-2 on an H100: the step
    amplifies summation-order differences, as tests/test_torch_train.py
    shows on the CPU)."""
    import numpy as np

    from taseg_tpu_torch.engine import Trainer
    from taseg_tpu_torch.utils.params_from_jax import export_flax_params

    small = make_scans(1, n_points=8000, seed=SEED + 1)
    cfg_small = {**cfg, "MODEL": {**cfg["MODEL"], "TRAIN_CAPACITY_SCHEDULE": (1.0,) * 5}}
    runs = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(
            cfg_small, variables, device=dev, iters_per_epoch=1, total_epochs=4,
            compute_dtype="float32", point_capacity=8192, seed=SEED,
        )
        runs[dev] = [tr.step(small) for _ in range(2)], export_flax_params(tr.model)[0]
    (g_out, g_par), (c_out, c_par) = runs["cuda"], runs["cpu"]
    p0 = variables["params"]

    def flat(t, pre=""):
        out = {}
        for k, v in t.items():
            out.update(flat(v, pre + k + "/") if isinstance(v, dict) else {pre + k: np.asarray(v, np.float64)})
        return out

    a, b, z = flat(g_par), flat(c_par), flat(p0)
    diff = np.sqrt(sum(((a[k] - b[k]) ** 2).sum() for k in a))
    upd = np.sqrt(sum(((b[k] - z[k]) ** 2).sum() for k in a))
    for i, (g, c) in enumerate(zip(g_out, c_out)):
        log(
            f"small-scan f32 step {i}: loss card {g['loss']:.7f} cpu {c['loss']:.7f}, "
            f"grad norm card {g['grad_norm']:.6f} cpu {c['grad_norm']:.6f}, lr {g['lr']:.3e}"
        )
        if not abs(g["loss"] - c["loss"]) <= 1e-4 * abs(c["loss"]):
            raise AssertionError(f"small-scan step {i}: card and CPU losses disagree")
        if not abs(g["grad_norm"] - c["grad_norm"]) <= 1e-3 * c["grad_norm"]:
            raise AssertionError(f"small-scan step {i}: card and CPU grad norms disagree")
    log(f"small-scan f32 params after 2 steps: |card - cpu| / |update| = {diff / upd:.3e}")
    if not diff <= 3e-2 * upd:
        raise AssertionError("small-scan step: card and CPU updates disagree")


def phase_train_steps(trainer, scans) -> dict:
    """The train path, counted: TRAIN_STEPS calls of `Trainer.step`, one
    120 000-point scan each, with every launch count set to 0 just before
    and read just after; loss, grad norm and every parameter finite; each
    kernel's launches per step as TRAIN_PER_STEP says.  Then the same
    number of steps again by stage (host clock for the host stage, CUDA
    events for the others), and the peak memory of the counted steps."""
    import numpy as np
    import torch

    from taseg_tpu_torch.engine import check_capacity
    from taseg_tpu_torch.ops import _build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    outs = [trainer.step(scans[i % len(scans) : i % len(scans) + 1]) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, o in enumerate(outs):
        log(
            f"train step {i}: loss {o['loss']:.5f} grad norm {o['grad_norm']:.4f} "
            f"lr {o['lr']:.3e} level voxels {o['level_nums']}"
        )
        if not (np.isfinite(o["loss"]) and np.isfinite(o["grad_norm"])):
            raise AssertionError(f"train step {i}: non-finite loss or grad norm")
    for n, p in trainer.model.named_parameters():
        if not torch.isfinite(p).all():
            raise AssertionError(f"train: parameter {n} is not finite")
    log(f"train path launches over {TRAIN_STEPS} steps: {launches}")
    for k, per in TRAIN_PER_STEP.items():
        if launches[k] != per * TRAIN_STEPS:
            raise AssertionError(
                f"train: {k} launched {launches[k]} times, expected {per} per step"
            )
    log(f"train: launches per step as expected: {TRAIN_PER_STEP}")

    stages = {k: [] for k in ("host", "topology", "forward", "backward", "optimizer", "step")}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        a = trainer.collate(scans[i % len(scans) : i % len(scans) + 1])
        t1 = time.perf_counter()
        ev[0].record()
        topo = trainer.topology(a)
        check_capacity(topo, trainer.caps)
        ev[1].record()
        loss = trainer.forward(a, topo)
        ev[2].record()
        trainer.backward(loss)
        ev[3].record()
        trainer.update()
        ev[4].record()
        ev[4].synchronize()
        stages["step"].append((time.perf_counter() - t0) * 1e3)
        stages["host"].append((t1 - t0) * 1e3)
        for j, k in enumerate(("topology", "forward", "backward", "optimizer")):
            stages[k].append(ev[j].elapsed_time(ev[j + 1]))
    med = {k: float(np.median(v)) for k, v in stages.items()}
    log(
        f"train ms per step (median of {TRAIN_STEPS}; counted steps {wall:.1f} ms "
        f"each end to end): " + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
        + f"; peak device memory {peak:.2f} GiB"
    )
    return launches


def phase_train_profile(trainer, scans, results: dict) -> None:
    """Device time per train step of each kernel (torch.profiler device
    events over one step), the split reductions of K4/K5 apart.  User
    annotations (the optimizer's `Optimizer.step` range) span kernels
    that are counted already, and are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.step(scans[:1])
        torch.cuda.synchronize()
    dev = {k: 0.0 for k in KERNEL_NAMES}
    red = busy = 0.0
    others = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU or e.is_user_annotation:
            continue
        ms = e.self_device_time_total / 1e3
        busy += ms
        if "reduce_splits" in e.key:
            red += ms
        mine = [k for k, frags in KERNEL_NAMES.items() if named(e.key, frags)]
        for k in mine:
            dev[k] += ms
        if not mine and "reduce_splits" not in e.key:
            others.append((ms, e.count, e.key[:90]))
    for k, ms in dev.items():
        log(f"profiler train {k}: {ms:.4f} ms per step on the device")
        results.setdefault(k, {})["device_ms_per_step"] = ms or None
    log(f"profiler train: K4/K5 split reductions {red:.4f} ms, all kernels {busy:.4f} ms per step")
    others.sort(reverse=True)
    log(
        f"profiler train: other kernels {sum(o[0] for o in others):.4f} ms per step "
        f"in {sum(o[1] for o in others)} launches; the largest:"
    )
    for ms, n, name in others[:10]:
        log(f"  {ms:.4f} ms x{n} {name}")


def phase_train_probes(trainer, scans) -> None:
    """Device time per call of K4, K5 and K6 at every shape of one more
    captured train step (torch.profiler device events, the call's own
    bf16 inputs and pair lists); after the timed steps, so that neither
    the profiler nor the captured inputs touch them."""
    from taseg_tpu_torch.ops import f3conv, strided_conv, voxelize

    cap = capture_train_calls(trainer, scans[:1])
    k6_names = k6_call_names([k for k in cap.seen if k[0] == "segment_sum"])
    for key, (a, kw) in sorted(cap.seen.items(), key=lambda kv: str(kv[0])):
        name = key[0]
        if name == "k3_conv_dw":
            route = f3conv.dw_route(a[0].dtype, a[0].shape[1], a[1].shape[1])
            label = f"{name} {key[1:]} route {route}"
            call = partial(f3conv.k3_conv_dw, a[0], a[1], a[2], pairs=kw.get("pairs"))
        elif name == "strided_dw":
            route = f3conv.dw_route(a[0].dtype, a[0].shape[1], a[1].shape[1])
            label = f"{name} {key[1:]} route {route}"
            call = partial(strided_conv.strided_dw, *a, **kw)
        elif name == "segment_sum":
            label = f"{name} ({k6_names[key]}) {key[1:]}"
            call = partial(voxelize.segment_sum, *a, **kw)
        else:
            continue
        log(f"profiler {label} x{cap.count[key]}/step: device {fmt_ms(device_ms(call, KERNEL_NAMES[name]))} per call")


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
    phase_point_ops(seg, arrays, topo, cfg["MODEL"]["NUM_CLASS"], results, probes)
    del cap

    # 4. the main path, counted
    _build.reset_launches()
    out = seg.predict(scans)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"main path launches: {launches}")
    for k in INFER_KERNELS:
        if launches[k] <= 0:
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
    if launches["devoxelize"] != DEVOX_PER_SCAN * N_SCANS:
        raise AssertionError(
            f"devoxelize: {launches['devoxelize']} launches, expected "
            f"{DEVOX_PER_SCAN} per scan over {N_SCANS} scans"
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

    # 5. the train path: Trainer of the same model in bf16
    from taseg_tpu_torch.engine import Trainer

    trainer = Trainer(
        cfg, variables, iters_per_epoch=TRAIN_STEPS,
        total_epochs=cfg["OPTIM"]["NUM_EPOCHS"], compute_dtype="bfloat16", seed=SEED,
    )
    log(f"train capacities {list(trainer.caps.voxels)}")
    train_cap = capture_train_calls(trainer, scans[:1])
    phase_train_kernels(train_cap, results)
    del train_cap
    phase_pair_lists(trainer, scans)
    phase_small_train_step(cfg, variables)
    train_launches = phase_train_steps(trainer, scans)

    # 6. device time per kernel on the main paths
    phase_profile(seg, scans, results, {k: launches[k] / N_SCANS for k in KERNEL_NAMES}, probes)
    phase_train_profile(trainer, scans, results)
    phase_train_probes(trainer, scans)

    # 7. the kernels line: K1-K3 and K7 with the inference path's
    # launches (and their train launches), K4-K6 with the train path's
    meta = {
        "join_scan": ("csrc/join_scan.cu", "taseg_tpu/ops/join_scan.py:134"),
        "sparse_conv_k3": ("csrc/sparse_conv.cu", "taseg_tpu/ops/tgf.py:216"),
        "strided_down": ("csrc/strided_conv.cu", "taseg_tpu/ops/strided_conv.py:123"),
        "strided_up": ("csrc/strided_conv.cu", "taseg_tpu/ops/strided_conv.py:152"),
        "k3_conv_dw": ("csrc/conv_dw.cu", "taseg_tpu/ops/f3conv.py:219"),
        "strided_dw": ("csrc/conv_dw.cu", "taseg_tpu/ops/strided_conv.py:136"),
        "segment_sum": ("csrc/segment_sum.cu", "taseg_tpu/ops/voxelize.py:85"),
        "devoxelize": ("csrc/devoxelize.cu", "taseg_tpu/ops/voxelize.py:241,261"),
    }
    per_step = ("k3_conv_dw", "strided_dw", "segment_sum")
    kernels = []
    for name, (src, replaces) in meta.items():
        r = results[name]
        entry = {
            "name": name, "route": "cuda", "source": f"taseg_tpu_torch/{src}",
            "replaces": replaces,
            "launches": (train_launches if name in per_step else launches)[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        }
        if name in per_step:
            entry["per"] = "train step"
            if name in ("k3_conv_dw", "strided_dw"):
                mma = train_launches[f"{name}_mma"]
                entry["launches_by_route"] = {"mma": mma, "simt": train_launches[name] - mma}
        else:
            entry["per"] = "scan"
            mma = launches[f"{name}_mma"] if f"{name}_mma" in launches else None
            if mma is not None:
                entry["launches_by_route"] = {"mma": mma, "simt": launches[name] - mma}
                d = results[f"{name}_dgrad"]
                entry["train"] = {
                    "launches": train_launches[name],
                    "dgrad_launches": train_launches[f"{name}_dgrad"],
                    "dgrad_mma_launches": train_launches[f"{name}_dgrad_mma"],
                    "dgrad_ms_per_step": d["ms"], "dgrad_plain_ms_per_step": d["plain_ms"],
                    "dgrad_bound_ms_per_step": d["bound_ms"], "dgrad_max_abs_err": d["max_abs_err"],
                    "dgrad_library_ms_per_step": d["library_ms"],
                }
            else:
                entry["train"] = {"launches": train_launches[name]}
            entry["device_ms_per_scan"] = r["device_ms"]
        if name == "join_scan":
            entry["kernel_launches_per_call"] = r["kernel_launches_per_call"]
        entry["device_ms_per_train_step"] = r.get("device_ms_per_step")
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
