#!/usr/bin/env python3
"""K10 (the segment max) and K9 (the KNN clean-up) on one GPU: each
design choice taken out at a time, beside the first designs, in turns.

    python3 tools/k9k10_ablate.py

Device ms here is chip_smoke.py's `graph_ms` (CUDA events around replays
of a CUDA graph of 20 calls: no host cost, every kernel of a call, the
first designs' torch fill and cast included); `cuda_ms` is chip_smoke's,
10 calls back to back.

K10, forward and backward, at Cylinder_TS's real call (one synthetic
scan's point_inverse under the cy480 recipe's topology, 16 ReLU columns
with -0.0 planted, the padding rows -inf in the dummy segment), the same
rows as a random permutation, and the pool's shape (65 536 x 128 sorted
into 2 segments and the dropped rows' third, f32 and bf16).  Variants,
each a copy of `csrc/segment_max.cu` with one edit, built under
`build/k9k10_ablate/<name>/`:
    base          the shipped kernels;
    v1            the first design, through its wrappers;
    ahead_max1    the forward loads one pass's rows before it walks them
                  (`kAheadMax`), not four;
    ahead_count4  the backward's count loads four (`kAheadCount`), not
                  one;
    no_fold       a pass whose rows all continue the open run goes
                  through the scan like any other;
    no_flush      the forward's f32 atomics left out (wrong results: the
                  atomics' share of the time);
    scalar        one column a thread (the plan with vec = 1);
    long_x1       the forward's chunks not lengthened for long segments
                  (`voxelize.K10_LONG_CHUNKS` = 1; the shipped value and
                  16 beside it).

K9 at SalsaNext's real call (one synthetic scan through the recipe's
projection and seeded weights: shuffled, as the synthetic scans come, and
in beam order) and at CENet's nuScenes image (32 x 1920, 34 000 synthetic
points in beam order): the shipped kernel (`base`), the build `skip` (a
candidate not below the fifth kept distance skips the insertion) and v1 (the
first design), each through its wrapper; beside `base`, every launch choice of
tools/k9_variants.cu, the choices the shipped kernel left out (points a
thread 1 or 2, a block staging its image rows in shared memory or not,
window rows in 16-byte pieces or pixel by pixel; `pts=1 stage=0
vec_rows=0` is the shipped kernel's loop), and its 16-byte rows on whole
waves of the SMs (`waves`: the blocks rounded up to a multiple of 132,
the points spread evenly over them), through its bare C entry.

Every variant but no_flush is held to the plain versions' bits first.
Prints each variant's numbers beside the card's name and power limit,
base and v1 first and last.  Imports no JAX.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SOURCES = ("segment_max.cu", "knn_postproc.cu")
ENTRIES = ("taseg_segment_max", "taseg_segment_max_bwd", "taseg_segment_max_v1", "taseg_segment_max_bwd_v1",
           "taseg_knn_postproc", "taseg_knn_postproc_v1")
VARIANTS = {
    "base": [],
    "ahead_max1": [("segment_max.cu", "constexpr int kAheadMax = 4;", "constexpr int kAheadMax = 1;")],
    "ahead_count4": [("segment_max.cu", "constexpr int kAheadCount = 1;", "constexpr int kAheadCount = 4;")],
    "no_fold": [("segment_max.cu", "      if (k > 0 && __all_sync(kFull, id == cid)) {",
                 "      if (false && __all_sync(kFull, id == cid)) {")],
    "no_flush": [("segment_max.cu", "    for (int j = 0; j < VEC; ++j) atomic_max_f32(o + j, v[j]);",
                  "    for (int j = 0; j < VEC; ++j) (void)o;")],
    "skip": [("knn_postproc.cu",
              "__device__ __forceinline__ void insert(float (&bd)[kK], int (&bl)[kK], float d, int l) {\n",
              "__device__ __forceinline__ void insert(float (&bd)[kK], int (&bl)[kK], float d, int l) {\n"
              "  if (!(d < bd[kK - 1])) return;\n")],
}
K10_ORDER = ("base", "v1", "ahead_max1", "ahead_count4", "no_fold", "no_flush", "scalar", "long_x1", "long_x16",
             "v1", "base")
_LIBS: dict = {}  # variant -> its loaded library


def build(name: str) -> None:
    """Compile the two sources with the variant's edits into their own
    library (once a run) and load it in place of the package's."""
    from taseg_tpu_torch.ops import _build

    if name in _LIBS:
        _build._lib = _LIBS[name]
        return
    src, dst = REPO / "taseg_tpu_torch" / "csrc", REPO / "build" / "k9k10_ablate" / name
    if dst.exists():
        shutil.rmtree(dst)
    dst.mkdir(parents=True)
    shutil.copy(src / "common.cuh", dst)
    for f in SOURCES:
        text = (src / f).read_text()
        for file, old, new in VARIANTS.get(name, []):
            if file == f:
                if old not in text:
                    raise RuntimeError(f"{name}: the edit's text is not in {f}")
                text = text.replace(old, new)
        (dst / f).write_text(text)
    lib = dst / "libk9k10.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(dst), "-o", str(lib),
           *(str(dst / f) for f in SOURCES)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"{name}: nvcc failed:\n{out.stdout}{out.stderr}")
    if name == "base":
        print("\n".join(l for l in (out.stdout + out.stderr).splitlines()
                        if "Compiling entry" in l or "registers" in l))
    cdll = ctypes.CDLL(str(lib))
    for e in ENTRIES:
        fn = getattr(cdll, e)
        fn.argtypes = _build._SIGNATURES[e]
        fn.restype = ctypes.c_int
    _build._lib = _LIBS[name] = cdll


def k10_cases(dev):
    import numpy as np
    import torch

    import chip_smoke as cs
    from taseg_tpu_torch.configs import CYLINDER_CY480_CR10
    from taseg_tpu_torch.engine import Segmenter
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    params, stats = init_params_numpy(CYLINDER_CY480_CR10, seed=cs.SEED)
    seg = Segmenter(CYLINDER_CY480_CR10, {"params": params, "batch_stats": stats})
    topo = seg.topology(seg.collate(cs.make_scans(1)))
    inv, v0 = topo.point_inverse, topo.levels[0].coords.shape[0]
    ids = torch.where(inv >= 0, inv, v0).to(torch.int32)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    x = torch.relu(torch.randn(inv.shape[0], 16, device=dev, generator=gen))
    x = torch.where(torch.rand(x.shape, device=dev, generator=gen) < 0.05, -0.0, x)
    x = torch.where((inv >= 0)[:, None], x, float("-inf"))
    real = int((inv >= 0).sum())
    perm = torch.randperm(real, device=dev, generator=gen).to(torch.int32)
    shuffled = torch.cat([perm, torch.full((x.shape[0] - real,), real, dtype=torch.int32, device=dev)])
    xs = torch.cat([x[inv >= 0], x[inv < 0]])
    rng = np.random.default_rng(0)
    pool = torch.from_numpy(np.round(rng.normal(size=(65_536, 128)) * 4).astype(np.float32) / 4).to(dev)
    pseg = torch.from_numpy(((np.arange(65_536) >= 30_000).astype(np.int32)
                             + (np.arange(65_536) >= 64_000))).to(dev)
    ordered = float((ids[1:real].long() - ids[: real - 1].long() == 1).float().mean())
    print(f"cylinder's real ids: {real} rows of {x.shape[0]} in {v0 + 1} segments, {ordered:.3f} of the rows "
          f"followed by the next segment's", flush=True)
    del seg
    return [
        ("cylinder", x, ids, v0 + 1),
        ("cylinder, ids permuted", xs, shuffled, real + 1),
        ("pool f32", pool, pseg, 3),
        ("pool bf16", pool.bfloat16(), pseg, 3),
    ]


def k9_cases(dev):
    import numpy as np
    import torch

    import chip_smoke as cs
    from taseg_tpu_torch.configs import SALSANEXT_RES34
    from taseg_tpu_torch.engine import Segmenter
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    params, stats = init_params_numpy(SALSANEXT_RES34, seed=cs.SEED)
    seg = Segmenter(SALSANEXT_RES34, {"params": params, "batch_stats": stats})
    args = cs.k9_args(seg, cs.make_scans(1))
    del seg
    rng = np.random.default_rng(1)
    h, w, p = 32, 1920, 34_000
    r = rng.uniform(2.0, 60.0, (1, h, w)).astype(np.float32)
    r[rng.random((1, h, w)) < 0.4] = 0.0
    lab = rng.integers(0, 17, (1, h, w)).astype(np.int32)
    py, px = rng.integers(0, h, p).astype(np.int32), rng.integers(0, w, p).astype(np.int32)
    o = np.lexsort((px, py))
    py, px = py[o], px[o]
    u = (r[0, py, px] + rng.normal(0, 0.3, p)).astype(np.float32)
    cenet = tuple(torch.from_numpy(a).to(dev) for a in (r, u, lab, px, py, np.zeros(p, np.int32)))
    return [("salsanext", args, 20), ("salsanext beam order", cs.beam_order(args), 20), ("cenet", cenet, 17)]


def k10_rows(name, cases, grads):
    """(label, fwd device, bwd device, fwd cuda_ms, bwd cuda_ms) of each
    K10 case on the loaded build, held to the plain versions' bits."""
    import torch

    import chip_smoke as cs
    from taseg_tpu_torch.ops import voxelize as vx

    plan_of, long_chunks = vx.segment_max_plan, vx.K10_LONG_CHUNKS
    if name == "scalar":
        vx.segment_max_plan = lambda p, c, esz, aligned=True, segments=0: plan_of(p, c, esz, False, segments)
    elif name.startswith("long_x"):
        vx.K10_LONG_CHUNKS = int(name[6:])
    fwd_of = vx.segment_max_v1 if name == "v1" else vx.segment_max_kernel
    bwd_of = vx.segment_max_bwd_v1 if name == "v1" else vx.segment_max_bwd_kernel
    rows = []
    try:
        for (label, x, seg, s), g in zip(cases, grads):
            want = vx.segment_max_plain(x, seg, s)
            fwd = lambda x=x, seg=seg, s=s: fwd_of(x, seg, s)
            bwd = lambda x=x, seg=seg, out=want, g=g: bwd_of(x, seg, out, g)
            if name != "no_flush":
                if not (torch.equal(cs.bits(fwd()), cs.bits(want)) and torch.equal(cs.bits(fwd()), cs.bits(want))):
                    raise AssertionError(f"K10 {name} {label}: the forward differs from the plain version's bits")
                dwant = vx.segment_max_bwd_plain(x, seg, want, g)
                if not (torch.equal(cs.bits(bwd()), cs.bits(dwant)) and torch.equal(cs.bits(bwd()), cs.bits(dwant))):
                    raise AssertionError(f"K10 {name} {label}: the backward differs from the plain version's bits")
            rows.append((label, cs.graph_ms(fwd), cs.graph_ms(bwd), cs.cuda_ms(fwd), cs.cuda_ms(bwd)))
    finally:
        vx.segment_max_plan, vx.K10_LONG_CHUNKS = plan_of, long_chunks
    return rows


def k9_variants():
    """tools/k9_variants.cu compiled into its own library (once a run)."""
    from taseg_tpu_torch.ops import _build

    if "k9_variants" not in _LIBS:
        dst = REPO / "build" / "k9k10_ablate" / "k9_variants"
        dst.mkdir(parents=True, exist_ok=True)
        lib = dst / "libk9v.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(REPO / "tools" / "k9_variants.cu")]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"k9_variants.cu: nvcc failed:\n{out.stdout}{out.stderr}")
        fn = ctypes.CDLL(str(lib)).k9_variant_postproc
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIBS["k9_variants"] = fn
    return _LIBS["k9_variants"]


def k9_call(args, n_cls, pts, stage, vec_rows, blocks=None):
    """tools/k9_variants.cu with these launch choices: blocks of 256 x
    pts points, or `blocks` with the points spread evenly over them."""
    import torch

    from taseg_tpu_torch.ops import knn

    r, u, lab, px, py, img = args
    p = u.shape[0]
    if blocks is None:
        blocks = -(-p // (256 * pts))
    out = torch.empty(p, dtype=torch.int32, device=u.device)
    err = k9_variants()(*(t.data_ptr() for t in (r, lab, u, px, py, img)), knn._host_weights(1.0)[1],
                        out.data_ptr(), p, r.shape[1], r.shape[2], n_cls, 1.0, blocks, -(-p // blocks), pts, stage,
                        vec_rows, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"k9_variant_postproc: CUDA error {err}")
    return out


def main() -> int:
    import torch

    import chip_smoke as cs
    from taseg_tpu_torch.ops import knn

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    k10, k9 = k10_cases(dev), k9_cases(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    grads = [torch.randn((s, x.shape[1]), device=dev, generator=gen).to(x.dtype) for _, x, _, s in k10]
    for i, name in enumerate(K10_ORDER):
        build(name if name in VARIANTS else "base")
        key = name if K10_ORDER.index(name) == i else f"{name} again"
        rows = k10_rows(name, k10, grads)
        print(f"{smi}: K10 {key} (device fwd / bwd, cuda_ms fwd / bwd): " + " | ".join(
            f"{l} {cs.fmt_ms(f)} / {cs.fmt_ms(b)}, {cf:.4f} / {cb:.4f}" for l, f, b, cf, cb in rows), flush=True)

    choices = [(pts, stage, vec) for pts in (1, 2) for stage in (0, 1) for vec in (0, 1)]
    for name in ("v1", "base", "skip", "base", "v1"):
        build(name if name in VARIANTS else "base")
        for label, args, n_cls in k9:
            want = knn.knn_postprocess_plain(*args, num_classes=n_cls)
            if name == "v1":
                calls = {"v1": lambda: knn.knn_postprocess_v1(*args, num_classes=n_cls)}
            else:
                calls = {name: lambda: knn.knn_postprocess(*args, num_classes=n_cls)}
            if name == "base":
                calls.update({f"pts={pts} stage={stage} vec_rows={vec}":
                              (lambda pts=pts, stage=stage, vec=vec: k9_call(args, n_cls, pts, stage, vec))
                              for pts, stage, vec in choices})
                blocks = -(-args[1].shape[0] // 256)
                calls["waves"] = lambda blocks=blocks: k9_call(args, n_cls, 1, 0, 1, blocks=132 * -(-blocks // 132))
            row = []
            for key, fn in calls.items():
                if not (torch.equal(fn(), want) and torch.equal(fn(), want)):
                    raise AssertionError(f"K9 {name} {key} {label}: labels differ from the plain version's")
                row.append(f"{key} {cs.fmt_ms(cs.graph_ms(fn))}, {cs.cuda_ms(fn, 20):.4f}")
            print(f"{smi}: K9 {name} {label} (device, cuda_ms): " + " | ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
