#!/usr/bin/env python3
"""Where the f32 weight-gradient tile (`csrc/wgmma_tf32_dw.cuh`) spends
its time, on one GPU: device ms of the tile with one part of its work
taken out at a time.

    python3 tools/dw_tf32_ablate.py

Builds copies of the kernel sources under `build/dw_tf32_ablate/<name>/`,
each with one edit, and times K4 at K offsets on each (torch.profiler,
mean of 5 calls) at four synthetic calls shaped as the largest of
TIAF's and Cylinder_TS's steps (reverse tables with one pair an input
row, each offset's output rows a fixed shift of its input rows, the
centre offset full, widths padded as the wrappers pad them):

  base          the shipped tile;
  no_transpose  the consumer does not transpose or split B (the tensor
                cores read a stale B buffer);
  no_mma        no wgmma (the stage accumulator stays zero);
  one_mma       one wgmma a k8 step (hi * hi) in place of three;
  no_gather     the producer's copies zero-fill their rows (no global
                read; the stages still land through their barriers).

Every variant but `base` gives wrong results on purpose; `base` is held
to the plain version (1e-4 of the largest sum of |terms|).  Prints each
variant's times beside the card's name and power limit.  Imports no JAX.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

HEADER = "wgmma_tf32_dw.cuh"
MMAS = """      wt::Mma<T::BN>::run(part, al[kk], dh, kk > 0);
      wt::Mma<T::BN>::run(part, ah[kk], dl, 1);
      wt::Mma<T::BN>::run(part, ah[kk], dh, 1);"""
VARIANTS = {
    "base": [],
    "no_transpose": [("    transpose_b<T>(s, slot, bh, threadIdx.x);\n", "")],
    "no_mma": [(MMAS, "      (void)dh;\n      (void)dl;")],
    "one_mma": [(MMAS, "      wt::Mma<T::BN>::run(part, ah[kk], dh, kk > 0);\n      (void)dl;")],
    "no_gather": [("    const bool ok = q < n_w && c < c_in;", "    const bool ok = false;"),
                  ("    const bool ok = q < n_w && col < c_out;", "    const bool ok = false;")],
}
# (K, V, C_in, C_out, share of rows in each non-centre offset's list)
CALLS = ((27, 41984, 256, 256, 0.25), (27, 262144, 96, 96, 0.095), (27, 41984, 128, 128, 0.25),
         (9, 131072, 32, 32, 0.1))


def sources(name: str) -> Path:
    """A copy of the kernel sources with the variant's edits."""
    src, dst = REPO / "taseg_tpu_torch" / "csrc", REPO / "build" / "dw_tf32_ablate" / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    h = dst / HEADER
    text = h.read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"{name}: the edit's text is not in {HEADER}")
        text = text.replace(old, new)
    h.write_text(text)
    return dst


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from taseg_tpu_torch.ops import _build, f3conv

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cases = []
    for k, v, c_in, c_out, share in CALLS:
        rb = np.full((k, v), -1, np.int32)
        for j in range(k):
            keep = rng.random(v) < (1.0 if j == k // 2 else share)
            to = np.clip(np.arange(v) + rng.integers(-64, 64), 0, v - 1)
            rb[j, keep] = to[keep]
        rb = torch.from_numpy(rb).to(dev)
        x, g = torch.randn(v, c_in, device=dev), torch.randn(v, c_out, device=dev)
        cases.append((f"K={k} V={v} {c_in}->{c_out}", x, g, rb, f3conv.pair_lists(rb)))
    for name in VARIANTS:
        _build.CSRC = sources(name)
        _build.BUILD_DIR = REPO / "build" / "dw_tf32_ablate" / f"lib-{name}"
        _build._lib = None
        _build.get_lib()
        row = []
        for label, x, g, rb, lists in cases:
            k, v = rb.shape

            def run():
                return f3conv.launch_dw_tf32("taseg_sparse_conv_dw_tf32", "", x, g, lists, k, v, k * v, k)

            if name == "base":
                cs.check_close(label, run(), f3conv.k3_conv_dw_plain(x, g, rb),
                               f3conv.k3_conv_dw_plain(x.abs(), g.abs(), rb), "float32", 1e-4)
            ms = cs.device_ms(run, ("dw_tf32_wgmma_kernel",), iters=5)
            row.append(f"{label} pairs={int(lists.starts[-1])}: {cs.fmt_ms(ms)}")
        print(f"{smi}: {name} " + " | ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
