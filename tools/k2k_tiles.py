#!/usr/bin/env python3
"""Tile shape and chain splits of K2 at K's mma.sync 3xTF32 tile, on one GPU
(the tile the wgmma tile of `csrc/wgmma_tf32.cuh` replaced on the path;
it stays as `chip_smoke.py`'s yardstick `old_ms`).

    python3 tools/k2k_tiles.py

Copies `taseg_tpu_torch` to `build/k2k_tiles/` with one more C entry,
`taseg_sparse_conv_k_tf32_cfg`, that launches `k_tf32_mma_kernel`
at a chosen tile (BN output columns, BK input channels per stage, ST
stages in the cp.async ring) and number of chain splits S, and builds it.
Then it captures every distinct K2-at-K call of Cylinder_TS cy480 cr1.0
(f32, seeded weights, one synthetic 120 000-point scan): the serving
forward's and one train step's input gradients, with the topology's row
orders.  Each call runs at BN 32 / 64 / 128 x (BK, ST) (16, 3) / (16, 4)
/ (32, 3) x S 1 / 2 / 4, checked against the plain version (within 1e-5
of the largest sum of |terms|) and timed (CUDA events, mean of 10
launches).  It prints per call the time of every variant and of the
shipped rule (`sparse_conv.k_splits`, BK 32, ST 3, BN from C_out), and
the sums over a forward plus its input gradients for the shipped rule,
the first kernel (BK 16, S 1), the best single variant and the best per
call, beside the card's name and power limit.  Imports no JAX.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
COPY = REPO / "build" / "k2k_tiles"
TILES = [(bn, bk, st) for bn in (32, 64, 128) for bk, st in ((16, 3), (16, 4), (32, 3))]
SPLITS = (1, 2, 4)


def make_copy() -> None:
    """The package at COPY, its sparse_conv.cu with the entry that picks
    the tile at run time."""
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(REPO / "taseg_tpu_torch", COPY / "taseg_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cases = "\n".join(
        f"  if (bn == {bn} && bk == {bk} && st == {st})\n"
        f"    return launch_k_tf32<taseg::tf32::Tile<{bn}, {bk}, {st}>>(feats, w, rb, order, out, "
        "part, live, v_out, c_in, c_out, n_off, splits, static_cast<cudaStream_t>(stream), c_out);"
        for bn, bk, st in TILES
    )
    src = COPY / "taseg_tpu_torch" / "csrc" / "sparse_conv.cu"
    src.write_text(src.read_text() + f"""
extern "C" int taseg_sparse_conv_k_tf32_cfg(const void* feats, const void* w,
    const void* rb, const void* order, void* out, void* part, void* live,
    int v_out, int c_in, int c_out, int n_off, int splits, int bn, int bk,
    int st, void* stream) {{
{cases}
  return static_cast<int>(cudaErrorInvalidValue);
}}
""")


def tile_n(c_out: int) -> int:
    """csrc/gather_mma.cuh with_tile_n_f32."""
    return 32 if c_out <= 32 else 64 if c_out <= 64 else 128


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    make_copy()
    sys.path[:0] = [str(COPY), str(REPO)]
    import chip_smoke as cs
    from taseg_tpu_torch.configs import CYLINDER_CY480_CR10
    from taseg_tpu_torch.engine import Segmenter, Trainer
    from taseg_tpu_torch.ops import _build, sparse_conv
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    if not _build.__file__.startswith(str(COPY)):
        raise RuntimeError(f"imported {_build.__file__}, not the copy")
    P, I = ctypes.c_void_p, ctypes.c_int
    _build._SIGNATURES["taseg_sparse_conv_k_tf32_cfg"] = [P] * 7 + [I] * 8 + [P]
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    fn = _build.get_lib().taseg_sparse_conv_k_tf32_cfg

    cfg = CYLINDER_CY480_CR10
    params, stats = init_params_numpy(cfg, seed=cs.SEED)
    variables = {"params": params, "batch_stats": stats}
    scans = cs.make_scans(1)
    seg = Segmenter(cfg, variables)
    a = seg.collate(scans)
    cap = cs.cylinder_calls(lambda: seg.forward(a, seg.topology(a)))
    trainer = Trainer(cfg, variables, iters_per_epoch=4, total_epochs=10, seed=cs.SEED)
    cap_train = cs.cylinder_calls(lambda: trainer.step(scans))
    calls = {k: (v, cap.count[k]) for k, v in cap.seen.items()}
    calls.update({k: (v, cap_train.count[k]) for k, v in cap_train.seen.items()
                  if k[0] == "sparse_conv_k_dgrad"})

    stream = torch.cuda.current_stream().cuda_stream
    variants = [(t, s) for t in TILES for s in SPLITS]
    sums = {name: 0.0 for name in ("shipped", "first", "best per call")}
    by_variant = {v: 0.0 for v in variants}
    for key, ((args, kw), n) in sorted(calls.items(), key=lambda kv: str(kv[0])):
        x, w, rb = args[:3]
        w = w.contiguous()  # the mma.sync tile reads W (K, C_in, C_out) row-major; an input gradient's W^T is a view
        order = kw.get("order")
        if order is None:
            order = sparse_conv.mask_row_order(rb)
        k, v_out = rb.shape
        c_in, c_out = x.shape[1], w.shape[2]
        want = sparse_conv.sparse_conv_plain(x, w, rb)
        scale = sparse_conv.sparse_conv_plain(x.abs(), w.abs(), rb).abs().max().item()
        part = torch.empty((max(SPLITS) - 1, v_out, c_out), device=x.device)
        live = torch.empty((max(SPLITS) - 1, -(-v_out // 64)), dtype=torch.int32, device=x.device)
        out = torch.empty_like(want)
        ms = {}
        for (bn, bk, st), sp in variants:
            def run(bn=bn, bk=bk, st=st, sp=sp):
                err = fn(x.data_ptr(), w.data_ptr(), rb.data_ptr(), order.data_ptr(), out.data_ptr(),
                         part.data_ptr(), live.data_ptr(), v_out, c_in, c_out, k, sp, bn, bk, st, stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")
            run()
            err = (out - want).abs().max().item()
            if not err <= 1e-5 * scale:
                raise AssertionError(f"{key} {bn}/{bk}/{st} S={sp}: max|err| {err:.3e} > {1e-5 * scale:.3e}")
            ms[((bn, bk, st), sp)] = cs.cuda_ms(run)
        shipped = ms[((tile_n(c_out), 32, 3), sparse_conv.k_splits(v_out))]
        first = ms[((tile_n(c_out), 16, 3), 1)]
        best = min(ms, key=ms.get)
        sums["shipped"] += n * shipped
        sums["first"] += n * first
        sums["best per call"] += n * ms[best]
        for v in variants:
            by_variant[v] += n * ms[v]
        print(
            f"{key} x{n}: shipped {shipped:.4f} ms, BK 16 S 1 {first:.4f}, best {best} {ms[best]:.4f} | "
            + " ".join(f"{t[0]}/{t[1]}/{t[2]} S{s}: {v:.4f}" for (t, s), v in ms.items()),
            flush=True,
        )
    print("sums over one forward and its input gradients (ms): "
          + ", ".join(f"{name} {v:.4f}" for name, v in sums.items()))
    best = min(by_variant, key=by_variant.get)
    print(f"best single variant {best}: {by_variant[best]:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
