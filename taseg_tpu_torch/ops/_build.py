"""Build, load and count the port's hand-written CUDA kernels.

The sources in `taseg_tpu_torch/csrc/*.cu` have a plain C interface.  At
first use `nvcc` compiles each of them for `sm_90a` (all started
together), links them into `build/kernels/libtaseg_kernels-<hash>.so`,
and the library is loaded with `ctypes`.  The hash covers the sources,
the headers and the flags, so an edited source is rebuilt and an
unchanged one is reused.  Nothing is built when a module is imported.

Each kernel wrapper adds one to its entries of `LAUNCHES` where it
launches its kernel, and nowhere else, so a run can show which kernels it
went through.  `sparse_conv_k3`, `strided_down` and `strided_up` count
every launch of K2, K3-down and K3-up; the route entries count those
that took a route: `sparse_conv_k3_wgmma`, `strided_down_wgmma` and
`strided_up_wgmma` the Hopper wgmma tile (K2, K3-down and K3-up in
bf16, over row orders), `strided_down_tf32` and `strided_up_tf32` K2 at
K's 3xTF32 tile (K3 in f32), `strided_down_rounds` K3-down's round
kernels (child tables of several rounds), `k3_conv_dw_wgmma` and
`strided_dw_wgmma` the wgmma tile over pair lists (K4 over the offset
lists, K5 over the slot lists, bf16), `strided_dw_tf32` the 3xTF32
wgmma tile over pair lists (K5 in f32; K4 at K offsets counts it under
`sparse_conv_dw_tf32`).  The `_dgrad` counters count, again, the launches of K2 and
K3 that compute an input gradient (the backward of the k3 conv and of
the other strided direction).  K1 (`join_scan`), K4 on its wgmma route
and K5 (`k3_conv_dw`, `strided_dw`, their splits added in the kernel)
and K6 (`segment_sum`, a segment cut across units finished by its last
piece) launch one kernel per call; K4 on CUDA cores counts one per call,
its second kernel (the split reduction) included, as do K2's and
K3's split routes; K7 (`devoxelize`) launches one kernel per call,
trilinear, bilinear or identity, or up to three of them summed or
concatenated (`devoxelize_multi` counts these again: the MinkUNet head,
KD's features, TIAF's taps and image gathers), and `devoxelize_bilinear`
counts again those at 4 corners (RPVNet's `range_to_point`); K8 (`voxelize_bwd`)
launches one per call.  K2 at K offsets (`sparse_conv`, Cylinder3D's
convs) counts under its own `sparse_conv_k` (`_wgmma`, `_tf32`,
`_dgrad`, `_dgrad_wgmma`, `_dgrad_tf32` as K2's), so K2's 27-offset
counts stay those of the 3^3 convs; K4 at K offsets (`sparse_conv_dw`,
`_tf32`) launches one kernel per call on its 3xTF32 wgmma tile (its
splits added in the kernel) and counts one per call, its split reduction
included, on CUDA cores.  K9 (`knn`, the
range view's KNN clean-up) launches one kernel per call, one call per
batch of scans.  K10 (`segment_max`, Cylinder3D's max-pooled voxelize
and the global max pool) counts one per call each way, its backward
again under `segment_max_bwd`: a forward call launches two kernels (the
-inf fill and the runs kernel), a backward three (the tie counts
zeroed, the ties counted, the shares).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# launches per kernel wrapper; see reset_launches
LAUNCHES = {
    "join_scan": 0,
    "sparse_conv_k3": 0,
    "sparse_conv_k3_wgmma": 0,
    "strided_down": 0,
    "strided_down_wgmma": 0,
    "strided_down_tf32": 0,
    "strided_down_rounds": 0,
    "strided_up": 0,
    "strided_up_wgmma": 0,
    "strided_up_tf32": 0,
    "sparse_conv_k3_dgrad": 0,
    "sparse_conv_k3_dgrad_wgmma": 0,
    "strided_down_dgrad": 0,
    "strided_down_dgrad_wgmma": 0,
    "strided_down_dgrad_tf32": 0,
    "strided_down_dgrad_rounds": 0,
    "strided_up_dgrad": 0,
    "strided_up_dgrad_wgmma": 0,
    "strided_up_dgrad_tf32": 0,
    "k3_conv_dw": 0,
    "k3_conv_dw_wgmma": 0,
    "strided_dw": 0,
    "strided_dw_wgmma": 0,
    "strided_dw_tf32": 0,
    "segment_sum": 0,
    "devoxelize": 0,
    "devoxelize_bilinear": 0,
    "devoxelize_multi": 0,
    "voxelize_bwd": 0,
    "sparse_conv_k": 0,
    "sparse_conv_k_wgmma": 0,
    "sparse_conv_k_dgrad": 0,
    "sparse_conv_k_dgrad_wgmma": 0,
    "sparse_conv_dw": 0,
    "sparse_conv_k_tf32": 0,
    "sparse_conv_k_dgrad_tf32": 0,
    "sparse_conv_dw_tf32": 0,
    "knn": 0,
    "segment_max": 0,
    "segment_max_bwd": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argument types (all return cudaError_t as int)
_SIGNATURES = {
    "taseg_join_scan": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "taseg_sparse_conv_k3": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "taseg_sparse_conv_k3_mma": [_P, _P, _P, _P, _I, _I, _I, _P],
    "taseg_strided_down": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "taseg_strided_down_mma": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "taseg_strided_up": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "taseg_strided_up_mma": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "taseg_k3_conv_dw": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "taseg_k3_conv_dw_mma": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "taseg_k3_conv_dw_wgmma": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "taseg_strided_dw": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "taseg_strided_dw_wgmma": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "taseg_strided_dw_tf32": [_P] * 7 + [_I] * 6 + [_P],
    "taseg_strided_dw_tf32_mma": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "taseg_segment_sum": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "taseg_devox_trilinear": [_P, _P, _P, _P, _I, _I, _I, _P],
    "taseg_devox_bilinear": [_P, _P, _P, _P, _I, _I, _I, _P],
    "taseg_devox_identity": [_P, _P, _P, _I, _I, _I, _P],
    "taseg_devox_multi": [_P, _P, _P, _I, _I] * 3 + [_I, _P, _P, _I, _I, _I, _P],
    "taseg_voxelize_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "taseg_sparse_conv_k": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "taseg_sparse_conv_dw": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "taseg_sparse_conv_k_tf32": [_P] * 8 + [_I] * 10 + [_P],
    "taseg_sparse_conv_k_tf32_mma": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "taseg_sparse_conv_dw_tf32": [_P] * 7 + [_I] * 6 + [_P],
    "taseg_sparse_conv_dw_tf32_mma": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "taseg_sparse_conv_wgmma": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "taseg_strided_down_wgmma": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "taseg_strided_up_wgmma": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "taseg_sparse_conv_wgmma_blocks": [_I, _I, _I, _P],
    "taseg_knn_postproc": [_P] * 8 + [_I] * 4 + [_F, _P],
    "taseg_knn_postproc_v1": [_P] * 8 + [_I] * 4 + [_F, _P],
    "taseg_segment_max": [_P] * 3 + [_I] * 9 + [_P],
    "taseg_segment_max_bwd": [_P] * 7 + [_I] * 9 + [_P],
    "taseg_segment_max_v1": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "taseg_segment_max_bwd_v1": [_P] * 7 + [_I] * 5 + [_P],
}

_lib = None
build_info: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cands = [
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> tuple[list[Path], str]:
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return srcs, h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source hash has no library yet.
    Returns the library path; `build_info` records the time and the
    compiler's register/spill report."""
    srcs, digest = _sources()
    lib_path = BUILD_DIR / f"libtaseg_kernels-{digest}.so"
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, fresh=False)
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for s in srcs:
            obj = Path(tmp) / (s.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(s), "-o", str(obj)]
            procs.append(
                (s, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                ))
            )
        log = []
        failed = []
        for s, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== {s.name}\n{out}")
            if p.returncode != 0:
                failed.append(s.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log)
            )
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    build_info.update(
        path=str(lib_path), seconds=time.perf_counter() - t0, fresh=True,
        log="\n".join(log),
    )
    return lib_path


def get_lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def counters(name: str, *, dgrad: bool = False, suffix: str = "") -> tuple:
    """The LAUNCHES entries that one launch of wrapper `name` counts
    under: its own, `<name>_dgrad` for an input-gradient call, and, on a
    named route, the route's entry of each (`suffix`: `_wgmma` for the
    Hopper tiles, `_rounds` for K3-down's round kernels, `_tf32` for
    3xTF32)."""
    names = (name, name + "_dgrad") if dgrad else (name,)
    return names + tuple(n + suffix for n in names) if suffix else names


def _raw_stream() -> int:
    """The current CUDA stream of the current device, as an int: torch's
    C accessor where this build has it (no Stream object per call), else
    through `torch.cuda.current_stream()`."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream().cuda_stream
    return raw(torch._C._cuda_getDevice())


def launch(name: str, counters: tuple[str, ...], *args) -> None:
    """Call C entry point `name` on the current stream, raise on a CUDA
    error, and count the launch under each of `counters`."""
    err = getattr(get_lib(), name)(*args, _raw_stream())
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")
    for c in counters:
        LAUNCHES[c] += 1


def wgmma_blocks_per_sm(c_in: int, c_out: int, n_off: int) -> int:
    """Resident blocks per SM of K2's wgmma route at these widths and
    offsets (the CUDA occupancy calculator; needs the card)."""
    n = ctypes.c_int(0)
    err = get_lib().taseg_sparse_conv_wgmma_blocks(c_in, c_out, n_off, ctypes.addressof(n))
    if err != 0:
        raise RuntimeError(f"taseg_sparse_conv_wgmma_blocks failed with CUDA error {err}")
    return n.value


def check(name: str, t: torch.Tensor, dtypes, ndim: int, device, contiguous: bool = True) -> None:
    """Raise unless `t` is a tensor of one of `dtypes`, with `ndim`
    dimensions, on `device`, and contiguous (any strides where not
    `contiguous`)."""
    if (isinstance(t, torch.Tensor) and t.dtype in dtypes and t.dim() == ndim
            and t.device == device and (t.is_contiguous() or not contiguous)):
        return
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_aligned(**tensors: torch.Tensor) -> None:
    """Raise unless every tensor's data starts on a 16-byte boundary (the
    tensor-core kernels copy rows in 16-byte pieces)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data not 16-byte aligned")


_COUNTERS: dict = {}  # (device, stream) -> int32 tensor, zero between calls


def zeroed_counters(device, n: int) -> torch.Tensor:
    """At least `n` int32 counters on `device`'s current stream, zero on
    entry: the kernels that finish their split sums in the last block to
    arrive (K5, K6) count arrivals there and set each counter they used
    back to 0 before they exit, so one buffer per device and stream
    serves every call, cleared once when it is made or grown.  Calls on
    one stream run in order."""
    key = (device.index, _raw_stream())
    buf = _COUNTERS.get(key)
    if buf is None or buf.shape[0] < n:
        grown = max(n, 2 * (0 if buf is None else buf.shape[0]), 1024)
        buf = _COUNTERS[key] = torch.zeros(grown, dtype=torch.int32, device=device)
    return buf


def dispatch(t: torch.Tensor) -> bool:
    """True when the kernel must run (CUDA tensor), False for the plain
    version (CPU tensor); raises for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")
