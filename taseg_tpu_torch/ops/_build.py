"""Build, load and count the port's hand-written CUDA kernels.

The sources in `taseg_tpu_torch/csrc/*.cu` have a plain C interface.  At
first use `nvcc` compiles each of them for `sm_90a` (all started
together), links them into `build/kernels/libtaseg_kernels-<hash>.so`,
and the library is loaded with `ctypes`.  The hash covers the sources,
the headers and the flags, so an edited source is rebuilt and an
unchanged one is reused.  Nothing is built when a module is imported.

Each kernel wrapper adds one to its entry of `LAUNCHES` where it launches
its kernel, and nowhere else, so a run can show which kernels it went
through.
"""

from __future__ import annotations

import ctypes
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
    "strided_down": 0,
    "strided_up": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (all return cudaError_t as int)
_SIGNATURES = {
    "taseg_join_scan": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "taseg_sparse_conv_k3": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "taseg_strided_down": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "taseg_strided_up": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
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


def launch(name: str, counter: str, *args) -> None:
    """Call C entry point `name` on the current stream, raise on a CUDA
    error, and count the launch under `counter`."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(get_lib(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")
    LAUNCHES[counter] += 1


def check(name: str, t: torch.Tensor, dtypes, ndim: int, device) -> None:
    """Raise unless `t` is a contiguous tensor of one of `dtypes`, with
    `ndim` dimensions, on `device`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def dispatch(t: torch.Tensor) -> bool:
    """True when the kernel must run (CUDA tensor), False for the plain
    version (CPU tensor); raises for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")
