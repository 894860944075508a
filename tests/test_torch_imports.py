"""The port stands alone: importing it, every submodule (the train
path's loss, optim and f3conv among them) and chip_smoke.py pulls in no
jax, flax, optax or taseg_tpu module; chip_smoke.py refuses to run
without CUDA or without the package beside it, and prints no result."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_CHECK = """
import importlib, pkgutil, sys
import taseg_tpu_torch
names = [m.name for m in pkgutil.walk_packages(taseg_tpu_torch.__path__, "taseg_tpu_torch.")]
train = {"taseg_tpu_torch.loss", "taseg_tpu_torch.loss.lovasz", "taseg_tpu_torch.loss.util",
         "taseg_tpu_torch.optim", "taseg_tpu_torch.ops.f3conv"}
missing = train - set(names)
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "taseg_tpu"))
print(len(names), bad, missing)
sys.exit(1 if bad or missing or len(names) < 25 else 0)
"""


def test_port_imports_no_jax():
    r = subprocess.run(
        [sys.executable, "-c", _CHECK], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_alone_fails_without_result(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120,
    )
    assert r.returncode != 0
    assert r.stdout == ""


def test_chip_smoke_without_cuda_fails_without_result():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: chip_smoke.py would run in full")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert r.returncode != 0
    assert r.stdout == ""
    assert "CUDA" in r.stderr
