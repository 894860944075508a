"""The port stands alone: importing it, every submodule (the train
path's loss, optim and f3conv, models/fusion, RPVNet's range blocks,
point_range and fusion pipeline, Cylinder3D's model, pipeline and the
K-offset conv entries, the multi-scan readers, poses and SMSA, TIAF's
model, pipeline, readers and parameter groups, the range view's models,
pipeline, losses, train step and K9's wrapper, the nuScenes and Waymo
readers, the sparse tensors, the BEV ops and modules, torchsparse's
backbones, EQLv2, the checkpoint converter and the Petrel storage among
them) and
chip_smoke.py pulls in no jax, flax, optax or taseg_tpu module;
chip_smoke.py refuses to run without CUDA or without the package beside
it, and prints no result."""

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
         "taseg_tpu_torch.optim", "taseg_tpu_torch.ops.f3conv",
         "taseg_tpu_torch.models.fusion", "taseg_tpu_torch.models.fusion.spvcnn",
         "taseg_tpu_torch.models.fusion.rpvnet", "taseg_tpu_torch.models.range2d",
         "taseg_tpu_torch.models.range2d.blocks", "taseg_tpu_torch.ops.point_range",
         "taseg_tpu_torch.data.fusion_dataset", "taseg_tpu_torch.ops.sparse_conv",
         "taseg_tpu_torch.models.voxel.cylinder3d", "taseg_tpu_torch.data.cylinder_dataset",
         "taseg_tpu_torch.data.semantickitti.poses", "taseg_tpu_torch.data.semantickitti.smsa",
         "taseg_tpu_torch.data.semantickitti.reader_ms",
         "taseg_tpu_torch.models.voxel.minkunet_mm", "taseg_tpu_torch.data.voxel_mm",
         "taseg_tpu_torch.data.semantickitti.reader_mm", "taseg_tpu_torch.data.semantickitti.tiaf",
         "taseg_tpu_torch.utils.param_groups", "taseg_tpu_torch.ops.knn",
         "taseg_tpu_torch.models.range2d.salsanext", "taseg_tpu_torch.models.range2d.resnet_range",
         "taseg_tpu_torch.models.range2d.rangenet", "taseg_tpu_torch.models.range2d.postproc",
         "taseg_tpu_torch.data.range_dataset", "taseg_tpu_torch.loss.range",
         "taseg_tpu_torch.range_step", "taseg_tpu_torch.data.nuscenes.reader",
         "taseg_tpu_torch.data.nuscenes.reader_mm", "taseg_tpu_torch.data.nuscenes.labels",
         "taseg_tpu_torch.data.waymo.reader", "taseg_tpu_torch.ops.sparse_tensor",
         "taseg_tpu_torch.ops.bev", "taseg_tpu_torch.models.bev",
         "taseg_tpu_torch.models.voxel.backbones", "taseg_tpu_torch.loss.eqlv2",
         "taseg_tpu_torch.utils.ckpt_convert", "taseg_tpu_torch.utils.storage"}
missing = train - set(names)
for n in names:
    importlib.import_module(n)
from taseg_tpu_torch.ops.sparse_conv import conv_k, sparse_conv  # K2 at K offsets
from taseg_tpu_torch.ops.f3conv import sparse_conv_dw  # K4 at K offsets
from taseg_tpu_torch.data.voxel_dataset import MsKdVoxelPipeline, MsVoxelPipeline  # FSA, KD
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
