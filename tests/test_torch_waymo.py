"""Waymo in the port against the JAX package, on tiny trees written by
`torch_nuscenes_fixture.make_waymo_root` (first and second returns of
[range, intensity, elongation, x, y, z, label] rows, the split lists).

Host side, array-equal: `WaymoReader` over the split lists (train, val,
train_val, resampled train) and over the directory glob without them,
the test split's zero labels.  The recipes: `check_ported` and the
loaders' pipelines (RPVNet's `fusion`, Cylinder_TS's `cylinder`), the
single-frame voxel pipelines keeping 4 of the reader's 5 columns, as
JAX's loader does, so the models' stems are 4 wide, as JAX's `init`
makes them from that batch, though the recipes name IN_FEATURE_DIM 5;
`evaluate_points` over the loader equal to `Segmenter.predict` (its own
pipeline at IN_FEATURE_DIM 5, the model slicing 4) bit for bit.

The Cylinder_TS repair: the Waymo recipe's IN_FEATURE_DIM is 10 while
the cylinder pipeline emits 9 columns; JAX slices `feats[:, :10]` (9
columns) and its layers take their widths from them.  JAX's `init` at
that setting (INIT_SIZE 4, 23 classes, a 64 x 64 x 16 grid, jitted once)
gives a 9-wide pre-net; the port builds the same tree, loads JAX's
initialised parameters and its eval logits agree with JAX's within 1e-4
of their scale (Cylinder's tolerance); a pre-net built 10 wide, as
before the repair, cannot take them.  About 30 s on one worker
(`--durations`), most of it JAX compiling init and apply (one jit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taseg_tpu.data.waymo import WaymoReader as JReader
from taseg_tpu.models import UNetCapacities as JCaps
from taseg_tpu.models.voxel.cylinder3d import CylinderTS as JCylinderTS
from taseg_tpu.models.voxel.cylinder3d import build_cylinder_topology as j_topology
from taseg_tpu.ops import PointSet
from taseg_tpu_torch import data as tdata
from taseg_tpu_torch.configs import RECIPES
from taseg_tpu_torch.data.cylinder_dataset import CylinderPipeline
from taseg_tpu_torch.data.fusion_dataset import FusionPipeline
from taseg_tpu_torch.data.voxel_dataset import VoxelPipeline
from taseg_tpu_torch.data.waymo import WaymoReader as TReader
from taseg_tpu_torch.engine import Segmenter, Trainer
from taseg_tpu_torch.models import CylinderTS, build_segmentor
from taseg_tpu_torch.models.voxel import cylinder3d
from taseg_tpu_torch.train import check_ported
from taseg_tpu_torch.utils.params_from_jax import init_params_numpy, load_flax_params
from torch_nuscenes_fixture import make_waymo_root

CYL = "tools/cfgs/voxel/waymo/cylinder_cy480_cr10.yaml"
CAP = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's thread team per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def waymo(tmp_path_factory):
    return make_waymo_root(tmp_path_factory.mktemp("waymo"))


def assert_dicts_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("split,per_epoch,n", [
    ("train", -1, 4), ("val", -1, 2), ("train_val", -1, 6), ("train", 5, 5), ("test", -1, 2),
])
def test_reader_matches_jax(waymo, split, per_epoch, n):
    kw = dict(split=split, samples_per_epoch=per_epoch, seed=1)
    if split == "test":  # no list: the glob of test/first (the val frames copied)
        import shutil

        if not (waymo / "test").exists():
            shutil.copytree(waymo / "val", waymo / "test")
    j, t = JReader(str(waymo), **kw), TReader(str(waymo), **kw)
    assert len(j) == len(t) == n
    for _ in range(2):
        for i in range(len(t)):
            a, b = j[i], t[i]
            assert_dicts_equal(a, b)
            assert b["xyzret"].shape == (3750, 5) and np.abs(b["xyzret"][:, 3:]).max() <= 1.0
            assert (b["labels"] == 0).all() if split == "test" else b["labels"].max() < 23
        j.resample(), t.resample()
    assert t.class_names == j.class_names and len(t.class_names) == 23


def test_reader_raises_without_frames(tmp_path):
    with pytest.raises(FileNotFoundError):
        TReader(str(tmp_path), split="val")


@pytest.mark.parametrize("name,kind,pipe", [
    ("voxel/waymo/minkunet_mk34_cr10", "voxel", VoxelPipeline),
    ("voxel/waymo/minkunet_mk18_cr10", "voxel", VoxelPipeline),
    ("fusion/waymo/spvcnn_mk18_cr10", "voxel", VoxelPipeline),
    ("fusion/waymo/rpvnet_mk18_cr10", "fusion", FusionPipeline),
    ("voxel/waymo/cylinder_cy480_cr10", "cylinder", CylinderPipeline),
])
def test_recipes_take_their_loaders(waymo, name, kind, pipe):
    """Each recipe is ported; its loader reads the tree through its
    pipeline, the voxel ones keeping 4 of the reader's 5 columns (JAX's
    loader's), and the model's stem takes 4."""
    from taseg_tpu_torch.train import pipeline_kind
    from taseg_tpu_torch.utils.config import load_config

    cfg = load_config(f"tools/cfgs/{name}.yaml")
    modality = check_ported(cfg)
    data = {**cfg["DATA"], "DATA_PATH": str(waymo), "NUM_POINTS": CAP}
    loader = tdata.build_dataloader(data, training=False, scans_per_shard=1, modality=modality,
                                    pipeline_kind=pipeline_kind(cfg) or kind)
    assert type(loader.pipeline) is pipe and len(loader) == 2
    if pipe is not CylinderPipeline:
        assert loader.reader[0]["xyzret"].shape[1] == 5
        assert loader.pipeline(loader.reader[0]).feats.shape[1] == 4
        assert build_segmentor(cfg, device="meta").in_dim == 4
    assert cfg["MODEL"]["NUM_CLASS"] == 23


def test_evaluate_points_equals_segmenter(waymo, tmp_path):
    """A tiny Waymo MinkUNet (23 classes): the loader's 4 columns give
    `evaluate_points` the labels of `Segmenter.predict` (its own pipeline
    at MODEL.IN_FEATURE_DIM 5, the model slicing 4), bit for bit."""
    cfg = RECIPES["tools/cfgs/voxel/waymo/minkunet_mk18_cr10.yaml"]
    cfg = {
        **cfg, "DATA": {**cfg["DATA"], "DATA_PATH": str(waymo), "VOXEL_SIZE": 1.0},
        "MODEL": {**cfg["MODEL"], "cr": 0.125, "NUM_LAYER": [1] * 8, "CAPACITY_SCHEDULE": (1.0,) * 5},
    }
    p, s = init_params_numpy(cfg, seed=2)
    variables = {"params": p, "batch_stats": s}
    val = tdata.build_dataloader(cfg["DATA"], training=False, scans_per_shard=1, point_capacity=CAP)
    tr = Trainer(cfg, variables, device="cpu", iters_per_epoch=1, total_epochs=1, batch_size=1,
                 point_capacity=CAP, val_loader=val, output_dir=tmp_path)
    assert tr.model.stem_0.SparseConv_0.kernel.shape[1] == 4
    tr.evaluate_points(save_path=tmp_path / "preds")
    seg = Segmenter(cfg, variables, device="cpu", point_capacity=CAP)
    from taseg_tpu_torch.data.semantickitti.labels import train_to_raw

    for i in range(2):
        (o,) = seg.predict([val.reader[i]])
        assert o["logits"].shape == (3750, 23)
        got = np.fromfile(tmp_path / "preds" / "sequences" / "val" / "predictions" / f"{i:06d}.label",
                          np.uint32)
        np.testing.assert_array_equal(got, train_to_raw(o["labels"]))


# ------------------------------------------------- the Cylinder_TS repair


def _cyl_cfg():
    cfg = RECIPES[CYL]
    return {**cfg, "DATA": {**cfg["DATA"], "GRID_SIZE": [64, 64, 16]},
            "MODEL": {**cfg["MODEL"], "INIT_SIZE": 4, "CAPACITY_SCHEDULE": None}}


@pytest.fixture(scope="module")
def jax_cylinder(waymo):
    """JAX's Cylinder_TS at the Waymo recipe's IN_FEATURE_DIM 10, its
    parameters from its own `init` on a Waymo frame, and its eval
    logits."""
    pipe = CylinderPipeline(grid=(64, 64, 16), training=False)
    scan = TReader(str(waymo), split="val")[0]
    arrays = pipe.collate([pipe(scan)], CAP)
    n = int(arrays["num_points"][0])
    points = PointSet(coords=jnp.asarray(arrays["point_coords"]), feats=jnp.asarray(arrays["point_feats"]),
                      num=jnp.int32(n))
    caps = JCaps.for_points(CAP)
    model = JCylinderTS(num_classes=23, in_dim=10, init_size=4)

    @jax.jit
    def init_apply(points):  # one compile for both
        topo = j_topology(points.coords, points.num, caps)
        v = model.init({"params": jax.random.PRNGKey(0)}, points, topo, False)
        return v, model.apply(v, points, topo, False)

    v, logits = jax.tree_util.tree_map(np.asarray, init_apply(points))
    return scan, arrays, n, v, logits


def test_cylinder_pre_net_takes_jax_width(jax_cylinder):
    scan, arrays, n, v, want = jax_cylinder
    assert arrays["point_feats"].shape[1] == 9
    assert v["params"]["pp_bn0"]["scale"].shape == (9,) and v["params"]["pp_fc0"]["kernel"].shape == (9, 64)
    cfg = _cyl_cfg()
    m = build_segmentor(cfg, device="cpu")
    assert isinstance(m, CylinderTS) and m.in_dim == 9 and m.pp_bn0.scale.shape == (9,)
    load_flax_params(m, v["params"], v["batch_stats"])
    seg = Segmenter(cfg, v, device="cpu", point_capacity=CAP)
    (out,) = seg.predict([scan])
    inv = arrays["samples"][0].inverse_map
    scale = np.abs(want[:n]).max()
    assert out["logits"].shape == (3750, 23)
    assert np.abs(out["logits"] - want[inv]).max() <= 1e-4 * scale


def test_cylinder_pre_net_at_the_yaml_width_cannot_load(jax_cylinder, monkeypatch):
    """The fault the repair takes away: a pre-net 10 wide (the YAML's
    IN_FEATURE_DIM taken as is) has no place for JAX's 9-wide leaves."""
    *_, v, _ = jax_cylinder
    monkeypatch.setattr(cylinder3d, "POINT_FEATURES", 10)
    m = build_segmentor(_cyl_cfg(), device="cpu")
    assert m.pp_bn0.scale.shape == (10,)
    with pytest.raises(Exception, match="shape|size"):
        load_flax_params(m, v["params"], v["batch_stats"])
