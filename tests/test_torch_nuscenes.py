"""nuScenes in the port against the JAX package, on a tiny tree written by
`torch_nuscenes_fixture.py` (4 keyframes of 1000 uniform points, 4 sweeps
of 800 between each pair, six cameras a keyframe with 48 x 64 JPEGs
written by Pillow, pseudo labels for every cloud).

Host side, array-equal: the quaternion helper and the ego-chain
transform, `NuscenesReader` (val, and train resampled from its
generator), `NuscenesMsReader` (the distance-based sweep selection, the
fused cloud and its labels, with and without the pseudo-label flexible
steps), `NuscenesTiafReader` (the six cameras' `fov_mask`, `fov_rowcol`,
images and 2D targets, train with its jitter drawn from `img_rng`, a
keyframe window of 3), and the submission files byte-equal.
`build_reader` / `build_dataloader` route the three datasets to their
pipelines, `check_ported` takes the three recipes, CENet's nuScenes
recipe builds its loader.

Model: a tiny MinkUNet (cr 0.125, one block per stage, 17 classes, random
BN statistics so the logits are O(1)) through reader, pipeline and
`Segmenter`, f32 on the CPU, its logits within rtol = atol = 1e-3 of
JAX's (the MinkUNet slice's tolerance), JAX's forward jitted once;
MinkUNetMsMmNus built from its recipe at a tiny width with the parameter
tree of JAX's `init` (traced only: `jax.eval_shape`); IF_DIST on one
device without a process group: the step bit-equal to the same step
without it; `evaluate_points` writing the lidarseg files of
`Segmenter.predict` (FSA: the keyframe's points); the CLI on the
single-sweep recipe (one epoch, then `--eval --save_path`).  About 40 s on one worker (`--durations`),
most of it JAX compiling the forward (~10 s), tracing TIAF's init (~8 s)
and the CLI's two processes (~15 s).
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taseg_tpu.data.nuscenes import reader as jrd
from taseg_tpu.data.nuscenes import reader_mm as jmm
from taseg_tpu.data.voxel_dataset import VoxelPipeline as JPipeline
from taseg_tpu.data.voxel_dataset import collate_shard as j_collate
from taseg_tpu.data.voxel_mm import MsMmVoxelPipeline as JMmPipeline
from taseg_tpu.data.voxel_mm import collate_mm_batch as j_collate_mm
from taseg_tpu.models import MinkUNet as JMinkUNet
from taseg_tpu.models import UNetCapacities as JCaps
from taseg_tpu.models import build_unet_topology as j_topology
from taseg_tpu.models.voxel.minkunet_mm import MinkUNetMsMmNus as JNus
from taseg_tpu.ops import PointSet
from taseg_tpu.parallel import Batch
from taseg_tpu.parallel.tiaf import TiafBatch, _unpack
from taseg_tpu.utils import submission as jsub
from taseg_tpu_torch import data as tdata
from taseg_tpu_torch.configs import RECIPES
from taseg_tpu_torch.data.nuscenes import reader as trd
from taseg_tpu_torch.data.nuscenes import reader_mm as tmm
from taseg_tpu_torch.data.range_dataset import RangeViewPipeline
from taseg_tpu_torch.data.voxel_dataset import MsVoxelPipeline, VoxelPipeline
from taseg_tpu_torch.data.voxel_mm import MsMmVoxelPipeline
from taseg_tpu_torch.engine import Segmenter, Trainer
from taseg_tpu_torch.models import MinkUNetMsMmNus, build_segmentor
from taseg_tpu_torch.train import check_ported
from taseg_tpu_torch.utils import submission as tsub
from taseg_tpu_torch.utils.params_from_jax import init_params_numpy
from torch_nuscenes_fixture import make_nuscenes_root

REPO = Path(__file__).resolve().parents[1]
NUS = "tools/cfgs/voxel/nuscenes/"
FLEX = [0, 1, 1, 1, 3, 1, 1, 3, 1, 3, 3, 0, 1, 1, 1, 1, 1]  # the recipes' flexible steps
CAP = 8192
TINY = {"cr": 0.125, "NUM_LAYER": [1] * 8, "CAPACITY_SCHEDULE": (1.0,) * 5,
        "TRAIN_CAPACITY_SCHEDULE": (1.0,) * 5}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's thread team per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nusc(tmp_path_factory):
    return make_nuscenes_root(tmp_path_factory.mktemp("nusc"), splits=("train", "val"), pseudo=True)


def tiny_cfg(path: str, root, **model) -> dict:
    cfg = RECIPES[path]
    return {
        **cfg, "DATA": {**cfg["DATA"], "DATA_PATH": str(root), "VOXEL_SIZE": 0.5},
        "MODEL": {**cfg["MODEL"], **TINY, **model},
    }


def assert_dicts_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


# ------------------------------------------------------------ host side


def test_quaternion_and_transform_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=4)
    np.testing.assert_array_equal(trd.quaternion_matrix(q), jrd.quaternion_matrix(q))
    infos = [
        {"lidar2ego_rotation": rng.normal(size=4), "lidar2ego_translation": rng.normal(size=3),
         "ego2global_rotation": rng.normal(size=4), "ego2global_translation": rng.normal(size=3)}
        for _ in range(2)
    ]
    for a, b in zip(trd.transform_between(*infos), jrd.transform_between(*infos)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("split,per_epoch", [("val", -1), ("train", 6)])
def test_reader_matches_jax(nusc, split, per_epoch):
    kw = dict(split=split, samples_per_epoch=per_epoch, seed=2)
    j, t = jrd.NuscenesReader(str(nusc), **kw), trd.NuscenesReader(str(nusc), **kw)
    for _ in range(2):
        assert len(j) == len(t) == (per_epoch if per_epoch > 0 else 4)
        for i in range(len(t)):
            a, b = j[i], t[i]
            assert_dicts_equal(a, b)
            assert b["labels"].max() <= 16 and b["token"].startswith("key_")
        j.resample(), t.resample()


@pytest.mark.parametrize("pseudo", [False, True])
def test_ms_reader_matches_jax(nusc, pseudo):
    kw = dict(split="val", multiscan=3, step=1.0, flexible_steps=FLEX,
              pseudo_label_root=str(nusc / "pseudo") if pseudo else None)
    j, t = jrd.NuscenesMsReader(str(nusc), **kw), trd.NuscenesMsReader(str(nusc), **kw)
    for i in range(len(t)):
        assert t._select_sweeps(i) == j._select_sweeps(i)
        a, b = j[i], t[i]
        assert_dicts_equal(a, b)
        n = len(b["xyzret"])
        assert (b["xyzret_ms"][:n, 4] == 0).all()
    assert len(b["xyzret_ms"]) > len(b["xyzret"]) and (b["xyzret_ms"][n:, 4] > 0).all()
    assert t._sample_list_cache.keys() == j._sample_list_cache.keys()


@pytest.mark.parametrize("split,window", [("val", 0), ("train", 2)])
def test_tiaf_reader_matches_jax(nusc, split, window):
    """The six cameras of the keyframe (and, with a window, of the
    keyframes 1 and 2 back), projected at 48 x 64; train draws each
    image's jitter from `img_rng` in JAX's order."""
    kw = dict(split=split, multiscan=3, step=0.5, image_height=48, image_width=64,
              multiscan_image=window, step_image=1)
    j, t = jmm.NuscenesTiafReader(str(nusc), **kw), tmm.NuscenesTiafReader(str(nusc), **kw)
    n_img = []
    for i in range(len(t)):
        a, b = j[i], t[i]
        assert_dicts_equal(a, b)
        n_img.append(b["images"].shape[0])
        assert b["fov_rowcol"].shape == (int(b["fov_mask"].sum()), 2)
    assert max(n_img) == 6 * (window + 1) and b["fov_mask"].sum() > 0
    assert b["fov_rowcol"][:, 0].max() >= 48  # rows offset by image slot
    np.testing.assert_array_equal(j.img_rng.random(3), t.img_rng.random(3))
    assert tmm.CAMERAS == jmm.CAMERAS


def test_projection_and_missing_cameras_match_jax(nusc, tmp_path):
    """`project_to_camera` with a quaternion extrinsic; a camera whose
    record or file is missing is skipped, and with none a blank image
    stands in."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(-20, 20, (500, 3))
    cam = {"sensor2lidar_rotation": [0.5, -0.5, 0.5, -0.5], "sensor2lidar_translation": [0.1, 0, 0.2],
           "cam_intrinsic": np.array([[30.0, 0, 32], [0, 30.0, 24], [0, 0, 1]])}
    for a, b in zip(jmm.project_to_camera(pts, cam, 48, 64, 0.5, 0.5),
                    tmm.project_to_camera(pts, cam, 48, 64, 0.5, 0.5)):
        np.testing.assert_array_equal(a, b)
    (nusc / "samples" / "CAM_BACK" / "0003.jpg").rename(tmp_path / "moved.jpg")
    try:
        kw = dict(split="val", multiscan=2, image_height=48, image_width=64)
        j, t = jmm.NuscenesTiafReader(str(nusc), **kw), tmm.NuscenesTiafReader(str(nusc), **kw)
        for r in (j, t):
            for info in r.infos[:1]:
                info["cams"] = {}
        assert_dicts_equal(j[3], t[3])
        assert t[3]["images"].shape[0] == 5
        assert_dicts_equal(j[0], t[0])
        assert t[0]["images"].shape == (1, 48, 64, 3) and not t[0]["images"].any()
    finally:
        (tmp_path / "moved.jpg").rename(nusc / "samples" / "CAM_BACK" / "0003.jpg")


def test_submission_files_byte_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    for i, preds in enumerate((rng.integers(0, 17, 1000), np.zeros(50, np.int64))):
        a = jsub.save_nuscenes_predictions(tmp_path / "j", f"tok{i}", preds)
        b = tsub.save_nuscenes_predictions(tmp_path / "t", f"tok{i}", preds)
        assert a.relative_to(tmp_path / "j") == b.relative_to(tmp_path / "t")
        assert a.read_bytes() == b.read_bytes()
        np.testing.assert_array_equal(tsub.read_nuscenes_predictions(tmp_path / "t", f"tok{i}"),
                                      jsub.read_nuscenes_predictions(tmp_path / "j", f"tok{i}"))
    assert not (tsub.read_nuscenes_predictions(tmp_path / "t", "tok0") == 0).any()
    assert set(tsub.read_nuscenes_predictions(tmp_path / "t", "tok1")) == {1}
    a, b = jsub.write_nuscenes_submission_json(tmp_path / "j"), tsub.write_nuscenes_submission_json(tmp_path / "t")
    assert a.read_bytes() == b.read_bytes()
    assert json.loads(b.read_text())["meta"] == tsub.NUSCENES_SUBMISSION_META


def test_datasets_route_to_their_pipelines(nusc):
    """`build_dataloader` takes the multi-scan pipeline for `nuscenes_ms`
    (the `_ms` suffix) and the mm one for `nuscenes_ms_mm`; the three
    recipes and CENet's are ported, and CENet's loader reads the tree."""
    for name, reader, pipe in (
        ("minkunet_mk34_cr10", trd.NuscenesReader, VoxelPipeline),
        ("minkunet_mk34_cr10_fsa", trd.NuscenesMsReader, MsVoxelPipeline),
        ("minkunet_mk34_cr10_fsa_tiaf", tmm.NuscenesTiafReader, MsMmVoxelPipeline),
    ):
        cfg = tiny_cfg(NUS + name + ".yaml", nusc)
        assert check_ported(cfg) == "voxel"
        loader = tdata.build_dataloader(cfg["DATA"], training=False, scans_per_shard=1)
        assert type(loader.reader) is reader and type(loader.pipeline) is pipe
    cenet = RECIPES["tools/cfgs/range/nuscenes/cenet_res34.yaml"]
    assert check_ported(cenet) == "range"
    data = {**cenet["DATA"], "DATA_PATH": str(nusc), "H": 16, "W": 128}
    loader = tdata.build_dataloader(data, training=True, scans_per_shard=1, modality="range")
    assert isinstance(loader.pipeline, RangeViewPipeline) and len(loader) == 4
    arrays, meta = next(iter(loader))
    assert arrays["scan"].shape[:3] == (1, 16, 128)


# ---------------------------------------------------------------- model


def _variables(cfg, seed=4):
    p, s = init_params_numpy(cfg, seed=seed)
    rng = np.random.default_rng(seed + 100)

    def bn(tree, kind):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = bn(v, kind)
                continue
            v = np.array(v, np.float32)
            if kind == "stats":
                v = rng.uniform(0.05, 0.15, v.shape) if k == "var" else rng.normal(0, 0.05, v.shape)
            elif k == "scale":
                v = rng.uniform(0.8, 1.2, v.shape)
            elif k == "bias" and v.shape[0] != 17:  # BN bias, not the head
                v = rng.normal(0, 0.1, v.shape)
            out[k] = v.astype(np.float32)
        return out

    return {"params": bn(p, "params"), "batch_stats": bn(s, "stats")}


def test_tiny_minkunet_logits_match_jax(nusc):
    """Reader -> pipeline -> model: `Segmenter.predict` on two keyframes
    against JAX's MinkUNet on JAX's pipeline and collate."""
    cfg = tiny_cfg(NUS + "minkunet_mk34_cr10.yaml", nusc)
    variables = _variables(cfg)
    reader = trd.NuscenesReader(str(nusc), split="val")
    scans = [reader[i] for i in (1, 3)]
    samples = [JPipeline(0.5, training=False, in_feature_dim=4)(s) for s in scans]
    arrays = j_collate(samples, CAP)
    model = JMinkUNet(num_classes=17, in_dim=4, cr=0.125, num_layer=(1,) * 8, block="ResBlock",
                      dropout_p=0.0, compute_dtype="float32")
    caps = JCaps.for_points(CAP, schedule=(1.0,) * 5)

    @jax.jit
    def fwd(variables, coords, feats, num):
        topo = j_topology(coords, num, caps)
        return model.apply(variables, PointSet(coords=coords, feats=feats, num=num), topo, False)

    want = np.asarray(fwd(variables, jnp.asarray(arrays["point_coords"]), jnp.asarray(arrays["point_feats"]),
                          jnp.asarray(arrays["num_points"][0])))
    seg = Segmenter(cfg, variables, device="cpu", point_capacity=CAP, batch_size=2)
    assert seg.model.stem_0.SparseConv_0.kernel.shape == (27, 4, 4)
    out = seg.predict(scans)
    for b, (s, o) in enumerate(zip(scans, out)):
        rows = want[arrays["offsets"][b]: arrays["offsets"][b + 1]]
        w = rows[samples[b].inverse_map]
        assert o["logits"].shape == (len(s["xyzret"]), 17) == w.shape
        np.testing.assert_allclose(o["logits"], w, rtol=1e-3, atol=1e-3)
    assert np.abs(want).max() > 0.5  # O(1) logits


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{pre}{k}/") if isinstance(v, dict) else {pre + k: v})
    return out


def test_tiaf_nus_builds_jax_tree(nusc):
    """MinkUNetMsMmNus from its recipe (4 input features: the FOV branch
    reads 3 + 2 IMAGE_BASE + 17 channels) at cr / FOV_CR 0.125 and
    IMAGE_BASE 8: `init_params_numpy` draws the names and shapes of the
    tree JAX's `init` makes on a shard of the nuScenes TIAF reader."""
    cfg = tiny_cfg(NUS + "minkunet_mk34_cr10_fsa_tiaf.yaml", nusc, FOV_CR=0.125, IMAGE_BASE=8)
    m = build_segmentor(cfg, device="cpu")
    assert type(m) is MinkUNetMsMmNus and m.lidar_backbone.stem.SparseConv_0.kernel.shape == (27, 3 + 16 + 17, 4)
    with pytest.raises(ValueError, match="float32"):
        build_segmentor(cfg, device="cpu", compute_dtype="bfloat16")
    reader = tmm.NuscenesTiafReader(str(nusc), split="val", multiscan=2, image_height=48, image_width=64)
    samples = [JMmPipeline(0.5, training=False, in_feature_dim=5)(reader[3])]
    ja, _ = j_collate_mm([samples], CAP, CAP // 2)

    def batch(d):
        return Batch(**{k: jnp.asarray(d[k]) for k in ("point_coords", "point_feats", "labels", "num_points")})

    tb = TiafBatch(main=batch(ja["main"]), fov=batch(ja["fov"]), fov_rowcol=jnp.asarray(ja["fov_rowcol"]),
                   images=jnp.asarray(ja["images"]), image_labels=jnp.asarray(ja["image_labels"]))
    model = JNus(num_classes=17, in_dim=4, cr=0.125, fov_cr=0.125, image_base=8)

    def init(tb):
        main, topo, fov, fov_topo, fov_devox = _unpack(tb, JCaps.for_points(CAP), JCaps.for_points(CAP // 2))
        return model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, main, topo,
                          fov, fov_topo, fov_devox, tb.images[0], tb.fov_rowcol[0], False)

    shapes = jax.eval_shape(init, tb)
    p, s = init_params_numpy(cfg, seed=0)
    for mine, theirs in ((p, shapes["params"]), (s, shapes["batch_stats"])):
        mine, theirs = _flat(mine), _flat(theirs)
        assert mine.keys() == theirs.keys()
        for k in mine:
            assert mine[k].shape == theirs[k].shape, k


def test_if_dist_on_one_device_is_the_plain_step(nusc):
    """IF_DIST (every nuScenes and Waymo recipe) on one device without a
    process group: the step equals the same step without it, bit for bit
    (JAX's one-device step reduces its BN statistics over one device)."""
    cfg = tiny_cfg(NUS + "minkunet_mk34_cr10.yaml", nusc)
    scans = [trd.NuscenesReader(str(nusc), split="train")[3]]
    outs = []
    for dist in (True, False):
        c = {**cfg, "MODEL": {**cfg["MODEL"], "IF_DIST": dist}}
        tr = Trainer(c, _variables(c), device="cpu", iters_per_epoch=2, total_epochs=1, batch_size=1,
                     point_capacity=CAP, seed=0)
        outs.append([tr.step(scans) for _ in range(2)] + [dict(tr.model.named_parameters())])
    for a, b in zip(outs[0][:2], outs[1][:2]):
        assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
    for k, v in outs[0][2].items():
        assert torch.equal(v, outs[1][2][k]), k


def test_evaluate_points_writes_lidarseg_files(nusc, tmp_path):
    """FSA's `evaluate_points(save_path=...)`: one uint8 `lidarseg/test/
    <token>_lidarseg.bin` per keyframe, of its own points only, equal to
    `Segmenter.predict`'s labels (a 0 refilled as the benchmark needs),
    and `submission.json`."""
    cfg = tiny_cfg(NUS + "minkunet_mk34_cr10_fsa.yaml", nusc)
    val = tdata.build_dataloader(cfg["DATA"], training=False, scans_per_shard=1, point_capacity=CAP)
    variables = _variables(cfg)
    tr = Trainer(cfg, variables, device="cpu", iters_per_epoch=1, total_epochs=1, batch_size=1,
                 point_capacity=CAP, val_loader=val, output_dir=tmp_path)
    tr.evaluate_points(save_path=tmp_path / "preds")
    seg = Segmenter(cfg, variables, device="cpu", point_capacity=CAP)
    for i in range(len(val.reader)):
        s = val.reader[i]
        (o,) = seg.predict([s])
        got = tsub.read_nuscenes_predictions(tmp_path / "preds", s["token"])
        assert len(got) == len(s["xyzret"]) < len(s["xyzret_ms"]) or i == 0  # 0: no history
        want = o["labels"].astype(np.uint8)
        np.testing.assert_array_equal(got[want != 0], want[want != 0])
        assert not (got == 0).any()
    meta = json.loads((tmp_path / "preds" / "submission.json").read_text())["meta"]
    assert meta == tsub.NUSCENES_SUBMISSION_META


def test_cli_trains_and_writes_the_submission(nusc, tmp_path):
    """`python -m taseg_tpu_torch.train` on the single-sweep recipe, cut
    to a tiny width with `--set`: one epoch, then `--eval --save_path`
    writes the four keyframes' lidarseg files and `submission.json`."""
    sets = [
        "DATA.DATA_PATH", str(nusc), "DATA.VOXEL_SIZE", "0.5", "DATA.NUM_POINTS", str(CAP),
        "MODEL.cr", "0.125", "MODEL.NUM_LAYER", "[1, 1, 1, 1, 1, 1, 1, 1]",
        "MODEL.CAPACITY_SCHEDULE", "(1.0, 1.0, 1.0, 1.0, 1.0)",
        "MODEL.TRAIN_CAPACITY_SCHEDULE", "(1.0, 1.0, 1.0, 1.0, 1.0)", "OPTIM.NUM_EPOCHS", "1",
    ]
    cmd = [sys.executable, "-m", "taseg_tpu_torch.train", "--cfg_file", NUS + "minkunet_mk34_cr10.yaml",
           "--device", "cpu", "--batch_size", "1"]
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
    r = subprocess.run(cmd + ["--set", *sets], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                       env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    log = (tmp_path / "output/minkunet_mk34_cr10/default/log.txt").read_text()
    assert "epoch 0 mean loss" in log and "saved checkpoint" in log
    r = subprocess.run(cmd + ["--eval", "--save_path", "preds", "--set", *sets], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    files = sorted((tmp_path / "preds" / "lidarseg" / "test").glob("*_lidarseg.bin"))
    assert [f.name for f in files] == [f"key_{k}_lidarseg.bin" for k in range(4)]
    reader = trd.NuscenesReader(str(nusc), split="val")
    for f, k in zip(files, range(4)):
        got = np.fromfile(f, np.uint8)
        assert len(got) == len(reader[k]["xyzret"]) and got.min() >= 1 and got.max() <= 16
    assert json.loads((tmp_path / "preds" / "submission.json").read_text())["meta"]["use_lidar"]
