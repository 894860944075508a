"""The port's readers, loader, metrics, submission writers and config
against the JAX package's: the same files, seeds and inputs must give
the same arrays, bytes and dicts (`taseg_tpu_torch.data` and `.utils`
are copies or ports).

Small sizes: synthetic scans of 2 000 points, voxel 0.2 m, 4 096-row
shards; a SemanticKITTI tree of 3 000-point scans written to a tmp dir
the way `tests/test_data_kitti.py` writes one.  Everything is compared
exactly, except the IoU values (within 1e-12).
"""

import numpy as np
import pytest

from taseg_tpu import data as jdata
from taseg_tpu.data import augment as jaug
from taseg_tpu.data import synthetic as jsyn
from taseg_tpu.data.semantickitti import labels as jlab
from taseg_tpu.data.semantickitti import laserscan as jls
from taseg_tpu.data.semantickitti import reader as jrd
from taseg_tpu.utils import config as jcfg
from taseg_tpu.utils import metrics as jmet
from taseg_tpu.utils import submission as jsub
from taseg_tpu_torch import data as tdata
from taseg_tpu_torch.data import augment as taug
from taseg_tpu_torch.data import synthetic as tsyn
from taseg_tpu_torch.data.semantickitti import labels as tlab
from taseg_tpu_torch.data.semantickitti import laserscan as tls
from taseg_tpu_torch.data.semantickitti import reader as trd
from taseg_tpu_torch.utils import config as tcfg
from taseg_tpu_torch.utils import metrics as tmet
from taseg_tpu_torch.utils import storage as tst
from taseg_tpu_torch.utils import submission as tsub

DATA = {
    "DATASET": "synthetic", "LENGTH": 5, "N_RAW_POINTS": 2000,
    "VOXEL_SIZE": 0.2, "NUM_POINTS": 2048,
}
ARRAY_KEYS = ("point_coords", "point_feats", "labels", "num_points")
N_FRAMES, N_POINTS = 4, 3000


def _equal_dicts(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


# ------------------------------------------------------------------ readers
@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_reader_equal(seed):
    j = jsyn.SyntheticKittiReader(length=3, n_points=2000, seed=seed)
    t = tsyn.SyntheticKittiReader(length=3, n_points=2000, seed=seed)
    assert len(j) == len(t) == 3
    for i in range(3):
        _equal_dicts(j[i], t[i])


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """SemanticKITTI and ScribbleKITTI trees of sequences 00 and 08."""
    base = tmp_path_factory.mktemp("kitti")
    rng = np.random.default_rng(0)
    for tree, sub in (("SemanticKITTI", "labels"), ("ScribbleKITTI", "scribbles")):
        for seq in ("00", "08"):
            d = base / tree / "sequences" / seq
            (d / sub).mkdir(parents=True)
            if tree == "SemanticKITTI":
                (d / "velodyne").mkdir()
            for t in range(N_FRAMES):
                if tree == "SemanticKITTI":
                    pts = rng.uniform(-20, 20, (N_POINTS, 4)).astype(np.float32)
                    pts[:, 3] = rng.uniform(0, 1, N_POINTS)
                    pts.tofile(d / "velodyne" / f"{t:06d}.bin")
                raw = rng.choice([10, 40, 48, 50, 70, 81, 30, 252], N_POINTS)
                inst = rng.integers(0, 5, N_POINTS).astype(np.uint32) << 16
                (raw.astype(np.uint32) | inst).tofile(d / sub / f"{t:06d}.label")
    return base / "SemanticKITTI" / "sequences"


@pytest.mark.parametrize(
    "augment,split,scribble",
    [
        ("GlobalAugment", "train", False),
        ("GlobalAugment_L", "train", False),
        ("GlobalAugment_P", "train", False),
        ("GlobalAugment_LP", "train", False),
        ("GlobalAugment_LP", "val", False),
        ("GlobalAugment", "train", True),
    ],
)
def test_semantickitti_reader_equal(kitti_root, augment, split, scribble):
    kw = dict(split=split, augment=augment, seed=3, if_scribble=scribble,
              samples_per_epoch=6 if split == "train" else -1)
    j = jrd.SemanticKittiReader(str(kitti_root), **kw)
    t = trd.SemanticKittiReader(str(kitti_root), **kw)
    assert len(j) == len(t)
    for _ in range(2):  # two epochs: the resampled subset too
        np.testing.assert_array_equal(j.sample_idx, t.sample_idx)
        for i in range(len(j)):
            _equal_dicts(j[i], t[i])
        j.resample()
        t.resample()


def test_ring_ids_labels_and_projection_equal():
    pts = np.random.default_rng(5).uniform(-30, 30, (5000, 4)).astype(np.float32)
    np.testing.assert_array_equal(jrd.ring_ids_from_yaw(pts), trd.ring_ids_from_yaw(pts))
    for name in ("LEARNING_MAP_LUT", "LEARNING_MAP_MS_LUT", "INV_LUT"):
        np.testing.assert_array_equal(getattr(jlab, name), getattr(tlab, name))
    assert jlab.CLASS_NAMES == tlab.CLASS_NAMES
    raw = np.random.default_rng(6).integers(0, 2**20, 4000).astype(np.uint32)
    for ms in (False, True):
        np.testing.assert_array_equal(jlab.remap_labels(raw, ms), tlab.remap_labels(raw, ms))
    train = np.random.default_rng(7).integers(0, 20, 4000)
    np.testing.assert_array_equal(jlab.train_to_raw(train), tlab.train_to_raw(train))
    a = jls.project_scan(pts[:, :3], pts[:, 3], h=32, w=256)
    b = tls.project_scan(pts[:, :3], pts[:, 3], h=32, w=256)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_tta_votes_and_mixes_equal():
    for v in range(10):
        a = jaug.AugParams.tta_vote(v, rng=np.random.default_rng(v))
        b = taug.AugParams.tta_vote(v, rng=np.random.default_rng(v))
        assert (a.theta, a.scale, a.flip_type) == (b.theta, b.scale, b.flip_type)
    rng = np.random.default_rng(8)
    pa, pb = rng.uniform(-20, 20, (3000, 4)), rng.uniform(-20, 20, (2500, 4))
    la, lb = rng.integers(0, 20, 3000), rng.integers(0, 20, 2500)
    for seed in range(4):
        x = jaug.lasermix(pa, la, pb, lb, rng=np.random.default_rng(seed), return_strategy=True)
        y = taug.lasermix(pa, la, pb, lb, rng=np.random.default_rng(seed), return_strategy=True)
        for u, w in zip(x, y):
            np.testing.assert_array_equal(u, w)
        kw = dict(alpha=-1.0, beta=2.1, instance_classes=[1, 2, 3], omega=[0.5, 2.5],
                  return_flags=True)
        x = jaug.polarmix(pa, la, pb, lb, rng=np.random.default_rng(seed), **kw)
        y = taug.polarmix(pa, la, pb, lb, rng=np.random.default_rng(seed), **kw)
        for u, w in zip(x, y):
            np.testing.assert_array_equal(u, w)


def test_build_reader_raises_for_ports_still_to_come(tmp_path):
    """Every dataset of the JAX package has its reader (nuScenes and Waymo
    since their slice, over trees of `torch_nuscenes_fixture`); a dataset
    neither package reads raises."""
    from torch_nuscenes_fixture import make_nuscenes_root, make_waymo_root

    with pytest.raises(NotImplementedError, match="dataset 'kitti360'"):
        tdata.build_reader({**DATA, "DATASET": "kitti360"}, True)
    nus = make_nuscenes_root(tmp_path / "nus", n_key=2, splits=("train",))
    waymo = make_waymo_root(tmp_path / "waymo", n_first=100, n_second=10)
    for ds, root in (("nuscenes", nus), ("nuscenes_ms", nus), ("nuscenes_ms_mm", nus), ("waymo", waymo)):
        reader = tdata.build_reader({**DATA, "DATASET": ds, "DATA_PATH": str(root)}, True)
        assert len(reader) > 0 and reader[0]["xyzret"].shape[1] == 5
    # the range kind on nuScenes (CENet's recipe)
    loader = tdata.build_dataloader({**DATA, "DATASET": "nuscenes", "DATA_PATH": str(nus), "H": 16, "W": 64},
                                    training=True, scans_per_shard=1, pipeline_kind="range")
    assert len(loader) == 2


# ------------------------------------------------------------------- loader
def _loaders(training, **kw):
    j = jdata.build_dataloader(DATA, training=training, n_shards=1, scans_per_shard=2, **kw)
    t = tdata.build_dataloader(DATA, training=training, n_shards=1, scans_per_shard=2, **kw)
    return j, t


def _batches_equal(jb, tb):
    (ja, jm), (ta, tm) = jb, tb
    assert len(tm) == 1
    for k in ARRAY_KEYS:
        np.testing.assert_array_equal(ja[k][0], ta[k].reshape(ja[k][0].shape), err_msg=k)
    np.testing.assert_array_equal(jm[0]["offsets"], tm[0]["offsets"])
    assert jm[0]["padded"] == tm[0]["padded"]
    assert [s.name for s in jm[0]["samples"]] == [s.name for s in tm[0]["samples"]]
    for a, b in zip(jm[0]["samples"], tm[0]["samples"]):
        for f in ("inverse_map", "raw_labels", "labels"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_train_loader_equal_over_two_epochs():
    j, t = _loaders(True)
    assert len(j) == len(t) == 2
    assert t.point_capacity == j.point_capacity == 2 * DATA["NUM_POINTS"]
    for _ in range(2):
        jb, tb = list(j), list(t)
        assert len(jb) == len(tb) == 2
        for a, b in zip(jb, tb):
            _batches_equal(a, b)
    assert j.epoch == t.epoch == 2
    np.testing.assert_array_equal(j._epoch_order(), t._epoch_order())


def test_eval_loader_pads_the_last_batch_equal():
    j, t = _loaders(False)
    assert len(j) == len(t) == 3
    jb, tb = list(j), list(t)
    for a, b in zip(jb, tb):
        _batches_equal(a, b)
    arrays, meta = tb[-1]
    assert meta[0]["padded"] == [False, True]
    pad = meta[0]["samples"][1]
    assert not pad.labels.any() and not pad.raw_labels.any()
    lo, hi = meta[0]["offsets"][1:3]
    assert not arrays["labels"][lo:hi].any()
    assert arrays["labels"][: meta[0]["offsets"][1]].any()


@pytest.mark.parametrize("training", [True, False])
def test_process_slices_equal(training):
    for idx in (0, 1):
        j, t = _loaders(training, process_index=idx, process_count=2)
        assert len(j) == len(t)
        for g in (np.array([4, 1, 3, 0]), np.array([2]), np.array([], int)):
            assert j._local_slice(g) == t._local_slice(g)
        for a, b in zip(list(j), list(t)):
            _batches_equal(a, b)


def test_tta_batches_equal():
    j, t = _loaders(False)
    jv, tv = list(j.iter_tta(3)), list(t.iter_tta(3))
    assert len(jv) == len(tv) == 3
    for a, b in zip(jv, tv):
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            _batches_equal(x, y)
    assert t.fixed_aug is None and t.pipeline.training is False


@pytest.mark.parametrize("training", [True, False])
def test_fusion_loader_equal(training):
    """The `fusion` kind (RPVNet): the voxel arrays, the (B, H, W, 6)
    range images and the per-scan offset pixel coordinates of every
    batch equal JAX's (`collate_fusion_batch`), augmented and padded
    batches included."""
    data = {**DATA, "H": 16, "W": 64}
    j = jdata.build_dataloader(data, training=training, n_shards=1, scans_per_shard=2,
                               pipeline_kind="fusion")
    t = tdata.build_dataloader(data, training=training, n_shards=1, scans_per_shard=2,
                               pipeline_kind="fusion")
    assert type(t.pipeline).__name__ == "FusionPipeline"
    jb, tb = list(j), list(t)
    assert len(jb) == len(tb) == (2 if training else 3)
    for a, b in zip(jb, tb):
        _batches_equal(a, b)
        for k in ("range_image", "range_pxpy"):
            np.testing.assert_array_equal(a[0][k][0], b[0][k], err_msg=k)
    assert tb[0][0]["range_image"].shape == (2, 16, 64, 6)


def test_reader_error_reaches_the_consumer():
    class Broken(tsyn.SyntheticKittiReader):
        def __getitem__(self, index):
            if index == 3:
                raise ValueError("scan 3 is corrupt")
            return super().__getitem__(index)

    t = tdata.build_dataloader(DATA, training=False, scans_per_shard=1)
    t.reader = Broken(length=5, n_points=2000, seed=1)
    got = []
    with pytest.raises(ValueError, match="scan 3 is corrupt"):
        for arrays, meta in t:
            got.append(meta[0]["samples"][0].name)
    assert len(got) == 3


def test_loader_takes_one_shard_per_process():
    # several cards run one process each, with its process_index
    with pytest.raises(ValueError, match="process_index"):
        tdata.build_dataloader(DATA, training=True, n_shards=2, scans_per_shard=1)


# ------------------------------------------------------------------ metrics
def test_confusion_hist_and_iou_equal():
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(9)
    label = rng.integers(-1, 22, 5000).astype(np.int32)
    pred = rng.integers(-2, 23, 5000).astype(np.int32)
    valid = rng.random(5000) < 0.8
    want = np.asarray(jmet.confusion_hist(jnp.asarray(pred), jnp.asarray(label), jnp.asarray(valid), 20))
    got = tmet.confusion_hist(torch.from_numpy(pred), torch.from_numpy(label), torch.from_numpy(valid), 20)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(tmet.per_class_iou(want), jmet.per_class_iou(want), rtol=0, atol=1e-12)
    assert abs(tmet.miou_from_hist(want) - jmet.miou_from_hist(want)) <= 1e-12
    names = [f"c{i}" for i in range(20)]
    assert tmet.format_confusion(want, names) == jmet.format_confusion(want, names)


# --------------------------------------------------------------- submission
def test_submission_files_equal(tmp_path):
    rng = np.random.default_rng(10)
    pred = rng.integers(0, 20, 3000)
    logits = rng.normal(size=(3000, 20)).astype(np.float32)
    scan = "/data/sequences/08/velodyne/000123.bin"
    for mod, d in ((jsub, tmp_path / "j"), (tsub, tmp_path / "t")):
        mod.save_predictions(d, scan, pred)
        mod.save_predictions(d / "train", scan, pred, raw_ids=False)
        mod.save_logits(d, scan, logits)
    rel = [
        "sequences/08/predictions/000123.label",
        "train/sequences/08/predictions/000123.label",
        "sequences/08/predictions/000123.bin",
    ]
    for r in rel:
        assert (tmp_path / "t" / r).read_bytes() == (tmp_path / "j" / r).read_bytes(), r
    for direction in ("raw_to_train", "train_to_raw"):
        nj = jsub.remap_label_files(tmp_path / "j", direction=direction)
        nt = tsub.remap_label_files(tmp_path / "t", direction=direction)
        assert nj == nt == 1
        assert (tmp_path / "t" / rel[0]).read_bytes() == (tmp_path / "j" / rel[0]).read_bytes()


def test_storage_and_checkpoint_listing(tmp_path):
    arr = np.arange(10, dtype=np.float32)
    tst.save_bin(tmp_path / "a" / "x.bin", arr)
    np.testing.assert_array_equal(tst.load_bin(tmp_path / "a" / "x.bin"), arr)
    tst.save_bytes(tmp_path / "b.txt", b"hi")
    assert tst.load_bytes(tmp_path / "b.txt") == b"hi" and tst.exists(tmp_path / "b.txt")
    assert tst.listdir(tmp_path) == ["a", "b.txt"]
    io = tst.CheckpointIO()
    for e in (10, 2, 1):
        io.save(tmp_path / "ck" / f"checkpoint_epoch_{e}", {"epoch": e})
    (tmp_path / "ck" / "checkpoint_epoch_x").write_text("")
    found = io.list_epochs(tmp_path / "ck")
    assert [e for e, _ in found] == [1, 2, 10]
    assert io.restore(found[-1][1]) == {"epoch": 10}
    io.remove(found[0][1])
    assert [e for e, _ in io.list_epochs(tmp_path / "ck")] == [2, 10]
    tst.remove(tmp_path / "a")
    assert not tst.exists(tmp_path / "a")
    # s3:// paths go to the Petrel backend, which needs petrel_client
    # (test_torch_storage.py holds it against a stand-in client)
    with pytest.raises(ImportError, match="petrel"):
        tst.load_bin("s3://bucket/x.bin")


# ------------------------------------------------------------------- config
OVERRIDES = [
    "OPTIM.NUM_EPOCHS", "3", "OPTIM.LR_PER_SAMPLE", "0.5", "MODEL.cr", "1",
    "MODEL.NUM_LAYER", "[2, 2, 2, 2, 2, 2, 2, 2]", "DATA.DATASET", "semantickitti",
    "DATA.NEW.SUB", "7", "DATA.PATH", "/x/y", "MODEL.LOSS_CONFIG.LOSS_WEIGHTS", "[1.0, 0.5]",
]


def test_apply_overrides_equal():
    from taseg_tpu_torch.configs import MINKUNET_TINY

    j = jcfg.apply_overrides(jcfg.Config.wrap(MINKUNET_TINY), list(OVERRIDES))
    t = tcfg.apply_overrides(tcfg.Config.wrap(MINKUNET_TINY), list(OVERRIDES))
    assert t == j
    assert t.OPTIM.NUM_EPOCHS == 3 and t.MODEL.cr == 1.0 and t.DATA.NEW.SUB == 7
    assert isinstance(t.MODEL.cr, float)


def test_load_config_from_the_registry():
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    rel = "tools/cfgs/voxel/synthetic/minkunet_tiny.yaml"
    t = tcfg.load_config(rel)
    j = jcfg.load_config(repo / rel)
    assert t.TAG == j.TAG == "minkunet_tiny"
    assert tcfg.load_config(repo / rel) == t
    for sec in ("DATA", "MODEL", "OPTIM"):
        for k, v in t[sec].items():
            if k != "CAPACITY_SCHEDULE":
                assert j[sec][k] == v, (sec, k)
    t.OPTIM.NUM_EPOCHS = 99  # a copy: the registry stays as it is
    assert tcfg.load_config(rel).OPTIM.NUM_EPOCHS == 1
    with pytest.raises(KeyError, match="minkunet_tiny"):
        tcfg.load_config("tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr20.yaml")
