"""SMSA (static/moving switch augmentation, the 26-class multi-scan task)
in the port against the JAX package, host numpy only, array-equal:
`static2moving` and `moving2static` called directly on clouds built to
reach each of their branches (an instance elongated along x left and
right of the ego lane, one along y, one without history rows, one below
`min_points`), at p = 1 and p = 0.5 (the draws of the generator in JAX's
order); `SmsaKittiReader` over the tiny SemanticKITTI tree of
`torch_kitti_fixture.py` (train: the switches run; val: they do not);
the 26-class label map; and `build_reader` / `build_dataloader` on
`semantickitti_ms_ms` against JAX's loader.  About 5 s on one worker.
"""

import numpy as np
import pytest

from taseg_tpu.data import build_dataloader as j_build_dataloader
from taseg_tpu.data.semantickitti import smsa as jsmsa
from taseg_tpu.data.semantickitti.labels import remap_labels as j_remap
from taseg_tpu.data.semantickitti.reader_ms import SmsaKittiReader as JReader
from taseg_tpu_torch import data as tdata
from taseg_tpu_torch.configs import MINKUNET_MK34_CR10_SMSA
from taseg_tpu_torch.data.semantickitti import smsa as tsmsa
from taseg_tpu_torch.data.semantickitti.labels import remap_labels as t_remap
from taseg_tpu_torch.data.semantickitti.reader_ms import SmsaKittiReader as TReader
from taseg_tpu_torch.data.voxel_dataset import MsVoxelPipeline
from torch_kitti_fixture import N_FRAMES, make_kitti_root


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    return make_kitti_root(tmp_path_factory.mktemp("kitti"), seed=1)


def _instance(rng, n, center, extent, raw, inst, deltas):
    """n frame points of one instance and one history copy per delta."""
    pts = np.zeros((n, 4), np.float32)
    pts[:, :3] = center + rng.uniform(-0.5, 0.5, (n, 3)) * extent
    pts[:, 3] = rng.uniform(0, 1, n)
    fused = np.concatenate([pts[:0]] + [pts + [0.3 * -d, 0.1 * -d, 0, 0] for d in deltas]).astype(np.float32)
    return (
        pts, np.full(n, raw, np.int64), np.full(n, inst, np.int32),
        fused, np.full(len(fused), raw, np.int64), np.full(len(fused), inst, np.int32),
        np.repeat(np.asarray(deltas, np.int32), n),
    )


def _scene(kind):
    rng = np.random.default_rng(11)
    if kind == "static":
        parts = [
            _instance(rng, 40, [10, 8, -1], [4, 1.5, 1], 18, 1, [-1, -2]),   # along x, y > 4
            _instance(rng, 40, [5, -6, -1], [4, 1.5, 1], 20, 2, [-1, -3]),   # along x, y < -2
            _instance(rng, 40, [-7, 1, -1], [4, 1.5, 1], 18, 3, [-2]),       # along x, in lane
            _instance(rng, 40, [-3, 12, -1], [1.5, 4, 1], 20, 4, [-1, -2]),  # along y
            _instance(rng, 30, [15, -15, -1], [2, 2, 1], 18, 5, []),         # no history
            _instance(rng, 50, [0, 30, 0], [30, 2, 3], 40, 0, [-1]),         # road
        ]
    else:
        parts = [
            _instance(rng, 40, [6, 3, -1], [1.5, 0.6, 1.5], 253, 1, [-1, -2, -3]),
            _instance(rng, 40, [-6, 3, -1], [1.5, 0.6, 1.5], 255, 2, [-1, -2]),
            _instance(rng, 40, [9, 9, -1], [1.5, 0.6, 1.5], 253, 3, [-2, -3]),  # no delta -1
            _instance(rng, 10, [3, -9, -1], [1.5, 0.6, 1.5], 255, 4, [-1]),      # < min_points
            _instance(rng, 50, [0, 30, 0], [30, 2, 3], 40, 0, [-1]),
        ]
    return [np.concatenate([p[i] for p in parts]) for i in range(7)]


@pytest.mark.parametrize("kind", ["static", "moving"])
@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_switch_functions_match_jax(kind, prob):
    fn = "static2moving" if kind == "static" else "moving2static"
    outs, rngs = [], []
    for mod in (jsmsa, tsmsa):
        fp, fr, fi, mp, mr, mi, md = (a.copy() for a in _scene(kind))
        rng = np.random.default_rng(5)
        outs.append(getattr(mod, fn)(fp, fr, fi, mp, mr, mi, md, rng=rng, prob=prob))
        rngs.append(rng.random(3))
    for a, b in zip(*outs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(*rngs)
    if prob == 1.0:  # every eligible instance switched
        moved = {258, 259} if kind == "static" else {31, 32}
        assert moved <= set(np.unique(outs[1][1]).tolist())


def test_multiscan_label_map_matches_jax():
    raw = np.arange(260, dtype=np.uint32) | (np.uint32(3) << 16)
    for ms in (False, True):
        np.testing.assert_array_equal(j_remap(raw, multiscan=ms), t_remap(raw, multiscan=ms))
    assert t_remap(raw, multiscan=True).max() == 25


@pytest.mark.parametrize("split", ["train", "val"])
def test_smsa_reader_matches_jax(kitti, split):
    kw = dict(
        split=split, augment="NoAug", multiscan=3, pseudo_mask="gt",
        flexible_steps=[0] + [1] * 19, multiscan_labels=True, seed=2,
    )
    j, t = JReader(str(kitti), **kw), TReader(str(kitti), **kw)
    moving = 0
    for i in range(N_FRAMES):
        a, b = j[i], t[i]
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k]
        assert b["labels"].max() < 26 and len(b["labels_ms"]) == len(b["xyzret_ms"])
        moving += int((b["labels_ms"] >= 20).sum())
    assert moving > 0  # the fixture's moving classes (and any switch) reach the labels
    np.testing.assert_array_equal(j.rng.random(3), t.rng.random(3))


def test_smsa_loader_matches_jax(kitti):
    data = {**MINKUNET_MK34_CR10_SMSA["DATA"], "DATA_PATH": str(kitti), "MULTISCAN": 3,
            "PSEUDO_MASK": "gt", "VOXEL_SIZE": 0.2}
    r = tdata.build_reader(data, training=True)
    assert isinstance(r, TReader) and r.multiscan_labels and r.augment == "NoAug"
    kw = dict(training=True, scans_per_shard=2, point_capacity=16384)
    jl = j_build_dataloader(data, n_shards=1, **kw)
    tl = tdata.build_dataloader(data, **kw)
    assert isinstance(tl.pipeline, MsVoxelPipeline)
    for (ja, _), (ta, _) in zip(jl, tl):
        for k in ("point_coords", "point_feats", "labels", "num_points"):
            np.testing.assert_array_equal(ja[k][0], ta[k], err_msg=k)
