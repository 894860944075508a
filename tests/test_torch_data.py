"""The port's numpy host pipeline against the JAX package's: the same
seed must give the same arrays (`taseg_tpu_torch.data` is a copy)."""

from pathlib import Path

import numpy as np
import pytest

from taseg_tpu.data import augment as jaug
from taseg_tpu.data import synthetic as jsyn
from taseg_tpu.data import voxel_dataset as jvd
from taseg_tpu.ops import quantize as jq
from taseg_tpu_torch.data import augment as taug
from taseg_tpu_torch.data import quantize as tq
from taseg_tpu_torch.data import synthetic as tsyn
from taseg_tpu_torch.data import voxel_dataset as tvd


def _scans(mod, n, n_points, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pts, labels = mod.synthetic_scan(rng, n_points)
        ring = np.zeros((len(pts), 1), np.float32)
        out.append({"xyzret": np.concatenate([pts, ring], 1), "labels": labels})
    return out


def test_synthetic_scan_equal():
    a = _scans(jsyn, 2, 4000, 7)
    b = _scans(tsyn, 2, 4000, 7)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["xyzret"], y["xyzret"])
        np.testing.assert_array_equal(x["labels"], y["labels"])


def test_sparse_quantize_equal():
    rng = np.random.default_rng(3)
    pts = rng.normal(0, 5, (3000, 3))
    for a, b in zip(
        jq.sparse_quantize(pts, 0.5, return_index=True, return_inverse=True),
        tq.sparse_quantize(pts, 0.5, return_index=True, return_inverse=True),
    ):
        np.testing.assert_array_equal(a, b)


def test_aug_params_equal():
    xyz = np.random.default_rng(1).normal(size=(500, 3))
    a = jaug.AugParams.sample(np.random.default_rng(9))
    b = taug.AugParams.sample(np.random.default_rng(9))
    np.testing.assert_array_equal(a.apply(xyz), b.apply(xyz))


@pytest.mark.parametrize("training", [False, True])
def test_pipeline_and_collate_equal(training):
    scans = _scans(tsyn, 3, 5000, 11)
    jp = jvd.VoxelPipeline(voxel_size=0.1, training=training, seed=4)
    tp = tvd.VoxelPipeline(voxel_size=0.1, training=training, seed=4)
    js = [jp(s) for s in scans]
    ts = [tp(s) for s in scans]
    for a, b in zip(js, ts):
        for field in ("coords", "feats", "labels", "inverse_map", "raw_labels"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        assert a.num_raw_points == b.num_raw_points
    ja = jvd.collate_shard(js, 16384)
    ta = tvd.collate_shard(ts, 16384)
    for k in ("point_coords", "point_feats", "labels", "num_points", "offsets"):
        np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)
    with pytest.raises(ValueError):
        tvd.collate_shard(ts, 100)


def test_config_dict_matches_yaml():
    """configs.MINKUNET_MK34_CR10 holds every DATA/MODEL key it shares
    with its YAML file at the YAML's value."""
    from taseg_tpu.utils.config import load_config
    from taseg_tpu_torch.configs import MINKUNET_MK34_CR10

    y = load_config(
        Path(__file__).resolve().parents[1]
        / "tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10.yaml"
    )
    for sec in ("DATA", "MODEL"):
        for k, v in MINKUNET_MK34_CR10[sec].items():
            if k == "CAPACITY_SCHEDULE":
                continue  # the port's deployment setting, not in the YAML
            assert y[sec][k] == v, (sec, k)
