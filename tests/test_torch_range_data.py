"""The range view's host pipeline in the port against the JAX package's
(`data/range_dataset.py`, the `range` kind of `data/__init__.py`):
arrays equal, from the same scans and seeds.

  * each augmentation on its own (RangeShift, RangeMix, RangePaste,
    RangeUnion: the pipeline with that flag alone, over 8 scans and
    their second scans, so both branches of each 0.5 draw are taken), all
    four together, and eval (no augmentation);
  * the four augmentation functions directly, every mix grid;
  * `collate_range_batch` (JAX's (R, B, ...) form) and the port's shard
    collate, whose points concatenate scan after scan;
  * the loader (`build_dataloader(..., modality="range")`), train and
    eval: every batch's images, labels and masks, the scans' order, the
    padding flags; the second scans come from the loader's generator, so
    the training batches are equal too.

~7 s in one process, 4 s in the 6-worker tier-1 run.
"""

import numpy as np
import pytest

from taseg_tpu.data import build_dataloader as j_build_dataloader
from taseg_tpu.data import range_dataset as jrd
from taseg_tpu_torch.data import build_dataloader
from taseg_tpu_torch.data import range_dataset as trd
from taseg_tpu_torch.data.synthetic import SyntheticKittiReader

H, W = 16, 128
FLAGS = ("if_shift", "if_mix", "if_paste", "if_union")


def _scans(n, seed=0):
    reader = SyntheticKittiReader(length=n, n_points=3000, seed=seed)
    return [reader[i] for i in range(n)]


def _equal(a, b):
    for f in ("scan", "label", "mask", "proj_x", "proj_y", "unproj_range", "point_labels"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.name == b.name


@pytest.mark.parametrize("on", [*FLAGS, "all", "eval"])
def test_pipeline_equals_jax(on):
    flags = {f: on in (f, "all") for f in FLAGS}
    training = on != "eval"
    jp = jrd.RangeViewPipeline(H, W, training=training, seed=5, **flags)
    tp = trd.RangeViewPipeline(H, W, training=training, seed=5, **flags)
    scans, others = _scans(8), _scans(8, seed=1)
    for s, o in zip(scans, others):
        _equal(tp(s, o), jp(s, o))


def test_augmentations_equal_jax():
    (a, b), (c, d) = _scans(2), _scans(2, seed=3)
    p = jrd.RangeViewPipeline(H, W, training=False)
    sa, la, pa = p._project(a)
    sb, lb, pb = p._project(c)
    args = (sa, la, pa.mask, sb, lb, pb.mask)
    for x, y in zip(trd.range_shift(sa, la, pa.mask, 37), jrd.range_shift(sa, la, pa.mask, 37)):
        np.testing.assert_array_equal(x, y)
    for fn in ("range_paste", "range_union"):
        for x, y in zip(getattr(trd, fn)(*args), getattr(jrd, fn)(*args)):
            np.testing.assert_array_equal(x, y)
    assert trd.RANGE_MIX_GRIDS == jrd.RANGE_MIX_GRIDS
    assert trd.RANGE_PASTE_CLASSES == jrd.RANGE_PASTE_CLASSES
    for rows, cols in trd.RANGE_MIX_GRIDS:
        for x, y in zip(trd.range_mix(*args, rows, cols), jrd.range_mix(*args, rows, cols)):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)


def test_collate_equals_jax():
    p = trd.RangeViewPipeline(H, W, training=False)
    shards = [[p(s) for s in _scans(3)], [p(s) for s in _scans(3, seed=2)]]
    ta, tm = trd.collate_range_batch(shards)
    ja, jm = jrd.collate_range_batch(shards)
    assert ta.keys() == ja.keys()
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    assert [m["samples"] for m in tm] == [m["samples"] for m in jm]
    c = trd.collate_range_shard(shards[0])
    for k in ("scan", "label", "mask"):
        np.testing.assert_array_equal(c[k], ja[k][0], err_msg=k)
    n = [len(s.proj_x) for s in shards[0]]
    np.testing.assert_array_equal(c["offsets"], np.cumsum([0] + n))
    np.testing.assert_array_equal(c["img"], np.repeat(np.arange(3), n))
    for k, f in (("px", "proj_x"), ("py", "proj_y"), ("unproj_range", "unproj_range")):
        np.testing.assert_array_equal(c[k], np.concatenate([getattr(s, f) for s in shards[0]]))
    assert c["px"].dtype == c["py"].dtype == c["img"].dtype == np.int32


@pytest.mark.parametrize("training", [True, False])
def test_loader_equals_jax(training):
    data = {"DATASET": "synthetic", "LENGTH": 5, "N_RAW_POINTS": 2000, "H": H, "W": W}
    j = j_build_dataloader(data, training=training, n_shards=1, scans_per_shard=2, modality="range")
    t = build_dataloader(data, training=training, scans_per_shard=2, modality="range")
    assert len(j) == len(t) == (2 if training else 3)
    assert t.point_capacity == 0
    n = 0
    for (ja, jm), (ta, tm) in zip(j, t):
        for k in ("scan", "label", "mask"):
            np.testing.assert_array_equal(ta[k], ja[k][0], err_msg=k)
        assert [s.name for s in tm[0]["samples"]] == [s.name for s in jm[0]["samples"]]
        assert tm[0]["padded"] == jm[0]["padded"]
        n += 1
    assert n == len(t)
