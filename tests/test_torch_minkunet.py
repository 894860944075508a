"""The port's slice end to end against the JAX package: the same synthetic
scans and the same weights through `Segmenter.predict` and through the
JAX pipeline + topology + MinkUNet, per raw point.

Small size: cr 0.25, one block per stage, two ~900-point scans in a
2048-row shard.  BN running statistics and affine terms are drawn at
random (the flax init makes BN near-identity, which leaves the logits
near zero), so the logits are O(1).

Tolerances: f32 `allclose(rtol=1e-3, atol=1e-3)`.  bf16 (the port sums
each conv in f32 and rounds once; JAX's TGF path rounds per group):
max |dlogit| <= 2e-2 * max |logit| and per-point argmax agreement >= 98%
(0.74% and 99.6% measured on this scene when the bound was set).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taseg_tpu.data.voxel_dataset import VoxelPipeline as JPipeline
from taseg_tpu.data.voxel_dataset import collate_shard as j_collate
from taseg_tpu.models import MinkUNet as JMinkUNet
from taseg_tpu.models import UNetCapacities as JCaps
from taseg_tpu.models import build_unet_topology as j_topology
from taseg_tpu.ops import PointSet
from taseg_tpu_torch.data.synthetic import synthetic_scan
from taseg_tpu_torch.engine import Segmenter
from taseg_tpu_torch.models.voxel.minkunet import MinkUNet
from taseg_tpu_torch.utils.params_from_jax import init_params_numpy, load_flax_params

CAP = 2048
SCHEDULE = (1.0,) * 5
CFG = {
    "DATA": {"VOXEL_SIZE": 0.05},
    "MODEL": {
        "NAME": "MinkUNet", "NUM_CLASS": 20, "IN_FEATURE_DIM": 4,
        "BLOCK": "ResBlock", "cr": 0.25, "NUM_LAYER": [1] * 8,
        "PLANES": [32, 32, 64, 128, 256, 256, 128, 96, 96],
        "CAPACITY_SCHEDULE": SCHEDULE,
    },
}


def _jax_model(dtype):
    m = CFG["MODEL"]
    return JMinkUNet(
        num_classes=m["NUM_CLASS"], cr=m["cr"], num_layer=tuple(m["NUM_LAYER"]),
        block="ResBlock", compute_dtype=dtype,
    )


def _randomize_bn(tree, rng, kind):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_bn(v, rng, kind)
            continue
        v = np.array(v, np.float32)
        if kind == "stats":
            v = (rng.uniform(0.05, 0.15, v.shape) if k == "var" else rng.normal(0, 0.05, v.shape))
        elif k == "scale":
            v = rng.uniform(0.8, 1.2, v.shape)
        elif k == "bias" and v.shape[0] != 20:  # BN bias, not the head
            v = rng.normal(0, 0.1, v.shape)
        out[k] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(21)
    scans = []
    for _ in range(2):
        pts, labels = synthetic_scan(rng, 900)
        ring = np.zeros((len(pts), 1), np.float32)
        scans.append({"xyzret": np.concatenate([pts, ring], 1), "labels": labels})
    arrays = j_collate([JPipeline(0.05, training=False)(s) for s in scans], CAP)
    coords = jnp.asarray(arrays["point_coords"])
    feats = jnp.asarray(arrays["point_feats"])
    num = jnp.int32(arrays["num_points"][0])
    caps = JCaps.for_points(CAP, schedule=SCHEDULE)
    points = PointSet(coords=coords, feats=feats, num=num)
    topo = jax.jit(
        lambda c, n: j_topology(c, n, caps, devox_pairs=False, assume_sorted_points=True)
    )(coords, num)
    variables = jax.jit(
        lambda p: _jax_model("float32").init({"params": jax.random.PRNGKey(0)}, p, topo, False)
    )(points)
    r = np.random.default_rng(5)
    variables = {
        "params": _randomize_bn(jax.tree_util.tree_map(np.asarray, variables["params"]), r, "params"),
        "batch_stats": _randomize_bn(jax.tree_util.tree_map(np.asarray, variables["batch_stats"]), r, "stats"),
    }
    return scans, arrays, points, topo, variables


def _jax_point_logits(scene, dtype):
    scans, arrays, points, topo, variables = scene
    model = _jax_model(dtype)
    logits = np.asarray(jax.jit(lambda v, p: model.apply(v, p, topo, False))(variables, points))
    off = arrays["offsets"]
    return [
        logits[off[b] : off[b + 1]][s.inverse_map] for b, s in enumerate(arrays["samples"])
    ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segmenter_matches_jax(scene, dtype):
    scans, _, _, _, variables = scene
    want = _jax_point_logits(scene, dtype)
    seg = Segmenter(
        CFG, variables, device="cpu", compute_dtype=dtype, batch_size=2, point_capacity=CAP
    )
    got = seg.predict(scans)
    assert len(got) == len(scans)
    g = np.concatenate([o["logits"] for o in got])
    w = np.concatenate(want)
    assert g.shape == (sum(len(s["labels"]) for s in scans), 20)
    assert np.isfinite(g).all()
    scale = np.abs(w).max()
    assert scale > 0.5  # BN stats randomized: logits are O(1)
    np.testing.assert_array_equal(
        np.concatenate([o["labels"] for o in got]), g.argmax(1)
    )
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3)
    else:
        assert np.abs(g - w).max() <= 2e-2 * scale
        assert (g.argmax(1) == w.argmax(1)).mean() >= 0.98


def test_init_params_numpy_matches_flax_tree(scene):
    """Same names and shapes as `model.init`, and the flax init ranges."""
    _, _, _, _, variables = scene
    params, stats = init_params_numpy(CFG, seed=3)
    flat = lambda t: {jax.tree_util.keystr(k): v.shape for k, v in jax.tree_util.tree_leaves_with_path(t)}
    assert flat(params) == flat(variables["params"])
    assert flat(stats) == flat(variables["batch_stats"])
    k = params["stem_0"]["SparseConv_0"]["kernel"]  # (27, 4, 8): std 1/sqrt(4*27)
    assert np.abs(k).max() <= 1 / np.sqrt(4 * 27) and np.abs(k).max() > 0.5 / np.sqrt(4 * 27)
    m = MinkUNet.from_cfg(CFG, device="cpu")
    load_flax_params(m, params, stats)  # every key consumed, none missing


def test_load_flax_params_rejects_mismatch(scene):
    _, _, _, _, variables = scene
    m = MinkUNet.from_cfg(CFG, device="cpu")
    params = {**variables["params"], "extra": {"kernel": np.zeros(3, np.float32)}}
    with pytest.raises(KeyError):
        load_flax_params(m, params, variables["batch_stats"])
    params = dict(variables["params"])
    del params["stem_1"]
    with pytest.raises(KeyError):
        load_flax_params(m, params, variables["batch_stats"])


def test_segmenter_raises_on_capacity_overflow(scene):
    scans, _, _, _, variables = scene
    cfg = {**CFG, "MODEL": {**CFG["MODEL"], "CAPACITY_SCHEDULE": (1.0, 0.05)}}
    seg = Segmenter(cfg, variables, device="cpu", point_capacity=CAP)
    with pytest.raises(RuntimeError, match="capacity overflow"):
        seg.predict(scans[:1])


def test_entry_points_default_to_cuda():
    """device=None means CUDA: without it the entry points raise rather
    than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: device=None resolves to it")
    params, stats = init_params_numpy(CFG, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        MinkUNet.from_cfg(CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        Segmenter(CFG, {"params": params, "batch_stats": stats})
