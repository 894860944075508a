"""Cylinder_TS in the port against the JAX package on the CPU: the eval
logits of `CylinderTS` (INIT_SIZE 4, 20 classes, f32) on JAX's own test
scene (1500 uniform points on the 64 x 64 x 16 polar grid, 2048 rows),
`Segmenter.predict` mapping them to the raw points, the weight tree
(names, shapes, init bounds, load and export), and `build_segmentor`'s
dispatch (INIT_SIZE / IN_FEATURE_DIM defaults, f32 only).

JAX's `apply` is jitted once for the module, on the seeded weights of
`init_params_numpy`; its `init` is only traced (`jax.eval_shape`), for
the tree's names and shapes.  Tolerance: the eval logits within 1e-4 of
the logit scale [measured 6.9e-7 of it].
About 19 s on one worker (`--durations`), 14 s of it JAX compiling.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taseg_tpu.models import UNetCapacities as JCaps
from taseg_tpu.models.voxel.cylinder3d import CylinderTS as JCylinderTS
from taseg_tpu.models.voxel.cylinder3d import build_cylinder_topology as j_topology
from taseg_tpu.ops import PointSet
from taseg_tpu_torch.data.cylinder_dataset import CylinderPipeline
from taseg_tpu_torch.engine import Segmenter, make_pipeline
from taseg_tpu_torch.models import CylinderTS, build_segmentor
from taseg_tpu_torch.models.layers import SparseConv
from taseg_tpu_torch.models.voxel.backbone_context import UNetCapacities
from taseg_tpu_torch.models.voxel.cylinder3d import build_cylinder_topology
from taseg_tpu_torch.ops import _build
from taseg_tpu_torch.utils.params_from_jax import export_flax_params, init_params_numpy, load_flax_params

CAP = 2048
CFG = {
    "DATA": {"GRID_SIZE": [64, 64, 16]},
    "MODEL": {"NAME": "Cylinder_TS", "NUM_CLASS": 20, "IN_FEATURE_DIM": 9, "INIT_SIZE": 4},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's thread team per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-30, 30, (1500, 4)).astype(np.float32)
    return {"xyzret": pts, "labels": rng.integers(0, 20, 1500).astype(np.int32)}


@pytest.fixture(scope="module")
def jax_run():
    """The scene, the seeded weights (`init_params_numpy`, the flax
    layout), JAX's eval logits with them, and the shapes of the tree that
    JAX's `init` makes (traced only: `jax.eval_shape`)."""
    arrays = CylinderPipeline(grid=(64, 64, 16), training=False).collate(
        [CylinderPipeline(grid=(64, 64, 16), training=False)(_scan())], CAP
    )
    n = int(arrays["num_points"][0])
    points = PointSet(
        coords=jnp.asarray(arrays["point_coords"]), feats=jnp.asarray(arrays["point_feats"]),
        num=jnp.int32(n),
    )
    caps = JCaps.for_points(CAP)
    model = JCylinderTS(num_classes=20, init_size=4)

    def init(points):
        topo = j_topology(points.coords, points.num, caps)
        return model.init({"params": jax.random.PRNGKey(0)}, points, topo, False)

    def apply(v, points):
        return model.apply(v, points, j_topology(points.coords, points.num, caps), False)

    p, s = init_params_numpy(CFG, seed=3)
    v = {"params": p, "batch_stats": s}
    logits = jax.jit(apply)(jax.tree_util.tree_map(jnp.asarray, v), points)
    return arrays, n, v, jax.eval_shape(init, points), np.asarray(logits)


def _model(v):
    m = CylinderTS(20, init_size=4, device="cpu")
    load_flax_params(m, v["params"], v["batch_stats"])
    return m.eval()


def test_eval_logits_match_jax(jax_run):
    arrays, n, v, _, want = jax_run
    m = _model(v)
    topo = build_cylinder_topology(
        torch.from_numpy(arrays["point_coords"]), torch.tensor(n, dtype=torch.int32),
        UNetCapacities.for_points(CAP),
    )
    _build.reset_launches()
    with torch.no_grad():
        got = m(torch.from_numpy(arrays["point_feats"]), topo).numpy()
    assert not any(_build.LAUNCHES.values())
    assert got.dtype == np.float32 and got.shape == want.shape == (CAP, 20)
    scale = np.abs(want[:n]).max()
    assert np.abs(got[:n] - want[:n]).max() <= 1e-4 * scale
    assert np.isfinite(got).all()


def test_segmenter_maps_the_logits_to_raw_points(jax_run):
    """`Segmenter.predict` (the cylinder pipeline, topology and model by
    MODEL.NAME) gives each raw point its voxel row's logits."""
    arrays, n, v, _, want = jax_run
    seg = Segmenter(CFG, v, device="cpu", point_capacity=CAP)
    assert isinstance(seg.model, CylinderTS) and isinstance(seg.pipeline, CylinderPipeline)
    assert not seg.pipeline.sorted_points
    (out,) = seg.predict([_scan()])
    inv = arrays["samples"][0].inverse_map
    assert out["logits"].shape == (1500, 20)
    scale = np.abs(want[:n]).max()
    assert np.abs(out["logits"] - want[inv]).max() <= 1e-4 * scale
    np.testing.assert_array_equal(out["labels"], out["logits"].argmax(1))


def _flat(tree, pre=""):
    out = {}
    for k, x in tree.items():
        out.update(_flat(x, f"{pre}{k}/") if isinstance(x, dict) else {pre + k: x})
    return out


def test_weight_tree_matches_flax(jax_run):
    """`init_params_numpy` draws the names and shapes of the tree JAX's
    `init` makes (the head's bias and the deconvs' fan included: uniform
    within 1/sqrt(fan K)); load then export gives back the same arrays."""
    _, _, v, shapes, _ = jax_run
    p, s = v["params"], v["batch_stats"]
    jp, js = _flat(shapes["params"]), _flat(shapes["batch_stats"])
    tp, ts = _flat(p), _flat(s)
    assert tp.keys() == jp.keys() and ts.keys() == js.keys()
    for k in jp:
        assert tp[k].shape == jp[k].shape and tp[k].dtype == np.float32, k
    assert "logits/bias" in tp and "up0_deconv/kernel" in tp and "res2/proj/kernel" not in tp
    assert "up0_res/proj/kernel" in tp
    m = CylinderTS(20, init_size=4, device="cpu")
    convs = {n.replace(".", "/"): c for n, c in m.named_modules() if isinstance(c, SparseConv)}
    for name, c in convs.items():
        bound = 1.0 / (c.fan * c.kernel_volume) ** 0.5
        assert np.abs(tp[f"{name}/kernel"]).max() <= bound
        if c.bias is not None:
            assert np.abs(tp[f"{name}/bias"]).max() <= bound
    assert convs["up3_deconv"].fan == 8 and convs["pool1"].fan == 4
    load_flax_params(m, p, s)
    p2, s2 = export_flax_params(m)
    for a, b in ((tp, _flat(p2)), (ts, _flat(s2))):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_build_segmentor_takes_cylinder():
    """INIT_SIZE 32 and IN_FEATURE_DIM 9 by default (JAX
    models/__init__.py:58-64), built on the meta device (no memory); f32
    only; the cylinder pipeline on DATA.GRID_SIZE."""
    m = build_segmentor({"MODEL": {"NAME": "Cylinder_TS", "NUM_CLASS": 20}}, device="meta")
    assert isinstance(m, CylinderTS)
    assert m.pp_bn0.scale.shape == (9,)
    assert m.downCntx.a_conv0.kernel.shape == (9, 16, 32)
    assert m.pool3.kernel.shape == (4, 128, 256) and m.pool1.kernel.shape == (8, 32, 64)
    assert m.up0_res.res.a_conv0.kernel.shape == (9, 768, 512)
    assert m.logits.kernel.shape == (27, 128, 20) and m.logits.bias.shape == (20,)
    assert m.point_logits.kernel.shape == (256, 20)
    with pytest.raises(ValueError, match="float32"):
        build_segmentor({"MODEL": {"NAME": "Cylinder_TS", "NUM_CLASS": 20}}, device="meta",
                        compute_dtype="bfloat16")
    pipe = make_pipeline(CFG, m, training=True, seed=3)
    assert isinstance(pipe, CylinderPipeline) and tuple(pipe.grid) == (64, 64, 16)
    assert pipe.training
