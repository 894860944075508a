"""RPVNet in the port against the JAX package, eval side: the fusion
pipeline and collate, the point <-> range tables as the engine builds
them, the logits of the three heads, the range branch's dtypes, the
weight tree, and the dispatch on MODEL.NAME.

The scene is `rpvnet_scene`'s: cr 0.125, one block per stage, two
~900-point scans in one 2048-row shard with 16 x 64 range images; the
weights are `init_params_numpy`'s with the BN terms drawn at random (the
logits reach ~2600: the random BN statistics compound through the range
branch's ~30 BN layers in a row).  Tolerances, measured values in
brackets: f32 logits within 1e-5 of their scale [9.3e-7]; bf16 within
2e-3 of the scale [5.0e-4] with argmax agreement >= 0.98 [0.9994]; the
'sum' and 'se' heads as the f32 'concat' one.  Tables and collated
arrays are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpvnet_scene as S
from taseg_tpu.data.fusion_dataset import FusionPipeline as JFusionPipeline
from taseg_tpu_torch.data.fusion_dataset import FusionPipeline, collate_fusion_shard
from taseg_tpu_torch.engine import Segmenter, model_topology, to_device
from taseg_tpu_torch.models import RPVNet, build_segmentor
from taseg_tpu_torch.models.fusion.rpvnet import FUSION_SCALES, RpvInputs
from taseg_tpu_torch.models.voxel.backbone_context import UNetCapacities
from taseg_tpu_torch.utils.params_from_jax import (
    export_flax_params,
    init_params_numpy,
    load_flax_params,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's thread team per process oversubscribes the cores
    (the range branch's many small convs then slow down tenfold)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def scene():
    scans = S.scans()
    arrays, meta = S.jax_arrays(scans)
    inputs = S.jax_inputs(arrays)
    init = jax.eval_shape(
        lambda *a: S.jax_model().init({"params": jax.random.PRNGKey(0)}, *a, False), *inputs
    )
    return scans, (arrays, meta), inputs, S.variables(), init


def _port_arrays(scans, training=False, aug=None):
    pipe = FusionPipeline(S.CFG["DATA"]["VOXEL_SIZE"], training=training, h=S.H, w=S.W)
    return collate_fusion_shard([pipe(s, aug=aug) for s in scans], S.CAP)


def test_fusion_pipeline_and_collate_equal_jax(scene):
    """The collated shard (voxels, the (B, H, W, 6) images, the pixel
    coordinates with rows offset per scan) equals JAX's, without and with
    an augmentation; padding rows have pixel (0, 0)."""
    from taseg_tpu.data.augment import AugParams as JAug
    from taseg_tpu_torch.data.augment import AugParams

    scans, (ja, jm), *_ = scene
    for aug in (None, 1):
        if aug is None:
            want, got = ja, _port_arrays(scans)
        else:
            j = JAug.sample(np.random.default_rng(4))
            t = AugParams.sample(np.random.default_rng(4))
            jp = JFusionPipeline(0.05, training=False, h=S.H, w=S.W)
            from taseg_tpu.data.fusion_dataset import collate_fusion_batch

            want, _ = collate_fusion_batch([[jp(s, aug=j) for s in scans]], S.CAP)
            got = _port_arrays(scans, aug=t)
        for k in ("point_coords", "point_feats", "labels", "num_points", "range_image", "range_pxpy"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k][0]).reshape(got[k].shape), err_msg=k)
    assert got["range_image"].shape == (2, S.H, S.W, 6)
    n0, n = got["offsets"][1], int(got["num_points"][0])
    assert (got["range_pxpy"][:n0, 1] < S.H).all() and (got["range_pxpy"][n0:n, 1] >= S.H).all()
    assert (got["range_pxpy"][n:] == 0).all()
    assert [s.name for s in got["samples"]] == [s.name for s in jm[0]["samples"]]


def test_rpv_inputs_equal_jax(scene):
    """The engine's topology stage for RPVNet (`model_topology`): the
    point <-> range tables at every scale equal JAX's `_unpack`; serving
    leaves the sample tables' pairs out."""
    scans, _, (_, _, jrpv, jcanvas), *_ = scene
    model = build_segmentor(S.CFG, device="cpu")
    arrays = to_device(_port_arrays(scans), "cpu")
    caps = UNetCapacities.for_points(S.CAP, schedule=S.SCHEDULE)
    train = model_topology(model, arrays, caps, sorted_points=True, devox_pairs=True)
    serve = model_topology(model, arrays, caps, sorted_points=True)
    assert isinstance(train, RpvInputs)
    np.testing.assert_array_equal(train.range_image.numpy(), np.asarray(jcanvas))
    assert (train.rpv.h, train.rpv.w, train.rpv.b) == (S.H, S.W, 2)
    for s in FUSION_SCALES:
        (ti, tt), (ji, jt) = train.rpv.scatter[s], jrpv.scatter[s]
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        for f in ("perm", "starts", "counts"):
            np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)))
            np.testing.assert_array_equal(
                getattr(train.rpv.sample[s].pairs, f).numpy(),
                np.asarray(getattr(jrpv.sample[s].pairs, f)),
            )
        np.testing.assert_array_equal(train.rpv.sample[s].idx.numpy(), np.asarray(jrpv.sample[s].idx))
        np.testing.assert_array_equal(
            train.rpv.sample[s].weights.numpy(), np.asarray(jrpv.sample[s].weights)
        )
        assert serve.rpv.sample[s].pairs is None
        assert torch.equal(serve.rpv.sample[s].idx, train.rpv.sample[s].idx)


def _head_model(head, variables, dtype):
    """RPVNet with the `head` classifier ('sum': l1, l2 and a 12 -> 20
    classifier; 'se': the attention Dense and a 60 -> 20 classifier) on
    the scene's weights, its head's Dense layers drawn at random."""
    model = RPVNet(num_classes=20, cr=0.125, num_layer=[1] * 8, dropout_p=0.0,
                   compute_dtype=dtype, multi_scale=head, device="cpu")
    shapes = export_flax_params(model)[0]
    rng = np.random.default_rng(6)
    params = dict(variables["params"])
    for name in ("l1", "l2", "attn", "classifier"):
        if name in shapes:
            fan_in, fan_out = shapes[name]["kernel"].shape
            params[name] = {
                "kernel": rng.normal(0, fan_in**-0.5, (fan_in, fan_out)).astype(np.float32),
                "bias": rng.normal(0, 0.1, fan_out).astype(np.float32),
            }
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    load_flax_params(model, params, variables["batch_stats"])
    return model.eval(), variables


@pytest.mark.parametrize(
    "dtype,head", [("float32", "concat"), ("bfloat16", "concat"), ("float32", "sum"), ("float32", "se")]
)
def test_rpvnet_logits_match_jax(scene, dtype, head):
    scans, arrays, inputs, variables, _ = scene
    seg = Segmenter(S.CFG, variables, device="cpu", compute_dtype=dtype, batch_size=2,
                    point_capacity=S.CAP)
    if head != "concat":
        seg.model, variables = _head_model(head, variables, dtype)
    assert isinstance(seg.model, RPVNet) and seg.model.multi_scale == head
    want = np.concatenate(S.jax_point_logits(arrays, inputs, variables, dtype, head))
    got = seg.predict(scans)
    g = np.concatenate([o["logits"] for o in got])
    assert g.shape == want.shape == (sum(len(s["labels"]) for s in scans), 20)
    assert np.isfinite(g).all()
    np.testing.assert_array_equal(np.concatenate([o["labels"] for o in got]), g.argmax(1))
    scale = np.abs(want).max()
    assert scale > 0.5
    if dtype == "float32":
        assert np.abs(g - want).max() <= 1e-5 * scale
    else:
        assert np.abs(g - want).max() <= 2e-3 * scale
        assert (g.argmax(1) == want.argmax(1)).mean() >= 0.98


def test_range_branch_dtypes_as_jax(scene, monkeypatch):
    """In bf16, as in JAX: the three scatters to the range image take f32
    point rows (z0, z1, z2); the four samples back read f32 images (the
    range branch computes in f32: flax's Conv promotes) at widths 4, 32,
    16, 12 (cr 0.125); the voxel branch's devoxelizations read bf16."""
    import taseg_tpu.models.fusion.rpvnet as jmod
    import taseg_tpu_torch.models.fusion.rpvnet as tmod

    _, _, inputs, variables, _ = scene
    seen = {"jax": [], "port": []}

    def spy(key, name, orig):
        def f(x, *a, **kw):
            seen[key].append((name, str(x.dtype).split(".")[-1], int(x.shape[-1])))
            return orig(x, *a, **kw)
        return f

    for key, mod in (("jax", jmod), ("port", tmod)):
        for name in ("point_to_range", "devoxelize", "voxelize_avg"):
            monkeypatch.setattr(mod, name, spy(key, name, getattr(mod, name)))
    jax.eval_shape(
        lambda v, *a: S.jax_model("bfloat16").apply(v, *a, False), variables, *inputs
    )
    scans = S.scans()
    seg = Segmenter(S.CFG, variables, device="cpu", compute_dtype="bfloat16", batch_size=2,
                    point_capacity=S.CAP)
    seg.predict(scans)
    assert seen["jax"] == seen["port"]
    assert [d for n, d, _ in seen["port"] if n == "point_to_range"] == ["float32"] * 3
    samples = [(d, c) for n, d, c in seen["port"] if n == "devoxelize" and d == "float32"]
    assert samples == [("float32", 4), ("float32", 32), ("float32", 16), ("float32", 12)]


def test_weight_tree_and_round_trip(scene):
    """init_params_numpy gives `RPVNet.init`'s names and shapes (flax
    Conv kernels HWIO with a bias, BatchNorm scale / bias and mean /
    var), load -> export is the identity, a missing or extra key raises;
    the range convs draw lecun_normal over kh * kw * C_in."""
    *_, variables, init = scene
    params, stats = init_params_numpy(S.CFG, seed=3)
    shapes = lambda t: {
        jax.tree_util.keystr(k): tuple(v.shape) for k, v in jax.tree_util.tree_leaves_with_path(t)
    }
    assert shapes(params) == shapes(init["params"])
    assert shapes(stats) == shapes(init["batch_stats"])
    k = params["range_stem"]["ResContextBlock_0"]["ConvActBN_0"]["Conv_0"]["kernel"]
    assert k.shape == (3, 3, 4, 4) and np.abs(k).max() <= 2 / np.sqrt(36) / 0.8796256610342398
    assert not params["range_stem"]["ResContextBlock_0"]["Conv_0"]["bias"].any()
    assert params["classifier"]["kernel"].shape == (32 + 16 + 12, 20)
    m = build_segmentor(S.CFG, device="cpu")
    load_flax_params(m, variables["params"], variables["batch_stats"])
    p, s = export_flax_params(m)
    for a, b in ((p, variables["params"]), (s, variables["batch_stats"])):
        fa, fb = _flat(a), _flat(b)
        assert fa.keys() == fb.keys()
        for key in fa:
            np.testing.assert_array_equal(fa[key], fb[key], err_msg=key)
    extra = {**variables["params"], "extra": {"kernel": np.zeros(3, np.float32)}}
    with pytest.raises(KeyError):
        load_flax_params(m, extra, variables["batch_stats"])
    short = dict(variables["params"])
    del short["range_dec_top"]
    with pytest.raises(KeyError):
        load_flax_params(m, short, variables["batch_stats"])


def test_build_segmentor_dispatch_rpvnet():
    """MODEL.NAME RPVNet builds RPVNet with JAX's kwargs: BN_MOMENTUM and
    MULTI_SCALE are not passed (every BN at momentum 0.1, or the range
    branch's flax 0.9; the 'concat' head), DROPOUT_P is; the recipe at
    full width has the YAML's widths."""
    from taseg_tpu_torch.utils.config import load_config

    cfg = {**S.CFG, "MODEL": {**S.CFG["MODEL"], "BN_MOMENTUM": 0.01, "MULTI_SCALE": "sum",
                              "DROPOUT_P": 0.3}}
    m = build_segmentor(cfg, device="cpu")
    assert isinstance(m, RPVNet) and m.point_voxel_strides == (1, 4, 16) and m.range_view
    assert m.multi_scale == "concat" and m.dropout_p == 0.3 and m.dropout.rate == 0.3
    assert m.v_stem0.MaskedBatchNorm_0.momentum == 0.1
    assert m.stage1_0.MaskedBatchNorm_0.momentum == 0.1
    assert m.pt0.MaskedBatchNorm_0.momentum == 0.1
    assert m.range_stem.ResContextBlock_0.ConvActBN_0.BatchNorm_0.momentum == 0.9
    full = build_segmentor(load_config("tools/cfgs/fusion/semantic_kitti/rpvnet_mk18_cr10.yaml"), device="cpu")
    assert full.classifier.kernel.shape == (256 + 128 + 96, 20)
    assert full.range_encoder.SalsaResBlock_4.ConvActBN_3.Conv_0.kernel.shape == (1, 1, 768, 256)
    assert [full.num_layer[i] for i in range(8)] == [2] * 8
