"""SPVCNN in the port against the JAX package: the point -> voxel tables,
the voxelize backward (K8's plain version), the eval logits, 3 train
steps, the weight tree, and the harness on SPVCNN.

Small size: cr 0.25, one block per stage, Dropout 0, 20 classes; two
~900-point synthetic scans in a 2048-row shard.  The eval weights are
`init_params_numpy`'s with the BN running statistics and affine terms
drawn at random, as `test_torch_minkunet.py` draws them (the flax init
leaves the logits near zero); their names and shapes are `SPVCNN.init`'s.

Tolerances, measured values in brackets.  The point_vox tables are
integers and equal.  K8's plain version is bit-equal to `jax.vjp` of
`voxelize_avg` in f32 and bf16 (a segment of 301 members, whose count
rounds to 300 in bf16).  Eval logits: f32 within 1e-4 of the logit scale;
bf16 within 2e-2 with argmax agreement >= 0.98.  Train steps (f32): this
step is more ill-conditioned than MinkUNet's of `test_torch_train.py`
(in the port alone, a 1e-7 relative change of the input features moves
single gradient tensors of step 0 by up to 3%, and JAX's own step and a
plain `jax.grad` of the same loss differ by 7e-5 in the grad norm), so
the tolerances are this model's, per step, from measurement: see TOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taseg_tpu.data.voxel_dataset import VoxelPipeline as JPipeline
from taseg_tpu.data.voxel_dataset import collate_shard as j_collate
from taseg_tpu.loss import Losses as JLosses
from taseg_tpu.models import UNetCapacities as JCaps
from taseg_tpu.models import build_unet_topology as j_topology
from taseg_tpu.models.fusion import SPVCNN as JSPVCNN
from taseg_tpu.ops import PointSet
from taseg_tpu.ops.voxelize import build_segment_tables as j_segment_tables
from taseg_tpu.ops.voxelize import voxelize_avg as j_voxelize
from taseg_tpu.optim import build_optimizer as j_build_optimizer
from taseg_tpu.parallel import Batch, TrainState, make_mesh, make_train_step
from taseg_tpu_torch.configs import MINKUNET_TINY
from taseg_tpu_torch.data.synthetic import synthetic_scan
from taseg_tpu_torch.engine import Segmenter, Trainer
from taseg_tpu_torch.models import SPVCNN, build_segmentor
from taseg_tpu_torch.models.voxel.backbone_context import UNetCapacities, build_unet_topology
from taseg_tpu_torch.models.voxel.minkunet import MinkUNet
from taseg_tpu_torch.ops import _build
from taseg_tpu_torch.ops import voxelize as tvx
from taseg_tpu_torch.utils.params_from_jax import (
    export_flax_params,
    init_params_numpy,
    load_flax_params,
)
from torch_jit_once import compile_once


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's thread team per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CAP = 2048
SCHEDULE = (1.0,) * 5
STRIDES = (1, 4, 16)
CFG = {
    "MODALITY": "fusion",
    "DATA": {"VOXEL_SIZE": 0.05},
    "MODEL": {
        "NAME": "SPVCNN", "NUM_CLASS": 20, "IN_FEATURE_DIM": 4, "IGNORE_LABEL": 0,
        "BLOCK": "ResBlock", "cr": 0.25, "NUM_LAYER": [1] * 8,
        "PLANES": [32, 32, 64, 128, 256, 256, 128, 96, 96], "DROPOUT_P": 0.0,
        "LABEL_SMOOTHING": 0.0, "CAPACITY_SCHEDULE": SCHEDULE,
        "LOSS_CONFIG": {"LOSS_TYPES": ["CELoss", "LovLoss"], "LOSS_WEIGHTS": [1.0, 1.0]},
    },
    "OPTIM": {
        "OPTIMIZER": "sgd", "LR_PER_SAMPLE": 0.02, "WEIGHT_DECAY": 1e-4,
        "MOMENTUM": 0.9, "NESTEROV": True, "GRAD_NORM_CLIP": 10.0,
        "SCHEDULER": "linear_warmup_with_cosdecay", "WARMUP_EPOCH": 1,
    },
}
SCHED = dict(iters_per_epoch=2, total_epochs=3)


def _jax_model(dtype="float32"):
    m = CFG["MODEL"]
    return JSPVCNN(
        num_classes=m["NUM_CLASS"], cr=m["cr"], num_layer=tuple(m["NUM_LAYER"]),
        block="ResBlock", dropout_p=0.0, compute_dtype=dtype,
    )


def _scans(seed=21, n=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pts, labels = synthetic_scan(rng, 900)
        ring = np.zeros((len(pts), 1), np.float32)
        out.append({"xyzret": np.concatenate([pts, ring], 1), "labels": labels})
    return out


def _randomize_bn(tree, rng, kind):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_bn(v, rng, kind)
            continue
        v = np.array(v, np.float32)
        if kind == "stats":
            v = rng.uniform(0.05, 0.15, v.shape) if k == "var" else rng.normal(0, 0.05, v.shape)
        elif k == "scale":
            v = rng.uniform(0.8, 1.2, v.shape)
        elif k == "bias" and v.shape[0] != 20:  # BN and Dense biases, not the head
            v = rng.normal(0, 0.1, v.shape)
        out[k] = v.astype(np.float32)
    return out


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def scene():
    scans = _scans()
    arrays = j_collate([JPipeline(0.05, training=False)(s) for s in scans], CAP)
    coords = jnp.asarray(arrays["point_coords"])
    num = jnp.int32(arrays["num_points"][0])
    points = PointSet(coords=coords, feats=jnp.asarray(arrays["point_feats"]), num=num)
    caps = JCaps.for_points(CAP, schedule=SCHEDULE)
    # the train form (its point_vox block does not depend on devox_pairs;
    # the eval forward reads none of its backward tables)
    topo = jax.jit(
        lambda c, n: j_topology(
            c, n, caps, assume_sorted_points=True, point_voxel_strides=STRIDES
        )
    )(coords, num)
    shapes = jax.eval_shape(
        lambda p: _jax_model().init({"params": jax.random.PRNGKey(0)}, p, topo, False), points
    )
    params, stats = init_params_numpy(CFG, seed=3)
    r = np.random.default_rng(5)
    variables = {
        "params": _randomize_bn(params, r, "params"),
        "batch_stats": _randomize_bn(stats, r, "stats"),
    }
    return scans, arrays, points, topo, variables, shapes


@pytest.mark.parametrize("devox_pairs", [False, True], ids=["eval", "train"])
def test_point_vox_tables_equal_jax(scene, devox_pairs):
    _, arrays, _, jt, _, _ = scene
    tt = build_unet_topology(
        torch.from_numpy(arrays["point_coords"]),
        torch.tensor(int(arrays["num_points"][0]), dtype=torch.int32),
        UNetCapacities.for_points(CAP, schedule=SCHEDULE),
        devox_pairs=devox_pairs, assume_sorted_points=True, point_voxel_strides=STRIDES,
    )
    assert sorted(tt.point_vox) == sorted(jt.point_vox) == list(STRIDES)
    assert int(tt.num_points) == int(jt.num_points)
    for s in STRIDES:
        (ji, jtab), (ti, ttab) = jt.point_vox[s], tt.point_vox[s]
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji), err_msg=f"stride {s}")
        for f in ("perm", "starts", "counts"):
            np.testing.assert_array_equal(
                getattr(ttab, f).numpy(), np.asarray(getattr(jtab, f)), err_msg=f"stride {s} {f}"
            )
        # every valid point has a voxel at every stride, the padding none
        n = int(arrays["num_points"][0])
        assert (ti[:n] >= 0).all() and (ti[n:] == -1).all()
    assert tt.point_vox[1][0] is tt.point_inverse and tt.point_vox[1][1] is tt.point_tables
    plain = build_unet_topology(
        torch.from_numpy(arrays["point_coords"]), tt.num_points,
        UNetCapacities.for_points(CAP, schedule=SCHEDULE), devox_pairs=devox_pairs,
    )
    assert plain.point_vox == {}
    with pytest.raises(ValueError, match="point_voxel_strides"):
        build_unet_topology(
            torch.from_numpy(arrays["point_coords"]), tt.num_points,
            UNetCapacities.for_points(CAP, schedule=SCHEDULE), point_voxel_strides=(2,),
        )


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).numpy()
        return x.view(np.uint16 if x.dtype == np.int16 else np.uint32)
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_voxelize_bwd_plain_bit_equal_jax(dtype):
    """K8's plain version (the VoxelizeAvg backward on the CPU) gives the
    bits of `jax.vjp(voxelize_avg)`: segments of 301 and 257 members
    (counts 300 and 256 in bf16), points without a voxel (+0 rows), empty
    voxels, and negative zeros in g."""
    rng = np.random.default_rng(8)
    v, p, c = 300, 3000, 24
    inv = rng.integers(2, v, p).astype(np.int32)
    inv[rng.random(p) < 0.05] = -1
    inv[inv == 7] = 5  # voxel 7 is empty
    inv[:301] = 0
    inv[301:558] = 1
    feats = rng.normal(size=(p, c)).astype(np.float32)
    g = rng.normal(size=(v, c)).astype(np.float32)
    g[3, :5] = -0.0
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jt = j_segment_tables(jnp.asarray(inv), v)
    _, vjp = jax.vjp(lambda f: j_voxelize(f, jnp.asarray(inv), jt), jnp.asarray(feats, jdt))
    (want,) = vjp(jnp.asarray(g, jdt))

    t_inv = torch.from_numpy(inv)
    tt = tvx.build_segment_tables(t_inv, v)
    _build.reset_launches()
    f = torch.from_numpy(feats).to(tdt).requires_grad_()
    (got,) = torch.autograd.grad(tvx.voxelize_avg(f, t_inv, tt), f, torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt and got.shape == (p, c)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    direct = tvx.voxelize_bwd(torch.from_numpy(g).to(tdt), t_inv, tt.counts)
    np.testing.assert_array_equal(_bits(direct), _bits(want))
    assert (_bits(got[inv < 0]) == 0).all()  # +0 rows
    assert not any(_build.LAUNCHES.values())  # CPU tensors: the plain version
    exact = torch.from_numpy(g).to(tdt)[0] / 301
    assert torch.equal(got[0], exact) == (dtype == "float32")  # bf16 divides by 300


def _jax_point_logits(scene, dtype):
    scans, arrays, points, topo, variables, _ = scene
    model = _jax_model(dtype)
    logits = np.asarray(jax.jit(lambda v, p: model.apply(v, p, topo, False))(variables, points))
    off = arrays["offsets"]
    return [logits[off[b] : off[b + 1]][s.inverse_map] for b, s in enumerate(arrays["samples"])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spvcnn_logits_match_jax(scene, dtype):
    scans, _, _, _, variables, _ = scene
    want = np.concatenate(_jax_point_logits(scene, dtype))
    seg = Segmenter(CFG, variables, device="cpu", compute_dtype=dtype, batch_size=2, point_capacity=CAP)
    assert isinstance(seg.model, SPVCNN)
    got = seg.predict(scans)
    g = np.concatenate([o["logits"] for o in got])
    assert g.shape == want.shape == (sum(len(s["labels"]) for s in scans), 20)
    assert np.isfinite(g).all()
    scale = np.abs(want).max()
    assert scale > 0.5  # BN terms randomized: logits are O(1)
    np.testing.assert_array_equal(np.concatenate([o["labels"] for o in got]), g.argmax(1))
    if dtype == "float32":
        assert np.abs(g - want).max() <= 1e-4 * scale
    else:
        assert np.abs(g - want).max() <= 2e-2 * scale
        assert (g.argmax(1) == want.argmax(1)).mean() >= 0.98


def test_point_branch_dtypes_as_jax(scene, monkeypatch):
    """In bf16 the point branch voxelizes bf16 rows at stride 1 and f32
    rows at strides 16 and 4, in JAX and in the port; so K8 takes bf16 g
    once and f32 g twice per train step."""
    import taseg_tpu.models.fusion.spvcnn as jmod
    import taseg_tpu_torch.models.fusion.spvcnn as tmod

    _, arrays, points, topo, variables, _ = scene
    seen = {"jax": [], "port": [], "k8": []}

    def spy(key, orig):
        def f(x, *a, **kw):
            seen[key].append(str(x.dtype).split(".")[-1])
            return orig(x, *a, **kw)
        return f

    monkeypatch.setattr(jmod, "voxelize_avg", spy("jax", jmod.voxelize_avg))
    monkeypatch.setattr(tmod, "voxelize_avg", spy("port", tmod.voxelize_avg))
    monkeypatch.setattr(tvx, "voxelize_bwd", spy("k8", tvx.voxelize_bwd))
    jax.eval_shape(lambda v, p: _jax_model("bfloat16").apply(v, p, topo, False), variables, points)
    tr = _trainer("bfloat16", variables)
    tr.train_on(tr.collate(_scans()))
    want = ["float32", "bfloat16", "float32", "float32"]
    assert seen["jax"] == seen["port"] == want
    assert sorted(seen["k8"]) == ["bfloat16", "float32", "float32"]


def test_weight_tree_and_round_trip(scene):
    """init_params_numpy gives `SPVCNN.init`'s names and shapes (the
    point transforms' Dense and BN, the f32 classifier over 480 = 256 +
    128 + 96 channels at cr 1, here 120), load -> export is the identity,
    and a missing or extra key raises."""
    _, _, _, _, variables, init = scene
    params, stats = init_params_numpy(CFG, seed=3)
    shapes = lambda t: {
        jax.tree_util.keystr(k): tuple(v.shape) for k, v in jax.tree_util.tree_leaves_with_path(t)
    }
    assert shapes(params) == shapes(init["params"])
    assert shapes(stats) == shapes(init["batch_stats"])
    assert params["classifier"]["kernel"].shape == (64 + 32 + 24, 20)
    k = params["point_transform_0"]["Dense_0"]["kernel"]  # (8, 64): lecun_normal, fan_in 8
    assert k.shape == (8, 64) and np.abs(k).max() <= 2 / np.sqrt(8) / 0.8796256610342398
    assert 0.8 < k.std() * np.sqrt(8) < 1.2
    m = build_segmentor(CFG, device="cpu")
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
    del short["point_transform_1"]
    with pytest.raises(KeyError):
        load_flax_params(m, short, variables["batch_stats"])


def test_build_segmentor_dispatch():
    """MODEL.NAME picks the model; an unported name raises with the list;
    `MinkUNet.from_cfg` refuses another name.  The point transforms' BN
    keeps momentum 0.1 whatever MODEL.BN_MOMENTUM says (as in JAX).
    DROPOUT_P > 0 builds a Trainer whose dropout draws from its seeded
    generator (MinkUNet trains with it: test_torch_train.py)."""
    cfg = {**CFG, "MODEL": {**CFG["MODEL"], "BN_MOMENTUM": 0.01, "MULTI_SCALE": "last"}}
    m = build_segmentor(cfg, device="cpu")
    assert isinstance(m, SPVCNN) and m.point_voxel_strides == STRIDES
    assert m.classifier.kernel.shape == (24, 20)  # z3 only
    assert m.point_transform_0.MaskedBatchNorm_0.momentum == 0.1
    assert m.stem_0.MaskedBatchNorm_0.momentum == 0.01
    mink = build_segmentor({**CFG, "MODEL": {**CFG["MODEL"], "NAME": "MinkUNet"}}, device="cpu")
    assert isinstance(mink, MinkUNet) and mink.point_voxel_strides == ()
    with pytest.raises(ValueError, match="SparseResUNet.*'CENet', 'Cylinder_TS', 'FIDNet', 'MinkUNet', "
                                         "'MinkUNetMs', 'MinkUNetMsKd', 'MinkUNetMsMm', 'MinkUNetMsMmNus', "
                                         "'RPVNet', 'RangeNet', 'SPVCNN', 'SalsaNext'"):
        build_segmentor({**CFG, "MODEL": {**CFG["MODEL"], "NAME": "SparseResUNet"}}, device="cpu")
    with pytest.raises(ValueError, match="build_segmentor"):
        MinkUNet.from_cfg(CFG, device="cpu")
    p, s = init_params_numpy(CFG, seed=0)
    tr = Trainer({**CFG, "MODEL": {**CFG["MODEL"], "DROPOUT_P": 0.3}},
                 {"params": p, "batch_stats": s}, device="cpu", point_capacity=CAP, **SCHED)
    assert tr.model.dropout.rate == 0.3 and tr.model.dropout.generator is tr.dropout_generator


def test_cli_takes_the_spvcnn_recipe():
    """`--cfg_file tools/cfgs/fusion/semantic_kitti/spvcnn_mk34_cr10.yaml`
    resolves to SPVCNN at full width (MODALITY fusion, on the voxel
    pipeline); RPVNet is taken, a model the port has not ported is
    refused."""
    from taseg_tpu_torch.train import check_ported
    from taseg_tpu_torch.utils.config import load_config

    cfg = load_config("tools/cfgs/fusion/semantic_kitti/spvcnn_mk34_cr10.yaml")
    assert check_ported(cfg) == "fusion"
    m = build_segmentor(cfg, device="cpu")
    assert isinstance(m, SPVCNN) and m.classifier.kernel.shape == (256 + 128 + 96, 20)
    assert m.point_transform_0.Dense_0.kernel.shape == (32, 256)
    assert check_ported({**cfg, "MODEL": {**cfg["MODEL"], "NAME": "RPVNet"}}) == "fusion"
    assert check_ported({**cfg, "MODEL": {**cfg["MODEL"], "NAME": "MinkUNetMsMmNus"}}) == "fusion"
    with pytest.raises(NotImplementedError, match="SparseResUNet"):
        check_ported({**cfg, "MODEL": {**cfg["MODEL"], "NAME": "SparseResUNet"}})
    with pytest.raises(NotImplementedError, match="range"):
        check_ported({**cfg, "MODALITY": "range"})


# ------------------------------------------------------------ train steps
def _trainer(dtype, variables=None, **kw):
    if variables is None:
        p, s = init_params_numpy(CFG, seed=4)
        variables = {"params": p, "batch_stats": s}
    return Trainer(
        CFG, variables, device="cpu", batch_size=2, seed=9, compute_dtype=dtype,
        point_capacity=CAP, **SCHED, **kw,
    )


def _jax_step():
    criterion = JLosses(["CELoss", "LovLoss"], [1.0, 1.0], ignore_index=0, label_smoothing=0.0)
    tx = j_build_optimizer(
        {**CFG["OPTIM"], "LR": 0.02 * 2}, SCHED["iters_per_epoch"], SCHED["total_epochs"],
        clip_grad_norm=10.0,
    )
    caps = JCaps.for_points(CAP, schedule=SCHEDULE)
    step = compile_once(make_train_step(
        _jax_model(), criterion, tx, caps, make_mesh(jax.devices()[:1]), donate=False,
        topo_kwargs={"assume_sorted_points": True, "point_voxel_strides": STRIDES},
    ))
    params, stats = init_params_numpy(CFG, seed=4)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(
        params=params, batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
        opt_state=tx.init(params), step=jnp.int32(0),
    )
    return step, state


@pytest.fixture(scope="module")
def f32_run():
    scans = _scans()
    tr = _trainer("float32")
    step, state = _jax_step()
    got, want = [], []
    for i in range(3):
        arrays = tr.collate(scans)
        state, metrics = step(
            state,
            Batch(
                point_coords=jnp.asarray(arrays["point_coords"][None]),
                point_feats=jnp.asarray(arrays["point_feats"][None]),
                labels=jnp.asarray(arrays["labels"][None]),
                num_points=jnp.asarray(arrays["num_points"].reshape(1, 1)),
            ),
            jax.random.fold_in(jax.random.PRNGKey(0), i),
        )
        want.append({k: np.asarray(v) for k, v in metrics.items()})
        want[-1]["variables"] = (state.params, state.batch_stats)
        got.append(tr.train_on(arrays))
        got[-1]["variables"] = export_flax_params(tr.model)
    return tr, got, want


# per step: (loss rel, grad norm rel, update L2 rel, BN statistics rel);
# measured [1e-9, 1.1e-4, 9.7e-3, 2.7e-6], [6.8e-7, 1.3e-4, 2.7e-3,
# 2.1e-6], [7.7e-5, 1.9e-3, 4.3e-2, 2.3e-3]
TOL = [(5e-5, 5e-4, 3e-2, 1e-4), (5e-5, 5e-4, 1e-2, 1e-4), (3e-4, 2e-2, 1e-1, 5e-3)]


def test_train_steps_match_jax_f32(f32_run):
    tr, got, want = f32_run
    prev = _flat(init_params_numpy(CFG, seed=4)[0])
    for i, (g, w, (tol_loss, tol_norm, tol_upd, tol_bn)) in enumerate(zip(got, want, TOL)):
        assert g["loss"] == pytest.approx(float(w["loss"]), rel=tol_loss), i
        assert g["grad_norm"] == pytest.approx(float(w["grad_norm"]), rel=tol_norm), i
        assert g["level_nums"] == w["level_nums"].tolist()
        (p, s), (jp, js) = g["variables"], w["variables"]
        a, b = _flat(p), _flat(jp)
        assert a.keys() == b.keys()
        diff = np.sqrt(sum(np.sum((a[k] - b[k]).astype(np.float64) ** 2) for k in a))
        upd = np.sqrt(sum(np.sum((b[k] - prev[k]).astype(np.float64) ** 2) for k in a))
        assert diff <= tol_upd * upd, (i, diff, upd)
        if i == 0:
            for k in a:
                assert np.abs(a[k] - b[k]).max() <= 1e-6 * max(np.abs(b[k]).max(), 1e-3), k
        sa, sb = _flat(s), _flat(js)
        assert sa.keys() == sb.keys()
        for k in sa:
            err = np.abs(sa[k] - sb[k]).max()
            assert err <= tol_bn * max(np.abs(sb[k]).max(), 1e-3), (i, k, err)
        prev = b
    # the point transforms train: their Dense kernels moved
    p0 = init_params_numpy(CFG, seed=4)[0]
    p3 = export_flax_params(tr.model)[0]
    for i in range(3):
        k0 = p0[f"point_transform_{i}"]["Dense_0"]["kernel"]
        assert np.abs(p3[f"point_transform_{i}"]["Dense_0"]["kernel"] - k0).max() > 1e-4


# ---------------------------------------------------------------- harness
def test_spvcnn_through_the_harness(tmp_path):
    """`Trainer.train` for one epoch through the loader (MODALITY fusion:
    the voxel pipeline, as in JAX), a checkpoint, `evaluate_points`
    equal to `Segmenter.predict` on the same weights and scans, and 2
    TTA votes writing raw-id `.label` files."""
    from taseg_tpu_torch import data as tdata
    from taseg_tpu_torch.data.semantickitti.labels import LEARNING_MAP_LUT

    data = {**MINKUNET_TINY["DATA"], "LENGTH": 4, "N_RAW_POINTS": 2000}
    cfg = {**MINKUNET_TINY, "MODALITY": "fusion", "DATA": data,
           "MODEL": {**MINKUNET_TINY["MODEL"], "NAME": "SPVCNN"}}
    p, s = init_params_numpy(cfg, seed=4)
    loaders = {
        t: tdata.build_dataloader(data, training=t, scans_per_shard=2, modality="fusion")
        for t in (True, False)
    }
    tr = Trainer(
        cfg, {"params": p, "batch_stats": s}, "cpu", train_loader=loaders[True],
        val_loader=loaders[False], total_epochs=1, output_dir=tmp_path, compute_dtype="float32",
    )
    assert isinstance(tr.model, SPVCNN)
    hist = tr.train()
    assert len(hist[0]["steps"]) == 2 and np.isfinite(hist[0]["loss"])
    assert [e for e, _ in tr.ckptr.list_epochs(tr.ckpt_dir)] == [0]
    out = tr.evaluate_points(save_path=tmp_path / "p")
    assert np.isfinite(out["miou"]) and out["hist"].sum() > 0
    p2, s2 = export_flax_params(tr.model)
    seg = Segmenter(cfg, {"params": p2, "batch_stats": s2}, "cpu", compute_dtype="float32",
                    point_capacity=loaders[False].point_capacity)
    reader = loaders[False].reader
    pred = seg.predict([reader[i] for i in range(len(reader))])
    for i, o in enumerate(pred):
        raw = np.fromfile(tmp_path / "p" / "sequences" / "08" / "predictions" / f"{i:06d}.label", np.uint32)
        np.testing.assert_array_equal(LEARNING_MAP_LUT[raw], o["labels"])
    tta = tr.evaluate_points(tta_votes=2, save_path=tmp_path / "t")
    assert np.isfinite(tta["miou"])
    files = sorted((tmp_path / "t" / "sequences" / "08" / "predictions").glob("*.label"))
    assert len(files) == len(reader)
    assert all(np.fromfile(f, np.uint32).shape == (2000,) for f in files)
