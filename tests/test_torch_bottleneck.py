"""MinkUNet with the `Bottleneck` block, JAX's default when a config names
no BLOCK, against the JAX package: the same parameter tree, the same
serving logits through `Segmenter.predict`, and one train step through
`Trainer.train_on` against `make_train_step` on a one-device CPU mesh.

Small size: cr 0.125 (3^3 conv widths 4 ... 32, block outputs 16 ...
128), one block per stage, two ~900-point synthetic scans in a 2048-row
shard.  Tolerances as `test_torch_minkunet.py` (f32 logits
`allclose(rtol=1e-3, atol=1e-3)`, BN randomized so the logits are O(1))
and, for the step, as step 0 of `test_torch_train.py` (f32: loss
within 5e-5 relative, BN running statistics within 1e-4 of their scale)
except where the block's conditioning is measured worse: three convs
with BN and no ReLU between them leave the gradients of the convs before
each BN cancellation-limited, so in the port alone a 1e-7 relative change
of the input features moves the grad norm by 7.7e-5 and the update by
2.4e-2 of its L2 norm.  So the grad norm is held within 5e-4 [1.3e-4
measured against JAX] and the update within 5e-2 of its norm [2.4e-2].
~50 s on one worker, ~30 s of it JAX compiling the step, at XLA's
backend optimisation level 1 (the default level takes ~10 s more; at
level 0 JAX's grad norm comes out NaN).
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
from taseg_tpu.models import build_segmentor as j_build
from taseg_tpu.models import build_unet_topology as j_topology
from taseg_tpu.optim import build_optimizer as j_build_optimizer
from taseg_tpu.ops import PointSet
from taseg_tpu.parallel import Batch, TrainState, make_mesh, make_train_step
from taseg_tpu_torch.data.synthetic import synthetic_scan
from taseg_tpu_torch.engine import Segmenter, Trainer
from taseg_tpu_torch.models import build_segmentor
from taseg_tpu_torch.models.layers import Bottleneck
from taseg_tpu_torch.utils.params_from_jax import export_flax_params, init_params_numpy

CAP = 2048
SCHEDULE = (1.0,) * 5
# no BLOCK: both packages default to Bottleneck
CFG = {
    "DATA": {"VOXEL_SIZE": 0.05},
    "MODEL": {
        "NAME": "MinkUNet", "NUM_CLASS": 20, "IN_FEATURE_DIM": 4, "IGNORE_LABEL": 0,
        "cr": 0.125, "NUM_LAYER": [1] * 8, "DROPOUT_P": 0.0,
        "PLANES": [32, 32, 64, 128, 256, 256, 128, 96, 96],
        "CAPACITY_SCHEDULE": SCHEDULE, "LABEL_SMOOTHING": 0.1,
        "LOSS_CONFIG": {"LOSS_TYPES": ["CELoss", "LovLoss"], "LOSS_WEIGHTS": [1.0, 1.0]},
    },
    "OPTIM": {
        "OPTIMIZER": "sgd", "LR_PER_SAMPLE": 0.02, "WEIGHT_DECAY": 1e-4,
        "MOMENTUM": 0.9, "NESTEROV": True, "GRAD_NORM_CLIP": 10.0,
        "SCHEDULER": "linear_warmup_with_cosdecay", "WARMUP_EPOCH": 1,
    },
}
SCHED = dict(iters_per_epoch=2, total_epochs=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


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
        elif k == "bias" and v.shape[0] != 20:  # BN bias, not the head
            v = rng.normal(0, 0.1, v.shape)
        out[k] = v.astype(np.float32)
    return out


def _scans():
    rng = np.random.default_rng(21)
    out = []
    for _ in range(2):
        pts, labels = synthetic_scan(rng, 900)
        ring = np.zeros((len(pts), 1), np.float32)
        out.append({"xyzret": np.concatenate([pts, ring], 1), "labels": labels})
    return out


@pytest.fixture(scope="module")
def scene():
    scans = _scans()
    arrays = j_collate([JPipeline(0.05, training=False)(s) for s in scans], CAP)
    points = PointSet(
        coords=jnp.asarray(arrays["point_coords"]), feats=jnp.asarray(arrays["point_feats"]),
        num=jnp.int32(arrays["num_points"][0]),
    )
    caps = JCaps.for_points(CAP, schedule=SCHEDULE)
    topo = jax.jit(
        lambda c, n: j_topology(c, n, caps, devox_pairs=False, assume_sorted_points=True)
    )(points.coords, points.num)
    model = j_build(CFG["MODEL"], 20)
    assert model.block == "Bottleneck"
    params, stats = init_params_numpy(CFG, seed=3)
    r = np.random.default_rng(5)
    variables = {
        "params": _randomize_bn(params, r, "params"),
        "batch_stats": _randomize_bn(stats, r, "stats"),
    }
    return scans, arrays, points, topo, model, variables


def test_default_block_is_bottleneck_in_both(scene):
    """A config without BLOCK builds Bottleneck blocks in the port, with
    the parameter names and shapes of JAX's `model.init`, and every 3^3
    conv and block output at a width that is a multiple of 4 here (of 8
    at cr 1.0, so no call leaves the tensor-core routes)."""
    _, _, points, topo, model, _ = scene
    m = build_segmentor(CFG, device="cpu")
    blocks = [b for b in m.modules() if isinstance(b, Bottleneck)]
    assert len(blocks) == 8 and m.head_widths == (128, 64, 48)
    ref = jax.eval_shape(lambda p: model.init({"params": jax.random.PRNGKey(0)}, p, topo, False), points)
    params, stats = init_params_numpy(CFG, seed=0)
    shapes = lambda t: {
        jax.tree_util.keystr(k): tuple(v.shape) for k, v in jax.tree_util.tree_leaves_with_path(t)
    }
    assert shapes(params) == shapes(ref["params"])
    assert shapes(stats) == shapes(ref["batch_stats"])
    full = build_segmentor({**CFG, "MODEL": {**CFG["MODEL"], "cr": 1.0}}, device="cpu")
    widths = {w for p in full.parameters() for w in p.shape[-2:] if p.dim() >= 2}
    assert all(w % 8 == 0 for w in widths - {4, 20}), sorted(widths)  # C_in 4, 20 classes


def test_bottleneck_logits_match_jax(scene):
    scans, arrays, points, topo, model, variables = scene
    logits = np.asarray(jax.jit(lambda v, p: model.apply(v, p, topo, False))(variables, points))
    off = arrays["offsets"]
    want = np.concatenate(
        [logits[off[b] : off[b + 1]][s.inverse_map] for b, s in enumerate(arrays["samples"])]
    )
    seg = Segmenter(CFG, variables, device="cpu", batch_size=2, point_capacity=CAP)
    got = np.concatenate([o["logits"] for o in seg.predict(scans)])
    assert np.abs(want).max() > 0.5  # BN statistics randomized: O(1) logits
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_bottleneck_train_step_matches_jax():
    params, stats = init_params_numpy(CFG, seed=4)
    tr = Trainer(
        CFG, {"params": params, "batch_stats": stats}, device="cpu", batch_size=2, seed=9,
        point_capacity=CAP, **SCHED,
    )
    criterion = JLosses(["CELoss", "LovLoss"], [1.0, 1.0], ignore_index=0, label_smoothing=0.1)
    tx = j_build_optimizer(
        {**CFG["OPTIM"], "LR": 0.02 * 2}, SCHED["iters_per_epoch"], SCHED["total_epochs"],
        clip_grad_norm=10.0,
    )
    step = make_train_step(
        j_build(CFG["MODEL"], 20), criterion, tx, JCaps.for_points(CAP, schedule=SCHEDULE),
        make_mesh(jax.devices()[:1]), donate=False, topo_kwargs={"assume_sorted_points": True},
    )
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(
        params=jp, batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
        opt_state=tx.init(jp), step=jnp.int32(0),
    )
    a = tr.collate(_scans())
    batch = Batch(
        point_coords=jnp.asarray(a["point_coords"][None]), point_feats=jnp.asarray(a["point_feats"][None]),
        labels=jnp.asarray(a["labels"][None]), num_points=jnp.asarray(a["num_points"].reshape(1, 1)),
    )
    key = jax.random.PRNGKey(0)
    compiled = step.lower(state, batch, key).compile(
        compiler_options={"xla_backend_optimization_level": 1}
    )
    state, metrics = compiled(state, batch, key)
    got = tr.train_on(a)
    assert got["loss"] == pytest.approx(float(metrics["loss"]), rel=5e-5)
    assert got["grad_norm"] == pytest.approx(float(metrics["grad_norm"]), rel=5e-4)
    assert got["level_nums"] == np.asarray(metrics["level_nums"]).tolist()
    p, s = export_flax_params(tr.model)
    a_, b_, prev = _flat(p), _flat(state.params), _flat(params)
    assert a_.keys() == b_.keys()
    diff = np.sqrt(sum(np.sum((a_[k] - b_[k]).astype(np.float64) ** 2) for k in a_))
    upd = np.sqrt(sum(np.sum((b_[k] - prev[k]).astype(np.float64) ** 2) for k in a_))
    assert upd > 0 and diff <= 5e-2 * upd, (diff, upd)
    sa, sb = _flat(s), _flat(state.batch_stats)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert np.abs(sa[k] - sb[k]).max() <= 1e-4 * max(np.abs(sb[k]).max(), 1e-3), k
