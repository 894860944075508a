"""Cylinder_TS's train step in the port against JAX's `make_train_step`
with the cylinder `topology_fn` (as JAX's engine wires it,
engine.py:272-284): 3 f32 steps on the same collated shards and weights
(`Trainer.train_on` on the CPU: the plain versions of every kernel; JAX
on a one-device CPU mesh).

INIT_SIZE 4, 20 classes, the 64 x 64 x 16 polar grid; two 700-point
synthetic scans per step (~1070 voxel rows) in a 2048-row shard,
augmented by the port's cylinder pipeline (new augmentations each step).
Warmup of 2 steps (iters_per_epoch 2), so steps 1 and 2 move the
parameters.

Tolerances per step, measured values in brackets: loss within 5e-5
relative [<= 1.5e-7]; grad norm within 1e-4, 1e-4 and 1e-3 [1.0e-6,
1.0e-6, 1.0e-5]; the parameters' updates within 1e-3, 1e-3 and 1e-2 of
the update's L2 norm [3.3e-8, 1.7e-6, 8.3e-4]; every parameter after
step 0 within 1e-6 of its scale [5.7e-11]; BN running statistics within
5e-4 of their scale [3.0e-5, 3.8e-5, 5.5e-5].  About 45 s on one worker
(`--durations`), most of it JAX compiling the step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from taseg_tpu.loss import Losses as JLosses
from taseg_tpu.models import UNetCapacities as JCaps
from taseg_tpu.models.voxel.cylinder3d import CylinderTS as JCylinderTS
from taseg_tpu.models.voxel.cylinder3d import build_cylinder_topology as j_topology
from taseg_tpu.optim import build_optimizer as j_build_optimizer
from taseg_tpu.parallel import Batch, TrainState, make_mesh, make_train_step
from taseg_tpu_torch.data.cylinder_dataset import CylinderPipeline
from taseg_tpu_torch.data.synthetic import synthetic_scan
from taseg_tpu_torch.engine import Trainer
from taseg_tpu_torch.models import CylinderTS
from taseg_tpu_torch.utils.params_from_jax import export_flax_params, init_params_numpy

CAP = 2048
CFG = {
    "DATA": {"GRID_SIZE": [64, 64, 16]},
    "MODEL": {
        "NAME": "Cylinder_TS", "NUM_CLASS": 20, "IN_FEATURE_DIM": 9, "IGNORE_LABEL": 0,
        "INIT_SIZE": 4,
        "LOSS_CONFIG": {"LOSS_TYPES": ["CELoss", "LovLoss"], "LOSS_WEIGHTS": [1.0, 1.0]},
    },
    "OPTIM": {
        "OPTIMIZER": "sgd", "LR_PER_SAMPLE": 0.02, "WEIGHT_DECAY": 1e-4, "MOMENTUM": 0.9,
        "NESTEROV": True, "GRAD_NORM_CLIP": 10.0, "SCHEDULER": "linear_warmup_with_cosdecay",
        "WARMUP_EPOCH": 1,
    },
}
SCHED = dict(iters_per_epoch=2, total_epochs=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's thread team per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scans(seed=21, n=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pts, labels = synthetic_scan(rng, 700)
        out.append({"xyzret": np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1),
                    "labels": labels})
    return out


def _jax_step():
    caps = JCaps.for_points(CAP)
    criterion = JLosses(["CELoss", "LovLoss"], [1.0, 1.0], ignore_index=0, label_smoothing=0.0)
    tx = j_build_optimizer(
        {**CFG["OPTIM"], "LR": 0.02 * 2}, SCHED["iters_per_epoch"], SCHED["total_epochs"],
        clip_grad_norm=10.0,
    )
    mesh = make_mesh(jax.devices()[:1])
    step = make_train_step(
        JCylinderTS(num_classes=20, init_size=4), criterion, tx, caps, mesh, donate=False,
        topology_fn=lambda c, n: j_topology(c, n, caps),
    )
    params, stats = init_params_numpy(CFG, seed=4)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(
        params=params, batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
        opt_state=tx.init(params), step=jnp.int32(0),
    )
    # placed as the step's outputs are, so every step reuses one executable
    return step, jax.device_put(state, NamedSharding(mesh, PartitionSpec()))


@pytest.fixture(scope="module")
def f32_run():
    p, s = init_params_numpy(CFG, seed=4)
    tr = Trainer(CFG, {"params": p, "batch_stats": s}, device="cpu", batch_size=2, seed=9,
                 point_capacity=CAP, **SCHED)
    assert isinstance(tr.model, CylinderTS) and isinstance(tr.pipeline, CylinderPipeline)
    step, state = _jax_step()
    scans = _scans()
    got, want = [], []
    for i in range(3):
        a = tr.collate(scans)
        batch = Batch(
            point_coords=jnp.asarray(a["point_coords"][None]),
            point_feats=jnp.asarray(a["point_feats"][None]),
            labels=jnp.asarray(a["labels"][None]),
            num_points=jnp.asarray(a["num_points"].reshape(1, 1)),
        )
        state, metrics = step(state, batch, jax.random.fold_in(jax.random.PRNGKey(0), i))
        want.append({k: np.asarray(v) for k, v in metrics.items()})
        want[-1]["variables"] = jax.tree_util.tree_map(np.asarray, (state.params, state.batch_stats))
        got.append(tr.train_on(a))
        got[-1]["variables"] = export_flax_params(tr.model)
    return tr, got, want


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{pre}{k}/") if isinstance(v, dict) else {pre + k: np.asarray(v, np.float64)})
    return out


# per step: (grad norm rel, update L2 rel, BN statistics rel)
TOL = [(1e-4, 1e-3, 5e-4), (1e-4, 1e-3, 5e-4), (1e-3, 1e-2, 5e-4)]


def test_train_steps_match_jax_f32(f32_run):
    _, got, want = f32_run
    prev = _flat(init_params_numpy(CFG, seed=4)[0])
    for i, (g, w, (tol_norm, tol_upd, tol_bn)) in enumerate(zip(got, want, TOL)):
        assert np.isfinite(g["loss"]) and np.isfinite(g["grad_norm"])
        assert g["loss"] == pytest.approx(float(w["loss"]), rel=5e-5), i
        assert g["grad_norm"] == pytest.approx(float(w["grad_norm"]), rel=tol_norm), i
        assert g["level_nums"] == w["level_nums"].tolist()
        (p, s), (jp, js) = g["variables"], w["variables"]
        a, b = _flat(p), _flat(jp)
        assert a.keys() == b.keys()
        diff = np.sqrt(sum(np.sum((a[k] - b[k]) ** 2) for k in a))
        upd = np.sqrt(sum(np.sum((b[k] - prev[k]) ** 2) for k in a))
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


def test_every_part_trains(f32_run):
    """After 3 steps the weights of every part moved (the pre-net, the
    context and residual blocks, the pooling and transposed convs, the
    recon gate, the 3^3 head and its bias, the refinement head), and every
    BN's running statistics."""
    tr, got, _ = f32_run
    p0, s0 = init_params_numpy(CFG, seed=4)
    a0, a3 = _flat(p0), _flat(export_flax_params(tr.model)[0])
    for prefix in ("pp_fc0/", "fea_compression/", "downCntx/", "pool1/", "pool4/", "res5/",
                   "up0_deconv/", "up3_deconv/", "up3_res/", "ReconNet/", "logits/kernel",
                   "logits/bias", "change_dim/", "point_logits/"):
        moved = [k for k in a0 if k.startswith(prefix) and np.abs(a3[k] - a0[k]).max() > 1e-6]
        assert moved, prefix
    b0, b3 = _flat(s0), _flat(export_flax_params(tr.model)[1])
    assert all(np.abs(b3[k] - b0[k]).max() > 0 for k in b0)
    assert got[0]["lr"] == pytest.approx(0.04 * 1e-5)
    assert all(torch.isfinite(q).all() for q in tr.model.parameters())
