"""The port's train step against the JAX package's: the same collated
shards and the same weights through `Trainer.train_on` (CPU, plain
versions of every kernel) and through `make_train_step` on a one-device
CPU mesh, for 3 steps.

Tiny MinkUNet: cr 0.125, one block per stage, Dropout 0, 20 classes; two
~900-point synthetic scans per step in a 2048-row shard, augmented by the
port's training pipeline (each step draws new augmentations).  Warmup of
2 steps (iters_per_epoch 2, WARMUP_EPOCH 1), so steps 1 and 2 run at
LRs that move the parameters (step 0 runs at LR * 1e-5).

Tolerances (f32), measured values in brackets.  Step 0 (LR * 1e-5)
and the gradient of step 1 (from parameters that still agree to 1e-7)
are held tightly: loss within 5e-5 relative [<= 8e-6], grad norm within
1e-4 [<= 3.4e-5], every parameter after step 0 within 1e-6 of its scale
[8e-8], BN running statistics within 1e-4 of their scale [7e-6], and
the parameters' updates within 1e-2 of the update's L2 norm [1.6e-3].
Step 2 is ill-conditioned: in the port alone, a 1e-7 relative change of
the input features moves its grad norm by 7e-4 and single small
gradient tensors by 3% (ReLU and BN kinks, the Lovász sort), so there
the grad norm is held within 2e-2 [7.2e-3], the update within 1e-1 of
its norm [2.3e-2] and the BN statistics within 5e-3 [4.8e-4].  bf16:
the port's bf16 loss against JAX's f32 loss within 2e-2 relative
[3.3e-3] (the port rounds each conv once and d_W to bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taseg_tpu.loss import Losses as JLosses
from taseg_tpu.models import MinkUNet as JMinkUNet
from taseg_tpu.models import UNetCapacities as JCaps
from taseg_tpu.optim import build_optimizer as j_build_optimizer
from taseg_tpu.parallel import Batch, TrainState, make_mesh, make_train_step
from taseg_tpu_torch.data.synthetic import synthetic_scan
from taseg_tpu_torch.engine import Trainer
from taseg_tpu_torch.utils.params_from_jax import export_flax_params, init_params_numpy

CAP = 2048
STEPS = 3
CFG = {
    "DATA": {"VOXEL_SIZE": 0.05},
    "MODEL": {
        "NAME": "MinkUNet", "NUM_CLASS": 20, "IN_FEATURE_DIM": 4, "IGNORE_LABEL": 0,
        "BLOCK": "ResBlock", "cr": 0.125, "NUM_LAYER": [1] * 8,
        "PLANES": [32, 32, 64, 128, 256, 256, 128, 96, 96], "DROPOUT_P": 0.0,
        "LABEL_SMOOTHING": 0.1, "CAPACITY_SCHEDULE": (1.0,) * 5,
        "LOSS_CONFIG": {"LOSS_TYPES": ["CELoss", "LovLoss"], "LOSS_WEIGHTS": [1.0, 1.0]},
    },
    "OPTIM": {
        "OPTIMIZER": "sgd", "LR_PER_SAMPLE": 0.02, "WEIGHT_DECAY": 1e-4,
        "MOMENTUM": 0.9, "NESTEROV": True, "GRAD_NORM_CLIP": 10.0,
        "SCHEDULER": "linear_warmup_with_cosdecay", "WARMUP_EPOCH": 1,
    },
}
SCHED = dict(iters_per_epoch=2, total_epochs=3)


def _scans(seed=21, n=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pts, labels = synthetic_scan(rng, 900)
        ring = np.zeros((len(pts), 1), np.float32)
        out.append({"xyzret": np.concatenate([pts, ring], 1), "labels": labels})
    return out


def _trainer(dtype, cfg=CFG, **kw):
    params, stats = init_params_numpy(cfg, seed=4)
    return Trainer(
        cfg, {"params": params, "batch_stats": stats}, device="cpu",
        batch_size=2, seed=9, compute_dtype=dtype, point_capacity=CAP, **SCHED, **kw,
    )


def _jax_step(dtype, bn_momentum=0.1):
    m = CFG["MODEL"]
    model = JMinkUNet(
        num_classes=m["NUM_CLASS"], cr=m["cr"], num_layer=tuple(m["NUM_LAYER"]),
        block="ResBlock", dropout_p=0.0, compute_dtype=dtype, bn_momentum=bn_momentum,
    )
    criterion = JLosses(["CELoss", "LovLoss"], [1.0, 1.0], ignore_index=0, label_smoothing=0.1)
    tx = j_build_optimizer(
        {**CFG["OPTIM"], "LR": 0.02 * 2}, SCHED["iters_per_epoch"], SCHED["total_epochs"],
        clip_grad_norm=10.0,
    )
    caps = JCaps.for_points(CAP, schedule=m["CAPACITY_SCHEDULE"])
    step = make_train_step(
        model, criterion, tx, caps, make_mesh(jax.devices()[:1]), donate=False,
        topo_kwargs={"assume_sorted_points": True},
    )
    params, stats = init_params_numpy(CFG, seed=4)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(
        params=params, batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
        opt_state=tx.init(params), step=jnp.int32(0),
    )
    return step, state


def _batch(a):
    return Batch(
        point_coords=jnp.asarray(a["point_coords"][None]),
        point_feats=jnp.asarray(a["point_feats"][None]),
        labels=jnp.asarray(a["labels"][None]),
        num_points=jnp.asarray(a["num_points"].reshape(1, 1)),
    )


def _run_both(dtype):
    scans = _scans()
    tr = _trainer(dtype)
    step, state = _jax_step(dtype)
    key = jax.random.PRNGKey(0)
    got, want = [], []
    for i in range(STEPS):
        arrays = tr.collate(scans)
        state, metrics = step(state, _batch(arrays), jax.random.fold_in(key, i))
        want.append({k: np.asarray(v) for k, v in metrics.items()})
        want[-1]["variables"] = (state.params, state.batch_stats)
        got.append(tr.train_on(arrays))
        got[-1]["variables"] = export_flax_params(tr.model)
    return tr, state, got, want


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def f32_run():
    return _run_both("float32")


# per step: (grad norm rel, update L2 rel, BN statistics rel)
TOL = [(1e-4, 1e-2, 1e-4), (1e-4, 1e-2, 1e-4), (2e-2, 1e-1, 5e-3)]


def test_train_steps_match_jax_f32(f32_run):
    tr, state, got, want = f32_run
    prev = _flat(init_params_numpy(CFG, seed=4)[0])
    for i, (g, w, (tol_norm, tol_upd, tol_bn)) in enumerate(zip(got, want, TOL)):
        assert g["loss"] == pytest.approx(float(w["loss"]), rel=5e-5), i
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
    assert got[0]["lr"] == pytest.approx(0.04 * 1e-5)
    assert got[1]["lr"] == pytest.approx(0.04 * ((1 - 1e-5) / 2 + 1e-5), rel=1e-6)


def test_bn_momentum_from_the_config(f32_run):
    """`MODEL.BN_MOMENTUM` reaches every MaskedBatchNorm (as JAX's
    `build_model` passes it): after one f32 step at 0.005 the running
    means and vars match those of JAX's `make_train_step` with
    bn_momentum 0.005 within 1e-4 of their scale (step 0's tolerance
    above), and differ from the default 0.1 run's step 0."""
    from taseg_tpu_torch.models.layers import MaskedBatchNorm

    cfg = {**CFG, "MODEL": {**CFG["MODEL"], "BN_MOMENTUM": 0.005}}
    tr = _trainer("float32", cfg=cfg)
    bns = [m for m in tr.model.modules() if isinstance(m, MaskedBatchNorm)]
    assert bns and all(m.momentum == 0.005 for m in bns)
    step, state = _jax_step("float32", bn_momentum=0.005)
    arrays = tr.collate(_scans())
    state, _ = step(state, _batch(arrays), jax.random.fold_in(jax.random.PRNGKey(0), 0))
    tr.train_on(arrays)
    got, want = _flat(export_flax_params(tr.model)[1]), _flat(state.batch_stats)
    default = _flat(f32_run[2][0]["variables"][1])
    assert got.keys() == want.keys() == default.keys()
    init = _flat(init_params_numpy(CFG, seed=4)[1])
    for k in got:
        scale = max(np.abs(want[k]).max(), 1e-3)
        assert np.abs(got[k] - want[k]).max() <= 1e-4 * scale, k
        # the running statistics move from their start 20x less than at 0.1
        moved, moved_default = np.abs(got[k] - init[k]).max(), np.abs(default[k] - init[k]).max()
        assert moved == pytest.approx(moved_default / 20, rel=1e-2), k


def test_train_steps_move_the_parameters(f32_run):
    """Steps 1-2 change every conv kernel by far more than the tolerance
    above, so the comparison tests the update, not the initial weights."""
    tr, state, got, _ = f32_run
    p0, _ = init_params_numpy(CFG, seed=4)
    a, b = _flat(p0), _flat(export_flax_params(tr.model)[0])
    moved = [np.abs(b[k] - a[k]).max() / max(np.abs(a[k]).max(), 1e-3) for k in a if k.endswith("['kernel']")]
    assert min(moved) > 1e-3, min(moved)
    assert np.isfinite([g["loss"] for g in got]).all()


def test_train_steps_match_jax_bf16(f32_run):
    """The same shards (the same pipeline seed) in bf16 against JAX's f32
    step."""
    _, _, _, want = f32_run
    tr = _trainer("bfloat16")
    scans = _scans()
    for w in want:
        g = tr.train_on(tr.collate(scans))
        assert g["loss"] == pytest.approx(float(w["loss"]), rel=2e-2)
        assert np.isfinite(g["grad_norm"])
    assert all(torch.isfinite(p).all() for p in tr.model.parameters())


def test_trainer_step_end_to_end_cpu():
    """`Trainer.step` on reader dicts: finite loss and grad norm, the
    level counts, the warmup LR; DROPOUT_P > 0 and a level over capacity
    raise."""
    tr = _trainer("float32")
    scans = _scans(seed=3)
    out = [tr.step(scans) for _ in range(2)]
    for o in out:
        assert np.isfinite(o["loss"]) and np.isfinite(o["grad_norm"]) and o["grad_norm"] > 0
        assert len(o["level_nums"]) == 5 and o["level_nums"][0] > o["level_nums"][4] > 0
    assert out[0]["lr"] == pytest.approx(0.04 * 1e-5)
    assert all(torch.isfinite(p).all() for p in tr.model.parameters())
    params, stats = init_params_numpy(CFG, seed=4)
    variables = {"params": params, "batch_stats": stats}
    cfg = {**CFG, "MODEL": {**CFG["MODEL"], "DROPOUT_P": 0.3}}
    with pytest.raises(NotImplementedError, match="Dropout"):
        Trainer(cfg, variables, device="cpu", **SCHED)
    cfg = {**CFG, "MODEL": {**CFG["MODEL"], "CAPACITY_SCHEDULE": (1.0, 0.05)}}
    small = Trainer(cfg, variables, device="cpu", point_capacity=CAP, **SCHED)
    with pytest.raises(RuntimeError, match="capacity overflow"):
        small.step(scans[:1])


def test_trainer_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: device=None resolves to it")
    params, stats = init_params_numpy(CFG, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(CFG, {"params": params, "batch_stats": stats}, **SCHED)
