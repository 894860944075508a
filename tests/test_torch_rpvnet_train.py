"""RPVNet's train step in the port against JAX's `make_fusion_train_step`:
3 f32 steps on the `rpvnet_scene` configuration (batch 2, the port's
augmented shards fed to both), the dropout the identity on both sides
(patched in this test; the JAX package does not change).

The weights are `init_params_numpy`'s with the range convs' biases
drawn from N(0, 0.05) (`rpvnet_scene.with_conv_biases`): at the init's
zero biases the convs over the images' empty pixels are exactly 0, where
leaky_relu's derivative is discontinuous, and the step-0 grad norms of
JAX and the port differed by 1.1e-3 (6.8e-5 with the biases).

Tolerances per step, from measurement.  Steps 0 and 1 agree closely
(every leaf after step 0 within 5.6e-7 of its scale); from step 2 the
step is ill-conditioned beyond SPVCNN's: the range branch normalises
over a handful of pixels at 1/16 scale (1 x 4 per scan of a 16 x 64
image), and in the port alone a 1e-7 relative change of the input
features moves the grad norm by 5.2e-5, 4.2e-5 and 6.3e-2 and the update
by 1.3e-2, 9.9e-4 and 0.12 of its L2 norm at steps 0, 1 and 2.  Against
JAX (measured): loss 1.0e-5, 3.0e-6, 5.7e-3 relative; grad norm 6.8e-5,
1.4e-3, 0.23; update 1.4e-2, 7.4e-3, 0.36 of its norm; BN statistics
8.3e-5, 6.4e-5, 2.7e-2 of their scale.  See TOL.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch
import pytest
from jax.sharding import NamedSharding, PartitionSpec

import rpvnet_scene as S
from taseg_tpu.loss import Losses as JLosses
from taseg_tpu.models import UNetCapacities as JCaps
from taseg_tpu.optim import build_optimizer as j_build_optimizer
from taseg_tpu.parallel import TrainState, make_mesh
from taseg_tpu.parallel.fusion_step import make_fusion_train_step
from taseg_tpu_torch.engine import Trainer
from taseg_tpu_torch.models import RPVNet
from taseg_tpu_torch.models.layers import Dropout
from taseg_tpu_torch.utils.params_from_jax import export_flax_params, init_params_numpy

SCHED = dict(iters_per_epoch=2, total_epochs=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's thread team per process oversubscribes the cores
    (the range branch's many small convs then slow down tenfold)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{pre}{k}/") if isinstance(v, dict) else {pre + k: np.asarray(v, np.float64)})
    return out


def _init():
    p, s = init_params_numpy(S.CFG, seed=4)
    return S.with_conv_biases(p, seed=1), s


def _jax_step():
    criterion = JLosses(["CELoss", "LovLoss"], [1.0, 1.0], ignore_index=0, label_smoothing=0.0)
    tx = j_build_optimizer(
        {**S.CFG["OPTIM"], "LR": 0.02 * 2}, SCHED["iters_per_epoch"], SCHED["total_epochs"],
        clip_grad_norm=10.0,
    )
    mesh = make_mesh(jax.devices()[:1])
    caps = JCaps.for_points(S.CAP, schedule=S.SCHEDULE)
    step = make_fusion_train_step(S.jax_model(), criterion, tx, caps, mesh, donate=False)
    params, stats = _init()
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(
        params=params, batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
        opt_state=tx.init(params), step=jnp.int32(0),
    )
    # placed as the step's outputs are, so the second step reuses the
    # first one's executable
    return step, jax.device_put(state, NamedSharding(mesh, PartitionSpec()))


@pytest.fixture(scope="module")
def f32_run():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, deterministic=None, rng=None: x)
        mp.setattr(Dropout, "forward", lambda self, x: x)
        p, s = _init()
        tr = Trainer(
            S.CFG, {"params": p, "batch_stats": s}, device="cpu", batch_size=2, seed=9,
            compute_dtype="float32", point_capacity=S.CAP, **SCHED,
        )
        assert isinstance(tr.model, RPVNet)
        step, state = _jax_step()
        scans = S.scans()
        got, want = [], []
        for i in range(3):
            arrays = tr.collate(scans)
            batch = {k: arrays[k][None] for k in
                     ("point_coords", "point_feats", "labels", "range_image", "range_pxpy")}
            batch["num_points"] = arrays["num_points"].reshape(1, 1)
            state, metrics = step(
                state, S.fusion_batch(batch), jax.random.fold_in(jax.random.PRNGKey(0), i)
            )
            want.append({k: float(v) for k, v in metrics.items()})
            want[-1]["variables"] = jax.tree_util.tree_map(np.asarray, (state.params, state.batch_stats))
            got.append(tr.train_on(arrays))
            got[-1]["variables"] = export_flax_params(tr.model)
    return tr, got, want


# per step: (loss rel, grad norm rel, update L2 rel, BN statistics rel)
TOL = [(5e-5, 5e-4, 5e-2, 5e-4), (5e-5, 1e-2, 5e-2, 5e-4), (2e-2, 0.5, 1.0, 0.1)]


def test_train_steps_match_jax_f32(f32_run):
    tr, got, want = f32_run
    prev = _flat(_init()[0])
    for i, (g, w, (tol_loss, tol_norm, tol_upd, tol_bn)) in enumerate(zip(got, want, TOL)):
        assert np.isfinite(g["loss"]) and np.isfinite(g["grad_norm"])
        assert g["loss"] == pytest.approx(w["loss"], rel=tol_loss), i
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=tol_norm), i
        (p, s), (jp, js) = g["variables"], w["variables"]
        a, b = _flat(p), _flat(jp)
        assert a.keys() == b.keys()
        diff = np.sqrt(sum(np.sum((a[k] - b[k]) ** 2) for k in a))
        upd = np.sqrt(sum(np.sum((b[k] - prev[k]) ** 2) for k in a))
        assert diff <= tol_upd * upd, (i, diff, upd)
        if i == 0:
            for k in a:
                assert np.abs(a[k] - b[k]).max() <= 1e-5 * max(np.abs(b[k]).max(), 1e-3), k
        sa, sb = _flat(s), _flat(js)
        assert sa.keys() == sb.keys()
        for k in sa:
            err = np.abs(sa[k] - sb[k]).max()
            assert err <= tol_bn * max(np.abs(sb[k]).max(), 1e-3), (i, k, err)
        prev = b


def test_every_branch_trains(f32_run):
    """After 3 steps every branch's weights moved: the range branch's
    convs and flax BN running statistics, the point transforms, the voxel
    stages and the head."""
    tr, *_ = f32_run
    p0, s0 = _init()
    p3, s3 = export_flax_params(tr.model)
    a0, a3 = _flat(p0), _flat(p3)
    for prefix in ("range_stem/", "range_encoder/", "range_dec_top/", "range_dec_bottom/",
                   "pt0/", "pt3/", "v_stem0/", "up4_blocks_0/", "classifier/"):
        moved = [k for k in a0 if k.startswith(prefix) and np.abs(a3[k] - a0[k]).max() > 1e-6]
        assert moved, prefix
    b0, b3 = _flat(s0), _flat(s3)
    assert all(np.abs(b3[k] - b0[k]).max() > 0 for k in b0 if "BatchNorm_0" in k)
