"""The range view's losses and its optimizer in the port against the JAX
package: `loss/range.py` (`salsanext_loss` = WCE + 3 x Lovász +
boundary, its terms, the class weights) and `optim` (adamW over the
onecycle schedule).

  * `salsanext_loss` and its gradient on random (2, 8, 16, 20) logits
    with a third of the pixels invalid, at top-k 1.0 and 0.5: loss within
    1e-5 relative, gradient within 1e-5 of its largest magnitude (f32
    sums in another order); `weighted_ce_image` and `boundary_loss` alone
    the same; the weights of `range_class_weights` equal.
  * `cosine_onecycle` against `optax.cosine_onecycle_schedule` (JAX's
    `build_schedule`) at every step of runs of 7, 50 and 1000 steps and
    past their end: within 2e-6 relative (numpy's and XLA's f32 cos);
    NaN where optax gives NaN (under 5 steps).
  * three adamW updates (the clip active in the second) of two
    parameters against the optax chain JAX builds: the grad norms and
    LRs equal to 1e-6, the parameters within 1e-6 of their scale.

~16 s in one process, 21 s in the 6-worker tier-1 run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from taseg_tpu.loss import range as jrange
from taseg_tpu.optim import build_optimizer as j_build_optimizer
from taseg_tpu.optim import build_schedule as j_build_schedule
from taseg_tpu_torch.loss import range as trange
from taseg_tpu_torch.optim import ClippedAdamW, build_optimizer, build_schedule, cosine_onecycle

C = 20
ADAMW = {"OPTIMIZER": "adamW", "WEIGHT_DECAY": 0.01, "SCHEDULER": "onecycle", "WARMUP_EPOCH": 10, "LR": 0.01,
         "LEARNING_RATE": 0.0025}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (2, 8, 16, C)).astype(np.float32)
    labels = rng.integers(0, C, (2, 8, 16)).astype(np.int32)
    labels[:, :2] = rng.integers(0, 3, (2, 2, 16))  # a few large regions
    valid = (rng.random((2, 8, 16)) < 0.67) & (labels != 0)
    return logits, labels, valid


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    assert np.abs(np.asarray(got, np.float64) - want).max() <= tol * max(np.abs(want).max(), 1e-6)


def test_class_weights_equal_jax():
    for ds in ("semantickitti", "synthetic", "nuscenes"):
        np.testing.assert_array_equal(trange.range_class_weights(ds, C), jrange.range_class_weights(ds, C))
    w = [0.5] * 17
    np.testing.assert_array_equal(trange.range_class_weights("x", 17, w), jrange.range_class_weights("x", 17, w))
    with pytest.raises(ValueError):
        trange.range_class_weights("x", 20, w)


@pytest.mark.parametrize("fn, top_k", [
    ("salsanext_loss", 1.0), ("salsanext_loss", 0.5), ("weighted_ce_image", 1.0),
    ("weighted_ce_image", 0.5), ("boundary_loss", 1.0),
])
def test_loss_and_gradient_match_jax(fn, top_k):
    logits, labels, valid = _inputs()
    cw = trange.range_class_weights("semantickitti", C)
    kw = {} if fn == "boundary_loss" else {"top_k_percent": top_k}

    def jloss(x):
        k = dict(kw, class_weight=jnp.asarray(cw)) if fn != "boundary_loss" else {}
        return getattr(jrange, fn)(x, jnp.asarray(labels), jnp.asarray(valid), **k)

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    k = dict(kw, class_weight=torch.from_numpy(cw)) if fn != "boundary_loss" else {}
    got = getattr(trange, fn)(x, torch.from_numpy(labels), torch.from_numpy(valid), **k)
    got.backward()
    assert got.dtype == torch.float32
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    _close(x.grad.numpy(), want_g, 1e-5)


@pytest.mark.parametrize("total", [3, 7, 50, 1000])
def test_onecycle_matches_optax(total):
    want = j_build_schedule(ADAMW, total, 1)
    got = build_schedule(ADAMW, total, 1)
    w = np.array([float(want(jnp.int32(i))) for i in range(total + 3)])
    g = np.array([got(i) for i in range(total + 3)])
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    ok = ~np.isnan(w)
    np.testing.assert_allclose(g[ok], w[ok], rtol=2e-6)
    if total >= 5:
        assert g[int(0.2 * total)] == pytest.approx(1.0) and g[0] == pytest.approx(1 / 25)
        assert g[-1] == pytest.approx(1 / 2500)
    assert cosine_onecycle(10)(2) == pytest.approx(1.0)


def test_adamw_updates_match_optax():
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,)]
    ps = [rng.normal(size=s).astype(np.float32) for s in shapes]
    cfg = ADAMW
    tx = j_build_optimizer(cfg, 10, 2, clip_grad_norm=1.0)
    jp = [jnp.asarray(p) for p in ps]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in ps]
    opt = build_optimizer(tp, cfg, 10, 2, clip_grad_norm=1.0)
    assert isinstance(opt, ClippedAdamW)
    want_lr = j_build_schedule(cfg, 10, 2)
    for it in range(3):
        gs = [rng.normal(size=s).astype(np.float32) * (3.0 if it == 1 else 0.1) for s in shapes]
        u, state = tx.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, u)
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g)
        g_norm, lr = opt.step()
        assert float(g_norm) == pytest.approx(float(optax.global_norm(gs)), rel=1e-6)
        assert lr == pytest.approx(cfg["LR"] * float(want_lr(jnp.int32(it))), rel=1e-6)
        for a, b in zip(jp, tp):
            _close(b.detach().numpy(), a, 1e-6)
    assert opt.state_dict()["count"] == 3
