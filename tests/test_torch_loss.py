"""The port's losses, schedule and optimizer against the JAX package.

CE with label smoothing and an ignored class, Lovász-softmax and their
sum (`Losses`): values within 1e-6 relative and gradients within 1e-5
of their scale, in f32 (the same formulas; the sums run in another
order).  The warmup-cosine
schedule against JAX's in float32 (1e-6 relative: the two cos differ by
an ulp or two), and `ClippedSGD` against the optax
chain of `build_optimizer` (clip by global norm, weight decay, Nesterov
trace, scheduled LR) over 5 steps, with clipping on and off: parameters
within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taseg_tpu.loss import Losses as JLosses
from taseg_tpu.loss import cross_entropy as j_ce
from taseg_tpu.loss import lovasz_softmax as j_lovasz
from taseg_tpu.optim import build_optimizer as j_build_optimizer
from taseg_tpu.optim import build_schedule as j_build_schedule
from taseg_tpu_torch import loss as tl
from taseg_tpu_torch import optim as to


def _scene(seed=0, n=400, c=20):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, size=(n, c)).astype(np.float32)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    labels[rng.random(n) < 0.3] = rng.integers(0, 4)  # a few frequent classes
    valid = rng.random(n) < 0.9
    return logits, labels, valid


def _value_and_grad_jax(fn, logits, *args):
    v, g = jax.value_and_grad(lambda x: fn(x, *(jnp.asarray(a) for a in args)))(jnp.asarray(logits))
    return float(v), np.asarray(g)


def _value_and_grad_torch(fn, logits, *args):
    x = torch.from_numpy(logits).requires_grad_()
    v = fn(x, *(torch.from_numpy(a) for a in args))
    (g,) = torch.autograd.grad(v, x)
    return float(v.detach()), g.numpy()


def _close(a, b):
    (va, ga), (vb, gb) = a, b
    assert abs(va - vb) <= 1e-6 * max(abs(vb), 1.0), (va, vb)
    assert np.abs(ga - gb).max() <= 1e-5 * np.abs(gb).max(), np.abs(ga - gb).max()


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    logits, labels, valid = _scene(1)
    valid = valid & (labels != 0)
    j = _value_and_grad_jax(lambda x, l, v: j_ce(x, l, v, label_smoothing=smoothing), logits, labels, valid)
    t = _value_and_grad_torch(lambda x, l, v: tl.cross_entropy(x, l.long(), v, label_smoothing=smoothing), logits, labels, valid)
    _close(t, j)


@pytest.mark.parametrize("seed", [2, 3])
def test_lovasz_matches_jax(seed):
    logits, labels, valid = _scene(seed)
    j = _value_and_grad_jax(j_lovasz, logits, labels, valid)
    t = _value_and_grad_torch(lambda x, l, v: tl.lovasz_softmax(x, l.long(), v), logits, labels, valid)
    _close(t, j)


def test_losses_combinator_matches_jax():
    """CE (smoothing 0.1) + Lovász with ignore class 0, and padding rows
    masked by point_valid."""
    logits, labels, valid = _scene(4)
    jl = JLosses(["CELoss", "LovLoss"], [1.0, 1.0], ignore_index=0, label_smoothing=0.1)
    tlo = tl.Losses(["CELoss", "LovLoss"], [1.0, 1.0], ignore_index=0, label_smoothing=0.1)
    j = _value_and_grad_jax(jl, logits, labels, valid)
    t = _value_and_grad_torch(lambda x, l, v: tlo(x, l.long(), v), logits, labels, valid)
    _close(t, j)
    with pytest.raises(NotImplementedError):
        tl.Losses(["CELoss", "FocalLoss"], [1.0, 1.0])


def test_permute_rows_gradient_is_the_inverse_gather():
    x = torch.randn(6, 3, dtype=torch.float64, requires_grad=True)
    perm = torch.argsort(torch.randn(6, 3), dim=0)
    inv = torch.argsort(perm, dim=0)
    y = tl.util.permute_rows(x, perm, inv)
    assert torch.equal(y, torch.take_along_dim(x, perm, 0))
    torch.autograd.gradcheck(lambda a: tl.util.permute_rows(a, perm, inv), (x,))


OPTIM = {
    "OPTIMIZER": "sgd", "LR": 0.3, "WEIGHT_DECAY": 1e-2, "MOMENTUM": 0.9,
    "NESTEROV": True, "SCHEDULER": "linear_warmup_with_cosdecay", "WARMUP_EPOCH": 1,
}


def test_schedule_matches_jax():
    j = j_build_schedule(OPTIM, iters_per_epoch=3, total_epochs=5)
    t = to.build_schedule(OPTIM, iters_per_epoch=3, total_epochs=5)
    for s in range(20):
        # float32 cos of numpy and XLA may differ by an ulp or two
        assert t(s) == pytest.approx(float(j(jnp.int32(s))), rel=1e-6, abs=1e-12), s
    assert t(0) == pytest.approx(1e-5)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clipped_sgd_matches_optax(max_norm):
    """5 steps from the same parameters and gradients: with max_norm 1
    every step clips, with 1e3 none does."""
    rng = np.random.default_rng(7)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()} for _ in range(5)]

    tx = j_build_optimizer(OPTIM, iters_per_epoch=2, total_epochs=3, clip_grad_norm=max_norm)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    opt = to.build_optimizer(list(tp.values()), OPTIM, 2, 3, clip_grad_norm=max_norm)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        g_norm, lr = opt.step()
        want_norm = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in g.values()))
        assert float(g_norm) == pytest.approx(want_norm, rel=1e-6)
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
    assert opt.count == 5
    assert lr == pytest.approx(0.3 * to.build_schedule(OPTIM, 2, 3)(4))
