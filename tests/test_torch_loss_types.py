"""The port's other loss types (`taseg_tpu_torch.loss`, `loss.eqlv2`)
against the JAX package, on the CPU.

Each of the eight loss types beyond CE and Lovász through `Losses`
(WCELoss, FocalLoss, DiceLossV0, DiceLossV1, ELLLoss with and without
class counts, EQLv2, GroupSoftmax, GroupSoftmax_fgbg_2) and `geo_loss`:
the value within 1e-6 relative and the gradient in the logits within
1e-5 of its largest, in f32 (the same formulas; the sums run in another
order), on 400 points of 20 classes from a seeded numpy generator.
EQLv2's statistics over three steps, each step's loss, gradient and
state against JAX's threaded `loss_state` (the state within 1e-6
relative); a 2-rank gloo process group (`torch_ddp_worker.py`) sums the
statistics as JAX's `psum` over a named axis (here `jax.vmap` with
`axis_name`) does, over three steps.  About 30 s alone (`--durations`),
~8 s of it the two ranks starting; 53 s in the 6-worker tier-1 run.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_ddp_worker
from taseg_tpu.loss import Losses as JLosses
from taseg_tpu.loss import eqlv2 as jeq
from taseg_tpu.loss import wce_weights as j_wce_weights
from taseg_tpu_torch import loss as tl
from taseg_tpu_torch.loss import eqlv2 as teq
from test_torch_loss import _close, _scene, _value_and_grad_jax, _value_and_grad_torch

N_CLS = 20
CLS_PTS = np.random.default_rng(3).integers(10, 10_000, N_CLS).astype(np.float64)
GROUPS = [[1, 2, 3, 4, 5], [6, 7, 8, 9, 10, 11, 12], [13, 14, 15, 16, 17, 18, 19]]
FG = [1, 2, 3, 4, 5, 6, 7, 8]
WAIT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(types, **kw):
    return (
        JLosses(types, [1.0] * len(types), ignore_index=0, **kw),
        tl.Losses(types, [1.0] * len(types), ignore_index=0, **kw),
    )


CASES = {
    "WCELoss": dict(cls_num_pts=CLS_PTS),
    "FocalLoss": {},
    "DiceLossV0": {},
    "DiceLossV1": {},
    "ELLLoss": {},
    "ELLLoss_counts": dict(cls_num_pts=CLS_PTS),
    "GroupSoftmax": dict(gs_groups=GROUPS),
    "GroupSoftmax_fgbg_2": dict(gs_groups=GROUPS, gs_fg_classes=FG),
    "mixed": dict(cls_num_pts=CLS_PTS, label_smoothing=0.1),
}
TYPES = {"ELLLoss_counts": ["ELLLoss"], "mixed": ["WCELoss", "FocalLoss", "DiceLossV1", "ELLLoss"]}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_type_matches_jax(case):
    logits, labels, valid = _scene(list(CASES).index(case), c=N_CLS)
    jl, tlo = _both(TYPES.get(case, [case]), **CASES[case])
    j = _value_and_grad_jax(jl, logits, labels, valid)
    t = _value_and_grad_torch(lambda x, l, v: tlo(x, l.long(), v), logits, labels, valid)
    _close(t, j)


def test_wce_needs_class_counts_and_weights_match():
    for normalize in (True, False):
        np.testing.assert_array_equal(
            tl.wce_weights(CLS_PTS, normalize=normalize), j_wce_weights(CLS_PTS, normalize=normalize)
        )
    logits, labels, valid = _scene(1, c=N_CLS)
    crit = tl.Losses(["WCELoss"], [1.0])
    with pytest.raises(AssertionError, match="cls_num_pts"):
        crit(torch.from_numpy(logits), torch.from_numpy(labels).long(), torch.from_numpy(valid))


@pytest.mark.parametrize("nsample,max_points", [(10, 4096), (6, 150)])
def test_geo_loss_matches_jax(nsample, max_points):
    logits, labels, valid = _scene(7, c=N_CLS)
    xyz = np.random.default_rng(8).normal(size=(len(labels), 3)).astype(np.float32)
    kw = dict(nsample=nsample, max_points=max_points)
    j = _value_and_grad_jax(lambda x, l, v, p: jeq.geo_loss(x, l, v, p, **kw), logits, labels, valid, xyz)
    t = _value_and_grad_torch(lambda x, l, v, p: teq.geo_loss(x, l, v, p, **kw), logits, labels, valid, xyz)
    _close(t, j)


def _eqlv2_scenes(n_steps=3, ranks=1):
    """(step, rank, N, C) logits and their labels and masks."""
    out = [[_scene(100 + 10 * i + r, n=200, c=N_CLS) for r in range(ranks)] for i in range(n_steps)]
    return tuple(np.stack([np.stack([s[k] for s in row]) for row in out]) for k in range(3))


def test_eqlv2_state_over_three_steps_matches_jax():
    """The loss, its gradient and the statistics at each of three steps,
    the state threaded through both (JAX `TrainState.loss_state`)."""
    logits, labels, valid = _eqlv2_scenes()
    jl, tlo = _both(["EQLv2"])
    js, ts = jl.init_state(N_CLS), tlo.init_state(N_CLS)
    assert ts.pos_grad.shape == (N_CLS - 1,) and not ts.pos_grad.any()
    for i in range(3):
        x, y, v = logits[i, 0], labels[i, 0], valid[i, 0]
        (jv, js_new), jg = jax.value_and_grad(
            lambda a: jl(a, jnp.asarray(y), jnp.asarray(v), js), has_aux=True
        )(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_()
        tv, ts_new = tlo(xt, torch.from_numpy(y).long(), torch.from_numpy(v), ts)
        (tg,) = torch.autograd.grad(tv, xt)
        _close((float(tv), tg.numpy()), (float(jv), np.asarray(jg)))
        for a, b in zip(ts_new, js_new):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
        js, ts = js_new, ts_new
    assert (ts.pos_grad > 0).all() and (ts.neg_grad > 0).all()


def test_eqlv2_two_rank_sum_matches_jax_psum(tmp_path):
    """Two gloo ranks, each on its own rows, with `dist`: every step's
    statistics are the sum over both ranks, as JAX's `psum` over the
    named axis of the two shards; each rank's loss is its own rows'."""
    logits, labels, valid = _eqlv2_scenes(ranks=2)
    spec = {"eqlv2": {"logits": logits, "labels": labels, "valid": valid}}
    ctx = mp.start_processes(
        torch_ddp_worker.run, args=(2, str(tmp_path), spec), nprocs=2, join=False,
        start_method="spawn",
    )
    jl = JLosses(["EQLv2"], [1.0], ignore_index=0, axis_name="data")

    def shard_step(x, y, v, st):
        return jl(x, y, v, st)

    step = jax.jit(jax.vmap(shard_step, in_axes=(0, 0, 0, None), out_axes=(0, None), axis_name="data"))
    state, want = jl.init_state(N_CLS), []
    for i in range(3):
        loss, state = step(jnp.asarray(logits[i]), jnp.asarray(labels[i]), jnp.asarray(valid[i]), state)
        want.append((np.asarray(loss), np.asarray(state.pos_grad), np.asarray(state.neg_grad)))
    deadline = time.monotonic() + WAIT_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"the 2 ranks did not finish within {WAIT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    outs = [torch.load(tmp_path / f"out_rank{r}.pt", weights_only=False)["eqlv2"] for r in range(2)]
    for i, (loss, pos, neg) in enumerate(want):
        for r in range(2):
            got_loss, got_pos, got_neg = outs[r][i]
            assert abs(got_loss - float(loss[r])) <= 1e-6 * abs(float(loss[r]))
            np.testing.assert_allclose(got_pos.numpy(), pos, rtol=1e-6, atol=0)
            np.testing.assert_allclose(got_neg.numpy(), neg, rtol=1e-6, atol=0)
        assert torch.equal(outs[0][i][1], outs[1][i][1]) and torch.equal(outs[0][i][2], outs[1][i][2])
