"""The port's other schedules and optimizers (`taseg_tpu_torch.optim`)
against the JAX package's optax chains, on the CPU.

Each schedule over a full cycle (every step of the run and a few past
it): `cos_warmup_with_cosdecay`, `linear_warmup_with_stepdecay`,
`coswarmup_with_stepdecay` (through `build_schedule`) and the fastai
one-cycle LR and momentum (`fastai_onecycle`), in float32 within 1e-6
relative (numpy's and XLA's float32 cos may differ by an ulp or two).
`sgd_fc`, `adam` and `adam_onecycle` over five steps from the same
parameters and gradients, with clipping on and off, against
`build_optimizer`'s optax chains: each parameter within 1e-6 of its
largest element (the two round the scheduled LR apart: the port takes
lr x schedule in double and rounds once, JAX in float32).  `sgd_fc`'s head is picked by the flax path (a leaf
under `classifier`), on the port's side through `head_parameters` of a
module whose parameter names are those paths.  About 12 s alone
(`--durations`), 13 s in the 6-worker tier-1 run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from taseg_tpu.optim import build_optimizer as j_build_optimizer
from taseg_tpu.optim import build_schedule as j_build_schedule
from taseg_tpu.optim import fastai_onecycle as j_onecycle
from taseg_tpu_torch import optim as to

ITERS, EPOCHS = 3, 4
BASE = {"LR": 0.3, "WEIGHT_DECAY": 1e-2, "MOMENTUM": 0.9, "NESTEROV": True, "WARMUP_EPOCH": 1}
SCHEDULES = {
    "cos_warmup_with_cosdecay": {},
    "linear_warmup_with_stepdecay": {"DECAY_EPOCHS": [2, 3], "DECAY_SCALES": [0.5, 0.1]},
    "coswarmup_with_stepdecay": {"DECAY_EPOCHS": [1, 3], "DECAY_SCALES": [0.3, 0.2]},
    "linear_warmup_with_cosdecay": {},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_over_a_full_cycle_matches_jax(name):
    cfg = {**BASE, "SCHEDULER": name, **SCHEDULES[name]}
    j = j_build_schedule(cfg, ITERS, EPOCHS)
    t = to.build_schedule(cfg, ITERS, EPOCHS)
    for s in range(ITERS * EPOCHS + 3):
        assert t(s) == pytest.approx(float(j(jnp.int32(s))), rel=1e-6, abs=1e-12), (name, s)


@pytest.mark.parametrize("pct", [0.4, 0.25])
def test_fastai_onecycle_matches_jax(pct):
    total = ITERS * EPOCHS
    jl, jm = j_onecycle(total, 0.01, (0.95, 0.85), 10.0, pct)
    tl_, tm = to.fastai_onecycle(total, 0.01, (0.95, 0.85), 10.0, pct)
    for s in range(total + 2):
        assert tl_(s) == pytest.approx(float(jl(jnp.int32(s))), rel=1e-6), s
        assert tm(s) == pytest.approx(float(jm(jnp.int32(s))), rel=1e-6), s
    assert tl_(0) == pytest.approx(0.001, rel=1e-6) and tm(0) == pytest.approx(0.95, rel=1e-6)


class _Net(nn.Module):
    """Parameters named as a flax tree: `stage/kernel`, `stage/bias` and
    the head `classifier/kernel`."""

    def __init__(self, params: dict):
        super().__init__()
        self.stage = nn.Module()
        self.classifier = nn.Module()
        for path, v in params.items():
            mod, leaf = path.split("/")
            setattr(getattr(self, mod), leaf, nn.Parameter(torch.from_numpy(v.copy())))


OPTIMIZERS = {
    "sgd_fc": {"SCHEDULER": "linear_warmup_with_cosdecay"},
    "adam": {"SCHEDULER": "coswarmup_with_stepdecay", "DECAY_EPOCHS": [1], "DECAY_SCALES": [0.5],
             "LR": 0.01},
    "adam_onecycle": {"LR": 0.01, "MOMS": (0.95, 0.85), "DIV_FACTOR": 10.0, "PCT_START": 0.4},
}


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_optax(name, max_norm):
    """5 steps from the same parameters and gradients: with max_norm 1
    every step clips, with 1e3 none does."""
    cfg = {**BASE, "OPTIMIZER": name, **OPTIMIZERS[name]}
    rng = np.random.default_rng(11)
    shapes = {"stage/kernel": (4, 3), "stage/bias": (3,), "classifier/kernel": (3, 5)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()} for _ in range(5)]

    def nest(flat):
        out: dict = {}
        for k, v in flat.items():
            mod, leaf = k.split("/")
            out.setdefault(mod, {})[leaf] = jnp.asarray(v)
        return out

    tx = j_build_optimizer(cfg, ITERS, EPOCHS, clip_grad_norm=max_norm)
    jp = nest(params)
    state = tx.init(jp)
    net = _Net(params)
    head = to.head_parameters(net)
    assert [id(p) for p in head] == [id(net.classifier.kernel)]
    opt = to.build_optimizer(list(net.parameters()), cfg, ITERS, EPOCHS, clip_grad_norm=max_norm, head=head)
    named = {n.replace(".", "/"): p for n, p in net.named_parameters()}
    for g in grads:
        upd, state = tx.update(nest(g), state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        for k, p in named.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in named.items():
            mod, leaf = k.split("/")
            want = np.asarray(jp[mod][leaf])
            assert np.abs(p.detach().numpy() - want).max() <= 1e-6 * np.abs(want).max(), k
    assert opt.count == 5
    # the state round-trips (a resumed run goes on where it stopped)
    fresh = to.build_optimizer(list(net.parameters()), cfg, ITERS, EPOCHS, clip_grad_norm=max_norm, head=head)
    fresh.load_state_dict(opt.state_dict())
    assert fresh.count == 5


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="SCHEDULER"):
        to.build_schedule({**BASE, "SCHEDULER": "nope"}, 1, 1)
    with pytest.raises(ValueError, match="OPTIMIZER"):
        to.build_optimizer([nn.Parameter(torch.zeros(2))], {**BASE, "OPTIMIZER": "nope"}, 1, 1)
