"""Optimizers and LR schedules (port of `taseg_tpu/optim/__init__.py`:
the optax chains that `build_optimizer` returns, `sgd`, `sgd_fc`,
`adam`, `adamW` and `adam_onecycle`, and its five schedules), in plain
torch.  `sgd`:

    clip_by_global_norm(max_norm)     scale by max_norm / |g| only when
                                      |g| >= max_norm (optax; unlike
                                      clip_grad_norm_, no 1e-6 term)
    add_decayed_weights(wd)           g + wd * p
    trace(momentum, nesterov)         m' = g + mu m; u = g + mu m' (Nesterov)
    scale_by_learning_rate(schedule)  u * -(lr * schedule(count)),
                                      count taken before its increment

so step 0 runs at lr * 1e-5 under the linear warmup.  `sgd_fc` is `sgd`
with 10x the LR on every parameter whose flax path names `classifier`
(`head_parameters`; optax's `multi_transform` over JAX's labels).
`adamW` (the range recipes'):

    clip_by_global_norm(max_norm)
    scale_by_adam(0.9, 0.999, 1e-8)   m' = 0.1 g + 0.9 m, v' = 0.001 g^2 +
                                      0.999 v, u = m'/(1 - 0.9^t) /
                                      (sqrt(v'/(1 - 0.999^t)) + 1e-8), t
                                      the update's number from 1
    add_decayed_weights(wd)           u + wd * p (decoupled: after Adam)
    scale_by_learning_rate(schedule)

`adam` adds the weight decay to the gradient first (`add_decayed_weights`
then `optax.adam`: b1 0.9, b2 0.999, eps 1e-8) and decays nothing after;
`adam_onecycle` is that chain with the LR and b1 of each update from the
fastai one-cycle schedules (`fastai_onecycle`: OPTIM.MOMS, DIV_FACTOR,
PCT_START; `inject_hyperparams`) and b2 0.99.  The clip by the global
norm comes first in every chain (`_ClippedChain`).

The schedules are computed in float32, as JAX computes them.  Parameters given as `frozen`
(a staged recipe's, `utils.param_groups`) sit outside the chain, as
JAX's `freeze_except` puts them (`optax.multi_transform` with
`set_to_zero`): the clip's norm covers the others only, and the frozen
ones get no update and no trace.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch


def linear_warmup_with_cosdecay(
    warmup_steps: int, total_steps: int, min_scale: float = 1e-5
) -> Callable[[int], float]:
    """JAX optim/__init__.py:20, in float32."""
    f32 = np.float32

    def f(step: int) -> float:
        s = f32(step)
        if step < warmup_steps:
            return float(f32(1 - min_scale) * s / f32(max(warmup_steps, 1)) + f32(min_scale))
        ratio = (s - f32(warmup_steps)) / f32(max(total_steps, 1))
        cos = f32(np.cos(f32(math.pi) * ratio))
        return float(f32(1 - min_scale) * f32(0.5) * (f32(1) + cos) + f32(min_scale))

    return f


def cos_warmup_with_cosdecay(
    warmup_steps: int, total_steps: int, min_scale: float = 1e-5
) -> Callable[[int], float]:
    """JAX optim/__init__.py:34, in float32: a cosine warmup, then the
    cosine decay of `linear_warmup_with_cosdecay`."""
    f32 = np.float32
    decay = linear_warmup_with_cosdecay(warmup_steps, total_steps, min_scale)

    def f(step: int) -> float:
        if step < warmup_steps:
            cos = f32(np.cos(f32(math.pi) * f32(step) / f32(max(warmup_steps, 1))))
            return float(f32(1 - min_scale) * (f32(1) - cos) / f32(2) + f32(min_scale))
        return decay(step)

    return f


def _step_scale(step: int, decay_steps, decay_scales) -> np.float32:
    scale = np.float32(1.0)
    for ds, sc in zip(decay_steps, decay_scales):
        scale = scale * np.float32(sc if step >= ds else 1.0)
    return scale


def linear_warmup_with_stepdecay(
    warmup_steps: int, decay_steps: list, decay_scales: list
) -> Callable[[int], float]:
    """JAX :53, in float32: step / warmup during the warmup, then the
    product of the scales of the decay steps passed."""
    f32 = np.float32

    def f(step: int) -> float:
        if step < warmup_steps:
            return float(f32(step) / f32(max(warmup_steps, 1)))
        return float(_step_scale(step, decay_steps, decay_scales))

    return f


def coswarmup_with_stepdecay(
    warmup_steps: int, decay_steps: list, decay_scales: list
) -> Callable[[int], float]:
    """JAX :68, in float32: (1 - cos(pi step / warmup)) / 2 during the
    warmup, then the step decay."""
    f32 = np.float32

    def f(step: int) -> float:
        if step < warmup_steps:
            cos = f32(np.cos(f32(math.pi) * f32(step) / f32(max(warmup_steps, 1))))
            return float((f32(1) - cos) / f32(2))
        return float(_step_scale(step, decay_steps, decay_scales))

    return f


def _annealing_cos(start: float, end: float, pct: np.float32) -> np.float32:
    """end + (start - end) / 2 (cos(pi pct) + 1), in float32 as JAX's."""
    f32 = np.float32
    cos = f32(np.cos(f32(math.pi) * pct))
    return f32(end) + f32((start - end) / 2) * (cos + f32(1))


def fastai_onecycle(total_steps: int, lr_max: float, moms, div_factor: float, pct_start: float):
    """fastai's one-cycle LR and momentum schedules (JAX :89; reference
    `learning_schedules_fastai.py:60-78`), in float32: the LR anneals by
    cosine from lr_max / div_factor up to lr_max over pct_start of the
    steps, then down to lr_max / div_factor / 1e4; the momentum from
    moms[0] to moms[1] and back.  Returns (lr_fn, mom_fn) of the step."""
    a1 = max(int(total_steps * pct_start), 1)
    a2 = max(total_steps - a1, 1)
    low = lr_max / div_factor
    f32 = np.float32

    def lr_fn(step: int) -> float:
        if step < a1:
            return float(_annealing_cos(low, lr_max, f32(step) / f32(a1)))
        return float(_annealing_cos(lr_max, low / 1e4, f32(step - a1) / f32(a2)))

    def mom_fn(step: int) -> float:
        if step < a1:
            return float(_annealing_cos(moms[0], moms[1], f32(step) / f32(a1)))
        return float(_annealing_cos(moms[1], moms[0], f32(step - a1) / f32(a2)))

    return lr_fn, mom_fn


def cosine_onecycle(
    total_steps: int, peak: float = 1.0, pct_start: float = 0.2, div_factor: float = 25.0,
    final_div_factor: float = 100.0,
) -> Callable[[int], float]:
    """`optax.cosine_onecycle_schedule` (its piecewise cosine
    interpolation), in float32: from peak / div_factor up to peak over
    the first int(pct_start * total_steps) steps, down to peak /
    (div_factor * final_div_factor) at total_steps, constant after.  As
    in optax, a phase of zero steps gives NaN (fewer than 5 steps at
    pct_start 0.2)."""
    if total_steps <= 0:
        raise ValueError(f"onecycle over {total_steps} steps")
    f32 = np.float32
    bounds = np.array([0, int(pct_start * total_steps), int(total_steps)])
    values = np.cumprod([peak / div_factor, div_factor, 1.0 / (div_factor * final_div_factor)])
    half = ((values[:-1] - values[1:]) / 2).astype(f32)
    ends = values[1:].astype(f32)
    sizes = (bounds[1:] - bounds[:-1]).astype(f32)

    def f(step: int) -> float:
        inside = (bounds[:-1] <= step) & (step < bounds[1:])
        with np.errstate(divide="ignore", invalid="ignore"):
            pct = (step - bounds[:-1]).astype(f32) / sizes
            interp = ends + half * (np.cos(f32(math.pi) * pct) + f32(1))
            val = np.dot(inside.astype(f32), interp)
        return float(val + f32(bounds[-1] <= step) * f32(values[-1]))

    return f


def build_schedule(optim_cfg: dict, iters_per_epoch: int, total_epochs: int):
    """Step -> LR-scale schedule of an OPTIM block (JAX :118): SCHEDULER
    `linear_warmup_with_cosdecay` (the default) or `cos_warmup_with_
    cosdecay` over WARMUP_EPOCH and the whole run, `linear_warmup_with_
    stepdecay` or `coswarmup_with_stepdecay` with DECAY_EPOCHS and
    DECAY_SCALES, or `onecycle` over the whole run (JAX ignores
    WARMUP_EPOCH and LEARNING_RATE there)."""
    name = optim_cfg.get("SCHEDULER", "linear_warmup_with_cosdecay")
    total_steps = total_epochs * iters_per_epoch
    if name == "onecycle":
        return cosine_onecycle(total_steps)
    warmup_steps = int(optim_cfg.get("WARMUP_EPOCH", 1)) * iters_per_epoch
    if name == "linear_warmup_with_cosdecay":
        return linear_warmup_with_cosdecay(warmup_steps, total_steps)
    if name == "cos_warmup_with_cosdecay":
        return cos_warmup_with_cosdecay(warmup_steps, total_steps)
    if name in ("linear_warmup_with_stepdecay", "coswarmup_with_stepdecay"):
        decay_steps = [int(x) * iters_per_epoch for x in optim_cfg["DECAY_EPOCHS"]]
        scales = list(optim_cfg["DECAY_SCALES"])
        if len(scales) != len(decay_steps):
            raise ValueError("one DECAY_SCALES entry per DECAY_EPOCHS entry")
        fn = linear_warmup_with_stepdecay if name.startswith("linear") else coswarmup_with_stepdecay
        return fn(warmup_steps, decay_steps, scales)
    raise ValueError(f"SCHEDULER {name!r} is not one of JAX's")


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


class _ClippedChain(torch.optim.Optimizer):
    """What the chains share: one group of parameters, the clip by the
    global norm first, the schedule's position `count`, which travels in
    `state_dict()` beside the optimizer's traces so a resumed run goes on
    where it stopped (optax keeps it in the chain's state), and the
    `frozen` parameters outside the chain."""

    def __init__(self, params, defaults: dict, schedule: Callable[[int], float], frozen=()):
        super().__init__(params, defaults)
        self.schedule = schedule
        self.count = 0
        self.frozen = {id(p) for p in frozen}

    def state_dict(self) -> dict:
        return {**super().state_dict(), "count": self.count}

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)
        self.count = count

    def _clipped(self, closure):
        """(group, [(parameter, its clipped gradient)] of the parameters
        in the chain, the unclipped global norm of every gradient, the
        frozen ones' included, the LR of this update)."""
        if closure is not None:
            raise ValueError(f"{type(self).__name__} takes no closure")
        (group,) = self.param_groups
        params = [p for p in group["params"] if p.grad is not None]
        g_norm = global_norm([p.grad for p in params])
        if self.frozen:
            params = [p for p in params if id(p) not in self.frozen]
            c_norm = global_norm([p.grad for p in params])
        else:
            c_norm = g_norm
        clip = bool(c_norm >= group["max_norm"])
        grads = [(p.grad / c_norm) * group["max_norm"] if clip else p.grad for p in params]
        return group, list(zip(params, grads)), g_norm, group["lr"] * self.schedule(self.count)


class ClippedSGD(_ClippedChain):
    """The `sgd` chain, and `sgd_fc`'s where `head` names parameters
    (their LR 10x the schedule's, JAX :170-194).  `step()` reads
    `p.grad`, updates the parameters and the momentum traces in place,
    and returns (the unclipped global norm, as JAX's `grad_norm` metric;
    the LR it applied to the others)."""

    def __init__(
        self, params, *, lr: float, schedule: Callable[[int], float],
        momentum: float = 0.9, nesterov: bool = False, weight_decay: float = 0.0,
        max_norm: float = 10.0, frozen=(), head=(),
    ):
        defaults = dict(
            lr=lr, momentum=momentum, nesterov=nesterov, weight_decay=weight_decay,
            max_norm=max_norm,
        )
        super().__init__(params, defaults, schedule, frozen)
        self.head = {id(p) for p in head}

    @torch.no_grad()
    def step(self, closure=None):
        group, pairs, g_norm, lr_t = self._clipped(closure)
        mu, wd = group["momentum"], group["weight_decay"]
        lr_head = float(np.float32(10.0) * np.float32(lr_t))  # JAX: 10.0 * lr_schedule(s)
        for p, g in pairs:
            if wd:
                g = g + wd * p
            st = self.state[p]
            trace = st.get("trace")
            if trace is None:
                trace = st["trace"] = torch.zeros_like(p)
            trace.copy_(g + mu * trace)
            u = g + mu * trace if group["nesterov"] else trace
            lr_p = lr_head if id(p) in self.head else lr_t
            p.add_(u * torch.tensor(-lr_p, dtype=p.dtype, device=p.device))
        self.count += 1
        return g_norm, lr_t


class ClippedAdam(_ClippedChain):
    """The Adam chains.  `decoupled` (`adamW`, `optax.adamw`): Adam's
    scaling, then + weight_decay x p; else (`adam`, `adam_onecycle`) the
    weight decay is added to the gradient first (`add_decayed_weights`
    before `optax.adam`).  `b1_schedule` (adam_onecycle's momentum
    schedule, float32) gives b1 for each update in place of `b1`, as
    optax's `inject_hyperparams` does (the moments and the bias
    correction take that update's b1).  `step()` updates the parameters
    and the moments `mu`, `nu` in place and returns (the unclipped
    global norm, the LR it applied)."""

    def __init__(
        self, params, *, lr: float, schedule: Callable[[int], float], b1: float = 0.9,
        b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
        max_norm: float = 10.0, frozen=(), decoupled: bool = True,
        b1_schedule: Callable[[int], float] = None,
    ):
        defaults = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, max_norm=max_norm)
        super().__init__(params, defaults, schedule, frozen)
        self.decoupled = decoupled
        self.b1_schedule = b1_schedule

    @torch.no_grad()
    def step(self, closure=None):
        group, pairs, g_norm, lr_t = self._clipped(closure)
        b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
        one_b1 = 1 - b1
        if self.b1_schedule is not None:  # an f32 hyperparameter, as optax injects it
            b1_32 = np.float32(self.b1_schedule(self.count))
            b1, one_b1 = float(b1_32), float(np.float32(1) - b1_32)
        t = np.float32(self.count + 1)
        # optax's bias corrections, in float32
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        for p, g in pairs:
            if wd and not self.decoupled:
                g = g + wd * p
            st = self.state[p]
            if "mu" not in st:
                st["mu"], st["nu"] = torch.zeros_like(p), torch.zeros_like(p)
            mu, nu = st["mu"], st["nu"]
            mu.copy_(one_b1 * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            if wd and self.decoupled:
                u = u + wd * p
            p.add_(u * torch.tensor(-lr_t, dtype=p.dtype, device=p.device))
        self.count += 1
        return g_norm, lr_t


class ClippedAdamW(ClippedAdam):
    """The `adamW` chain (`optax.adamw`: b1 0.9, b2 0.999, eps 1e-8, the
    weight decay on every parameter after Adam's scaling)."""

    def __init__(self, params, **kw):
        super().__init__(params, decoupled=True, **kw)


def head_parameters(model: torch.nn.Module) -> list:
    """The parameters that `sgd_fc` steps at 10x the LR: those whose flax
    path has an element naming `classifier` (JAX labels a leaf "head"
    where any path element contains it, :181-188; the port's parameter
    names are the flax paths joined by dots)."""
    return [p for n, p in model.named_parameters() if any("classifier" in e for e in n.split("."))]


def build_optimizer(
    params, optim_cfg: dict, iters_per_epoch: int, total_epochs: int,
    *, clip_grad_norm: float = 10.0, frozen=(), head=(),
) -> _ClippedChain:
    """The optimizer of an OPTIM block (JAX :151), `frozen` parameters
    held still: `sgd` and `sgd_fc` (LR, WEIGHT_DECAY, MOMENTUM,
    NESTEROV; `sgd_fc` steps `head`, `head_parameters(model)`, at 10x the
    LR), `adam` and `adamW` (LR, WEIGHT_DECAY) on the SCHEDULER's
    schedule, or `adam_onecycle` (LR, WEIGHT_DECAY, MOMS, DIV_FACTOR,
    PCT_START; its own one-cycle schedules over the whole run, b2 0.99)."""
    name = optim_cfg.get("OPTIMIZER", "sgd")
    lr = float(optim_cfg["LR"])
    wd = float(optim_cfg.get("WEIGHT_DECAY", 0.0))
    common = dict(weight_decay=wd, max_norm=clip_grad_norm, frozen=frozen)
    if name == "adam_onecycle":
        moms = tuple(float(m) for m in optim_cfg.get("MOMS", (0.95, 0.85)))
        lr_fn, mom_fn = fastai_onecycle(
            max(iters_per_epoch * total_epochs, 1), lr, moms,
            float(optim_cfg.get("DIV_FACTOR", 10.0)), float(optim_cfg.get("PCT_START", 0.4)),
        )
        return ClippedAdam(
            params, lr=1.0, schedule=lr_fn, b2=0.99, decoupled=False, b1_schedule=mom_fn, **common,
        )
    schedule = build_schedule(optim_cfg, iters_per_epoch, total_epochs)
    if name == "adamW":
        return ClippedAdamW(params, lr=lr, schedule=schedule, **common)
    if name == "adam":
        return ClippedAdam(params, lr=lr, schedule=schedule, decoupled=False, **common)
    if name not in ("sgd", "sgd_fc"):
        raise ValueError(f"OPTIMIZER {name!r} is not one of JAX's")
    return ClippedSGD(
        params, lr=lr, schedule=schedule, momentum=float(optim_cfg.get("MOMENTUM", 0.9)),
        nesterov=bool(optim_cfg.get("NESTEROV", False)), head=head if name == "sgd_fc" else (),
        **common,
    )
