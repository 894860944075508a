"""Optimizers and LR schedules (port of the `sgd` and `adamW` branches
of `taseg_tpu/optim/__init__.py`, the optax chains that `build_optimizer`
returns, and of its `linear_warmup_with_cosdecay` and `onecycle`
schedules), in plain torch.  `sgd`:

    clip_by_global_norm(max_norm)     scale by max_norm / |g| only when
                                      |g| >= max_norm (optax; unlike
                                      clip_grad_norm_, no 1e-6 term)
    add_decayed_weights(wd)           g + wd * p
    trace(momentum, nesterov)         m' = g + mu m; u = g + mu m' (Nesterov)
    scale_by_learning_rate(schedule)  u * -(lr * schedule(count)),
                                      count taken before its increment

so step 0 runs at lr * 1e-5 under the linear warmup.  `adamW` (the
range recipes'):

    clip_by_global_norm(max_norm)
    scale_by_adam(0.9, 0.999, 1e-8)   m' = 0.1 g + 0.9 m, v' = 0.001 g^2 +
                                      0.999 v, u = m'/(1 - 0.9^t) /
                                      (sqrt(v'/(1 - 0.999^t)) + 1e-8), t
                                      the update's number from 1
    add_decayed_weights(wd)           u + wd * p (decoupled: after Adam)
    scale_by_learning_rate(schedule)

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
    """Step -> LR-scale schedule of an OPTIM block (JAX :118):
    `linear_warmup_with_cosdecay` over WARMUP_EPOCH, or `onecycle` over
    the whole run (JAX ignores WARMUP_EPOCH and LEARNING_RATE there)."""
    name = optim_cfg.get("SCHEDULER", "linear_warmup_with_cosdecay")
    total_steps = total_epochs * iters_per_epoch
    if name == "onecycle":
        return cosine_onecycle(total_steps)
    if name != "linear_warmup_with_cosdecay":
        raise NotImplementedError(f"SCHEDULER {name} is not ported yet (ROADMAP Queue 1 item 6)")
    warmup_steps = int(optim_cfg.get("WARMUP_EPOCH", 1)) * iters_per_epoch
    return linear_warmup_with_cosdecay(warmup_steps, total_steps)


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
    """The `sgd` chain.  `step()` reads `p.grad`, updates the parameters
    and the momentum traces in place, and returns (the unclipped global
    norm, as JAX's `grad_norm` metric; the LR it applied)."""

    def __init__(
        self, params, *, lr: float, schedule: Callable[[int], float],
        momentum: float = 0.9, nesterov: bool = False, weight_decay: float = 0.0,
        max_norm: float = 10.0, frozen=(),
    ):
        defaults = dict(
            lr=lr, momentum=momentum, nesterov=nesterov, weight_decay=weight_decay,
            max_norm=max_norm,
        )
        super().__init__(params, defaults, schedule, frozen)

    @torch.no_grad()
    def step(self, closure=None):
        group, pairs, g_norm, lr_t = self._clipped(closure)
        mu, wd = group["momentum"], group["weight_decay"]
        for p, g in pairs:
            if wd:
                g = g + wd * p
            st = self.state[p]
            trace = st.get("trace")
            if trace is None:
                trace = st["trace"] = torch.zeros_like(p)
            trace.copy_(g + mu * trace)
            u = g + mu * trace if group["nesterov"] else trace
            p.add_(u * torch.tensor(-lr_t, dtype=p.dtype, device=p.device))
        self.count += 1
        return g_norm, lr_t


class ClippedAdamW(_ClippedChain):
    """The `adamW` chain (`optax.adamw`: b1 0.9, b2 0.999, eps 1e-8, the
    weight decay on every parameter after Adam's scaling).  `step()`
    updates the parameters and the moments `mu`, `nu` in place and
    returns (the unclipped global norm, the LR it applied)."""

    def __init__(
        self, params, *, lr: float, schedule: Callable[[int], float], b1: float = 0.9,
        b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
        max_norm: float = 10.0, frozen=(),
    ):
        defaults = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, max_norm=max_norm)
        super().__init__(params, defaults, schedule, frozen)

    @torch.no_grad()
    def step(self, closure=None):
        group, pairs, g_norm, lr_t = self._clipped(closure)
        b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
        t = np.float32(self.count + 1)
        # optax's bias corrections, in float32
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        for p, g in pairs:
            st = self.state[p]
            if "mu" not in st:
                st["mu"], st["nu"] = torch.zeros_like(p), torch.zeros_like(p)
            mu, nu = st["mu"], st["nu"]
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps) + wd * p
            p.add_(u * torch.tensor(-lr_t, dtype=p.dtype, device=p.device))
        self.count += 1
        return g_norm, lr_t


def build_optimizer(
    params, optim_cfg: dict, iters_per_epoch: int, total_epochs: int,
    *, clip_grad_norm: float = 10.0, frozen=(),
) -> _ClippedChain:
    """The `sgd` (LR, WEIGHT_DECAY, MOMENTUM, NESTEROV) or `adamW` (LR,
    WEIGHT_DECAY) optimizer of an OPTIM block on its SCHEDULER's schedule
    (JAX :151), `frozen` parameters held still.  JAX's other optimizers
    (sgd_fc, adam, adam_onecycle) raise."""
    name = optim_cfg.get("OPTIMIZER", "sgd")
    kw = dict(
        lr=float(optim_cfg["LR"]),
        schedule=build_schedule(optim_cfg, iters_per_epoch, total_epochs),
        weight_decay=float(optim_cfg.get("WEIGHT_DECAY", 0.0)),
        max_norm=clip_grad_norm,
        frozen=frozen,
    )
    if name == "adamW":
        return ClippedAdamW(params, **kw)
    if name != "sgd":
        raise NotImplementedError(f"OPTIMIZER {name} is not ported yet (ROADMAP Queue 1 item 6)")
    return ClippedSGD(
        params, momentum=float(optim_cfg.get("MOMENTUM", 0.9)),
        nesterov=bool(optim_cfg.get("NESTEROV", False)), **kw,
    )
