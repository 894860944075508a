"""Optimizer and LR schedule (port of the `sgd` branch of
`taseg_tpu/optim/__init__.py`, the optax chain that `build_optimizer`
returns), in plain torch:

    clip_by_global_norm(max_norm)     scale by max_norm / |g| only when
                                      |g| >= max_norm (optax; unlike
                                      clip_grad_norm_, no 1e-6 term)
    add_decayed_weights(wd)           g + wd * p
    trace(momentum, nesterov)         m' = g + mu m; u = g + mu m' (Nesterov)
    scale_by_learning_rate(schedule)  u * -(lr * schedule(count)),
                                      count taken before its increment

so step 0 runs at lr * 1e-5 under the linear warmup.  The schedule is
computed in float32, as JAX computes it.  Parameters given as `frozen`
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


def build_schedule(optim_cfg: dict, iters_per_epoch: int, total_epochs: int):
    """Step -> LR-scale schedule of an OPTIM block (JAX :118)."""
    name = optim_cfg.get("SCHEDULER", "linear_warmup_with_cosdecay")
    if name != "linear_warmup_with_cosdecay":
        raise NotImplementedError(f"SCHEDULER {name} is not ported yet")
    warmup_steps = int(optim_cfg.get("WARMUP_EPOCH", 1)) * iters_per_epoch
    return linear_warmup_with_cosdecay(warmup_steps, total_epochs * iters_per_epoch)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


class ClippedSGD(torch.optim.Optimizer):
    """The optax chain above over one group of parameters.  `step()`
    reads `p.grad`, updates the parameters and the momentum traces in
    place, and returns (the unclipped global norm of every gradient, the
    frozen parameters' included, as JAX's `grad_norm` metric; the LR it
    applied).  `count`, the schedule's position, travels in
    `state_dict()` beside the traces, so a resumed run goes on where it
    stopped (optax keeps it in the chain's state)."""

    def __init__(
        self, params, *, lr: float, schedule: Callable[[int], float],
        momentum: float = 0.9, nesterov: bool = False, weight_decay: float = 0.0,
        max_norm: float = 10.0, frozen=(),
    ):
        super().__init__(
            params,
            dict(lr=lr, momentum=momentum, nesterov=nesterov,
                 weight_decay=weight_decay, max_norm=max_norm),
        )
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

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ClippedSGD takes no closure")
        (group,) = self.param_groups
        params = [p for p in group["params"] if p.grad is not None]
        g_norm = global_norm([p.grad for p in params])
        if self.frozen:
            params = [p for p in params if id(p) not in self.frozen]
            c_norm = global_norm([p.grad for p in params])
        else:
            c_norm = g_norm
        lr_t = group["lr"] * self.schedule(self.count)
        clip = bool(c_norm >= group["max_norm"])
        mu, wd = group["momentum"], group["weight_decay"]
        for p in params:
            g = p.grad
            if clip:
                g = (g / c_norm) * group["max_norm"]
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


def build_optimizer(
    params, optim_cfg: dict, iters_per_epoch: int, total_epochs: int,
    *, clip_grad_norm: float = 10.0, frozen=(),
) -> ClippedSGD:
    """The `sgd` optimizer of an OPTIM block (LR, WEIGHT_DECAY, MOMENTUM,
    NESTEROV) on the warmup-cosine schedule (JAX :151), `frozen`
    parameters held still."""
    name = optim_cfg.get("OPTIMIZER", "sgd")
    if name != "sgd":
        raise NotImplementedError(f"OPTIMIZER {name} is not ported yet")
    return ClippedSGD(
        params,
        lr=float(optim_cfg["LR"]),
        schedule=build_schedule(optim_cfg, iters_per_epoch, total_epochs),
        momentum=float(optim_cfg.get("MOMENTUM", 0.9)),
        nesterov=bool(optim_cfg.get("NESTEROV", False)),
        weight_decay=float(optim_cfg.get("WEIGHT_DECAY", 0.0)),
        max_norm=clip_grad_norm,
        frozen=frozen,
    )
