"""Data parallelism over several cards, one process per card (the port's
counterpart of `taseg_tpu/parallel/__init__.py`'s shard_map step).

JAX runs one SPMD step over a mesh axis: each shard builds its topology
and loss from its own scans, the gradients and the loss are `pmean`-ed
before the optax update (`parallel/__init__.py:179-180`), the masked
BN's count, sum and sum of squares are `psum`-ed under `MODEL.IF_DIST`
(`models/layers.py:210-213`; under `shard_map(check_vma=False)` the
psum's transpose sums the cotangents too), and the level counts are
`pmax`-ed (:198-200).  Here each process runs the same `Trainer` on its
slice of the global batch and `torch.distributed` does the collectives:

  * `average_gradients`: one all-reduce over the gradients flattened into
    one buffer, divided by the world size, before the optimizer (so the
    clip of `ClippedSGD` sees the averaged gradient);
  * `all_reduce_sum`: an autograd Function whose forward and backward
    both all-reduce by sum (the masked BN's statistics under IF_DIST);
    without a process group it is the identity, with the same graph, so
    a run on one rank gives a run without torch.distributed's bits;
  * `sum_over_ranks` / `max_over_ranks` / `mean_over_ranks`: the eval
    histograms, the level counts, the reported loss.

`init_from_env` sets the process group up from `torchrun`'s environment
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL on the
card, gloo on the CPU.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


def is_on() -> bool:
    """Whether a process group is set up."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_on() else 0


def world_size() -> int:
    return dist.get_world_size() if is_on() else 1


def init_from_env(device: str = "cuda", timeout_s: float = 600.0) -> torch.device:
    """Join the process group `torchrun` describes in the environment and
    return this process's device: `cuda:LOCAL_RANK` (NCCL) or the CPU
    (gloo)."""
    local = int(os.environ.get("LOCAL_RANK", 0))
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--distributed on cuda: CUDA is not available")
        torch.cuda.set_device(local)
        dev, backend = torch.device("cuda", local), "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(
        backend, init_method="env://", timeout=datetime.timedelta(seconds=timeout_s)
    )
    return dev


def shutdown() -> None:
    if is_on():
        dist.destroy_process_group()


def barrier() -> None:
    if is_on():
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its gradient is the sum of the ranks'
    gradients (the transpose of a psum under shard_map)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        if is_on():
            dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        if is_on():
            dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the ranks, differentiable (the identity on one
    process without a process group)."""
    return _AllReduceSum.apply(x)


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    if is_on():
        x = x.clone()
        dist.all_reduce(x)
    return x


def max_over_ranks(x: torch.Tensor) -> torch.Tensor:
    if is_on():
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return x


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    return sum_over_ranks(x) / world_size() if is_on() else x


@torch.no_grad()
def average_gradients(params) -> None:
    """Every gradient replaced by its mean over the ranks, in one
    all-reduce over a flat buffer (the parameters are f32)."""
    if not is_on():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= world_size()
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[off : off + n].view_as(g))
        off += n


def sync_batchnorm(model: nn.Module) -> int:
    """Sum every masked BN's statistics over the ranks (MODEL.IF_DIST);
    returns how many BN layers it set."""
    from .models.layers import MaskedBatchNorm

    n = 0
    for m in model.modules():
        if isinstance(m, MaskedBatchNorm):
            m.sync = True
            n += 1
    return n


def rank_seed(seed: int, r: int = None) -> int:
    """The dropout seed of rank `r` (default this process's): the seed
    itself on rank 0, else one drawn from (seed, rank), as JAX folds the
    axis index into the step's key."""
    r = rank() if r is None else r
    if r == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), r]).generate_state(1)[0])
