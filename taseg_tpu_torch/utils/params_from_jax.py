"""Weights between the JAX package's flax trees and the port's MinkUNet.

`load_flax_params(model, params, batch_stats)` fills a torch `MinkUNet`
from the flax `params` and `batch_stats` trees given as nested dicts of
numpy arrays, with the names `model.init` gives (`stem_0/SparseConv_0/
kernel`, `stage1_0/MaskedBatchNorm_1/scale`, `classifier/kernel`, ...).
Conv kernels are (K, C_in, C_out) on both sides, so nothing is
transposed.  Every key on either side must be matched, or it raises.

`export_flax_params(model)` is the inverse map: the model's parameters
and BN running statistics back to the two flax-shaped numpy trees.

`init_params_numpy(cfg, seed)` draws trees of the same names and shapes
from numpy with the flax init distributions (JAX layers.py:68-76:
uniform(+-1/sqrt(fan*K)) for convs, lecun_uniform for the head, ones and
zeros for BN), so a run on the card needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.layers import MaskedBatchNorm, SparseConv
from ..models.voxel.minkunet import MinkUNet, _TriScaleHead


def _flatten(tree: dict, prefix: str = "") -> dict:
    flat = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, name + "/"))
        else:
            flat[name] = np.asarray(v)
    return flat


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


@torch.no_grad()
def load_flax_params(model: MinkUNet, params: dict, batch_stats: dict) -> None:
    """Copy the flax trees into `model` in place (on its device)."""
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    filled = set()
    flat_p, flat_s = _flatten(params), _flatten(batch_stats)
    sources = {**flat_p, **flat_s}
    if len(sources) != len(flat_p) + len(flat_s):
        raise KeyError("params and batch_stats share a key")
    for flax_name, arr in sources.items():
        name = flax_name.replace("/", ".")
        if name not in targets:
            raise KeyError(f"flax key {flax_name} has no counterpart in the model")
        t = targets[name]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(
                f"{flax_name}: shape {arr.shape} != model {tuple(t.shape)}"
            )
        t.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
        filled.add(name)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"model entries not in the flax trees: {missing[:8]}")


@torch.no_grad()
def export_flax_params(model: MinkUNet) -> tuple[dict, dict]:
    """(params, batch_stats) nested dicts of float32 numpy arrays, named
    as `model.init` names them: the BN buffers `mean` / `var` go to
    batch_stats, every parameter to params."""
    params = {
        n.replace(".", "/"): np.array(p.detach().float().cpu(), copy=True)
        for n, p in model.named_parameters()
    }
    stats = {
        n.replace(".", "/"): np.array(b.detach().float().cpu(), copy=True)
        for n, b in model.named_buffers()
    }
    return _nest(params), _nest(stats)


def init_params_numpy(cfg: dict, seed: int = 0) -> tuple[dict, dict]:
    """(params, batch_stats) nested dicts of float32 numpy arrays for the
    MinkUNet of `cfg`, drawn from numpy's generator seeded with `seed`."""
    rng = np.random.default_rng(seed)
    model = MinkUNet.from_cfg(cfg, device="cpu")
    params, stats = {}, {}
    for mname, m in model.named_modules():
        path = mname.replace(".", "/")
        if isinstance(m, SparseConv):
            std = 1.0 / (m.fan * m.kernel_volume) ** 0.5
            params[f"{path}/kernel"] = rng.uniform(
                -std, std, tuple(m.kernel.shape)
            ).astype(np.float32)
        elif isinstance(m, MaskedBatchNorm):
            c = m.scale.shape[0]
            params[f"{path}/scale"] = np.ones(c, np.float32)
            params[f"{path}/bias"] = np.zeros(c, np.float32)
            stats[f"{path}/mean"] = np.zeros(c, np.float32)
            stats[f"{path}/var"] = np.ones(c, np.float32)
        elif isinstance(m, _TriScaleHead):
            fan_in, n_cls = m.kernel.shape
            lim = (3.0 / fan_in) ** 0.5
            params[f"{path}/kernel"] = rng.uniform(
                -lim, lim, (fan_in, n_cls)
            ).astype(np.float32)
            params[f"{path}/bias"] = np.zeros(n_cls, np.float32)
    return _nest(params), _nest(stats)
