"""Weights between the JAX package's flax trees and the port's models
(MinkUNet, SPVCNN, RPVNet, Cylinder_TS, MinkUNetMsMm, the range
view's SalsaNext, CENet, FIDNet and RangeNet, torchsparse's
SparseResNet21D and SparseResUNet42 (`stage1_conv/SparseConv_0/kernel`,
`dec0_fuse1/MaskedBatchNorm_2/mean`), and the parameterised BEV modules
ToBEVConvolution and ToDenseBEVConvolution (`kernel`, `bias`)).

`load_flax_params(model, params, batch_stats)` fills a torch model
from the flax `params` and `batch_stats` trees given as nested dicts of
numpy arrays, with the names `model.init` gives (`stem_0/SparseConv_0/
kernel`, `stage1_0/MaskedBatchNorm_1/scale`, `classifier/kernel`,
SPVCNN's `point_transform_0/Dense_0/kernel`, RPVNet's
`range_stem/ResContextBlock_0/ConvActBN_0/Conv_0/kernel`, Cylinder_TS's
`downCntx/a_conv0/kernel` and `logits/bias`, TIAF's
`image_backbone/image_head/kernel`, `lidar_backbone/stem/SparseConv_0/
kernel` and `main/stem_0/...`, CENet's `MultiScaleResNetBackbone_0/
BasicBlock2d_3/ConvBNLeaky_2/Conv_0/kernel`, RangeNet's
`ConvTranspose_0/kernel`, ...).  Sparse conv, 2D conv, transposed 2D
conv and Dense kernels are (K, C_in, C_out), (kh, kw, C_in, C_out) (a
transposed conv's too: flax does not transpose it) and (C_in, C_out) on
both sides, so nothing is transposed.  Every
key on either side must be matched, or it raises.

`export_flax_params(model)` is the inverse map: the model's parameters
and BN running statistics back to the two flax-shaped numpy trees.

`init_params_numpy(cfg, seed)` (and `init_module_numpy(model, seed)` for
a module that no config builds) draws trees of the same names and shapes
from numpy with the flax init distributions (JAX layers.py:68-76:
uniform(+-1/sqrt(fan*K)) for convs and a sparse conv's bias,
lecun_uniform for MinkUNet's head,
flax's default Dense and Conv init (lecun_normal: a normal truncated at 2
standard deviations over the fan-in, kh * kw * C_in for a 2D conv, zero
bias where the conv has one) for the Dense layers, RPVNet's range
branch and the range models, ones and zeros for
both kinds of BN), so a run on the card needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from torch import nn

from ..models import build_segmentor
from ..models.bev import _Sliced
from ..models.layers import Dense, MaskedBatchNorm, SparseConv
from ..models.range2d.blocks import BatchNorm, Conv, ConvTranspose
from ..models.voxel.minkunet import _TriScaleHead


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
def load_flax_params(model: nn.Module, params: dict, batch_stats: dict) -> None:
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
def export_flax_params(model: nn.Module) -> tuple[dict, dict]:
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
    model of `cfg` (`models.build_segmentor`), drawn from numpy's
    generator seeded with `seed`."""
    return init_module_numpy(build_segmentor(cfg, device="cpu"), seed)


def init_module_numpy(model: nn.Module, seed: int = 0) -> tuple[dict, dict]:
    """(params, batch_stats) of any module built from the port's layers
    (a segmentor, SparseResNet21D, SparseResUNet42, the BEV modules),
    drawn with the flax init distributions from numpy's generator seeded
    with `seed`; the BEV modules' kernels uniform(+-1/sqrt(C_in)), their
    biases 0 (JAX `models/bev.py:33`)."""
    rng = np.random.default_rng(seed)
    params, stats = {}, {}
    for mname, m in model.named_modules():
        path = mname.replace(".", "/")
        if isinstance(m, SparseConv):
            std = 1.0 / (m.fan * m.kernel_volume) ** 0.5
            params[f"{path}/kernel"] = rng.uniform(
                -std, std, tuple(m.kernel.shape)
            ).astype(np.float32)
            if m.bias is not None:
                params[f"{path}/bias"] = rng.uniform(
                    -std, std, tuple(m.bias.shape)
                ).astype(np.float32)
        elif isinstance(m, (Conv, ConvTranspose)):
            kh, kw, ci, co = m.kernel.shape
            params[f"{path}/kernel"] = lecun_normal(rng, kh * kw * ci, (kh, kw, ci, co))
            if getattr(m, "bias", None) is not None:
                params[f"{path}/bias"] = np.zeros(co, np.float32)
        elif isinstance(m, (MaskedBatchNorm, BatchNorm)):
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
        elif isinstance(m, Dense):
            fan_in, n_out = m.kernel.shape
            params[f"{path}/kernel"] = lecun_normal(rng, fan_in, (fan_in, n_out))
            params[f"{path}/bias"] = np.zeros(n_out, np.float32)
        elif isinstance(m, _Sliced):  # may be the root: no scope then
            pre = f"{path}/" if path else ""
            std = 1.0 / m.in_channels**0.5
            params[pre + "kernel"] = rng.uniform(-std, std, tuple(m.kernel.shape)).astype(np.float32)
            if m.bias is not None:
                params[pre + "bias"] = np.zeros(m.out_channels, np.float32)
    return _nest(params), _nest(stats)


def lecun_normal(rng: np.random.Generator, fan_in: int, shape) -> np.ndarray:
    """flax's `lecun_normal`: a standard normal truncated to [-2, 2]
    (redrawn outside), scaled to variance 1 / fan_in (the truncated
    normal's std is 0.8796256610342398)."""
    x = rng.standard_normal(shape)
    out = np.abs(x) > 2.0
    while out.any():
        x[out] = rng.standard_normal(int(out.sum()))
        out = np.abs(x) > 2.0
    return (x * (1.0 / fan_in) ** 0.5 / 0.8796256610342398).astype(np.float32)
