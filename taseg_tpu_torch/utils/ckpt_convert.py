"""A torchsparse MinkUNet checkpoint into the port's parameters (port of
`taseg_tpu/utils/ckpt_convert.py`).

The port's `SparseConv` keeps torchsparse's weight layout, (K, C_in,
C_out) over the same kernel-offset enumeration (`ops.rulebook.
kernel_offsets`, ts `nn/utils/kernel.py:11-32`), so a reference
checkpoint maps onto the port's names by translation alone; only the
head's Linear weight is transposed.  It covers every MinkUNet-family
state dict (MinkUNet, MinkUNetMs, SPVCNN's voxel branch share the names,
reference `minkunet.py:186-362`):

    stem.0.kernel                 -> stem_0/SparseConv_0/kernel
    stem.1.{weight,bias}          -> stem_0/MaskedBatchNorm_0/{scale,bias}
    stem.1.running_{mean,var}     -> batch_stats .../{mean,var}
    stageL.0.net.{0,1}            -> downL/...
    stageL.i.net.{0,1,3,4,...}    -> stageL_{i-1}/SparseConv_k + BN_k
    stageL.i.downsample.{0,1}     -> stageL_{i-1}/ the next conv + BN
    upN.0.net.{0,1}               -> upN_deconv/...
    upN.1.i.net...                -> upN_blocks_i/...
    classifier.0.{weight,bias}    -> classifier/{kernel^T, bias}

`translate_minkunet_state` gives the flax-layout (params, batch_stats)
trees, as JAX's does, and `load_minkunet_state` fills a port model with
them (`params_from_jax.load_flax_params`).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
from torch import nn

from .params_from_jax import load_flax_params


def _set(tree: dict, scope: str, leaf: str, value) -> None:
    node = tree
    for part in scope.split("/"):
        node = node.setdefault(part, {})
    node[leaf] = np.asarray(value)


def _bn(params: dict, stats: dict, sd: Mapping, prefix: str, scope: str) -> None:
    _set(params, scope, "scale", sd[f"{prefix}.weight"])
    _set(params, scope, "bias", sd[f"{prefix}.bias"])
    _set(stats, scope, "mean", sd[f"{prefix}.running_mean"])
    _set(stats, scope, "var", sd[f"{prefix}.running_var"])


def _block(params: dict, stats: dict, sd: Mapping, prefix: str, scope: str) -> None:
    """One residual or bottleneck block: the convs and BNs of `net` in
    module order become SparseConv_k / MaskedBatchNorm_k; the
    `downsample` projection (absent for an identity shortcut) takes the
    next index."""
    conv_i = bn_i = 0
    j = 0
    while f"{prefix}.net.{j}.kernel" in sd or f"{prefix}.net.{j}.weight" in sd or j < 8:
        if f"{prefix}.net.{j}.kernel" in sd:
            _set(params, f"{scope}/SparseConv_{conv_i}", "kernel", sd[f"{prefix}.net.{j}.kernel"])
            conv_i += 1
        elif f"{prefix}.net.{j}.weight" in sd:
            _bn(params, stats, sd, f"{prefix}.net.{j}", f"{scope}/MaskedBatchNorm_{bn_i}")
            bn_i += 1
        j += 1
    if f"{prefix}.downsample.0.kernel" in sd:
        _set(params, f"{scope}/SparseConv_{conv_i}", "kernel", sd[f"{prefix}.downsample.0.kernel"])
        _bn(params, stats, sd, f"{prefix}.downsample.1", f"{scope}/MaskedBatchNorm_{bn_i}")


def translate_minkunet_state(
    ref_sd: Mapping, num_layer: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2),
) -> tuple[dict, dict]:
    """A torchsparse MinkUNet state dict (tensors or arrays) -> the
    (params, batch_stats) trees of the port's MinkUNet, float32 numpy
    (JAX ckpt_convert.py:74)."""
    sd = {
        k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v, np.float32)
        for k, v in ref_sd.items()
    }
    params: dict = {}
    stats: dict = {}
    _set(params, "stem_0/SparseConv_0", "kernel", sd["stem.0.kernel"])
    _bn(params, stats, sd, "stem.1", "stem_0/MaskedBatchNorm_0")
    _set(params, "stem_1/SparseConv_0", "kernel", sd["stem.3.kernel"])
    _bn(params, stats, sd, "stem.4", "stem_1/MaskedBatchNorm_0")
    for l in range(1, 5):
        _set(params, f"down{l}/SparseConv_0", "kernel", sd[f"stage{l}.0.net.0.kernel"])
        _bn(params, stats, sd, f"stage{l}.0.net.1", f"down{l}/MaskedBatchNorm_0")
        for i in range(num_layer[l - 1]):
            _block(params, stats, sd, f"stage{l}.{i + 1}", f"stage{l}_{i}")
    for n in range(1, 5):
        _set(params, f"up{n}_deconv/SparseConv_0", "kernel", sd[f"up{n}.0.net.0.kernel"])
        _bn(params, stats, sd, f"up{n}.0.net.1", f"up{n}_deconv/MaskedBatchNorm_0")
        for i in range(num_layer[3 + n]):
            _block(params, stats, sd, f"up{n}.1.{i}", f"up{n}_blocks_{i}")
    _set(params, "classifier", "kernel", sd["classifier.0.weight"].T)
    _set(params, "classifier", "bias", sd["classifier.0.bias"])
    return params, stats


def load_minkunet_state(
    model: nn.Module, ref_sd: Mapping, num_layer: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2),
) -> None:
    """Fill a port MinkUNet in place from a torchsparse state dict;
    every key on either side must be matched, or it raises."""
    params, stats = translate_minkunet_state(ref_sd, num_layer)
    load_flax_params(model, params, stats)


__all__ = ["load_minkunet_state", "translate_minkunet_state"]
