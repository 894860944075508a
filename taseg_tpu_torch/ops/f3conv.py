"""Backward of the stride-1 k3 conv — port of
`taseg_tpu/ops/f3conv.py:219 f3_bwd_fused` (the backward of both the TGF
and the F3 conv), with `f3_dw_impl` (:200) as the second oracle of d_W.

With the flipped rulebook rb_bwd (rb_bwd[k, i] = v <=> rb_fwd[k, v] = i):

    d_feats[i] = sum_k g[rb_bwd[k, i]] @ W[k]^T       (K2 on (g, W^T, rb_bwd))
    d_W[k]     = sum_i feats[i]^T (x) g[rb_bwd[k, i]] (K4, csrc/conv_dw.cu)

So d_feats is the forward kernel K2 run on the transposed weights, and
takes K2's tensor-core route wherever C_in and C_out are multiples of 8;
d_W is the new kernel K4.  On CPU tensors both run their plain versions
(`f3_bwd_fused_plain`).  d_W comes back in the weight's dtype, as
`_tgf_vjp_bwd` returns it (`d_w.astype(weight.dtype)`): with a bf16
weight it is rounded once to bf16.
"""

from __future__ import annotations

import torch

from . import _build
from .sparse_conv import DTYPE_CODES, sparse_conv_k3, sparse_conv_plain

# split-K rule of K4 and K5 (csrc/conv_dw.cu): at least 4 blocks per SM
# of the H100's 132, at least 1024 rows per split, at most 64 MiB of f32
# partials; a split's rows are whole 256-row windows
DW_TARGET_BLOCKS = 4 * 132
DW_MIN_ROWS = 1024
DW_PART_BYTES = 64 << 20
DW_TILE = 64
DW_WINDOW = 256


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def dw_splits(n_rows: int, n_out: int, c_in: int, c_out: int) -> tuple[int, int]:
    """(splits, rows per split) of a weight-gradient call of K4 / K5 over
    `n_rows` rows and an (n_out, c_in, c_out) output, from the shapes
    alone: the rows are cut until the grid holds DW_TARGET_BLOCKS blocks,
    no split has fewer than DW_MIN_ROWS rows, and the partials stay within
    DW_PART_BYTES."""
    tiles = _cdiv(c_in, DW_TILE) * _cdiv(c_out, DW_TILE)
    splits = min(
        _cdiv(DW_TARGET_BLOCKS, n_out * tiles),
        _cdiv(n_rows, DW_MIN_ROWS),
        DW_PART_BYTES // (n_out * c_in * c_out * 4),
    )
    rows = _cdiv(_cdiv(n_rows, max(splits, 1)), DW_WINDOW) * DW_WINDOW
    return _cdiv(n_rows, rows), rows


def launch_dw(name: str, counter: str, ptrs: tuple, shape: tuple,
              n_rows: int, n_out: int, dtype: torch.dtype, dev) -> torch.Tensor:
    """Launch K4 or K5 (C entry `name`) on `ptrs` (its input pointers)
    and `shape` (its int arguments before the split), with this shape's
    split rule and partial buffer; returns the f32 (n_out, C_in, C_out)
    result."""
    c_in, c_out = shape[1], shape[2]
    out = torch.empty((n_out, c_in, c_out), dtype=torch.float32, device=dev)
    splits, rows = dw_splits(n_rows, n_out, c_in, c_out)
    part = (
        torch.empty((splits, n_out, c_in, c_out), dtype=torch.float32, device=dev)
        if splits > 1 else None
    )
    _build.launch(
        name, (counter,), *ptrs, out.data_ptr(),
        None if part is None else part.data_ptr(),
        *shape, splits, rows, DTYPE_CODES[dtype],
    )
    return out


def k3_conv_dw_plain(
    feats: torch.Tensor, grad: torch.Tensor, rb_bwd: torch.Tensor
) -> torch.Tensor:
    """d_W (27, C_in, C_out) f32: per offset, feats^T @ the gathered grad
    rows (zero where rb_bwd is -1), f32 products and sums."""
    f = feats.float().t()
    out = []
    for k in range(rb_bwd.shape[0]):
        idx = rb_bwd[k]
        g = grad[idx.clamp(min=0).long()]
        g = torch.where((idx >= 0)[:, None], g, 0)
        out.append(f @ g.float())
    return torch.stack(out)


def k3_conv_dw(
    feats: torch.Tensor, grad: torch.Tensor, rb_bwd: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """K4: feats (V, C_in), grad (V, C_out) in one dtype, rb_bwd (27, V)
    int32 -> d_W (27, C_in, C_out), summed in f32 and rounded once to
    `out_dtype`.  Deterministic: the same inputs give the same bits."""
    dev = feats.device
    _build.check("feats", feats, tuple(DTYPE_CODES), 2, dev)
    _build.check("grad", grad, (feats.dtype,), 2, dev)
    _build.check("rb_bwd", rb_bwd, (torch.int32,), 2, dev)
    v, c_in = feats.shape
    c_out = grad.shape[1]
    if grad.shape[0] != v or rb_bwd.shape != (27, v):
        raise ValueError(
            f"shapes do not fit: feats {tuple(feats.shape)}, grad "
            f"{tuple(grad.shape)}, rb_bwd {tuple(rb_bwd.shape)}"
        )
    if not _build.dispatch(feats):
        return k3_conv_dw_plain(feats, grad, rb_bwd).to(out_dtype)
    if v == 0 or c_in == 0 or c_out == 0:
        return torch.zeros((27, c_in, c_out), dtype=out_dtype, device=dev)
    out = launch_dw(
        "taseg_k3_conv_dw", "k3_conv_dw",
        (feats.data_ptr(), grad.data_ptr(), rb_bwd.data_ptr()),
        (v, c_in, c_out), v, 27, feats.dtype, dev,
    )
    return out.to(out_dtype)


def f3_bwd_fused_plain(feats, weight, grad, rb_bwd):
    """(d_feats in feats' dtype, d_W in weight's dtype) by the plain
    versions of K2 and K4."""
    w_t = weight.transpose(1, 2).contiguous()
    g = grad.to(feats.dtype)
    d_feats = sparse_conv_plain(g, w_t, rb_bwd)
    return d_feats, k3_conv_dw_plain(feats, g, rb_bwd).to(weight.dtype)


def f3_bwd_fused(
    feats: torch.Tensor, weight: torch.Tensor, grad: torch.Tensor,
    rb_bwd: torch.Tensor, *, need_feats: bool = True,
):
    """(d_feats or None, d_W) of the k3 conv for the cotangent `grad`
    (V, C_out): d_feats through K2 on (grad, W^T, rb_bwd), counted as a
    `sparse_conv_k3_dgrad` launch; d_W through K4, in weight's dtype.
    `need_feats=False` skips d_feats (returns None)."""
    g = grad.to(feats.dtype)
    d_feats = None
    if need_feats:
        w_t = weight.transpose(1, 2).contiguous()
        d_feats = sparse_conv_k3(g, w_t, rb_bwd, dgrad=True)
    return d_feats, k3_conv_dw(feats, g, rb_bwd, out_dtype=weight.dtype)
