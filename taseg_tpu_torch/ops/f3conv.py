"""Backward of the stride-1 k3 conv — port of
`taseg_tpu/ops/f3conv.py:219 f3_bwd_fused` (the backward of both the TGF
and the F3 conv), with `f3_dw_impl` (:200) as the second oracle of d_W.

With the flipped rulebook rb_bwd (rb_bwd[k, i] = v <=> rb_fwd[k, v] = i):

    d_feats[i] = sum_k g[rb_bwd[k, i]] @ W[k]^T       (K2 on (g, W^T, rb_bwd))
    d_W[k]     = sum_i feats[i]^T (x) g[rb_bwd[k, i]] (K4, csrc/conv_dw.cu)

So d_feats is the forward kernel K2 run on the transposed weights, and
takes K2's tensor-core route wherever C_in and C_out are multiples of 8;
d_W is the kernel K4, on one of two routes (`dw_route`): for bf16 with
C_in and C_out multiples of 8, the tensor-core kernel over the level's
per-offset pair lists (`k3_pair_lists`, built once per level and step by
the topology and shared by every conv of the level); else the CUDA-core
kernel over rb_bwd.  On CPU tensors both run their plain versions
(`f3_bwd_fused_plain`).  d_W comes back in the weight's dtype, as
`_tgf_vjp_bwd` returns it (`d_w.astype(weight.dtype)`): with a bf16
weight it is rounded once to bf16.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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


# split rule of the tensor-core route of K4 and K5: pairs per split a
# multiple of the 32-pair stage, at least DW_MMA_MIN_PAIRS, and enough
# splits to cover V pairs (the most one list can have) within
# DW_MMA_PART_BYTES of f32 partials
DW_MMA_STAGE = 32
DW_MMA_MIN_PAIRS = 512
DW_MMA_PART_BYTES = 32 << 20


def dw_route(dtype: torch.dtype, c_in: int, c_out: int) -> str:
    """The kernel a CUDA call of K4 or K5 takes: "mma" (tensor cores, over
    pair lists) for bf16 with C_in and C_out multiples of 8, else "simt"
    (CUDA cores, over rb_bwd or the strided tables), as K2's
    `sparse_conv.route`."""
    if dtype == torch.bfloat16 and c_in % 8 == 0 and c_out % 8 == 0:
        return "mma"
    return "simt"


class PairLists(NamedTuple):
    """Present (x row, y row) pairs of a weight gradient, compacted per
    output index o (K4's 27 offsets, K5's 8 slots), each list in row
    order.

    pairs:  (capacity, 2) int32 — for o = 0..n_out-1 in turn, o's pairs;
            rows past starts[n_out] are unused capacity.
    starts: (n_out + 1,) int32 — o's pairs are pairs[starts[o]:starts[o+1]].
    """

    pairs: torch.Tensor
    starts: torch.Tensor


def k3_pair_lists(rb_bwd: torch.Tensor) -> PairLists:
    """K4's PairLists of a (27, V) int32 flipped rulebook: per offset k
    the pairs (row i, rb_bwd[k, i]) with rb_bwd[k, i] >= 0, in a (27 V, 2)
    buffer; on its device, by one prefix sum and one scatter: no count
    is read back to the host."""
    k, v = rb_bwd.shape
    present = (rb_bwd >= 0).reshape(-1)
    pos = torch.cumsum(present, 0)  # int64: pairs up to and including each entry
    # absent entries all go to one spare row, cut off below
    dest = torch.where(present, pos - 1, k * v)
    # (i, rb_bwd[k, i]) as one int64, i in the low word: viewed as int32
    # pairs on a little-endian device
    packed = (rb_bwd.long() << 32) | torch.arange(v, device=rb_bwd.device)
    out = torch.empty(k * v + 1, dtype=torch.int64, device=rb_bwd.device)
    out.scatter_(0, dest, packed.reshape(-1))
    starts = torch.cat([pos.new_zeros(1), pos[v - 1 :: v]]).int()
    return PairLists(pairs=out[: k * v].view(torch.int32).view(k * v, 2), starts=starts)


def dw_mma_splits(v: int, c_in: int, c_out: int, n_out: int = 27) -> tuple[int, int]:
    """(splits, pairs per split) of the tensor-core route of K4 (n_out =
    27 offsets) or K5 (8 slots) when one list can hold up to V pairs,
    from the shapes alone."""
    by_mem = max(1, DW_MMA_PART_BYTES // (n_out * c_in * c_out * 4))
    per = max(DW_MMA_MIN_PAIRS, _cdiv(v, by_mem))
    per = _cdiv(per, DW_MMA_STAGE) * DW_MMA_STAGE
    return max(1, _cdiv(v, per)), per


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


def k3_conv_dw_pairs_plain(
    feats: torch.Tensor, grad: torch.Tensor, pairs: PairLists
) -> torch.Tensor:
    """d_W (n_out, C_in, C_out) f32 over the pair lists (K4's 27 offsets,
    or K5's 8 slots): per list, the gathered feats rows^T @ the gathered
    grad rows, f32 products and sums (reads the start table on the
    host)."""
    s = pairs.starts.tolist()
    out = []
    for k in range(len(s) - 1):
        p = pairs.pairs[s[k] : s[k + 1]].long()
        out.append(feats[p[:, 0]].float().t() @ grad[p[:, 1]].float())
    return torch.stack(out)


def k3_conv_dw(
    feats: torch.Tensor, grad: torch.Tensor, rb_bwd: torch.Tensor,
    out_dtype: torch.dtype = torch.float32, pairs: Optional[PairLists] = None,
) -> torch.Tensor:
    """K4: feats (V, C_in), grad (V, C_out) in one dtype, rb_bwd (27, V)
    int32 -> d_W (27, C_in, C_out), summed in f32 and rounded once to
    `out_dtype`.  The tensor-core route reads `pairs`, the level's
    `k3_pair_lists(rb_bwd)` (built here when not given).  Deterministic:
    the same inputs give the same bits."""
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
    if dw_route(feats.dtype, c_in, c_out) == "mma":
        return _k3_conv_dw_mma(feats, grad, rb_bwd, pairs).to(out_dtype)
    out = launch_dw(
        "taseg_k3_conv_dw", "k3_conv_dw",
        (feats.data_ptr(), grad.data_ptr(), rb_bwd.data_ptr()),
        (v, c_in, c_out), v, 27, feats.dtype, dev,
    )
    return out.to(out_dtype)


def _k3_conv_dw_mma(feats, grad, rb_bwd, pairs):
    if pairs is None:
        pairs = k3_pair_lists(rb_bwd)
    v = feats.shape[0]
    return launch_dw_mma(
        "taseg_k3_conv_dw_mma", "k3_conv_dw", feats, grad, pairs, 27, v, 27 * v,
    )


def launch_dw_mma(name: str, counter: str, x, y, pairs: PairLists, n_out: int,
                  max_pairs: int, capacity: int, *extra) -> torch.Tensor:
    """Launch the tensor-core route of K4 or K5 (C entry `name`, counted
    under `counter` and its `_mma` entry) over `pairs`, n_out lists of up
    to `max_pairs` pairs each in a (capacity, 2) buffer; `extra` are the
    entry's int arguments after the widths.  Returns the f32 (n_out,
    C_in, C_out) result."""
    dev = x.device
    _build.check_aligned(x=x, y=y)
    _build.check("pairs", pairs.pairs, (torch.int32,), 2, dev)
    _build.check("starts", pairs.starts, (torch.int32,), 1, dev)
    if pairs.pairs.shape != (capacity, 2) or pairs.starts.shape != (n_out + 1,):
        raise ValueError(
            f"pair lists {tuple(pairs.pairs.shape)} / {tuple(pairs.starts.shape)} "
            f"do not fit ({capacity}, 2) / ({n_out + 1},)"
        )
    c_in, c_out = x.shape[1], y.shape[1]
    splits, per = dw_mma_splits(max_pairs, c_in, c_out, n_out)
    out = torch.empty((n_out, c_in, c_out), dtype=torch.float32, device=dev)
    part = (
        torch.empty((splits, n_out, c_in, c_out), dtype=torch.float32, device=dev)
        if splits > 1 else None
    )
    _build.launch(
        name, _build.counters(counter, mma=True),
        x.data_ptr(), y.data_ptr(), pairs.pairs.data_ptr(),
        pairs.starts.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), c_in, c_out, *extra, splits, per,
    )
    return out


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
    pairs: Optional[PairLists] = None,
):
    """(d_feats or None, d_W) of the k3 conv for the cotangent `grad`
    (V, C_out): d_feats through K2 on (grad, W^T, rb_bwd), counted as a
    `sparse_conv_k3_dgrad` launch; d_W through K4 (over the level's pair
    lists `pairs` on its tensor-core route), in weight's dtype.
    `need_feats=False` skips d_feats (returns None)."""
    g = grad.to(feats.dtype)
    d_feats = None
    if need_feats:
        w_t = weight.transpose(1, 2).contiguous()
        d_feats = sparse_conv_k3(g, w_t, rb_bwd, dgrad=True)
    return d_feats, k3_conv_dw(feats, g, rb_bwd, out_dtype=weight.dtype, pairs=pairs)
