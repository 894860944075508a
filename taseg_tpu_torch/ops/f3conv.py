"""Backward of the stride-1 k3 conv — port of
`taseg_tpu/ops/f3conv.py:219 f3_bwd_fused` (the backward of both the TGF
and the F3 conv), with `f3_dw_impl` (:200) as the second oracle of d_W.

With the flipped rulebook rb_bwd (rb_bwd[k, i] = v <=> rb_fwd[k, v] = i):

    d_feats[i] = sum_k g[rb_bwd[k, i]] @ W[k]^T       (K2 on (g, W^T, rb_bwd))
    d_W[k]     = sum_i feats[i]^T (x) g[rb_bwd[k, i]] (K4, csrc/conv_dw.cu)

So d_feats is the forward kernel K2 run on the transposed weights, on
K2's wgmma route in bf16 (over the level's row order: a flip maps equal
offset masks to equal masks); d_W is the kernel K4 (`dw_route`): in bf16
Hopper's warpgroup MMA over the level's per-offset pair lists
(`k3_pair_lists`, built once per level and step by the topology and
shared by every conv of the level), in one launch a call
(`k3_conv_dw_wgmma`, its tile and splits from `k4_plan`); a direct f32
call the CUDA-core kernel over rb_bwd.  Ragged widths are padded to
whole 16-byte pieces (`sparse_conv.padded_width`), once for both kernels
(`bwd_operands`).  On CPU tensors both run their plain versions
(`f3_bwd_fused_plain`).  d_W comes back in the weight's dtype, as
`_tgf_vjp_bwd` returns it (`d_w.astype(weight.dtype)`): with a bf16
weight it is rounded once to bf16.

The conv over K offsets (`sparse_conv.conv_k`, JAX sparse_conv.py:157
`_conv_vjp_bwd`) has the same backward over its reverse table rb_bwd
(K, V_in) of cotangent rows (`sparse_conv_bwd`): d_feats through K2 at K
offsets on (g, W^T, rb_bwd), d_W through K4 at K offsets
(`sparse_conv_dw`, `csrc/conv_dw.cu`), where g has V_out rows and feats
V_in.  K4 at K offsets takes the route of `sparse_conv.k_route`: in f32
the 3xTF32 tile on Hopper's wgmma over the per-offset pair lists of
rb_bwd (`pair_lists`, which the topology builds once per table and step),
at widths padded to multiples of 4, in one launch a call
(`launch_dw_tf32`, its plan from `dw_tf32_plan`; K5's f32 calls take the
same tile over the slot lists); a bf16 call (no path makes one) the
CUDA-core kernel over rb_bwd itself.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from . import _build
from .sparse_conv import (
    DTYPE_CODES, k_route, pad_cols, padded_feats, padded_width, sparse_conv, sparse_conv_k3,
    sparse_conv_plain, unpad,
)

# split-K rule of K4 and K5 (csrc/conv_dw.cu): at least 4 blocks per SM
# of the H100's 132, at least 1024 rows per split, at most 64 MiB of f32
# partials; a split's rows are whole 256-row windows
DW_TARGET_BLOCKS = 4 * 132
DW_MIN_ROWS = 1024
DW_PART_BYTES = 64 << 20
DW_TILE = 64
DW_WINDOW = 256


# split rule of the mma.sync tiles that wgmma tiles replaced (K4's bf16
# tile and the 3xTF32 tile of K4 at K, now only chip_smoke.py's
# yardsticks): pairs per split a multiple of the 32-pair stage, at least
# DW_MMA_MIN_PAIRS, and enough splits to cover V pairs (the most one list
# can have) within DW_MMA_PART_BYTES of f32 partials
DW_MMA_STAGE = 32
DW_MMA_MIN_PAIRS = 512
DW_MMA_PART_BYTES = 32 << 20


def dw_route(dtype: torch.dtype, c_in: int, c_out: int, strided: bool = False) -> str:
    """The kernel a CUDA call of K4 (`strided=False`) or K5 (`strided=True`)
    takes, both over pair lists in one launch, at any widths (each padded
    to `sparse_conv.padded_width`).  "wgmma" (Hopper's warpgroup MMA: K4
    over the level's offset lists, K5 over its slot lists) for bf16; K5's
    f32 calls "tf32x3" (the 3xTF32 wgmma tile over the slot lists,
    `launch_dw_tf32`).  K4's f32 calls run as K4 at K = 27
    (`sparse_conv.k_route`) and do not reach it: a direct f32 call takes
    "simt" (CUDA cores over rb_bwd)."""
    if dtype == torch.bfloat16:
        return "wgmma"
    return "tf32x3" if strided and dtype == torch.float32 else "simt"


def dw_unpad(out: torch.Tensor, c_in: int, c_out: int, dtype: torch.dtype) -> torch.Tensor:
    """The logical (n, C_in, C_out) block of a weight gradient computed at
    padded widths, contiguous, in `dtype` (one copy where it is ragged or
    changes dtype, none else)."""
    if dtype != out.dtype:
        return out[:, :c_in, :c_out].to(dtype, memory_format=torch.contiguous_format)
    return unpad(out, c_in, c_out)


# K4's wgmma route (csrc/conv_dw.cu, lists::dw_wgmma_kernel): pairs per
# split in whole 64-pair stages, at least K4_MIN_PAIRS, the least at
# which the 27 lists' pieces (each list at least one) fill one wave of
# live blocks: K4_SMS x the tile's resident blocks per SM (at most 2)
# over all tiles.  The kernel finds it from the lists' lengths on the
# device (`k4_split_pairs` is its host model), so a wave holds the pieces
# the data gives: a target from the lists' total alone over- or
# under-fills the wave by up to 27 ragged last pieces per tile, and a
# block's fixed cost (its ring's fill, its partial's round trip) is a
# few us, as much as a short piece's stages (tools/k4_calls.py)
K4_STAGE = 64
K4_MIN_PAIRS = 256
K4_SMS = 132
K4_SMEM = 232448  # shared memory a block can use on the H100
K4_WINDOW = 1024  # pairs a block stages in shared memory at a time


class K4Plan(NamedTuple):
    """One K4 call on its wgmma route: `cw` consumer warpgroups (64 cw
    C_in rows per block), `bn` C_out columns per block, pairs per split
    at least `per_min` and, with a `target`, the least at which the
    lists' pieces number at most `target` per tile (`k4_split_pairs`;
    target 0: `per_min`)."""

    cw: int
    bn: int
    target: int
    per_min: int


def k4_tile(c_in: int, c_out: int) -> tuple[int, int]:
    """(consumer warpgroups, columns) of K4's wgmma tile: two warpgroups
    (128 C_in rows, so a gathered g row feeds 128 of them) where C_in >=
    256, else one; the whole C_out up to 256 columns (32, 64, 96, 128 or
    256: a gathered feats row feeds all of them), wider C_out in 256-wide
    tiles.  Two warpgroups paid on the H100 only from C_in 256 (MinkUNet's
    256 -> 256 and 384 -> 256); at C_in 128 and 192 one was faster at
    every call (tools/k4_calls.py --variants)."""
    return (2 if c_in >= 256 else 1), next((w for w in (32, 64, 96, 128) if c_out <= w), 256)


def k4_tiles(c_in: int, c_out: int, cw: int, bn: int) -> int:
    """Blocks per piece of K4's wgmma tile: (64 cw)-row C_in tiles x
    bn-column C_out tiles."""
    return _cdiv(c_in, 64 * cw) * _cdiv(c_out, bn)


def k4_smem_bytes(cw: int, bn: int) -> int:
    """Dynamic shared memory of K4's wgmma tile: 1 KB of alignment, the
    4-stage ring of A (64 cw rows) and B (bn columns) over 64 pairs, the
    ring's barriers and the pair window."""
    return 1024 + 4 * (cw * 64 + bn) * K4_STAGE * 2 + 2 * 4 * 8 + K4_WINDOW * 8


def k4_resident(cw: int, bn: int) -> int:
    """Blocks of K4's wgmma tile that the plan counts resident per SM:
    as many as the shared memory holds, at most 2."""
    return max(1, min(2, K4_SMEM // k4_smem_bytes(cw, bn)))


def k4_pieces(v: int, target: int, per_min: int) -> int:
    """Blocks per tile that cover every split of 27 lists of at most V
    pairs each: piece (k, z) lies at (starts[k] - starts[0]) // per + k +
    z, below max(target, 27) + 27 with a target (at most `target` pieces,
    or one per list), below 27 V // per_min + 27 without."""
    return (max(target, 27) if target > 0 else 27 * v // per_min) + 27


def k4_split_pairs(starts, per_min: int, target: int, stage: int = K4_STAGE) -> int:
    """Host model of the kernel's pairs per split (csrc/conv_dw.cu,
    lists::split_pairs) for the start table `starts` (a list): with a
    target, the least multiple of `stage`, at least per_min, at which the
    lists' pieces number at most `target`, or the longest list rounded up
    to a stage; else per_min.  For tools and tests (it reads the starts
    on the host)."""
    if target <= 0:
        return per_min
    n = [b - a for a, b in zip(starts[:-1], starts[1:])]
    lo = max(1, _cdiv(per_min, stage))
    hi = max(lo, _cdiv(max(n), stage))
    while lo < hi:
        mid = (lo + hi) // 2
        if sum(max(1, _cdiv(m, mid * stage)) for m in n) <= target:
            hi = mid
        else:
            lo = mid + 1
    return lo * stage


@functools.lru_cache(maxsize=None)
def k4_plan(v: int, c_in: int, c_out: int) -> K4Plan:
    """K4's wgmma plan for V rows and these widths, from the shapes alone
    (the pairs per split follow the lists' lengths on the device)."""
    cw, bn = k4_tile(c_in, c_out)
    target = _cdiv(K4_SMS * k4_resident(cw, bn), k4_tiles(c_in, c_out, cw, bn))
    return K4Plan(cw, bn, target, K4_MIN_PAIRS)


def k4_one_split(v: int, c_in: int, c_out: int) -> K4Plan:
    """`k4_plan` with every list in one piece (pairs per split V, the
    most one list holds): no partials and no sum of pieces, for measuring
    what the splits cost."""
    return k4_plan(v, c_in, c_out)._replace(target=0, per_min=v)


# K5's split rule over the slot lists (csrc/conv_dw.cu, k5): pairs per
# split a multiple of the 64-pair stage, at least K5_MIN_PAIRS, few
# enough that the live blocks (tiles x the V pairs over all 8 lists) come
# to about one wave of the H100's 132 SMs at 2 resident blocks per SM
K5_STAGE = 64
K5_MIN_PAIRS = 256
K5_SMS = 132
K5_PER_SM = 2


def k5_tile_n(c_out: int) -> int:
    """C_out columns per block of K5's tile (both routes): 32, 64, 96 or
    128; wider C_out takes several 128-wide blocks."""
    return next((w for w in (32, 64, 96) if c_out <= w), 128)


@functools.lru_cache(maxsize=None)
def k5_splits(v: int, c_in: int, c_out: int) -> tuple[int, int]:
    """(splits, pairs per split) of K5 over slot lists of V_fine = `v`
    rows in all (one list can hold all of them), from the shapes alone;
    the splits of a list are added in the kernel, in split order."""
    tiles = _cdiv(c_in, 64) * _cdiv(c_out, k5_tile_n(c_out))
    per = max(K5_MIN_PAIRS, _cdiv(v * tiles, K5_SMS * K5_PER_SM))
    per = _cdiv(per, K5_STAGE) * K5_STAGE
    return max(1, _cdiv(v, per)), per


# The f32 weight gradients' tile (csrc/wgmma_tf32_dw.cuh: K4 at K offsets
# and K5 in f32 on 3xTF32 wgmma, one launch a call): one consumer
# warpgroup on 64 C_in rows, DW_TF32_TILE_COLS C_out columns a block;
# pairs per split in whole 32-pair stages, at least DW_TF32_MIN_PAIRS, the
# least at which the lists' pieces number at most the plan's target a
# tile (found on the device, `k4_split_pairs` at stage 32 is its host
# model): DW_TF32_WAVES waves of the H100's SMs at the tile's resident
# blocks
DW_TF32_WAVES = 1
DW_TF32_STAGE = 32
DW_TF32_MIN_PAIRS = 256
DW_TF32_TILE_COLS = (16, 32, 64, 96, 128)
DW_TF32_B_BUFFERS = 2  # transposed, split B (hi and lo)
DW_TF32_WINDOW = 512  # pairs a block stages in shared memory at a time


class DwTf32Plan(NamedTuple):
    """One call of the f32 weight-gradient tile: `bn` C_out columns a
    block (64 C_in rows), `tiles` blocks a piece, pairs per split at least
    `per_min` and the least at which the lists' pieces number at most
    `target` a tile."""

    bn: int
    tiles: int
    target: int
    per_min: int


def dw_tf32_tile_n(c_out: int) -> int:
    """C_out columns a block of the f32 tile: the whole C_out up to 128,
    in 16, 32, 64, 96 or 128; wider C_out in 128-column blocks."""
    return next((w for w in DW_TF32_TILE_COLS if c_out <= w), 128)


def dw_tf32_raw_stages(bn: int) -> int:
    """Stages of gathered rows a block of the f32 tile keeps in flight: 6,
    but 4 at 64 columns (two blocks an SM)."""
    return 4 if bn == 64 else 6


def dw_tf32_smem_bytes(bn: int) -> int:
    """Dynamic shared memory of a block: 1 KB of alignment, the B buffers
    (hi and lo, bn rows of 32 pairs), the raw stages (32 X rows of 72
    floats and 32 Y rows of bn) with their two barriers each, and the pair
    window."""
    raw = dw_tf32_raw_stages(bn)
    return (1024 + DW_TF32_B_BUFFERS * 2 * bn * DW_TF32_STAGE * 4 + raw * DW_TF32_STAGE * (72 + bn) * 4
            + 2 * raw * 8 + DW_TF32_WINDOW * 8)


def dw_tf32_resident(bn: int) -> int:
    """Blocks of the f32 tile resident per SM: two where bn <= 64 (their
    registers, ~128 a thread, and shared memory fit twice), else one."""
    return 2 if bn <= 64 else 1


@functools.lru_cache(maxsize=None)
def dw_tf32_plan(c_in: int, c_out: int) -> DwTf32Plan:
    """The f32 weight-gradient tile's plan at these (padded) widths, from
    the shapes alone (the pairs per split follow the lists' lengths on the
    device)."""
    bn = dw_tf32_tile_n(c_out)
    tiles = _cdiv(c_in, 64) * _cdiv(c_out, bn)
    return DwTf32Plan(bn, tiles, _cdiv(DW_TF32_WAVES * K4_SMS * dw_tf32_resident(bn), tiles), DW_TF32_MIN_PAIRS)


def dw_pieces(n_out: int, v: int, target: int, per_min: int) -> int:
    """Blocks a tile that cover every split of n_out lists of at most V
    pairs each: piece (k, z) lies at (starts[k] - starts[0]) // per + k +
    z, below max(target, n_out) + n_out with a target (at most `target`
    pieces, or one a list), below n_out V // per_min + n_out without."""
    return (max(target, n_out) if target > 0 else n_out * v // per_min) + n_out


class PairLists(NamedTuple):
    """Present (x row, y row) pairs of a weight gradient, compacted per
    output index o (K4's 27 offsets, K5's 8 slots), each list in row
    order.

    pairs:  (capacity, 2) int32 — for o = 0..n_out-1 in turn, o's pairs;
            rows past starts[n_out] are unused capacity (and, in lists of
            `pair_lists_many`, rows before starts[0] are other tables').
    starts: (n_out + 1,) int32 — o's pairs are pairs[starts[o]:starts[o+1]].
    """

    pairs: torch.Tensor
    starts: torch.Tensor


def pair_lists(rb_bwd: torch.Tensor) -> PairLists:
    """The PairLists of a (K, V) int32 reverse table (K4's flipped
    rulebook, K = 27, or any table of K4 at K offsets): per offset k the
    pairs (row i, rb_bwd[k, i]) with rb_bwd[k, i] >= 0, in row order, in a
    (K V, 2) buffer; on its device, by one prefix sum and one scatter: no
    count is read back to the host."""
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


k3_pair_lists = pair_lists  # K4's name for its 27-offset lists


def pair_lists_many(rbs) -> list:
    """`pair_lists` of each (K_t, V_t) reverse table of `rbs`, built once
    per distinct V_t over the group's tables stacked along K: each
    table's PairLists reads the group's buffer through its own slice of
    the start table (its offsets' lists, at their place in the buffer)."""
    out = [None] * len(rbs)
    groups: dict = {}
    for i, rb in enumerate(rbs):
        groups.setdefault(rb.shape[1], []).append(i)
    for idx in groups.values():
        both = pair_lists(torch.cat([rbs[i] for i in idx]))
        off = 0
        for i in idx:
            k = rbs[i].shape[0]
            out[i] = PairLists(pairs=both.pairs, starts=both.starts[off : off + k + 1])
            off += k
    return out


def dw_mma_splits(v: int, c_in: int, c_out: int, n_out: int = 27) -> tuple[int, int]:
    """(splits, pairs per split) of the tensor-core route of K4 (n_out =
    27 offsets) or K4 at K when one list can hold up to V pairs, from
    the shapes alone."""
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
    split rule and partial buffer, counted under `counter` (an empty
    `counter`: nowhere); returns the f32 (n_out, C_in, C_out) result."""
    c_in, c_out = shape[1], shape[2]
    out = torch.empty((n_out, c_in, c_out), dtype=torch.float32, device=dev)
    splits, rows = dw_splits(n_rows, n_out, c_in, c_out)
    part = (
        torch.empty((splits, n_out, c_in, c_out), dtype=torch.float32, device=dev)
        if splits > 1 else None
    )
    _build.launch(
        name, (counter,) if counter else (), *ptrs, out.data_ptr(),
        None if part is None else part.data_ptr(),
        *shape, splits, rows, DTYPE_CODES[dtype],
    )
    return out


def k3_conv_dw_plain(
    feats: torch.Tensor, grad: torch.Tensor, rb_bwd: torch.Tensor
) -> torch.Tensor:
    """d_W (K, C_in, C_out) f32: per offset, feats^T @ the gathered grad
    rows (zero where rb_bwd is -1), f32 products and sums; the plain
    version of K4 (K = 27) and of K4 at K offsets, where grad has its own
    row count."""
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
    `out_dtype`.  The wgmma route reads `pairs`, the level's
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
    if dw_route(feats.dtype, c_in, c_out) == "wgmma":
        if pairs is None:
            pairs = k3_pair_lists(rb_bwd)
        ci, co = padded_width(feats.dtype, c_in), padded_width(feats.dtype, c_out)
        out = k3_conv_dw_wgmma(pad_cols(feats, ci), pad_cols(grad, co), pairs)
        return dw_unpad(out, c_in, c_out, out_dtype)
    out = launch_dw(
        "taseg_k3_conv_dw", "k3_conv_dw",
        (feats.data_ptr(), grad.data_ptr(), rb_bwd.data_ptr()),
        (v, c_in, c_out), v, 27, feats.dtype, dev,
    )
    return out.to(out_dtype)


def check_pair_lists(x, y, pairs: PairLists, n_out: int, capacity: int) -> None:
    """Raise unless x and y are 16-byte aligned and `pairs` holds n_out
    lists in a (>= capacity, 2) int32 buffer with (n_out + 1,) starts on
    x's device."""
    dev = x.device
    _build.check_aligned(x=x, y=y)
    _build.check("pairs", pairs.pairs, (torch.int32,), 2, dev)
    _build.check("starts", pairs.starts, (torch.int32,), 1, dev)
    if (pairs.pairs.shape[1:] != (2,) or pairs.pairs.shape[0] < capacity
            or pairs.starts.shape != (n_out + 1,)):
        raise ValueError(
            f"pair lists {tuple(pairs.pairs.shape)} / {tuple(pairs.starts.shape)} "
            f"do not fit (>= {capacity}, 2) / ({n_out + 1},)"
        )


def k3_conv_dw_wgmma(
    feats: torch.Tensor, grad: torch.Tensor, pairs: PairLists, plan: Optional[K4Plan] = None,
) -> torch.Tensor:
    """K4's wgmma route: feats (V, C_in) and grad (V, C_out) bf16 with
    widths in 8s, `pairs` the level's `k3_pair_lists` -> f32 (27, C_in,
    C_out), in one launch with `plan` (`k4_plan` where None; a test or a
    tool may pass another, e.g. `k4_one_split`).  The splits of a list
    are added in split order by its last block: the same inputs and plan
    give the same bits."""
    dev = feats.device
    v, c_in = feats.shape
    c_out = grad.shape[1]
    check_pair_lists(feats, grad, pairs, 27, 27 * v)
    p = plan or k4_plan(v, c_in, c_out)
    pieces = k4_pieces(v, p.target, p.per_min)
    out = torch.empty((27, c_in, c_out), dtype=torch.float32, device=dev)
    part = cnt = None
    if p.target > 0 or p.per_min < v:  # a list may split
        part = torch.empty((pieces, c_in, c_out), dtype=torch.float32, device=dev)
        cnt = _build.zeroed_counters(dev, 27 * k4_tiles(c_in, c_out, p.cw, p.bn))
    _build.launch(
        "taseg_k3_conv_dw_wgmma", _build.counters("k3_conv_dw", suffix="_wgmma"),
        feats.data_ptr(), grad.data_ptr(), pairs.pairs.data_ptr(), pairs.starts.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(),
        None if cnt is None else cnt.data_ptr(), c_in, c_out, p.cw, p.bn, pieces,
        p.per_min, p.target,
    )
    return out


def launch_dw_mma(name: str, x, y, pairs: PairLists, n_out: int, max_pairs: int, capacity: int,
                  *extra) -> torch.Tensor:
    """Launch an mma.sync pair-list tile that a wgmma tile replaced (C
    entry `name`: K4's bf16 tile, `taseg_k3_conv_dw_mma`, or the 3xTF32
    tile of K4 at K offsets, `taseg_sparse_conv_dw_tf32_mma`), counted
    nowhere: chip_smoke.py's yardsticks, on no path.  Over `pairs`, n_out
    lists of up to `max_pairs` pairs each in a (capacity, 2) buffer, its
    splits from `dw_mma_splits` added by a second kernel; `extra` are the
    entry's int arguments after the widths.  Returns the f32 (n_out,
    C_in, C_out) result."""
    dev = x.device
    check_pair_lists(x, y, pairs, n_out, capacity)
    c_in, c_out = x.shape[1], y.shape[1]
    splits, per = dw_mma_splits(max_pairs, c_in, c_out, n_out)
    out = torch.empty((n_out, c_in, c_out), dtype=torch.float32, device=dev)
    part = (
        torch.empty((splits, n_out, c_in, c_out), dtype=torch.float32, device=dev)
        if splits > 1 else None
    )
    _build.launch(
        name, (), x.data_ptr(), y.data_ptr(), pairs.pairs.data_ptr(), pairs.starts.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), c_in, c_out, *extra, splits, per,
    )
    return out


def launch_dw_tf32(name: str, counter: str, x, y, pairs: PairLists, n_out: int, max_pairs: int,
                   capacity: int, mode: int, plan: Optional[DwTf32Plan] = None) -> torch.Tensor:
    """Launch the f32 weight-gradient tile on 3xTF32 wgmma (C entry
    `name`: `taseg_sparse_conv_dw_tf32`, K4 at K offsets, `mode` n_out;
    `taseg_strided_dw_tf32`, K5, `mode` 1 for the up direction), counted
    under `counter` and its `_tf32` entry (an empty `counter`: nowhere),
    in one launch: x (rows, C_in) and y (rows, C_out) f32 with widths in
    4s over `pairs`, n_out lists of up to `max_pairs` pairs each in a
    (capacity, 2) buffer, with `plan` (`dw_tf32_plan` where None; a tool
    may pass another target).  The partials (pieces, C_in,
    C_out) and the counters are handed over only where a list can split
    (its split at least `per_min` pairs); the last block of each list
    adds its pieces in split order, so the same inputs give the same
    bits.  Returns the f32 (n_out, C_in, C_out) result."""
    dev = x.device
    check_pair_lists(x, y, pairs, n_out, capacity)
    c_in, c_out = x.shape[1], y.shape[1]
    p = plan or dw_tf32_plan(c_in, c_out)
    pieces = dw_pieces(n_out, max_pairs, p.target, p.per_min)
    out = torch.empty((n_out, c_in, c_out), dtype=torch.float32, device=dev)
    part = cnt = None
    if p.per_min < max_pairs:  # a list may split
        part = torch.empty((pieces, c_in, c_out), dtype=torch.float32, device=dev)
        cnt = _build.zeroed_counters(dev, n_out * p.tiles)
    _build.launch(
        name, _build.counters(counter, suffix="_tf32") if counter else (),
        x.data_ptr(), y.data_ptr(), pairs.pairs.data_ptr(), pairs.starts.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(),
        None if cnt is None else cnt.data_ptr(), c_in, c_out, mode, pieces, p.per_min, p.target,
    )
    return out


def f3_bwd_fused_plain(feats, weight, grad, rb_bwd):
    """(d_feats in feats' dtype, d_W in weight's dtype) by the plain
    versions of K2 and K4."""
    w_t = weight.transpose(1, 2).contiguous()
    g = grad.to(feats.dtype)
    d_feats = sparse_conv_plain(g, w_t, rb_bwd)
    return d_feats, k3_conv_dw_plain(feats, g, rb_bwd).to(weight.dtype)


def bwd_operands(feats: torch.Tensor, weight: torch.Tensor, grad: torch.Tensor) -> tuple:
    """(g, W^T) for a conv's backward: the cotangent in feats' dtype,
    zero-padded on CUDA tensors to the tensor-core routes' width once for
    both kernels that read it (the input gradient's conv and the weight
    gradient), and the transposed weight as a view of W (no copy: the
    3xTF32 route reads it as W is stored, K-major; the other routes pad
    or copy it to their own layout)."""
    return padded_feats(grad.to(feats.dtype), weight.shape[2]), weight.transpose(1, 2)


def f3_bwd_fused(
    feats: torch.Tensor, weight: torch.Tensor, grad: torch.Tensor,
    rb_bwd: torch.Tensor, *, need_feats: bool = True,
    pairs: Optional[PairLists] = None, order: Optional[torch.Tensor] = None,
):
    """(d_feats or None, d_W) of the k3 conv for the cotangent `grad`
    (V, C_out): d_feats through K2 on (grad, W^T, rb_bwd) over the
    level's row order `order` on its wgmma route, counted as a
    `sparse_conv_k3_dgrad` launch; d_W through K4 (over the level's pair
    lists `pairs` on its wgmma route), in weight's dtype.  `feats` may
    come padded to the route's C_in (as `K3Conv` saves it); the
    cotangent is padded once for both kernels (`bwd_operands`).
    `need_feats=False` skips d_feats (returns None)."""
    c_in, c_out = weight.shape[1], weight.shape[2]
    g, w_t = bwd_operands(feats, weight, grad)
    d_feats = None
    if need_feats:
        d_feats = sparse_conv_k3(g, w_t, rb_bwd, dgrad=True, order=order)
    d_w = k3_conv_dw(feats, g, rb_bwd, pairs=pairs)
    return d_feats, dw_unpad(d_w, c_in, c_out, weight.dtype)


def sparse_conv_dw(
    feats: torch.Tensor, grad: torch.Tensor, rb_bwd: torch.Tensor,
    out_dtype: torch.dtype = torch.float32, pairs: Optional[PairLists] = None,
) -> torch.Tensor:
    """K4 at K offsets: feats (V_in, C_in), grad (V_out, C_out) in one
    dtype, rb_bwd (K, V_in) int32 of grad rows -> d_W (K, C_in, C_out),
    summed in f32 and rounded once to `out_dtype`.  The 3xTF32 route (the
    wgmma tile, one launch) reads `pairs`, `pair_lists(rb_bwd)` (built here
    when not given).  Deterministic: the same inputs give the same bits."""
    dev = feats.device
    _build.check("feats", feats, tuple(DTYPE_CODES), 2, dev)
    _build.check("grad", grad, (feats.dtype,), 2, dev)
    _build.check("rb_bwd", rb_bwd, (torch.int32,), 2, dev)
    v_in, c_in = feats.shape
    c_out = grad.shape[1]
    k = rb_bwd.shape[0]
    if rb_bwd.shape[1] != v_in or not 1 <= k <= 32:
        raise ValueError(
            f"shapes do not fit: feats {tuple(feats.shape)}, grad "
            f"{tuple(grad.shape)}, rb_bwd {tuple(rb_bwd.shape)} (1 <= K <= 32)"
        )
    if not _build.dispatch(feats):
        return k3_conv_dw_plain(feats, grad, rb_bwd).to(out_dtype)
    if v_in == 0 or c_in == 0 or c_out == 0 or grad.shape[0] == 0:
        return torch.zeros((k, c_in, c_out), dtype=out_dtype, device=dev)
    if k_route(feats.dtype, c_in, c_out) == "tf32x3":
        if pairs is None:
            pairs = pair_lists(rb_bwd)
        ci, co = padded_width(feats.dtype, c_in), padded_width(feats.dtype, c_out)
        out = launch_dw_tf32(
            "taseg_sparse_conv_dw_tf32", "sparse_conv_dw", pad_cols(feats, ci), pad_cols(grad, co),
            pairs, k, v_in, k * v_in, k,
        )
        return dw_unpad(out, c_in, c_out, out_dtype)
    out = launch_dw(
        "taseg_sparse_conv_dw", "sparse_conv_dw",
        (feats.data_ptr(), grad.data_ptr(), rb_bwd.data_ptr()),
        (v_in, c_in, c_out, k), v_in, k, feats.dtype, dev,
    )
    return out.to(out_dtype)


def sparse_conv_bwd(
    feats: torch.Tensor, weight: torch.Tensor, grad: torch.Tensor,
    rb_bwd: torch.Tensor, *, need_feats: bool = True,
    order: Optional[torch.Tensor] = None, pairs: Optional[PairLists] = None,
):
    """(d_feats or None, d_W) of the conv over K offsets for the cotangent
    `grad` (V_out, C_out): d_feats (V_in, C_in) through K2 at K offsets
    on (grad, W^T, rb_bwd) over rb_bwd's row order `order`, counted as a
    `sparse_conv_k_dgrad` launch; d_W through K4 at K offsets over rb_bwd's
    pair lists `pairs`, in weight's dtype (both built where not given).
    `feats` may come padded (as `SparseConvK` saves it); the cotangent
    is padded once for both kernels (`bwd_operands`)."""
    c_in, c_out = weight.shape[1], weight.shape[2]
    g, w_t = bwd_operands(feats, weight, grad)
    d_feats = None
    if need_feats:
        d_feats = sparse_conv(g, w_t, rb_bwd, dgrad=True, order=order)
    d_w = sparse_conv_dw(feats, g, rb_bwd, pairs=pairs)
    return d_feats, dw_unpad(d_w, c_in, c_out, weight.dtype)
