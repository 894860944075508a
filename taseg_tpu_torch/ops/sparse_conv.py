"""Sparse conv forward (K2) — the port's counterpart of
`taseg_tpu/ops/tgf.py:tgf_conv_apply` (the stride-1 27-offset conv of
the MinkUNet path) and of `taseg_tpu/ops/sparse_conv.py:137
sparse_conv_apply` (the conv over any kernel volume, Cylinder3D's).

With a dense (27, V) rulebook the output row of voxel v is

    out[v] = sum_k  feats[rb[k, v]] * (rb[k, v] >= 0)  @  W[k]

On CUDA tensors `sparse_conv_k3` launches a hand-written gather-GEMM of
`csrc/sparse_conv.cu`, chosen by `route`: for bf16 the Hopper tile
(`csrc/wgmma_tile.cuh`: wgmma over the table's row order
`mask_row_order`, a producer warpgroup's cp.async ring, the chains of
the coarse levels cut in `wgmma_splits` parts), the CUDA-core kernel for
a direct f32 call.  The tensor-core tiles copy rows in 16-byte pieces:
a ragged width is zero-padded to whole pieces (`padded_width`) in the
feature columns (an input may come padded already, as the autograd
Functions save it) and the weight (a served weight's padded copy is
kept beside it), and the kernel writes the logical output columns
(`padded_call`).  On CPU tensors it runs `sparse_conv_plain`, the
per-offset gather + matmul of `_conv_fwd_impl`.  Both accumulate in f32
over all 27 offsets and round once to the input dtype.  (The JAX TGF path
rounds each group's transformed rows to the activation dtype before it
sums them, so in bf16 the two packages differ by that rounding.)

The port takes the rulebook directly and builds no TGF tables.

`k3_conv` is the 3^3 conv the models call, differentiable (`K3Conv`,
the counterpart of the custom VJP `_tgf_vjp_bwd`, JAX tgf.py:231): its
backward runs `f3conv.f3_bwd_fused` over the flipped rulebook
`flip_rulebook(rb)` and K4's pair lists, which the topology builds once
per level and step.  Its f32 calls (`k_route`'s "tf32x3") go instead to
`conv_k` at K = 27, on 3xTF32 tensor cores over the level's row order;
so no path reaches the CUDA-core K2 at 27.

The topology builds each level's order once (`k3_order`); a flip maps
equal offset masks to equal masks, so the input gradient's call on the
flipped table reads the same order.

`sparse_conv` is K2 at K <= 32 offsets with a (K, V_out) rulebook over
V_in input rows (V_in != V_out between two levels), counted under
`sparse_conv_k`; `conv_k` its differentiable form (`SparseConvK`, the
counterpart of the custom VJP `_conv_vjp_fwd` / `_conv_vjp_bwd`, JAX
sparse_conv.py:153-201): d_feats is `sparse_conv` on (g, W^T, rb_bwd),
pairing rb_bwd[k] with W[k], and d_W is K4 at K offsets
(`f3conv.sparse_conv_dw`) over the same reverse table.  rb_bwd is the
table of the other direction: `flip_rulebook(rb)` for an odd kernel on
one coordinate set, the down / up table pair (`rulebook.build_rulebook`
and `build_reverse_rulebook`) between two levels.

K2 at K picks its kernel by `k_route`: in f32 the 3xTF32 wgmma tile
over the rows in `mask_row_order(rb)` (rows with equal sets of present
offsets share a 64-row tile, so a tile runs about the offsets its rows
have); in bf16 the bf16 wgmma tile over the same order; both at padded
widths.  wgmma reads f32 (TF32) operands K-major only, so the 3xTF32
tile reads the weight as (K, C_out, C_in), split into its TF32 high and
low parts by the launch (`tf32_operand`): the launch takes the weight at
any strides, and the input gradient's W^T, a transposed view of W, is
read as W is stored (no transposed copy).  A `KTable` carries a table
with its order and, where a weight gradient reads it, its pair lists,
built once by the topology.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import _build

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def route(dtype: torch.dtype, c_in: int, c_out: int) -> str:
    """The kernel a CUDA call of the 27-offset conv takes: "wgmma" (Hopper
    tensor cores, over the table's row order) for bf16 at any widths,
    each padded to `padded_width` (a multiple of 8), else "simt" (CUDA
    cores).  `k3_conv` asks `k_route` first: its f32 calls go to the conv
    over K = 27 offsets on 3xTF32, so "simt" serves only a direct f32
    call of `sparse_conv_k3`."""
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def k_route(dtype: torch.dtype, c_in: int, c_out: int) -> str:
    """The kernel a CUDA call of K2 or K4 at K offsets takes: "tf32x3"
    (tensor cores, each f32 product as three TF32 products of its
    operands' high and low parts, within the f32 tolerance) for f32,
    "wgmma" for bf16 (K2 only: K4 at K has no bf16 tensor-core route);
    at any widths, each padded to `padded_width`."""
    return "tf32x3" if dtype == torch.float32 else route(dtype, c_in, c_out)


# The tensor-core routes copy rows in 16-byte pieces, so they run at
# widths of whole pieces: C rounded up to a multiple of 8 (bf16) or 4
# (f32).  The wrappers zero-pad the feature columns and the weight's rows
# and columns to those widths, run the kernel there, and hand back the
# logical columns: a zero column adds nothing to a sum, so the padded
# call computes the same products in the same order.  The weight's width
# is the logical one; the input may come padded (`takes_cols`)
ROW_PIECE = 16


def padded_width(dtype: torch.dtype, c: int) -> int:
    """`c` rounded up to whole 16-byte pieces of `dtype`."""
    q = ROW_PIECE // dtype.itemsize
    return -(-c // q) * q


def pad_cols(x: torch.Tensor, c: int) -> torch.Tensor:
    """x (..., C0) with zero columns up to `c` (x itself where C0 == c)."""
    return x if x.shape[-1] == c else torch.nn.functional.pad(x, (0, c - x.shape[-1]))


def pad_weight(w: torch.Tensor, c_in: int, c_out: int) -> torch.Tensor:
    """w (K, C_in0, C_out0) with zero rows and columns up to (c_in, c_out)
    (w itself, at its strides, where it has them; else a contiguous copy).
    A weight that takes no gradient (a served model's: `layers.SparseConv`
    keeps its cast kernel while the kernel is unchanged) keeps its padded
    copy beside it while its version holds, so a served conv pads its
    weight once."""
    if w.shape[1:] == (c_in, c_out):
        return w
    if w.requires_grad:
        return torch.nn.functional.pad(w, (0, c_out - w.shape[2], 0, c_in - w.shape[1]))
    hit = getattr(w, "_taseg_padded", None)
    if hit is None or hit[0] != w._version or hit[1].shape[1:] != (c_in, c_out):
        hit = (w._version, torch.nn.functional.pad(w, (0, c_out - w.shape[2], 0, c_in - w.shape[1])))
        w._taseg_padded = hit
    return hit[1]


def unpad(x: torch.Tensor, *widths: int) -> torch.Tensor:
    """The leading `widths` of x's last len(widths) dims, contiguous (x
    itself where they are whole)."""
    if tuple(x.shape[-len(widths):]) == widths:
        return x
    return x[(..., *(slice(0, w) for w in widths))].contiguous()


def takes_cols(feats: torch.Tensor, c_in: int) -> bool:
    """Whether feats' columns fit a weight of `c_in` rows: c_in, or c_in
    zero-padded to `padded_width` (an input that its autograd Function
    padded once, for the forward and for the weight gradient)."""
    return feats.shape[-1] in (c_in, padded_width(feats.dtype, c_in))


def logical_cols(feats: torch.Tensor, c_in: int) -> torch.Tensor:
    """feats' first `c_in` columns (feats itself where it has no more):
    the plain versions' view of a padded input."""
    return feats if feats.shape[-1] == c_in else feats[..., :c_in]


def padded_feats(feats: torch.Tensor, c_in: int) -> torch.Tensor:
    """feats (V, c_in) zero-padded to the tensor-core routes' width on
    CUDA tensors, as given on the CPU (whose plain versions take any
    width): an autograd Function pads its input once, for the forward
    and for the weight gradient that reads it again."""
    return pad_cols(feats, padded_width(feats.dtype, c_in)) if _build.dispatch(feats) else feats


def padded_call(feats: torch.Tensor, weight: torch.Tensor, v_out: int, launch) -> torch.Tensor:
    """Run `launch(feats_p, weight_p, out)` on feats and weight padded to
    the routes' widths (feats may come padded already; the kernel writes
    only the output's columns) and return out, (v_out, C_out)."""
    c_in, c_out = weight.shape[1], weight.shape[2]
    ci, co = padded_width(feats.dtype, c_in), padded_width(feats.dtype, c_out)
    out = torch.empty((v_out, c_out), dtype=feats.dtype, device=feats.device)
    launch(pad_cols(feats, ci), pad_weight(weight, ci, co), out)
    return out


# split rule of K2 at K's 3xTF32 route (csrc/sparse_conv.cu): a 64-row
# tile runs a chain of (present offsets) x (C_in / 32) stages.  A table of
# at most K_SPLIT_ROWS output rows (Cylinder's coarse levels: 12-29k rows
# of capacity, a fifth of them occupied) has too few tiles to fill the
# card, so each chain is cut into K_SPLITS parts, each its own block, and
# the partials are added in split order afterwards (tools/k2k_tiles.py
# times the tile shapes and split counts at Cylinder's calls)
K_TILE_ROWS = 64
K_SPLITS = 4
K_SPLIT_ROWS = 32768


def k_splits(v_out: int) -> int:
    """Parts of each tile's chain on the 3xTF32 route of K2 at K, from
    the shapes alone."""
    return K_SPLITS if v_out <= K_SPLIT_ROWS else 1


# split rule of the wgmma route (csrc/wgmma_tile.cuh): a table of fewer
# than WGMMA_SPLIT_BLOCKS 64-row tiles (2 blocks per SM of the H100's
# 132) cuts each tile's chain of (present offset) x (C_in chunk) stages
# into ceil(WGMMA_SPLIT_BLOCKS / tiles) parts, one block each, at most
# WGMMA_MAX_SPLITS and at most one per WGMMA_PART_STAGES stages of the
# full chain (K x C_in chunks: a part pays the tile's table load and a
# partial's round trip), and a second kernel adds their f32 partials in
# split order.  `tools/k2_pace.py --splits` chose it (H100, every K2 and
# K3-down shape of MinkUNet's path at 1-8 parts): uncut at 616 tiles and
# more, 2 parts at 248 (MinkUNet's level 3), 3 at 104 (level 4); K3-down's
# 8 slots are cut only from 16 stages (C_in > 64)
WGMMA_SPLIT_BLOCKS = 2 * 132
WGMMA_MAX_SPLITS = 8
WGMMA_PART_STAGES = 8


def wgmma_splits(v_out: int, n_off: int = 27, c_in: int = 64) -> int:
    """Parts of each tile's chain on the wgmma route, from the shapes
    alone (no host read): V_out rows, K offsets, C_in channels."""
    tiles = -(-v_out // K_TILE_ROWS)
    if tiles >= WGMMA_SPLIT_BLOCKS:
        return 1
    chain = n_off * -(-c_in // (64 if c_in % 64 == 0 else 32))
    fill = -(-WGMMA_SPLIT_BLOCKS // max(tiles, 1))
    return max(1, min(WGMMA_MAX_SPLITS, fill, chain // WGMMA_PART_STAGES))


def launch_wgmma(
    feats: torch.Tensor, weight: torch.Tensor, rb: torch.Tensor,
    order: Optional[torch.Tensor], out: torch.Tensor, counters: tuple,
    entry: str = "taseg_sparse_conv_wgmma",
) -> None:
    """K2's wgmma route (and K3-down's, on the child table, through its
    own C `entry`, which names the kernel apart in a profile): feats
    (V_in, C_in) and weight (K, C_in, C_out) bf16 with widths in 8s, rb
    (K, V_out) int32, order rb's `mask_row_order` (built here when None)
    -> out (V_out, <= C_out): the output's first columns (a ragged width
    padded by the caller is written at its own), with
    `wgmma_splits(V_out, K, C_in)` parts per tile chain."""
    dev = feats.device
    v_out, c_out = out.shape[0], weight.shape[2]
    if order is None:
        order = mask_row_order(rb)
    _build.check("order", order, (torch.int32,), 1, dev)
    if order.shape != (v_out,):
        raise ValueError(f"order {tuple(order.shape)} does not fit ({v_out},)")
    weight = weight.contiguous()  # the input gradient's W^T comes as a view
    _build.check_aligned(feats=feats, weight=weight)
    splits = wgmma_splits(v_out, rb.shape[0], feats.shape[1])
    part = live = None
    if splits > 1:
        # one scratch allocation: the f32 partials, then the live flags
        n_part = splits * v_out * c_out
        buf = torch.empty(n_part + splits * -(-v_out // K_TILE_ROWS), dtype=torch.float32, device=dev)
        part, live = buf.data_ptr(), buf.data_ptr() + 4 * n_part
    _build.launch(
        entry, counters,
        feats.data_ptr(), weight.data_ptr(), rb.data_ptr(), order.data_ptr(), out.data_ptr(),
        part, live, v_out, feats.shape[1], c_out, rb.shape[0], splits, out.shape[1],
    )


# the 3xTF32 wgmma tile (csrc/wgmma_tf32.cuh): 64 order entries by BN
# output columns (the least of TF32_TILE_COLS that holds C_out; wider convs
# run several 128-column blocks, each gathering its rows), stages of 32
# input channels (one 128-byte row each) in a ring of 4, each stage A
# (64 rows) and B's high and low parts (BN rows each); tiles of BN <= 64
# run two blocks an SM
TF32_TILE_COLS = (16, 32, 64, 96, 128)
TF32_STAGE_CHANNELS = 32
TF32_RING = 4
SMEM_PER_BLOCK = 232448  # the H100's dynamic shared memory a block may use


class Tf32Tile(NamedTuple):
    """The 3xTF32 wgmma tile's plan for one call."""

    bn: int             # output columns a block
    column_blocks: int  # blocks across C_out (each gathers the rows again)
    chunks: int         # stages per present offset: C_in / 32
    smem_bytes: int     # dynamic shared memory a block
    blocks_per_sm: int  # resident blocks an SM


def tf32_tile(c_in: int, c_out: int, n_off: int) -> Tf32Tile:
    """The 3xTF32 wgmma tile's plan at widths c_in, c_out (multiples of 4,
    as the wrappers pad them) over n_off offsets: the kernel's own choice
    (`wt::with_tile`, `wt::smem_bytes`, `Tile::MIN_BLOCKS`), for tools and
    tests."""
    bn = next((b for b in TF32_TILE_COLS if c_out <= b), TF32_TILE_COLS[-1])
    row = 4 * TF32_STAGE_CHANNELS
    smem = (1024 + TF32_RING * (K_TILE_ROWS * row + 2 * bn * row) + 2 * TF32_RING * 8
            + n_off * K_TILE_ROWS * 4 + K_TILE_ROWS * 4 + 32 * 4 + 8 * 4)
    return Tf32Tile(bn, -(-c_out // bn), -(-c_in // TF32_STAGE_CHANNELS), smem, 2 if bn <= 64 else 1)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as `cvt.rna.tf32.f32` rounds a finite value."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split_plain(weight: torch.Tensor) -> torch.Tensor:
    """The plain version of the weight split (`tf32_split_kernel`): weight
    (K, C_in, C_out) f32 at any strides -> (2, K, C_out, C_in), its TF32
    high part hi = rna(w) and low part rna(w - hi), K-major."""
    w = weight.transpose(1, 2).float()
    hi = tf32_round(w)
    return torch.stack([hi, tf32_round(w - hi)])


def tf32_operand(weight: torch.Tensor) -> tuple:
    """(buffer, fresh): the (2, K, C_out, C_in) f32 buffer of the 3xTF32
    wgmma tile's B operand for weight (K, C_in, C_out) (its TF32 high and
    low parts, K-major: `tf32_split_plain`), and whether the launch must
    fill it.  A weight that takes no gradient (a served model's, kept by
    `layers.SparseConv.kernel_as` and padded once by `pad_weight`) keeps
    its filled operand beside it while its version holds (`keep_tf32`),
    so a served conv splits its weight once."""
    k, c_in, c_out = weight.shape
    shape = (2, k, c_out, c_in)
    hit = None if weight.requires_grad else getattr(weight, "_taseg_tf32", None)
    if hit is not None and hit[0] == weight._version and hit[1].shape == shape:
        return hit[1], False
    return torch.empty(shape, dtype=torch.float32, device=weight.device), True


def keep_tf32(weight: torch.Tensor, buf: torch.Tensor) -> None:
    """Keep the operand `buf` that a launch filled beside a weight that
    takes no gradient (see `tf32_operand`)."""
    if not weight.requires_grad:
        weight._taseg_tf32 = (weight._version, buf)


def launch_k_tf32(
    feats: torch.Tensor, weight: torch.Tensor, rb: torch.Tensor,
    order: Optional[torch.Tensor], out: torch.Tensor, counters: tuple,
    splits: Optional[int] = None,
) -> None:
    """K2 at K's 3xTF32 route (and K3's f32 one, on the child and up
    tables), the wgmma tile: feats (V_in, C_in) and weight (K, C_in,
    C_out) f32 with widths in 4s, the weight at any strides (the input
    gradient's W^T, a transposed view of W, is read as W is stored), rb
    (K, V_out) int32, order rb's `mask_row_order` (built here when None)
    -> out (V_out, <= C_out): the output's first columns, with `splits`
    parts per tile chain (K2 at K's rule `k_splits(V_out)` where None).
    The launch splits the weight into its K-major TF32 operand first,
    unless the weight keeps one (`tf32_operand`)."""
    dev = feats.device
    v_out, c_out = out.shape[0], weight.shape[2]
    if order is None:
        order = mask_row_order(rb)
    _build.check("order", order, (torch.int32,), 1, dev)
    if order.shape != (v_out,):
        raise ValueError(f"order {tuple(order.shape)} does not fit ({v_out},)")
    _build.check_aligned(feats=feats)
    if splits is None:
        splits = k_splits(v_out)
    part = live = None
    if splits > 1:
        part = torch.empty((splits - 1, v_out, c_out), dtype=torch.float32, device=dev)
        live = torch.empty((splits - 1, -(-v_out // K_TILE_ROWS)), dtype=torch.int32, device=dev)
    buf, fresh = tf32_operand(weight)
    _build.launch(
        "taseg_sparse_conv_k_tf32", counters,
        feats.data_ptr(), weight.data_ptr(), rb.data_ptr(), order.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), None if live is None else live.data_ptr(),
        buf.data_ptr(), int(fresh), *weight.stride(),
        v_out, feats.shape[1], c_out, rb.shape[0], splits, out.shape[1],
    )
    if fresh:
        keep_tf32(weight, buf)


class KTable(NamedTuple):
    """A table of the conv over K offsets with what its kernels read
    beside it.

    rb:    (K, V_out) int32 rulebook: rb[k, v] the input row of output row
           v at offset k, -1 for none.
    order: (V_out,) int32 `mask_row_order(rb)`, or None (built at the call).
    pairs: `f3conv.PairLists` of rb, where a weight gradient reads rb as
           its reverse table (train topologies), or None (built at the call).
    """

    rb: torch.Tensor
    order: Optional[torch.Tensor] = None
    pairs: Optional[tuple] = None


def as_table(t) -> KTable:
    """`t` as a KTable (a bare rulebook gets no order or pair lists)."""
    return t if isinstance(t, KTable) else KTable(t)


def mask_row_order(rb: torch.Tensor) -> torch.Tensor:
    """(V_out,) int32 permutation of the rows of a (K, V_out) rulebook:
    rows grouped by their bitmask of present offsets, rows without any
    offset last, table order within a group (one stable sort on the
    device; nothing is read back).  The bitmask sort of TorchSparse++
    (Tang et al., MICRO 2023)."""
    return mask_row_orders([rb])[0]


def mask_row_orders(rbs) -> list:
    """`mask_row_order` of each (K_t, V_t) rulebook of `rbs`, with one
    stable sort per distinct V_t (the tables of one level share it).  The
    key of row v is the bitmask of its ABSENT offsets (bit k set where
    rb[k, v] < 0): a bijection of the present mask, so equal masks
    group, and a row without offsets has all K bits set, the largest key.
    The keys of a group are one float64 product (exact below 2^53) of a
    block matrix of powers of two with the stacked absence flags."""
    out = [None] * len(rbs)
    groups: dict = {}
    for i, rb in enumerate(rbs):
        groups.setdefault(rb.shape[1], []).append(i)
    for idx in groups.values():
        ks = [rbs[i].shape[0] for i in idx]
        bits = torch.zeros((len(idx), sum(ks)), dtype=torch.float64)
        off = 0
        for t, k in enumerate(ks):
            bits[t, off : off + k] = 2.0 ** torch.arange(k, dtype=torch.float64)
            off += k
        dev = rbs[idx[0]].device
        absent = (torch.cat([rbs[i] for i in idx]) < 0).double()
        keys = (bits.to(dev) @ absent).to(torch.int32 if max(ks) < 31 else torch.int64)
        order = torch.sort(keys, dim=1, stable=True).indices.to(torch.int32)
        for t, i in enumerate(idx):
            out[i] = order[t]
    return out


def tile_work(rb: torch.Tensor, order: Optional[torch.Tensor] = None) -> int:
    """Row-offset products the 64-row tiles of the tensor-core routes run
    on a (K, V) table: per tile of `order` (table order where None), 64
    rows x the offsets that some row of the tile has (reads the count
    back: for tools and tests, not the path)."""
    k, v = rb.shape
    present = rb >= 0
    if order is not None:
        present = present[:, order.long()]
    pad = (-v) % K_TILE_ROWS
    hit = torch.nn.functional.pad(present.to(torch.int8), (0, pad))
    return K_TILE_ROWS * int(hit.reshape(k, -1, K_TILE_ROWS).amax(-1).sum())


def sparse_conv_plain(
    feats: torch.Tensor, weight: torch.Tensor, rb: torch.Tensor
) -> torch.Tensor:
    """Per-offset gather -> f32 matmul accumulation, one final rounding
    (feats may come padded: its first C_in columns are read)."""
    feats = logical_cols(feats, weight.shape[1])
    out = None
    for k in range(rb.shape[0]):
        idx = rb[k]
        g = feats[idx.clamp(min=0).long()]
        g = torch.where((idx >= 0)[:, None], g, 0)
        c = g.float() @ weight[k].float()
        out = c if out is None else out + c
    return out.to(feats.dtype)


def flip_rulebook(rb: torch.Tensor) -> torch.Tensor:
    """Reverse table of a same-coordinate-set odd-kernel rulebook (JAX
    sparse_conv.py:207): offset k -> K - 1 - k negates the offset, so
    flip(rb)[k, i] = v  <=>  rb[k, v] = i."""
    return rb.flip(0).contiguous()


def sparse_conv_k3(
    feats: torch.Tensor, weight: torch.Tensor, rb: torch.Tensor,
    *, dgrad: bool = False, order: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """feats (V, C_in) (or zero-padded to `padded_width(C_in)`), weight
    (27, C_in, C_out) in feats' dtype (at any strides), rb (27, V) int32
    -> (V, C_out) in feats' dtype.  The wgmma route
    reads `order`, rb's `mask_row_order` (the level's `k3_order`; built
    here when not given).  `dgrad` marks a call that computes an input
    gradient: its launch also counts under `sparse_conv_k3_dgrad`."""
    dev = feats.device
    _build.check("feats", feats, tuple(DTYPE_CODES), 2, dev)
    _build.check("weight", weight, (feats.dtype,), 3, dev, contiguous=False)
    _build.check("rb", rb, (torch.int32,), 2, dev)
    v, c_in = feats.shape[0], weight.shape[1]
    if weight.shape[0] != 27 or not takes_cols(feats, c_in) or rb.shape != (27, v):
        raise ValueError(
            f"shapes do not fit: feats {tuple(feats.shape)}, weight "
            f"{tuple(weight.shape)}, rb {tuple(rb.shape)}"
        )
    if not _build.dispatch(feats):
        return sparse_conv_plain(feats, weight, rb)
    c_out = weight.shape[2]
    if v == 0 or c_out == 0 or c_in == 0:
        return torch.zeros((v, c_out), dtype=feats.dtype, device=dev)
    if route(feats.dtype, c_in, c_out) == "wgmma":
        counters = _build.counters("sparse_conv_k3", dgrad=dgrad, suffix="_wgmma")
        return padded_call(feats, weight, v, lambda x, w, o: launch_wgmma(x, w, rb, order, o, counters))
    feats, weight = logical_cols(feats, c_in).contiguous(), weight.contiguous()
    out = torch.empty((v, c_out), dtype=feats.dtype, device=dev)
    _build.launch(
        "taseg_sparse_conv_k3", _build.counters("sparse_conv_k3", dgrad=dgrad),
        feats.data_ptr(), weight.data_ptr(), rb.data_ptr(), out.data_ptr(),
        v, c_in, c_out, DTYPE_CODES[feats.dtype],
    )
    return out


class K3Conv(torch.autograd.Function):
    """`sparse_conv_k3` with its gradient, over the KTables `fwd` and
    `bwd` (the flipped rulebook with the level's order and pair lists).
    On CUDA tensors feats are padded to the wgmma route's width once
    (`padded_feats`) and saved so for K4; the tables are held by
    reference (no copy).  The backward returns no
    d_feats where feats need none (the stem's first conv, whose input is
    the voxelized point features)."""

    @staticmethod
    def forward(ctx, feats, weight, fwd, bwd):
        x = padded_feats(feats, weight.shape[1])
        ctx.save_for_backward(x, weight)
        ctx.bwd = bwd
        return sparse_conv_k3(x, weight, fwd.rb, order=fwd.order)

    @staticmethod
    def backward(ctx, grad):
        from .f3conv import f3_bwd_fused

        x, weight = ctx.saved_tensors
        b = ctx.bwd
        d_feats, d_w = f3_bwd_fused(
            x, weight, grad.contiguous(), b.rb,
            need_feats=ctx.needs_input_grad[0], pairs=b.pairs, order=b.order,
        )
        return d_feats, d_w, None, None


def wants_grad(*tensors: torch.Tensor) -> bool:
    """True where autograd records a graph through one of `tensors`: the
    differentiable entry points then go through their Function, else
    straight to the kernel wrapper (inference pays nothing for autograd)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def k3_conv(
    feats: torch.Tensor, weight: torch.Tensor, rb, rb_bwd=None, pairs=None,
) -> torch.Tensor:
    """The stride-1 k3 conv, differentiable where autograd asks for a
    gradient (then `rb_bwd = flip_rulebook(rb)` is required; `pairs`,
    `f3conv.k3_pair_lists(rb_bwd)`, is built in the backward where not
    given), else the plain call.  `rb` and `rb_bwd` are rulebooks or
    `KTable`s (the level's row order, and the reverse table's pair lists).
    The route is `k_route`'s: on "tf32x3" (f32, C_in and C_out multiples
    of 4) the conv over K = 27 offsets (`conv_k`: K2 and K4 at K on 3xTF32
    tensor cores, over the tables' row order and pair lists, built per
    call where absent), else K2 at 27 (`sparse_conv_k3`, over the tables'
    row order on its wgmma route) with K4 (`f3conv.k3_conv_dw`) in its
    backward."""
    fwd = as_table(rb)
    bwd = None if rb_bwd is None else as_table(rb_bwd)
    if bwd is not None and pairs is not None:
        bwd = bwd._replace(pairs=pairs)
    if k_route(feats.dtype, feats.shape[1], weight.shape[2]) == "tf32x3":
        return conv_k(feats, weight, fwd, bwd)
    if wants_grad(feats, weight):
        if bwd is None:
            raise ValueError(
                "a gradient of the k3 conv needs the flipped rulebook: build "
                "the topology with devox_pairs=True"
            )
        return K3Conv.apply(feats, weight, fwd, bwd)
    return sparse_conv_k3(feats, weight, fwd.rb, order=fwd.order)


def sparse_conv(
    feats: torch.Tensor, weight: torch.Tensor, rb: torch.Tensor,
    *, dgrad: bool = False, order: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K2 at K offsets: feats (V_in, C_in) (or zero-padded to
    `padded_width(C_in)`), weight (K, C_in, C_out) in feats' dtype (at
    any strides: the input gradient passes W^T as a view of W), rb
    (K, V_out) int32 of feats rows (-1: none), 1 <= K <= 32 -> (V_out,
    C_out) in feats' dtype, summed in f32 and rounded once.  The 3xTF32 and wgmma
    routes read `order`, rb's `mask_row_order` (built here when not
    given).  `dgrad` marks an input-gradient call (counted again under
    `sparse_conv_k_dgrad`)."""
    dev = feats.device
    _build.check("feats", feats, tuple(DTYPE_CODES), 2, dev)
    _build.check("weight", weight, (feats.dtype,), 3, dev, contiguous=False)
    _build.check("rb", rb, (torch.int32,), 2, dev)
    k, v_out = rb.shape
    c_in = weight.shape[1]
    if weight.shape[0] != k or not takes_cols(feats, c_in) or not 1 <= k <= 32:
        raise ValueError(
            f"shapes do not fit: feats {tuple(feats.shape)}, weight "
            f"{tuple(weight.shape)}, rb {tuple(rb.shape)} (1 <= K <= 32)"
        )
    if not _build.dispatch(feats):
        return sparse_conv_plain(feats, weight, rb)
    c_out = weight.shape[2]
    if v_out == 0 or c_out == 0 or c_in == 0 or feats.shape[0] == 0:
        return torch.zeros((v_out, c_out), dtype=feats.dtype, device=dev)
    if k_route(feats.dtype, c_in, c_out) == "tf32x3":
        counters = _build.counters("sparse_conv_k", dgrad=dgrad, suffix="_tf32")
        launch = lambda x, w, o: launch_k_tf32(x, w, rb, order, o, counters)  # noqa: E731
    else:
        counters = _build.counters("sparse_conv_k", dgrad=dgrad, suffix="_wgmma")
        launch = lambda x, w, o: launch_wgmma(x, w, rb, order, o, counters)  # noqa: E731
    return padded_call(feats, weight, v_out, launch)


class SparseConvK(torch.autograd.Function):
    """`sparse_conv` with its gradient (JAX `_conv_vjp_bwd`).  On CUDA
    tensors feats are padded once (`padded_feats`) and saved so for K4 at
    K; the reverse table `bwd` (a KTable over V_in rows) is held by
    reference.  No d_feats where feats need none."""

    @staticmethod
    def forward(ctx, feats, weight, fwd, bwd):
        x = padded_feats(feats, weight.shape[1])
        ctx.save_for_backward(x, weight)
        ctx.bwd = bwd
        return sparse_conv(x, weight, fwd.rb, order=fwd.order)

    @staticmethod
    def backward(ctx, grad):
        from .f3conv import sparse_conv_bwd

        x, weight = ctx.saved_tensors
        b = ctx.bwd
        d_feats, d_w = sparse_conv_bwd(
            x, weight, grad.contiguous(), b.rb,
            need_feats=ctx.needs_input_grad[0], order=b.order, pairs=b.pairs,
        )
        return d_feats, d_w, None, None


def conv_k(
    feats: torch.Tensor, weight: torch.Tensor, rb, rb_bwd=None,
) -> torch.Tensor:
    """The conv over K offsets, differentiable where autograd asks for a
    gradient (then rb_bwd, the (K, V_in) table of the other direction, is
    required: `flip_rulebook(rb)` for an odd kernel on one level, as JAX's
    layer takes it), else the plain `sparse_conv` call.  `rb` and `rb_bwd`
    are rulebooks or `KTable`s (a table with its row order and pair
    lists)."""
    fwd = as_table(rb)
    if wants_grad(feats, weight):
        if rb_bwd is None:
            raise ValueError(
                "a gradient of this conv needs its reverse rulebook: build the "
                "topology in its train form"
            )
        return SparseConvK.apply(feats, weight, fwd, as_table(rb_bwd))
    return sparse_conv(feats, weight, fwd.rb, order=fwd.order)
