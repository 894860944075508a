"""Strided (ks=2, stride=2) sparse conv pair via the parent relation —
port of `taseg_tpu/ops/strided_conv.py`.

Every fine voxel f belongs to exactly one coarse cell `parent(f)` (the
downsample unique's inverse) at one kernel offset `slot(f)` (its
per-axis parity bits), so:

  down:  out[c] = sum_{f: parent(f)=c} feats[f] @ W[slot(f)]
  up:    out[f] = feats[parent(f)] @ W[slot(f)]

Children of a coarse cell are the contiguous run [starts[c], starts[c+1])
of the downsample unique's sort permutation `perm`.  On CUDA tensors the
wrappers launch the hand-written kernel K3 (`csrc/strided_conv.cu`):
either direction on tensor cores where `downsample_route` /
`upsample_route` say so (bf16, C_in and C_out multiples of 8), everything
else on CUDA cores.  On CPU
tensors they run the plain versions, which follow the JAX
`_slot_matmul`, `_segment_sum` (a mean-centred cumsum) and
`_parent_gather` (`voxelize.run_sums` is the segment sum).  The kernel
sums children directly, so in f32 the two differ by the cumsum's
rounding only (about 1e-6 of the output scale).
Weight layout (8, C_in, C_out) with the z-fastest offset enumeration of
`kernel_offsets(2)`.

Gradients (`DownConv`, `UpConv`; JAX `_down_bwd` :136, `_up_bwd` :169):
the two directions swap, so down's d_feats is exactly
`upsample_conv_apply(g, W^T, tables)` and up's d_feats exactly
`downsample_conv_apply(g, W^T, tables)`; both d_W run the kernel K5
(`strided_dw`, `csrc/conv_dw.cu`), which gathers the parent rows itself,
on one of two routes (`f3conv.dw_route`): for bf16 with C_in and C_out
multiples of 8, K4's tensor-core tile over the level's per-slot pair
lists (`slot_pair_lists`, built once per level and step by the train
topology as `StridedTables.pairs` and shared by the level's down and up
conv); else the CUDA-core kernel over the parent and slot tables.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from . import _build
from .f3conv import PairLists, dw_route, k3_conv_dw_pairs_plain, launch_dw, launch_dw_mma
from .sparse_conv import DTYPE_CODES, route, wants_grad
from .voxelize import run_sums


@dataclass(frozen=True)
class StridedTables:
    """Parent relation between one fine level and its 2x-coarser level.

    parent: (V_fine,) int32 — coarse uid per fine row, -1 for padding.
    slot:   (V_fine,) int32 — kernel-offset index (bx*4 + by*2 + bz).
    perm:   (V_fine,) int32 — fine rows reordered by parent key (invalid
            rows last).
    starts: (V_coarse + 1,) int32 — exclusive prefix over children
            counts; children of c are PERMUTED rows [starts[c], starts[c+1]).
    pairs:  `slot_pair_lists` of these tables, for K5's tensor-core route
            (train topologies; None: the wrapper builds them per call).
    """

    parent: torch.Tensor
    slot: torch.Tensor
    perm: torch.Tensor
    starts: torch.Tensor
    pairs: Optional[PairLists] = None


def build_strided_tables(
    fine_coords: torch.Tensor,
    num_fine: torch.Tensor,
    parent: torch.Tensor,
    counts: torch.Tensor,
    perm: torch.Tensor,
    tensor_stride: int,
) -> StridedTables:
    """From spdownsample's inverse/counts/perm (no extra sort)."""
    s = tensor_stride
    dev = fine_coords.device
    xyz = fine_coords[:, :3].to(torch.int32)
    bits = (xyz % (2 * s)) // s
    slot = (bits[:, 0] * 4 + bits[:, 1] * 2 + bits[:, 2]).to(torch.int32)
    v = fine_coords.shape[0]
    valid = (torch.arange(v, dtype=torch.int32, device=dev) < num_fine) & (
        parent >= 0
    )
    starts = torch.cat(
        [
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.cumsum(counts, 0, dtype=torch.int32),
        ]
    )
    return StridedTables(
        parent=torch.where(valid, parent, -1).to(torch.int32),
        slot=slot,
        perm=perm.to(torch.int32),
        starts=starts,
    )


def slot_pair_lists(tables: StridedTables) -> PairLists:
    """K5's PairLists: per slot s, the pairs (f, parent f) of the live
    fine rows f of slot s, in row order, in a (V_fine, 2) buffer (every
    live row has one slot, so the lists partition the live rows) with a
    (9,) start table.  On the tables' device, by one prefix sum over the
    (8, V_fine) slot one-hot and one scatter: no count is read back to
    the host."""
    parent = tables.parent
    v = parent.shape[0]
    dev = parent.device
    slot = (tables.slot & 7).long()
    live = parent >= 0
    onehot = (torch.arange(8, device=dev)[:, None] == slot) & live  # (8, V_fine)
    pos = torch.cumsum(onehot.reshape(-1), 0)  # int64: pairs up to and including each entry
    f = torch.arange(v, device=dev)
    # dead rows all go to one spare row, cut off below
    dest = torch.where(live, pos[slot * v + f] - 1, v)
    # (f, parent f) as one int64, f in the low word: viewed as int32
    # pairs on a little-endian device
    packed = (parent.long() << 32) | f
    out = torch.empty(v + 1, dtype=torch.int64, device=dev)
    out.scatter_(0, dest, packed)
    starts = torch.cat([pos.new_zeros(1), pos[v - 1 :: v]]).int()
    return PairLists(pairs=out[:v].view(torch.int32).view(v, 2), starts=starts)


def downsample_route(dtype: torch.dtype, c_in: int, c_out: int) -> str:
    """The kernel a CUDA call of `downsample_conv_apply` takes: "mma" or
    "simt", by K2's rule (`sparse_conv.route`)."""
    return route(dtype, c_in, c_out)


def upsample_route(dtype: torch.dtype, c_in: int, c_out: int) -> str:
    """The kernel a CUDA call of `upsample_conv_apply` takes: "mma" or
    "simt", by K2's rule (`sparse_conv.route`)."""
    return route(dtype, c_in, c_out)


def slot_child_table(tables: StridedTables) -> torch.Tensor:
    """(rounds, 8, V_coarse) int32: entry [q, s, c] is the q-th child of
    coarse row c at slot s, in `perm` order, -1 for none; children with
    parent < 0 are skipped.  It is the table that the tensor-core down
    kernel builds in shared memory, round by round, so that

        out[c] = sum_q sum_s feats[table[q, s, c]] @ W[s]

    One round covers a cell whose children have distinct slots; more
    rounds come only from cells that fold negative coordinates."""
    starts = tables.starts.long()
    v_coarse = starts.shape[0] - 1
    dev = starts.device
    pos = torch.arange(int(starts[-1]), device=dev)
    cell = torch.searchsorted(starts, pos, right=True) - 1
    f = tables.perm[pos].long()
    live = tables.parent[f] >= 0
    cell, f = cell[live], f[live]
    key = cell * 8 + (tables.slot[f].long() & 7)
    # rank of each child among the earlier children of its (cell, slot)
    order = torch.sort(key, stable=True).indices
    k_sorted = key[order]
    first = torch.searchsorted(k_sorted, k_sorted)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=dev) - first
    rounds = int(rank.max()) + 1 if rank.numel() else 0
    table = torch.full((rounds, 8, v_coarse), -1, dtype=torch.int32, device=dev)
    table[rank, key % 8, cell] = f.to(torch.int32)
    return table


def _slot_matmul(x: torch.Tensor, w: torch.Tensor, tables) -> torch.Tensor:
    """x (V_fine, Ci) -> f32 rows x[f] @ W[slot(f)], zero for padding."""
    live = tables.parent >= 0
    out = None
    for k in range(w.shape[0]):
        oh = ((tables.slot == k) & live).to(x.dtype)[:, None]
        c = (x * oh).float() @ w[k].float()
        out = c if out is None else out + c
    return out


def _parent_gather(rows: torch.Tensor, tables: StridedTables) -> torch.Tensor:
    g = rows[tables.parent.clamp(min=0).long()]
    return torch.where((tables.parent >= 0)[:, None], g, 0)


def downsample_conv_plain(feats, weight, tables: StridedTables):
    h = _slot_matmul(feats, weight, tables)
    return run_sums(h[tables.perm.long()], tables.starts).to(feats.dtype)


def upsample_conv_plain(feats, weight, tables: StridedTables):
    g = _parent_gather(feats, tables)
    return _slot_matmul(g, weight, tables).to(feats.dtype)


def _check(feats, weight, tables, v_fine, v_coarse):
    dev = feats.device
    _build.check("feats", feats, tuple(DTYPE_CODES), 2, dev)
    _build.check("weight", weight, (feats.dtype,), 3, dev)
    if weight.shape[0] != 8 or weight.shape[1] != feats.shape[1]:
        raise ValueError(
            f"weight {tuple(weight.shape)} does not fit feats "
            f"{tuple(feats.shape)}: expected (8, C_in, C_out)"
        )
    for name in ("parent", "slot", "perm"):
        t = getattr(tables, name)
        _build.check(name, t, (torch.int32,), 1, dev)
        if t.shape[0] != v_fine:
            raise ValueError(f"{name}: length {t.shape[0]} != {v_fine}")
    _build.check("starts", tables.starts, (torch.int32,), 1, dev)
    if tables.starts.shape[0] != v_coarse + 1:
        raise ValueError(
            f"starts: length {tables.starts.shape[0]} != {v_coarse + 1}"
        )


def downsample_conv_apply(
    feats: torch.Tensor, weight: torch.Tensor, tables: StridedTables,
    *, dgrad: bool = False,
) -> torch.Tensor:
    """feats (V_fine, Ci), weight (8, Ci, Co) in feats' dtype ->
    (V_coarse, Co).  `dgrad` marks an input-gradient call (counted under
    `strided_down_dgrad` too)."""
    v_fine = feats.shape[0]
    v_coarse = tables.starts.shape[0] - 1
    _check(feats, weight, tables, v_fine, v_coarse)
    if not _build.dispatch(feats):
        return downsample_conv_plain(feats, weight, tables)
    c_in, c_out = weight.shape[1], weight.shape[2]
    out = torch.empty((v_coarse, c_out), dtype=feats.dtype, device=feats.device)
    if v_coarse == 0 or c_out == 0:
        return out
    if v_fine == 0 or c_in == 0:
        return out.zero_()
    ptrs = (
        feats.data_ptr(), weight.data_ptr(), tables.parent.data_ptr(),
        tables.slot.data_ptr(), tables.perm.data_ptr(),
        tables.starts.data_ptr(), out.data_ptr(),
    )
    if downsample_route(feats.dtype, c_in, c_out) == "mma":
        _build.check_aligned(feats=feats, weight=weight)
        _build.launch(
            "taseg_strided_down_mma", _build.counters("strided_down", dgrad=dgrad, suffix="_mma"),
            *ptrs, v_coarse, c_in, c_out,
        )
    else:
        _build.launch(
            "taseg_strided_down", _build.counters("strided_down", dgrad=dgrad),
            *ptrs, v_fine, v_coarse, c_in, c_out, DTYPE_CODES[feats.dtype],
        )
    return out


def upsample_conv_apply(
    feats: torch.Tensor, weight: torch.Tensor, tables: StridedTables,
    *, dgrad: bool = False,
) -> torch.Tensor:
    """Transposed pair: feats (V_coarse, Ci), weight (8, Ci, Co) in feats'
    dtype -> (V_fine, Co); out[f] = feats[parent(f)] @ W[slot(f)].
    `dgrad` marks an input-gradient call (counted under
    `strided_up_dgrad` too)."""
    v_fine = tables.parent.shape[0]
    v_coarse = feats.shape[0]
    _check(feats, weight, tables, v_fine, v_coarse)
    if not _build.dispatch(feats):
        return upsample_conv_plain(feats, weight, tables)
    c_in, c_out = weight.shape[1], weight.shape[2]
    out = torch.empty((v_fine, c_out), dtype=feats.dtype, device=feats.device)
    if v_fine == 0 or c_out == 0:
        return out
    if v_coarse == 0 or c_in == 0:
        return out.zero_()
    ptrs = (
        feats.data_ptr(), weight.data_ptr(), tables.parent.data_ptr(),
        tables.slot.data_ptr(), out.data_ptr(),
    )
    if upsample_route(feats.dtype, c_in, c_out) == "mma":
        _build.check_aligned(feats=feats, weight=weight)
        _build.launch(
            "taseg_strided_up_mma", _build.counters("strided_up", dgrad=dgrad, suffix="_mma"),
            *ptrs, v_fine, c_in, c_out,
        )
    else:
        _build.launch(
            "taseg_strided_up", _build.counters("strided_up", dgrad=dgrad),
            *ptrs, v_fine, c_in, c_out, DTYPE_CODES[feats.dtype],
        )
    return out


def strided_dw_plain(x, y, tables: StridedTables, up: bool) -> torch.Tensor:
    """d_W (8, C_in, C_out) f32 = sum over live fine rows f of slot s of
    X[f]^T (x) Y[f], the coarse side gathered by parent (JAX's einsum
    "vk,vc,vo->kco", f32 products and sums)."""
    if up:
        x = _parent_gather(x, tables)
    else:
        y = _parent_gather(y, tables)
    live = tables.parent >= 0
    yf = y.float()
    out = []
    for s in range(8):
        oh = ((tables.slot == s) & live)[:, None]
        out.append(torch.where(oh, x, 0).float().t() @ yf)
    return torch.stack(out)


def strided_dw_pairs_plain(x, y, pairs: PairLists, up: bool) -> torch.Tensor:
    """d_W (8, C_in, C_out) f32 over the per-slot pair lists, the
    arithmetic of K5's tensor-core route: per slot, the gathered x rows^T
    @ the gathered y rows; the up direction reads each (f, parent f)
    pair swapped."""
    if up:
        pairs = PairLists(pairs=pairs.pairs.flip(1), starts=pairs.starts)
    return k3_conv_dw_pairs_plain(x, y, pairs)


def strided_dw(
    x: torch.Tensor, y: torch.Tensor, tables: StridedTables, up: bool,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """K5: the weight gradient of the strided pair, (8, C_in, C_out)
    summed in f32 and rounded once to `out_dtype`.  down (`up=False`): x
    the fine input (V_fine, C_in), y the coarse cotangent (V_coarse,
    C_out); up: x the coarse input (V_coarse, C_in), y the fine cotangent
    (V_fine, C_out).  The tensor-core route reads `tables.pairs` (built
    here when absent).  Deterministic: the same inputs give the same
    bits."""
    dev = x.device
    _build.check("x", x, tuple(DTYPE_CODES), 2, dev)
    _build.check("y", y, (x.dtype,), 2, dev)
    v_fine = tables.parent.shape[0]
    v_coarse = tables.starts.shape[0] - 1
    fine, coarse = (y, x) if up else (x, y)
    if fine.shape[0] != v_fine or coarse.shape[0] != v_coarse:
        raise ValueError(
            f"rows do not fit the tables: fine {fine.shape[0]} != {v_fine} "
            f"or coarse {coarse.shape[0]} != {v_coarse}"
        )
    for name in ("parent", "slot"):
        _build.check(name, getattr(tables, name), (torch.int32,), 1, dev)
    if not _build.dispatch(x):
        return strided_dw_plain(x, y, tables, up).to(out_dtype)
    c_in, c_out = x.shape[1], y.shape[1]
    if v_fine == 0 or v_coarse == 0 or c_in == 0 or c_out == 0:
        return torch.zeros((8, c_in, c_out), dtype=out_dtype, device=dev)
    if dw_route(x.dtype, c_in, c_out) == "mma":
        pairs = tables.pairs if tables.pairs is not None else slot_pair_lists(tables)
        out = launch_dw_mma(
            "taseg_strided_dw_mma", "strided_dw", x, y, pairs, 8, v_fine, v_fine, int(up),
        )
        return out.to(out_dtype)
    out = launch_dw(
        "taseg_strided_dw", "strided_dw",
        (x.data_ptr(), y.data_ptr(), tables.parent.data_ptr(), tables.slot.data_ptr()),
        (v_fine, c_in, c_out, int(up)), v_fine, 8, x.dtype, dev,
    )
    return out.to(out_dtype)


class DownConv(torch.autograd.Function):
    """`downsample_conv_apply` with its gradient (JAX `_down_bwd`):
    d_feats = up(g, W^T) through K3-up, d_W through K5.  Saves feats and
    weight; the tables by reference."""

    @staticmethod
    def forward(ctx, feats, weight, tables):
        ctx.save_for_backward(feats, weight)
        ctx.tables = tables
        return downsample_conv_apply(feats, weight, tables)

    @staticmethod
    def backward(ctx, g):
        feats, weight = ctx.saved_tensors
        g = g.contiguous().to(feats.dtype)
        d_feats = None
        if ctx.needs_input_grad[0]:
            w_t = weight.transpose(1, 2).contiguous()
            d_feats = upsample_conv_apply(g, w_t, ctx.tables, dgrad=True)
        d_w = strided_dw(feats, g, ctx.tables, up=False, out_dtype=weight.dtype)
        return d_feats, d_w, None


class UpConv(torch.autograd.Function):
    """`upsample_conv_apply` with its gradient (JAX `_up_bwd`): d_feats =
    down(g, W^T) through K3-down, d_W through K5, which gathers the
    coarse rows by parent itself (the (V_fine, C_in) gathered rows that
    the JAX forward keeps are not saved)."""

    @staticmethod
    def forward(ctx, feats, weight, tables):
        ctx.save_for_backward(feats, weight)
        ctx.tables = tables
        return upsample_conv_apply(feats, weight, tables)

    @staticmethod
    def backward(ctx, g):
        feats, weight = ctx.saved_tensors
        g = g.contiguous().to(feats.dtype)
        d_feats = None
        if ctx.needs_input_grad[0]:
            w_t = weight.transpose(1, 2).contiguous()
            d_feats = downsample_conv_apply(g, w_t, ctx.tables, dgrad=True)
        d_w = strided_dw(feats, g, ctx.tables, up=True, out_dtype=weight.dtype)
        return d_feats, d_w, None


def downsample_conv(feats, weight, tables: StridedTables) -> torch.Tensor:
    """`downsample_conv_apply`, differentiable where autograd asks."""
    if wants_grad(feats, weight):
        return DownConv.apply(feats, weight, tables)
    return downsample_conv_apply(feats, weight, tables)


def upsample_conv(feats, weight, tables: StridedTables) -> torch.Tensor:
    """`upsample_conv_apply`, differentiable where autograd asks."""
    if wants_grad(feats, weight):
        return UpConv.apply(feats, weight, tables)
    return upsample_conv_apply(feats, weight, tables)
