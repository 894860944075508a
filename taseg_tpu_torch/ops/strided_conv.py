"""Strided (ks=2, stride=2) sparse conv pair via the parent relation —
port of `taseg_tpu/ops/strided_conv.py`.

Every fine voxel f belongs to exactly one coarse cell `parent(f)` (the
downsample unique's inverse) at one kernel offset `slot(f)` (its
per-axis parity bits), so:

  down:  out[c] = sum_{f: parent(f)=c} feats[f] @ W[slot(f)]
  up:    out[f] = feats[parent(f)] @ W[slot(f)]

Children of a coarse cell are the contiguous run [starts[c], starts[c+1])
of the downsample unique's sort permutation `perm`.  The down direction
is also a conv over 8 offsets from V_fine rows to V_coarse rows, over the
child table (`slot_child_table`: entry [s, c] the child of cell c at slot
s; one round of it where coordinates are non-negative, as on every path),
which the topology builds once per level with its row order
(`StridedTables.child`, `child_order`).  The up direction is a conv over
8 offsets from V_coarse to V_fine rows too, over the up table
(`slot_up_table`: entry [s, f] the parent of fine row f where its slot is
s, -1 elsewhere; `StridedTables.up`, `up_order`, built by the topology
with the level's orders: its row order groups the fine rows by slot).
On CUDA tensors the wrappers launch hand-written kernels, by
`downsample_route` / `upsample_route`: over a one-round child table, or
the up table, in bf16 on K2's wgmma tile at K = 8
(`sparse_conv.launch_wgmma`), in f32 on K2 at K's 3xTF32 tile
(`sparse_conv.launch_k_tf32`), ragged widths padded to whole 16-byte
pieces (`sparse_conv.padded_call`); a child table of several rounds
(cells that fold negative coordinates) on K3-down's round kernels of
`csrc/strided_conv.cu` ("rounds": its tensor-core one in bf16, its
CUDA-core one in f32).  On CPU
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
in one launch, on one of three routes (`f3conv.dw_route(...,
strided=True)`): over the level's per-slot pair lists
(`slot_pair_lists`, built once per level and step by the train topology
as `StridedTables.pairs` and shared by the level's down and up conv) on
Hopper's wgmma for bf16, on 3xTF32 wgmma for f32 (the tile of K4 at K
offsets), at padded widths, the splits of a list added in the kernel by
its last block.
The autograd Functions pad the input and the cotangent once for the
calls that share them (`sparse_conv.padded_feats`,
`f3conv.bwd_operands`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from . import _build
from . import sparse_conv as _sc
from .f3conv import (
    PairLists, bwd_operands, check_pair_lists, dw_route, dw_unpad, k3_conv_dw_pairs_plain, k5_splits,
    launch_dw_tf32,
)
from .sparse_conv import (
    DTYPE_CODES,
    launch_k_tf32,
    launch_wgmma,
    logical_cols,
    pad_cols,
    pad_weight,
    padded_call,
    padded_feats,
    padded_width,
    sparse_conv_plain,
    takes_cols,
    unpad,
    wants_grad,
)
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
    pairs:  `slot_pair_lists` of these tables, for K5's tensor-core routes
            (train topologies; None: the wrapper builds them per call).
    child:  `slot_child_table` of these tables, (rounds, 8, V_coarse)
            int32, read by K3-down's routes (None: built per call).
    child_order: `mask_row_order(child[0])` where child has one round
            (None: built per call).
    up:     `slot_up_table` of these tables, (8, V_fine) int32, read by
            K3-up's tensor-core routes (None: built per call).
    up_order: `mask_row_order(up)`: the fine rows grouped by slot, dead
            rows last (None: built per call).
    """

    parent: torch.Tensor
    slot: torch.Tensor
    perm: torch.Tensor
    starts: torch.Tensor
    pairs: Optional[PairLists] = None
    child: Optional[torch.Tensor] = None
    child_order: Optional[torch.Tensor] = None
    up: Optional[torch.Tensor] = None
    up_order: Optional[torch.Tensor] = None


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


def downsample_route(dtype: torch.dtype, c_in: int, c_out: int, rounds: int = 1) -> str:
    """The kernel a CUDA call of `downsample_conv_apply` takes, from its
    child table's rounds (`StridedTables.child.shape[0]`) and dtype, at
    any widths (each padded to `sparse_conv.padded_width`): over one round
    "wgmma" (K2's wgmma tile at K = 8) for bf16, "tf32x3" (K2 at K's
    3xTF32 tile) for f32; over several rounds "rounds": K3-down's round
    kernels of csrc/strided_conv.cu (its tensor-core one for bf16, its
    CUDA-core one for f32), which walk each cell's children themselves."""
    if rounds > 1:
        return "rounds"
    return upsample_route(dtype, c_in, c_out)


def k3_tf32_splits(v_out: int, c_in: int) -> int:
    """Parts of each tile's chain of K3's 3xTF32 route (over a child or
    an up table of V_out rows): K2 at K's rule (`sparse_conv.k_splits`),
    at most one per 16 stages of the full chain (8 slots x C_in chunks of
    32): a child table's tiles run 1-3 slots each, an up table's 1-2, too
    few stages to share (as the wgmma route's rule)."""
    return max(1, min(_sc.k_splits(v_out), 8 * -(-c_in // 32) // 16))


def upsample_route(dtype: torch.dtype, c_in: int, c_out: int) -> str:
    """The kernel a CUDA call of `upsample_conv_apply` takes, over the
    level's up table, at any widths (each padded to
    `sparse_conv.padded_width`): "wgmma" (K2's wgmma tile at K = 8) for
    bf16, "tf32x3" (K2 at K's 3xTF32 tile) for f32 (any other dtype:
    "simt", which the wrappers refuse)."""
    return {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}.get(dtype, "simt")


def slot_up_table(tables: StridedTables) -> torch.Tensor:
    """(8, V_fine) int32: entry [s, f] is parent f where slot f == s and
    parent f >= 0, else -1 (one elementwise op).  It is the table of
    K3-up as a conv over 8 offsets from the coarse rows to the fine ones:

        out[f] = sum_s feats[table[s, f]] @ W[s] = feats[parent f] @ W[slot f]
    """
    slot = (tables.slot & 7).long()
    s = torch.arange(8, device=slot.device)[:, None]
    return torch.where((s == slot) & (tables.parent >= 0), tables.parent, -1)


def slot_child_table(tables: StridedTables, rounds: Optional[int] = None) -> torch.Tensor:
    """(rounds, 8, V_coarse) int32: entry [q, s, c] is the q-th child of
    coarse row c at slot s, in `perm` order, -1 for none; children with
    parent < 0 are skipped.  It is the table of K3-down as a conv over 8
    offsets:

        out[c] = sum_q sum_s feats[table[q, s, c]] @ W[s]

    One round covers a cell whose children have distinct slots; more
    rounds come only from cells that fold negative coordinates.  With
    `rounds=1` the caller vouches for that (non-negative coordinates: the
    host pipelines shift them): one scatter of the live rows by (slot,
    parent), nothing read back.  Else the rounds are counted (one read of
    the largest rank) and at least one is built."""
    if rounds == 1:
        parent = tables.parent
        v_coarse = tables.starts.shape[0] - 1
        live = parent >= 0
        f = torch.arange(parent.shape[0], dtype=torch.int32, device=parent.device)
        # dead rows all go to one spare column, cut off below
        dest = torch.where(live, (tables.slot.long() & 7) * (v_coarse + 1) + parent.long(), v_coarse)
        table = torch.full((8 * (v_coarse + 1),), -1, dtype=torch.int32, device=parent.device)
        table.scatter_(0, dest, torch.where(live, f, -1))
        return table.view(1, 8, v_coarse + 1)[:, :, :v_coarse].contiguous()
    if rounds is not None:
        raise ValueError(f"rounds: 1 or None (counted), got {rounds}")
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
    rounds = int(rank.max()) + 1 if rank.numel() else 1
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
    feats = logical_cols(feats, weight.shape[1])
    h = _slot_matmul(feats, weight, tables)
    return run_sums(h[tables.perm.long()], tables.starts).to(feats.dtype)


def downsample_conv_slot_plain(feats, weight, child: torch.Tensor):
    """The down conv over a child table (rounds, 8, V_coarse), the
    arithmetic of its K2-tile routes: per round, the per-slot gather +
    f32 matmul of `sparse_conv.sparse_conv_plain`, summed in f32 over the
    rounds and rounded once."""
    out = None
    for q in range(child.shape[0]):
        c = sparse_conv_plain(feats.float(), weight.float(), child[q])
        out = c if out is None else out + c
    return out.to(feats.dtype)


def upsample_conv_plain(feats, weight, tables: StridedTables):
    g = _parent_gather(logical_cols(feats, weight.shape[1]), tables)
    return _slot_matmul(g, weight, tables).to(feats.dtype)


def upsample_conv_up_plain(feats, weight, up: torch.Tensor):
    """The up conv over an up table (8, V_fine), the arithmetic of its
    K2-tile routes: the per-slot gather + f32 matmul of
    `sparse_conv.sparse_conv_plain`, rounded once."""
    return sparse_conv_plain(feats.float(), weight.float(), up).to(feats.dtype)


def _check_weights(feats, weight):
    dev = feats.device
    _build.check("feats", feats, tuple(DTYPE_CODES), 2, dev)
    # any strides: the input gradient passes W^T as a view of W
    _build.check("weight", weight, (feats.dtype,), 3, dev, contiguous=False)
    if weight.shape[0] != 8 or not takes_cols(feats, weight.shape[1]):
        raise ValueError(
            f"weight {tuple(weight.shape)} does not fit feats "
            f"{tuple(feats.shape)}: expected (8, C_in, C_out)"
        )


def _check(feats, weight, tables, v_fine, v_coarse):
    dev = feats.device
    _check_weights(feats, weight)
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
    """feats (V_fine, Ci) (or zero-padded to `padded_width(Ci)`), weight
    (8, Ci, Co) in feats' dtype -> (V_coarse, Co).  The route (`downsample_route`) reads the child
    table's rounds: `tables.child` and `tables.child_order` (built here,
    with one host read for the rounds, where the topology gave none).
    `dgrad` marks an input-gradient call (counted under
    `strided_down_dgrad` too)."""
    v_fine = feats.shape[0]
    v_coarse = tables.starts.shape[0] - 1
    if tables.child is None or not _build.dispatch(feats):
        _check(feats, weight, tables, v_fine, v_coarse)
    else:  # the child table's routes read no other table
        _check_weights(feats, weight)
    if not _build.dispatch(feats):
        return downsample_conv_plain(feats, weight, tables)
    c_in, c_out = weight.shape[1], weight.shape[2]
    if v_coarse == 0 or c_out == 0 or v_fine == 0 or c_in == 0:
        return torch.zeros((v_coarse, c_out), dtype=feats.dtype, device=feats.device)
    child = tables.child if tables.child is not None else slot_child_table(tables)
    _build.check("child", child, (torch.int32,), 3, feats.device)
    if child.shape[1:] != (8, v_coarse):
        raise ValueError(f"child {tuple(child.shape)} does not fit (rounds, 8, {v_coarse})")
    r = downsample_route(feats.dtype, c_in, c_out, child.shape[0])
    order = tables.child_order if tables.child is not None else None
    if r == "wgmma":
        counters = _build.counters("strided_down", dgrad=dgrad, suffix="_wgmma")
        return padded_call(feats, weight, v_coarse, lambda x, w, o: launch_wgmma(
            x, w, child[0], order, o, counters, entry="taseg_strided_down_wgmma"))
    if r == "tf32x3":
        counters = _build.counters("strided_down", dgrad=dgrad, suffix="_tf32")
        splits = k3_tf32_splits(v_coarse, padded_width(feats.dtype, c_in))
        return padded_call(feats, weight, v_coarse, lambda x, w, o: launch_k_tf32(
            x, w, child[0], order, o, counters, splits=splits))
    if tables.child is not None:
        _check(feats, weight, tables, v_fine, v_coarse)
    counters = _build.counters("strided_down", dgrad=dgrad, suffix="_rounds")

    def rounds(x, w, o):
        ptrs = (
            x.data_ptr(), w.data_ptr(), tables.parent.data_ptr(), tables.slot.data_ptr(),
            tables.perm.data_ptr(), tables.starts.data_ptr(), o.data_ptr(),
        )
        if x.dtype == torch.bfloat16:
            _build.check_aligned(feats=x, weight=w)
            _build.launch("taseg_strided_down_mma", counters, *ptrs, v_coarse, x.shape[1], o.shape[1])
        else:
            _build.launch(
                "taseg_strided_down", counters,
                *ptrs, v_fine, v_coarse, x.shape[1], o.shape[1], DTYPE_CODES[x.dtype],
            )

    if feats.dtype == torch.bfloat16:  # the round tile copies 16-byte pieces too
        ci, co = padded_width(feats.dtype, c_in), padded_width(feats.dtype, c_out)
        feats, weight = pad_cols(feats, ci), pad_weight(weight, ci, co).contiguous()
    else:
        feats, weight = logical_cols(feats, c_in).contiguous(), weight.contiguous()
    out = torch.empty((v_coarse, weight.shape[2]), dtype=feats.dtype, device=feats.device)
    rounds(feats, weight, out)
    return unpad(out, c_out)


def upsample_conv_apply(
    feats: torch.Tensor, weight: torch.Tensor, tables: StridedTables,
    *, dgrad: bool = False,
) -> torch.Tensor:
    """Transposed pair: feats (V_coarse, Ci) (or zero-padded to
    `padded_width(Ci)`), weight (8, Ci, Co) in feats' dtype -> (V_fine,
    Co); out[f] = feats[parent(f)] @ W[slot(f)].  The tensor-core routes (`upsample_route`) read `tables.up` and
    `tables.up_order` (built here where the topology gave none).  `dgrad`
    marks an input-gradient call (counted under `strided_up_dgrad`
    too)."""
    v_fine = tables.parent.shape[0]
    v_coarse = feats.shape[0]
    _check(feats, weight, tables, v_fine, v_coarse)
    if not _build.dispatch(feats):
        return upsample_conv_plain(feats, weight, tables)
    c_in, c_out = weight.shape[1], weight.shape[2]
    if v_fine == 0 or c_out == 0 or v_coarse == 0 or c_in == 0:
        return torch.zeros((v_fine, c_out), dtype=feats.dtype, device=feats.device)
    up, order = (tables.up, tables.up_order) if tables.up is not None else (slot_up_table(tables), None)
    _build.check("up", up, (torch.int32,), 2, feats.device)
    if up.shape != (8, v_fine):
        raise ValueError(f"up {tuple(up.shape)} does not fit (8, {v_fine})")
    if upsample_route(feats.dtype, c_in, c_out) == "wgmma":
        counters = _build.counters("strided_up", dgrad=dgrad, suffix="_wgmma")
        return padded_call(feats, weight, v_fine, lambda x, w, o: launch_wgmma(
            x, w, up, order, o, counters, entry="taseg_strided_up_wgmma"))
    counters = _build.counters("strided_up", dgrad=dgrad, suffix="_tf32")
    splits = k3_tf32_splits(v_fine, padded_width(feats.dtype, c_in))
    return padded_call(feats, weight, v_fine, lambda x, w, o: launch_k_tf32(
        x, w, up, order, o, counters, splits=splits))


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
    arithmetic of K5's tensor-core routes: per slot, the gathered x rows^T
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
    (V_fine, C_out).  The tensor-core routes read `tables.pairs` (built
    here when absent).  One launch; deterministic: the same inputs give
    the same bits."""
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
    pairs = tables.pairs if tables.pairs is not None else slot_pair_lists(tables)
    ci, co = padded_width(x.dtype, c_in), padded_width(x.dtype, c_out)
    out = _strided_dw_lists(
        pad_cols(x, ci), pad_cols(y, co), pairs, v_fine, up, dw_route(x.dtype, c_in, c_out, strided=True)
    )
    return dw_unpad(out, c_in, c_out, out_dtype)


def _strided_dw_lists(x, y, pairs: PairLists, v_fine: int, up: bool, route: str) -> torch.Tensor:
    """K5 over the slot lists `pairs` (a (>= V_fine, 2) buffer, (9,)
    starts) on its "wgmma" route (bf16) or its "tf32x3" one (f32, the
    3xTF32 wgmma tile, `f3conv.launch_dw_tf32`): one launch, the splits of
    a list added in split order by the last of its blocks to finish."""
    if route == "tf32x3":
        return launch_dw_tf32("taseg_strided_dw_tf32", "strided_dw", x, y, pairs, 8, v_fine, v_fine, int(up))
    return _launch_k5_lists("taseg_strided_dw_wgmma", _build.counters("strided_dw", suffix="_wgmma"),
                            x, y, pairs, v_fine, up)


def strided_dw_tf32_mma(x, y, pairs: PairLists, v_fine: int, up: bool) -> torch.Tensor:
    """K5's f32 mma.sync tile over the slot lists, which the 3xTF32 wgmma
    tile replaced (C entry `taseg_strided_dw_tf32_mma`), counted nowhere:
    the yardstick of chip_smoke.py and the card tests, on no path.  x, y
    f32 with widths in 4s -> f32 (8, C_in, C_out)."""
    return _launch_k5_lists("taseg_strided_dw_tf32_mma", (), x, y, pairs, v_fine, up)


def _launch_k5_lists(entry: str, counters: tuple, x, y, pairs: PairLists, v_fine: int, up: bool):
    """One launch of a K5 entry that takes its splits from the shapes
    (`f3conv.k5_splits`): the bf16 wgmma tile, or the f32 mma.sync
    yardstick."""
    dev = x.device
    check_pair_lists(x, y, pairs, 8, v_fine)
    c_in, c_out = x.shape[1], y.shape[1]
    splits, per = k5_splits(v_fine, c_in, c_out)
    out = torch.empty((8, c_in, c_out), dtype=torch.float32, device=dev)
    part = cnt = None
    pieces = 8  # one block per (tile, piece): a list's splits are its pieces
    if splits > 1:
        pieces = v_fine // per + 9
        part = torch.empty((pieces, c_in, c_out), dtype=torch.float32, device=dev)
        cnt = _build.zeroed_counters(dev, 8 * _cdiv(c_in, 64) * _cdiv(c_out, 32))
    _build.launch(
        entry, counters, x.data_ptr(), y.data_ptr(), pairs.pairs.data_ptr(), pairs.starts.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(),
        None if cnt is None else cnt.data_ptr(), c_in, c_out, int(up), pieces, per,
    )
    return out


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class DownConv(torch.autograd.Function):
    """`downsample_conv_apply` with its gradient (JAX `_down_bwd`):
    d_feats = up(g, W^T) through K3-up (over the level's up table and
    order, as the forward's up conv), d_W through K5.  On CUDA tensors
    feats are padded once (`padded_feats`) and saved so for K5, g once in
    the backward (`f3conv.bwd_operands`); the tables by reference."""

    @staticmethod
    def forward(ctx, feats, weight, tables):
        x = padded_feats(feats, weight.shape[1])
        ctx.save_for_backward(x, weight)
        ctx.tables = tables
        return downsample_conv_apply(x, weight, tables)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g, w_t = bwd_operands(x, weight, g.contiguous())
        d_feats = None
        if ctx.needs_input_grad[0]:
            d_feats = upsample_conv_apply(g, w_t, ctx.tables, dgrad=True)
        d_w = strided_dw(x, g, ctx.tables, up=False)
        return d_feats, dw_unpad(d_w, weight.shape[1], weight.shape[2], weight.dtype), None


class UpConv(torch.autograd.Function):
    """`upsample_conv_apply` with its gradient (JAX `_up_bwd`): d_feats =
    down(g, W^T) through K3-down (over the level's child table and order,
    as the forward's down conv), d_W through K5, which gathers the
    coarse rows by parent itself (the (V_fine, C_in) gathered rows that
    the JAX forward keeps are not saved).  Operands padded once, as
    `DownConv`'s."""

    @staticmethod
    def forward(ctx, feats, weight, tables):
        x = padded_feats(feats, weight.shape[1])
        ctx.save_for_backward(x, weight)
        ctx.tables = tables
        return upsample_conv_apply(x, weight, tables)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g, w_t = bwd_operands(x, weight, g.contiguous())
        d_feats = None
        if ctx.needs_input_grad[0]:
            d_feats = downsample_conv_apply(g, w_t, ctx.tables, dgrad=True)
        d_w = strided_dw(x, g, ctx.tables, up=True)
        return d_feats, dw_unpad(d_w, weight.shape[1], weight.shape[2], weight.dtype), None


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
