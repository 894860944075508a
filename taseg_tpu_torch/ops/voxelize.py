"""Point<->voxel transforms and their gradients (port of
`taseg_tpu/ops/voxelize.py`).

  * `voxelize_avg`: segment mean of point features per voxel, over the
    sorted-segment layout of `build_segment_tables`; its backward gathers
    each voxel's gradient / count back to the points, the hand kernel K8
    (`voxelize_bwd`, `csrc/devoxelize.cu`, one launch per call,
    bit-identical to the plain version `_voxelize_bwd_plain`) on CUDA
    tensors;
  * `devoxelize`: the identity gather (integer points at stride 1), the
    8-corner trilinear interpolation, or the 4-corner bilinear sample of
    an image (`point_range.range_to_point`), the hand kernel K7
    (`csrc/devoxelize.cu`, one launch per call, bit-identical to the plain
    versions `_devox_identity` / `_devox_trilinear`) on CUDA tensors;
    their backwards are segment sums, over the point tables or over the
    (corner, point) pair table `DevoxTable.pairs`;
  * `devoxelize_multi`: up to three of them in one K7 launch, summed in
    f32 with a bias (the MinkUNet head) or concatenated (KD's features,
    TIAF's taps), plain version `devox_multi_plain`; the sum's backward
    is one K6 call over the scales' pair tables stacked with row offsets
    (`stack_devox_tables`, built by the train topology).

`segment_max` is Cylinder3D's max-pooled voxelization and the global
max pool (JAX `jax.ops.segment_max` in `models/voxel/cylinder3d.py:236`
and `ops/bev.py:43`, an XLA scatter) with JAX's gradient
(`SegmentMax`): the hand kernel K10 (`csrc/segment_max.cu`, one counted
launch each way: the forward's fill and runs kernels, the backward's
zeroed counts, tie count and shares; bit-identical to the plain versions
`segment_max_plain` / `segment_max_bwd_plain`) on CUDA tensors.

Every segment sum (the voxelize forward and both devoxelize backwards)
is `segment_sum`: the hand kernel K6 (`csrc/segment_sum.cu`: the sorted
positions cut into units of equal work, lanes over channels, a
segment cut across units finished by its last piece, in a fixed order,
one launch) on CUDA tensors, the JAX package's mean-centred cumsum
(`segment_sum_plain`) on CPU tensors.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from . import _build
from .coords import GridBounds
from .join import query_coords
from .rulebook import kernel_offsets
from .sparse_conv import DTYPE_CODES, pad_cols, unpad, wants_grad


class SegmentTables(NamedTuple):
    """Sorted-segment layout for segment reductions.

    perm:   (N,) int64 — row order grouping members by segment id
            (members of segment u occupy perm[starts[u]:starts[u+1]]).
    starts: (V+1,) int32 — exclusive prefix of segment sizes.
    counts: (V,) int32 — segment sizes.
    """

    perm: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor


def build_segment_tables(ids: torch.Tensor, num_segments: int) -> SegmentTables:
    """ids: (N,) int32 segment id per row; out-of-range (e.g. -1) = drop.

    One sentinel row per segment is appended so every segment is
    non-empty (as in the JAX package); consumers pad their value rows with
    `num_segments` zero rows, and `counts` excludes the sentinels.  The
    sort is stable and the sentinels come after the N rows, so segment
    u's sentinel (row N + u) is the last of u: its real members are
    perm[starts[u] : starts[u+1] - 1], which is all K6 reads."""
    dev = ids.device
    ids_aug = torch.cat(
        [ids.to(torch.int32), torch.arange(num_segments, dtype=torch.int32, device=dev)]
    )
    in_range = (ids_aug >= 0) & (ids_aug < num_segments)
    key = torch.where(in_range, ids_aug, num_segments)
    perm = torch.sort(key, stable=True).indices
    sizes = torch.zeros(num_segments + 1, dtype=torch.int32, device=dev)
    sizes.scatter_add_(0, key.long(), torch.ones_like(key))
    starts = torch.cat(
        [
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.cumsum(sizes[:num_segments], 0, dtype=torch.int32),
        ]
    )
    counts = starts[1:] - starts[:-1] - 1  # minus the sentinel row
    return SegmentTables(perm=perm, starts=starts, counts=counts)


def run_sums(rows_f32: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Sums of the contiguous runs [starts[u], starts[u+1]) of (N, C) f32
    rows, by a mean-centred cumsum (as the JAX package does: the centring
    keeps the prefixes, and so their rounding, small).  (V, C) out.

    The scan runs over the transposed (C, N) copy: a cumsum along dim 0
    of a narrow (N, C) tensor runs one thread per column on CUDA (23 ms
    per scan at N = 262144, C = 4 on an H100), along the contiguous dim
    it is a fast row scan."""
    center = rows_f32.mean(0, keepdim=True)
    cum = torch.cumsum((rows_f32 - center).t().contiguous(), 1)
    cum = torch.cat([cum.new_zeros((cum.shape[0], 1)), cum], 1)
    lo, hi = starts[:-1].long(), starts[1:].long()
    seg = (cum[:, hi] - cum[:, lo]).t().contiguous()
    return seg + (hi - lo)[:, None].float() * center


def segment_sum_plain(
    src: torch.Tensor, tables: SegmentTables, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K6's plain version, as JAX `_segment_sum_sorted`: the R = N - V
    real rows (row r reads src[r mod P], times weights[r]), zero-padded
    by the V sentinel rows, gathered to sorted order, run sums by a
    mean-centred cumsum.  (V, C) f32 (f64 for f64 input: a reference
    without the cumsum's rounding)."""
    v = tables.starts.shape[0] - 1
    r_real = tables.perm.shape[0] - v
    rows = src.to(torch.promote_types(src.dtype, torch.float32))
    if r_real != rows.shape[0]:
        rows = rows.repeat(r_real // rows.shape[0], 1)
    if weights is not None:
        rows = rows * weights.reshape(-1, 1).to(rows.dtype)
    vals = torch.cat([rows, rows.new_zeros((v, rows.shape[1]))])
    return run_sums(vals[tables.perm], tables.starts)


# K6's partition (csrc/segment_sum.cu): blocks of K6_THREADS threads, one
# unit of consecutive sorted positions per lane group, 8 items a lane up
# to K6_MAX_UNIT items a group
K6_THREADS = 256
K6_MAX_UNIT = 64
# pieces a lane K6 takes, by the bytes of a piece
K6_MAX_PIECES = {16: 8, 8: 8, 4: 16, 2: 8}


# K6 cuts a table by rows, not by units of items, where it has at most one
# member per K6_ROWS_RATIO segments (the image branches' pixel tables)
K6_ROWS_RATIO = 4


def segment_sum_by_rows(r_real: int, v: int) -> bool:
    """Whether K6 takes its rows kernel for a table of `r_real` member rows
    over `v` segments: each warp sums 32 consecutive rows and stores them
    in order, with no search (the zero rows, most of a sparse table's
    bytes, stream out); else the units of equal work."""
    return K6_ROWS_RATIO * r_real <= v


class SegmentSumPlan(NamedTuple):
    """How K6 lays a call out: `vw` bytes of a source row per lane piece,
    `lanes` groups of that many lanes per segment row (a power of two up
    to 32), `pieces` per lane, `unit` sorted positions per group."""

    vw: int
    lanes: int
    pieces: int
    unit: int


@functools.lru_cache(maxsize=None)
def _plan(c: int, esz: int, addr16: int) -> tuple:
    return segment_sum_cols(c, esz, addr16), segment_sum_plan(c, esz, addr16)


def _layout(c: int, esz: int, addr: int) -> SegmentSumPlan:
    vw = math.gcd(c * esz, 16)
    while vw > esz and addr % vw:
        vw //= 2
    need = c // (vw // esz)
    lanes = 1 << max(0, need - 1).bit_length()
    pieces = 1
    if lanes > 32:
        pieces, lanes = lanes // 32, 32
    return SegmentSumPlan(vw=vw, lanes=lanes, pieces=pieces, unit=min(8 * lanes, K6_MAX_UNIT))


def segment_sum_cols(c: int, esz: int, addr: int = 0) -> int:
    """The width K6 runs rows of `c` channels of `esz` bytes at: c, or c
    rounded up to whole 16-byte pieces (a zero-padded copy of the source)
    where c's own pieces would need more than K6_MAX_PIECES a lane.  On
    the H100 at SPVCNN cr 1.6's 409 channels, 16 pieces of 4 bytes a lane
    (f32) beat the copy to 412 columns, while 16 pieces of 2 bytes (bf16)
    took twice the copy to 416 and K6 there (PERF.md §6)."""
    own = _layout(c, esz, addr)
    if own.pieces <= K6_MAX_PIECES[own.vw]:
        return c
    q = 16 // esz
    return -(-c // q) * q


def segment_sum_plan(c: int, esz: int, addr: int = 0) -> SegmentSumPlan:
    """K6's layout for rows of `c` channels of `esz` bytes at address
    `addr`, run at `segment_sum_cols` (a padded copy is aligned): the
    widest piece (16, 8, 4 or 2 bytes) that divides a row and the
    address, the lanes that cover a row in such pieces (rounded up to a
    power of two, at most 32, with 2, 4 or 8 pieces a lane above that, or
    16 of 4 bytes), and the items per group: 8 a lane, at most
    K6_MAX_UNIT (a group walks its unit in sequence, so wide rows take
    short units)."""
    cols = segment_sum_cols(c, esz, addr)
    plan = _layout(cols, esz, addr if cols == c else 0)
    if plan.pieces > K6_MAX_PIECES[plan.vw]:
        raise ValueError(f"segment_sum: {c} channels of {esz} bytes is wider than K6 takes")
    return plan


def segment_sum(
    src: torch.Tensor, tables: SegmentTables, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K6: per segment u of `tables` (V segments over N = R + V sorted
    rows, the last V the sentinels, each last in its segment), out[u] =
    sum of weights[r] * src[r mod P] over its real member rows r < R.
    src (P, C) f32 or bf16 with R a multiple of P; weights (R,) f32 or
    None (weight 1).  (V, C) f32, each segment's members added in a fixed
    order, in one launch (by rows on sparse tables: `segment_sum_by_rows`)."""
    dev = src.device
    _build.check("src", src, (torch.float32, torch.bfloat16), 2, dev)
    _build.check("perm", tables.perm, (torch.int64,), 1, dev)
    _build.check("starts", tables.starts, (torch.int32,), 1, dev)
    v = tables.starts.shape[0] - 1
    r_real = tables.perm.shape[0] - v
    p, c = src.shape
    if r_real < 0 or (r_real and (not p or r_real % p)):
        raise ValueError(f"{r_real} table rows do not tile {p} source rows")
    if weights is not None:
        weights = weights.reshape(-1)
        _build.check("weights", weights, (torch.float32,), 1, dev)
        if weights.shape[0] != r_real:
            raise ValueError(f"weights: {weights.shape[0]} rows, tables have {r_real}")
    if r_real + v >= 2**31:
        raise ValueError("segment tables of 2^31 rows or more")
    if not _build.dispatch(src):
        return segment_sum_plain(src, tables, weights)
    if v == 0 or c == 0 or r_real == 0:
        return torch.zeros((v, c), dtype=torch.float32, device=dev)
    n = tables.perm.shape[0]
    cols, plan = _plan(c, src.element_size(), src.data_ptr() % 16)
    src = pad_cols(src, cols)
    out = torch.empty((v, cols), dtype=torch.float32, device=dev)
    units = -(-n // plan.unit)
    part = torch.empty((units, 2, cols), dtype=torch.float32, device=dev)
    _build.launch(
        "taseg_segment_sum", ("segment_sum",),
        src.data_ptr(), None if weights is None else weights.data_ptr(),
        tables.perm.data_ptr(), tables.starts.data_ptr(), out.data_ptr(),
        part.data_ptr(), _build.zeroed_counters(dev, units).data_ptr(),
        v, cols, r_real, p, n, DTYPE_CODES[src.dtype], plan.vw, plan.lanes, plan.pieces, plan.unit,
        int(segment_sum_by_rows(r_real, v)),
    )
    return unpad(out, c)


def _voxelize_avg(point_feats, tables):
    sums = segment_sum(point_feats, tables)
    mean = sums / tables.counts.clamp(min=1)[:, None].float()
    return mean.to(point_feats.dtype)


def _voxelize_bwd_plain(g, inverse, counts):
    # K8's plain version, as JAX `_voxelize_bwd`: the count is cast to
    # g's dtype before the division (in bf16 that rounds counts above 256)
    scaled = g / counts.clamp(min=1).to(g.dtype)[:, None]
    return torch.where((inverse >= 0)[:, None], scaled[inverse.clamp(min=0).long()], 0)


# K8's layouts (csrc/devoxelize.cu): the C entry's `layout` codes
K8_LAYOUTS = {"rows": 1, "flat": 2, "old": 3}


def voxelize_bwd_plan(c: int, esz: int, base: int, values: int = 0) -> tuple:
    """(layout, piece bytes) of K8 for rows of `c` values of `esz` bytes
    whose g starts `base` bytes past a 16-byte boundary (its output, a
    new tensor, starts on one), `values` = P * C in all: "rows" (one
    thread a (point, piece), the piece the widest of 16, 8, 4 or 2 bytes
    that the row's bytes and g's base allow) where that is 16 bytes or the
    row is narrower than 16 bytes; else "flat" (one thread 16 bytes of the
    flat output, its values gathered from the rows they fall in: 51 bf16,
    409 f32).  Calls of 2^31 values or more take the first K8 kernel
    ("old"), which counts in 64 bits."""
    piece = 16
    for x in (c * esz, base):
        while piece > esz and x % piece:
            piece //= 2
    if values >= 2**31:
        return "old", 16
    if piece == 16 or c * esz < 16:
        return "rows", piece
    return "flat", 16


def voxelize_bwd(g: torch.Tensor, inverse: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """K8, the gradient of `voxelize_avg`: out[p] = g[inverse[p]] /
    max(counts[inverse[p]], 1), the count rounded to g's dtype first, and
    +0 where inverse[p] < 0; (V, C) f32 or bf16, (P,) and (V,) int32 ->
    (P, C) in g's dtype.  One launch in the layout `voxelize_bwd_plan`
    picks from the row's alignment."""
    dev = g.device
    _build.check("g", g, tuple(DTYPE_CODES), 2, dev)
    _build.check("inverse", inverse, (torch.int32,), 1, dev)
    _build.check("counts", counts, (torch.int32,), 1, dev)
    if counts.shape[0] != g.shape[0]:
        raise ValueError(f"counts: {counts.shape[0]} rows, g has {g.shape[0]}")
    if not _build.dispatch(g):
        return _voxelize_bwd_plain(g, inverse, counts)
    p, c = inverse.shape[0], g.shape[1]
    out = torch.empty((p, c), dtype=g.dtype, device=dev)
    if p == 0 or c == 0:
        return out
    layout, _ = voxelize_bwd_plan(c, g.element_size(), g.data_ptr() % 16, p * c)
    _build.launch(
        "taseg_voxelize_bwd", ("voxelize_bwd",), g.data_ptr(), inverse.data_ptr(),
        counts.data_ptr(), out.data_ptr(), p, c, DTYPE_CODES[g.dtype], K8_LAYOUTS[layout],
    )
    return out


class VoxelizeAvg(torch.autograd.Function):
    """Segment mean (K6, then the division) with the JAX `_voxelize_bwd`
    gradient: each point gets its voxel's gradient / count (K8)."""

    @staticmethod
    def forward(ctx, point_feats, inverse, tables):
        ctx.inverse, ctx.counts = inverse, tables.counts
        return _voxelize_avg(point_feats, tables)

    @staticmethod
    def backward(ctx, g):
        return voxelize_bwd(g.contiguous(), ctx.inverse, ctx.counts), None, None


def voxelize_avg(
    point_feats: torch.Tensor,
    inverse: torch.Tensor,
    tables: SegmentTables,
) -> torch.Tensor:
    """Average point features per voxel (reference `spvoxelize`); tables
    from `build_segment_tables(inverse, V)`."""
    if wants_grad(point_feats):
        return VoxelizeAvg.apply(point_feats, inverse, tables)
    return _voxelize_avg(point_feats, tables)


class DevoxTable(NamedTuple):
    """Interpolation table + its transpose structure: 8 corners
    (trilinear, voxels) or 4 (bilinear, pixels).

    idx:     (8, P) or (4, P) int32 row index per corner, -1 missing.
    weights: (8, P) or (4, P) float32 interpolation weights.
    pairs:   SegmentTables over the flattened corner -> row ids,
             for the backward (None: forward only).
    """

    idx: torch.Tensor
    weights: torch.Tensor
    pairs: Optional[SegmentTables] = None


def trilinear_table(
    point_coords: torch.Tensor,
    point_valid: torch.Tensor,
    voxel_coords: torch.Tensor,
    num_voxels: torch.Tensor,
    stride: int,
    bounds: GridBounds,
    with_pairs: bool = True,
    corner_idx: Optional[torch.Tensor] = None,
) -> DevoxTable:
    """8-corner indices + weights (reference `voxel_to_point` /
    `calc_ti_weights`, minkunet/utils.py:69-105), plus the transposed
    pair layout for the backward unless `with_pairs` is False (its
    (8P + V)-row sort serves training only).  `corner_idx` (8, P) skips
    the corner joins when the caller already derived the corner rows
    (`backbone_context.build_unet_topology`)."""
    p = point_coords[:, :3].float()
    s = float(stride)
    pf = torch.floor(p / s) * s

    if corner_idx is not None:
        idx = corner_idx.contiguous()  # K7 reads (8, P) rows
    else:
        offs = torch.as_tensor(
            kernel_offsets(2, stride=stride), device=p.device
        )  # (8, 3); k = 4dx+2dy+dz
        corner = pf[None, :, :].to(torch.int32) + offs[:, None, :]
        b = point_coords[None, :, 3:4].to(torch.int32).expand(8, -1, 1)
        q = torch.cat([corner, b], dim=-1)
        q_valid = point_valid[None, :].expand(8, -1)
        idx = query_coords(q, q_valid, voxel_coords, num_voxels, bounds)

    frac = (p - pf) / s
    one = 1.0 - frac
    # corner bit pattern (k = 4*jx + 2*jy + jz)
    d = torch.tensor(
        [[(k >> 2) & 1, (k >> 1) & 1, k & 1] for k in range(8)],
        dtype=torch.bool, device=p.device,
    )
    w = torch.where(d[:, None, :], frac[None, :, :], one[None, :, :]).prod(-1)
    w = torch.where(idx >= 0, w, 0.0)
    w = w / (w.sum(0, keepdim=True) + 1e-8)
    pairs = (
        build_segment_tables(idx.reshape(-1), voxel_coords.shape[0])
        if with_pairs else None
    )
    return DevoxTable(idx=idx, weights=w, pairs=pairs)


class IdentityDevoxTable(NamedTuple):
    """Degenerate trilinear table for integer points at stride 1: the
    weights collapse to 1 on the containing voxel, so devoxelization is
    a gather by the point->voxel inverse map, and its gradient a segment
    sum over the point tables that the topology builds anyway."""

    inverse: torch.Tensor  # (P,) point -> voxel id (-1 invalid)
    tables: Optional[SegmentTables] = None  # segment tables over `inverse`


def _devox_identity(voxel_feats, inv):
    # K7's plain version
    g = voxel_feats[inv.clamp(min=0).long()]
    return torch.where((inv >= 0)[:, None], g, 0)


def _devox_trilinear(voxel_feats, table):
    # K7's plain version: per-corner multiply-accumulate in the feature
    # dtype, as the JAX package does
    out = None
    for k in range(table.idx.shape[0]):
        idx = table.idx[k]
        g = voxel_feats[idx.clamp(min=0).long()]
        g = torch.where((idx >= 0)[:, None], g, 0)
        c = g * table.weights[k][:, None].to(voxel_feats.dtype)
        out = c if out is None else out + c
    return out


def _launch_devox(name: str, voxel_feats, idx, weights, counters=("devoxelize",)) -> torch.Tensor:
    p = idx.shape[-1]
    c = voxel_feats.shape[1]
    out = torch.empty((p, c), dtype=voxel_feats.dtype, device=voxel_feats.device)
    if p == 0 or c == 0:
        return out
    ptrs = (voxel_feats.data_ptr(), idx.data_ptr())
    if weights is not None:
        ptrs += (weights.data_ptr(),)
    _build.launch(
        name, counters, *ptrs, out.data_ptr(), p, c,
        DTYPE_CODES[voxel_feats.dtype],
    )
    return out


def devoxelize_identity(voxel_feats: torch.Tensor, inverse: torch.Tensor) -> torch.Tensor:
    """K7 identity: out[p] = voxel_feats[inverse[p]], 0 where inverse[p]
    < 0; (V, C) f32 or bf16 and (P,) int32 -> (P, C)."""
    dev = voxel_feats.device
    _build.check("voxel_feats", voxel_feats, tuple(DTYPE_CODES), 2, dev)
    _build.check("inverse", inverse, (torch.int32,), 1, dev)
    if not _build.dispatch(voxel_feats):
        return _devox_identity(voxel_feats, inverse)
    return _launch_devox("taseg_devox_identity", voxel_feats, inverse, None)


# K7's corner entries: 8 corners (trilinear, voxels) and 4 (bilinear,
# the pixels of RPVNet's range_to_point), and their launch counters
_DEVOX_CORNERS = {
    8: ("taseg_devox_trilinear", ("devoxelize",)),
    4: ("taseg_devox_bilinear", ("devoxelize", "devoxelize_bilinear")),
}


def devoxelize_trilinear(voxel_feats: torch.Tensor, table: DevoxTable) -> torch.Tensor:
    """K7 trilinear (8 corners) or bilinear (4): out[p] = sum over
    corners k of weights[k, p] * voxel_feats[idx[k, p]] (absent corners
    idx = -1 add 0), multiplied and added in the feature dtype in corner
    order, as the JAX package does; (V, C) f32 or bf16 -> (P, C)."""
    dev = voxel_feats.device
    _build.check("voxel_feats", voxel_feats, tuple(DTYPE_CODES), 2, dev)
    _build.check("idx", table.idx, (torch.int32,), 2, dev)
    _build.check("weights", table.weights, (torch.float32,), 2, dev)
    corners = table.idx.shape[0]
    if corners not in _DEVOX_CORNERS or table.weights.shape != table.idx.shape:
        raise ValueError(
            f"idx {tuple(table.idx.shape)} / weights {tuple(table.weights.shape)}: "
            "expected (8, P) or (4, P) each"
        )
    if not _build.dispatch(voxel_feats):
        return _devox_trilinear(voxel_feats, table)
    entry, counters = _DEVOX_CORNERS[corners]
    return _launch_devox(entry, voxel_feats, table.idx, table.weights, counters)


class DevoxIdentity(torch.autograd.Function):
    """Identity devoxelize (K7); backward (JAX `_devox_id_bwd`): the
    segment sum of the point gradients per voxel, K6 over the point
    tables."""

    @staticmethod
    def forward(ctx, voxel_feats, table):
        if table.tables is None:
            raise ValueError("the identity devox table has no segment tables")
        ctx.table = table
        return devoxelize_identity(voxel_feats, table.inverse)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return segment_sum(g, ctx.table.tables).to(g.dtype), None


class DevoxTrilinear(torch.autograd.Function):
    """Trilinear devoxelize (K7); backward (JAX `_devox_bwd`): per voxel
    the weighted sum of the point gradients over its (corner, point)
    pairs, K6 over `pairs` with the corner weights."""

    @staticmethod
    def forward(ctx, voxel_feats, table):
        if table.pairs is None:
            raise ValueError(
                "the trilinear table has no pairs: build it with with_pairs=True"
            )
        ctx.table = table
        return devoxelize_trilinear(voxel_feats, table)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        t = ctx.table
        return segment_sum(g, t.pairs, t.weights.reshape(-1)).to(g.dtype), None


def _devox_plain(voxel_feats, table):
    if isinstance(table, IdentityDevoxTable):
        return _devox_identity(voxel_feats, table.inverse)
    return _devox_trilinear(voxel_feats, table)


def devox_multi_plain(feats, tables, bias=None) -> torch.Tensor:
    """The multi-scale entry's plain version: each scale's plain gather,
    then with `bias` their f32 casts summed in order plus the bias (the
    head's sequence, JAX minkunet.py:57-66), else their concatenation
    in the feature dtype."""
    outs = [_devox_plain(x, t) for x, t in zip(feats, tables)]
    if bias is None:
        return torch.cat(outs, dim=-1)
    out = None
    for o in outs:
        o = o.float()
        out = o if out is None else out + o
    return out + bias


def _scale_args(x: torch.Tensor, table, dev) -> tuple:
    """(feats, idx, w, corners, C) of one scale for `taseg_devox_multi`,
    checked."""
    _build.check("voxel_feats", x, tuple(DTYPE_CODES), 2, dev)
    if isinstance(table, IdentityDevoxTable):
        _build.check("inverse", table.inverse, (torch.int32,), 1, dev)
        return (x.data_ptr(), table.inverse.data_ptr(), None, 1, x.shape[1])
    _build.check("idx", table.idx, (torch.int32,), 2, dev)
    _build.check("weights", table.weights, (torch.float32,), 2, dev)
    corners = table.idx.shape[0]
    if corners not in _DEVOX_CORNERS or table.weights.shape != table.idx.shape:
        raise ValueError(f"idx {tuple(table.idx.shape)}: expected (8, P) or (4, P)")
    return (x.data_ptr(), table.idx.data_ptr(), table.weights.data_ptr(), corners, x.shape[1])


def _table_points(table) -> int:
    return table.inverse.shape[0] if isinstance(table, IdentityDevoxTable) else table.idx.shape[1]


MAX_SCALES = 3


def devoxelize_multi_kernel(feats, tables, bias=None) -> torch.Tensor:
    """K7's multi-scale entry: up to MAX_SCALES gathers (identity, 4 or 8
    corners, all of one feature dtype and one point count) in one
    launch.  With `bias` ((C,) f32, every C_s = C): the (P, C) f32 sum of
    their f32 casts in order plus the bias; else their (P, sum C_s)
    concatenation in the feature dtype.  Bit-identical to
    `devox_multi_plain` (CPU tensors take it)."""
    if not 1 <= len(feats) == len(tables) <= MAX_SCALES:
        raise ValueError(f"{len(feats)} feature maps, {len(tables)} tables: 1 to {MAX_SCALES} pairs")
    dev = feats[0].device
    dtype = feats[0].dtype
    p = _table_points(tables[0])
    if any(x.dtype != dtype for x in feats) or any(_table_points(t) != p for t in tables):
        raise ValueError("devoxelize_multi: the scales differ in dtype or point count")
    widths = [x.shape[1] for x in feats]
    if bias is not None:
        _build.check("bias", bias, (torch.float32,), 1, dev)
        if len(set(widths)) != 1 or bias.shape[0] != widths[0]:
            raise ValueError(f"sum of widths {widths} with a bias of {tuple(bias.shape)}")
    args = [_scale_args(x, t, dev) for x, t in zip(feats, tables)]
    if not _build.dispatch(feats[0]):
        return devox_multi_plain(feats, tables, bias)
    if min(widths) == 0:
        raise ValueError(f"devoxelize_multi: a scale of width 0 in {widths}")
    c_out = widths[0] if bias is not None else sum(widths)
    out = torch.empty((p, c_out), dtype=torch.float32 if bias is not None else dtype, device=dev)
    if p == 0:
        return out
    args += [(None, None, None, 1, 0)] * (MAX_SCALES - len(args))
    _build.launch(
        "taseg_devox_multi", ("devoxelize", "devoxelize_multi"),
        *[v for a in args for v in a], len(feats), out.data_ptr(),
        None if bias is None else bias.data_ptr(), p, DTYPE_CODES[dtype], int(bias is not None),
    )
    return out


class StackedDevox(NamedTuple):
    """The pair tables of several devoxelizations of one gradient stacked
    with row offsets, so their backward is one K6 call: `tables` over the
    concatenated real rows of each scale (R = sum R_s, each a multiple of
    P) and sum V_s segments, `weights` (R,) f32 (1 for an identity
    scale's rows), `rows` the V_s of each scale, in order."""

    tables: SegmentTables
    weights: torch.Tensor
    rows: tuple


def _pair_tables(table):
    if isinstance(table, IdentityDevoxTable):
        if table.tables is None:
            raise ValueError("the identity devox table has no segment tables")
        return table.tables, torch.ones(
            table.inverse.shape[0], dtype=torch.float32, device=table.inverse.device
        )
    if table.pairs is None:
        raise ValueError("the trilinear table has no pairs: build it with with_pairs=True")
    return table.pairs, table.weights.reshape(-1)


def stack_devox_tables(tables) -> StackedDevox:
    """One `StackedDevox` over the pair tables of `tables` (identity or
    trilinear, each with its backward tables), without a sort and
    without a host read: each scale's sorted positions keep their order,
    its member rows move by the real rows before it and its sentinel rows
    to the end, its used positions (those below its last start) follow
    the earlier scales' used positions and its dropped ones (ids out of
    range) go after every used position, by one scatter."""
    seg = [_pair_tables(t) for t in tables]
    dev = seg[0][0].perm.device
    v = [st.starts.shape[0] - 1 for st, _ in seg]
    r = [st.perm.shape[0] - vs for (st, _), vs in zip(seg, v)]
    r_tot, v_tot = sum(r), sum(v)
    used = torch.stack([st.starts[-1].long() for st, _ in seg])  # device scalars
    dropped = torch.tensor([st.perm.shape[0] for st, _ in seg], device=dev) - used
    used_before = torch.cumsum(used, 0) - used
    drop_at = used.sum() + torch.cumsum(dropped, 0) - dropped  # first dropped slot
    perm = torch.empty(r_tot + v_tot, dtype=torch.int64, device=dev)
    starts, counts = [], []
    r_off = v_off = 0
    for s, ((st, _), vs, rs) in enumerate(zip(seg, v, r)):
        n = st.perm.shape[0]
        mapped = torch.where(st.perm < rs, st.perm + r_off, st.perm - rs + r_tot + v_off)
        i = torch.arange(n, device=dev)
        dst = torch.where(i < used[s], used_before[s] + i, drop_at[s] + i - used[s])
        perm.scatter_(0, dst, mapped)
        starts.append(st.starts[:-1] + used_before[s].int())
        counts.append(st.counts)
        r_off += rs
        v_off += vs
    starts.append(used.sum().int().reshape(1))
    return StackedDevox(
        tables=SegmentTables(perm=perm, starts=torch.cat(starts), counts=torch.cat(counts)),
        weights=torch.cat([w for _, w in seg]),
        rows=tuple(v),
    )


def _scale_grads(gs, tables, dtypes, stacked: Optional[StackedDevox]):
    """Each scale's voxel gradient (its dtype) from its point gradient:
    on the card one K6 over `stacked` where given (every g_s the same
    tensor), else one K6 per scale over its own pair table.  CPU tensors
    take the per-scale plain calls either way: the plain K6's mean-centred
    cumsum rounds far coarser over the stacked rows (17 P of three scales,
    one centre) than over each scale's, enough to move the ill-conditioned
    third step of `test_torch_train.py` by 2.4% in grad norm."""
    if stacked is not None and _build.dispatch(gs[0]):
        out = segment_sum(gs[0], stacked.tables, stacked.weights)
        return [o.to(dt) for o, dt in zip(out.split(list(stacked.rows)), dtypes)]
    grads = []
    for g, t, dt in zip(gs, tables, dtypes):
        st, w = _pair_tables(t)
        grads.append(segment_sum(g, st, None if isinstance(t, IdentityDevoxTable) else w).to(dt))
    return grads


class DevoxMulti(torch.autograd.Function):
    """K7's multi-scale entry; backward: with a bias (the sum) every scale
    takes the output gradient cast to its dtype, and the bias its column
    sums; without (the cat) each scale its column slice.  The voxel
    gradients are K6 over the stacked pair table in one call where one
    is given (the sum: one gradient), else K6 per scale."""

    @staticmethod
    def forward(ctx, bias, stacked, tables, *feats):
        ctx.tables, ctx.stacked, ctx.has_bias = tables, stacked, bias is not None
        ctx.widths = [x.shape[1] for x in feats]
        ctx.dtypes = [x.dtype for x in feats]
        return devoxelize_multi_kernel(feats, tables, bias)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.has_bias:
            gb = g.to(ctx.dtypes[0])
            gs = [gb] * len(ctx.widths)
            g_bias = g.sum(0)
        else:
            gs = [c.contiguous() for c in g.split(ctx.widths, dim=1)]
            g_bias = None
        stacked = ctx.stacked if ctx.has_bias else None
        return (g_bias, None, None, *_scale_grads(gs, ctx.tables, ctx.dtypes, stacked))


def devoxelize_multi(feats, tables, bias=None, stacked: Optional[StackedDevox] = None) -> torch.Tensor:
    """Several devoxelizations of one point set in one K7 launch: with
    `bias`, the (P, C) f32 sum of their f32 casts plus the bias (the
    MinkUNet head); else their concatenation (P, sum C_s) in the feature
    dtype.  Differentiable in the features and the bias where autograd
    asks; the sum's backward is one K6 call over `stacked`
    (`stack_devox_tables` of the same tables) where given."""
    feats = tuple(feats)
    tables = tuple(tables)
    grad = wants_grad(*feats, *(() if bias is None else (bias,)))
    if not grad:
        return devoxelize_multi_kernel(feats, tables, bias)
    if stacked is not None and tuple(stacked.rows) != tuple(x.shape[0] for x in feats):
        raise ValueError(f"stacked rows {stacked.rows} do not match the feature rows")
    return DevoxMulti.apply(bias, stacked, tables, *feats)


def devoxelize(voxel_feats: torch.Tensor, table) -> torch.Tensor:
    """Interpolate (V, C) voxel feats to (P, C) points (reference
    `spdevoxelize`); dispatches on the table type, and is differentiable
    in the voxel features where autograd asks."""
    identity = isinstance(table, IdentityDevoxTable)
    if wants_grad(voxel_feats):
        return (DevoxIdentity if identity else DevoxTrilinear).apply(voxel_feats, table)
    if identity:
        return devoxelize_identity(voxel_feats, table.inverse)
    return devoxelize_trilinear(voxel_feats, table)


# K10's runs kernel (`csrc/segment_max.cu`): warps a block, and the warps
# of one wave of the card (132 SMs x 64 resident warps)
K10_WARPS = 8
K10_WAVE_WARPS = 132 * 64
# where a forward's segments hold K10_LONG rows or more on average (the
# global pool's few segments), its warps take K10_LONG_CHUNKS times longer
# chunks: a segment spanning many blocks takes an atomic a column from
# each, and atomics on one address serialize
K10_LONG = 64
K10_LONG_CHUNKS = 4
# the first design's threads: about one wave of the card (132 SMs x 2048)
K10_WAVE = 132 * 2048


class SegmentMaxPlan(NamedTuple):
    """The shape of K10's runs kernel: `vec` columns a thread (16 bytes of
    a row, else 1), `tpr` threads a row (a power of two, at most a warp),
    `col_blocks` blocks along the row where it is wider than a warp's
    pieces, `chunk` consecutive rows a warp (whole passes of 32 / tpr
    rows), `blocks` blocks of K10_WARPS warps over the rows."""

    vec: int
    tpr: int
    col_blocks: int
    chunk: int
    blocks: int


def segment_max_plan(p: int, c: int, esz: int, aligned: bool = True, segments: int = 0) -> SegmentMaxPlan:
    """K10's plan at p rows of c columns of `esz` bytes: 16-byte pieces
    where the rows are 16-byte aligned (`aligned`) and hold whole pieces,
    the warps' chunks as short as fill one wave of the card, K10_LONG_CHUNKS
    times longer where a forward's `segments` hold K10_LONG rows or more
    on average (0: the backward, whose tie counts rarely flush)."""
    step = 16 // esz
    vec = step if aligned and c % step == 0 else 1
    groups = c // vec
    tpr = min(32, 1 << (groups - 1).bit_length()) if groups > 1 else 1
    col_blocks = -(-groups // tpr)
    rpw = 32 // tpr
    per_warp = -(-p * col_blocks // K10_WAVE_WARPS)
    chunk = rpw * max(1, -(-per_warp // rpw))
    if segments and p >= K10_LONG * segments:
        chunk *= K10_LONG_CHUNKS
    return SegmentMaxPlan(vec, tpr, col_blocks, chunk, max(1, -(-p // (K10_WARPS * chunk))))


def segment_max_rows(p: int, c: int) -> int:
    """Rows a thread of K10's first design takes (its run): the p x c
    items spread over about one wave of the card, at least one row each."""
    return max(1, -(-p * c // K10_WAVE))


def _seg32(seg: torch.Tensor) -> torch.Tensor:
    return seg.to(torch.int32).contiguous()


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def segment_max_plain(x: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The forward of `segment_max` in plain torch: `scatter_reduce`
    amax over a -inf fill, then + 0.0, which makes a -0.0 max +0.0 (the
    order of the members decides which zero amax keeps; K10 makes every
    zero +0.0 first, so the two agree to the bit)."""
    idx = seg.long()[:, None].expand_as(x)
    out = torch.full(
        (num_segments, x.shape[1]), float("-inf"), dtype=x.dtype, device=x.device
    ).scatter_reduce(0, idx, x, "amax", include_self=True)
    return out + 0.0


def segment_max_bwd_plain(x, seg, out, g) -> torch.Tensor:
    """The backward of `segment_max` in plain torch: g / n to every
    member equal to its segment's max (n the number of such members,
    counted in f32; the share g * (1 / n) taken in f32 and rounded once
    to x's dtype), 0 elsewhere."""
    idx = seg.long()[:, None].expand_as(x)
    top = out.gather(0, idx)
    hit = x == top
    n = torch.zeros(out.shape, dtype=torch.float32, device=x.device).scatter_add_(0, idx, hit.float())
    share = (g.float() * (1.0 / n.clamp(min=1.0))).to(x.dtype)  # JAX multiplies by 1 / count
    return torch.where(hit, share.gather(0, idx), 0.0)


def _check_fwd(x, seg):
    dev = x.device
    _build.check("x", x, tuple(DTYPE_CODES), 2, dev)
    seg = _seg32(seg)
    _build.check("seg", seg, (torch.int32,), 1, dev)
    if seg.shape[0] != x.shape[0]:
        raise ValueError(f"seg has {seg.shape[0]} rows, x {x.shape[0]}")
    return seg


def segment_max_kernel(x: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """K10's forward (`csrc/segment_max.cu`: the -inf fill and the runs
    kernel, two launches): x (P, C) f32 or bf16, seg (P,) ids in [0,
    num_segments) -> (num_segments, C) in x's dtype; -inf for a segment
    without rows."""
    seg = _check_fwd(x, seg)
    p, c = x.shape
    out = torch.empty((num_segments, c), dtype=x.dtype, device=x.device)
    if c and num_segments:
        plan = segment_max_plan(p, c, x.element_size(), _aligned(x), num_segments)
        _build.launch(
            "taseg_segment_max", ("segment_max",), x.data_ptr(), seg.data_ptr(), out.data_ptr(), p, c,
            num_segments, *plan, DTYPE_CODES[x.dtype],
        )
    return out


def _check_bwd(x, seg, out, g):
    dev = x.device
    for name, t in (("x", x), ("out", out), ("g", g)):
        _build.check(name, t, (x.dtype,), 2, dev)
    seg = _seg32(seg)
    _build.check("seg", seg, (torch.int32,), 1, dev)
    if x.dtype not in DTYPE_CODES or out.shape != g.shape or out.shape[1] != x.shape[1] or seg.shape[0] != x.shape[0]:
        raise ValueError(f"shapes do not fit: x {tuple(x.shape)}, out {tuple(out.shape)}, g {tuple(g.shape)}")
    return seg


def segment_max_bwd_kernel(x, seg, out, g) -> torch.Tensor:
    """K10's backward (the tie counts zeroed, the ties counted, then the
    shares: three launches, no barrier): x (P, C), out and g (S, C) of
    x's dtype -> dx (P, C)."""
    seg = _check_bwd(x, seg, out, g)
    p, c = x.shape
    s = out.shape[0]
    dx = torch.empty_like(x)
    if p and c:
        plan = segment_max_plan(p, c, x.element_size(), _aligned(x, out, g))
        n = torch.empty((s, c), dtype=torch.float32, device=x.device)
        mask = torch.empty(p * (c // plan.vec), dtype=torch.uint8, device=x.device)
        _build.launch(
            "taseg_segment_max_bwd", ("segment_max", "segment_max_bwd"), x.data_ptr(), seg.data_ptr(),
            out.data_ptr(), g.data_ptr(), n.data_ptr(), mask.data_ptr(), dx.data_ptr(), p, c, s, *plan,
            DTYPE_CODES[x.dtype],
        )
    return dx


def segment_max_v1(x: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """K10's first design (C entry `taseg_segment_max_v1`: the -inf
    fill and the cast in torch around one launch), counted nowhere: the
    yardstick `old_ms` of chip_smoke.py and the card tests, on no path."""
    seg = _check_fwd(x, seg)
    p, c = x.shape
    out = torch.full((num_segments, c), float("-inf"), dtype=torch.float32, device=x.device)
    if p and c and num_segments:
        _build.launch(
            "taseg_segment_max_v1", (), x.data_ptr(), seg.data_ptr(), out.data_ptr(),
            p, c, num_segments, segment_max_rows(p, c), DTYPE_CODES[x.dtype],
        )
    return out.to(x.dtype)


def segment_max_bwd_v1(x, seg, out, g) -> torch.Tensor:
    """K10's first backward (one cooperative launch: the ties counted
    into zeroed int32 counts, a grid-wide barrier, the shares), behind
    K10's own argument checks, counted nowhere: the yardstick `old_ms`,
    on no path."""
    seg = _check_bwd(x, seg, out, g)
    p, c = x.shape
    s = out.shape[0]
    dx = torch.empty_like(x)
    if p and c:
        n = torch.zeros((s, c), dtype=torch.int32, device=x.device)
        _build.launch(
            "taseg_segment_max_bwd_v1", (), x.data_ptr(), seg.data_ptr(), out.data_ptr(), g.data_ptr(),
            n.data_ptr(), dx.data_ptr(), _build.zeroed_counters(x.device, 2).data_ptr(), p, c, s,
            segment_max_rows(p, c), DTYPE_CODES[x.dtype],
        )
    return dx


class SegmentMax(torch.autograd.Function):
    """`jax.ops.segment_max` with JAX's gradient.  Forward: per segment
    the max over its member rows, -inf for a segment with no member.
    Backward: the segment's cotangent goes to every member equal to the
    segment's max, divided by the number of such members, as JAX's
    scatter-max gradient splits ties (torch's own `amax` backward counts
    the fill value as a tie).  K10 on CUDA tensors, the plain versions on
    CPU tensors."""

    @staticmethod
    def forward(ctx, x, seg, num_segments):
        if _build.dispatch(x):
            out = segment_max_kernel(x, seg, num_segments)
        else:
            out = segment_max_plain(x, seg, num_segments)
        ctx.save_for_backward(x, seg, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, seg, out = ctx.saved_tensors
        g = g.contiguous()
        if _build.dispatch(x):
            return segment_max_bwd_kernel(x, seg, out, g), None, None
        return segment_max_bwd_plain(x, seg, out, g), None, None


def segment_max(x: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(num_segments, C): per segment id in `seg` (P,), in [0,
    num_segments), the max of its rows of x (P, C); -inf where a segment
    has no row (JAX `jax.ops.segment_max`); a max of zeros is +0.0.
    Differentiable in x (`SegmentMax`); K10 on CUDA tensors."""
    return SegmentMax.apply(x, seg, num_segments)
