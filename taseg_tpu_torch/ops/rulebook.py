"""Sparse-convolution rulebooks as dense static-shape tables (port of
`taseg_tpu/ops/rulebook.py`).

For every kernel offset k and output voxel v the table holds the index of
the contributing input voxel or -1: a dense (K, V_out) int32 table, in
torchsparse's offset order (`nn/utils/kernel.py:11-32`).
"""

from __future__ import annotations

import numpy as np
import torch

from .coords import REF_SENTINEL_HI, GridBounds, pack_keys
from .join import join_keys, query_coords, unique_coords


def make_ntuple(x, ndim: int = 3) -> tuple:
    if isinstance(x, (list, tuple)):
        if len(x) != ndim:
            raise ValueError(f"expected {ndim} values, got {x}")
        return tuple(x)
    return (x,) * ndim


def kernel_offsets(kernel_size, stride=1, dilation=1) -> np.ndarray:
    """(K, 3) int32 offsets; x-fastest for odd kernel volumes, z-fastest
    for even (torchsparse `nn/utils/kernel.py:11-32`)."""
    size = make_ntuple(kernel_size)
    stride = make_ntuple(stride)
    dilation = make_ntuple(dilation)
    per_axis = [
        np.arange(-size[k] // 2 + 1, size[k] // 2 + 1) * stride[k] * dilation[k]
        for k in range(3)
    ]
    if np.prod(size) % 2 == 1:
        offs = [[x, y, z] for z in per_axis[2] for y in per_axis[1] for x in per_axis[0]]
    else:
        offs = [[x, y, z] for x in per_axis[0] for y in per_axis[1] for z in per_axis[2]]
    return np.asarray(offs, dtype=np.int32)


def spdownsample(
    coords: torch.Tensor,
    num: torch.Tensor,
    stride,
    tensor_stride,
    bounds: GridBounds,
    capacity: int,
    *,
    return_inverse: bool = False,
):
    """Downsampled (strided) output coordinates, deduplicated
    (torchsparse `nn/functional/downsample.py:25-28`): truncate-toward-
    zero division of xyz by stride * tensor_stride, then unique.  With
    `return_inverse`, also the fine-row -> coarse-uid map, the per-cell
    children counts and the parent-grouping sort permutation."""
    stride = make_ntuple(stride)
    tensor_stride = make_ntuple(tensor_stride)
    ss = torch.tensor(
        [stride[k] * tensor_stride[k] for k in range(3)],
        dtype=torch.int32, device=coords.device,
    )
    xyz = coords[:, :3]
    down = torch.sign(xyz) * (torch.abs(xyz) // ss) * ss
    new_coords = torch.cat([down, coords[:, 3:4]], dim=1)
    valid = (
        torch.arange(coords.shape[0], dtype=torch.int32, device=coords.device)
        < num
    )
    if return_inverse:
        return unique_coords(
            new_coords, valid, bounds, capacity, return_perm=True
        )
    out_coords, num_out, _, _ = unique_coords(
        new_coords, valid, bounds, capacity
    )
    return out_coords, num_out


def build_rulebook(
    out_coords: torch.Tensor,
    num_out: torch.Tensor,
    in_coords: torch.Tensor,
    num_in: torch.Tensor,
    offsets: np.ndarray,
    bounds: GridBounds,
) -> torch.Tensor:
    """Dense rulebook: idx[k, v] = input voxel index at out_coords[v] +
    offsets[k], or -1 (one join per offset; the test oracle of
    `build_rulebook_k3`)."""
    k = offsets.shape[0]
    vo = out_coords.shape[0]
    dev = out_coords.device
    offs = torch.as_tensor(offsets, dtype=torch.int32, device=dev)
    q_xyz = out_coords[None, :, :3] + offs[:, None, :]
    q = torch.cat(
        [q_xyz, out_coords[None, :, 3:4].expand(k, vo, 1)], dim=-1
    )
    q_valid = (
        torch.arange(vo, dtype=torch.int32, device=dev) < num_out
    )[None, :].expand(k, vo)
    return query_coords(q, q_valid, in_coords, num_in, bounds)


def k3_floor_queries(
    coords: torch.Tensor,
    num: torch.Tensor,
    stride: int,
    bounds: GridBounds,
) -> tuple:
    """Reference keys (hi, lo) of a level and the keys (q_hi, q_lo) of its
    9 (dx, dz) floor queries at dy = 0, group g = (dz+1)*3 + (dx+1), each
    (9 * V,) — the join that `build_rulebook_k3` runs."""
    v = coords.shape[0]
    dev = coords.device
    valid = torch.arange(v, dtype=torch.int32, device=dev) < num
    hi, lo = pack_keys(coords, bounds, valid)
    groups = torch.tensor(
        [[dx, 0, dz] for dz in (-1, 0, 1) for dx in (-1, 0, 1)],
        dtype=torch.int32, device=dev,
    )
    q_xyz = coords[None, :, :3] + (groups * int(stride))[:, None, :]
    q = torch.cat([q_xyz, coords[None, :, 3:4].expand(9, v, 1)], dim=-1)
    q_hi, q_lo = pack_keys(
        q.reshape(-1, 4), bounds, valid[None, :].expand(9, v).reshape(-1),
        is_query=True,
    )
    return hi, lo, q_hi, q_lo


def build_rulebook_k3(
    coords: torch.Tensor,
    num: torch.Tensor,
    stride: int,
    bounds: GridBounds,
) -> torch.Tensor:
    """Same-level 3^3 rulebook from 9 floor queries instead of 27 joins.

    Equal to `build_rulebook(coords, num, coords, num,
    kernel_offsets(3, stride=stride), bounds)`: voxel keys sort by
    (batch, z, x, y), so for each (dx, dz) offset group the three
    dy-column entries follow from ONE floor join plus the keys of the
    floor row and its successor:

      exact (ref[f] == q):   dy=0 -> f; dy=-1 -> f-1 iff ref[f-1]==q-s
      otherwise:             dy=-1 -> f iff ref[f] == q - s
      either way:            dy=+1 -> f+1 iff ref[f+1] == q + s
    """
    v = coords.shape[0]
    dev = coords.device
    s = int(stride)
    hi, lo, q_hi, q_lo = k3_floor_queries(coords, num, stride, bounds)

    # per-reference record: own key, successor key, and the d1 flag
    # (ref[r-1] == ref[r] - s in the same hi group)
    hi_next = torch.cat(
        [hi[1:], torch.full((1,), int(REF_SENTINEL_HI), dtype=torch.int32, device=dev)]
    )
    lo_next = torch.cat([lo[1:], torch.zeros(1, dtype=torch.int32, device=dev)])
    u1 = (hi_next == hi) & (lo_next == lo + s)
    d1 = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), u1[:-1]])
    rec = torch.stack([hi, lo, hi_next, lo_next, d1.to(torch.int32)], 1)

    enc = join_keys(hi, lo, num, q_hi, q_lo, floor=True)
    f = (enc >> 1).reshape(9, v)  # arithmetic shift: -2 -> -1
    exact = (enc & 1).to(torch.bool).reshape(9, v)

    g = rec[f.clamp(min=0).to(torch.int64)]  # (9, V, 5)
    g_hi, g_lo = g[..., 0], g[..., 1]
    g_hi_n, g_lo_n = g[..., 2], g[..., 3]
    g_d1 = g[..., 4].to(torch.bool)
    qh = q_hi.reshape(9, v)
    ql = q_lo.reshape(9, v)

    rc = torch.where(exact, f, -1)
    rm = torch.where(
        exact,
        torch.where(g_d1, f - 1, -1),
        torch.where((g_hi == qh) & (g_lo == ql - s) & (f >= 0), f, -1),
    )
    # ceil = f + 1 when a floor exists, else reference 0
    up_row = torch.where(f >= 0, f + 1, 0)
    up_hi = torch.where(f >= 0, g_hi_n, g_hi)
    up_lo = torch.where(f >= 0, g_lo_n, g_lo)
    rp = torch.where((up_hi == qh) & (up_lo == ql + s), up_row, -1)

    # interleave into torchsparse offset order: k = (dx+1) + 3(dy+1) + 9(dz+1)
    cols = [None] * 27
    for gi in range(9):
        dz1, dx1 = divmod(gi, 3)
        base = dx1 + 9 * dz1
        cols[base] = rm[gi]
        cols[base + 3] = rc[gi]
        cols[base + 6] = rp[gi]
    return torch.stack(cols).to(torch.int32)
