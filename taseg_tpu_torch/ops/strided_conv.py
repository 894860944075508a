"""Strided (ks=2, stride=2) sparse conv pair via the parent relation —
port of `taseg_tpu/ops/strided_conv.py` (forward only).

Every fine voxel f belongs to exactly one coarse cell `parent(f)` (the
downsample unique's inverse) at one kernel offset `slot(f)` (its
per-axis parity bits), so:

  down:  out[c] = sum_{f: parent(f)=c} feats[f] @ W[slot(f)]
  up:    out[f] = feats[parent(f)] @ W[slot(f)]

Children of a coarse cell are the contiguous run [starts[c], starts[c+1])
of the downsample unique's sort permutation `perm`.  On CUDA tensors the
wrappers launch the hand-written kernel K3 (`csrc/strided_conv.cu`); on
CPU tensors they run the plain versions, which follow the JAX
`_slot_matmul`, `_segment_sum` (a mean-centred cumsum) and
`_parent_gather` (`voxelize.run_sums` is the segment sum).  The kernel
sums children directly, so in f32 the two differ by the cumsum's
rounding only (about 1e-6 of the output scale).
Weight layout (8, C_in, C_out) with the z-fastest offset enumeration of
`kernel_offsets(2)`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _build
from .sparse_conv import DTYPE_CODES
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
    """

    parent: torch.Tensor
    slot: torch.Tensor
    perm: torch.Tensor
    starts: torch.Tensor


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
    feats: torch.Tensor, weight: torch.Tensor, tables: StridedTables
) -> torch.Tensor:
    """feats (V_fine, Ci), weight (8, Ci, Co) in feats' dtype ->
    (V_coarse, Co)."""
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
    _build.launch(
        "taseg_strided_down", "strided_down",
        feats.data_ptr(), weight.data_ptr(), tables.parent.data_ptr(),
        tables.slot.data_ptr(), tables.perm.data_ptr(),
        tables.starts.data_ptr(), out.data_ptr(),
        v_fine, v_coarse, c_in, c_out, DTYPE_CODES[feats.dtype],
    )
    return out


def upsample_conv_apply(
    feats: torch.Tensor, weight: torch.Tensor, tables: StridedTables
) -> torch.Tensor:
    """Transposed pair: feats (V_coarse, Ci), weight (8, Ci, Co) in feats'
    dtype -> (V_fine, Co); out[f] = feats[parent(f)] @ W[slot(f)]."""
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
    _build.launch(
        "taseg_strided_up", "strided_up",
        feats.data_ptr(), weight.data_ptr(), tables.parent.data_ptr(),
        tables.slot.data_ptr(), out.data_ptr(),
        v_fine, c_in, c_out, DTYPE_CODES[feats.dtype],
    )
    return out
