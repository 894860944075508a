"""Post-sort join scan (K1) — port of `taseg_tpu/ops/join_scan.py`.

After `join_keys` sorts the tagged union of reference and query keys,
each sorted row needs three running maxima (last key-group start, last
reference row, last valid reference id) and a match/select on them.  On
CUDA tensors `join_scan` launches the hand-written kernel
`csrc/join_scan.cu`; on CPU tensors it runs `join_scan_plain`, the XLA
cummax formulation of `taseg_tpu/ops/join.py:205-231`.  Both are
bit-identical.
"""

from __future__ import annotations

import torch

from . import _build

# rows per block of the CUDA kernel (csrc/join_scan.cu kTile)
TILE = 2048


def join_scan_plain(
    shi: torch.Tensor,
    slo2: torch.Tensor,
    srow: torch.Tensor,
    num_refs: torch.Tensor,
    v: int,
    qsent: int,
    mode: int,
) -> torch.Tensor:
    """Three int32 cummax passes + match select (join.py:205-231)."""
    n = shi.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=shi.device)
    key_differs = torch.ones(n, dtype=torch.bool, device=shi.device)
    key_differs[1:] = (shi[1:] != shi[:-1]) | (
        (slo2[1:] >> 1) != (slo2[:-1] >> 1)
    )
    is_ref = srow < v
    last_boundary = torch.cummax(torch.where(key_differs, pos, -1), 0).values
    last_ref_pos = torch.cummax(torch.where(is_ref, pos, -1), 0).values
    ref_id = torch.cummax(
        torch.where(is_ref & (srow < num_refs), srow, -1), 0
    ).values
    in_range = shi < qsent
    matched = (last_ref_pos >= last_boundary) & (ref_id >= 0) & in_range
    if mode == 1:
        return torch.where(in_range, ref_id * 2 + matched.to(torch.int32), -2)
    return torch.where(matched, ref_id, -1)


def join_scan(
    shi: torch.Tensor,
    slo2: torch.Tensor,
    srow: torch.Tensor,
    num_refs: torch.Tensor,
    v: int,
    qsent: int,
    mode: int,
) -> torch.Tensor:
    """Fused post-sort join scan.

    shi/slo2/srow: (n,) int32 sorted union (refs tagged via the low bit
    of slo2, rows < v are references).  num_refs: (1,) int32 tensor, the
    count of valid references.  mode 0 -> matched ref id or -1; mode 1 ->
    floor encoding `refid * 2 + exact`, -2 where no reference sorts at or
    before the row.  Returns (n,) int32."""
    if mode not in (0, 1):
        raise ValueError(f"mode must be 0 or 1, got {mode}")
    dev = shi.device
    for name, t in (("shi", shi), ("slo2", slo2), ("srow", srow)):
        _build.check(name, t, (torch.int32,), 1, dev)
        if t.shape[0] != shi.shape[0]:
            raise ValueError(f"{name}: length {t.shape[0]} != {shi.shape[0]}")
    num_refs = num_refs.reshape(1)
    _build.check("num_refs", num_refs, (torch.int32,), 1, dev)
    n = shi.shape[0]
    if not _build.dispatch(shi):
        return join_scan_plain(shi, slo2, srow, num_refs, v, qsent, mode)
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    nb = (n + TILE - 1) // TILE
    scratch = torch.empty(6 * nb, dtype=torch.int32, device=dev)
    _build.launch(
        "taseg_join_scan", ("join_scan",),
        shi.data_ptr(), slo2.data_ptr(), srow.data_ptr(),
        num_refs.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        n, int(v), int(qsent), int(mode),
    )
    return out
