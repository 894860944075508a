"""Post-sort join scan (K1) — port of `taseg_tpu/ops/join_scan.py`.

After `join_keys` sorts the tagged union of reference and query keys,
each sorted row needs three running maxima (last key-group start, last
reference row, last valid reference id) and a match/select on them.  On
CUDA tensors `join_scan` launches the hand-written kernel
`csrc/join_scan.cu`, a single-pass scan with decoupled look-back (one
launch per call); on CPU tensors it runs `join_scan_plain`, the XLA
cummax formulation of `taseg_tpu/ops/join.py:205-231`.  Both are
bit-identical.

The kernel's tiles publish their maxima in status words tagged with a
per-call epoch.  `LookbackState` keeps those words and the tile counter
across calls, one per device and stream, so a call allocates and clears
nothing.
"""

from __future__ import annotations

import torch

from . import _build

# rows per tile of the CUDA kernel (csrc/join_scan.cu kTile)
TILE = 4096
# status words carry epoch << 2 in 32 bits; 0 marks a word never written
EPOCH_LIMIT = 2**30


class LookbackState:
    """The kernel's state between calls on one device and stream: three
    int64 status words per tile, the int32 tile counter (0 again after
    every call) and the epoch of the last call.  Calls on one stream run
    in order, so one state serves them all."""

    def __init__(self, device):
        self.status = torch.zeros(0, dtype=torch.int64, device=device)
        self.counter = torch.zeros(1, dtype=torch.int32, device=device)
        self.epoch = 0

    def next_call(self, tiles: int) -> int:
        """Make room for `tiles` tiles and return the new call's epoch.
        A grown buffer is zeroed (epoch 0), so no word in it matches; at
        the epoch limit the words are zeroed and the epochs start over."""
        if self.status.shape[0] < 3 * tiles:
            grown = max(tiles, 2 * (self.status.shape[0] // 3))
            self.status = torch.zeros(
                3 * grown, dtype=torch.int64, device=self.status.device
            )
        self.epoch += 1
        if self.epoch >= EPOCH_LIMIT:
            self.status.zero_()
            self.epoch = 1
        return self.epoch


_STATES: dict = {}  # (device, stream) -> LookbackState


def _state(dev: torch.device) -> LookbackState:
    """The state of `dev`'s current stream ("cuda" means the current
    device)."""
    stream = torch.cuda.current_stream(dev)
    key = (stream.device, stream.cuda_stream)
    if key not in _STATES:
        _STATES[key] = LookbackState(stream.device)
    return _STATES[key]


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
    state = _state(dev)
    epoch = state.next_call((n + TILE - 1) // TILE)
    _build.launch(
        "taseg_join_scan", ("join_scan",),
        shi.data_ptr(), slo2.data_ptr(), srow.data_ptr(),
        num_refs.data_ptr(), out.data_ptr(), state.status.data_ptr(),
        state.counter.data_ptr(), n, int(v), int(qsent), int(mode), epoch,
    )
    return out
