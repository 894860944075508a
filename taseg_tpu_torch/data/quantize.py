"""Host-side (numpy) voxel quantization; copy of `taseg_tpu/ops/quantize.py`.

Functional equivalent of torchsparse `utils/quantize.py:9-46`: unique the
quantized coordinate rows, keep the first occurrence per voxel and map
every input point to its voxel's row.  The unique set comes out in
lexicographic order.
"""

from __future__ import annotations

import numpy as np


def quantize_coords(coords: np.ndarray, voxel_size=1.0) -> np.ndarray:
    """floor(coords / voxel_size) as int32; voxel_size scalar or per-axis."""
    vs = np.asarray(voxel_size, dtype=np.float64)
    return np.floor(coords / vs).astype(np.int32)


def sparse_quantize(
    coords: np.ndarray,
    voxel_size=1,
    *,
    return_index: bool = False,
    return_inverse: bool = False,
):
    """Deduplicate points falling into the same voxel.

    Returns the unique quantized coords, optionally the index of one
    representative input row per voxel and the per-point inverse map.
    """
    pc = quantize_coords(coords, voxel_size)
    unique_pc, index, inverse = np.unique(
        pc, axis=0, return_index=True, return_inverse=True
    )
    inverse = inverse.reshape(-1)
    out = [unique_pc]
    if return_index:
        out.append(index)
    if return_inverse:
        out.append(inverse)
    return out[0] if len(out) == 1 else out
