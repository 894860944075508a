"""taseg_tpu_torch.ops — sparse ops of the port (counterpart of
`taseg_tpu.ops`): coordinate keys, sort-based joins, rulebooks, the
strided conv pair, point<->voxel transforms and the stride-1 sparse conv.

Kernels (built at first use, see `_build`):
  K1 `join_scan.join_scan`           csrc/join_scan.cu
  K2 `sparse_conv.sparse_conv_k3`    csrc/sparse_conv.cu
  K3 `strided_conv.downsample_conv_apply` / `upsample_conv_apply`
                                     csrc/sparse_conv.cu (K2's tiles over
                                     the child / up tables),
                                     csrc/strided_conv.cu
  K6 `voxelize.segment_sum`          csrc/segment_sum.cu
  K10 `voxelize.segment_max`         csrc/segment_max.cu (the global max
                                     pool, Cylinder3D's max voxelize)

The names of `taseg_tpu.ops` that the port has are exported here under
the same names (`taseg_tpu/ops/__init__.py:10-94`), the sparse tensors
and the global pools and BEV ops (`bev`) among them; `conv_k` (K2 at K
offsets, differentiable) takes the place of JAX's `sparse_conv_apply`.
No exported name is a submodule's: the modules import each other by
their module names (`from . import sparse_conv as _sc`).
"""

from .bev import (
    bev_height_compression,
    bev_reduction,
    bev_sparse_conv,
    global_avg_pool,
    global_max_pool,
    to_dense_bev,
)
from .coords import GridBounds, compute_bounds, pack_keys
from .join import join_keys, query_coords, unique_coords
from .point_range import (
    pixel_ids,
    point_to_range,
    point_to_range_tables,
    range_sample_table,
    range_to_point,
)
from .rulebook import (
    build_reverse_rulebook,
    build_rulebook,
    build_rulebook_k3,
    kernel_offsets,
    make_ntuple,
    spdownsample,
)
from .sparse_conv import KTable, conv_k, flip_rulebook
from .sparse_tensor import PointSet, SparseGrid
from .strided_conv import (
    StridedTables,
    build_strided_tables,
    downsample_conv_apply,
    upsample_conv_apply,
)
from .voxelize import (
    DevoxTable,
    IdentityDevoxTable,
    SegmentTables,
    build_segment_tables,
    devoxelize,
    segment_max,
    segment_sum,
    trilinear_table,
    voxelize_avg,
)

__all__ = [
    "DevoxTable", "GridBounds", "IdentityDevoxTable", "KTable", "PointSet", "SegmentTables",
    "SparseGrid", "StridedTables", "bev_height_compression", "bev_reduction", "bev_sparse_conv",
    "build_reverse_rulebook", "build_rulebook", "build_rulebook_k3", "build_segment_tables",
    "build_strided_tables", "compute_bounds", "conv_k", "devoxelize", "downsample_conv_apply",
    "flip_rulebook", "global_avg_pool", "global_max_pool", "join_keys", "kernel_offsets",
    "make_ntuple", "pack_keys", "pixel_ids", "point_to_range", "point_to_range_tables",
    "query_coords", "range_sample_table", "range_to_point", "segment_max", "segment_sum",
    "spdownsample", "to_dense_bev", "trilinear_table", "unique_coords",
    "upsample_conv_apply", "voxelize_avg",
]
