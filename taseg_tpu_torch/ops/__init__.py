"""taseg_tpu_torch.ops — sparse ops of the port (counterpart of
`taseg_tpu.ops`): coordinate keys, sort-based joins, rulebooks, the
strided conv pair, point<->voxel transforms and the stride-1 sparse conv.

Kernels (built at first use, see `_build`):
  K1 `join_scan.join_scan`           csrc/join_scan.cu
  K2 `sparse_conv.sparse_conv_k3`    csrc/sparse_conv.cu
  K3 `strided_conv.downsample_conv_apply` / `upsample_conv_apply`
                                     csrc/strided_conv.cu
"""
