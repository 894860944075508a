"""taseg_tpu_torch — the PyTorch/CUDA port of `taseg_tpu`.

The module names follow the JAX package one for one, so each counterpart
is easy to find.  Public functions keep the JAX layouts: static row
capacities with padded rows, `(K, C_in, C_out)` conv weights, `(27, V)`
rulebooks in torchsparse offset order and `(x, y, z, batch)` coords.

Ops are plain functions on tensors and run on the device of their inputs.
The hot-path kernels (`ops.join_scan`, `ops.sparse_conv`,
`ops.strided_conv`) are hand-written CUDA for Hopper (`csrc/`), built at
first use by `ops._build`; each has a plain PyTorch version that serves
CPU tensors only.  Entry points (`engine.Segmenter`,
`models.voxel.minkunet.MinkUNet`) take `device=None`, which means CUDA,
and raise when CUDA is absent unless the caller passes `device="cpu"`.

This package imports torch and numpy only — never jax, flax or taseg_tpu.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
