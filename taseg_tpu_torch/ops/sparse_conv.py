"""Stride-1 27-offset sparse conv forward (K2) — the port's counterpart of
`taseg_tpu/ops/tgf.py:tgf_conv_apply` (the main path's conv) and of the
oracle `taseg_tpu/ops/sparse_conv.py:sparse_conv_apply`.

With a dense (27, V) rulebook the output row of voxel v is

    out[v] = sum_k  feats[rb[k, v]] * (rb[k, v] >= 0)  @  W[k]

On CUDA tensors `sparse_conv_k3` launches a hand-written gather-GEMM of
`csrc/sparse_conv.cu`, chosen by `route`: the tensor-core kernel for
bf16 with C_in and C_out multiples of 8, the CUDA-core kernel for f32
and ragged widths.  On CPU tensors it runs `sparse_conv_plain`, the
per-offset gather + matmul of `_conv_fwd_impl`.  Both accumulate in f32
over all 27 offsets and round once to the input dtype.  (The JAX TGF path
rounds each group's transformed rows to the activation dtype before it
sums them, so in bf16 the two packages differ by that rounding.)

The port takes the rulebook directly and builds no TGF tables.
"""

from __future__ import annotations

import torch

from . import _build

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def route(dtype: torch.dtype, c_in: int, c_out: int) -> str:
    """The kernel a CUDA call takes: "mma" (tensor cores) for bf16 with
    C_in and C_out multiples of 8, else "simt" (CUDA cores).  f32 stays
    on CUDA cores: TF32 tensor cores would not hold its 1e-5 tolerance."""
    if dtype == torch.bfloat16 and c_in % 8 == 0 and c_out % 8 == 0:
        return "mma"
    return "simt"


def sparse_conv_plain(
    feats: torch.Tensor, weight: torch.Tensor, rb: torch.Tensor
) -> torch.Tensor:
    """Per-offset gather -> f32 matmul accumulation, one final rounding."""
    out = None
    for k in range(rb.shape[0]):
        idx = rb[k]
        g = feats[idx.clamp(min=0).long()]
        g = torch.where((idx >= 0)[:, None], g, 0)
        c = g.float() @ weight[k].float()
        out = c if out is None else out + c
    return out.to(feats.dtype)


def sparse_conv_k3(
    feats: torch.Tensor, weight: torch.Tensor, rb: torch.Tensor
) -> torch.Tensor:
    """feats (V, C_in), weight (27, C_in, C_out) in feats' dtype, rb
    (27, V) int32 -> (V, C_out) in feats' dtype."""
    dev = feats.device
    _build.check("feats", feats, tuple(DTYPE_CODES), 2, dev)
    _build.check("weight", weight, (feats.dtype,), 3, dev)
    _build.check("rb", rb, (torch.int32,), 2, dev)
    v, c_in = feats.shape
    if weight.shape[:2] != (27, c_in) or rb.shape != (27, v):
        raise ValueError(
            f"shapes do not fit: feats {tuple(feats.shape)}, weight "
            f"{tuple(weight.shape)}, rb {tuple(rb.shape)}"
        )
    if not _build.dispatch(feats):
        return sparse_conv_plain(feats, weight, rb)
    c_out = weight.shape[2]
    out = torch.empty((v, c_out), dtype=feats.dtype, device=dev)
    if v == 0 or c_out == 0:
        return out
    if c_in == 0:
        return out.zero_()
    ptrs = (feats.data_ptr(), weight.data_ptr(), rb.data_ptr(), out.data_ptr())
    if route(feats.dtype, c_in, c_out) == "mma":
        _build.check_aligned(feats=feats, weight=weight)
        _build.launch(
            "taseg_sparse_conv_k3_mma", ("sparse_conv_k3", "sparse_conv_k3_mma"),
            *ptrs, v, c_in, c_out,
        )
    else:
        _build.launch(
            "taseg_sparse_conv_k3", ("sparse_conv_k3",),
            *ptrs, v, c_in, c_out, DTYPE_CODES[feats.dtype],
        )
    return out
