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

`k3_conv` is the differentiable form (`K3Conv`, the counterpart of the
custom VJP `_tgf_vjp_bwd`, JAX tgf.py:231): its backward runs
`f3conv.f3_bwd_fused` over the flipped rulebook `flip_rulebook(rb)` and
K4's pair lists, which the topology builds once per level and step.
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


def flip_rulebook(rb: torch.Tensor) -> torch.Tensor:
    """Reverse table of a same-coordinate-set odd-kernel rulebook (JAX
    sparse_conv.py:207): offset k -> 26 - k negates the offset, so
    flip(rb)[k, i] = v  <=>  rb[k, v] = i."""
    return rb.flip(0).contiguous()


def sparse_conv_k3(
    feats: torch.Tensor, weight: torch.Tensor, rb: torch.Tensor,
    *, dgrad: bool = False,
) -> torch.Tensor:
    """feats (V, C_in), weight (27, C_in, C_out) in feats' dtype, rb
    (27, V) int32 -> (V, C_out) in feats' dtype.  `dgrad` marks a call
    that computes an input gradient: its launch also counts under
    `sparse_conv_k3_dgrad`."""
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
            "taseg_sparse_conv_k3_mma",
            _build.counters("sparse_conv_k3", dgrad=dgrad, mma=True),
            *ptrs, v, c_in, c_out,
        )
    else:
        _build.launch(
            "taseg_sparse_conv_k3", _build.counters("sparse_conv_k3", dgrad=dgrad),
            *ptrs, v, c_in, c_out, DTYPE_CODES[feats.dtype],
        )
    return out


class K3Conv(torch.autograd.Function):
    """`sparse_conv_k3` with its gradient.  Saves feats and weight; the
    rulebooks and pair lists are held by reference (no copy).  The
    backward returns no d_feats where feats need none (the stem's first
    conv, whose input is the voxelized point features)."""

    @staticmethod
    def forward(ctx, feats, weight, rb, rb_bwd, pairs):
        ctx.save_for_backward(feats, weight)
        ctx.rb_bwd, ctx.pairs = rb_bwd, pairs
        return sparse_conv_k3(feats, weight, rb)

    @staticmethod
    def backward(ctx, grad):
        from .f3conv import f3_bwd_fused

        feats, weight = ctx.saved_tensors
        d_feats, d_w = f3_bwd_fused(
            feats, weight, grad.contiguous(), ctx.rb_bwd,
            need_feats=ctx.needs_input_grad[0], pairs=ctx.pairs,
        )
        return d_feats, d_w, None, None, None


def wants_grad(*tensors: torch.Tensor) -> bool:
    """True where autograd records a graph through one of `tensors`: the
    differentiable entry points then go through their Function, else
    straight to the kernel wrapper (inference pays nothing for autograd)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def k3_conv(
    feats: torch.Tensor, weight: torch.Tensor, rb: torch.Tensor,
    rb_bwd: torch.Tensor = None, pairs=None,
) -> torch.Tensor:
    """The stride-1 k3 conv, differentiable where autograd asks for a
    gradient (then `rb_bwd = flip_rulebook(rb)` is required; `pairs`,
    `f3conv.k3_pair_lists(rb_bwd)`, is built in the backward where not
    given), else the plain `sparse_conv_k3` call."""
    if wants_grad(feats, weight):
        if rb_bwd is None:
            raise ValueError(
                "a gradient of the k3 conv needs the flipped rulebook: build "
                "the topology with devox_pairs=True"
            )
        return K3Conv.apply(feats, weight, rb, rb_bwd, pairs)
    return sparse_conv_k3(feats, weight, rb)
