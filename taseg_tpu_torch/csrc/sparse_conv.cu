// K2: stride-1 27-offset sparse conv forward — replaces the forward of
// taseg_tpu/ops/tgf.py:tgf_conv_apply (_tgf_fwd_impl, :165), whose oracle
// is taseg_tpu/ops/sparse_conv.py:_conv_fwd_impl.
//
//   out[v] = sum_k feats[rb[k, v]] @ W[k]      (rb[k, v] == -1: absent)
//
// feats (V, C_in) and W (27, C_in, C_out) in f32 or bf16, rb (27, V)
// int32; out (V, C_out) in the input dtype, accumulated in f32 over all
// 27 offsets and rounded once.
//
// Bound on the H100: at the path's widths (C_in 4..384, C_out 32..256)
// the bytes are small (one read of feats, W and rb, one write of out);
// the work is 2 * (present rulebook entries) * C_in * C_out operations,
// so the bound is operations at the tensor-core bf16 rate.
//
// Design (first, simple version): a gather-GEMM.  Each block owns a
// 64-row x 64-column output tile and keeps it in registers (4x4 per
// thread) for all 27 offsets; per offset it gathers the present
// neighbour rows into shared memory (zero for -1), multiplies them with
// the W[k] tile by f32 FMA and skips the offset when no row of the tile
// has that neighbour.  Ragged C_in / C_out / V edges are masked.  It uses
// CUDA cores, not tensor cores: mma/wgmma with a cp.async ring is the
// next step for speed.
#include "common.cuh"

namespace {

using taseg::store_f;
using taseg::to_f;

constexpr int kBM = 64;   // output rows per block
constexpr int kBN = 64;   // output columns per block
constexpr int kBK = 16;   // input channels per shared-memory stage
constexpr int kThreads = 256;
constexpr int kOffsets = 27;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k3_conv_kernel(const T* __restrict__ feats, const T* __restrict__ w,
                   const int* __restrict__ rb, T* __restrict__ out, int v,
                   int c_in, int c_out) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN];
  __shared__ int idx_s[kBM];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float acc[4][4] = {};

  for (int k = 0; k < kOffsets; ++k) {
    int present = 0;
    if (tid < kBM) {
      const int r = m0 + tid;
      const int src = r < v ? rb[static_cast<size_t>(k) * v + r] : -1;
      idx_s[tid] = src;
      present = src >= 0;
    }
    // barrier for idx_s; skip offsets absent from the whole tile
    if (!__syncthreads_or(present)) continue;
    const T* wk = w + static_cast<size_t>(k) * c_in * c_out;
    for (int c0 = 0; c0 < c_in; c0 += kBK) {
      for (int e = tid; e < kBM * kBK; e += kThreads) {
        const int r = e / kBK, kk = e % kBK, c = c0 + kk, src = idx_s[r];
        As[kk][r] = (src >= 0 && c < c_in)
                        ? to_f(feats[static_cast<size_t>(src) * c_in + c])
                        : 0.f;
      }
      for (int e = tid; e < kBK * kBN; e += kThreads) {
        const int kk = e / kBN, n = e % kBN, c = c0 + kk, col = n0 + n;
        Bs[kk][n] = (c < c_in && col < c_out)
                        ? to_f(wk[static_cast<size_t>(c) * c_out + col])
                        : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= v) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < c_out)
        store_f(acc[i][j], &out[static_cast<size_t>(r) * c_out + col]);
    }
  }
}

}  // namespace

extern "C" int taseg_sparse_conv_k3(const void* feats, const void* w,
                                    const void* rb, void* out, int v,
                                    int c_in, int c_out, int dtype,
                                    void* stream) {
  if (v <= 0 || c_in <= 0 || c_out <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((v + kBM - 1) / kBM, (c_out + kBN - 1) / kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rb);
  if (dtype == taseg::kF32) {
    k3_conv_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(feats), static_cast<const float*>(w), r,
        static_cast<float*>(out), v, c_in, c_out);
  } else if (dtype == taseg::kBF16) {
    k3_conv_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feats),
        static_cast<const __nv_bfloat16*>(w), r,
        static_cast<__nv_bfloat16*>(out), v, c_in, c_out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
