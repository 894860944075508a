// K2: stride-1 27-offset sparse conv forward — replaces the forward of
// taseg_tpu/ops/tgf.py:216 tgf_conv_apply (_tgf_fwd_impl, :165), whose
// oracle is taseg_tpu/ops/sparse_conv.py:_conv_fwd_impl.
//
//   out[v] = sum_k feats[rb[k, v]] @ W[k]      (rb[k, v] == -1: absent)
//
// feats (V, C_in) and W (27, C_in, C_out) in f32 or bf16, rb (27, V)
// int32; out (V, C_out) in the input dtype, accumulated in f32 over all
// 27 offsets and rounded once.
//
// Bound on the H100: one read of feats, W and rb and one write of out,
// against 2 * (present rulebook pairs) * C_in * C_out operations.  At the
// main path's shapes the bytes bound it (0.33 ms per scan in all against
// 0.19 ms of present-pair operations at the bf16 tensor-core rate).
//
// Two kernels; the wrapper picks one by dtype and widths:
//
// k3_conv_mma_kernel (bf16, C_in % 8 == 0, C_out % 8 == 0): the
// tensor-core gather-GEMM of gather_mma.cuh.  Against the four limits of
// the CUDA-core kernel below:
//   1. math on tensor cores: mma.sync m16n8k16 bf16 -> f32 on ldmatrix
//      fragments, instead of f32 FMA on operands widened in shared memory;
//   2. dense work inside a tile: still there.  A 64-row tile computes all
//      its rows for every offset that one of them needs (about 2.6x the
//      present-pair work at the path's occupancy); compacting pairs per
//      offset is the next step;
//   3. gathers: 16-byte cp.async per row chunk, zero-filled for absent
//      rows (src_size 0), in a 3-stage ring, so the next stages' gathers
//      are in flight during this stage's math;
//   4. tile width: 32, 64, 96 or 128 output columns per block, from C_out,
//      so 32- and 96-wide convs carry no masked columns.
//
// k3_conv_kernel (f32, or ragged widths such as the stem's C_in = 4): a
// 64 x 64 output tile in registers (4 x 4 per thread) for all 27 offsets;
// per offset it gathers the present neighbour rows into shared memory
// (zero for -1), multiplies them with the W[k] tile by f32 FMA and skips
// the offset when no row of the tile has that neighbour.  Ragged C_in /
// C_out / V edges are masked.  f32 stays on CUDA cores: TF32 tensor cores
// would not hold the f32 tolerance.
#include "common.cuh"
#include "gather_mma.cuh"

namespace {

namespace mma = taseg::mma;
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

template <int BN>
__global__ void __launch_bounds__(mma::kThreads)
    k3_conv_mma_kernel(const __nv_bfloat16* __restrict__ feats,
                       const __nv_bfloat16* __restrict__ w,
                       const int* __restrict__ rb,
                       __nv_bfloat16* __restrict__ out, int v, int c_in,
                       int c_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const mma::Smem s = mma::carve<BN>(smem, kOffsets);
  const int m0 = blockIdx.x * mma::kBM, n0 = blockIdx.y * BN;
  for (int e = threadIdx.x; e < kOffsets * mma::kBM; e += mma::kThreads) {
    const int k = e / mma::kBM, r = m0 + e % mma::kBM;
    s.idx[e] = r < v ? rb[static_cast<size_t>(k) * v + r] : -1;
  }
  __syncthreads();
  const int n_present = mma::present_offsets(s, kOffsets);
  float acc[2][BN / 16][4] = {};
  mma::gather_mma_tile<BN>(s, n_present, feats, w, c_in, c_out, n0, acc);
  mma::store_tile<BN>(acc, out, v, c_out, m0, n0);
}

}  // namespace

// bf16 only; C_in and C_out multiples of 8, feats and w 16-byte aligned
extern "C" int taseg_sparse_conv_k3_mma(const void* feats, const void* w,
                                        const void* rb, void* out, int v,
                                        int c_in, int c_out, void* stream) {
  if (v <= 0 || c_in <= 0 || c_out <= 0 || c_in % 8 != 0 || c_out % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  return mma::with_tile_n(c_out, [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    return mma::launch_tiles<BN>(
        k3_conv_mma_kernel<BN>, kOffsets, v, c_out,
        static_cast<cudaStream_t>(stream), static_cast<const bf16*>(feats),
        static_cast<const bf16*>(w), static_cast<const int*>(rb),
        static_cast<bf16*>(out), v, c_in, c_out);
  });
}

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
