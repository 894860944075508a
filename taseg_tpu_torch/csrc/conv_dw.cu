// K4 k3_conv_dw and K5 strided_dw: the weight gradients of the stride-1
// k3 conv and of the ks=2 / stride=2 conv pair.
//
// K4 replaces the d_W half of taseg_tpu/ops/f3conv.py:219 f3_bwd_fused
// (the backward of ops/tgf.py:216 tgf_conv_apply, _tgf_vjp_bwd :231):
//
//   d_W[k] = sum_i feats[i]^T (x) g[rb_bwd[k, i]]     (rb_bwd == -1: none)
//
// with rb_bwd the flipped rulebook: rb_bwd[k, i] = v <=> rb_fwd[k, v] = i.
// K5 replaces the d_W einsums of taseg_tpu/ops/strided_conv.py:136
// _down_bwd and :169 _up_bwd:
//
//   d_W[s] = sum_{f : slot(f) = s, parent(f) >= 0} X[f]^T (x) Y[f]
//   down: X[f] = feats_fine[f],           Y[f] = g_coarse[parent f]
//   up:   X[f] = feats_coarse[parent f],  Y[f] = g_fine[f]
//
// Both are one kernel over (x row, y row) pairs, `PairsK3` or
// `PairsStrided` naming the pairs of output index o (the offset k or the
// slot s).  Inputs f32 or bf16, products and sums in f32, out f32
// (n_out, C_in, C_out); the wrappers round it to the weight's dtype.
//
// Bound on the H100: operations.  Each present pair costs 2 C_in C_out
// flops; the path's 48 k3 convs hold ~184 GFLOP of present pairs per
// step (the forward's count), which is 2.7 ms at the 67 TFLOP/s of f32
// CUDA cores and 0.19 ms at the bf16 tensor-core rate.  The bytes (each
// feature row read once per tile column, the tables once) are small
// against that.  This first design stays on CUDA cores (f32 FMA on
// operands widened in shared memory); the tensor-core route is queued.
//
// Design:
//   * a block owns a 64 x 64 tile of d_W[o] (4 x 4 per thread, f32
//     registers) and walks the rows of its split in windows of 256: each
//     thread tests one row, the present pairs are compacted in row order
//     into shared memory (warp ballots), and the tile multiplies them 16
//     pairs per stage.  Only present pairs are multiplied, so an offset
//     that few rows have costs little.
//   * split-K over rows.  At level 0 (C_in = C_out = 32) the (o, tile)
//     grid has only 27 blocks for 132 SMs, so the rows are cut into
//     `splits` contiguous ranges and each split writes its own partial
//     tile.  The splits come from the shapes alone (the wrappers'
//     `dw_splits`):
//       splits = max(1, min(ceil(528 / (n_out * tiles)),   // 4 blocks/SM
//                           ceil(rows / 1024),             // >= 1024 rows
//                           floor(64 MiB / (n_out*C_in*C_out*4))))
//     e.g. level 0, 32 -> 32: 20 splits of 6 656 rows, 2.2 MB of
//     partials; up1_blocks_0 (384 -> 256, 648 blocks): 1 split.
//   * determinism: no float atomics.  Within a block the pairs are summed
//     in row order; a second kernel adds the splits' partials in split
//     order.  Two calls on the same inputs give the same bits.
#include <algorithm>

#include "common.cuh"

namespace {

using taseg::to_f;

constexpr int kTI = 64;  // input channels per tile
constexpr int kTO = 64;  // output channels per tile
constexpr int kBR = 16;  // pairs per shared-memory stage
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// K4: pair (i, rb_bwd[k, i]) of offset k
struct PairsK3 {
  const int* rb;
  int v;
  __device__ __forceinline__ bool get(int o, int i, int& xr, int& yr) const {
    const int y = rb[static_cast<size_t>(o) * v + i];
    xr = i;
    yr = y;
    return y >= 0;
  }
};

// K5: fine row f of slot o with a parent; `up` swaps the two sides
struct PairsStrided {
  const int* parent;
  const int* slot;
  int up;
  __device__ __forceinline__ bool get(int o, int f, int& xr, int& yr) const {
    const int p = parent[f];
    if (p < 0 || (slot[f] & 7) != o) return false;
    xr = up ? p : f;
    yr = up ? f : p;
    return true;
  }
};

// grid: x = C_in tiles * C_out tiles, y = output index o, z = split.
// Writes the split's (n_out, C_in, C_out) partial at out + z * n_out *
// C_in * C_out.
template <typename T, typename Pairs>
__global__ void __launch_bounds__(kThreads)
    dw_kernel(const T* __restrict__ x, const T* __restrict__ y, Pairs pairs,
              float* __restrict__ out, int n_rows, int rows_per_split,
              int c_in, int c_out) {
  __shared__ float As[kBR][kTI];
  __shared__ float Bs[kBR][kTO];
  __shared__ int xs[kThreads];
  __shared__ int ys[kThreads];
  __shared__ int warp_cnt[kWarps];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int tiles_o = (c_out + kTO - 1) / kTO;
  const int i0 = (blockIdx.x / tiles_o) * kTI;
  const int o0 = (blockIdx.x % tiles_o) * kTO;
  const int o = blockIdx.y;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(n_rows, r_begin + rows_per_split);
  float acc[4][4] = {};

  for (int base = r_begin; base < r_end; base += kThreads) {
    // compact this window's present pairs, in row order
    const int r = base + tid;
    int xr = -1, yr = -1;
    const bool ok = r < r_end && pairs.get(o, r, xr, yr);
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) warp_cnt[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_cnt[w];
      before += w < warp ? c : 0;
      n += c;
    }
    if (ok) {
      const int pos = before + __popc(ballot & ((1u << lane) - 1u));
      xs[pos] = xr;
      ys[pos] = yr;
    }
    __syncthreads();
    for (int c0 = 0; c0 < n; c0 += kBR) {
      for (int e = tid; e < kBR * kTI; e += kThreads) {
        const int rr = e / kTI, c = e % kTI, p = c0 + rr, ch = i0 + c;
        As[rr][c] = (p < n && ch < c_in)
                        ? to_f(x[static_cast<size_t>(xs[p]) * c_in + ch])
                        : 0.f;
      }
      for (int e = tid; e < kBR * kTO; e += kThreads) {
        const int rr = e / kTO, c = e % kTO, p = c0 + rr, ch = o0 + c;
        Bs[rr][c] = (p < n && ch < c_out)
                        ? to_f(y[static_cast<size_t>(ys[p]) * c_out + ch])
                        : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < kBR; ++rr) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[rr][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[rr][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  const size_t n_out = gridDim.y;
  float* dst = out + (static_cast<size_t>(blockIdx.z) * n_out + o) *
                         static_cast<size_t>(c_in) * c_out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = i0 + ty * 4 + i;
    if (ci >= c_in) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = o0 + tx * 4 + j;
      if (co < c_out) dst[static_cast<size_t>(ci) * c_out + co] = acc[i][j];
    }
  }
}

// out[e] = sum over splits, in split order, of part[s * n + e]
__global__ void reduce_splits_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, size_t n,
                                     int splits) {
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[static_cast<size_t>(k) * n + e];
    out[e] = s;
  }
}

template <typename Pairs>
int launch_dw(const void* x, const void* y, Pairs pairs, void* out,
              void* part, int n_out, int n_rows, int c_in, int c_out,
              int splits, int rows_per_split, int dtype, cudaStream_t s) {
  if (n_out <= 0 || n_rows <= 0 || c_in <= 0 || c_out <= 0 || splits <= 0 ||
      rows_per_split <= 0 ||
      static_cast<long long>(splits) * rows_per_split < n_rows ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ((c_in + kTI - 1) / kTI) * ((c_out + kTO - 1) / kTO);
  const dim3 grid(tiles, n_out, splits);
  float* dst = static_cast<float*>(splits > 1 ? part : out);
  if (dtype == taseg::kF32) {
    dw_kernel<float, Pairs><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(y), pairs,
        dst, n_rows, rows_per_split, c_in, c_out);
  } else if (dtype == taseg::kBF16) {
    dw_kernel<__nv_bfloat16, Pairs><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(y), pairs, dst, n_rows,
        rows_per_split, c_in, c_out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(n_out) * c_in * c_out;
  const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
  reduce_splits_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(part),
                                              static_cast<float*>(out), n,
                                              splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats (V, C_in), grad (V, C_out), rb_bwd (27, V) int32 -> out (27, C_in,
// C_out) f32; part (splits, 27, C_in, C_out) f32 scratch when splits > 1
extern "C" int taseg_k3_conv_dw(const void* feats, const void* grad,
                                const void* rb_bwd, void* out, void* part,
                                int v, int c_in, int c_out, int splits,
                                int rows_per_split, int dtype, void* stream) {
  const PairsK3 pairs{static_cast<const int*>(rb_bwd), v};
  return launch_dw(feats, grad, pairs, out, part, 27, v, c_in, c_out, splits,
                   rows_per_split, dtype, static_cast<cudaStream_t>(stream));
}

// down (up = 0): x = fine feats (V_fine, C_in), y = coarse grad
// (V_coarse, C_out); up (up = 1): x = coarse feats (V_coarse, C_in),
// y = fine grad (V_fine, C_out).  parent/slot (V_fine,) int32 -> out
// (8, C_in, C_out) f32; part as for K4
extern "C" int taseg_strided_dw(const void* x, const void* y,
                                const void* parent, const void* slot,
                                void* out, void* part, int v_fine, int c_in,
                                int c_out, int up, int splits,
                                int rows_per_split, int dtype, void* stream) {
  const PairsStrided pairs{static_cast<const int*>(parent),
                           static_cast<const int*>(slot), up};
  return launch_dw(x, y, pairs, out, part, 8, v_fine, c_in, c_out, splits,
                   rows_per_split, dtype, static_cast<cudaStream_t>(stream));
}
