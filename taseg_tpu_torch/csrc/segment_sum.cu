// K6 segment_sum: sums of the sorted segments of a row table — replaces
// taseg_tpu/ops/voxelize.py:85 _segment_sum_sorted where the train step
// runs it: the forward of voxelize_avg (:107), the identity devoxelize
// backward _devox_id_bwd (:253) and the trilinear backward _devox_bwd
// (:284), the last with weights over the (8P)-row pair table.
//
//   out[u] = sum_{j in [starts[u], starts[u+1])} w[r_j] * src[r_j mod P]
//   r_j = perm[j]; rows r_j >= R (the tables' sentinel rows) are skipped
//
// src (P, C) f32 or bf16, w (R,) f32 or absent (weight 1), perm int64,
// starts (V + 1,) int32, out (V, C) f32.  The JAX package takes boundary
// differences of a mean-centred cumsum; this kernel adds each segment's
// members directly, in member order, so it is closer to the exact sum and
// deterministic (no atomics).
//
// Bound on the H100: bytes.  Each member reads an 8-byte perm entry, a
// 4-byte weight and a src row; out is written once.  At P = 131 072 the
// trilinear pair table has 8P + V members (~1.2 M): ~0.03 ms of reads at
// 3.35 TB/s with C = 20 bf16 rows.
//
// Design: G = 4, 8, 16 or 32 lanes per segment (the smallest that covers
// C, capped at a warp), so the 4-wide voxelize and the 20-wide head
// gradients keep most lanes busy; a group walks its segment's members
// and each lane sums its channels (lane, lane + G, ...) in f32.  The
// members of one segment are contiguous in perm, so a group's perm reads
// are one broadcast per member.
#include "common.cuh"

namespace {

using taseg::to_f;

constexpr int kThreads = 256;

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const T* __restrict__ src, const float* __restrict__ w,
                       const long long* __restrict__ perm,
                       const int* __restrict__ starts, float* __restrict__ out,
                       int v, int c, int r_real, int p_src) {
  const int lane = threadIdx.x % G;
  const int u = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  if (u >= v) return;
  const int beg = starts[u], end = starts[u + 1];
  for (int ch = lane; ch < c; ch += G) {
    float s = 0.f;
    for (int j = beg; j < end; ++j) {
      const int r = static_cast<int>(perm[j]);
      if (r >= r_real) continue;
      const int row = r % p_src;
      const float x = to_f(src[static_cast<size_t>(row) * c + ch]);
      s = w ? fmaf(w[r], x, s) : s + x;
    }
    out[static_cast<size_t>(u) * c + ch] = s;
  }
}

template <typename T, int G>
void launch(const void* src, const void* w, const void* perm,
            const void* starts, void* out, int v, int c, int r_real,
            int p_src, cudaStream_t s) {
  const int per_block = kThreads / G;
  segment_sum_kernel<T, G><<<(v + per_block - 1) / per_block, kThreads, 0, s>>>(
      static_cast<const T*>(src), static_cast<const float*>(w),
      static_cast<const long long*>(perm), static_cast<const int*>(starts),
      static_cast<float*>(out), v, c, r_real, p_src);
}

template <typename T>
void launch_g(const void* src, const void* w, const void* perm,
              const void* starts, void* out, int v, int c, int r_real,
              int p_src, cudaStream_t s) {
  if (c <= 4) {
    launch<T, 4>(src, w, perm, starts, out, v, c, r_real, p_src, s);
  } else if (c <= 8) {
    launch<T, 8>(src, w, perm, starts, out, v, c, r_real, p_src, s);
  } else if (c <= 16) {
    launch<T, 16>(src, w, perm, starts, out, v, c, r_real, p_src, s);
  } else {
    launch<T, 32>(src, w, perm, starts, out, v, c, r_real, p_src, s);
  }
}

}  // namespace

// src (P, C), w (R,) f32 or null, perm (N,) int64, starts (V + 1,) int32
// -> out (V, C) f32.  Needs 0 < P, 0 < R, and every perm entry below
// 2^31 (the wrappers check the lengths).
extern "C" int taseg_segment_sum(const void* src, const void* w,
                                 const void* perm, const void* starts,
                                 void* out, int v, int c, int r_real,
                                 int p_src, int dtype, void* stream) {
  if (v <= 0 || c <= 0 || r_real <= 0 || p_src <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == taseg::kF32) {
    launch_g<float>(src, w, perm, starts, out, v, c, r_real, p_src, s);
  } else if (dtype == taseg::kBF16) {
    launch_g<__nv_bfloat16>(src, w, perm, starts, out, v, c, r_real, p_src,
                            s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
