// K10: the per-segment max and its gradient.
//
// Replaces `jax.ops.segment_max` (an XLA scatter, no Pallas kernel) where
// the JAX package calls it: Cylinder3D's max-pooled initial voxelization
// (`taseg_tpu/models/voxel/cylinder3d.py:236`) and the global max pool
// (`taseg_tpu/ops/bev.py:43`).  Forward: out[s, c] = max of x[r, c] over
// the rows r with seg[r] = s, -inf for a segment without rows.  Backward:
// dx[r, c] = g[s, c] / n[s, c] where x[r, c] equals its segment's max, n
// counting those rows (JAX's split of the cotangent among ties), else 0.
//
// The two callers sit at opposite ends.  Cylinder3D: ~120 000 rows x 16
// columns into as many segments, almost every one of one row (the rows
// are not sorted by segment).  The pool: a few segments (the batch) of up
// to ~10^5 rows each, at 128-256 columns.  One design takes both without
// a serial loop per segment: each thread owns one column of a run of R
// consecutive rows (neighbouring threads neighbouring columns, so every
// row is read coalesced), keeps the running max of the segment it is in,
// and writes it out with one atomic where the segment changes and at the
// end of its run.  On Cylinder's rows that is one atomic per row; on the
// pool's sorted batch column one per R rows, so the few addresses the
// pool writes see ~rows / R atomics each.  The wrapper picks R so the
// grid is about one wave of the card (`segment_max_rows`).
//
// The max is independent of order, so the result is the same bits on
// every run without sorted tables.  The atomic is the sign split of a
// float max on 32-bit words: a value with the sign bit clear takes
// atomicMax on the word as a signed int, one with it set atomicMin on the
// word as an unsigned int; the IEEE bit patterns order like the values
// under those two comparisons, and the output starts at -inf (0xff800000,
// the largest negative pattern), written by the wrapper.  -0.0 is made
// +0.0 before the atomic (x + 0.0f), so a max of zeros is +0.0 whatever
// the signs of its members (the plain version adds 0.0 to its result the
// same way); a NaN is made the positive quiet NaN, above every number, so
// a NaN member makes its segment NaN, as `scatter_reduce` amax does.
// bf16 rows go through the same f32 atomics into an f32 output that the
// wrapper rounds (exactly: every value is a bf16).
//
// The backward counts the ties first and splits the cotangent after, so
// every row needs its segment's final count: one launch in two phases
// with a grid-wide barrier between them.  The grid is at most what the
// card holds at once (cudaLaunchCooperativeKernel refuses more), and the
// blocks loop over the work; the barrier is two counters of the wrapper's
// zeroed buffer (`_build.zeroed_counters`), set back to 0 by the last
// block out.  Phase 1 adds each run's tie count (x ==
// out[seg] as floats: +0.0 and -0.0 tie, NaN ties nothing) with one
// integer atomicAdd per segment change; phase 2 writes dx = g * (1 / n),
// the multiply and the division rounded apart, as the plain version
// (and JAX) computes it.
//
// Bound: the bytes.  Forward x read once and out written once (the seg
// column beside them); backward x, seg, out, g read and dx written.  At
// Cylinder's 120 000 x 16 f32 that is ~8.5 MB forward, ~2.5 us at
// 3.35 TB/s; the atomics go to L2 and a launch costs about as much.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using taseg::to_f;

__device__ __forceinline__ float canonical(float v) {
  // -0.0 -> +0.0; any NaN -> the positive quiet NaN
  return v != v ? __int_as_float(0x7fc00000) : v + 0.0f;
}

__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// One thread per (run of `rows_per` rows, column): item t is column
// t % c of run t / c.
template <typename T>
__global__ void segment_max_fwd_kernel(const T* __restrict__ x,
                                       const int* __restrict__ seg,
                                       float* __restrict__ out, int p, int c,
                                       int s, int rows_per) {
  const long long items = static_cast<long long>((p + rows_per - 1) / rows_per) * c;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; t < items;
       t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int col = static_cast<int>(t % c);
    const int r0 = static_cast<int>(t / c) * rows_per;
    const int r1 = min(r0 + rows_per, p);
    int cur = -1;
    float m = 0.f;
    for (int r = r0; r < r1; ++r) {
      const int id = seg[r];
      const float v = canonical(to_f(x[static_cast<long long>(r) * c + col]));
      if (id != cur) {
        if (cur >= 0) atomic_max_f32(out + static_cast<long long>(cur) * c + col, m);
        cur = (id >= 0 && id < s) ? id : -1;
        m = v;
      } else if (v > m || v != v) {
        m = v;
      }
    }
    if (cur >= 0) atomic_max_f32(out + static_cast<long long>(cur) * c + col, m);
  }
}

// Every block of a co-resident grid waits here until all have arrived;
// bar[0] counts the arrivals.
__device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (atomicAdd(bar, 0u) < gridDim.x) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

template <typename T>
__global__ void segment_max_bwd_kernel(const T* __restrict__ x,
                                       const int* __restrict__ seg,
                                       const T* __restrict__ out,
                                       const T* __restrict__ g,
                                       int* __restrict__ n, T* __restrict__ dx,
                                       unsigned int* __restrict__ bar,
                                       int p, int c, int s, int rows_per) {
  const long long items = static_cast<long long>((p + rows_per - 1) / rows_per) * c;
  const long long first = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  // phase 1: the ties per (segment, column)
  for (long long t = first; t < items; t += step) {
    const int col = static_cast<int>(t % c);
    const int r0 = static_cast<int>(t / c) * rows_per;
    const int r1 = min(r0 + rows_per, p);
    int cur = -1, hits = 0;
    for (int r = r0; r < r1; ++r) {
      const int id = seg[r];
      if (id != cur) {
        if (cur >= 0 && hits) atomicAdd(n + static_cast<long long>(cur) * c + col, hits);
        cur = (id >= 0 && id < s) ? id : -1;
        hits = 0;
      }
      if (cur >= 0 && to_f(x[static_cast<long long>(r) * c + col]) ==
                          to_f(out[static_cast<long long>(cur) * c + col])) {
        ++hits;
      }
    }
    if (cur >= 0 && hits) atomicAdd(n + static_cast<long long>(cur) * c + col, hits);
  }
  grid_barrier(bar);
  // phase 2: each tie's share, 0 elsewhere
  for (long long t = first; t < items; t += step) {
    const int col = static_cast<int>(t % c);
    const int r0 = static_cast<int>(t / c) * rows_per;
    const int r1 = min(r0 + rows_per, p);
    for (int r = r0; r < r1; ++r) {
      const int id = seg[r];
      const long long i = static_cast<long long>(r) * c + col;
      float d = 0.f;
      if (id >= 0 && id < s) {
        const long long o = static_cast<long long>(id) * c + col;
        if (to_f(x[i]) == to_f(out[o])) {
          const float cnt = static_cast<float>(__ldcg(n + o));
          d = __fmul_rn(to_f(g[o]), __fdiv_rn(1.0f, cnt));
        }
      }
      taseg::store_f(d, dx + i);
    }
  }
  // the last block out sets the barrier's counters back to 0: every
  // block has left the barrier's wait before it counts itself here
  if (threadIdx.x == 0 && atomicAdd(bar + 1, 1u) == gridDim.x - 1) {
    bar[0] = 0u;
    bar[1] = 0u;
  }
}

constexpr int kThreads = 256;

template <typename T>
int launch_fwd(const void* x, const void* seg, void* out, int p, int c, int s, int rows_per,
               cudaStream_t stream) {
  const long long items = static_cast<long long>((p + rows_per - 1) / rows_per) * c;
  const long long want = (items + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < (1 << 30) ? want : (1 << 30));
  segment_max_fwd_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(seg), static_cast<float*>(out), p, c, s,
      rows_per);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* seg, const void* out, const void* g, void* n, void* dx,
               void* bar, int p, int c, int s, int rows_per, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segment_max_bwd_kernel<T>,
                                                        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = static_cast<long long>((p + rows_per - 1) / rows_per) * c;
  const long long want = (items + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(per_sm) * sms;
  int blocks = static_cast<int>(want < most ? want : most);
  if (blocks < 1) blocks = 1;
  const T* xp = static_cast<const T*>(x);
  const int* sp = static_cast<const int*>(seg);
  const T* op = static_cast<const T*>(out);
  const T* gp = static_cast<const T*>(g);
  int* np = static_cast<int*>(n);
  T* dp = static_cast<T*>(dx);
  unsigned int* bp = static_cast<unsigned int*>(bar);
  void* args[] = {&xp, &sp, &op, &gp, &np, &dp, &bp, &p, &c, &s, &rows_per};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(segment_max_bwd_kernel<T>),
                                    dim3(blocks), dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (p, c) f32 or bf16 (dtype code), seg (p,) int32, out (s, c) f32
// filled with -inf by the caller.
extern "C" int taseg_segment_max(const void* x, const void* seg, void* out, int p, int c, int s,
                                 int rows_per, int dtype, void* stream) {
  if (p == 0 || c == 0 || s == 0) return 0;
  if (rows_per < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == taseg::kF32) return launch_fwd<float>(x, seg, out, p, c, s, rows_per, st);
  if (dtype == taseg::kBF16) return launch_fwd<__nv_bfloat16>(x, seg, out, p, c, s, rows_per, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x (p, c), out and g (s, c), dx (p, c), all of one dtype; n (s, c)
// int32 and bar (2,) uint32 zeroed by the caller (bar is 0 again after).
extern "C" int taseg_segment_max_bwd(const void* x, const void* seg, const void* out,
                                     const void* g, void* n, void* dx, void* bar, int p, int c,
                                     int s, int rows_per, int dtype, void* stream) {
  if (p == 0 || c == 0) return 0;
  if (rows_per < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == taseg::kF32)
    return launch_bwd<float>(x, seg, out, g, n, dx, bar, p, c, s, rows_per, st);
  if (dtype == taseg::kBF16)
    return launch_bwd<__nv_bfloat16>(x, seg, out, g, n, dx, bar, p, c, s, rows_per, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
