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
// seg (N,) int32 the segment id of each sorted row, starts (V + 1,)
// int32, out (V, C) f32.  The JAX package takes boundary differences of a
// mean-centred cumsum; this kernel adds each segment's members directly,
// so it is closer to the exact sum, and in a fixed order (no atomics):
// two calls on the same inputs give the same bits.
//
// Bound on the H100: bytes.  Each member reads an 8-byte perm entry, a
// 4-byte weight and a src row; out is written once.  At P = 131 072 the
// stride-16 trilinear pair table has 8P + V members (~1.05 M): ~0.02 ms
// of reads at 3.35 TB/s with C = 20 bf16 rows.
//
// Why the first design (one lane group per segment, walking its members
// in sequence) was slow: each member cost one dependent perm -> src load,
// so a segment of ~150 members (stride 16, with a long tail) was ~150
// load latencies in a row with one load in flight per lane.  This design
// spreads the members over lanes, whatever the segment lengths:
//
//   * pass 1, segment_sum_chunk_kernel: the sorted members [0, M), M =
//     starts[V], are cut into chunks of kChunk = 64; one warp per chunk,
//     32 members per round, one member per lane (coalesced perm / seg
//     reads, 32 independent row gathers in flight per warp, each row read
//     in 16- or 8-byte pieces where its width allows).  A segmented
//     inclusive scan over the lanes (shuffles, keyed by seg) sums each
//     run of equal segment ids; the run that reaches lane 31 is carried
//     into the next round.  The run's last lane writes it: straight to
//     out when the segment lies inside the chunk, else to the chunk's
//     partial slots (slot 0: the chunk's first segment, slot 1: its last;
//     only these two can cross a chunk boundary, and the chunk knows
//     which do from the seg ids beside its ends).  Segments without
//     members (none in the port's tables, which give each a sentinel)
//     are written 0 by the lane that sees the gap.
//   * pass 2, segment_sum_merge_kernel: per (chunk, channel), where the
//     chunk's last segment begins in it and runs on, its partials are
//     added in chunk order.
// Short chunks keep many warps in flight with short dependent chains
// (the voxelize forward, ~1 member per segment, has 4096 chunks); long
// segments cost one partial per 64 members.  The channels are taken CG
// at a time (4 for the 4-wide voxelize, 32 for the 20-wide head
// gradients).  The order of the sums depends only on the tables, so the
// result is deterministic.
#include <cstdint>
#include <cstring>
#include <numeric>

#include "common.cuh"

namespace {

using taseg::to_f;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 64;  // sorted members per warp (2 rounds of 32)
constexpr unsigned kFull = 0xffffffffu;

template <int VW>
struct Vec;
template <>
struct Vec<16> { using type = uint4; };
template <>
struct Vec<8> { using type = uint2; };
template <>
struct Vec<4> { using type = unsigned; };
template <>
struct Vec<2> { using type = unsigned short; };

// val[0, nc) = wt * row[0, nc), read VW bytes at a time, the rest 0
// (nc * sizeof(T) and the row's address are multiples of VW)
template <typename T, int CG, int VW>
__device__ __forceinline__ void load_row(const T* row, int nc, float wt,
                                         float (&val)[CG]) {
  constexpr int kPer = VW / static_cast<int>(sizeof(T));
  using V = typename Vec<VW>::type;
#pragma unroll
  for (int i = 0; i < CG / kPer; ++i) {
    if (i * kPer < nc) {
      const V raw = __ldg(reinterpret_cast<const V*>(row) + i);
      T el[kPer];
      memcpy(el, &raw, VW);
#pragma unroll
      for (int t = 0; t < kPer; ++t) val[i * kPer + t] = wt * to_f(el[t]);
    } else {
#pragma unroll
      for (int t = 0; t < kPer; ++t) val[i * kPer + t] = 0.f;
    }
  }
}

// dst[0, nc) = val[0, nc), OW bytes at a time (16: float4, 4: float)
template <int CG, int OW>
__device__ __forceinline__ void store_row(float* dst, int nc,
                                          const float (&val)[CG]) {
  if (OW == 16) {
#pragma unroll
    for (int i = 0; i < CG / 4; ++i)
      if (i * 4 < nc)
        reinterpret_cast<float4*>(dst)[i] =
            make_float4(val[4 * i], val[4 * i + 1], val[4 * i + 2], val[4 * i + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < CG; ++q)
      if (q < nc) dst[q] = val[q];
  }
}

__device__ __forceinline__ void zero_rows(float* out, int lo, int hi, int c) {
  for (size_t i = static_cast<size_t>(lo) * c; i < static_cast<size_t>(hi) * c; ++i)
    out[i] = 0.f;
}

template <typename T, int CG, int VW, int OW>
__global__ void __launch_bounds__(kThreads)
    segment_sum_chunk_kernel(const T* __restrict__ src,
                             const float* __restrict__ w,
                             const long long* __restrict__ perm,
                             const int* __restrict__ seg,
                             const int* __restrict__ starts,
                             float* __restrict__ out, float* __restrict__ part,
                             int v, int c, int r_real, int p_src,
                             int n_chunks) {
  const int lane = threadIdx.x % 32;
  const int chunk = blockIdx.x * kWarps + threadIdx.x / 32;
  if (chunk >= n_chunks) return;
  const int m = starts[v];  // members that belong to a segment
  const int b = chunk * kChunk;
  if (b >= m) {
    if (b == 0)  // no members at all
      for (size_t i = lane; i < static_cast<size_t>(v) * c; i += 32) out[i] = 0.f;
    return;
  }
  const int e = min(b + kChunk, m);
  const int u_first = seg[b], u_last = seg[e - 1];
  const int before = b > 0 ? seg[b - 1] : -1;
  const bool first_open = before == u_first;  // began in an earlier chunk
  const bool last_open = e < m && seg[e] == u_last;  // runs on after e
  if (lane == 0) {
    zero_rows(out, before + 1, u_first, c);  // empty segments before b
    if (e == m) zero_rows(out, u_last + 1, v, c);  // ... after the last
  }
  for (int c0 = 0; c0 < c; c0 += CG) {
    const int nc = min(CG, c - c0);
    float carry[CG] = {};
    int carry_key = -1;
    for (int base = b; base < e; base += 32) {
      const int j = base + lane;
      const bool in = j < e;
      const int key = in ? seg[j] : -1;
      const int next = j + 1 < e ? seg[j + 1] : -1;
      const int r = in ? static_cast<int>(perm[j]) : r_real;
      float val[CG];
      if (r < r_real) {
        load_row<T, CG, VW>(src + static_cast<size_t>(r % p_src) * c + c0, nc,
                            w ? w[r] : 1.f, val);
      } else {
#pragma unroll
        for (int q = 0; q < CG; ++q) val[q] = 0.f;
      }
      if (lane == 0 && key == carry_key) {
#pragma unroll
        for (int q = 0; q < CG; ++q) val[q] = carry[q] + val[q];
      }
      // segmented inclusive scan: the seg ids are sorted, so an equal key
      // d lanes down means the whole stretch between is one run
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int k2 = __shfl_up_sync(kFull, key, d);
        const bool take = lane >= d && k2 == key;
#pragma unroll
        for (int q = 0; q < CG; ++q) {
          if (q < nc) {  // warp-uniform
            const float y = __shfl_up_sync(kFull, val[q], d);
            if (take) val[q] += y;
          }
        }
      }
      const bool tail = in && next != key;
      if (tail) {
        const bool open = (key == u_first && first_open) || (key == u_last && last_open);
        float* dst = open ? part + (static_cast<size_t>(chunk) * 2 + (key == u_first ? 0 : 1)) * c + c0
                          : out + static_cast<size_t>(key) * c + c0;
        store_row<CG, OW>(dst, nc, val);
        if (c0 == 0 && next > key + 1) zero_rows(out, key + 1, next, c);
      }
      carry_key = __shfl_sync(kFull, in && !tail ? key : -1, 31);
#pragma unroll
      for (int q = 0; q < CG; ++q) carry[q] = __shfl_sync(kFull, val[q], 31);
    }
  }
}

// one thread per (chunk, channel): where the chunk's last segment begins
// in it and runs on past it, add that segment's partials in chunk order
__global__ void segment_sum_merge_kernel(const int* __restrict__ seg,
                                         const int* __restrict__ starts,
                                         const float* __restrict__ part,
                                         float* __restrict__ out, int v, int c,
                                         int n_chunks) {
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<size_t>(n_chunks) * c) return;
  const int chunk = static_cast<int>(t / c), ch = static_cast<int>(t % c);
  const int m = starts[v];
  const int b = chunk * kChunk;
  if (b >= m) return;
  const int e = min(b + kChunk, m);
  const int u = seg[e - 1];
  if (e >= m || seg[e] != u) return;  // ends in this chunk
  const int u_first = seg[b];
  if (u == u_first && b > 0 && seg[b - 1] == u) return;  // began earlier
  const int last = (starts[u + 1] - 1) / kChunk;
  float s = part[(static_cast<size_t>(chunk) * 2 + (u == u_first ? 0 : 1)) * c + ch];
  for (int k = chunk + 1; k <= last; ++k)
    s += part[static_cast<size_t>(k) * 2 * c + ch];
  out[static_cast<size_t>(u) * c + ch] = s;
}

template <typename T, int CG, int VW, int OW>
int launch(const void* src, const void* w, const void* perm, const void* seg,
           const void* starts, void* out, void* part, int v, int c,
           int r_real, int p_src, int n, cudaStream_t s) {
  const int n_chunks = (n + kChunk - 1) / kChunk;
  segment_sum_chunk_kernel<T, CG, VW, OW>
      <<<(n_chunks + kWarps - 1) / kWarps, kThreads, 0, s>>>(
          static_cast<const T*>(src), static_cast<const float*>(w),
          static_cast<const long long*>(perm), static_cast<const int*>(seg),
          static_cast<const int*>(starts), static_cast<float*>(out),
          static_cast<float*>(part), v, c, r_real, p_src, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t threads = static_cast<size_t>(n_chunks) * c;
  segment_sum_merge_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, s>>>(
      static_cast<const int*>(seg), static_cast<const int*>(starts),
      static_cast<const float*>(part), static_cast<float*>(out), v, c,
      n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// the widest row reads (VW) and out writes (OW) that every row, channel
// group and base address allow
template <typename T, int CG>
int launch_vw(const void* src, const void* w, const void* perm,
              const void* seg, const void* starts, void* out, void* part,
              int v, int c, int r_real, int p_src, int n, cudaStream_t s) {
  constexpr int kE = static_cast<int>(sizeof(T));
  const int g = std::gcd(std::gcd(c * kE, CG * kE), 16);
  int vw = g;
  while (vw > kE && reinterpret_cast<uintptr_t>(src) % vw) vw /= 2;
  const bool o16 = c % 4 == 0;
#define TASEG_SEG_LAUNCH(VW)                                                  \
  return o16 ? launch<T, CG, VW, 16>(src, w, perm, seg, starts, out, part, v, \
                                     c, r_real, p_src, n, s)                  \
             : launch<T, CG, VW, 4>(src, w, perm, seg, starts, out, part, v,  \
                                    c, r_real, p_src, n, s)
  if (vw >= 16) TASEG_SEG_LAUNCH(16);
  if (vw >= 8) TASEG_SEG_LAUNCH(8);
  TASEG_SEG_LAUNCH(kE);
#undef TASEG_SEG_LAUNCH
}

template <typename T>
int launch_cg(const void* src, const void* w, const void* perm,
              const void* seg, const void* starts, void* out, void* part,
              int v, int c, int r_real, int p_src, int n, cudaStream_t s) {
  if (c <= 4)
    return launch_vw<T, 4>(src, w, perm, seg, starts, out, part, v, c, r_real, p_src, n, s);
  return launch_vw<T, 32>(src, w, perm, seg, starts, out, part, v, c, r_real, p_src, n, s);
}

}  // namespace

// src (P, C), w (R,) f32 or null, perm (N,) int64, seg (N,) int32,
// starts (V + 1,) int32 -> out (V, C) f32; part (ceil(N / 64), 2, C) f32
// scratch, 16-byte aligned like out.  Needs 0 < P, 0 < R, N < 2^31 and
// every perm entry below 2^31 (the wrapper checks the lengths).
extern "C" int taseg_segment_sum(const void* src, const void* w,
                                 const void* perm, const void* seg,
                                 const void* starts, void* out, void* part,
                                 int v, int c, int r_real, int p_src, int n,
                                 int dtype, void* stream) {
  if (v <= 0 || c <= 0 || r_real <= 0 || p_src <= 0 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == taseg::kF32)
    return launch_cg<float>(src, w, perm, seg, starts, out, part, v, c, r_real, p_src, n, s);
  if (dtype == taseg::kBF16)
    return launch_cg<__nv_bfloat16>(src, w, perm, seg, starts, out, part, v, c, r_real, p_src, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
