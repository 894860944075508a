// K6 segment_sum: sums of the sorted segments of a row table — replaces
// taseg_tpu/ops/voxelize.py:85 _segment_sum_sorted where the port runs
// it: the forward of voxelize_avg (:107), the identity devoxelize
// backward _devox_id_bwd (:253), the trilinear backward _devox_bwd (:284)
// (with weights, over the (8P)-row pair table), and the pixel tables of
// the image branches (point_range, minkunet_mm).
//
//   out[u] = sum_{j in [starts[u], starts[u+1] - 1)} w[r_j] * src[r_j mod P]
//   r_j = perm[j]
//
// src (P, C) f32 or bf16, w (R,) f32 or absent (weight 1), perm (N,)
// int64, starts (V + 1,) int32, out (V, C) f32.  Every table comes from
// voxelize.build_segment_tables, whose stable sort puts segment u's
// sentinel row R + u last in u: its real members are perm[starts[u],
// starts[u+1] - 1), and every segment holds at least its sentinel, so
// starts is strictly increasing.  The kernel reads starts and the real
// members' perm entries only: a sentinel is never read, and an empty
// segment costs two starts entries and the write of a zero row.  The
// JAX package takes boundary differences of a mean-centred cumsum; this
// kernel adds each segment's members directly, in a fixed order (no
// atomics on out): two calls on the same inputs give the same bits.
//
// Bound on the H100: bytes.  starts (4 (V + 1)), the real members' perm
// entries (8 each) and weights (4 each), src read once (P C esz) and out
// written once (4 V C).  On TIAF's pixel table (V = 2 457 600 segments,
// 131 072 members, C = 20) that is ~218 MB, 0.065 ms at 3.35 TB/s, most
// of it the output.
//
// Design (one launch):
//   * work items are the sorted positions [0, starts[V]): each segment
//     is its real members plus one item for its end (its sentinel's
//     position, never read).  The items are cut into units of S
//     consecutive positions, so every unit holds the same number of
//     (members + segment ends), whatever the lengths: a merge-path
//     partition whose cuts are plain arithmetic on the sorted positions.
//     A unit takes many empty or one-member segments, or a share of one
//     long one.
//   * lanes run over channels: a group of G lanes (the power of two that
//     covers a row in 16-, 8-, 4- or 2-byte pieces, at most 32, with NP
//     pieces a lane above that) walks one unit of S = min(8 G, 64) items;
//     a block unit is 256 / G such units.  Blocks are persistent (at
//     most 4 per SM) and take consecutive block units: one warp finds the
//     segment that holds the first unit's first item by a 32-ary search
//     over starts (5 rounds at V = 2.5 M, no host read); each later
//     unit's first segment follows from the unit before, and its starts
//     entries (at most its item count + 1) are copied into shared memory
//     by cp.async while the unit before is walked.
//   * zero rows: the segments that end in a block unit without a member
//     are written by all the block's threads at once, whole rows
//     contiguous (a pixel table's rows are ~95% such rows, most of its
//     bytes).
//   * the block marks the unit's segment ends in a shared bitmap, and
//     every group walks its unit in rounds of U = 8 / NP items, the same
//     number of rounds for every group of a warp (so the warp's groups
//     run in step, not one after another): a round reads its end bits,
//     then the perm entries of its members, then their rows, all in
//     flight together (the group's lanes read one perm entry, a
//     broadcast; each lane its 16-byte piece of a row), and adds them in
//     member order; a segment's end stores its row, contiguous across the
//     group's lanes.  Earlier versions walked segment by segment: with
//     2048-item blocks at every width (256-item walks at 32 lanes) they
//     ran at 3 blocks per SM and lost to the chunk-scan kernel before
//     them on the one-member tables of 48-88 channels; with short units
//     the groups of a warp, each at its own segment, took turns.
//   * a segment cut across units gets a partial from each of its units
//     (part[unit][0] where it began in an earlier unit, part[unit][1] in
//     the unit where it begins).  Each piece, once written, counts on the
//     segment's counter (cnt[its first unit]); the piece that brings the
//     count to the number of pieces adds them in unit order, writes the
//     row, and sets the counter back to 0 for the next call.  The order
//     of every sum depends only on the tables, so the result is
//     deterministic; cnt is zero between calls (the wrapper keeps it per
//     device and stream).
#include <algorithm>
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace {

using taseg::to_f;

constexpr int kThreads = 256;
constexpr int kMaxBlockItems = 2048;  // sorted positions per block unit, at most
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

// dst[0, LC) = val[0, LC) in f32, LC * 4 bytes at once where they fit
template <int LC>
__device__ __forceinline__ void store_piece(float* dst, const float* val) {
  if constexpr (LC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < LC / 4; ++i)
      reinterpret_cast<float4*>(dst)[i] =
          make_float4(val[4 * i], val[4 * i + 1], val[4 * i + 2], val[4 * i + 3]);
  } else if constexpr (LC == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(val[0], val[1]);
  } else {
    *dst = val[0];
  }
}

// val[0, LC) += L2's copy of src[0, LC) (partials of other blocks)
template <int LC>
__device__ __forceinline__ void add_piece_cg(float* val, const float* src) {
  if constexpr (LC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < LC / 4; ++i) {
      const float4 q = __ldcg(reinterpret_cast<const float4*>(src) + i);
      val[4 * i] += q.x;
      val[4 * i + 1] += q.y;
      val[4 * i + 2] += q.z;
      val[4 * i + 3] += q.w;
    }
  } else if constexpr (LC == 2) {
    const float2 q = __ldcg(reinterpret_cast<const float2*>(src));
    val[0] += q.x;
    val[1] += q.y;
  } else {
    val[0] += __ldcg(src);
  }
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// The largest u in [0, v) with starts[u] <= j (starts strictly
// increasing, starts[0] = 0 <= j < starts[v]): a 32-ary search by one
// warp, every lane returns it.
__device__ __forceinline__ int find_segment(const int* __restrict__ starts, int v,
                                            int j) {
  const int lane = threadIdx.x % 32;
  int lo = 0, hi = v;  // starts[lo] <= j < starts[hi]
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const bool le = p < hi && __ldg(starts + p) <= j;
    const int last = 31 - __clz(__ballot_sync(kFull, le));  // lane 0 probes lo
    const int nlo = lo + last * step;
    hi = min(hi, nlo + step);
    lo = nlo;
  }
  return lo;
}

template <int NP, int LC>
__device__ __forceinline__ void store_row(float* __restrict__ dst, const float (&acc)[NP][LC],
                                          int c, int g, int lg) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int ch = (p * g + lg) * LC;
    if (ch < c) store_piece<LC>(dst + ch, acc[p]);
  }
}

// A piece of segment u, cut across units ka = su / s .. kb = e / s, from
// unit k: write it to part[k][slot] (slot 1 in ka, where u begins, 0 in
// the others) and count it; the last piece to arrive adds all of them in
// unit order into out[u] and sets the counter back to 0.
template <int NP, int LC>
__device__ __forceinline__ void cut_piece(const float (&acc)[NP][LC], float* __restrict__ out,
                                          float* __restrict__ part, int* __restrict__ cnt,
                                          int u, int su, int e, int k, int s, int c, int g,
                                          int lg, unsigned gmask) {
  const int ka = su / s, kb = e / s;
  store_row<NP, LC>(part + (static_cast<size_t>(k) * 2 + (k == ka ? 1 : 0)) * c, acc, c, g, lg);
  __threadfence();
  __syncwarp(gmask);
  int old = 0;
  if (lg == 0) old = atomicAdd(cnt + ka, 1);
  old = __shfl_sync(gmask, old, 0, g);
  if (old != kb - ka) return;
  __threadfence();
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int ch = (p * g + lg) * LC;
    if (ch >= c) continue;
    float sum[LC];
#pragma unroll
    for (int q = 0; q < LC; ++q) sum[q] = 0.f;
    for (int kk = ka; kk <= kb; ++kk)
      add_piece_cg<LC>(sum, part + (static_cast<size_t>(kk) * 2 + (kk == ka ? 1 : 0)) * c + ch);
    store_piece<LC>(out + static_cast<size_t>(u) * c + ch, sum);
  }
  if (lg == 0) cnt[ka] = 0;
}

// One block: items [b0, b0 + kThreads s / g), one unit of s items per
// group of g lanes.
// The walk of group `grp` over its unit k of s items, [j0, j1), in the
// block's segment starts `st` (st[i] = starts[ua + i]) and end bits.
template <typename T, int VW, int NP>
__device__ __forceinline__ void walk_unit(const T* __restrict__ src, const float* __restrict__ w,
                                          const long long* __restrict__ perm,
                                          const int* st, const unsigned* ends, int n_st, int ua,
                                          int b0, int k, int j0, int j1, float* __restrict__ out,
                                          float* __restrict__ part, int* __restrict__ cnt,
                                          int c, int r_real, int p_src, int g, int s, int lg,
                                          unsigned gmask) {
  constexpr int LC = VW / static_cast<int>(sizeof(T));  // channels per piece
  constexpr int U = NP >= 4 ? 2 : 8 / NP;                // rows in flight
  int i;  // the segment that holds j0, as an index into st
  {
    int lo = 0, hi = n_st - 1;
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (st[mid] <= j0) lo = mid; else hi = mid;
    }
    i = lo;
  }
  // The unit's items U at a time, the same number of rounds for every
  // group of a warp: a round reads its end bits, then the perm entries of
  // its members, then their rows, all in flight together, and adds them
  // in member order; a segment's end stores its row (a segment without a
  // member stores nothing: the block wrote its zero row).  The segment
  // that began in an earlier unit (the head) and the one that runs on
  // past this unit (the tail) are pieces of cut segments, finished after
  // the rounds.
  const int i_head = i;
  bool in_head = st[i] < j0, had = false;
  float acc[NP][LC], hacc[NP][LC];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int q = 0; q < LC; ++q) acc[p][q] = hacc[p][q] = 0.f;
  using V = typename Vec<VW>::type;
  for (int j = j0; j < j1; j += U) {
    const int q0 = j - b0, wd = q0 / 32, off = q0 % 32;
    unsigned bits = ends[wd] >> off;
    if (off) bits |= ends[wd + 1] << (32 - off);
    const int n = min(U, j1 - j);
    bits &= (1u << n) - 1u;
    int r[U];
#pragma unroll
    for (int t = 0; t < U; ++t) {
      r[t] = -1;
      if (t < n && !((bits >> t) & 1u)) {
        const int rr = static_cast<int>(__ldg(perm + j + t));
        r[t] = rr < r_real ? rr : -1;
      }
    }
    float wt[U];
#pragma unroll
    for (int t = 0; t < U; ++t) wt[t] = (w != nullptr && r[t] >= 0) ? __ldg(w + r[t]) : 1.f;
    V raw[U][NP];
#pragma unroll
    for (int t = 0; t < U; ++t) {
      const int row = r[t] < 0 ? 0 : r[t] < p_src ? r[t] : r[t] % p_src;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int ch = (p * g + lg) * LC;
        raw[t][p] = (r[t] >= 0 && ch < c)
                        ? __ldg(reinterpret_cast<const V*>(src + static_cast<size_t>(row) * c + ch))
                        : V{};
      }
    }
#pragma unroll
    for (int t = 0; t < U; ++t) {
      if (r[t] >= 0) {
        had = true;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          T el[LC];
          memcpy(el, &raw[t][p], VW);
#pragma unroll
          for (int q = 0; q < LC; ++q) acc[p][q] = fmaf(wt[t], to_f(el[q]), acc[p][q]);
        }
      }
      if ((bits >> t) & 1u) {
        if (in_head) {
#pragma unroll
          for (int p = 0; p < NP; ++p)
#pragma unroll
            for (int q = 0; q < LC; ++q) hacc[p][q] = acc[p][q];
        } else if (had) {
          store_row<NP, LC>(out + static_cast<size_t>(ua + i) * c, acc, c, g, lg);
        }
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int q = 0; q < LC; ++q) acc[p][q] = 0.f;
        in_head = had = false;
        ++i;
      }
    }
  }
  const int ql = j1 - 1 - b0;
  const bool open = !((ends[ql / 32] >> (ql % 32)) & 1u);  // the last item ends no segment
  if (st[i_head] < j0) {  // the head: ended here, or runs on past the unit
    if (open && i == i_head) {
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int q = 0; q < LC; ++q) hacc[p][q] = acc[p][q];
    }
    cut_piece<NP, LC>(hacc, out, part, cnt, ua + i_head, st[i_head], st[i_head + 1] - 1, k, s,
                      c, g, lg, gmask);
  }
  if (open && (i != i_head || st[i_head] >= j0))  // the tail
    cut_piece<NP, LC>(acc, out, part, cnt, ua + i, st[i], st[i + 1] - 1, k, s, c, g, lg, gmask);
}

// One block unit of 256 s / g items per block, one unit of s items per
// group of g lanes.
template <typename T, int VW, int NP>
__global__ void __launch_bounds__(kThreads, 4)
    segment_sum_kernel(const T* __restrict__ src, const float* __restrict__ w,
                       const long long* __restrict__ perm,
                       const int* __restrict__ starts, float* __restrict__ out,
                       float* __restrict__ part, int* __restrict__ cnt, int v,
                       int c, int r_real, int p_src, int g, int s) {
  constexpr int LC = VW / static_cast<int>(sizeof(T));
  __shared__ int st[kMaxBlockItems + 2];
  __shared__ unsigned ends[kMaxBlockItems / 32 + 1];  // bit q: item b0 + q ends a segment
  __shared__ int s_ua;
  const int lane = threadIdx.x % 32;
  const int m_total = __ldg(starts + v);  // items: members + segment ends
  const int groups = kThreads / g, items = groups * s;
  const int b0 = blockIdx.x * items;
  if (b0 >= m_total) return;
  const int b1 = min(b0 + items, m_total);
  if (threadIdx.x < 32) {
    const int ua = find_segment(starts, v, b0);
    if (threadIdx.x == 0) s_ua = ua;
  }
  for (int q = threadIdx.x; q <= kMaxBlockItems / 32; q += kThreads) ends[q] = 0u;
  __syncthreads();
  // the block's segments are ua .. ub, ub - ua < items (each one after ua
  // begins at its own position inside the block's range)
  const int ua = s_ua;
  const int n_st = min(items + 2, v + 1 - ua);
  for (int i = threadIdx.x; i < n_st; i += kThreads) cp_async4(st + i, starts + ua + i);
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  // the segments that end in this block: rows ua .. ua + last - 1
  int last;
  {
    int lo = 0, hi = n_st - 1;  // the largest i with st[i] <= b1 - 1
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (st[mid] <= b1 - 1) lo = mid; else hi = mid;
    }
    last = st[lo + 1] - 1 < b1 ? lo + 1 : lo;
  }
  bool any = false;
  for (int i = threadIdx.x; i < (last + 31) / 32 * 32; i += kThreads) {
    const bool on = i < last;
    const int q = on ? st[i + 1] - 1 - b0 : 0;
    any |= on && st[i + 1] - st[i] == 1;
    // one atomic per word that the warp's ends fall in
    const unsigned peers = __match_any_sync(kFull, on ? q / 32 : -1);
    const unsigned bits = __reduce_or_sync(peers, on ? 1u << (q % 32) : 0u);
    if (on && lane == __ffs(peers) - 1) atomicOr(ends + q / 32, bits);
  }
  // zero rows (segments without a member): all the block's threads,
  // whole rows contiguous
  if (__syncthreads_or(any)) {
    const int pieces = c / LC;
    float zero[LC];
#pragma unroll
    for (int t = 0; t < LC; ++t) zero[t] = 0.f;
    for (int q = threadIdx.x; q < last * pieces; q += kThreads) {
      const int i = q / pieces;
      if (st[i + 1] - st[i] == 1)
        store_piece<LC>(out + static_cast<size_t>(ua + i) * c + (q - i * pieces) * LC, zero);
    }
  }
  const int grp = threadIdx.x / g, lg = threadIdx.x % g;
  const unsigned gmask =
      g == 32 ? kFull : ((1u << g) - 1u) << ((threadIdx.x % 32) / g * g);
  const int k = blockIdx.x * groups + grp, j0 = k * s;
  if (j0 < m_total)
    walk_unit<T, VW, NP>(src, w, perm, st, ends, n_st, ua, b0, k, j0, min(j0 + s, m_total), out,
                         part, cnt, c, r_real, p_src, g, s, lg, gmask);
}

// Tables with at most one member per four segments (the image branches'
// pixel tables: ~95% of the rows empty) are cut by rows instead: every
// warp takes 32 consecutive rows at a time (their starts in one
// coalesced load, the next 32 rows' issued before these are summed), its
// groups take turns over them, each summing its row's members U at a
// time, and the rows are stored in order, contiguous across the warp.
// No search, no shared memory: the zero rows stream out.  A row with many
// members keeps its warp the longer, which these tables bound.
template <typename T, int VW, int NP>
__global__ void __launch_bounds__(kThreads, 4)
    segment_sum_rows_kernel(const T* __restrict__ src, const float* __restrict__ w,
                            const long long* __restrict__ perm,
                            const int* __restrict__ starts, float* __restrict__ out, int v,
                            int c, int r_real, int p_src, int g) {
  constexpr int LC = VW / static_cast<int>(sizeof(T));
  constexpr int U = NP >= 4 ? 2 : 8 / NP;
  using V = typename Vec<VW>::type;
  const int lane = threadIdx.x % 32, grp = lane / g, lg = lane % g, gw = 32 / g;
  const int warps = gridDim.x * (kThreads / 32);
  int chunk = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int n_chunks = (v + 31) / 32;
  int s0 = 0, s1 = 0;  // this lane's row of the chunk: starts[row], starts[row + 1]
  if (chunk < n_chunks) {
    const int row = min(chunk * 32 + lane, v - 1);
    s0 = __ldg(starts + row);
    s1 = __ldg(starts + row + 1);
  }
  for (; chunk < n_chunks; chunk += warps) {
    const int a0 = s0, a1 = s1;
    const int nxt = chunk + warps;
    if (nxt < n_chunks) {  // the next chunk's starts, in flight while these are summed
      const int row = min(nxt * 32 + lane, v - 1);
      s0 = __ldg(starts + row);
      s1 = __ldg(starts + row + 1);
    }
    for (int t = 0; t < 32 / gw; ++t) {
      const int rr = t * gw + grp;  // row of the chunk this group sums now
      const int row = chunk * 32 + rr;
      const int m0 = __shfl_sync(kFull, a0, rr), m1 = __shfl_sync(kFull, a1, rr) - 1;
      float acc[NP][LC];
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int q = 0; q < LC; ++q) acc[p][q] = 0.f;
      for (int m = m0; m < m1; m += U) {
        int r[U];
        float wt[U];
        V raw[U][NP];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          r[u] = -1;
          if (m + u < m1) {
            const int x = static_cast<int>(__ldg(perm + m + u));
            r[u] = x < r_real ? x : -1;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) wt[u] = (w != nullptr && r[u] >= 0) ? __ldg(w + r[u]) : 1.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int sr = r[u] < 0 ? 0 : r[u] < p_src ? r[u] : r[u] % p_src;
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const int ch = (p * g + lg) * LC;
            raw[u][p] = (r[u] >= 0 && ch < c)
                            ? __ldg(reinterpret_cast<const V*>(src + static_cast<size_t>(sr) * c + ch))
                            : V{};
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (r[u] < 0) continue;
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            T el[LC];
            memcpy(el, &raw[u][p], VW);
#pragma unroll
            for (int q = 0; q < LC; ++q) acc[p][q] = fmaf(wt[u], to_f(el[q]), acc[p][q]);
          }
        }
      }
      if (row < v) store_row<NP, LC>(out + static_cast<size_t>(row) * c, acc, c, g, lg);
    }
  }
}

template <typename T, int VW>
int launch_np(int np, const void* src, const void* w, const void* perm,
              const void* starts, void* out, void* part, void* cnt, int v, int c,
              int r_real, int p_src, int n, int g, int unit, int rows, cudaStream_t s) {
  const int items = kThreads / g * unit;
  if (items > kMaxBlockItems) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks =
      rows ? std::min((v + kThreads - 1) / kThreads, 8 * 132) : (n + items - 1) / items;
#define TASEG_SEG_LAUNCH(NP)                                                        \
  if (rows)                                                                         \
    segment_sum_rows_kernel<T, VW, NP><<<blocks, kThreads, 0, s>>>(                 \
        static_cast<const T*>(src), static_cast<const float*>(w),                   \
        static_cast<const long long*>(perm), static_cast<const int*>(starts),       \
        static_cast<float*>(out), v, c, r_real, p_src, g);                          \
  else                                                                              \
    segment_sum_kernel<T, VW, NP><<<blocks, kThreads, 0, s>>>(                      \
        static_cast<const T*>(src), static_cast<const float*>(w),                   \
        static_cast<const long long*>(perm), static_cast<const int*>(starts),       \
        static_cast<float*>(out), static_cast<float*>(part), static_cast<int*>(cnt), \
        v, c, r_real, p_src, g, unit)
  switch (np) {
    case 1: TASEG_SEG_LAUNCH(1); break;
    case 2: TASEG_SEG_LAUNCH(2); break;
    case 4: TASEG_SEG_LAUNCH(4); break;
    case 8: TASEG_SEG_LAUNCH(8); break;
    case 16:  // pieces of 4 bytes (SPVCNN cr 1.6's 409 f32 channels); of 2
              // bytes only in a comparison (the wrapper pads such rows to
              // 16-byte pieces, which ran faster)
      if constexpr (VW <= 4) {
        TASEG_SEG_LAUNCH(16);
        break;
      }
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TASEG_SEG_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vw(int vw, int np, const void* src, const void* w, const void* perm,
              const void* starts, void* out, void* part, void* cnt, int v, int c,
              int r_real, int p_src, int n, int g, int unit, int rows, cudaStream_t s) {
  constexpr int kE = static_cast<int>(sizeof(T));
  if (vw < kE || (c * kE) % vw || reinterpret_cast<uintptr_t>(src) % vw)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vw == 16) return launch_np<T, 16>(np, src, w, perm, starts, out, part, cnt, v, c, r_real, p_src, n, g, unit, rows, s);
  if (vw == 8) return launch_np<T, 8>(np, src, w, perm, starts, out, part, cnt, v, c, r_real, p_src, n, g, unit, rows, s);
  if (vw == 4) return launch_np<T, 4>(np, src, w, perm, starts, out, part, cnt, v, c, r_real, p_src, n, g, unit, rows, s);
  if constexpr (kE == 2) {
    if (vw == 2) return launch_np<T, 2>(np, src, w, perm, starts, out, part, cnt, v, c, r_real, p_src, n, g, unit, rows, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// src (P, C), w (R,) f32 or null, perm (N,) int64, starts (V + 1,) int32
// (build_segment_tables: sentinel last in each segment) -> out (V, C)
// f32.  vw: bytes of src per lane piece (16, 8, 4 or 2; divides C esz
// and src's address), g: lanes per group (a power of two, 1..32), np:
// pieces per lane (1, 2, 4, 8; 16 where vw <= 4), with g np vw / esz >= C; unit: items
// per group (256 unit / g <= 2048); rows: cut by rows (the sparse tables'
// kernel, which reads neither part nor cnt); part (ceil(N / unit), 2, C)
// f32 scratch, cnt (ceil(N / unit),) int32 zero on entry and on exit.  Needs
// 0 < V, 0 < P, 0 < R, N < 2^31, every perm entry below 2^31 (the
// wrapper checks).
extern "C" int taseg_segment_sum(const void* src, const void* w, const void* perm,
                                 const void* starts, void* out, void* part, void* cnt,
                                 int v, int c, int r_real, int p_src, int n,
                                 int dtype, int vw, int g, int np, int unit, int rows,
                                 void* stream) {
  if (v <= 0 || c <= 0 || r_real <= 0 || p_src <= 0 || n <= 0 || g <= 0 || g > 32 ||
      (g & (g - 1)) || np <= 0 || unit <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == taseg::kF32) {
    if (static_cast<long long>(g) * np * (vw / 4) < c) return static_cast<int>(cudaErrorInvalidValue);
    return launch_vw<float>(vw, np, src, w, perm, starts, out, part, cnt, v, c, r_real, p_src, n, g, unit, rows, s);
  }
  if (dtype == taseg::kBF16) {
    if (static_cast<long long>(g) * np * (vw / 2) < c) return static_cast<int>(cudaErrorInvalidValue);
    return launch_vw<__nv_bfloat16>(vw, np, src, w, perm, starts, out, part, cnt, v, c, r_real, p_src, n, g, unit, rows, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
