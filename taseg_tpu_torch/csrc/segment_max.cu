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
// f32 columns into as many segments, almost every one of one row (the
// rows are not sorted by segment), and the padding rows, all -inf, in one
// dummy segment at the end.  The pool: a few segments (the batch) of up
// to ~10^5 sorted rows each, at 128-256 columns.
//
// Bound: the bytes.  Forward x read once and out written once (the seg
// column beside them); backward x, seg, out, g read and dx written.  At
// Cylinder's 131 072 x 16 f32 that is ~17 MB forward (5 us at 3.35 TB/s),
// ~34 MB backward.  What held the first design (a thread a column of a
// run of rows, scalar loads, one float atomic per segment change, a -inf
// fill and a cast in torch, a cooperative backward with a grid barrier)
// well under half of that: scalar dependent loads, one atomic per row and
// column even where consecutive rows share a segment (the pool's 3 x 128
// addresses took rows / run atomics each), two passes of torch around the
// launch, and a backward that re-read everything per column thread after
// a barrier over a grid capped at one wave.
//
// This design (`voxelize.segment_max_plan` picks the shape):
//   * a thread takes 16 bytes of a row (4 f32 or 8 bf16 columns: `vec`),
//     `tpr` threads a row (a power of two, at most a warp; wider rows
//     take more blocks along y), so a warp holds 32 / tpr consecutive
//     rows a pass and a row's seg id is one broadcast load;
//   * each warp owns `chunk` consecutive rows, walked in passes (the
//     forward loads four passes' rows before it walks them).  A pass
//     whose rows all continue the run open before it (a long segment)
//     only folds them in (one vote, log2(32 / tpr) shuffles).  Else
//     consecutive equal ids are merged in the warp (a segmented max over
//     the pass's rows by shuffles, its runs bounded by the ballot of run
//     starts), and the run open at a pass's end is carried into the next,
//     so a global atomic goes out only where a run ends;
//   * a warp holds back the first run of its chunk to end (its head) and
//     the run open at its end (its tail); the block's warps are merged in
//     shared memory in row order, so a segment that spans the block takes
//     one atomic per column a block, not one a warp or a run: the pool's
//     few segments and Cylinder's dummy segment (at Cylinder's real call
//     ~98 000 of its 131 072 rows) see ~blocks atomics per address,
//     Cylinder's one-row segments one per row and column.  Atomics on one
//     address serialize (a quarter of the pool's forward on an H100:
//     tools/k9k10_ablate.py's `no_flush`), so where segments are long the
//     plan makes the chunks longer and the blocks fewer;
//   * f32 atomics are the sign split of a float max on 32-bit words (a
//     value with the sign bit clear takes atomicMax on the word as a
//     signed int, one with it set atomicMin as an unsigned int; the IEEE
//     patterns order like the values under those two), issued without
//     return (reductions); bf16 rows take a compare-and-swap on the
//     32-bit word of two columns, so the output is written in bf16
//     directly (no f32 buffer, no cast);
//   * the -inf fill of out is one kernel of 16-byte stores before the
//     runs kernel: two launches a forward call;
//   * the backward is three ordinary full-grid launches and no barrier:
//     the same fill zeroing the f32 tie counts n (S, C), the runs kernel
//     again with a count for the max (x == out[seg] as
//     floats: +0.0 and -0.0 tie, NaN ties nothing), its counts merged the
//     same way and added with 16-byte float reductions (integers in f32,
//     exact, so any order gives the same bits), writing each (row,
//     16-byte group)'s tie bits into a byte mask; then the shares, one
//     thread a (row, group): where the mask byte is 0 it stores zeros and
//     gathers nothing, else it gathers g and n of the row's segment once
//     and writes dx = g * (1 / n), the multiply and the division rounded
//     apart, as the plain version (and JAX) compute it.  (The forward's
//     fill could zero n for a train step's backward and save it a launch:
//     within the noise of a Cylinder step's pair on an H100, so the
//     backward zeroes its own.)
//
// Semantics, to the bit against `segment_max_plain` / `_bwd_plain`: -0.0
// is made +0.0 (x + 0.0f) and any NaN the positive quiet NaN before the
// max, so a max of zeros is +0.0 whatever the signs of its members, and a
// NaN member makes its segment NaN; a segment with no row keeps the -inf
// of the fill; ids outside [0, S) are dropped; the max and the integer
// counts do not depend on the order of the atomics, so a repeat gives the
// same bits.
//
// The first design stays below (`taseg_segment_max_v1`,
// `taseg_segment_max_bwd_v1`) as the yardstick of chip_smoke.py and
// tools/k9k10_ablate.py, on no path.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using taseg::to_f;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// passes whose rows a warp loads before it walks them: four in the
// forward, one in the backward's count, whose top gather follows each
// row's id (tools/k9k10_ablate.py's `ahead_max1`, `ahead_count4`)
constexpr int kAheadMax = 4;
constexpr int kAheadCount = 1;

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

// The max over canonical values, NaN above every number.
__device__ __forceinline__ float max_nan(float a, float b) { return (b > a || b != b) ? b : a; }

__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
// the bf16 of a float that is one (a max of bf16 values): its top half
__device__ __forceinline__ unsigned bf16_bits(float v) { return __float_as_uint(v) >> 16; }

// out's words only grow (under max_nan), so a stale first read at most
// costs one more round
__device__ __forceinline__ void atomic_max_bf16x2(unsigned* w, float lo, float hi) {
  unsigned old = *w;
  for (;;) {
    const unsigned nw = bf16_bits(max_nan(bf16_lo(old), lo)) | (bf16_bits(max_nan(bf16_hi(old), hi)) << 16);
    if (nw == old) return;
    const unsigned prev = atomicCAS(w, old, nw);
    if (prev == old) return;
    old = prev;
  }
}

__device__ __forceinline__ void atomic_max_bf16(__nv_bfloat16* p, float v) {
  unsigned* w = reinterpret_cast<unsigned*>(reinterpret_cast<uintptr_t>(p) & ~uintptr_t(3));
  const bool hi = reinterpret_cast<uintptr_t>(p) & 2;
  unsigned old = *w;
  for (;;) {
    const float cur = hi ? bf16_hi(old) : bf16_lo(old);
    const unsigned b = bf16_bits(max_nan(cur, v));
    const unsigned nw = hi ? ((old & 0xffffu) | (b << 16)) : ((old & 0xffff0000u) | b);
    if (nw == old) return;
    const unsigned prev = atomicCAS(w, old, nw);
    if (prev == old) return;
    old = prev;
  }
}

// VEC values of T at p (16-byte aligned where VEC > 1) as floats
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f(p[0]);
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int h = 0; h < VEC / 4; ++h) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + h);
      v[4 * h] = q.x;
      v[4 * h + 1] = q.y;
      v[4 * h + 2] = q.z;
      v[4 * h + 3] = q.w;
    }
  } else {
    static_assert(VEC == 8, "bf16 rows go in 16-byte pieces of 8 columns");
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = bf16_lo(w[k]);
      v[2 * k + 1] = bf16_hi(w[k]);
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&d)[VEC]) {
  if constexpr (VEC == 1) {
    taseg::store_f(d[0], p);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  } else {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(d[2 * k]))) |
             (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(d[2 * k + 1]))) << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The forward's reduction: the max.  Its output is out (S, C) of T.
struct MaxOp {
  static constexpr bool kCount = false;
  __device__ static float identity() { return __int_as_float(0xff800000); }
  __device__ static float combine(float a, float b) { return max_nan(a, b); }
};

// The backward's first pass: the ties counted.  Its output is n (S, C)
// f32, zeroed before.
struct CountOp {
  static constexpr bool kCount = true;
  __device__ static float identity() { return 0.f; }
  __device__ static float combine(float a, float b) { return a + b; }
};

struct RunsArgs {
  const void* x;          // (p, c) of T
  const int* seg;         // (p,)
  const void* top;        // count: the forward's out (s, c) of T
  void* dst;              // max: out (s, c) of T; count: n (s, c) f32
  unsigned char* mask;    // count: (p, c / vec) tie bits
  int p, c, s;
  int tpr, lg_tpr;        // threads a row (a power of two <= 32) and its log
  int chunk;              // rows a warp, a multiple of 32 / tpr
};

// One run's VEC columns into dst, by the lane that holds them.
template <typename T, int VEC, class Op>
__device__ __forceinline__ void emit_lane(const RunsArgs& a, int id, const float (&v)[VEC], int col0) {
  if (id < 0) return;
  const long long at = static_cast<long long>(id) * a.c + col0;
  if constexpr (Op::kCount) {
    float* n = static_cast<float*>(a.dst) + at;
    if constexpr (VEC == 1) {
      if (v[0] != 0.f) atomicAdd(n, v[0]);
    } else {
#pragma unroll
      for (int h = 0; h < VEC / 4; ++h) {
        if (v[4 * h] != 0.f || v[4 * h + 1] != 0.f || v[4 * h + 2] != 0.f || v[4 * h + 3] != 0.f) {
          atomicAdd(reinterpret_cast<float4*>(n) + h,
                    make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]));
        }
      }
    }
  } else if constexpr (sizeof(T) == 4) {
    float* o = static_cast<float*>(a.dst) + at;
#pragma unroll
    for (int j = 0; j < VEC; ++j) atomic_max_f32(o + j, v[j]);
  } else {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.dst) + at;
    if constexpr (VEC == 1) {
      atomic_max_bf16(o, v[0]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC / 2; ++k) {
        atomic_max_bf16x2(reinterpret_cast<unsigned*>(o) + k, v[2 * k], v[2 * k + 1]);
      }
    }
  }
}

// The runs kernel (see the header): the forward's max (MaxOp) or the
// backward's tie counts (CountOp).  Grid (ceil(p / (kWarps chunk)),
// ceil(c / vec / tpr)); dynamic shared memory kWarps * 2 * tpr * VEC
// floats (each warp's head and tail values).
template <typename T, int VEC, class Op>
__global__ void __launch_bounds__(kThreads) k10_runs_kernel(const RunsArgs a) {
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tpr = a.tpr, lg = a.lg_tpr;
  const int rpw = 32 >> lg;
  const int slot = lane >> lg, cl = lane & (tpr - 1);
  const int groups = a.c / VEC;
  const int grp = blockIdx.y * tpr + cl;
  const bool col_ok = grp < groups;
  const int col0 = grp * VEC;
  const long long row0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) * a.chunk;

  extern __shared__ float sm[];
  __shared__ int head_id[kWarps], tail_id[kWarps], single[kWarps];
  float* head_v = sm + warp * 2 * tpr * VEC + cl * VEC;  // [j]: column col0 + j
  float* tail_v = head_v + tpr * VEC;

  auto load_row = [&](long long r, int& id, float (&raw)[VEC]) {
    id = -1;
#pragma unroll
    for (int j = 0; j < VEC; ++j) raw[j] = 0.f;
    if (r < a.p) {
      const int sid = __ldg(a.seg + r);
      id = (sid >= 0 && sid < a.s) ? sid : -1;
      if (col_ok) load_vec<T, VEC>(x + r * a.c + col0, raw);
    }
  };

  float cv[VEC];  // the carry: the run open at the last pass's end
  int cid = -1;
  bool pending = true;  // no run of the chunk has ended yet: the first to end is the head
  const int passes = a.chunk >> (5 - lg);
  constexpr int kAhead = Op::kCount ? kAheadCount : kAheadMax;
  for (int k0 = 0; k0 < passes; k0 += kAhead) {
    // kAhead passes' rows in flight at once, then walked in order
    int ids[kAhead];
    float raws[kAhead][VEC];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      load_row(k0 + u < passes ? row0 + static_cast<long long>(k0 + u) * rpw + slot : a.p, ids[u], raws[u]);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int k = k0 + u;
      if (k >= passes) break;
      const long long r = row0 + static_cast<long long>(k) * rpw + slot;
      const int id = ids[u];
      float v[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = raws[u][j];
      if constexpr (Op::kCount) {
        unsigned bits = 0;
        if (id >= 0 && col_ok) {
          float t[VEC];
          load_vec<T, VEC>(static_cast<const T*>(a.top) + static_cast<long long>(id) * a.c + col0, t);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const bool hit = v[j] == t[j];
            bits |= static_cast<unsigned>(hit) << j;
            v[j] = hit ? 1.f : 0.f;
          }
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) v[j] = 0.f;
        }
        if (r < a.p && col_ok) a.mask[r * groups + grp] = static_cast<unsigned char>(bits);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[j] = (id >= 0 && col_ok) ? canonical(v[j]) : Op::identity();
      }
      // a pass whose every row continues the carry (a long segment's, as
      // the pool's) folds into it: no scan, no flush
      if (k > 0 && __all_sync(kFull, id == cid)) {
        for (int d = tpr; d < 32; d <<= 1) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) v[j] = Op::combine(v[j], __shfl_xor_sync(kFull, v[j], d));
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) cv[j] = Op::combine(cv[j], v[j]);
        continue;
      }

      // the pass's runs of equal ids, merged by a segmented scan
      const int prev = __shfl_up_sync(kFull, id, tpr);
      const unsigned starts = __ballot_sync(kFull, slot == 0 || prev != id);
      const int run_slot = (31 - __clz(starts & (kFull >> (31 - lane)))) >> lg;
      for (int d = 1; d < rpw; d <<= 1) {
        float o[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) o[j] = __shfl_up_sync(kFull, v[j], d << lg);
        if (slot - d >= run_slot) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) v[j] = Op::combine(v[j], o[j]);
        }
      }
      const int nxt = __shfl_down_sync(kFull, id, tpr);
      const bool ends = slot != rpw - 1 && nxt != id;  // a run that ends inside the pass
      const int id0 = __shfl_sync(kFull, id, cl);
      const bool cont = k > 0 && id0 == cid;  // the carry goes on in this pass's first run
      if (cont && run_slot == 0) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[j] = Op::combine(v[j], cv[j]);
      }
      const bool carry_ends = k > 0 && !cont;
      const unsigned end_lanes = __ballot_sync(kFull, ends);
      bool carry_head = false;
      int head_slot = -1;
      if (pending) {
        if (carry_ends) {
          carry_head = true;
          pending = false;
        } else if (end_lanes) {
          head_slot = (__ffs(end_lanes) - 1) >> lg;
          pending = false;
        }
      }
      if (carry_ends && slot == 0) {
        if (carry_head) {
          if (cl == 0) head_id[warp] = cid;
#pragma unroll
          for (int j = 0; j < VEC; ++j) head_v[j] = cv[j];
        } else if (col_ok) {
          emit_lane<T, VEC, Op>(a, cid, cv, col0);
        }
      }
      if (ends && slot == head_slot) {
        if (cl == 0) head_id[warp] = id;
#pragma unroll
        for (int j = 0; j < VEC; ++j) head_v[j] = v[j];
      }
      if (ends && slot != head_slot && col_ok) emit_lane<T, VEC, Op>(a, id, v, col0);
      const int src = ((rpw - 1) << lg) + cl;
      cid = __shfl_sync(kFull, id, src);
#pragma unroll
      for (int j = 0; j < VEC; ++j) cv[j] = __shfl_sync(kFull, v[j], src);
    }
  }
  if (slot == 0) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) tail_v[j] = cv[j];
    if (cl == 0) {
      tail_id[warp] = cid;
      single[warp] = pending;
    }
  }
  __syncthreads();
  // the block's warps in row order: a warp's head continues the run open
  // before it where the ids match; a warp of one run continues it whole
  if (warp == 0 && slot == 0 && col_ok) {
    int cur = -1;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = Op::identity();
    for (int w = 0; w < kWarps; ++w) {
      const float* hv = sm + w * 2 * tpr * VEC + cl * VEC;
      const float* tv = hv + tpr * VEC;
      float h[VEC], t[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        h[j] = hv[j];
        t[j] = tv[j];
      }
      if (single[w]) {
        if (tail_id[w] == cur) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] = Op::combine(acc[j], t[j]);
        } else {
          emit_lane<T, VEC, Op>(a, cur, acc, col0);
          cur = tail_id[w];
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] = t[j];
        }
        continue;
      }
      if (head_id[w] == cur) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = Op::combine(acc[j], h[j]);
        emit_lane<T, VEC, Op>(a, cur, acc, col0);
      } else {
        emit_lane<T, VEC, Op>(a, cur, acc, col0);
        emit_lane<T, VEC, Op>(a, head_id[w], h, col0);
      }
      cur = tail_id[w];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = t[j];
    }
    emit_lane<T, VEC, Op>(a, cur, acc, col0);
  }
}

// `pat` (the 32-bit word of one f32 or two bf16 -inf, or 0) over a's
// bytes in 16-byte stores; the bytes past the last whole 16 in 2-byte
// stores by the first block.
__global__ void k10_fill_kernel(unsigned char* __restrict__ a, long long a_bytes, unsigned pat) {
  const long long a16 = a_bytes >> 4;
  const uint4 pa = make_uint4(pat, pat, pat, pat);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; t < a16; t += step) {
    reinterpret_cast<uint4*>(a)[t] = pa;
  }
  if (blockIdx.x == 0) {
    for (long long i = (a16 << 4) + 2 * threadIdx.x; i < a_bytes; i += 2 * blockDim.x) {
      *reinterpret_cast<unsigned short*>(a + i) = static_cast<unsigned short>((i & 2) ? pat >> 16 : pat);
    }
  }
}

// The backward's shares: one thread a (row, VEC-column group).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) k10_share_kernel(const int* __restrict__ seg,
                                                             const unsigned char* __restrict__ mask,
                                                             const T* __restrict__ g,
                                                             const float* __restrict__ n,
                                                             T* __restrict__ dx, int p, int c) {
  const int groups = c / VEC;
  const long long items = static_cast<long long>(p) * groups;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; t < items; t += step) {
    const unsigned bits = mask[t];
    const long long r = t / groups;
    const long long col = (t - r * groups) * VEC;
    float d[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) d[j] = 0.f;
    if (bits) {
      const long long o = static_cast<long long>(__ldg(seg + r)) * c + col;
      float gv[VEC], nv[VEC];
      load_vec<T, VEC>(g + o, gv);
      load_vec<float, VEC>(n + o, nv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if ((bits >> j) & 1u) d[j] = __fmul_rn(gv[j], __fdiv_rn(1.0f, nv[j]));
      }
    }
    store_vec<T, VEC>(dx + r * c + col, d);
  }
}

int fill_blocks(long long bytes) {
  const long long want = ((bytes >> 4) + kThreads - 1) / kThreads;
  return static_cast<int>(want < 1 ? 1 : want < 132 * 8 ? want : 132 * 8);
}

int launch_fill(void* a, long long a_bytes, unsigned pat, cudaStream_t st) {
  k10_fill_kernel<<<fill_blocks(a_bytes), kThreads, 0, st>>>(static_cast<unsigned char*>(a), a_bytes, pat);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, class Op>
int launch_runs(const RunsArgs& a, int blocks, int col_blocks, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(kWarps) * 2 * a.tpr * VEC * sizeof(float);
  k10_runs_kernel<T, VEC, Op><<<dim3(blocks, col_blocks), kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class Op>
int launch_runs_any(const RunsArgs& a, int dtype, int vec, int blocks, int col_blocks, cudaStream_t st) {
  if (dtype == taseg::kF32 && vec == 4) return launch_runs<float, 4, Op>(a, blocks, col_blocks, st);
  if (dtype == taseg::kF32 && vec == 1) return launch_runs<float, 1, Op>(a, blocks, col_blocks, st);
  if (dtype == taseg::kBF16 && vec == 8) return launch_runs<__nv_bfloat16, 8, Op>(a, blocks, col_blocks, st);
  if (dtype == taseg::kBF16 && vec == 1) return launch_runs<__nv_bfloat16, 1, Op>(a, blocks, col_blocks, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int VEC>
int launch_share(const void* seg, const void* mask, const void* g, const void* n, void* dx, int p, int c,
                 cudaStream_t st) {
  const long long items = static_cast<long long>(p) * (c / VEC);
  const long long want = (items + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  k10_share_kernel<T, VEC><<<blocks, kThreads, 0, st>>>(
      static_cast<const int*>(seg), static_cast<const unsigned char*>(mask), static_cast<const T*>(g),
      static_cast<const float*>(n), static_cast<T*>(dx), p, c);
  return static_cast<int>(cudaGetLastError());
}

// The plan's shape, checked: vec 4 (f32) or 8 (bf16) with c in whole
// groups, or 1; tpr a power of two up to 32; col_blocks covering the
// groups; chunk whole passes; blocks covering the rows.
bool plan_ok(int p, int c, int dtype, int vec, int tpr, int col_blocks, int chunk, int blocks) {
  const bool vec_ok = vec == 1 || (dtype == taseg::kF32 && vec == 4) || (dtype == taseg::kBF16 && vec == 8);
  if (!vec_ok || c % vec != 0 || tpr < 1 || tpr > 32 || (tpr & (tpr - 1)) != 0) return false;
  if (static_cast<long long>(col_blocks) * tpr < c / vec || chunk < 1 || chunk % (32 / tpr) != 0) return false;
  return static_cast<long long>(blocks) * kWarps * chunk >= p;
}

int lg2(int v) { return 31 - __builtin_clz(static_cast<unsigned>(v)); }

}  // namespace

// Forward: x (p, c) f32 or bf16 (dtype code), seg (p,) int32 -> out (s,
// c) of x's dtype, filled here.  Two launches: the fill and the runs
// kernel, shaped by `voxelize.segment_max_plan`.
extern "C" int taseg_segment_max(const void* x, const void* seg, void* out, int p, int c, int s, int vec,
                                 int tpr, int col_blocks, int chunk, int blocks, int dtype, void* stream) {
  if (c == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long esz = dtype == taseg::kBF16 ? 2 : 4;
  const unsigned pat = dtype == taseg::kBF16 ? 0xff80ff80u : 0xff800000u;
  int err = launch_fill(out, static_cast<long long>(s) * c * esz, pat, st);
  if (err != 0 || p == 0) return err;
  if (!plan_ok(p, c, dtype, vec, tpr, col_blocks, chunk, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  const RunsArgs a{x, static_cast<const int*>(seg), nullptr, out, nullptr, p, c, s, tpr, lg2(tpr), chunk};
  return launch_runs_any<MaxOp>(a, dtype, vec, blocks, col_blocks, st);
}

// Backward: x (p, c), out and g (s, c), dx (p, c), all of one dtype; n
// (s, c) f32 and mask (p, c / vec) bytes, scratch.  Three launches: n
// zeroed, the ties counted, the shares.
extern "C" int taseg_segment_max_bwd(const void* x, const void* seg, const void* out, const void* g, void* n,
                                     void* mask, void* dx, int p, int c, int s, int vec, int tpr,
                                     int col_blocks, int chunk, int blocks, int dtype, void* stream) {
  if (p == 0 || c == 0) return 0;
  if (!plan_ok(p, c, dtype, vec, tpr, col_blocks, chunk, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_fill(n, static_cast<long long>(s) * c * 4, 0u, st);
  if (err != 0) return err;
  const RunsArgs a{x, static_cast<const int*>(seg), out, n, static_cast<unsigned char*>(mask),
                   p, c, s, tpr, lg2(tpr), chunk};
  err = launch_runs_any<CountOp>(a, dtype, vec, blocks, col_blocks, st);
  if (err != 0) return err;
  if (dtype == taseg::kF32 && vec == 4) return launch_share<float, 4>(seg, mask, g, n, dx, p, c, st);
  if (dtype == taseg::kF32 && vec == 1) return launch_share<float, 1>(seg, mask, g, n, dx, p, c, st);
  if (dtype == taseg::kBF16 && vec == 8) return launch_share<__nv_bfloat16, 8>(seg, mask, g, n, dx, p, c, st);
  if (dtype == taseg::kBF16 && vec == 1) return launch_share<__nv_bfloat16, 1>(seg, mask, g, n, dx, p, c, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------------------------
// The first design, the yardstick `old_ms`, on no path.  Each
// thread owns one column of a run of R consecutive rows (neighbouring
// threads neighbouring columns), keeps the running max of the segment it
// is in, and writes it out with one sign-split atomic where the segment
// changes and at the end of its run, into an f32 output the caller
// filled with -inf (and casts).  Its backward is one cooperative launch
// in two phases with a grid-wide barrier between them: the ties counted
// with one integer atomicAdd per run and segment, then the shares.
namespace v1 {

using taseg::to_f;

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

}  // namespace v1

// The first design's forward: out (s, c) f32 filled with -inf by the
// caller.
extern "C" int taseg_segment_max_v1(const void* x, const void* seg, void* out, int p, int c, int s,
                                    int rows_per, int dtype, void* stream) {
  if (p == 0 || c == 0 || s == 0) return 0;
  if (rows_per < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == taseg::kF32) return v1::launch_fwd<float>(x, seg, out, p, c, s, rows_per, st);
  if (dtype == taseg::kBF16) return v1::launch_fwd<__nv_bfloat16>(x, seg, out, p, c, s, rows_per, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The first design's backward: n (s, c) int32 and bar (2,) uint32 zeroed
// by the caller (bar is 0 again after).
extern "C" int taseg_segment_max_bwd_v1(const void* x, const void* seg, const void* out,
                                        const void* g, void* n, void* dx, void* bar, int p, int c,
                                        int s, int rows_per, int dtype, void* stream) {
  if (p == 0 || c == 0) return 0;
  if (rows_per < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == taseg::kF32)
    return v1::launch_bwd<float>(x, seg, out, g, n, dx, bar, p, c, s, rows_per, st);
  if (dtype == taseg::kBF16)
    return v1::launch_bwd<__nv_bfloat16>(x, seg, out, g, n, dx, bar, p, c, s, rows_per, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
