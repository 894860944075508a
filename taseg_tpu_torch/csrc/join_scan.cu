// K1: post-sort join scan — replaces the Pallas kernel
// taseg_tpu/ops/join_scan.py:_kernel / join_scan (pallas_call at :146).
//
// After `join_keys` sorts the tagged union of reference and query keys,
// every sorted row i needs three running maxima
//   bound[i]  = last key-group start at or before i
//   refpos[i] = last reference row at or before i
//   refid[i]  = largest valid reference id seen (refs are key-sorted, so
//               the running max is the last one)
// and emits, in mode 0, the matched ref id or -1, in mode 1 the floor
// encoding refid*2+exact or -2.  Results are bit-identical to the XLA
// cummax formulation at taseg_tpu/ops/join.py:205-231.
//
// Bound on the H100: bytes.  The path's largest call (level 0, n = 10 x
// 131072 rows) reads 3 int32 arrays and writes one: 16 B/row, ~21 MB,
// ~6 us at 3.35 TB/s; it does a handful of integer ops per row.
//
// Design: the TPU kernel carries five values (the previous key pair and
// the three running maxima) in SMEM across a sequential grid.  CUDA blocks
// run in no order, so the counterpart of that carry is a single-pass scan
// with decoupled look-back (Merrill & Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", NVIDIA 2016), one launch per call
// and one read of the inputs:
//   * each block draws its tile index from an atomic counter, not from
//     blockIdx.x, so a tile only ever waits on tiles whose blocks have
//     already started; the block that draws the last index resets the
//     counter for the next call;
//   * a tile loads its 4096 rows into registers (16 per thread, 16-byte
//     loads where the arrays are 16-byte aligned), reduces them to the
//     three maxima and publishes that aggregate; warp 0 then reads its
//     predecessors' status words, 128 tiles per step (4 per lane), until
//     each maximum has met an inclusive prefix, publishes its own
//     inclusive prefix, and the block rescans its rows from registers
//     seeded with the exclusive prefix and writes them.  All tiles of a
//     call start at about the same time, so the inclusive prefixes spread
//     from tile 0 one look-back step at a time: large tiles and wide steps
//     keep that chain short (level 0: 320 tiles, at most 3 steps);
//   * a status word is 64 bits: the value in the low half, epoch << 2 |
//     flag in the high half, so one st.release publishes both and one
//     ld.acquire reads both.  Each tile has one word per maximum: max is
//     idempotent, so each maximum looks back on its own, and a value read
//     from beyond a predecessor's inclusive prefix changes nothing;
//   * words carry the wrapper's per-call epoch, so a word left by an
//     earlier call reads as not ready and the buffer needs no memset
//     between calls.  The wrapper keeps the buffer and the counter across
//     calls and grows the buffer zeroed (epoch 0 is never used).
// The key-boundary test reads row i-1 directly, so no key is carried.
#include "common.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // rows per tile (4096)
constexpr int kLookLanes = 4;             // predecessors per lane and step
constexpr unsigned kAggregate = 1;        // status flags
constexpr unsigned kPrefix = 2;

struct Max3 {
  int a, b, c;  // bound, refpos, refid
};

__device__ __forceinline__ Max3 max3(Max3 x, Max3 y) {
  return {max(x.a, y.a), max(x.b, y.b), max(x.c, y.c)};
}

// row i with keys (hi, lo2), row i-1 with (hi_prev, lo2_prev)
__device__ __forceinline__ Max3 row_vals(int i, int hi, int lo2, int r,
                                         int hi_prev, int lo2_prev, int v,
                                         int num_refs) {
  const bool differs =
      i == 0 || hi != hi_prev || (lo2 >> 1) != (lo2_prev >> 1);
  const bool is_ref = r < v;
  return {differs ? i : -1, is_ref ? i : -1,
          (is_ref && r < num_refs) ? r : -1};
}

// x[j] = p[base + j] for the rows < n (0 past n); 16-byte loads when the
// caller vouches for p's alignment and the thread's rows are all < n
template <bool kVec>
__device__ __forceinline__ void load_rows(const int* __restrict__ p, int base,
                                          int n, int (&x)[kItems]) {
  if (kVec && base + kItems <= n) {
#pragma unroll
    for (int j = 0; j < kItems; j += 4) {
      const int4 q = *reinterpret_cast<const int4*>(p + base + j);
      x[j] = q.x;
      x[j + 1] = q.y;
      x[j + 2] = q.z;
      x[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) x[j] = base + j < n ? p[base + j] : 0;
  }
}

template <bool kVec>
__device__ __forceinline__ void store_rows(int* __restrict__ p, int base,
                                           int n, const int (&x)[kItems]) {
  if (kVec && base + kItems <= n) {
#pragma unroll
    for (int j = 0; j < kItems; j += 4)
      *reinterpret_cast<int4*>(p + base + j) =
          make_int4(x[j], x[j + 1], x[j + 2], x[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (base + j < n) p[base + j] = x[j];
  }
}

__device__ __forceinline__ int warp_incl_max(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = max(x, y);
  }
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    x = max(x, __shfl_xor_sync(0xffffffffu, x, d));
  return x;
}

// Exclusive max-scan of one Max3 per thread over the block (identity -1:
// every scanned value is >= -1); *total gets the block's maxima.
__device__ Max3 block_excl_max3(Max3 x, int (*smem)[32], Max3* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int nw = kThreads / 32;
  const Max3 incl = {warp_incl_max(x.a), warp_incl_max(x.b),
                     warp_incl_max(x.c)};
  if (lane == 31) {
    smem[0][warp] = incl.a;
    smem[1][warp] = incl.b;
    smem[2][warp] = incl.c;
  }
  __syncthreads();
  if (warp < 3) {  // warp k scans the warp totals of maximum k
    const int w = lane < nw ? smem[warp][lane] : -1;
    smem[warp][lane] = warp_incl_max(w);
  }
  __syncthreads();
  Max3 ex = {__shfl_up_sync(0xffffffffu, incl.a, 1),
             __shfl_up_sync(0xffffffffu, incl.b, 1),
             __shfl_up_sync(0xffffffffu, incl.c, 1)};
  if (lane == 0) ex = {-1, -1, -1};
  if (warp > 0)
    ex = max3(ex, Max3{smem[0][warp - 1], smem[1][warp - 1],
                       smem[2][warp - 1]});
  *total = {smem[0][nw - 1], smem[1][nw - 1], smem[2][nw - 1]};
  return ex;
}

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void publish(u64* words, Max3 m, unsigned epoch,
                                        unsigned flag) {
  const u64 tag = static_cast<u64>(epoch << 2 | flag) << 32;
  st_release(words + 0, tag | static_cast<unsigned>(m.a));
  st_release(words + 1, tag | static_cast<unsigned>(m.b));
  st_release(words + 2, tag | static_cast<unsigned>(m.c));
}

// Run by all of warp 0 of tile t > 0: the maxima over tiles [0, t), from
// their status words, 32 * kLookLanes contiguous predecessors per step
// (lane l reads tiles base - l - 32 k), until each maximum has met some
// tile's inclusive prefix.  Every tile between that one and t has been
// read by then.
__device__ Max3 look_back(const u64* __restrict__ status, int t,
                          unsigned epoch) {
  const int lane = threadIdx.x & 31;
  Max3 ex = {-1, -1, -1};
  unsigned done = 0;  // bit c: maximum c has met an inclusive prefix
  for (int base = t - 1; done != 7u; base -= 32 * kLookLanes) {
    unsigned pre = 0;  // bit c: some tile read here holds prefix c
#pragma unroll
    for (int k = 0; k < kLookLanes; ++k) {
      const int j = base - lane - 32 * k;
      if (j < 0) {  // before tile 0 counts as a prefix of -1
        pre = 7u;
        continue;
      }
      u64 w[3];
      for (;;) {
        bool ready = true;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          w[c] = ld_acquire(status + 3 * j + c);
          ready = ready && (w[c] >> 34) == epoch;
        }
        if (ready) break;
        __nanosleep(32);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (((w[c] >> 32) & 3u) == kPrefix) pre |= 1u << c;
      ex = max3(ex, Max3{static_cast<int>(static_cast<unsigned>(w[0])),
                         static_cast<int>(static_cast<unsigned>(w[1])),
                         static_cast<int>(static_cast<unsigned>(w[2]))});
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
      if (__ballot_sync(0xffffffffu, (pre >> c) & 1u)) done |= 1u << c;
  }
  return {warp_max(ex.a), warp_max(ex.b), warp_max(ex.c)};
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    join_scan_kernel(const int* __restrict__ shi, const int* __restrict__ slo2,
                     const int* __restrict__ srow,
                     const int* __restrict__ num_refs_p, int* __restrict__ out,
                     u64* __restrict__ status, int* __restrict__ counter, int n,
                     int v, int qsent, int mode, unsigned epoch) {
  __shared__ int smem[3][32];
  __shared__ int tile_s;
  __shared__ Max3 prefix_s;
  const int nb = (n + kTile - 1) / kTile;
  if (threadIdx.x == 0) {
    const int t = atomicAdd(counter, 1);
    if (t == nb - 1) atomicExch(counter, 0);  // the call's last draw
    tile_s = t;
  }
  __syncthreads();
  const int t = tile_s;
  const int num_refs = *num_refs_p;
  const int base = t * kTile + threadIdx.x * kItems;
  int hi[kItems], lo2[kItems], row[kItems];
  load_rows<kVec>(shi, base, n, hi);
  load_rows<kVec>(slo2, base, n, lo2);
  load_rows<kVec>(srow, base, n, row);
  // row base - 1, for the key-boundary test of the thread's first row
  const bool has_prev = base > 0 && base <= n;
  const int hi0 = has_prev ? shi[base - 1] : 0;
  const int lo0 = has_prev ? slo2[base - 1] : 0;
  Max3 m = {-1, -1, -1};
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = base + j;
    if (i < n)
      m = max3(m, row_vals(i, hi[j], lo2[j], row[j], j ? hi[j - 1] : hi0,
                           j ? lo2[j - 1] : lo0, v, num_refs));
  }
  Max3 agg;
  Max3 run = block_excl_max3(m, smem, &agg);
  if (threadIdx.x < 32) {
    const bool lead = threadIdx.x == 0;
    u64* mine = status + 3 * t;
    Max3 ex = {-1, -1, -1};
    if (t > 0) {
      if (lead) publish(mine, agg, epoch, kAggregate);
      ex = look_back(status, t, epoch);
    }
    if (lead) {
      publish(mine, max3(ex, agg), epoch, kPrefix);
      prefix_s = ex;
    }
  }
  __syncthreads();
  run = max3(run, prefix_s);
  int res[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = base + j;
    run = max3(run, row_vals(i, hi[j], lo2[j], row[j], j ? hi[j - 1] : hi0,
                             j ? lo2[j - 1] : lo0, v, num_refs));
    const bool in_range = hi[j] < qsent;
    const bool matched = run.b >= run.a && run.c >= 0 && in_range;
    if (mode == 1) {
      res[j] = in_range ? run.c * 2 + (matched ? 1 : 0) : -2;
    } else {
      res[j] = matched ? run.c : -1;
    }
  }
  store_rows<kVec>(out, base, n, res);
}

}  // namespace

// status: at least 3 * ceil(n / 4096) 64-bit words, zeroed when allocated
// and holding no word of this `epoch` (1 <= epoch < 2^30); counter: one
// int32, 0 between calls (the kernel leaves it so).
extern "C" int taseg_join_scan(const void* shi, const void* slo2,
                               const void* srow, const void* num_refs,
                               void* out, void* status, void* counter, int n,
                               int v, int qsent, int mode, int epoch,
                               void* stream) {
  if (n <= 0 || (mode != 0 && mode != 1) || epoch <= 0 || epoch >= (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (n + kTile - 1) / kTile;
  const bool vec = ((reinterpret_cast<size_t>(shi) |
                     reinterpret_cast<size_t>(slo2) |
                     reinterpret_cast<size_t>(srow) |
                     reinterpret_cast<size_t>(out)) & 15) == 0;
  auto kernel = vec ? join_scan_kernel<true> : join_scan_kernel<false>;
  kernel<<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(shi), static_cast<const int*>(slo2),
      static_cast<const int*>(srow), static_cast<const int*>(num_refs),
      static_cast<int*>(out), static_cast<u64*>(status),
      static_cast<int*>(counter), n, v, qsent, mode,
      static_cast<unsigned>(epoch));
  return static_cast<int>(cudaGetLastError());
}
