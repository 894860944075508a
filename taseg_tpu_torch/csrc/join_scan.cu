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
// Design: the TPU kernel carried the maxima across a sequential grid in
// SMEM; CUDA blocks run in no order, so this is a block-parallel
// inclusive max-scan in three launches: (1) each block reduces its 2048
// rows to 3 maxima, (2) one block scans the block aggregates into
// exclusive prefixes, (3) each block rescans its rows seeded with its
// prefix and writes the result.  The key-boundary test reads row i-1
// directly, so no previous-key carry and no padding are needed.  Inputs
// are read twice (passes 1 and 3); at ~21 MB the second read is mostly
// served by the 50 MB L2.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // rows per block (2048)
constexpr int kScanThreads = 1024;

struct Max3 {
  int a, b, c;  // bound, refpos, refid
};

__device__ __forceinline__ Max3 max3(Max3 x, Max3 y) {
  return {max(x.a, y.a), max(x.b, y.b), max(x.c, y.c)};
}

__device__ __forceinline__ Max3 row_vals(const int* __restrict__ shi,
                                         const int* __restrict__ slo2,
                                         const int* __restrict__ srow, int i,
                                         int v, int num_refs) {
  const bool differs = i == 0 || shi[i] != shi[i - 1] ||
                       (slo2[i] >> 1) != (slo2[i - 1] >> 1);
  const int r = srow[i];
  const bool is_ref = r < v;
  return {differs ? i : -1, is_ref ? i : -1,
          (is_ref && r < num_refs) ? r : -1};
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

// Exclusive max-scan of one value per thread over the block (identity
// -1: every scanned value is >= -1).  *total gets the block's maximum.
// `smem` holds 32 ints; the trailing barrier lets callers reuse it.
__device__ int block_excl_max(int x, int* smem, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int incl = warp_incl_max(x);
  if (lane == 31) smem[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? smem[lane] : -1;
    smem[lane] = warp_incl_max(w);
  }
  __syncthreads();
  int excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = -1;
  if (warp > 0) excl = max(excl, smem[warp - 1]);
  *total = smem[nw - 1];
  __syncthreads();
  return excl;
}

__global__ void __launch_bounds__(kThreads)
    js_reduce(const int* __restrict__ shi, const int* __restrict__ slo2,
              const int* __restrict__ srow, const int* __restrict__ num_refs_p,
              int n, int v, int* __restrict__ agg) {
  __shared__ int smem[32];
  const int num_refs = *num_refs_p;
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  Max3 m = {-1, -1, -1};
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = base + j;
    if (i < n) m = max3(m, row_vals(shi, slo2, srow, i, v, num_refs));
  }
  Max3 t;
  block_excl_max(m.a, smem, &t.a);
  block_excl_max(m.b, smem, &t.b);
  block_excl_max(m.c, smem, &t.c);
  if (threadIdx.x == 0) {
    agg[3 * blockIdx.x + 0] = t.a;
    agg[3 * blockIdx.x + 1] = t.b;
    agg[3 * blockIdx.x + 2] = t.c;
  }
}

__global__ void __launch_bounds__(kScanThreads)
    js_scan_aggs(const int* __restrict__ agg, int* __restrict__ prefix,
                 int nblocks) {
  __shared__ int smem[32];
  int carry[3] = {-1, -1, -1};
  for (int base = 0; base < nblocks; base += blockDim.x) {
    const int i = base + threadIdx.x;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int x = i < nblocks ? agg[3 * i + c] : -1;
      int tot;
      const int ex = block_excl_max(x, smem, &tot);
      if (i < nblocks) prefix[3 * i + c] = max(carry[c], ex);
      carry[c] = max(carry[c], tot);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    js_emit(const int* __restrict__ shi, const int* __restrict__ slo2,
            const int* __restrict__ srow, const int* __restrict__ num_refs_p,
            const int* __restrict__ prefix, int* __restrict__ out, int n,
            int v, int qsent, int mode) {
  __shared__ int smem[32];
  const int num_refs = *num_refs_p;
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  Max3 vals[kItems];
  Max3 m = {-1, -1, -1};
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = base + j;
    vals[j] = i < n ? row_vals(shi, slo2, srow, i, v, num_refs)
                    : Max3{-1, -1, -1};
    m = max3(m, vals[j]);
  }
  int unused;
  Max3 run;
  run.a = block_excl_max(m.a, smem, &unused);
  run.b = block_excl_max(m.b, smem, &unused);
  run.c = block_excl_max(m.c, smem, &unused);
  const int b3 = 3 * blockIdx.x;
  run = max3(run, Max3{prefix[b3], prefix[b3 + 1], prefix[b3 + 2]});
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = base + j;
    if (i >= n) break;
    run = max3(run, vals[j]);
    const bool in_range = shi[i] < qsent;
    const bool matched = run.b >= run.a && run.c >= 0 && in_range;
    int res;
    if (mode == 1) {
      res = in_range ? run.c * 2 + (matched ? 1 : 0) : -2;
    } else {
      res = matched ? run.c : -1;
    }
    out[i] = res;
  }
}

}  // namespace

// scratch: 6 * ceil(n / 2048) int32 (block aggregates, then prefixes).
extern "C" int taseg_join_scan(const void* shi, const void* slo2,
                               const void* srow, const void* num_refs,
                               void* out, void* scratch, int n, int v,
                               int qsent, int mode, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (n + kTile - 1) / kTile;
  int* agg = static_cast<int*>(scratch);
  int* prefix = agg + 3 * nb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* h = static_cast<const int*>(shi);
  const int* l = static_cast<const int*>(slo2);
  const int* r = static_cast<const int*>(srow);
  const int* nr = static_cast<const int*>(num_refs);
  js_reduce<<<nb, kThreads, 0, s>>>(h, l, r, nr, n, v, agg);
  js_scan_aggs<<<1, kScanThreads, 0, s>>>(agg, prefix, nb);
  js_emit<<<nb, kThreads, 0, s>>>(h, l, r, nr, prefix,
                                  static_cast<int*>(out), n, v, qsent, mode);
  return static_cast<int>(cudaGetLastError());
}
