// K2: sparse conv forward over a dense rulebook — replaces the forward of
// taseg_tpu/ops/tgf.py:217 tgf_conv_apply (_tgf_fwd_impl, :165), the 27
// offsets of a stride-1 3^3 conv, and of taseg_tpu/ops/sparse_conv.py:137
// sparse_conv_apply (_conv_fwd_impl), a conv over any K <= 32 offsets
// with V_in input rows and V_out output rows (Cylinder3D's asymmetric
// 1x3x3 / 3x1x3 convs at K = 9, its 1-D recon convs at K = 3, its pooling
// and transposed convs at K = 8 and 4, between two levels, and its 3^3
// head at K = 27).
//
//   out[v] = sum_k feats[rb[k, v]] @ W[k]      (rb[k, v] == -1: absent)
//
// feats (V_in, C_in) and W (K, C_in, C_out) in f32 or bf16, rb (K, V_out)
// int32; out (V_out, C_out) in the input dtype, accumulated in f32 over
// all K offsets and rounded once.  The kernels never need V_in: they read
// only the rows the rulebook names.
//
// Bound on the H100: one read of feats, W and rb and one write of out,
// against 2 * (present rulebook pairs) * C_in * C_out operations.  At the
// MinkUNet path's shapes the bytes bound it (0.33 ms per scan in all
// against 0.19 ms of present-pair operations at the bf16 tensor-core
// rate); at Cylinder3D's f32 shapes, summed per scan on the H100
// (chip_smoke.py phase 5e), 1.09 ms at the 67 TFLOP/s of f32 CUDA cores
// (operations) and 0.80 ms at 3xTF32's 165 (bytes in most calls).
//
// The wrapper picks the kernel by dtype and widths (sparse_conv.route,
// sparse_conv.k_route); the 27-offset calls count as `sparse_conv_k3`, the
// K-offset calls as `sparse_conv_k`:
//
// sparse_conv_wgmma_kernel (bf16, C_in % 8 == 0, C_out % 8 == 0: every
// bf16 conv, ragged widths padded to them by the wrappers, which pass the
// logical output width `ldo` that the kernel writes, at 27 or K offsets, and
// K3-down's and K3-up's 8 slots, strided_conv.cu): the Hopper tile of
// wgmma_tile.cuh,
// output-stationary over the table's row order like the 3xTF32 kernel
// below: a producer warpgroup gathers rows by cp.async into a 4-stage
// mbarrier ring, a consumer warpgroup runs wgmma m64nNk16 with N the whole
// C_out (up to 256), and on tables of few rows (sparse_conv.wgmma_splits:
// the coarse levels) each tile's chain is cut into parts whose f32
// partials sparse_conv_wgmma_reduce adds in split order.  What held the
// mma.sync tile (k3_conv_mma_kernel, kept off the path as the yardstick
// `old_ms`) at ~7% of the bf16 peak (tools/k2_pace.py): a 64-row tile in
// table order ran 2.1-4.1x the present pairs (now 1.5-1.8x over the
// order); each 32-channel stage cost a __syncthreads with two stages of
// lookahead, which one 4-warp block per tile could not hide (now a
// warp-specialised ring with 64-channel stages); a 256-wide conv gathered
// its rows once per 128-column block (now once); the coarse levels had
// 1-4 blocks per SM (now split chains).
//
// sparse_conv_k_tf32_wgmma_kernel (f32, C_in % 4 == 0, C_out % 4 == 0:
// every conv of Cylinder3D, every f32 MinkUNet's 3^3 convs, their input
// gradients, and K3-down's and K3-up's f32 calls over the child and up
// tables): the Hopper tile of wgmma_tf32.cuh on 3xTF32, output-stationary
// over a row order.  The wrapper passes `order`, the rows sorted by their
// bitmask of present offsets (sparse_conv.mask_row_order, built once per
// table by the topology); a tile takes 64 consecutive entries of the
// order, reads their rows' rulebook entries through it, runs only the
// offsets one of them has and writes out[order[r]].  Rows with equal
// masks share a tile, so the tile's union of offsets comes near each
// row's own count, and rows of a group stay in table order (nearby
// gathers).  Each row sums its offsets in k order with no atomics: the
// same bits on repeat.  Tiles of rows without offsets write zeros.  A
// table of few rows (sparse_conv.k_splits: the coarse levels) has too few
// tiles to fill the card: each tile's chain of (offset, 32-channel)
// stages is then cut into equal parts run by separate blocks, and a
// second kernel adds the parts' partials to the first's output in split
// order.  wgmma reads .tf32 operands K-major only, so the weight's B
// operand is its (K, C_out, C_in) form, split into TF32 high and low
// parts by tf32_split_kernel (one pass over W read at any strides: the
// forward's W transposed, the input gradient's W^T as W is stored),
// once per call or once per served weight.  What held the mma.sync tile
// it replaced (k_tf32_mma_kernel, gather_mma.cuh namespace tf32, kept
// off the path as the yardstick `old_ms`) at 18% of its bound on
// Cylinder's calls (4.43 device ms a scan against 0.80 on an H100 80GB
// HBM3 at 700 W, chip_smoke.py phase 5e): Ampere's mma.sync m16n8k8 at
// a quarter of a warpgroup's issue, each operand split again for every
// fragment load (B once per row block of 32), and a __syncthreads per
// 32-channel stage with two stages of lookahead; the wgmma tile splits B
// once per call, runs a warp-specialised 4-stage ring and issues
// m64nBNk8 for the whole tile (3.51 device ms against the mma.sync tile's
// 4.03 at the same calls, PERF.md §6).
//
// k3_conv_kernel / sparse_conv_k_kernel (any dtype and width; no path
// calls them since the wrappers pad ragged widths onto the tensor-core
// routes: the yardstick those routes replaced): a 64 x 64 output tile in
// registers (4 x 4 per thread) for all its offsets;
// per offset it gathers the present neighbour rows into shared memory
// (zero for -1), multiplies them with the W[k] tile by f32 FMA and skips
// the offset when no row of the tile has that neighbour.  Ragged C_in /
// C_out / V edges are masked.
#include <algorithm>

#include "common.cuh"
#include "gather_mma.cuh"
#include "wgmma_tf32.cuh"
#include "wgmma_tile.cuh"

namespace {

namespace mma = taseg::mma;
using taseg::store_f;
using taseg::to_f;

constexpr int kBM = 64;   // output rows per block
constexpr int kBN = 64;   // output columns per block
constexpr int kBK = 16;   // input channels per shared-memory stage
constexpr int kThreads = 256;
constexpr int kOffsets = 27;

// the CUDA-core tile of one block over n_off offsets; v = output rows
template <typename T>
__device__ __forceinline__ void conv_simt_tile(const T* __restrict__ feats,
                                               const T* __restrict__ w,
                                               const int* __restrict__ rb,
                                               T* __restrict__ out, int v,
                                               int c_in, int c_out,
                                               int n_off) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN];
  __shared__ int idx_s[kBM];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float acc[4][4] = {};

  for (int k = 0; k < n_off; ++k) {
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k3_conv_kernel(const T* __restrict__ feats, const T* __restrict__ w,
                   const int* __restrict__ rb, T* __restrict__ out, int v,
                   int c_in, int c_out) {
  conv_simt_tile<T>(feats, w, rb, out, v, c_in, c_out, kOffsets);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sparse_conv_k_kernel(const T* __restrict__ feats, const T* __restrict__ w,
                         const int* __restrict__ rb, T* __restrict__ out,
                         int v_out, int c_in, int c_out, int n_off) {
  conv_simt_tile<T>(feats, w, rb, out, v_out, c_in, c_out, n_off);
}

// the mma.sync tile of one block over the 27 offsets in table
// order: off the path since the wgmma route, kept as its yardstick
// (chip_smoke.py's `old_ms`, tools/k2_pace.py)
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

// the mma.sync 3xTF32 tile of one block (off the path since the wgmma
// tile; kept as its yardstick, chip_smoke.py's `old_ms`, and for
// tools/k2k_tiles.py): 64 rows of the order, T::BN columns.  With
// gridDim.z = S > 1 splits, block z runs the z-th of S equal parts of the
// tile's stage chain; split 0 writes out (as with one split), split z > 0
// its partial at part[z - 1] in order positions and live[z - 1][tile] =
// whether it had stages; sparse_conv_k_tf32_reduce adds the partials.
template <typename T>
__global__ void __launch_bounds__(taseg::tf32::kThreads)
    k_tf32_mma_kernel(const float* __restrict__ feats, const float* __restrict__ w,
                      const int* __restrict__ rb, const int* __restrict__ order,
                      float* __restrict__ out, float* __restrict__ part,
                      int* __restrict__ live, int v_out, int c_in, int c_out, int n_off,
                      int ldo) {
  namespace tf = taseg::tf32;
  extern __shared__ __align__(16) unsigned char smem[];
  const tf::Smem s = tf::carve<T>(smem, n_off);
  const int m0 = blockIdx.x * tf::kBM, n0 = blockIdx.y * T::BN;
  if (threadIdx.x < tf::kBM) {
    const int r = m0 + threadIdx.x;
    s.rows[threadIdx.x] = r < v_out ? order[r] : -1;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n_off * tf::kBM; e += tf::kThreads) {
    const int k = e / tf::kBM, row = s.rows[e % tf::kBM];
    s.idx[e] = row >= 0 ? rb[static_cast<size_t>(k) * v_out + row] : -1;
  }
  __syncthreads();
  const int total = tf::present_offsets(s, n_off) * ((c_in + T::BK - 1) / T::BK);
  const int z = blockIdx.z, per = (total + gridDim.z - 1) / gridDim.z;
  const int t0 = min(total, z * per), t1 = min(total, t0 + per);
  if (z > 0) {
    if (threadIdx.x == 0 && blockIdx.y == 0)
      live[(z - 1) * gridDim.x + blockIdx.x] = t0 < t1;
    if (t0 >= t1) return;
  }
  float acc[2][T::BN / 16][4] = {};
  tf::gather_mma_tile<T>(s, t0, t1, feats, w, c_in, c_out, n0, acc);
  if (z == 0)
    tf::store_rows<T::BN>(s, acc, out, ldo, n0);
  else
    tf::store_rows<T::BN>(s, acc, part + static_cast<size_t>(z - 1) * v_out * c_out,
                          c_out, n0, m0);
}

// out[order[p]] += the live partials of p's tile, in split order; out
// rows of ldo <= c_out columns (partials of c_out), 4 columns a thread
__global__ void sparse_conv_k_tf32_reduce(const float* __restrict__ part,
                                          const int* __restrict__ live,
                                          const int* __restrict__ order,
                                          float* __restrict__ out, int v_out,
                                          int c_out, int ldo, int parts, int tiles) {
  const int c4 = c_out / 4;
  const size_t n = static_cast<size_t>(v_out) * c4;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int p = static_cast<int>(e / c4), c = static_cast<int>(e % c4) * 4;
    const int tile = p / taseg::tf32::kBM;
    if (c >= ldo) continue;
    bool any = false;
    for (int z = 0; z < parts; ++z) any |= live[z * tiles + tile] != 0;
    if (!any) continue;
    float* o = out + static_cast<size_t>(order[p]) * ldo + c;
    float a[4];
    if (ldo == c_out) {
      const float4 v = *reinterpret_cast<const float4*>(o);
      a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = c + i < ldo ? o[i] : 0.f;
    }
    for (int z = 0; z < parts; ++z) {
      if (!live[z * tiles + tile]) continue;
      const float4 b = *reinterpret_cast<const float4*>(
          part + (static_cast<size_t>(z) * v_out + p) * c_out + c);
      a[0] += b.x;
      a[1] += b.y;
      a[2] += b.z;
      a[3] += b.w;
    }
    if (ldo == c_out) {
      *reinterpret_cast<float4*>(o) = make_float4(a[0], a[1], a[2], a[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c + i < ldo) o[i] = a[i];
    }
  }
}

// launch the mma.sync 3xTF32 kernel with tile T over `splits` parts of
// each tile's chain (part: (splits - 1, v_out, c_out) f32, live: (splits
// - 1, row tiles) int32 scratch when splits > 1), then the reduction, out
// rows of ldo columns; returns the CUDA error
template <typename T>
int launch_k_tf32(const void* feats, const void* w, const void* rb,
                  const void* order, void* out, void* part, void* live,
                  int v_out, int c_in, int c_out, int n_off, int splits,
                  cudaStream_t stream, int ldo) {
  namespace tf = taseg::tf32;
  if (splits < 1 || (splits > 1 && (part == nullptr || live == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = tf::smem_bytes<T>(n_off);
  cudaError_t e = cudaFuncSetAttribute(k_tf32_mma_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (v_out + tf::kBM - 1) / tf::kBM;
  const dim3 grid(tiles, (c_out + T::BN - 1) / T::BN, splits);
  k_tf32_mma_kernel<T><<<grid, tf::kThreads, bytes, stream>>>(
      static_cast<const float*>(feats), static_cast<const float*>(w),
      static_cast<const int*>(rb), static_cast<const int*>(order),
      static_cast<float*>(out), static_cast<float*>(part), static_cast<int*>(live),
      v_out, c_in, c_out, n_off, ldo);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t n = static_cast<size_t>(v_out) * (c_out / 4);
  const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
  sparse_conv_k_tf32_reduce<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(live),
      static_cast<const int*>(order), static_cast<float*>(out), v_out, c_out, ldo,
      splits - 1, tiles);
  return static_cast<int>(cudaGetLastError());
}

// which table the wgmma kernel runs over: it names the kernel apart in a
// profile (K2's rulebooks, K3-down's child tables, K3-up's up tables)
struct K2Rows {};
struct DownSlots {};
struct UpSlots {};

// The B operand of the 3xTF32 wgmma tile: w (K, c_in, c_out) f32 read at
// strides (s_k, s_ci, s_co) -> hi and lo, (K, c_out, c_in) each, the
// K-major form wgmma reads, hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x -
// hi).  32 x 32 tiles through shared memory, read along w's unit-stride
// axis (C_out for W as stored, C_in for the input gradient's W^T, a
// transposed view of W) and written along C_in.  Grid (c_in / 32,
// c_out / 32, K), blocks of 32 x 8.
__global__ void tf32_split_kernel(const float* __restrict__ w, float* __restrict__ hi,
                                  float* __restrict__ lo, int c_in, int c_out, int s_k, int s_ci,
                                  int s_co) {
  __shared__ float t[32][33];  // [n - n0][c - c0]
  const int c0 = blockIdx.x * 32, n0 = blockIdx.y * 32, k = blockIdx.z;
  const bool n_major = s_co == 1;
  const float* wk = w + static_cast<size_t>(k) * s_k;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int n = n_major ? n0 + threadIdx.x : n0 + i;
    const int c = n_major ? c0 + i : c0 + threadIdx.x;
    const float x = n < c_out && c < c_in
                        ? wk[static_cast<size_t>(c) * s_ci + static_cast<size_t>(n) * s_co]
                        : 0.f;
    if (n_major)
      t[threadIdx.x][i] = x;
    else
      t[i][threadIdx.x] = x;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int n = n0 + i, c = c0 + threadIdx.x;
    if (n >= c_out || c >= c_in) continue;
    uint32_t h, l;
    taseg::wt::split(t[i][threadIdx.x], h, l);
    const size_t o = (static_cast<size_t>(k) * c_out + n) * c_in + c;
    hi[o] = __uint_as_float(h);
    lo[o] = __uint_as_float(l);
  }
}

// the 3xTF32 wgmma tile of one block: 64 entries of the order
// (blockIdx.x), columns [n0, n0 + BN) (blockIdx.y), part z of the tile's
// chain (blockIdx.z of S).  Split 0 writes out (as with one split), split
// z > 0 its partial at part[z - 1] in order positions and live[z -
// 1][tile] = whether it had stages; sparse_conv_k_tf32_reduce adds them.
// whi / wlo: the weight's split K-major operand (tf32_split_kernel).
template <typename T>
__global__ void __launch_bounds__(taseg::wt::kThreads, T::MIN_BLOCKS)
    sparse_conv_k_tf32_wgmma_kernel(const float* __restrict__ feats,
                                    const float* __restrict__ whi,
                                    const float* __restrict__ wlo,
                                    const int* __restrict__ rb, const int* __restrict__ order,
                                    float* __restrict__ out, float* __restrict__ part,
                                    int* __restrict__ live, int v_out, int c_in, int c_out,
                                    int n_off, int ldo) {
  namespace wg = taseg::wg;
  namespace wt = taseg::wt;
  extern __shared__ unsigned char smem_raw[];
  const wg::Smem s = wt::carve<T>(smem_raw, n_off);
  const int m0 = blockIdx.x * wt::kBM, n0 = blockIdx.y * T::BN;
  if (threadIdx.x < wt::kBM) {
    const int r = m0 + threadIdx.x;
    s.rows[threadIdx.x] = r < v_out ? order[r] : -1;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < wt::kStages; ++i) {
      wg::mbar_init(s.full + i, wt::kProducers);
      wg::mbar_init(s.empty + i, wt::kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n_off * wt::kBM; e += wt::kThreads) {
    const int k = e / wt::kBM, row = s.rows[e % wt::kBM];
    s.idx[e] = row >= 0 ? rb[static_cast<size_t>(k) * v_out + row] : -1;
  }
  __syncthreads();
  const int total = wg::present_offsets(s, n_off) * ((c_in + wt::kBK - 1) / wt::kBK);
  const int z = blockIdx.z, per = (total + gridDim.z - 1) / gridDim.z;
  const int t0 = min(total, z * per), t1 = min(total, t0 + per);
  if (z > 0) {
    if (threadIdx.x == 0 && blockIdx.y == 0)
      live[(z - 1) * gridDim.x + blockIdx.x] = t0 < t1;
    if (t0 >= t1) return;
  }
  if (threadIdx.x >= wt::kConsumers) {
    wt::produce<T>(s, t0, t1, feats, whi, wlo, c_in, c_out, n0);
    return;
  }
  float acc[T::BN / 2];
#pragma unroll
  for (int i = 0; i < T::BN / 2; ++i) acc[i] = 0.f;
  wt::consume<T>(s, t1 - t0, acc);
  if (z == 0)
    wt::store<T::BN>(s, acc, out, ldo, n0, -1);
  else
    wt::store<T::BN>(s, acc, part + static_cast<size_t>(z - 1) * v_out * c_out, c_out, n0, m0);
}

// launch the 3xTF32 wgmma route: where `fresh`, first split w (K, c_in,
// c_out) at strides (s_k, s_ci, s_co) into wsplit (2, K, c_out, c_in)
// (else wsplit holds that operand already), then the tile over `splits`
// parts of each tile's chain (part: (splits - 1, v_out, c_out) f32, live:
// (splits - 1, row tiles) int32 scratch when splits > 1), then the
// reduction, out rows of ldo columns; returns the CUDA error
template <typename T>
int launch_tf32_wgmma(const void* feats, const void* w, const void* rb, const void* order,
                      void* out, void* part, void* live, void* wsplit, bool fresh, int s_k,
                      int s_ci, int s_co, int v_out, int c_in, int c_out, int n_off, int splits,
                      cudaStream_t stream, int ldo) {
  namespace wt = taseg::wt;
  if (splits < 1 || (splits > 1 && (part == nullptr || live == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the attribute once per kernel at its largest size (K = 32 offsets)
  static const cudaError_t set = cudaFuncSetAttribute(
      sparse_conv_k_tf32_wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(wt::smem_bytes<T>(32)));
  if (set != cudaSuccess) return static_cast<int>(set);
  float* hi = static_cast<float*>(wsplit);
  float* lo = hi + static_cast<size_t>(n_off) * c_out * c_in;
  cudaError_t e;
  if (fresh) {
    const dim3 g((c_in + 31) / 32, (c_out + 31) / 32, n_off);
    tf32_split_kernel<<<g, dim3(32, 8), 0, stream>>>(static_cast<const float*>(w), hi, lo, c_in,
                                                     c_out, s_k, s_ci, s_co);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles = (v_out + wt::kBM - 1) / wt::kBM;
  const dim3 grid(tiles, (c_out + T::BN - 1) / T::BN, splits);
  sparse_conv_k_tf32_wgmma_kernel<T><<<grid, wt::kThreads, wt::smem_bytes<T>(n_off), stream>>>(
      static_cast<const float*>(feats), hi, lo, static_cast<const int*>(rb),
      static_cast<const int*>(order), static_cast<float*>(out), static_cast<float*>(part),
      static_cast<int*>(live), v_out, c_in, c_out, n_off, ldo);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t n = static_cast<size_t>(v_out) * (c_out / 4);
  const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
  sparse_conv_k_tf32_reduce<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(live),
      static_cast<const int*>(order), static_cast<float*>(out), v_out, c_out, ldo, splits - 1,
      tiles);
  return static_cast<int>(cudaGetLastError());
}

// the wgmma tile of one block: 64 entries of the order (blockIdx.x),
// columns [n0, n0 + BN) (blockIdx.y), part z of the tile's chain
// (blockIdx.z of S).  With S = 1 it writes out[order[r]] in bf16; with S
// > 1 part z writes f32 partials at part[z] in order positions and
// live[z][tile] = whether it had stages, and sparse_conv_wgmma_reduce
// adds them.
template <typename T, typename Role>
__global__ void __launch_bounds__(taseg::wg::kThreads, 1)
    sparse_conv_wgmma_kernel(const __nv_bfloat16* __restrict__ feats,
                             const __nv_bfloat16* __restrict__ w,
                             const int* __restrict__ rb, const int* __restrict__ order,
                             __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                             int* __restrict__ live, int v_out, int c_in, int c_out,
                             int n_off, int ldo) {
  namespace wg = taseg::wg;
  extern __shared__ unsigned char smem_raw[];
  const wg::Smem s = wg::carve<T>(smem_raw, n_off);
  const int m0 = blockIdx.x * wg::kBM, n0 = blockIdx.y * T::BN;
  if (threadIdx.x < wg::kBM) {
    const int r = m0 + threadIdx.x;
    s.rows[threadIdx.x] = r < v_out ? order[r] : -1;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < wg::kStages; ++i) {
      wg::mbar_init(s.full + i, wg::kThreads - wg::kConsumers);
      wg::mbar_init(s.empty + i, wg::kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n_off * wg::kBM; e += wg::kThreads) {
    const int k = e / wg::kBM, row = s.rows[e % wg::kBM];
    s.idx[e] = row >= 0 ? rb[static_cast<size_t>(k) * v_out + row] : -1;
  }
  __syncthreads();
  const int total = wg::present_offsets(s, n_off) * ((c_in + T::BK - 1) / T::BK);
  const int z = blockIdx.z, splits = gridDim.z, per = (total + splits - 1) / splits;
  const int t0 = min(total, z * per), t1 = min(total, t0 + per);
  if (splits > 1) {
    if (threadIdx.x == 0 && blockIdx.y == 0)
      live[z * gridDim.x + blockIdx.x] = t0 < t1;
    if (t0 >= t1) return;
  }
  if (threadIdx.x >= wg::kConsumers) {
    wg::produce<T>(s, t0, t1, feats, w, c_in, c_out, n0);
    return;
  }
  float acc[T::BN / 2];
#pragma unroll
  for (int i = 0; i < T::BN / 2; ++i) acc[i] = 0.f;
  wg::consume<T>(s, t1 - t0, acc);
  wg::store<T::BN>(s, acc, out,
                   splits > 1 ? part + static_cast<size_t>(z) * v_out * c_out : nullptr,
                   c_out, ldo, m0, n0);
}

// out[order[p]] = bf16(the live partials of p's tile added in split
// order; 0 where none is live), 8 columns per thread; out rows of ldo <=
// c_out columns (partials of c_out)
template <typename Role>
__global__ void sparse_conv_wgmma_reduce(const float* __restrict__ part,
                                         const int* __restrict__ live,
                                         const int* __restrict__ order,
                                         __nv_bfloat16* __restrict__ out, int v_out,
                                         int c_out, int ldo, int splits, int tiles) {
  const int c8 = c_out / 8;
  const size_t n = static_cast<size_t>(v_out) * c8;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int p = static_cast<int>(e / c8), c = static_cast<int>(e % c8) * 8;
    const int tile = p / taseg::wg::kBM;
    if (c >= ldo) continue;
    float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int z = 0; z < splits; ++z) {
      if (!live[z * tiles + tile]) continue;
      const float4* q = reinterpret_cast<const float4*>(
          part + (static_cast<size_t>(z) * v_out + p) * c_out + c);
      const float4 u = q[0], v = q[1];
      a[0] += u.x; a[1] += u.y; a[2] += u.z; a[3] += u.w;
      a[4] += v.x; a[5] += v.y; a[6] += v.z; a[7] += v.w;
    }
    if (ldo == c_out) {
      __align__(16) __nv_bfloat162 o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(order[p]) * c_out + c) =
          *reinterpret_cast<const uint4*>(o);
    } else {
      __nv_bfloat16* o = out + static_cast<size_t>(order[p]) * ldo + c;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (c + i < ldo) o[i] = __float2bfloat16_rn(a[i]);
    }
  }
}

template <typename T, typename Role>
int launch_wgmma(const void* feats, const void* w, const void* rb, const void* order,
                 void* out, void* part, void* live, int v_out, int c_in, int c_out,
                 int n_off, int splits, cudaStream_t stream, int ldo) {
  namespace wg = taseg::wg;
  using bf16 = __nv_bfloat16;
  const size_t bytes = wg::smem_bytes<T>(n_off);
  // the attribute once per kernel at its largest size (K = 32 offsets):
  // a launch then sets nothing more
  static const cudaError_t set = cudaFuncSetAttribute(
      sparse_conv_wgmma_kernel<T, Role>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(wg::smem_bytes<T>(32)));
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaError_t e;
  const int tiles = (v_out + wg::kBM - 1) / wg::kBM;
  const dim3 grid(tiles, (c_out + T::BN - 1) / T::BN, splits);
  sparse_conv_wgmma_kernel<T, Role><<<grid, wg::kThreads, bytes, stream>>>(
      static_cast<const bf16*>(feats), static_cast<const bf16*>(w),
      static_cast<const int*>(rb), static_cast<const int*>(order), static_cast<bf16*>(out),
      static_cast<float*>(part), static_cast<int*>(live), v_out, c_in, c_out, n_off, ldo);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t n = static_cast<size_t>(v_out) * (c_out / 8);
  const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
  sparse_conv_wgmma_reduce<Role><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(live),
      static_cast<const int*>(order), static_cast<bf16*>(out), v_out, c_out, ldo, splits,
      tiles);
  return static_cast<int>(cudaGetLastError());
}

// the CUDA-core kernel on one dtype code: the k3 instance (27 offsets)
// where `k3`, else the K-offset instance over n_off offsets
int launch_simt(const void* feats, const void* w, const void* rb, void* out,
                int v, int c_in, int c_out, int n_off, bool k3, int dtype,
                cudaStream_t s) {
  const dim3 grid((v + kBM - 1) / kBM, (c_out + kBN - 1) / kBN);
  const int* r = static_cast<const int*>(rb);
  if (dtype == taseg::kF32) {
    using T = float;
    const T *f = static_cast<const T*>(feats), *wt = static_cast<const T*>(w);
    T* o = static_cast<T*>(out);
    if (k3)
      k3_conv_kernel<T><<<grid, kThreads, 0, s>>>(f, wt, r, o, v, c_in, c_out);
    else
      sparse_conv_k_kernel<T><<<grid, kThreads, 0, s>>>(f, wt, r, o, v, c_in,
                                                        c_out, n_off);
  } else if (dtype == taseg::kBF16) {
    using T = __nv_bfloat16;
    const T *f = static_cast<const T*>(feats), *wt = static_cast<const T*>(w);
    T* o = static_cast<T*>(out);
    if (k3)
      k3_conv_kernel<T><<<grid, kThreads, 0, s>>>(f, wt, r, o, v, c_in, c_out);
    else
      sparse_conv_k_kernel<T><<<grid, kThreads, 0, s>>>(f, wt, r, o, v, c_in,
                                                        c_out, n_off);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
  return launch_simt(feats, w, rb, out, v, c_in, c_out, kOffsets, true, dtype,
                     static_cast<cudaStream_t>(stream));
}

// K offsets (1 <= n_off <= 32): feats (V_in, C_in), w (n_off, C_in,
// C_out), rb (n_off, v_out) int32 of input rows -> out (v_out, C_out)
extern "C" int taseg_sparse_conv_k(const void* feats, const void* w,
                                   const void* rb, void* out, int v_out,
                                   int c_in, int c_out, int n_off, int dtype,
                                   void* stream) {
  if (v_out <= 0 || c_in <= 0 || c_out <= 0 || n_off <= 0 || n_off > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_simt(feats, w, rb, out, v_out, c_in, c_out, n_off, false, dtype,
                     static_cast<cudaStream_t>(stream));
}

// the 3xTF32 route of the K-offset conv (and of K3's f32 calls over the
// child and up tables): f32, C_in and C_out multiples of 4, feats 16-byte
// aligned, 1 <= n_off <= 32; w (n_off, C_in, C_out) f32 at element
// strides (s_k, s_ci, s_co), any layout (the input gradient's W^T is a
// transposed view of W); wsplit (2, n_off, C_out, C_in) f32 scratch for
// w's split K-major operand, filled here where `fresh`, else filled by
// an earlier call on the same weight; order (v_out,) int32, a
// permutation of the output rows (sparse_conv.mask_row_order(rb));
// `splits` parts of each tile's chain (sparse_conv.k_splits), with part
// (splits - 1, v_out, c_out) f32 and live (splits - 1, ceil(v_out / 64))
// int32 scratch when splits > 1; out rows of ldo <= c_out columns (the
// first ldo of those computed: a ragged width padded to c_out)
extern "C" int taseg_sparse_conv_k_tf32(const void* feats, const void* w, const void* rb,
                                        const void* order, void* out, void* part, void* live,
                                        void* wsplit, int fresh, int s_k, int s_ci, int s_co,
                                        int v_out, int c_in, int c_out, int n_off, int splits,
                                        int ldo, void* stream) {
  namespace wt = taseg::wt;
  if (v_out <= 0 || c_in <= 0 || c_out <= 0 || c_in % 4 != 0 || c_out % 4 != 0 ||
      n_off <= 0 || n_off > 32 || ldo <= 0 || ldo > c_out || wsplit == nullptr ||
      (fresh && w == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return wt::with_tile(c_out, [&](auto bn) {
    using T = wt::Tile<decltype(bn)::value>;
    return launch_tf32_wgmma<T>(feats, w, rb, order, out, part, live, wsplit, fresh != 0, s_k,
                                s_ci, s_co, v_out, c_in, c_out, n_off, splits,
                                static_cast<cudaStream_t>(stream), ldo);
  });
}

// the mma.sync 3xTF32 tile that route replaced (off the path: the
// yardstick `old_ms`), at the same calls: w (n_off, C_in, C_out)
// contiguous, 16-byte aligned; the other arguments as above
extern "C" int taseg_sparse_conv_k_tf32_mma(const void* feats, const void* w,
                                            const void* rb, const void* order,
                                            void* out, void* part, void* live,
                                            int v_out, int c_in, int c_out,
                                            int n_off, int splits, int ldo, void* stream) {
  namespace tf = taseg::tf32;
  if (v_out <= 0 || c_in <= 0 || c_out <= 0 || c_in % 4 != 0 ||
      c_out % 4 != 0 || n_off <= 0 || n_off > 32 || ldo <= 0 || ldo > c_out)
    return static_cast<int>(cudaErrorInvalidValue);
  return tf::with_tile_n_f32(c_out, [&](auto bn) {
    using T = tf::Tile<decltype(bn)::value, 32, 3>;
    return launch_k_tf32<T>(feats, w, rb, order, out, part, live, v_out, c_in,
                            c_out, n_off, splits, static_cast<cudaStream_t>(stream), ldo);
  });
}

namespace {

// the wgmma route of K2 (27 offsets or any K) and of K3-down (the 8
// slots of the child table): bf16, C_in and C_out multiples of 8, feats
// and w 16-byte aligned, 1 <= n_off <= 32; rb (n_off, v_out) int32 rows
// of feats, order (v_out,) int32 a permutation of the output rows
// (sparse_conv.mask_row_order(rb)); `splits` (1..8) parts of each tile's
// chain (sparse_conv.wgmma_splits), with part (splits, v_out, c_out) f32
// and live (splits, ceil(v_out / 64)) int32 scratch when splits > 1; out
// rows of ldo <= c_out columns (the first ldo of those computed: a ragged
// width padded to c_out)
template <typename Role>
int wgmma_entry(const void* feats, const void* w, const void* rb, const void* order,
                void* out, void* part, void* live, int v_out, int c_in, int c_out,
                int n_off, int splits, int ldo, void* stream) {
  namespace wg = taseg::wg;
  if (v_out <= 0 || c_in <= 0 || c_out <= 0 || c_in % 8 != 0 || c_out % 8 != 0 ||
      n_off <= 0 || n_off > 32 || splits < 1 || splits > wg::kMaxSplits ||
      (splits > 1 && (part == nullptr || live == nullptr)) || ldo <= 0 || ldo > c_out)
    return static_cast<int>(cudaErrorInvalidValue);
  return wg::with_tile(c_in, c_out, [&](auto bk, auto bn) {
    using T = wg::Tile<decltype(bk)::value, decltype(bn)::value>;
    return launch_wgmma<T, Role>(feats, w, rb, order, out, part, live, v_out, c_in,
                                 c_out, n_off, splits, static_cast<cudaStream_t>(stream), ldo);
  });
}

}  // namespace

extern "C" int taseg_sparse_conv_wgmma(const void* feats, const void* w, const void* rb,
                                       const void* order, void* out, void* part,
                                       void* live, int v_out, int c_in, int c_out,
                                       int n_off, int splits, int ldo, void* stream) {
  return wgmma_entry<K2Rows>(feats, w, rb, order, out, part, live, v_out, c_in, c_out,
                             n_off, splits, ldo, stream);
}

// K3-down's calls of the same route, over its child table (n_off = 8)
extern "C" int taseg_strided_down_wgmma(const void* feats, const void* w,
                                        const void* child, const void* order,
                                        void* out, void* part, void* live,
                                        int v_coarse, int c_in, int c_out,
                                        int n_off, int splits, int ldo, void* stream) {
  return wgmma_entry<DownSlots>(feats, w, child, order, out, part, live, v_coarse,
                                c_in, c_out, n_off, splits, ldo, stream);
}

// K3-up's calls of the same route, over its up table (n_off = 8; feats
// the coarse rows, out the fine ones)
extern "C" int taseg_strided_up_wgmma(const void* feats, const void* w, const void* up,
                                      const void* order, void* out, void* part, void* live,
                                      int v_fine, int c_in, int c_out, int n_off, int splits,
                                      int ldo, void* stream) {
  return wgmma_entry<UpSlots>(feats, w, up, order, out, part, live, v_fine, c_in, c_out,
                              n_off, splits, ldo, stream);
}

// resident blocks per SM of the wgmma route at these widths and offsets
// (the occupancy calculator, after the shared-memory attribute is set)
extern "C" int taseg_sparse_conv_wgmma_blocks(int c_in, int c_out, int n_off,
                                              int* blocks) {
  namespace wg = taseg::wg;
  if (c_in <= 0 || c_out <= 0 || n_off <= 0 || n_off > 32 || blocks == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return wg::with_tile(c_in, c_out, [&](auto bk, auto bn) {
    using T = wg::Tile<decltype(bk)::value, decltype(bn)::value>;
    const size_t bytes = wg::smem_bytes<T>(n_off);
    cudaError_t e = cudaFuncSetAttribute(sparse_conv_wgmma_kernel<T, K2Rows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(wg::smem_bytes<T>(32)));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, sparse_conv_wgmma_kernel<T, K2Rows>, wg::kThreads, bytes);
    return static_cast<int>(e);
  });
}
