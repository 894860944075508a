// Tensor-core gather-GEMM tile, shared by the bf16 routes of K2
// (sparse_conv.cu) and of both directions of K3 (strided_conv.cu).
//
// A block of kThreads owns a kBM x BN output tile.  Its kernel first
// fills a shared table idx[j][r] (j < n_off offsets, r < kBM rows) with
// the input row that output row r takes at offset j, -1 for none; the
// tile then accumulates, in f32 registers,
//
//   acc[r, :] += sum_j feats[idx[j][r]] @ W[j][:, n0 : n0 + BN]
//
// over the offsets that some row of the tile needs, in stages of kBK
// input channels:
//   * A stage: the gathered rows, 16 bytes per cp.async; an absent row
//     or a channel past C_in copies 0 source bytes, which zero-fills the
//     destination without a branch or a memset.
//   * B stage: the contiguous weight chunk W[j][c0 : c0 + kBK, n0 : n0+BN]
//     by cp.async, zero past C_in and C_out.
//   * a ring of kStages stages (commit_group / wait_group): the gathers
//     of stage t + kStages - 1 are in flight while stage t is multiplied.
//   * mma.sync m16n8k16 bf16 x bf16 -> f32 on fragments read by ldmatrix
//     (B with .trans: W is stored (C_in, C_out), N contiguous).  Each
//     shared row is padded by 8 bf16 (16 bytes), so the 8 row addresses
//     of one ldmatrix phase fall on 8 distinct 4-bank groups.
// Four warps split the tile 2 (rows) x 2 (columns): each holds 32 rows x
// BN/2 columns of accumulators.  BN is 32, 64, 96 or 128 (with_tile_n), so a
// 32- or 96-wide conv is not padded to 64 or 128 columns.
//
// Needs C_in % 8 == 0, C_out % 8 == 0 and 16-byte aligned feats and W
// (the wrappers route other widths to the SIMT kernels).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace taseg {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;        // output rows per block
constexpr int kBK = 32;        // input channels per stage
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kThreads = 128;  // 4 warps: 2 (rows) x 2 (columns)
constexpr int kPad = 8;        // bf16 of padding per shared row
constexpr int kAStride = kBK + kPad;

// f(std::integral_constant<int, BN>{}) with the output columns per block
// for a conv of c_out columns (256 columns take two 128-wide blocks)
template <typename F>
int with_tile_n(int c_out, F&& f) {
  if (c_out <= 32) return f(std::integral_constant<int, 32>{});
  if (c_out <= 64) return f(std::integral_constant<int, 64>{});
  if (c_out <= 96) return f(std::integral_constant<int, 96>{});
  return f(std::integral_constant<int, 128>{});
}

template <int BN>
constexpr size_t smem_bytes(int n_off) {
  return static_cast<size_t>(kStages) * kBM * kAStride * 2 +
         static_cast<size_t>(kStages) * kBK * (BN + kPad) * 2 +
         static_cast<size_t>(n_off) * kBM * 4 + 32 * 4 + 4 * 4;
}

// views of one block's dynamic shared memory
struct Smem {
  bf16* a;          // [kStages][kBM][kAStride]
  bf16* b;          // [kStages][kBK][BN + kPad]
  int* idx;         // [n_off][kBM]
  int* list;        // [32] offsets present in the tile, ascending
  unsigned* wmask;  // [4] per-warp presence masks
};

template <int BN>
__device__ __forceinline__ Smem carve(unsigned char* p, int n_off) {
  Smem s;
  s.a = reinterpret_cast<bf16*>(p);
  p += kStages * kBM * kAStride * 2;
  s.b = reinterpret_cast<bf16*>(p);
  p += kStages * kBK * (BN + kPad) * 2;
  s.idx = reinterpret_cast<int*>(p);
  p += n_off * kBM * 4;
  s.list = reinterpret_cast<int*>(p);
  p += 32 * 4;
  s.wmask = reinterpret_cast<unsigned*>(p);
  return s;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_size 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16x16, row) @ b (16x8, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// After the caller filled s.idx and passed a __syncthreads: the offsets
// that some row of the tile needs, ascending in s.list; returns their
// number.  kBM is a multiple of 32, so every warp's 32 entries share one
// offset and the ballot is warp-uniform.
__device__ __forceinline__ int present_offsets(const Smem& s, int n_off) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  unsigned mine = 0;
  for (int e = threadIdx.x; e < n_off * kBM; e += kThreads) {
    if (__ballot_sync(0xffffffffu, s.idx[e] >= 0)) mine |= 1u << (e / kBM);
  }
  if (lane == 0) s.wmask[warp] = mine;
  __syncthreads();
  const unsigned m = s.wmask[0] | s.wmask[1] | s.wmask[2] | s.wmask[3];
  const int t = threadIdx.x;
  if (t < n_off && ((m >> t) & 1u)) s.list[__popc(m & ((1u << t) - 1u))] = t;
  __syncthreads();
  return __popc(m);
}

// issue the cp.asyncs of one stage: offset j, channels [c0, c0 + kBK)
template <int BN>
__device__ __forceinline__ void load_stage(const Smem& s, int buf, int j,
                                           int c0, const bf16* feats,
                                           const bf16* w, int c_in, int c_out,
                                           int n0) {
  constexpr int kBS = BN + kPad, kAChunks = kBK / 8, kBChunks = BN / 8;
  bf16* a = s.a + buf * kBM * kAStride;
  bf16* b = s.b + buf * kBK * kBS;
  const int* idx = s.idx + j * kBM;
#pragma unroll
  for (int e = threadIdx.x; e < kBM * kAChunks; e += kThreads) {
    const int r = e / kAChunks, cc = (e % kAChunks) * 8, c = c0 + cc;
    const int src = idx[r];
    const bool ok = src >= 0 && c < c_in;
    cp_async16(a + r * kAStride + cc,
               ok ? feats + static_cast<size_t>(src) * c_in + c : feats, ok);
  }
  const bf16* wj = w + static_cast<size_t>(j) * c_in * c_out;
#pragma unroll
  for (int e = threadIdx.x; e < kBK * kBChunks; e += kThreads) {
    const int kk = e / kBChunks, cc = (e % kBChunks) * 8;
    const int c = c0 + kk, col = n0 + cc;
    const bool ok = c < c_in && col < c_out;
    cp_async16(b + kk * kBS + cc,
               ok ? wj + static_cast<size_t>(c) * c_out + col : w, ok);
  }
}

// acc += A(stage buf) @ B(stage buf) for this warp's 32 x BN/2 sub-tile
template <int BN>
__device__ __forceinline__ void mma_stage(const Smem& s, int buf,
                                          float (&acc)[2][BN / 16][4]) {
  constexpr int kBS = BN + kPad;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;
  // ldmatrix x4: lanes 0-15 address rows 0-15 at column 0, lanes 16-31
  // the same rows at column 8
  const bf16* a = s.a + buf * kBM * kAStride +
                  (wm * 32 + lane % 16) * kAStride + (lane / 16) * 8;
  const bf16* b = s.b + buf * kBK * kBS + (lane % 16) * kBS + wn * (BN / 2) +
                  (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    unsigned af[2][4];
    ldmatrix_x4(af[0], a + kk);
    ldmatrix_x4(af[1], a + 16 * kAStride + kk);
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      // k 0-7 / 8-15 of columns j*16 + 0-7, then of j*16 + 8-15
      unsigned bf[4];
      ldmatrix_x4_trans(bf, b + kk * kBS + j * 16);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(acc[i][2 * j], af[i], bf[0], bf[1]);
        mma_bf16(acc[i][2 * j + 1], af[i], bf[2], bf[3]);
      }
    }
  }
}

// the whole mainloop: stages (present offset) x (C_in chunk), kStages deep
template <int BN>
__device__ __forceinline__ void gather_mma_tile(const Smem& s, int n_present,
                                                const bf16* feats,
                                                const bf16* w, int c_in,
                                                int c_out, int n0,
                                                float (&acc)[2][BN / 16][4]) {
  const int chunks = (c_in + kBK - 1) / kBK;
  const int total = n_present * chunks;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < total)
      load_stage<BN>(s, t, s.list[t / chunks], (t % chunks) * kBK, feats, w,
                     c_in, c_out, n0);
    cp_async_commit();
  }
  for (int t = 0; t < total; ++t) {
    cp_async_wait<kStages - 2>();  // stage t has landed (this thread's part)
    __syncthreads();  // ... everyone's part; and stage t-1 is consumed
    const int nxt = t + kStages - 1;
    if (nxt < total)
      load_stage<BN>(s, nxt % kStages, s.list[nxt / chunks],
                     (nxt % chunks) * kBK, feats, w, c_in, c_out, n0);
    cp_async_commit();
    mma_stage<BN>(s, t % kStages, acc);
  }
  cp_async_wait<0>();
}

// round once to bf16 and store the rows < `rows` of the tile
template <int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[2][BN / 16][4],
                                           bf16* __restrict__ out, int rows,
                                           int c_out, int m0, int n0) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + wm * 32 + i * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int col = n0 + wn * (BN / 2) + j * 8 + (lane % 4) * 2;
      if (col >= c_out) continue;
      if (r < rows)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(r) * c_out +
                                           col) =
            __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
      if (r + 8 < rows)
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<size_t>(r + 8) * c_out + col) =
            __floats2bfloat162_rn(acc[i][j][2], acc[i][j][3]);
    }
  }
}

// Launch kernel<<<(ceil(rows / kBM), ceil(c_out / BN)), kThreads, smem>>>
// after raising its dynamic shared-memory limit; returns the CUDA error.
template <int BN, typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, int n_off, int rows, int c_out,
                 cudaStream_t stream, Args... args) {
  const size_t bytes = smem_bytes<BN>(n_off);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((rows + kBM - 1) / kBM, (c_out + BN - 1) / BN);
  kernel<<<grid, kThreads, bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma
}  // namespace taseg
