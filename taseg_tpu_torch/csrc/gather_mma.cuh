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
// (the wrappers pad other widths).
//
// namespace tf32 below is the same tile in f32 for the conv over K
// offsets (K2 at K, and the helpers of K4 at K in conv_dw.cu), on 3xTF32:
//   * 16-byte cp.async of 4 f32 per row chunk, zero-filled for absent
//     rows, in a ring of ST stages of BK input channels (Tile; K2 at K
//     runs 3 stages of 32, which tools/k2k_tiles.py chose);
//   * mma.sync m16n8k8 .tf32 with f32 accumulators.  Each operand x is
//     split as hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), and each
//     product is taken as lo*hi + hi*lo + hi*hi (the lo*lo term, ~2^-22
//     of the product, is dropped): ~21 bits per product, within the f32
//     tolerance where one TF32 pass (~11 bits) is not;
//   * operands read from shared memory by 32-bit loads: rows padded by 4
//     floats (A, row-major over channels) or 8 floats (B, over columns),
//     so the 32 lanes of a fragment load hit 32 distinct banks;
//   * tile width 32, 64 or 128 from C_out (with_tile_n_f32).
// Needs C_in % 4 == 0, C_out % 4 == 0 and 16-byte aligned feats and W.
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

namespace tf32 {

constexpr int kBM = 64;        // output rows per block
constexpr int kThreads = 128;  // 4 warps: 2 (rows) x 2 (columns)

// A tile shape: BN output columns, BK input channels per stage, a ring of
// ST stages
// floats per shared row of a BN-wide B operand
template <int BN>
__host__ __device__ constexpr int b_stride() {
  return BN + 8;
}

template <int BN_, int BK_, int ST_>
struct Tile {
  static constexpr int BN = BN_, BK = BK_, ST = ST_;
  static constexpr int AS = BK + 4;  // floats per shared A row
  static constexpr int BS = b_stride<BN>();
};

// f(std::integral_constant<int, BN>{}) with the output columns per block
// for a conv of c_out columns (wider convs take several 128-wide blocks)
template <typename F>
int with_tile_n_f32(int c_out, F&& f) {
  if (c_out <= 32) return f(std::integral_constant<int, 32>{});
  if (c_out <= 64) return f(std::integral_constant<int, 64>{});
  return f(std::integral_constant<int, 128>{});
}

template <typename T>
constexpr size_t smem_bytes(int n_off) {
  return static_cast<size_t>(T::ST) * kBM * T::AS * 4 +
         static_cast<size_t>(T::ST) * T::BK * T::BS * 4 +
         static_cast<size_t>(n_off) * kBM * 4 + kBM * 4 + 32 * 4 + 4 * 4;
}

struct Smem {
  float* a;         // [ST][kBM][AS]
  float* b;         // [ST][BK][BS]
  int* idx;         // [n_off][kBM]
  int* rows;        // [kBM] output row of each tile row, -1 past V_out
  int* list;        // [32] offsets present in the tile, ascending
  unsigned* wmask;  // [4] per-warp presence masks
};

template <typename T>
__device__ __forceinline__ Smem carve(unsigned char* p, int n_off) {
  Smem s;
  s.a = reinterpret_cast<float*>(p);
  p += T::ST * kBM * T::AS * 4;
  s.b = reinterpret_cast<float*>(p);
  p += T::ST * T::BK * T::BS * 4;
  s.idx = reinterpret_cast<int*>(p);
  p += n_off * kBM * 4;
  s.rows = reinterpret_cast<int*>(p);
  p += kBM * 4;
  s.list = reinterpret_cast<int*>(p);
  p += 32 * 4;
  s.wmask = reinterpret_cast<unsigned*>(p);
  return s;
}

// x = hi + lo, each rounded to TF32 (nearest, ties away)
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// d += a (16x8, row) @ b (8x8, col) in TF32, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a @ b on 3xTF32 from the split operands: small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const unsigned (&ah)[4],
                                           const unsigned (&al)[4],
                                           const unsigned (&bh)[2],
                                           const unsigned (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// After s.idx is filled and a __syncthreads: the offsets some row of the
// tile needs, ascending in s.list; returns their number (as
// mma::present_offsets)
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

// issue the cp.asyncs of one stage: offset j, channels [c0, c0 + BK)
template <typename T>
__device__ __forceinline__ void load_stage(const Smem& s, int buf, int j, int c0,
                                           const float* feats, const float* w,
                                           int c_in, int c_out, int n0) {
  constexpr int kAChunks = T::BK / 4, kBChunks = T::BN / 4;
  float* a = s.a + buf * kBM * T::AS;
  float* b = s.b + buf * T::BK * T::BS;
  const int* idx = s.idx + j * kBM;
#pragma unroll
  for (int e = threadIdx.x; e < kBM * kAChunks; e += kThreads) {
    const int r = e / kAChunks, cc = (e % kAChunks) * 4, c = c0 + cc;
    const int src = idx[r];
    const bool ok = src >= 0 && c < c_in;
    mma::cp_async16(a + r * T::AS + cc,
                    ok ? feats + static_cast<size_t>(src) * c_in + c : feats, ok);
  }
  const float* wj = w + static_cast<size_t>(j) * c_in * c_out;
#pragma unroll
  for (int e = threadIdx.x; e < T::BK * kBChunks; e += kThreads) {
    const int kk = e / kBChunks, cc = (e % kBChunks) * 4;
    const int c = c0 + kk, col = n0 + cc;
    const bool ok = c < c_in && col < c_out;
    mma::cp_async16(b + kk * T::BS + cc,
                    ok ? wj + static_cast<size_t>(c) * c_out + col : w, ok);
  }
}

// acc += A(stage buf) @ B(stage buf) for this warp's 32 x BN/2 sub-tile.
// Fragments of m16n8k8 .tf32 (g = lane / 4, t = lane % 4): A (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); B (k t, n g), (k t + 4, n g).
// A rows of BK + 4 floats (BK % 32 == 16 or 0: 4 mod 32 banks apart) and
// B rows of BN + 8 (8 mod 32) put the 32 lanes of a load on 32 banks.
// The stage's products go into accumulators of their own, added to acc
// with rounded f32 adds: the tensor cores' f32 accumulation does not
// round to nearest, and over a whole chain (the 3^3 head's 27 offsets x
// 4 chunks: 1296 mma adds into one accumulator) its error grew to 1e-5
// of the largest sum of |terms| (Waymo Cylinder's 128 -> 23 head, halved
// by each halving of the chain); per stage it is 12 adds.
template <typename T>
__device__ __forceinline__ void mma_stage(const Smem& s, int buf,
                                          float (&acc)[2][T::BN / 16][4]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2, g = lane / 4, t = lane % 4;
  const float* a = s.a + buf * kBM * T::AS + (wm * 32 + g) * T::AS + t;
  const float* b = s.b + buf * T::BK * T::BS + t * T::BS + wn * (T::BN / 2) + g;
  float part[2][T::BN / 16][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < T::BN / 16; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
#pragma unroll
  for (int kk = 0; kk < T::BK; kk += 8) {
    unsigned ah[2][4], al[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* p = a + i * 16 * T::AS + kk;
      split(p[0], ah[i][0], al[i][0]);
      split(p[8 * T::AS], ah[i][1], al[i][1]);
      split(p[4], ah[i][2], al[i][2]);
      split(p[8 * T::AS + 4], ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < T::BN / 16; ++j) {
      const float* p = b + kk * T::BS + j * 8;
      unsigned bh[2], bl[2];
      split(p[0], bh[0], bl[0]);
      split(p[4 * T::BS], bh[1], bl[1]);
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_3xtf32(part[i][j], ah[i], al[i], bh, bl);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < T::BN / 16; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
}

// the mainloop over stages [t0, t1) of the tile's chain (present offset)
// x (C_in chunk), ST deep
template <typename T>
__device__ __forceinline__ void gather_mma_tile(const Smem& s, int t0, int t1,
                                                const float* feats, const float* w,
                                                int c_in, int c_out, int n0,
                                                float (&acc)[2][T::BN / 16][4]) {
  const int chunks = (c_in + T::BK - 1) / T::BK;
  const int total = t1 - t0;
#pragma unroll
  for (int t = 0; t < T::ST - 1; ++t) {
    const int g = t0 + t;
    if (t < total)
      load_stage<T>(s, t, s.list[g / chunks], (g % chunks) * T::BK, feats, w, c_in,
                    c_out, n0);
    mma::cp_async_commit();
  }
  for (int t = 0; t < total; ++t) {
    mma::cp_async_wait<T::ST - 2>();  // stage t has landed (own part)
    __syncthreads();  // ... everyone's part; and stage t-1 is consumed
    const int nxt = t + T::ST - 1, g = t0 + nxt;
    if (nxt < total)
      load_stage<T>(s, nxt % T::ST, s.list[g / chunks], (g % chunks) * T::BK,
                    feats, w, c_in, c_out, n0);
    mma::cp_async_commit();
    mma_stage<T>(s, t % T::ST, acc);
  }
  mma::cp_async_wait<0>();
}

// store the tile's rows r (s.rows[r] >= 0) at their output rows, or,
// with `at` >= 0, at rows at + r (a split's partial, in order positions);
// rows of `ld` columns, the first ld of those computed (a ragged width
// padded by the wrapper is written at its own width)
template <int BN>
__device__ __forceinline__ void store_rows(const Smem& s,
                                           const float (&acc)[2][BN / 16][4],
                                           float* __restrict__ out, int ld,
                                           int n0, int at = -1) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wm * 32 + i * 16 + lane / 4;
    int row0 = s.rows[r], row1 = s.rows[r + 8];
    if (at >= 0) {
      row0 = row0 >= 0 ? at + r : -1;
      row1 = row1 >= 0 ? at + r + 8 : -1;
    }
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int col = n0 + wn * (BN / 2) + j * 8 + (lane % 4) * 2;
      if (col >= ld) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = h ? row1 : row0;
        if (row < 0) continue;
        float* o = out + static_cast<size_t>(row) * ld + col;
        if (ld % 2 == 0) {  // col even: col + 1 < ld, 8-byte aligned
          *reinterpret_cast<float2*>(o) = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          o[0] = acc[i][j][2 * h];
          if (col + 1 < ld) o[1] = acc[i][j][2 * h + 1];
        }
      }
    }
  }
}

}  // namespace tf32
}  // namespace taseg
