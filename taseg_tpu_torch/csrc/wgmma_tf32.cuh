// Hopper tensor-core gather-GEMM tile on wgmma in f32, on 3xTF32: the f32
// route of K2 at K offsets (sparse_conv.cu: Cylinder3D's convs, every f32
// MinkUNet's 3^3 convs at K = 27, their input gradients) and of K3 both
// ways (the 8 slots of the level's child or up table).  It replaced the
// mma.sync m16n8k8 tile of gather_mma.cuh (namespace tf32, kept off the
// path as the yardstick `old_ms`).
//
// A block owns 64 consecutive entries of a row order (the table's rows
// sorted by their bitmask of present offsets, sparse_conv.mask_row_order)
// and BN <= 128 output columns, and runs, over the offsets j that some row
// of the tile needs, in stages of kBK = 32 input channels,
//
//   acc[r, :] += sum_j feats[idx[j][r]] @ W[j][:, n0 : n0 + BN]
//
// with each f32 product taken as three TF32 products: x = hi + lo, hi =
// cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), x*y ~ lo_x*hi_y + hi_x*lo_y
// + hi_x*hi_y (the lo*lo term, ~2^-22 of the product, is dropped).
//
// wgmma takes .tf32 operands only K-major, A and B both (the transposing
// layouts exist for 16-bit types alone), so:
//   * A, the gathered rows, is K-major already (a row's channels are
//     contiguous).  The producer copies each row's 32 channels (128 bytes)
//     by cp.async into the 128-byte swizzle; the consumer reads its
//     fragment of the raw f32 rows back from shared memory, splits it into
//     hi and lo in registers and issues wgmma with A from registers;
//   * B is the weight's (K, C_out, C_in) K-major form, split into its hi
//     and lo parts once per call (tf32_split_kernel, sparse_conv.cu: one
//     pass over W, any strides, that transposes and splits; a served
//     weight keeps its split operand, sparse_conv.tf32_operand).  W stored as
//     (C_in, C_out) (the forward) is transposed there; the input
//     gradient's W^T, read as W is stored, is K-major as it is.  The
//     producer copies B's hi and lo chunks (BN rows of 128 bytes each) by
//     cp.async into the same swizzle.
// Per stage and k8 step three wgmma m64nBNk8 (lo*hi, hi*lo, hi*hi: small
// terms first) into a stage accumulator, the first of the stage with
// scale-d = 0 (which zeroes it), then added to the running sum with
// rounded f32 adds: the tensor cores' f32 accumulation does not round to
// nearest, and over a whole chain (the 3^3 head's 27 offsets x 4 chunks)
// its error reached 1e-5 of the largest sum of |terms| on the mma.sync
// tile; per stage it is 12 adds.  So a thread holds BN / 2 accumulators
// twice (the running sum and the stage's) and 32 A registers: BN is
// capped at 128 (a 256- or 512-wide conv runs 2 or 4 column blocks and
// gathers its rows once per block, as the mma.sync tile did), and tiles
// of BN <= 64 run two blocks an SM (one block's wait is the other's
// wgmma).
//
// Roles and ring as wgmma_tile.cuh: warpgroup 0 consumes, warpgroup 1
// produces, kStages stages with a "full" (128 cp.async arrivals) and an
// "empty" (4 consumer warps) mbarrier each.  The consumer issues stage i
// after stage i - 1's products are done (wgmma.wait_group 0), since both
// share the stage accumulator.  Layout of a stage (1024-byte aligned): A
// (64 rows x 128 B), B hi (BN rows x 128 B), B lo (the same), each row's
// 16-byte chunk c at c ^ (row % 8); descriptors K-major, swizzle 128,
// stride one 8-row group (1024 B), each k8 step 32 bytes further.
//
// Needs f32, C_in % 4 == 0, C_out % 4 == 0 (the wrappers pad ragged
// widths), 16-byte aligned feats, 1 <= K <= 32 offsets; the output rows
// may be narrower (ldo <= C_out).
#pragma once

#include <stdint.h>

#include <type_traits>

#include "wgmma_tile.cuh"

namespace taseg {
namespace wt {

constexpr int kBM = wg::kBM;        // order entries (output rows) per tile
constexpr int kBK = 32;             // f32 input channels per stage
constexpr int kRow = kBK * 4;       // bytes of a staged row: the swizzle width
constexpr int kStages = 4;          // ring depth
constexpr int kConsumers = 128;     // warpgroup 0: wgmma
constexpr int kThreads = 256;       // + warpgroup 1: cp.async
constexpr int kProducers = kThreads - kConsumers;
constexpr int kMaxBN = 128;

template <int BN_>
struct Tile {
  static constexpr int BN = BN_;
  static constexpr int A_BYTES = kBM * kRow;
  static constexpr int B_BYTES = BN * kRow;  // one of B's two parts
  static constexpr int STAGE = A_BYTES + 2 * B_BYTES;
  // blocks an SM: the narrow tiles fit two (registers and shared memory)
  static constexpr int MIN_BLOCKS = BN <= 64 ? 2 : 1;
  static_assert(BN % 16 == 0 && BN <= kMaxBN, "BN");
  static_assert(STAGE % 1024 == 0, "stage alignment");
};

// f(std::integral_constant<int, BN>{}) with the output columns per block
// for a conv of c_out columns (wider convs take several 128-wide blocks)
template <typename F>
int with_tile(int c_out, F&& f) {
  if (c_out <= 16) return f(std::integral_constant<int, 16>{});
  if (c_out <= 32) return f(std::integral_constant<int, 32>{});
  if (c_out <= 64) return f(std::integral_constant<int, 64>{});
  if (c_out <= 96) return f(std::integral_constant<int, 96>{});
  return f(std::integral_constant<int, 128>{});
}

template <typename T>
constexpr size_t smem_bytes(int n_off) {
  return 1024 + static_cast<size_t>(kStages) * T::STAGE + 2 * kStages * 8 +
         static_cast<size_t>(n_off) * kBM * 4 + kBM * 4 + 32 * 4 + 8 * 4;
}

// the ring at s.a ([kStages][STAGE]); s.b unused
template <typename T>
__device__ __forceinline__ wg::Smem carve(unsigned char* raw, int n_off) {
  const uint32_t base = wg::smem_addr(raw);
  unsigned char* p = raw + (((base + 1023u) & ~1023u) - base);
  wg::Smem s;
  s.a = wg::smem_addr(p);
  s.b = s.a;
  p += kStages * T::STAGE;
  s.full = reinterpret_cast<uint64_t*>(p);
  s.empty = s.full + kStages;
  p += 2 * kStages * 8;
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
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

__device__ __forceinline__ float lds(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr) : "memory");
  return x;
}

// keep A fragments in their registers while an async wgmma reads them
__device__ __forceinline__ void fence_a(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// N = 16: 8 accumulators
#define TASEG_WGMMA_REGS_16 "%0, %1, %2, %3, %4, %5, %6, %7"
#define TASEG_WGMMA_OPS_16(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])

// d (64 x N f32) = (scale_d ? d : 0) + A (64 x 8 tf32, registers: this
// thread's a0-a3 at rows g, g + 8 and columns t, t + 4 of its warp's 16
// rows, g = lane / 4, t = lane % 4) @ B (8 x N tf32, K-major, shared)
template <int N>
struct Mma;

#define TASEG_WGMMA_TF32(N, A0, A1, A2, A3, IB, IS)                                 \
  template <>                                                                       \
  struct Mma<N> {                                                                   \
    __device__ __forceinline__ static void run(float (&d)[N / 2], const uint32_t (&a)[4], \
                                               uint64_t b, int scale_d) {           \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {"      \
                   TASEG_WGMMA_REGS_##N "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3   \
                   "}, %" #IB ", p, 1, 1;\n}\n"                                     \
                   : TASEG_WGMMA_OPS_##N(d)                                         \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)); \
    }                                                                               \
  };

TASEG_WGMMA_TF32(16, 8, 9, 10, 11, 12, 13)
TASEG_WGMMA_TF32(32, 16, 17, 18, 19, 20, 21)
TASEG_WGMMA_TF32(64, 32, 33, 34, 35, 36, 37)
TASEG_WGMMA_TF32(96, 48, 49, 50, 51, 52, 53)
TASEG_WGMMA_TF32(128, 64, 65, 66, 67, 68, 69)
#undef TASEG_WGMMA_TF32

// producer warpgroup: stages [t0, t1) of the chain into the ring.  whi /
// wlo: B's parts, (K, c_out, c_in) f32 each
template <typename T>
__device__ __forceinline__ void produce(const wg::Smem& s, int t0, int t1, const float* feats,
                                        const float* whi, const float* wlo, int c_in, int c_out,
                                        int n0) {
  const int pt = threadIdx.x - kConsumers;
  const int chunks = (c_in + kBK - 1) / kBK;
  for (int i = 0; i < t1 - t0; ++i) {
    const int st = i % kStages;
    wg::mbar_wait(s.empty + st, ((i / kStages) & 1) ^ 1);
    const int g = t0 + i, j = s.list[g / chunks], c0 = (g % chunks) * kBK;
    const uint32_t a = s.a + st * T::STAGE, bh = a + T::A_BYTES, bl = bh + T::B_BYTES;
    const int* idx = s.idx + j * kBM;
#pragma unroll
    for (int e = pt; e < kBM * 8; e += kProducers) {
      const int r = e / 8, cc = e % 8, c = c0 + cc * 4, src = idx[r];
      const bool ok = src >= 0 && c < c_in;
      wg::cp_async16(a + r * kRow + (wg::swz<kRow>(r, cc) << 4),
                     ok ? feats + static_cast<size_t>(src) * c_in + c : feats, ok);
    }
    const size_t wj = static_cast<size_t>(j) * c_out * c_in;
#pragma unroll
    for (int e = pt; e < T::BN * 8; e += kProducers) {
      const int n = e / 8, cc = e % 8, col = n0 + n, c = c0 + cc * 4;
      const bool ok = col < c_out && c < c_in;
      const size_t off = wj + static_cast<size_t>(col) * c_in + c;
      const uint32_t d = n * kRow + (wg::swz<kRow>(n, cc) << 4);
      wg::cp_async16(bh + d, ok ? whi + off : whi, ok);
      wg::cp_async16(bl + d, ok ? wlo + off : wlo, ok);
    }
    wg::cp_async_arrive(s.full + st);
  }
}

// consumer warpgroup: acc += the n stages of the ring, each stage's 12
// products summed in their own accumulator first
template <typename T>
__device__ __forceinline__ void consume(const wg::Smem& s, int n, float (&acc)[T::BN / 2]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16 + g, r1 = r0 + 8;
  float part[T::BN / 2];
  uint32_t ah[4][4], al[4][4];
  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    wg::mbar_wait(s.full + st, (i / kStages) & 1);
    __syncwarp();  // wgmma's .aligned needs the warp converged
    if (i > 0) {
      wg::wgmma_wait<0>();  // stage i - 1's products: its part and A registers are free
      wg::fence_regs(part);
      fence_a(ah);
      fence_a(al);
#pragma unroll
      for (int q = 0; q < T::BN / 2; ++q) acc[q] += part[q];
      if (lane == 0) wg::mbar_arrive(s.empty + (i - 1) % kStages);
    }
    const uint32_t a = s.a + st * T::STAGE, bh = a + T::A_BYTES, bl = bh + T::B_BYTES;
    // this thread's A fragment of each k8 step: rows r0, r1, columns
    // 8 kk + t and 8 kk + t + 4 (16-byte chunks 2 kk and 2 kk + 1)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t c0 = (wg::swz<kRow>(r0, 2 * kk) << 4) + t * 4;
      const uint32_t c1 = (wg::swz<kRow>(r0, 2 * kk + 1) << 4) + t * 4;
      const uint32_t d0 = (wg::swz<kRow>(r1, 2 * kk) << 4) + t * 4;
      const uint32_t d1 = (wg::swz<kRow>(r1, 2 * kk + 1) << 4) + t * 4;
      split(lds(a + r0 * kRow + c0), ah[kk][0], al[kk][0]);
      split(lds(a + r1 * kRow + d0), ah[kk][1], al[kk][1]);
      split(lds(a + r0 * kRow + c1), ah[kk][2], al[kk][2]);
      split(lds(a + r1 * kRow + d1), ah[kk][3], al[kk][3]);
    }
    __syncwarp();
    wg::fence_proxy_async();
    wg::fence_regs(part);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dh = wg::make_desc(bh + kk * 32, 16, 8 * kRow, kRow);
      const uint64_t dl = wg::make_desc(bl + kk * 32, 16, 8 * kRow, kRow);
      Mma<T::BN>::run(part, al[kk], dh, kk > 0);
      Mma<T::BN>::run(part, ah[kk], dl, 1);
      Mma<T::BN>::run(part, ah[kk], dh, 1);
    }
    wg::wgmma_commit();
  }
  if (n > 0) {
    wg::wgmma_wait<0>();
    wg::fence_regs(part);
    fence_a(ah);
    fence_a(al);
#pragma unroll
    for (int q = 0; q < T::BN / 2; ++q) acc[q] += part[q];
  }
}

// store the consumer's accumulators of the tile rows r with s.rows[r] >= 0
// at their output rows, or, with `at` >= 0, at rows at + r (a split's
// partial, in order positions); rows of `ld` columns, the first ld of
// those computed (a ragged width padded by the wrapper is written at its
// own width)
template <int BN>
__device__ __forceinline__ void store(const wg::Smem& s, const float (&acc)[BN / 2],
                                      float* __restrict__ out, int ld, int n0, int at) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + lane / 4 + 8 * h;
    int row = s.rows[r];
    if (at >= 0 && row >= 0) row = at + r;
    if (row < 0) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + (lane % 4) * 2;
      if (col >= ld) continue;
      const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
      float* o = out + static_cast<size_t>(row) * ld + col;
      if (ld % 2 == 0) {  // col even: col + 1 < ld, 8-byte aligned
        *reinterpret_cast<float2*>(o) = make_float2(x, y);
      } else {
        o[0] = x;
        if (col + 1 < ld) o[1] = y;
      }
    }
  }
}

}  // namespace wt
}  // namespace taseg
