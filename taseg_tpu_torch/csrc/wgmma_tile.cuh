// Hopper tensor-core gather-GEMM tile on wgmma: the bf16 route of K2
// (sparse_conv.cu: the 3^3 conv and the conv over K <= 32 offsets) and
// of K3 (the 8 slots of the level's child table, K3-down, or of its up
// table, K3-up, as its offsets).
//
// A block owns 64 consecutive entries of a row order (the rows of the
// table sorted by their bitmask of present offsets,
// sparse_conv.mask_row_order), so rows with equal masks share a tile and
// the tile runs about the offsets its rows have:
//
//   acc[r, :] += sum_j feats[idx[j][r]] @ W[j][:, n0 : n0 + BN]
//
// over the offsets j that some row of the tile needs, in stages of BK
// input channels, and writes out[order[m0 + r]].  A tile of rows without
// offsets writes zeros.
//
// Roles: warpgroup 0 (threads 0-127) consumes, warpgroup 1 (128-255)
// produces, through a ring of kStages stages with a "full" and an
// "empty" mbarrier each:
//   * the producer gathers A (64 rows x BK channels, the rows that the
//     tile's idx table names at the stage's offset) and copies B (W[j]'s
//     BK x BN chunk) with 16-byte cp.async, zero-filled for absent rows
//     and past C_in / C_out (src-size 0), into the swizzled layouts the
//     wgmma descriptors name; each producer thread then signals the stage
//     with cp.async.mbarrier.arrive.noinc, which lands when its copies
//     have (full: 128 arrivals).  Hopper's TMA cannot gather rows, so A
//     stays on cp.async; B's chunk is BK rows of C_out contiguous columns
//     and would suit TMA, but one producer warpgroup copies it too;
//   * the consumer waits on full, orders the generic-proxy cp.async
//     writes before its async-proxy reads (fence.proxy.async), starts BK
//     / 16 wgmma.mma_async m64nBNk16 bf16 -> f32 (N = the whole C_out up
//     to 256: a 256-wide conv gathers each row chunk once), commits, and
//     after wgmma.wait_group 1 (the previous stage's products are done)
//     releases the previous stage (empty: one arrival per consumer warp).
// Layouts (a 1024-byte aligned ring):
//   * A, K-major: row r of BK bf16 at r * 2 BK bytes, its 16-byte chunk c
//     at chunk c ^ (bits 7.. of the row's byte offset): the 128-byte
//     swizzle at BK = 64, the 64-byte one at BK = 32 (C_in = 32, 96); the
//     descriptor's stride (SBO) is one 8-row group, 16 BK bytes; each
//     k16 step moves its start by 32 bytes;
//   * B, MN-major (W is stored (C_in, C_out), N contiguous; tnspB = 1):
//     atoms of AW columns x 8 K rows (AW = 64 at the 128-byte swizzle for
//     BN % 64 == 0, 32 at the 64-byte swizzle for BN = 32, 96), the atoms
//     of one column block contiguous along K (SBO = one atom) and the
//     column blocks BK rows apart (LBO); each k16 step moves its start by
//     two atoms.
// A chain of (present offset) x (C_in chunk) stages can be cut into
// gridDim.z equal parts, one block each (the coarse levels have too few
// tiles to fill the card); every part then writes f32 partials and
// wgmma_conv_reduce adds them in split order and rounds once, so the
// same inputs give the same bits.
//
// Needs bf16, C_in % 8 == 0, C_out % 8 == 0, 16-byte aligned feats and
// W, 1 <= K <= 32 offsets; the output rows may be narrower (ldo <= C_out:
// the wrappers pad a ragged width to the next multiple of 8).
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace taseg {
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;         // order entries (output rows) per tile
constexpr int kStages = 4;      // ring depth
constexpr int kConsumers = 128; // warpgroup 0: wgmma
constexpr int kThreads = 256;   // + warpgroup 1: cp.async
constexpr int kMaxSplits = 8;

// A tile shape: BK input channels per stage, BN output columns per block
template <int BK_, int BN_>
struct Tile {
  static constexpr int BK = BK_, BN = BN_;
  static constexpr int ASW = BK * 2;                 // A row bytes = its swizzle
  static constexpr int BSW = BN % 64 == 0 ? 128 : 64;  // B swizzle bytes
  static constexpr int AW = BSW / 2;                 // B columns per atom
  static constexpr int A_BYTES = kBM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static_assert(BK == 32 || BK == 64, "BK");
  static_assert(BN % AW == 0, "BN");
};

// f(std::integral_constant<int, BK>{}, std::integral_constant<int, BN>{})
// for a conv of c_in x c_out (wider than 256 columns: several 256-wide
// blocks)
template <typename F>
int with_tile(int c_in, int c_out, F&& f) {
  auto by_n = [&](auto bk) {
    if (c_out <= 32) return f(bk, std::integral_constant<int, 32>{});
    if (c_out <= 64) return f(bk, std::integral_constant<int, 64>{});
    if (c_out <= 96) return f(bk, std::integral_constant<int, 96>{});
    if (c_out <= 128) return f(bk, std::integral_constant<int, 128>{});
    return f(bk, std::integral_constant<int, 256>{});
  };
  if (c_in % 64 == 0) return by_n(std::integral_constant<int, 64>{});
  return by_n(std::integral_constant<int, 32>{});
}

template <typename T>
constexpr size_t smem_bytes(int n_off) {
  return 1024 + static_cast<size_t>(kStages) * (T::A_BYTES + T::B_BYTES) +
         2 * kStages * 8 + static_cast<size_t>(n_off) * kBM * 4 + kBM * 4 +
         32 * 4 + 8 * 4;
}

struct Smem {
  uint32_t a;       // shared address of the A ring [kStages][A_BYTES]
  uint32_t b;       // ... of the B ring [kStages][B_BYTES]
  uint64_t* full;   // [kStages]
  uint64_t* empty;  // [kStages]
  int* idx;         // [n_off][kBM]
  int* rows;        // [kBM] output row of each tile row, -1 past V_out
  int* list;        // [32] offsets present in the tile, ascending
  unsigned* wmask;  // [8] per-warp presence masks
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <typename T>
__device__ __forceinline__ Smem carve(unsigned char* raw, int n_off) {
  const uint32_t base = smem_addr(raw);
  unsigned char* p = raw + (((base + 1023u) & ~1023u) - base);
  Smem s;
  s.a = smem_addr(p);
  s.b = s.a + kStages * T::A_BYTES;
  p += kStages * (T::A_BYTES + T::B_BYTES);
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

// ---- barriers, copies, fences ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 bytes global -> shared; src_size 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// arrive on `bar` once this thread's earlier cp.asyncs have landed,
// counted against the barrier's expected arrivals
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulators across an async wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor: start, leading and stride byte
// offsets, swizzle (128 -> 1, 64 -> 2, 32 -> 3)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int swizzle) {
  const uint64_t layout = swizzle == 128 ? 1 : swizzle == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) | (layout << 62);
}

// the 16-byte chunk `c` of a row `r` of `bytes` (64 or 128) in a
// swizzled atom: address bits [4, 7) (or [4, 6)) XOR bits [7, 10) (or
// [7, 9)) of the row's offset
template <int BYTES>
__device__ __forceinline__ int swz(int r, int c) {
  return BYTES == 128 ? (c ^ (r & 7)) : (c ^ ((r >> 1) & 3));
}

// N = 32: 16 accumulators
#define TASEG_WGMMA_REGS_32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define TASEG_WGMMA_OPS_32(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// N = 64: 32 accumulators
#define TASEG_WGMMA_REGS_64 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define TASEG_WGMMA_OPS_64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// N = 96: 48 accumulators
#define TASEG_WGMMA_REGS_96 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define TASEG_WGMMA_OPS_96(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])

// N = 128: 64 accumulators
#define TASEG_WGMMA_REGS_128 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define TASEG_WGMMA_OPS_128(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// N = 256: 128 accumulators
#define TASEG_WGMMA_REGS_256 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define TASEG_WGMMA_OPS_256(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
  "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])


// d (64 x N f32, wgmma's fragment layout) += A (64 x 16, K-major) @ B
// (16 x N, MN-major) from shared memory
template <int N>
struct Mma;

#define TASEG_WGMMA(N, IA, IB, IS)                                              \
  template <>                                                                   \
  struct Mma<N> {                                                               \
    __device__ __forceinline__ static void run(float (&d)[N / 2], uint64_t a,   \
                                               uint64_t b) {                    \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"            \
                   "wgmma.mma_async.sync.aligned.m64n" #N                       \
                   "k16.f32.bf16.bf16 {" TASEG_WGMMA_REGS_##N                   \
                   "}, %" #IA ", %" #IB ", p, 1, 1, 0, 1;\n}\n"                 \
                   : TASEG_WGMMA_OPS_##N(d)                                     \
                   : "l"(a), "l"(b), "r"(1));                                   \
    }                                                                           \
  };

TASEG_WGMMA(32, 16, 17, 18)
TASEG_WGMMA(64, 32, 33, 34)
TASEG_WGMMA(96, 48, 49, 50)
TASEG_WGMMA(128, 64, 65, 66)
TASEG_WGMMA(256, 128, 129, 130)
#undef TASEG_WGMMA

// the same with A MN-major too (tnspA = 1: A's M index contiguous, as the
// X^T of a weight gradient whose rows are gathered pair by pair, K4 and
// K5, conv_dw.cu)
template <int N>
struct MmaTA;

#define TASEG_WGMMA_TA(N, IA, IB, IS)                                           \
  template <>                                                                   \
  struct MmaTA<N> {                                                             \
    __device__ __forceinline__ static void run(float (&d)[N / 2], uint64_t a,   \
                                               uint64_t b) {                    \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"            \
                   "wgmma.mma_async.sync.aligned.m64n" #N                       \
                   "k16.f32.bf16.bf16 {" TASEG_WGMMA_REGS_##N                   \
                   "}, %" #IA ", %" #IB ", p, 1, 1, 1, 1;\n}\n"                 \
                   : TASEG_WGMMA_OPS_##N(d)                                     \
                   : "l"(a), "l"(b), "r"(1));                                   \
    }                                                                           \
  };

TASEG_WGMMA_TA(32, 16, 17, 18)
TASEG_WGMMA_TA(64, 32, 33, 34)
TASEG_WGMMA_TA(96, 48, 49, 50)
TASEG_WGMMA_TA(128, 64, 65, 66)
TASEG_WGMMA_TA(256, 128, 129, 130)
#undef TASEG_WGMMA_TA

// ---- the tile ----

// After s.idx is filled and a __syncthreads: the offsets that some row of
// the tile needs, ascending in s.list; returns their number.  kBM is a
// multiple of 32, so every warp's 32 entries share one offset.
__device__ __forceinline__ int present_offsets(const Smem& s, int n_off) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  unsigned mine = 0;
  for (int e = threadIdx.x; e < n_off * kBM; e += kThreads) {
    if (__ballot_sync(0xffffffffu, s.idx[e] >= 0)) mine |= 1u << (e / kBM);
  }
  if (lane == 0) s.wmask[warp] = mine;
  __syncthreads();
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) m |= s.wmask[i];
  const int t = threadIdx.x;
  if (t < n_off && ((m >> t) & 1u)) s.list[__popc(m & ((1u << t) - 1u))] = t;
  __syncthreads();
  return __popc(m);
}

// producer warpgroup: stages [t0, t1) of the chain into the ring
template <typename T>
__device__ __forceinline__ void produce(const Smem& s, int t0, int t1, const bf16* feats,
                                        const bf16* w, int c_in, int c_out, int n0) {
  constexpr int AC = T::BK / 8, BC = T::BN / 8, ATOM_C = T::AW / 8;
  const int pt = threadIdx.x - kConsumers;
  const int chunks = (c_in + T::BK - 1) / T::BK;
  for (int i = 0; i < t1 - t0; ++i) {
    const int st = i % kStages;
    mbar_wait(s.empty + st, ((i / kStages) & 1) ^ 1);
    const int g = t0 + i, j = s.list[g / chunks], c0 = (g % chunks) * T::BK;
    const uint32_t a = s.a + st * T::A_BYTES, b = s.b + st * T::B_BYTES;
    const int* idx = s.idx + j * kBM;
#pragma unroll
    for (int e = pt; e < kBM * AC; e += kThreads - kConsumers) {
      const int r = e / AC, cc = e % AC, c = c0 + cc * 8, src = idx[r];
      const bool ok = src >= 0 && c < c_in;
      cp_async16(a + r * T::ASW + (swz<T::ASW>(r, cc) << 4),
                 ok ? feats + static_cast<size_t>(src) * c_in + c : feats, ok);
    }
    const bf16* wj = w + static_cast<size_t>(j) * c_in * c_out;
#pragma unroll 4
    for (int e = pt; e < T::BK * BC; e += kThreads - kConsumers) {
      const int k = e / BC, nc = e % BC, c = c0 + k, col = n0 + nc * 8;
      const bool ok = c < c_in && col < c_out;
      const int atom = nc / ATOM_C, kr = k % 8;
      cp_async16(b + (atom * (T::BK / 8) + k / 8) * (8 * T::BSW) + kr * T::BSW +
                     (swz<T::BSW>(kr, nc % ATOM_C) << 4),
                 ok ? wj + static_cast<size_t>(c) * c_out + col : w, ok);
    }
    cp_async_arrive(s.full + st);
  }
}

// consumer warpgroup: acc += the n stages of the ring
template <typename T>
__device__ __forceinline__ void consume(const Smem& s, int n, float (&acc)[T::BN / 2]) {
  const int lane = threadIdx.x % 32;
  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    mbar_wait(s.full + st, (i / kStages) & 1);
    __syncwarp();  // wgmma's .aligned needs the warp converged
    fence_proxy_async();
    const uint32_t a = s.a + st * T::A_BYTES, b = s.b + st * T::B_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::BK / 16; ++kk) {
      const uint64_t da = make_desc(a + kk * 32, 16, 8 * T::ASW, T::ASW);
      const uint64_t db =
          make_desc(b + kk * 2 * 8 * T::BSW, T::BK * T::BSW, 8 * T::BSW, T::BSW);
      Mma<T::BN>::run(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    if (i > 0 && lane == 0) mbar_arrive(s.empty + (i - 1) % kStages);
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// store the consumer's accumulators of the tile rows r with s.rows[r] >= 0:
// rounded to bf16 at out[s.rows[r]], rows of `ldo` columns (the first ldo
// <= c_out of the columns computed: a ragged width padded to c_out by the
// wrapper is written at its own width, one value at a time), or, with
// `part`, in f32 at part[m0 + r] (rows of c_out)
template <int BN>
__device__ __forceinline__ void store(const Smem& s, const float (&acc)[BN / 2],
                                      bf16* __restrict__ out, float* __restrict__ part,
                                      int c_out, int ldo, int m0, int n0) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + lane / 4 + 8 * h, row = s.rows[r];
    if (row < 0) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + (lane % 4) * 2;
      if (col >= c_out) continue;  // c_out % 8 == 0: col + 1 < c_out too
      const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
      if (part) {
        *reinterpret_cast<float2*>(part + static_cast<size_t>(m0 + r) * c_out + col) =
            make_float2(x, y);
      } else if (ldo == c_out) {
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * c_out + col) =
            __floats2bfloat162_rn(x, y);
      } else {
        bf16* o = out + static_cast<size_t>(row) * ldo + col;
        if (col < ldo) o[0] = __float2bfloat16_rn(x);
        if (col + 1 < ldo) o[1] = __float2bfloat16_rn(y);
      }
    }
  }
}

}  // namespace wg
}  // namespace taseg
