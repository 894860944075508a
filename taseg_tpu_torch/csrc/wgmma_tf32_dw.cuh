// Hopper tensor-core weight-gradient tile on wgmma in f32, on 3xTF32: K4
// at K offsets (conv_dw.cu, taseg_sparse_conv_dw_tf32: every weight
// gradient of Cylinder3D and of the f32 MinkUNets' 3^3 convs) and K5 in
// f32 (taseg_strided_dw_tf32: the 8 slot lists, down and up).  It replaced
// the mma.sync m16n8k8 pair-list tile (conv_dw.cu, namespace dwmma::dwtf32,
// kept off the path as the yardstick `old_ms`).
//
// Over list o's pairs (x row, y row), d_W[o] = X_o^T Y_o with X_o the
// gathered x rows (C_in wide) and Y_o the gathered y rows (C_out wide),
// the contraction over the pairs.  A block owns 64 rows of C_in, BN <= 128
// columns of C_out, one list o and one piece of it (conv_dw.cu,
// lists::split_pairs / piece_of), and runs over the piece's pairs in
// stages of kBK = 32:
//
//   acc[m, n] += sum_p X[p][m0 + m] Y[p][n0 + n]
//
// each f32 product taken as three TF32 products (x = hi + lo, hi =
// cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi); x y ~ lo_x hi_y + hi_x lo_y
// + hi_x hi_y), as in wgmma_tf32.cuh.
//
// wgmma takes .tf32 operands only K-major (here K is the pair index) and
// reads B from shared memory always.  Both operands are gathered
// pair-major (a pair's channels contiguous), that is MN-major, so:
//   * A = X^T goes from registers (wgmma RS), where its layout in shared
//     memory is free: the producer copies each pair's 64 channels into a
//     row of kXS = 72 floats, and the consumer reads its m64k8 fragment
//     (pair 8 kk + t, channel g: bank 8 t + g, no conflict, as the
//     mma.sync tile read it) and splits it into hi and lo in registers;
//   * B = Y must lie K-major in shared memory, and nothing can split it
//     ahead of the call (it is an activation gathered through a pair
//     list).  So once a stage's rows have landed, the consumer warpgroup
//     reads them back a column at a time (a warp on 32 consecutive
//     columns of one pair: no conflict), splits each value into hi and lo
//     and writes both parts K-major, [n][pair]: one 128-byte swizzle row
//     per output column, its 16-byte chunk c (pairs 4 c .. 4 c + 3) at c ^
//     (n % 8) (a quarter-warp's 8 stores on 8 bank groups), while the
//     tensor cores run the stage before it.
// Roles of X and Y: not swapped.  Each block transposes its BN x 32 tile
// of B a stage, over ceil(C_in / 64) ceil(C_out / BN) blocks, so ~C_in
// C_out / 64 values a pair are transposed whichever side is B, and the
// rows gathered a pair (C_in ceil(C_out / BN) + C_out ceil(C_in / 64))
// come out the same both ways wherever both widths are >= 128.  A swap
// (d_W^T = Y^T X) would save a little only at the narrow heads (128 -> 20)
// and would store d_W transposed.
//
// Per k8 step three wgmma m64nBNk8 (lo*hi, hi*lo, hi*hi: small terms
// first) into a stage accumulator, the first of the stage with scale-d =
// 0, which zeroes it; each stage is then added to the running sum with
// rounded f32 adds (the tensor cores' accumulation does not round to
// nearest, and d_W's chains run over up to V pairs).  So a consumer
// thread holds BN / 2 accumulators twice and 32 A registers: BN <= 128
// (a wider C_out takes several 128-column blocks), and tiles of BN <= 64
// run two blocks an SM.  One consumer warpgroup a block: a second one (128
// C_in rows, B transposed once for both) would need 384 threads of ~180
// registers at BN = 128, past the SM's 65 536.
//
// Roles and ring: warpgroup 0 consumes, warpgroup 1 produces, through
// RAW_STAGES stages of gathered rows (X rows, Y rows), each with a "full"
// barrier (kProd cp.async arrivals: the stage has landed) and an "empty"
// one (4 consumer warps: its A is read and its Y transposed), and kB = 2
// buffers of the transposed B (hi and lo, 1024-byte aligned).  The
// producer only gathers, up to RAW_STAGES stages ahead.  The transpose
// sits with the consumer, beside the tensor cores' previous stage: with
// the producer transposing each stage a few stages behind its copies
// (cp.async.wait_group, then a barrier of the producer warps) every TIAF
// call measured was slower (tools/dw_tf32_calls.py).  The consumer, at
// stage i: waits for it to land, transposes
// and splits its Y into B buffer i % 2 (stage i - 2's products, which
// read that buffer, are done), fences its writes for the async proxy,
// meets the other consumer warps at a named barrier, waits for stage i -
// 1's products (the stage accumulator and the A registers are shared),
// adds them, reads and splits its A, frees the raw stage and issues stage
// i's 12 products.
//
// Needs f32, C_in % 4 == 0, C_out % 4 == 0 (the wrappers pad ragged
// widths), 16-byte aligned x and y.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "wgmma_tf32.cuh"

namespace taseg {
namespace wtd {

namespace wt = taseg::wt;

constexpr int kBM = 64;           // C_in rows of d_W a block
constexpr int kBK = 32;           // pairs a stage: one 128-byte swizzle row of B
constexpr int kXS = kBM + 8;      // floats a staged X row (the fragment's banks)
constexpr int kB = 2;             // B buffers
constexpr int kCons = 128;        // warpgroup 0: transpose and split B, wgmma
constexpr int kProd = 128;        // warpgroup 1: cp.async
constexpr int kThreads = kCons + kProd;
constexpr int kWin = 512;         // pairs staged in shared memory at a time
constexpr int kMaxBN = 128;

template <int BN_>
struct Tile {
  static constexpr int BN = BN_;
  static constexpr int X_BYTES = kBK * kXS * 4;
  static constexpr int Y_BYTES = kBK * BN * 4;
  static constexpr int RAW = X_BYTES + Y_BYTES;   // one raw stage
  static constexpr int B_PART = BN * kBK * 4;     // hi or lo: BN rows of 128 bytes
  static constexpr int B_BUF = 2 * B_PART;
  static constexpr int MIN_BLOCKS = BN <= 64 ? 2 : 1;
  // stages of gathered rows: 6, but 4 at BN = 64 (two blocks an SM in
  // 228 KB)
  static constexpr int RAW_STAGES = BN == 64 ? 4 : 6;
  static_assert(BN % 16 == 0 && BN <= kMaxBN, "BN");
  static_assert(B_PART % 1024 == 0 && RAW % 16 == 0, "alignment");
  static_assert(kBK * BN / 4 % kProd == 0 && BN * kBK / 4 % kCons == 0, "whole rounds of copies and splits");
};

// the dynamic shared memory of a block (f3conv.dw_tf32_smem_bytes)
template <typename T>
constexpr size_t smem_bytes() {
  return 1024 + static_cast<size_t>(kB) * T::B_BUF + static_cast<size_t>(T::RAW_STAGES) * T::RAW +
         2 * T::RAW_STAGES * 8 + static_cast<size_t>(kWin) * 8;
}

struct Smem {
  uint32_t b;        // B buffers [kB][hi, lo][BN][128 bytes], 1024-byte aligned
  uint32_t raw;      // raw stages [RAW_STAGES][X rows, Y rows]
  uint64_t* full;    // [RAW_STAGES]
  uint64_t* empty;   // [RAW_STAGES]
  int2* ps;          // [kWin] the window's pairs
};

template <typename T>
__device__ __forceinline__ Smem carve(unsigned char* raw) {
  const uint32_t base = wg::smem_addr(raw);
  unsigned char* p = raw + (((base + 1023u) & ~1023u) - base);
  Smem s;
  s.b = wg::smem_addr(p);
  p += kB * T::B_BUF;
  s.raw = wg::smem_addr(p);
  p += T::RAW_STAGES * T::RAW;
  s.full = reinterpret_cast<uint64_t*>(p);
  s.empty = s.full + T::RAW_STAGES;
  s.ps = reinterpret_cast<int2*>(s.empty + T::RAW_STAGES);
  return s;
}

template <typename T>
__device__ __forceinline__ void init_barriers(const Smem& s) {
  for (int i = 0; i < T::RAW_STAGES; ++i) {
    wg::mbar_init(s.full + i, kProd);
    wg::mbar_init(s.empty + i, kCons / 32);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// a barrier of one warpgroup's 128 threads (1: the producers, 2: the
// consumers)
template <int ID>
__device__ __forceinline__ void warpgroup_sync() {
  asm volatile("bar.sync %0, 128;\n" ::"n"(ID) : "memory");
}

__device__ __forceinline__ void sts4(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v[0]), "r"(v[1]),
               "r"(v[2]), "r"(v[3])
               : "memory");
}

// producer: stage t of the window into raw stage `slot`: X rows (64
// channels from m0) and Y rows (BN columns from n0) of pairs [32 t, 32 t +
// 32), zero past the window, C_in and C_out; the stage's "full" barrier
// counts this thread once its copies have landed
template <typename T>
__device__ __forceinline__ void issue_stage(const Smem& s, int slot, int t, int n_w, int pt,
                                            const float* __restrict__ x,
                                            const float* __restrict__ y, int c_in, int c_out,
                                            int m0, int n0) {
  const uint32_t xs = s.raw + slot * T::RAW, ys = xs + T::X_BYTES;
#pragma unroll
  for (int j = 0; j < kBK * (kBM / 4) / kProd; ++j) {
    const int e = pt + j * kProd;
    const int r = e / (kBM / 4), cc = e % (kBM / 4), c = m0 + cc * 4, q = t * kBK + r;
    const bool ok = q < n_w && c < c_in;
    wg::cp_async16(xs + (r * kXS + cc * 4) * 4,
                   ok ? x + static_cast<size_t>(s.ps[q].x) * c_in + c : x, ok);
  }
#pragma unroll
  for (int j = 0; j < kBK * (T::BN / 4) / kProd; ++j) {
    const int e = pt + j * kProd;
    const int r = e / (T::BN / 4), cc = e % (T::BN / 4), col = n0 + cc * 4, q = t * kBK + r;
    const bool ok = q < n_w && col < c_out;
    wg::cp_async16(ys + (r * T::BN + cc * 4) * 4,
                   ok ? y + static_cast<size_t>(s.ps[q].y) * c_out + col : y, ok);
  }
  wg::cp_async_arrive(s.full + slot);
}

// consumer: raw stage `slot`'s Y rows split into hi and lo and written
// K-major into the B buffer at `b` (its hi part, then its lo part);
// `ct` of the consumer warpgroup's 128 threads
template <typename T>
__device__ __forceinline__ void transpose_b(const Smem& s, int slot, uint32_t b, int ct) {
  const uint32_t ys = s.raw + slot * T::RAW + T::X_BYTES;
#pragma unroll
  for (int j = 0; j < T::BN * (kBK / 4) / kCons; ++j) {  // all of them unrolled: their loads in flight at once
    const int e = ct + j * kCons, n = e % T::BN, c = e / T::BN;  // column n, pairs 4 c .. 4 c + 3
    uint32_t h[4], l[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) wt::split(wt::lds(ys + ((4 * c + q) * T::BN + n) * 4), h[q], l[q]);
    const uint32_t d = n * (kBK * 4) + (wg::swz<kBK * 4>(n, c) << 4);
    sts4(b + d, h);
    sts4(b + T::B_PART + d, l);
  }
}

// this producer thread's pairs [w0 + pt + kProd j] of the piece (zeros
// past its end), into registers
template <int J>
__device__ __forceinline__ void fetch_window(int2 (&nxt)[J], const int2* __restrict__ src, int w0,
                                             int n_pairs, int pt, int swap) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int e = w0 + pt + j * kProd;
    const int2 q = e < n_pairs ? src[e] : make_int2(0, 0);
    nxt[j] = swap ? make_int2(q.y, q.x) : q;
  }
}

// producer warpgroup: the piece's n_pairs pairs at src, window by window
// (each window's pairs loaded into registers while the one before it is
// issued), up to RAW_STAGES stages ahead of the consumer; `swap` reads
// each pair as (y row, x row)
template <typename T>
__device__ __forceinline__ void produce(const Smem& s, const int2* __restrict__ src, int n_pairs,
                                        int swap, const float* __restrict__ x,
                                        const float* __restrict__ y, int c_in, int c_out, int m0,
                                        int n0) {
  constexpr int J = kWin / kProd, R = T::RAW_STAGES;
  const int pt = threadIdx.x - kCons;
  int2 nxt[J];
  fetch_window(nxt, src, 0, n_pairs, pt, swap);
  int i = 0;  // stages issued
  for (int w0 = 0; w0 < n_pairs; w0 += kWin) {
    const int n_w = min(kWin, n_pairs - w0);
    warpgroup_sync<1>();  // every producer has issued the previous window
#pragma unroll
    for (int j = 0; j < J; ++j) s.ps[pt + j * kProd] = nxt[j];
    warpgroup_sync<1>();
    if (w0 + kWin < n_pairs) fetch_window(nxt, src, w0 + kWin, n_pairs, pt, swap);
    const int stages = (n_w + kBK - 1) / kBK;
    for (int t = 0; t < stages; ++t, ++i) {
      wg::mbar_wait(s.empty + i % R, ((i / R) & 1) ^ 1);
      issue_stage<T>(s, i % R, t, n_w, pt, x, y, c_in, c_out, m0, n0);
    }
  }
}

// consumer warpgroup: acc (its 64 x BN tile) over the piece's n stages
template <typename T>
__device__ __forceinline__ void consume(const Smem& s, int n, float (&acc)[T::BN / 2]) {
  constexpr int R = T::RAW_STAGES;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16 + g, r1 = r0 + 8;
  float part[T::BN / 2];
  uint32_t ah[4][4] = {}, al[4][4] = {};
#pragma unroll
  for (int q = 0; q < T::BN / 2; ++q) part[q] = 0.f;
  for (int i = 0; i < n; ++i) {
    const int slot = i % R;
    const uint32_t bh = s.b + (i % kB) * T::B_BUF, bl = bh + T::B_PART;
    wg::mbar_wait(s.full + slot, (i / R) & 1);
    // B of stage i, while the tensor cores run stage i - 1 (its buffer's
    // last reader, stage i - 2, is done)
    transpose_b<T>(s, slot, bh, threadIdx.x);
    wg::fence_proxy_async();  // these generic writes before wgmma's async reads
    warpgroup_sync<2>();      // every consumer's part of B is written
    // stage i - 1's products (none before stage 0: part is zero): its
    // part and A registers are free
    wg::wgmma_wait<0>();
    wg::fence_regs(part);
    wt::fence_a(ah);
    wt::fence_a(al);
#pragma unroll
    for (int q = 0; q < T::BN / 2; ++q) acc[q] += part[q];
    // this thread's A fragment of each k8 step: a0 - a3 = A(r0, 8 kk + t),
    // A(r1, 8 kk + t), A(r0, 8 kk + t + 4), A(r1, 8 kk + t + 4), A(m, p) =
    // X[p][m]
    const uint32_t xs = s.raw + slot * T::RAW;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t p0 = xs + (8 * kk + t) * kXS * 4, p1 = p0 + 4 * kXS * 4;
      wt::split(wt::lds(p0 + r0 * 4), ah[kk][0], al[kk][0]);
      wt::split(wt::lds(p0 + r1 * 4), ah[kk][1], al[kk][1]);
      wt::split(wt::lds(p1 + r0 * 4), ah[kk][2], al[kk][2]);
      wt::split(wt::lds(p1 + r1 * 4), ah[kk][3], al[kk][3]);
    }
    __syncwarp();  // wgmma's .aligned needs the warp converged
    if (lane == 0) wg::mbar_arrive(s.empty + slot);  // A read, Y transposed: the raw stage is free
    wg::fence_regs(part);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dh = wg::make_desc(bh + kk * 32, 16, 8 * kBK * 4, kBK * 4);
      const uint64_t dl = wg::make_desc(bl + kk * 32, 16, 8 * kBK * 4, kBK * 4);
      wt::Mma<T::BN>::run(part, al[kk], dh, kk > 0);
      wt::Mma<T::BN>::run(part, ah[kk], dl, 1);
      wt::Mma<T::BN>::run(part, ah[kk], dh, 1);
    }
    wg::wgmma_commit();
  }
  wg::wgmma_wait<0>();
  wg::fence_regs(part);
#pragma unroll
  for (int q = 0; q < T::BN / 2; ++q) acc[q] += part[q];
}

// consumer: the tile's rows [m0, m0 + 64) x columns [n0, n0 + BN) of a
// (C_in, C_out) row-major f32 block at dst, within C_in and C_out
template <int BN>
__device__ __forceinline__ void store(const float (&acc)[BN / 2], float* __restrict__ dst,
                                      int c_in, int c_out, int m0, int n0) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + warp * 16 + lane / 4 + 8 * h;
    if (r >= c_in) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + (lane % 4) * 2;
      if (col >= c_out) continue;  // c_out % 4 == 0: col + 1 < c_out too
      *reinterpret_cast<float2*>(dst + static_cast<size_t>(r) * c_out + col) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

}  // namespace wtd
}  // namespace taseg
