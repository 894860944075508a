// K7 devoxelize: the point side of the MinkUNet head, one launch per call;
// and K8, the gradient of the voxelize mean, in the same point-major layout.
//
// K7 replaces taseg_tpu/ops/voxelize.py:262 _devoxelize_trilinear and :242
// _devoxelize_identity (the forwards; their backwards are K6), and, at 4
// corners, the forward of taseg_tpu/ops/point_range.py:82 range_to_point
// (RPVNet's bilinear sample of a range image at each point):
//
//   trilinear: out[p] = sum_{k < 8} w[k, p] * V[idx[k, p]]   (idx -1: 0 row)
//   bilinear:  out[p] = sum_{k < 4} w[k, p] * I[idx[k, p]]   (I: pixel rows)
//   identity:  out[p] = V[inverse[p]], or 0 where inverse[p] < 0
//
// The JAX package, and the port's plain version, multiply and add in the
// feature dtype, corner by corner: out = c_0, then out = out + c_k, with
// c_k = g_k * w_k and w_k cast to the feature dtype first.  The kernel
// repeats that rounding exactly: w_k rounded to the feature dtype, then
// __fmul_rn and a rounding, __fadd_rn and a rounding (the _rn intrinsics
// keep nvcc from contracting the pair into an FMA).  An absent corner is
// multiplied too, with g = +0, so the signed zeros come out as the plain
// version's (a present corner of weight 0 and a negative feature gives
// -0).  So the kernel is bit-identical to the plain version on the card.
//
// The multi-scale entry (taseg_devox_multi) runs up to three such
// gathers, each identity or weighted, in one launch, with one of two
// epilogues:
//
//   sum (the MinkUNet head, JAX minkunet.py:36-66):
//        out[p] = ((f32(d_0[p]) + f32(d_1[p])) + f32(d_2[p])) + bias, f32
//   cat (KD's tri-scale features, TIAF's taps): scale s written into its
//        column range of one (P, sum C_s) output in the feature dtype
//
// where d_s is the per-corner chain above, so the sum is bit-identical to
// the head's three calls, casts and adds, and the cat to torch.cat of the
// three calls.
//
// Bound on the H100: bytes.  Per point a trilinear call reads 8 (idx, w)
// pairs (64 B) and 8 corner rows and writes one row: at the head's class
// width (C = 20, bf16, P = 131072) the tables and the output are ~9 MB,
// ~0.003 ms at 3.35 TB/s.  The corner rows are gathered from L2 in 32-byte
// sectors, a row of 40 B touching one or two: ~67 MB of L2 sectors a call,
// ~0.012 ms, which sets the pace at narrow widths; at 256 channels the 8
// corner rows of each point move ~0.5 GB through L2 a call.  One thread
// owns one point and one piece of its row, the widest of 16, 8, 4 or 2
// bytes that C and the bases allow (the earlier kernel: 4 values, 8
// bytes in bf16),
// loads its point's 8 (idx, w) pairs (the threads of one point at one
// address: one broadcast load a warp), issues all 8 corner gathers
// before the chain and writes its piece once.  A layout that loads each
// point's pairs in one lane and hands them to the point's lanes by
// __shfl_sync (tried first) ran 1.1-1.9x slower at every width
// on the H100 (tools/k7_calls.py): the pairs' broadcast loads cost
// little, the shuffles' dependency and the extra registers more.  The
// multi-scale sum runs the scales in order in one thread, keeps the f32
// sum in registers and writes the (P, C) f32 row once: it saves the
// head's three (P, C) bf16 writes, three casts and three adds of (P, C)
// f32 rows; the cat runs one scale per blockIdx.y into its columns.
// K8 replaces taseg_tpu/ops/voxelize.py:126 _voxelize_bwd, the gradient
// of voxelize_avg (SPVCNN's point branch re-voxelizes features that take
// a gradient; RPVNet's and TIAF's scatters to pixels and voxels too):
//
//   d_points[p] = g[inv[p]] / max(count[inv[p]], 1), or 0 where inv[p] < 0
//
// The plain version (and JAX) casts the count to g's dtype before it
// divides, which in bf16 rounds counts above 256; the kernel repeats it:
// the count rounded to g's dtype, one IEEE division in f32 (__fdiv_rn),
// one rounding to g's dtype.  Absent points write +0.  So its bits,
// signed zeros included, are the plain version's.  Bound on the H100:
// bytes, the (P, C) output (8.4-134 MB per call on SPVCNN's train step)
// and the rows of g it gathers.  Two layouts, picked by the row's
// alignment (launch_voxelize_bwd):
//   * rows (voxelize_bwd_rows_kernel): one thread a (point, piece), the
//     piece the widest of 16, 8, 4 or 2 bytes that the row's bytes and
//     both bases allow (K7's layout), one 32-bit division a piece;
//   * flat (voxelize_bwd_flat_kernel): one thread a 16-byte piece of the
//     flat (P * C) output, its values gathered one by one from the (at
//     most two) rows they fall in: a row of 102 bytes (51 bf16, SPVCNN cr
//     1.6) or 1636 (409 f32) allows only 2- or 4-byte pieces above, and
//     those move a warp's 64 or 128 bytes an instruction; here every
//     store is 16 bytes a lane.
// The wrapper picks the layout (voxelize.voxelize_bwd_plan): rows whose
// bytes and bases allow 16-byte pieces take the rows layout (the two then
// coincide), and so do rows narrower than 16 bytes; the others the flat
// one.  The kernel it replaced (voxelize_bwd_kernel, the first K8: one
// thread 16 bytes of one point, scalar 2-byte loads and stores where the
// row is not 16-byte aligned, a 64-bit division and remainder per
// element) stays callable as the yardstick `old_ms` (layout 3).
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxScales = 3;
constexpr int kMaxCorners = 8;

// storage of one feature value and its conversions; bf16 is handled as
// its raw 16 bits
struct F32 {
  using raw = float;
  __device__ static float to_f(raw x) { return x; }
  __device__ static raw from_f(float x) { return x; }
};

struct BF16 {
  using raw = unsigned short;
  __device__ static float to_f(raw b) {
    return __uint_as_float(static_cast<unsigned>(b) << 16);
  }
  __device__ static raw from_f(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

template <int VB> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = unsigned; };
template <> struct Vec<2> { using T = unsigned short; };

// VB bytes of one row: N values, loaded and stored as one vector
template <typename D, int VB>
struct Piece {
  static constexpr int N = VB / static_cast<int>(sizeof(typename D::raw));
  union {
    typename Vec<VB>::T v;
    typename D::raw e[N];
  };
};

// one gather: rows of `feats` (V, c), `corners` (idx, w) pairs a point
// in (corners, P) tables (w null: the identity, one corner, copied)
struct Scale {
  const void* feats;
  const int* idx;
  const float* w;
  int corners;
  int c;
  int col0;  // first output column (cat)
};

struct Args {
  Scale s[kMaxScales];
  int n;    // scales
  int p;    // points
  int ldo;  // output row stride, in values
  void* out;
  const float* bias;  // sum epilogue: (c,) f32
};

// scale y of `a`, read with constant offsets (an index computed at run
// time into the kernel's parameters would copy them to local memory)
__device__ __forceinline__ Scale pick(const Args& a, int y) {
  return y == 0 ? a.s[0] : y == 1 ? a.s[1] : a.s[2];
}

// piece `ch` of point `pt` in one scale: the per-corner chain in the
// feature dtype (w rounded to it, __fmul_rn and __fadd_rn rounded, corner
// order; an absent corner gathers +0 and is multiplied too), or the
// identity's copy.  Every corner's (idx, w) and row piece are loaded
// before the chain; the lanes of one point read its pairs at one address
// (one broadcast load a warp), neighbouring points' at neighbouring ones.
template <typename D, int VB, int kC>
__device__ __forceinline__ void chain(const Scale& sc, int corners, int p, int pt, int ch,
                                      Piece<D, VB>& acc) {
  using raw = typename D::raw;
  using P = Piece<D, VB>;
  constexpr int N = P::N;
  const raw* feats = static_cast<const raw*>(sc.feats);
  P g[kMaxCorners];
  float wk[kMaxCorners];
#pragma unroll
  for (int k = 0; k < kMaxCorners; ++k) {
    if (k < (kC ? kC : corners)) {
      const size_t e = static_cast<size_t>(k) * p + pt;
      const int i = __ldg(sc.idx + e);
      wk[k] = sc.w != nullptr ? __ldg(sc.w + e) : 1.f;
#pragma unroll
      for (int j = 0; j < N; ++j) g[k].e[j] = raw(0);
      if (i >= 0)
        g[k].v = __ldg(reinterpret_cast<const typename Vec<VB>::T*>(
            feats + static_cast<size_t>(i) * sc.c + static_cast<size_t>(ch) * N));
    }
  }
  if (sc.w == nullptr) {
    acc = g[0];
    return;
  }
#pragma unroll
  for (int k = 0; k < kMaxCorners; ++k) {
    if (k < (kC ? kC : corners)) {
      const float w = D::to_f(D::from_f(wk[k]));
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const raw prod = D::from_f(__fmul_rn(D::to_f(g[k].e[j]), w));
        acc.e[j] = k == 0 ? prod : D::from_f(__fadd_rn(D::to_f(acc.e[j]), D::to_f(prod)));
      }
    }
  }
}

// cat (and the single-scale entries): scale blockIdx.y into its columns,
// one thread a (point, VB-byte piece); kC the corner count of every
// scale (1, 4 or 8; 0: they differ, read each scale's), so a profile
// tells the 4-corner calls apart
template <typename D, int VB, int kC>
__global__ void __launch_bounds__(kThreads) devox_cols_kernel(const Args a) {
  using raw = typename D::raw;
  using P = Piece<D, VB>;
  const Scale sc = pick(a, blockIdx.y);
  const int corners = kC ? kC : sc.corners;
  const unsigned chunks = static_cast<unsigned>(sc.c / P::N);
  const unsigned n = static_cast<unsigned>(a.p) * chunks;
  raw* out = static_cast<raw*>(a.out);
  for (unsigned t = blockIdx.x * kThreads + threadIdx.x; t < n; t += gridDim.x * kThreads) {
    const int pt = static_cast<int>(t / chunks);
    const int ch = static_cast<int>(t - static_cast<unsigned>(pt) * chunks);
    P acc;
    chain<D, VB, kC>(sc, corners, a.p, pt, ch, acc);
    *reinterpret_cast<typename Vec<VB>::T*>(
        out + static_cast<size_t>(pt) * a.ldo + sc.col0 + static_cast<size_t>(ch) * P::N) = acc.v;
  }
}

template <int N>
__device__ __forceinline__ void store_f32(float* dst, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4)
      *reinterpret_cast<float4*>(dst + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) dst[j] = v[j];
  }
}

// sum: every scale of width c, in order, summed in f32 in registers, plus
// the bias, one (P, c) f32 write
template <typename D, int VB>
__global__ void __launch_bounds__(kThreads) devox_sum_kernel(const Args a) {
  using P = Piece<D, VB>;
  constexpr int N = P::N;
  const int c = a.s[0].c;
  const unsigned chunks = static_cast<unsigned>(c / N);
  const unsigned n = static_cast<unsigned>(a.p) * chunks;
  float* out = static_cast<float*>(a.out);
  for (unsigned t = blockIdx.x * kThreads + threadIdx.x; t < n; t += gridDim.x * kThreads) {
    const int pt = static_cast<int>(t / chunks);
    const int ch = static_cast<int>(t - static_cast<unsigned>(pt) * chunks);
    float acc[N];
#pragma unroll
    for (int s = 0; s < kMaxScales; ++s) {
      if (s < a.n) {
        P d;
        chain<D, VB, 0>(a.s[s], a.s[s].corners, a.p, pt, ch, d);
#pragma unroll
        for (int e = 0; e < N; ++e)
          acc[e] = s == 0 ? D::to_f(d.e[e]) : __fadd_rn(acc[e], D::to_f(d.e[e]));
      }
    }
    const int c0 = ch * N;
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] = __fadd_rn(acc[e], __ldg(a.bias + c0 + e));
    store_f32<N>(out + static_cast<size_t>(pt) * c + c0, acc);
  }
}

template <typename D, int VB>
void launch_vb(const Args& a, bool sum, int tag, int blocks, cudaStream_t s) {
  if (sum) {
    devox_sum_kernel<D, VB><<<blocks, kThreads, 0, s>>>(a);
    return;
  }
  const dim3 grid(blocks, a.n);
  switch (tag) {
    case 1: devox_cols_kernel<D, VB, 1><<<grid, kThreads, 0, s>>>(a); break;
    case 4: devox_cols_kernel<D, VB, 4><<<grid, kThreads, 0, s>>>(a); break;
    case 8: devox_cols_kernel<D, VB, 8><<<grid, kThreads, 0, s>>>(a); break;
    default: devox_cols_kernel<D, VB, 0><<<grid, kThreads, 0, s>>>(a); break;
  }
}

template <typename D>
int launch_multi(const Args& a, bool sum, cudaStream_t s) {
  constexpr int esz = static_cast<int>(sizeof(typename D::raw));
  if (a.n < 1 || a.n > kMaxScales || a.p <= 0 || a.out == nullptr ||
      (sum && a.bias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // the widest piece that every row, base and column offset allows
  int vb = 16;
  auto fit = [&](size_t x) {
    while (vb > esz && x % vb) vb /= 2;
  };
  long long items = 0;  // (point, piece) pairs of the widest scale
  for (int i = 0; i < a.n; ++i) {
    const Scale& sc = a.s[i];
    const bool identity = sc.corners == 1 && sc.w == nullptr;
    const bool weighted = (sc.corners == 4 || sc.corners == 8) && sc.w != nullptr;
    if (sc.c <= 0 || sc.feats == nullptr || sc.idx == nullptr || !(identity || weighted) ||
        (sum && sc.c != a.s[0].c))
      return static_cast<int>(cudaErrorInvalidValue);
    fit(static_cast<size_t>(sc.c) * esz);
    fit(reinterpret_cast<size_t>(sc.feats));
    if (!sum) fit(static_cast<size_t>(sc.col0) * esz);
  }
  if (!sum) {
    fit(reinterpret_cast<size_t>(a.out));
    fit(static_cast<size_t>(a.ldo) * esz);
  }
  int tag = a.s[0].corners;
  for (int i = 0; i < a.n; ++i) {
    if (a.s[i].corners != tag) tag = 0;
    items = std::max(items, static_cast<long long>(a.p) * (a.s[i].c * esz / vb));
  }
  if (items >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>(
      std::min<long long>((items + kThreads - 1) / kThreads, 1 << 20));
  switch (vb) {
    case 16: launch_vb<D, 16>(a, sum, tag, blocks, s); break;
    case 8: launch_vb<D, 8>(a, sum, tag, blocks, s); break;
    default:
      if constexpr (esz <= 4) {
        if (vb == 4) {
          launch_vb<D, 4>(a, sum, tag, blocks, s);
          break;
        }
      }
      if constexpr (esz == 2) {
        launch_vb<D, 2>(a, sum, tag, blocks, s);
        break;
      }
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch_multi(const Args& a, bool sum, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == taseg::kF32) return launch_multi<F32>(a, sum, s);
  if (dtype == taseg::kBF16) return launch_multi<BF16>(a, sum, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// one gather of `corners` corners (1: the identity) into a (P, C) output
int single(const void* feats, const void* idx, const void* w, int corners, void* out,
           int p, int c, int dtype, void* stream) {
  if (corners > 1 && w == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.s[0] = Scale{feats, static_cast<const int*>(idx), static_cast<const float*>(w),
                 corners, c, 0};
  a.n = 1;
  a.p = p;
  a.ldo = c;
  a.out = out;
  return dispatch_multi(a, false, dtype, stream);
}

// ---------------------------------------------------------------- K8
// the first K8 kernel, off the path (the yardstick `old_ms`): 16 bytes of one
// row a thread, 4 f32 or 8 bf16 values
template <typename D>
struct alignas(16) Row16 {
  static constexpr int kN = 16 / sizeof(typename D::raw);
  typename D::raw e[kN];
};

template <typename D, bool kVec>
__global__ void __launch_bounds__(kThreads)
    voxelize_bwd_kernel(const typename D::raw* __restrict__ g,
                        const int* __restrict__ inv,
                        const int* __restrict__ counts,
                        typename D::raw* __restrict__ out, int p, int c) {
  using raw = typename D::raw;
  constexpr int kN = Row16<D>::kN;
  const int chunks = (c + kN - 1) / kN;
  const long long n = static_cast<long long>(p) * chunks;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       t < n; t += static_cast<long long>(gridDim.x) * kThreads) {
    const int pt = static_cast<int>(t / chunks);
    const int c0 = static_cast<int>(t % chunks) * kN;
    const int m = min(kN, c - c0);
    const int i = __ldg(inv + pt);
    Row16<D> r;
#pragma unroll
    for (int j = 0; j < kN; ++j) r.e[j] = raw(0);
    if (i >= 0) {
      // the count in g's dtype (bf16 rounds counts above 256)
      const float d =
          D::to_f(D::from_f(static_cast<float>(max(__ldg(counts + i), 1))));
      const raw* row = g + static_cast<size_t>(i) * c + c0;
      if (kVec) {
        r = *reinterpret_cast<const Row16<D>*>(row);
      } else {
#pragma unroll
        for (int j = 0; j < kN; ++j)
          if (j < m) r.e[j] = row[j];
      }
#pragma unroll
      for (int j = 0; j < kN; ++j)
        r.e[j] = D::from_f(__fdiv_rn(D::to_f(r.e[j]), d));
    }
    raw* dst = out + static_cast<size_t>(pt) * c + c0;
    if (kVec) {
      *reinterpret_cast<Row16<D>*>(dst) = r;
    } else {
#pragma unroll
      for (int j = 0; j < kN; ++j)
        if (j < m) dst[j] = r.e[j];
    }
  }
}

// the rows layout: one thread a (point, VB-byte piece), `chunks` pieces a
// row, p * chunks < 2^32 (one 32-bit division a piece)
template <typename D, int VB>
__global__ void __launch_bounds__(kThreads)
    voxelize_bwd_rows_kernel(const typename D::raw* __restrict__ g,
                             const int* __restrict__ inv, const int* __restrict__ counts,
                             typename D::raw* __restrict__ out, unsigned n, unsigned chunks) {
  using P = Piece<D, VB>;
  using V = typename Vec<VB>::T;
  for (unsigned t = blockIdx.x * kThreads + threadIdx.x; t < n; t += gridDim.x * kThreads) {
    const unsigned pt = t / chunks, ch = t - pt * chunks;
    const int i = __ldg(inv + pt);
    P r;
    if (i >= 0) {
      // the count in g's dtype (bf16 rounds counts above 256)
      const float d = D::to_f(D::from_f(static_cast<float>(max(__ldg(counts + i), 1))));
      r.v = __ldg(reinterpret_cast<const V*>(g) + static_cast<size_t>(i) * chunks + ch);
#pragma unroll
      for (int j = 0; j < P::N; ++j) r.e[j] = D::from_f(__fdiv_rn(D::to_f(r.e[j]), d));
    } else {
#pragma unroll
      for (int j = 0; j < P::N; ++j) r.e[j] = typename D::raw(0);
    }
    reinterpret_cast<V*>(out)[t] = r.v;
  }
}

// the flat layout: 16 bytes of the (P * c) output a thread, `total` = P * c
// < 2^31 values in `pieces` pieces, c >= the values of a piece (so a
// piece spans at most two rows, whose maps and counts are loaded first),
// out 16-byte aligned
template <typename D>
__global__ void __launch_bounds__(kThreads)
    voxelize_bwd_flat_kernel(const typename D::raw* __restrict__ g,
                             const int* __restrict__ inv, const int* __restrict__ counts,
                             typename D::raw* __restrict__ out, int p, int c, unsigned total,
                             unsigned pieces) {
  using raw = typename D::raw;
  using P = Piece<D, 16>;
  constexpr int N = P::N;
  for (unsigned t = blockIdx.x * kThreads + threadIdx.x; t < pieces; t += gridDim.x * kThreads) {
    const unsigned e0 = t * N, pt = e0 / c;
    const int ch0 = static_cast<int>(e0 - pt * c);
    const int i0 = __ldg(inv + pt);
    const int i1 = ch0 + N > c && pt + 1 < static_cast<unsigned>(p) ? __ldg(inv + pt + 1) : -1;
    // the counts in g's dtype (bf16 rounds counts above 256)
    const float d0 = D::to_f(D::from_f(static_cast<float>(i0 >= 0 ? max(__ldg(counts + i0), 1) : 1)));
    const float d1 = D::to_f(D::from_f(static_cast<float>(i1 >= 0 ? max(__ldg(counts + i1), 1) : 1)));
    P r;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const bool next = ch0 + j >= c;
      const int i = next ? i1 : i0;
      r.e[j] = raw(0);
      if (i >= 0 && e0 + j < total)
        r.e[j] = D::from_f(__fdiv_rn(
            D::to_f(__ldg(g + static_cast<size_t>(i) * c + (next ? ch0 + j - c : ch0 + j))),
            next ? d1 : d0));
    }
    if (e0 + N <= total) {
      *reinterpret_cast<uint4*>(out + e0) = r.v;
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (e0 + j < total) out[e0 + j] = r.e[j];
    }
  }
}

// K8's layouts (launch_voxelize_bwd's `layout`; voxelize.voxelize_bwd_plan
// picks one)
enum Layout { kRows = 1, kFlat = 2, kOld = 3 };

template <typename D, int VB>
void launch_rows(const void* g, const void* inv, const void* counts, void* out, int p, int c,
                 cudaStream_t s) {
  using raw = typename D::raw;
  const unsigned chunks = static_cast<unsigned>(c) * sizeof(raw) / VB;
  const unsigned n = static_cast<unsigned>(p) * chunks;
  const int blocks = static_cast<int>(std::min<unsigned>((n + kThreads - 1) / kThreads, 1u << 20));
  voxelize_bwd_rows_kernel<D, VB><<<blocks, kThreads, 0, s>>>(
      static_cast<const raw*>(g), static_cast<const int*>(inv), static_cast<const int*>(counts),
      static_cast<raw*>(out), n, chunks);
}

template <typename D>
int launch_voxelize_bwd(const void* g, const void* inv, const void* counts,
                        void* out, int p, int c, int layout, cudaStream_t s) {
  using raw = typename D::raw;
  constexpr int esz = static_cast<int>(sizeof(raw));
  if (p <= 0 || c <= 0 || layout < kRows || layout > kOld)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(p) * c;
  // the widest piece that the row and both bases allow
  int vb = 16;
  auto fit = [&](size_t x) {
    while (vb > esz && x % vb) vb /= 2;
  };
  fit(static_cast<size_t>(c) * esz);
  fit(reinterpret_cast<size_t>(g));
  fit(reinterpret_cast<size_t>(out));
  constexpr int N = 16 / esz;  // values of a flat piece
  const bool flat_ok = reinterpret_cast<size_t>(out) % 16 == 0 && total < (1LL << 31) && c >= N;
  const bool rows_ok = total * esz / vb < (1LL << 32);
  if (layout == kFlat) {
    if (!flat_ok) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned pieces = static_cast<unsigned>((total + N - 1) / N);
    const int blocks = static_cast<int>(std::min<long long>((pieces + kThreads - 1) / kThreads, 1 << 20));
    voxelize_bwd_flat_kernel<D><<<blocks, kThreads, 0, s>>>(
        static_cast<const raw*>(g), static_cast<const int*>(inv), static_cast<const int*>(counts),
        static_cast<raw*>(out), p, c, static_cast<unsigned>(total), pieces);
  } else if (layout == kRows) {
    if (!rows_ok) return static_cast<int>(cudaErrorInvalidValue);
    switch (vb) {
      case 16: launch_rows<D, 16>(g, inv, counts, out, p, c, s); break;
      case 8: launch_rows<D, 8>(g, inv, counts, out, p, c, s); break;
      default:
        if constexpr (esz == 2) {
          if (vb == 2) {
            launch_rows<D, 2>(g, inv, counts, out, p, c, s);
            break;
          }
        }
        launch_rows<D, 4>(g, inv, counts, out, p, c, s);
    }
  } else {
    constexpr int kN = Row16<D>::kN;
    const bool vec = c % kN == 0 && reinterpret_cast<size_t>(g) % 16 == 0 &&
                     reinterpret_cast<size_t>(out) % 16 == 0;
    const long long n = static_cast<long long>(p) * ((c + kN - 1) / kN);
    const int blocks = static_cast<int>(
        std::min<long long>((n + kThreads - 1) / kThreads, 1 << 20));
    auto kern = vec ? voxelize_bwd_kernel<D, true> : voxelize_bwd_kernel<D, false>;
    kern<<<blocks, kThreads, 0, s>>>(
        static_cast<const raw*>(g), static_cast<const int*>(inv),
        static_cast<const int*>(counts), static_cast<raw*>(out), p, c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats (V, C), idx (8, P) int32 (-1: absent corner), w (8, P) f32 ->
// out (P, C), feats and out f32 or bf16 (dtype)
extern "C" int taseg_devox_trilinear(const void* feats, const void* idx,
                                     const void* w, void* out, int p, int c,
                                     int dtype, void* stream) {
  return single(feats, idx, w, 8, out, p, c, dtype, stream);
}

// image rows (H * W, C), idx (4, P) int32 (-1: absent corner), w (4, P)
// f32 -> out (P, C), rows and out f32 or bf16 (dtype)
extern "C" int taseg_devox_bilinear(const void* feats, const void* idx,
                                    const void* w, void* out, int p, int c,
                                    int dtype, void* stream) {
  return single(feats, idx, w, 4, out, p, c, dtype, stream);
}

// feats (V, C), inverse (P,) int32 (-1: none) -> out (P, C)
extern "C" int taseg_devox_identity(const void* feats, const void* inverse,
                                    void* out, int p, int c, int dtype,
                                    void* stream) {
  return single(feats, inverse, nullptr, 1, out, p, c, dtype, stream);
}

// up to 3 gathers (feats_s (V_s, C_s), idx_s (k_s, P) int32 or the
// identity's (P,) with k_s = 1 and w_s null, w_s (k_s, P) f32) in one
// launch: sum != 0 -> out (P, C) f32 = sum over s in order of f32(d_s),
// plus bias (C,) f32 (every C_s equal); sum == 0 -> out (P, sum C_s) in
// the feature dtype, scale s in columns [C_0 + ... + C_{s-1}, ...)
extern "C" int taseg_devox_multi(
    const void* f0, const void* i0, const void* w0, int k0, int c0,
    const void* f1, const void* i1, const void* w1, int k1, int c1,
    const void* f2, const void* i2, const void* w2, int k2, int c2,
    int n, void* out, const void* bias, int p, int dtype, int sum, void* stream) {
  Args a{};
  const void* f[kMaxScales] = {f0, f1, f2};
  const void* i[kMaxScales] = {i0, i1, i2};
  const void* w[kMaxScales] = {w0, w1, w2};
  const int k[kMaxScales] = {k0, k1, k2};
  const int c[kMaxScales] = {c0, c1, c2};
  int col = 0;
  for (int s = 0; s < kMaxScales; ++s) {
    a.s[s] = Scale{f[s], static_cast<const int*>(i[s]), static_cast<const float*>(w[s]),
                   k[s], c[s], col};
    if (s < n) col += c[s];
  }
  a.n = n;
  a.p = p;
  a.ldo = sum ? c0 : col;
  a.out = out;
  a.bias = static_cast<const float*>(bias);
  return dispatch_multi(a, sum != 0, dtype, stream);
}

// g (V, C), inv (P,) int32 (-1: no voxel), counts (V,) int32 -> out (P, C),
// g and out f32 or bf16 (dtype), in `layout`: 1 rows (pieces of the widest
// of 16, 8, 4 or 2 bytes that the row and both bases allow, P * C values
// in fewer than 2^32 of them), 2 flat (out 16-byte aligned, P * C < 2^31,
// C at least a 16-byte piece's values), 3 the first K8 kernel (the
// yardstick `old_ms`)
extern "C" int taseg_voxelize_bwd(const void* g, const void* inv,
                                  const void* counts, void* out, int p, int c,
                                  int dtype, int layout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == taseg::kF32)
    return launch_voxelize_bwd<F32>(g, inv, counts, out, p, c, layout, s);
  if (dtype == taseg::kBF16)
    return launch_voxelize_bwd<BF16>(g, inv, counts, out, p, c, layout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
