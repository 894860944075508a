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
// Bound on the H100: bytes.  Per point it reads 8 (idx, w) pairs (64 B)
// and 8 corner rows, and writes one row: at the head's class width (C =
// 20, bf16) the tables and the output are ~9 MB per call at P = 131072,
// ~0.003 ms at 3.35 TB/s; the corner rows come mostly from L2 (V is
// 7936-46080 rows of 40 B).  A thread owns one point and 4 channels: it
// reads the 8 (idx, w) pairs once, gathers 4 channels of each corner row
// with one 8-byte (bf16) or 16-byte (f32) load where the rows allow it
// (C % 4 == 0 and aligned bases; else one scalar load per channel), keeps
// the sum in registers and writes its 4 channels once.
//
// At 4 corners (RPVNet, f32 images of C = 32-256 channels, P = 131072):
// per point 4 (idx, w) pairs (32 B) and one output row, and the image
// rows, read once where the corners of neighbouring points share pixels
// (a 64 x 2048 canvas at full scale is 131072 rows, 16-128 MB; the 1/16
// and 1/4 scales fit in L2).  The same thread layout serves: neighbouring
// threads take neighbouring 16-byte pieces of one corner row.  The corner
// count is a template parameter, so the corner loop unrolls.
//
// K8 replaces taseg_tpu/ops/voxelize.py:126 _voxelize_bwd, the gradient
// of voxelize_avg (SPVCNN's point branch re-voxelizes features that take
// a gradient):
//
//   d_points[p] = g[inv[p]] / max(count[inv[p]], 1), or 0 where inv[p] < 0
//
// The plain version (and JAX) casts the count to g's dtype before it
// divides, which in bf16 rounds counts above 256; the kernel repeats it:
// the count rounded to g's dtype, one IEEE division in f32 (__fdiv_rn),
// one rounding to g's dtype.  Absent points write +0.  So its bits,
// signed zeros included, are the plain version's.  Bound on the H100:
// bytes, the (P, C) output (8.4-134 MB per call on SPVCNN's train step)
// and the rows of g it gathers.  A thread owns one point and 16 bytes of
// its row (4 f32 or 8 bf16 channels): one 16-byte load of g, one of the
// output, where C and the bases allow it (else scalar loads and stores).
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4;  // channels per thread

// storage of one feature value, its conversions and 4-value vectors;
// bf16 is handled as its raw 16 bits
struct F32 {
  using raw = float;
  using vec = float4;
  __device__ static float to_f(raw x) { return x; }
  __device__ static raw from_f(float x) { return x; }
  __device__ static void unpack(vec q, raw (&e)[kChunk]) {
    e[0] = q.x; e[1] = q.y; e[2] = q.z; e[3] = q.w;
  }
  __device__ static vec pack(const raw (&e)[kChunk]) {
    return make_float4(e[0], e[1], e[2], e[3]);
  }
};

struct BF16 {
  using raw = unsigned short;
  using vec = uint2;
  __device__ static float to_f(raw b) {
    return __uint_as_float(static_cast<unsigned>(b) << 16);
  }
  __device__ static raw from_f(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  __device__ static void unpack(vec q, raw (&e)[kChunk]) {
    e[0] = q.x & 0xffffu; e[1] = q.x >> 16;
    e[2] = q.y & 0xffffu; e[3] = q.y >> 16;
  }
  __device__ static vec pack(const raw (&e)[kChunk]) {
    return make_uint2(e[0] | (static_cast<unsigned>(e[1]) << 16),
                      e[2] | (static_cast<unsigned>(e[3]) << 16));
  }
};

// channels [c0, c0 + n) of row i (all +0 where i < 0)
template <typename D, bool kVec>
__device__ __forceinline__ void load_chunk(const typename D::raw* feats,
                                           int i, int c, int c0, int n,
                                           typename D::raw (&g)[kChunk]) {
  using raw = typename D::raw;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) g[j] = raw(0);
  if (i < 0) return;
  const raw* row = feats + static_cast<size_t>(i) * c + c0;
  if (kVec) {
    D::unpack(__ldg(reinterpret_cast<const typename D::vec*>(row)), g);
  } else {
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < n) g[j] = __ldg(row + j);
  }
}

// kCorners == 1: the identity (one corner, copied as it is, w unused);
// else the weighted sum over kCorners corners in corner order
template <typename D, bool kVec, int kCorners>
__global__ void __launch_bounds__(kThreads)
    devox_kernel(const typename D::raw* __restrict__ feats,
                 const int* __restrict__ idx, const float* __restrict__ w,
                 typename D::raw* __restrict__ out, int p, int c) {
  using raw = typename D::raw;
  const int chunks = (c + kChunk - 1) / kChunk;
  const long long n = static_cast<long long>(p) * chunks;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       t < n; t += static_cast<long long>(gridDim.x) * kThreads) {
    const int pt = static_cast<int>(t / chunks);
    const int c0 = static_cast<int>(t % chunks) * kChunk;
    const int m = min(kChunk, c - c0);
    raw acc[kChunk];
    if (kCorners == 1) {
      load_chunk<D, kVec>(feats, __ldg(idx + pt), c, c0, m, acc);
    } else {
#pragma unroll
      for (int k = 0; k < kCorners; ++k) {
        const size_t e = static_cast<size_t>(k) * p + pt;
        raw g[kChunk];
        load_chunk<D, kVec>(feats, __ldg(idx + e), c, c0, m, g);
        const float wk = D::to_f(D::from_f(__ldg(w + e)));
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const raw prod = D::from_f(__fmul_rn(D::to_f(g[j]), wk));
          acc[j] = k == 0 ? prod
                          : D::from_f(__fadd_rn(D::to_f(acc[j]), D::to_f(prod)));
        }
      }
    }
    raw* dst = out + static_cast<size_t>(pt) * c + c0;
    if (kVec) {
      *reinterpret_cast<typename D::vec*>(dst) = D::pack(acc);
    } else {
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (j < m) dst[j] = acc[j];
    }
  }
}

template <typename D, int kCorners>
int launch(const void* feats, const void* idx, const void* w, void* out,
           int p, int c, cudaStream_t s) {
  if (p <= 0 || c <= 0 || (kCorners > 1 && w == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  using raw = typename D::raw;
  const size_t vb = sizeof(typename D::vec);
  const bool vec = c % kChunk == 0 &&
                   reinterpret_cast<size_t>(feats) % vb == 0 &&
                   reinterpret_cast<size_t>(out) % vb == 0;
  const long long n =
      static_cast<long long>(p) * ((c + kChunk - 1) / kChunk);
  const int blocks = static_cast<int>(
      std::min<long long>((n + kThreads - 1) / kThreads, 1 << 20));
  auto kern = vec ? devox_kernel<D, true, kCorners>
                 : devox_kernel<D, false, kCorners>;
  kern<<<blocks, kThreads, 0, s>>>(
      static_cast<const raw*>(feats), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<raw*>(out), p, c);
  return static_cast<int>(cudaGetLastError());
}

template <int kCorners>
int dispatch(const void* feats, const void* idx, const void* w, void* out,
             int p, int c, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == taseg::kF32)
    return launch<F32, kCorners>(feats, idx, w, out, p, c, s);
  if (dtype == taseg::kBF16)
    return launch<BF16, kCorners>(feats, idx, w, out, p, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------- K8
// 16 bytes of one row: 4 f32 or 8 bf16 values
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

template <typename D>
int launch_voxelize_bwd(const void* g, const void* inv, const void* counts,
                        void* out, int p, int c, cudaStream_t s) {
  if (p <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  using raw = typename D::raw;
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
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats (V, C), idx (8, P) int32 (-1: absent corner), w (8, P) f32 ->
// out (P, C), feats and out f32 or bf16 (dtype)
extern "C" int taseg_devox_trilinear(const void* feats, const void* idx,
                                     const void* w, void* out, int p, int c,
                                     int dtype, void* stream) {
  return dispatch<8>(feats, idx, w, out, p, c, dtype, stream);
}

// image rows (H * W, C), idx (4, P) int32 (-1: absent corner), w (4, P)
// f32 -> out (P, C), rows and out f32 or bf16 (dtype)
extern "C" int taseg_devox_bilinear(const void* feats, const void* idx,
                                    const void* w, void* out, int p, int c,
                                    int dtype, void* stream) {
  return dispatch<4>(feats, idx, w, out, p, c, dtype, stream);
}

// feats (V, C), inverse (P,) int32 (-1: none) -> out (P, C)
extern "C" int taseg_devox_identity(const void* feats, const void* inverse,
                                    void* out, int p, int c, int dtype,
                                    void* stream) {
  return dispatch<1>(feats, inverse, nullptr, out, p, c, dtype, stream);
}

// g (V, C), inv (P,) int32 (-1: no voxel), counts (V,) int32 -> out (P, C),
// g and out f32 or bf16 (dtype)
extern "C" int taseg_voxelize_bwd(const void* g, const void* inv,
                                  const void* counts, void* out, int p, int c,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == taseg::kF32)
    return launch_voxelize_bwd<F32>(g, inv, counts, out, p, c, s);
  if (dtype == taseg::kBF16)
    return launch_voxelize_bwd<BF16>(g, inv, counts, out, p, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
