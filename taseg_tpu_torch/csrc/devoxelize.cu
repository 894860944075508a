// K7 devoxelize: the point side of the MinkUNet head, one launch per call.
//
// Replaces taseg_tpu/ops/voxelize.py:261 _devoxelize_trilinear and :241
// _devoxelize_identity (the forwards; their backwards are K6):
//
//   trilinear: out[p] = sum_{k < 8} w[k, p] * V[idx[k, p]]   (idx -1: 0 row)
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

// w == nullptr: the identity (one corner, copied as it is); else the
// trilinear sum over `corners` corners in corner order
template <typename D, bool kVec>
__global__ void __launch_bounds__(kThreads)
    devox_kernel(const typename D::raw* __restrict__ feats,
                 const int* __restrict__ idx, const float* __restrict__ w,
                 typename D::raw* __restrict__ out, int p, int corners,
                 int c) {
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
    if (w == nullptr) {
      load_chunk<D, kVec>(feats, __ldg(idx + pt), c, c0, m, acc);
    } else {
      for (int k = 0; k < corners; ++k) {
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

template <typename D>
int launch(const void* feats, const void* idx, const void* w, void* out,
           int p, int corners, int c, cudaStream_t s) {
  if (p <= 0 || c <= 0 || corners <= 0)
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
  auto kern = vec ? devox_kernel<D, true> : devox_kernel<D, false>;
  kern<<<blocks, kThreads, 0, s>>>(
      static_cast<const raw*>(feats), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<raw*>(out), p, corners, c);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* feats, const void* idx, const void* w, void* out,
             int p, int corners, int c, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == taseg::kF32) return launch<F32>(feats, idx, w, out, p, corners, c, s);
  if (dtype == taseg::kBF16) return launch<BF16>(feats, idx, w, out, p, corners, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// feats (V, C), idx (8, P) int32 (-1: absent corner), w (8, P) f32 ->
// out (P, C), feats and out f32 or bf16 (dtype)
extern "C" int taseg_devox_trilinear(const void* feats, const void* idx,
                                     const void* w, void* out, int p, int c,
                                     int dtype, void* stream) {
  if (w == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(feats, idx, w, out, p, 8, c, dtype, stream);
}

// feats (V, C), inverse (P,) int32 (-1: none) -> out (P, C)
extern "C" int taseg_devox_identity(const void* feats, const void* inverse,
                                    void* out, int p, int c, int dtype,
                                    void* stream) {
  return dispatch(feats, inverse, nullptr, out, p, 1, c, dtype, stream);
}
