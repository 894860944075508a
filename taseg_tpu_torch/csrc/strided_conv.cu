// K3: ks=2 / stride=2 sparse conv pair, forward only — replaces the
// forward of taseg_tpu/ops/strided_conv.py:downsample_conv_apply (:123)
// and upsample_conv_apply (:152).
//
//   down: out[c] = sum_{f in children(c)} feats[f] @ W[slot f]
//         children(c) = perm[starts[c] : starts[c+1]]
//   up:   out[f] = feats[parent f] @ W[slot f]       (0 where parent < 0)
//
// W is (8, C_in, C_out); f32 or bf16 storage, f32 accumulation, one
// rounding at the store.  The JAX down path sums children with a
// mean-centred cumsum; this kernel sums them directly, so f32 results
// differ from it by cumsum rounding only.
//
// Bound on the H100: operations (2 * V_fine * C_in * C_out) and bytes
// (one read of feats and W, one write of out) are both small at the
// path's shapes; at V_fine <= 131072 and C <= 256 either bound is tens of
// microseconds.
//
// In bf16 with C_in and C_out multiples of 8 (all eight strided convs of
// the main path) both directions run on the tensor-core tile of
// gather_mma.cuh with the 8 slots as its offsets.  For each slot s that
// occurs in a 64-row tile, A_s holds the gathered input rows of slot s
// and zero elsewhere (the same zero-filling cp.async), and
// acc += A_s @ W[s]:
//   * up (strided_up_mma_kernel): A_s row f is the parent row of fine row
//     f when slot(f) == s; each row receives exactly one nonzero term, and
//     rows with parent < 0 stay zero.
//   * down (strided_down_mma_kernel): a block owns 64 coarse rows; thread
//     r walks its row's children perm[starts[c] : starts[c+1]] and sets
//     idx[slot f][r] = f.  On the main path a cell has at most one child
//     per slot (the host pipeline shifts coordinates to be non-negative),
//     so one round of the tile covers every child.  Where coordinates are
//     negative, truncating division folds {-1, 0, 1} into cell 0 and a
//     slot repeats up to 8 times in a cell: round q then takes each row's
//     q-th child of each slot, the f32 accumulators carry across rounds,
//     and the block stops when no row of the tile has a further round.
//     The tile does 8 slots x 64 rows of work per (round, C_in chunk)
//     against ~V_fine present pairs in all: at most ~5x at level 0, and
//     cheap on tensor cores; the reads of feats (V_fine x C_in) and the
//     write of out bound it.
//
// The other cases (f32 and ragged widths) run the CUDA-core design: like
// K2's a gather-GEMM with a 64x64 output tile in registers, except that
// the weight slice varies per row: each shared-memory stage holds the
// chunk of all 8 slots' weights, and each thread reads the slot of each of
// its rows.  `up` gathers one parent row per fine row.  `down` walks the
// children of each coarse row in rounds (round q takes each row's q-th
// child), until no row of the tile has another child; a coarse cell has up
// to 8 children, up to 27 where truncating division folds negative
// coordinates into cell 0.  f32 stays on CUDA cores: TF32 tensor cores
// would miss its tolerance.
#include "common.cuh"
#include "gather_mma.cuh"

namespace {

namespace mma = taseg::mma;
using taseg::store_f;
using taseg::to_f;

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 8;
constexpr int kThreads = 256;
constexpr int kSlots = 8;

struct Smem {
  float As[kBK][kBM + 4];
  float Bs[kSlots][kBK][kBN];
  int idx[kBM];
  int slot[kBM];
};

// acc += gather(feats, sm.idx) @ W[sm.slot[row]] over all of C_in
template <typename T>
__device__ void slot_tile_accumulate(const T* __restrict__ feats,
                                     const T* __restrict__ w, int c_in,
                                     int c_out, int n0, Smem& sm,
                                     float (&acc)[4][4]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  int sl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) sl[i] = sm.slot[ty * 4 + i];
  for (int c0 = 0; c0 < c_in; c0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK, c = c0 + kk, src = sm.idx[r];
      sm.As[kk][r] = (src >= 0 && c < c_in)
                         ? to_f(feats[static_cast<size_t>(src) * c_in + c])
                         : 0.f;
    }
    for (int e = tid; e < kSlots * kBK * kBN; e += kThreads) {
      const int s = e / (kBK * kBN), rem = e % (kBK * kBN);
      const int kk = rem / kBN, n = rem % kBN, c = c0 + kk, col = n0 + n;
      sm.Bs[s][kk][n] =
          (c < c_in && col < c_out)
              ? to_f(w[(static_cast<size_t>(s) * c_in + c) * c_out + col])
              : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = sm.As[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(a, sm.Bs[sl[i]][kk][tx * 4 + j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

template <typename T>
__device__ void store_tile(const float (&acc)[4][4], T* __restrict__ out,
                           int rows, int c_out, int m0, int n0) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= rows) continue;
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
    strided_down_kernel(const T* __restrict__ feats, const T* __restrict__ w,
                        const int* __restrict__ parent,
                        const int* __restrict__ slot,
                        const int* __restrict__ perm,
                        const int* __restrict__ starts, T* __restrict__ out,
                        int v_coarse, int c_in, int c_out) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float acc[4][4] = {};
  int beg = 0, cnt = 0;
  if (tid < kBM && m0 + tid < v_coarse) {
    beg = starts[m0 + tid];
    cnt = starts[m0 + tid + 1] - beg;
  }
  for (int q = 0;; ++q) {
    if (tid < kBM) {
      int f = -1, s = 0;
      if (q < cnt) {
        f = perm[beg + q];
        if (parent[f] < 0) {
          f = -1;
        } else {
          s = slot[f] & (kSlots - 1);
        }
      }
      sm.idx[tid] = f;
      sm.slot[tid] = s;
    }
    // barrier for idx/slot; stop once no row of the tile has a q-th child
    if (!__syncthreads_or(tid < kBM && q < cnt)) break;
    slot_tile_accumulate(feats, w, c_in, c_out, n0, sm, acc);
  }
  store_tile(acc, out, v_coarse, c_out, m0, n0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    strided_up_kernel(const T* __restrict__ feats, const T* __restrict__ w,
                      const int* __restrict__ parent,
                      const int* __restrict__ slot, T* __restrict__ out,
                      int v_fine, int c_in, int c_out) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float acc[4][4] = {};
  if (tid < kBM) {
    const int f = m0 + tid;
    const int p = f < v_fine ? parent[f] : -1;
    sm.idx[tid] = p;
    sm.slot[tid] = p >= 0 ? (slot[f] & (kSlots - 1)) : 0;
  }
  __syncthreads();
  slot_tile_accumulate(feats, w, c_in, c_out, n0, sm, acc);
  store_tile(acc, out, v_fine, c_out, m0, n0);
}

template <int BN>
__global__ void __launch_bounds__(mma::kThreads)
    strided_up_mma_kernel(const __nv_bfloat16* __restrict__ feats,
                          const __nv_bfloat16* __restrict__ w,
                          const int* __restrict__ parent,
                          const int* __restrict__ slot,
                          __nv_bfloat16* __restrict__ out, int v_fine,
                          int c_in, int c_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const mma::Smem s = mma::carve<BN>(smem, kSlots);
  const int m0 = blockIdx.x * mma::kBM, n0 = blockIdx.y * BN;
  if (threadIdx.x < mma::kBM) {
    const int f = m0 + threadIdx.x;
    const int p = f < v_fine ? parent[f] : -1;
    const int sl = p >= 0 ? (slot[f] & (kSlots - 1)) : -1;
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      s.idx[j * mma::kBM + threadIdx.x] = j == sl ? p : -1;
  }
  __syncthreads();
  const int n_present = mma::present_offsets(s, kSlots);
  float acc[2][BN / 16][4] = {};
  mma::gather_mma_tile<BN>(s, n_present, feats, w, c_in, c_out, n0, acc);
  mma::store_tile<BN>(acc, out, v_fine, c_out, m0, n0);
}

template <int BN>
__global__ void __launch_bounds__(mma::kThreads)
    strided_down_mma_kernel(const __nv_bfloat16* __restrict__ feats,
                            const __nv_bfloat16* __restrict__ w,
                            const int* __restrict__ parent,
                            const int* __restrict__ slot,
                            const int* __restrict__ perm,
                            const int* __restrict__ starts,
                            __nv_bfloat16* __restrict__ out, int v_coarse,
                            int c_in, int c_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const mma::Smem s = mma::carve<BN>(smem, kSlots);
  const int m0 = blockIdx.x * mma::kBM, n0 = blockIdx.y * BN;
  const int r = threadIdx.x;
  int beg = 0, end = 0;
  if (r < mma::kBM && m0 + r < v_coarse) {
    beg = starts[m0 + r];
    end = starts[m0 + r + 1];
  }
  float acc[2][BN / 16][4] = {};
  for (int q = 0;; ++q) {
    // round q: idx[j][r] = row r's q-th child of slot j, -1 for none.
    // `seen` counts the children of each slot walked so far, 8 bits each
    // (at most 8 children of one slot share a cell).
    bool has = false;
    if (r < mma::kBM) {
#pragma unroll
      for (int j = 0; j < kSlots; ++j) s.idx[j * mma::kBM + r] = -1;
      unsigned long long seen = 0;
      for (int i = beg; i < end; ++i) {
        const int f = perm[i];
        if (parent[f] < 0) continue;
        const int sl = slot[f] & (kSlots - 1);
        if (static_cast<int>((seen >> (8 * sl)) & 0xffu) == q) {
          s.idx[sl * mma::kBM + r] = f;
          has = true;
        }
        seen += 1ull << (8 * sl);
      }
    }
    // barrier for idx; stop once no row of the tile has a q-th round
    if (!__syncthreads_or(has)) break;
    const int n_present = mma::present_offsets(s, kSlots);
    mma::gather_mma_tile<BN>(s, n_present, feats, w, c_in, c_out, n0, acc);
    // other warps may still be multiplying the last stage: nobody
    // rewrites idx or refills the ring before they are done
    __syncthreads();
  }
  mma::store_tile<BN>(acc, out, v_coarse, c_out, m0, n0);
}

template <typename T>
void launch_down(const void* feats, const void* w, const void* parent,
                 const void* slot, const void* perm, const void* starts,
                 void* out, int v_coarse, int c_in, int c_out,
                 cudaStream_t s) {
  const dim3 grid((v_coarse + kBM - 1) / kBM, (c_out + kBN - 1) / kBN);
  strided_down_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(feats), static_cast<const T*>(w),
      static_cast<const int*>(parent), static_cast<const int*>(slot),
      static_cast<const int*>(perm), static_cast<const int*>(starts),
      static_cast<T*>(out), v_coarse, c_in, c_out);
}

template <typename T>
void launch_up(const void* feats, const void* w, const void* parent,
               const void* slot, void* out, int v_fine, int c_in, int c_out,
               cudaStream_t s) {
  const dim3 grid((v_fine + kBM - 1) / kBM, (c_out + kBN - 1) / kBN);
  strided_up_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(feats), static_cast<const T*>(w),
      static_cast<const int*>(parent), static_cast<const int*>(slot),
      static_cast<T*>(out), v_fine, c_in, c_out);
}

}  // namespace

// feats (V_fine, C_in), w (8, C_in, C_out), parent/slot/perm (V_fine,),
// starts (V_coarse + 1,) -> out (V_coarse, C_out)
extern "C" int taseg_strided_down(const void* feats, const void* w,
                                  const void* parent, const void* slot,
                                  const void* perm, const void* starts,
                                  void* out, int v_fine, int v_coarse,
                                  int c_in, int c_out, int dtype,
                                  void* stream) {
  if (v_fine <= 0 || v_coarse <= 0 || c_in <= 0 || c_out <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == taseg::kF32) {
    launch_down<float>(feats, w, parent, slot, perm, starts, out, v_coarse,
                       c_in, c_out, s);
  } else if (dtype == taseg::kBF16) {
    launch_down<__nv_bfloat16>(feats, w, parent, slot, perm, starts, out,
                               v_coarse, c_in, c_out, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// feats (V_coarse, C_in), w (8, C_in, C_out), parent/slot (V_fine,)
// -> out (V_fine, C_out)
extern "C" int taseg_strided_up(const void* feats, const void* w,
                                const void* parent, const void* slot,
                                void* out, int v_fine, int c_in, int c_out,
                                int dtype, void* stream) {
  if (v_fine <= 0 || c_in <= 0 || c_out <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == taseg::kF32) {
    launch_up<float>(feats, w, parent, slot, out, v_fine, c_in, c_out, s);
  } else if (dtype == taseg::kBF16) {
    launch_up<__nv_bfloat16>(feats, w, parent, slot, out, v_fine, c_in,
                             c_out, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// bf16 only; C_in and C_out multiples of 8, feats and w 16-byte aligned.
// feats (V_fine, C_in), w (8, C_in, C_out), parent/slot/perm (V_fine,),
// starts (V_coarse + 1,) -> out (V_coarse, C_out)
extern "C" int taseg_strided_down_mma(const void* feats, const void* w,
                                      const void* parent, const void* slot,
                                      const void* perm, const void* starts,
                                      void* out, int v_coarse, int c_in,
                                      int c_out, void* stream) {
  if (v_coarse <= 0 || c_in <= 0 || c_out <= 0 || c_in % 8 != 0 ||
      c_out % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  return mma::with_tile_n(c_out, [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    return mma::launch_tiles<BN>(
        strided_down_mma_kernel<BN>, kSlots, v_coarse, c_out,
        static_cast<cudaStream_t>(stream), static_cast<const bf16*>(feats),
        static_cast<const bf16*>(w), static_cast<const int*>(parent),
        static_cast<const int*>(slot), static_cast<const int*>(perm),
        static_cast<const int*>(starts), static_cast<bf16*>(out), v_coarse,
        c_in, c_out);
  });
}

// bf16 only; C_in and C_out multiples of 8, feats and w 16-byte aligned
extern "C" int taseg_strided_up_mma(const void* feats, const void* w,
                                    const void* parent, const void* slot,
                                    void* out, int v_fine, int c_in,
                                    int c_out, void* stream) {
  if (v_fine <= 0 || c_in <= 0 || c_out <= 0 || c_in % 8 != 0 ||
      c_out % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  return mma::with_tile_n(c_out, [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    return mma::launch_tiles<BN>(
        strided_up_mma_kernel<BN>, kSlots, v_fine, c_out,
        static_cast<cudaStream_t>(stream), static_cast<const bf16*>(feats),
        static_cast<const bf16*>(w), static_cast<const int*>(parent),
        static_cast<const int*>(slot), static_cast<bf16*>(out), v_fine, c_in,
        c_out);
  });
}
