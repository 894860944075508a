// K4 k3_conv_dw and K5 strided_dw: the weight gradients of the stride-1
// k3 conv and of the ks=2 / stride=2 conv pair.
//
// K4 replaces the d_W half of taseg_tpu/ops/f3conv.py:219 f3_bwd_fused
// (the backward of ops/tgf.py:216 tgf_conv_apply, _tgf_vjp_bwd :231):
//
//   d_W[k] = sum_i feats[i]^T (x) g[rb_bwd[k, i]]     (rb_bwd == -1: none)
//
// with rb_bwd the flipped rulebook: rb_bwd[k, i] = v <=> rb_fwd[k, v] = i.
// K5 replaces the d_W einsums of taseg_tpu/ops/strided_conv.py:136
// _down_bwd and :169 _up_bwd:
//
//   d_W[s] = sum_{f : slot(f) = s, parent(f) >= 0} X[f]^T (x) Y[f]
//   down: X[f] = feats_fine[f],           Y[f] = g_coarse[parent f]
//   up:   X[f] = feats_coarse[parent f],  Y[f] = g_fine[f]
//
// Both are a sum over (x row, y row) pairs per output index o (the
// offset k or the slot s).  Inputs f32 or bf16, products and sums in f32,
// out f32 (n_out, C_in, C_out); the wrappers round it to the weight's
// dtype.
//
// Bound on the H100: operations at the wide levels, bytes at the narrow
// ones.  Each present pair costs 2 C_in C_out flops; the path's 48 k3
// convs hold ~184 GFLOP of present pairs per step (the forward's count),
// 0.19 ms at the bf16 tensor-core rate and 2.7 ms at the 67 TFLOP/s of
// f32 CUDA cores.  The bytes (feats, grad and the tables read once, d_W
// written once) are 0.39 ms per step.  K5 has at most one pair per fine
// row: ~12 GFLOP per step, so its 0.047 ms of bytes set its floor.
//
// Two routes for each; the wrappers pick one by dtype and widths
// (f3conv.dw_route):
//
// dw_mma_kernel (bf16, C_in % 8 == 0, C_out % 8 == 0: 47 of the 48 convs
// of a step): tensor cores over pair lists built once per level.  The
// topology compacts the present (i, rb_bwd[k, i]) pairs of each offset
// k, in row order (f3conv.k3_pair_lists), into one (27 V,) int2 list with
// a (28,) start table on the device; every conv of the level shares it.
// d_W[k] is then a dense product over k's pair list,
//
//   d_W[k] = X_k^T Y_k,  X_k = feats[i of k's pairs], Y_k = g[j of them],
//
// with the contraction over pairs.  A block owns (a 64-row C_in tile, a
// BN-column C_out tile, offset k, a split of k's list); it stages up to
// kWin pairs in shared memory, then gathers X and Y rows, 32 pairs per
// stage, by 16-byte cp.async into a 4-stage ring (the list is known
// before the loop, so three stages are in flight while one multiplies),
// and multiplies them with mma.sync m16n8k16 bf16 -> f32: X^T through
// ldmatrix .trans (X is stored pair-major), Y through ldmatrix .trans as
// gather_mma.cuh reads W.  Pairs past the list's end copy 0 bytes and
// add 0.  Against the CUDA-core kernel below, which tested 256 rows per
// window and multiplied the ~21 pairs it found in 16-pair rounds with no
// loads in flight, every stage here is full and prefetched.
//
// K5 runs the same tile with the 8 slots as the lists: every live fine
// row f has one slot, so the train topology compacts the (f, parent f)
// pairs slot by slot, in row order, into one (V_fine,) int2 list with a
// (9,) start table (strided_conv.slot_pair_lists); the down and the up
// conv of a level share it, the up direction reading each pair swapped
// (X = coarse feats[parent f], Y = fine grad[f]).  Against the CUDA-core
// kernel, whose blocks each scanned every row of the tables for the ~1/8
// of their slot, each list is read once.
//
// Splits of a pair list come from the shapes alone (f3conv.dw_mma_splits:
// `per_split` pairs, enough splits to cover V, the most any list can
// have, within 32 MiB of partials); the counts stay on the device.  A
// split past its list's count does nothing, and the reduction reads
// only the splits a list's count reaches, in split order.
//
// dw_kernel (f32, and ragged widths such as the stem's 4 -> 32, for K4
// and K5): CUDA cores, f32 FMA on operands widened in shared memory:
#include <algorithm>

#include "common.cuh"
#include "gather_mma.cuh"

namespace {

using taseg::to_f;

constexpr int kTI = 64;  // input channels per tile
constexpr int kTO = 64;  // output channels per tile
constexpr int kBR = 16;  // pairs per shared-memory stage
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// K4: pair (i, rb_bwd[k, i]) of offset k
struct PairsK3 {
  const int* rb;
  int v;
  __device__ __forceinline__ bool get(int o, int i, int& xr, int& yr) const {
    const int y = rb[static_cast<size_t>(o) * v + i];
    xr = i;
    yr = y;
    return y >= 0;
  }
};

// K5: fine row f of slot o with a parent; `up` swaps the two sides
struct PairsStrided {
  const int* parent;
  const int* slot;
  int up;
  __device__ __forceinline__ bool get(int o, int f, int& xr, int& yr) const {
    const int p = parent[f];
    if (p < 0 || (slot[f] & 7) != o) return false;
    xr = up ? p : f;
    yr = up ? f : p;
    return true;
  }
};

// grid: x = C_in tiles * C_out tiles, y = output index o, z = split.
// Writes the split's (n_out, C_in, C_out) partial at out + z * n_out *
// C_in * C_out.
template <typename T, typename Pairs>
__global__ void __launch_bounds__(kThreads)
    dw_kernel(const T* __restrict__ x, const T* __restrict__ y, Pairs pairs,
              float* __restrict__ out, int n_rows, int rows_per_split,
              int c_in, int c_out) {
  __shared__ float As[kBR][kTI];
  __shared__ float Bs[kBR][kTO];
  __shared__ int xs[kThreads];
  __shared__ int ys[kThreads];
  __shared__ int warp_cnt[kWarps];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int tiles_o = (c_out + kTO - 1) / kTO;
  const int i0 = (blockIdx.x / tiles_o) * kTI;
  const int o0 = (blockIdx.x % tiles_o) * kTO;
  const int o = blockIdx.y;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(n_rows, r_begin + rows_per_split);
  float acc[4][4] = {};

  for (int base = r_begin; base < r_end; base += kThreads) {
    // compact this window's present pairs, in row order
    const int r = base + tid;
    int xr = -1, yr = -1;
    const bool ok = r < r_end && pairs.get(o, r, xr, yr);
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) warp_cnt[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_cnt[w];
      before += w < warp ? c : 0;
      n += c;
    }
    if (ok) {
      const int pos = before + __popc(ballot & ((1u << lane) - 1u));
      xs[pos] = xr;
      ys[pos] = yr;
    }
    __syncthreads();
    for (int c0 = 0; c0 < n; c0 += kBR) {
      for (int e = tid; e < kBR * kTI; e += kThreads) {
        const int rr = e / kTI, c = e % kTI, p = c0 + rr, ch = i0 + c;
        As[rr][c] = (p < n && ch < c_in)
                        ? to_f(x[static_cast<size_t>(xs[p]) * c_in + ch])
                        : 0.f;
      }
      for (int e = tid; e < kBR * kTO; e += kThreads) {
        const int rr = e / kTO, c = e % kTO, p = c0 + rr, ch = o0 + c;
        Bs[rr][c] = (p < n && ch < c_out)
                        ? to_f(y[static_cast<size_t>(ys[p]) * c_out + ch])
                        : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < kBR; ++rr) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[rr][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[rr][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  const size_t n_out = gridDim.y;
  float* dst = out + (static_cast<size_t>(blockIdx.z) * n_out + o) *
                         static_cast<size_t>(c_in) * c_out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = i0 + ty * 4 + i;
    if (ci >= c_in) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = o0 + tx * 4 + j;
      if (co < c_out) dst[static_cast<size_t>(ci) * c_out + co] = acc[i][j];
    }
  }
}

// out[e] = sum over splits, in split order, of part[s * n + e]
__global__ void reduce_splits_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, size_t n,
                                     int splits) {
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[static_cast<size_t>(k) * n + e];
    out[e] = s;
  }
}

// ---- K4 on tensor cores, over per-offset pair lists ----
namespace dwmma {

namespace mma = taseg::mma;
using bf16 = __nv_bfloat16;

constexpr int kBM = 64;        // C_in rows of d_W per block
constexpr int kBK = 32;        // pairs per stage
constexpr int kStages = 4;     // cp.async ring depth
constexpr int kThreads = 128;  // 4 warps: 2 (C_in) x 2 (C_out)
constexpr int kWin = 1024;     // pairs staged in shared memory at a time
constexpr int kAS = kBM + mma::kPad;

template <int BN>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kStages) * kBK * kAS * 2 +
         static_cast<size_t>(kStages) * kBK * (BN + mma::kPad) * 2 +
         static_cast<size_t>(kWin) * sizeof(int2);
}

// issue the cp.asyncs of stage t of the window: pairs [t kBK, t kBK + kBK)
template <int BN>
__device__ __forceinline__ void load_stage(bf16* as, bf16* bs,
                                           const int2* ps, int buf, int t,
                                           int n_w, const bf16* x,
                                           const bf16* y, int c_in,
                                           int c_out, int m0, int n0) {
  constexpr int kBS = BN + mma::kPad, kAC = kBM / 8, kBC = BN / 8;
  bf16* a = as + buf * kBK * kAS;
  bf16* b = bs + buf * kBK * kBS;
#pragma unroll
  for (int e = threadIdx.x; e < kBK * kAC; e += kThreads) {
    const int r = e / kAC, cc = (e % kAC) * 8, c = m0 + cc, p = t * kBK + r;
    const bool ok = p < n_w && c < c_in;
    mma::cp_async16(a + r * kAS + cc,
                    ok ? x + static_cast<size_t>(ps[p].x) * c_in + c : x, ok);
  }
#pragma unroll
  for (int e = threadIdx.x; e < kBK * kBC; e += kThreads) {
    const int r = e / kBC, cc = (e % kBC) * 8, col = n0 + cc, p = t * kBK + r;
    const bool ok = p < n_w && col < c_out;
    mma::cp_async16(b + r * kBS + cc,
                    ok ? y + static_cast<size_t>(ps[p].y) * c_out + col : y,
                    ok);
  }
}

// acc += X(stage)^T Y(stage) for this warp's 32 x BN/2 sub-tile.  X is
// stored [pair][C_in]: ldmatrix .trans turns its 8 x 8 blocks into the
// row-major A fragment (lanes 8q..8q+7 address pairs (q / 2) * 8 + 0..7 at
// C_in column (q % 2) * 8: a0..a3 = (m 0-7, k 0-7), (m 8-15, k 0-7),
// (m 0-7, k 8-15), (m 8-15, k 8-15)).
template <int BN>
__device__ __forceinline__ void mma_stage(const bf16* as, const bf16* bs,
                                          int buf,
                                          float (&acc)[2][BN / 16][4]) {
  constexpr int kBS = BN + mma::kPad;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2, q = lane / 8;
  const bf16* a = as + buf * kBK * kAS + ((lane % 8) + (q / 2) * 8) * kAS +
                  wm * 32 + (q % 2) * 8;
  const bf16* b = bs + buf * kBK * kBS + (lane % 16) * kBS + wn * (BN / 2) +
                  (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    unsigned af[2][4];
    mma::ldmatrix_x4_trans(af[0], a + kk * kAS);
    mma::ldmatrix_x4_trans(af[1], a + kk * kAS + 16);
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      unsigned bfr[4];
      mma::ldmatrix_x4_trans(bfr, b + kk * kBS + j * 16);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma::mma_bf16(acc[i][2 * j], af[i], bfr[0], bfr[1]);
        mma::mma_bf16(acc[i][2 * j + 1], af[i], bfr[2], bfr[3]);
      }
    }
  }
}

// The lists of K4 and K5; the tag also tells their kernels apart in a
// profile.
struct K3Lists {
  static constexpr int kOut = 27;  // offsets
};
struct SlotLists {
  static constexpr int kOut = 8;  // slots
};

// grid: x = C_in tiles * C_out tiles, y = list k (of Lists::kOut), z =
// split.  Split z of list k takes pairs [z per_split, (z + 1) per_split)
// of k's list and writes its (C_in, C_out) partial at out + (z * kOut +
// k) C_in C_out; with one split, out is d_W itself.  `swap` reads each
// pair as (y row, x row): K5's up direction over the down direction's
// (fine, parent) lists.
template <int BN, typename Lists>
__global__ void __launch_bounds__(kThreads)
    dw_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                  const int2* __restrict__ pairs,
                  const int* __restrict__ starts, float* __restrict__ out,
                  int c_in, int c_out, int per_split, int swap) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kBS = BN + mma::kPad;
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = as + kStages * kBK * kAS;
  int2* ps = reinterpret_cast<int2*>(bs + kStages * kBK * kBS);
  const int tiles_n = (c_out + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * kBM, n0 = (blockIdx.x % tiles_n) * BN;
  const int k = blockIdx.y;
  const int beg = starts[k], n_k = starts[k + 1] - beg;
  const int lo = blockIdx.z * per_split;
  // nothing to add: the reduction reads no partial of this split
  if (gridDim.z > 1 && lo >= n_k) return;
  const int n_pairs = max(0, min(per_split, n_k - lo));
  float acc[2][BN / 16][4] = {};

  for (int w0 = 0; w0 < n_pairs; w0 += kWin) {
    const int n_w = min(kWin, n_pairs - w0);
    __syncthreads();  // the previous window is consumed
    for (int e = threadIdx.x; e < n_w; e += kThreads) {
      const int2 q = pairs[beg + lo + w0 + e];
      ps[e] = swap ? make_int2(q.y, q.x) : q;
    }
    __syncthreads();
    const int total = (n_w + kBK - 1) / kBK;
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < total)
        load_stage<BN>(as, bs, ps, t, t, n_w, x, y, c_in, c_out, m0, n0);
      mma::cp_async_commit();
    }
    for (int t = 0; t < total; ++t) {
      mma::cp_async_wait<kStages - 2>();  // stage t landed (own part)
      __syncthreads();  // everyone's part; stage t - 1 is consumed
      const int nxt = t + kStages - 1;
      if (nxt < total)
        load_stage<BN>(as, bs, ps, nxt % kStages, nxt, n_w, x, y, c_in,
                       c_out, m0, n0);
      mma::cp_async_commit();
      mma_stage<BN>(as, bs, t % kStages, acc);
    }
    mma::cp_async_wait<0>();
  }

  float* dst = out + (static_cast<size_t>(blockIdx.z) * Lists::kOut + k) *
                         static_cast<size_t>(c_in) * c_out;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + wm * 32 + i * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int col = n0 + wn * (BN / 2) + j * 8 + (lane % 4) * 2;
      if (col >= c_out) continue;  // c_out % 8 == 0: col + 1 < c_out too
      if (r < c_in) {
        dst[static_cast<size_t>(r) * c_out + col] = acc[i][j][0];
        dst[static_cast<size_t>(r) * c_out + col + 1] = acc[i][j][1];
      }
      if (r + 8 < c_in) {
        dst[static_cast<size_t>(r + 8) * c_out + col] = acc[i][j][2];
        dst[static_cast<size_t>(r + 8) * c_out + col + 1] = acc[i][j][3];
      }
    }
  }
}

// out[e] = sum over the splits that list k(e) reaches, in split order
template <typename Lists>
__global__ void dw_mma_reduce_splits_kernel(const float* __restrict__ part,
                                          const int* __restrict__ starts,
                                          float* __restrict__ out,
                                          size_t per_k, int per_split,
                                          int splits) {
  const size_t n = Lists::kOut * per_k;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(e / per_k);
    const int n_k = starts[k + 1] - starts[k];
    const int live = min(splits, (n_k + per_split - 1) / per_split);
    float s = 0.f;
    for (int z = 0; z < live; ++z) s += part[static_cast<size_t>(z) * n + e];
    out[e] = s;
  }
}

// Lists::kOut pair lists -> out (kOut, C_in, C_out) f32, through part
// when splits > 1
template <typename Lists>
int launch_dw_mma(const void* x, const void* y, const void* pairs,
                  const void* starts, void* out, void* part, int c_in,
                  int c_out, int swap, int splits, int per_split,
                  cudaStream_t s) {
  constexpr int n_out = Lists::kOut;
  if (c_in <= 0 || c_out <= 0 || c_in % 8 || c_out % 8 || splits <= 0 ||
      per_split <= 0 || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* dst = static_cast<float*>(splits > 1 ? part : out);
  const int err = mma::with_tile_n(c_out, [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    const size_t bytes = smem_bytes<BN>();
    cudaError_t e = cudaFuncSetAttribute(
        dw_mma_kernel<BN, Lists>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    const int tiles = ((c_in + kBM - 1) / kBM) * ((c_out + BN - 1) / BN);
    dw_mma_kernel<BN, Lists><<<dim3(tiles, n_out, splits), kThreads, bytes, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(y),
        static_cast<const int2*>(pairs), static_cast<const int*>(starts), dst,
        c_in, c_out, per_split, swap);
    return static_cast<int>(cudaGetLastError());
  });
  if (err != 0 || splits == 1) return err;
  const size_t per_k = static_cast<size_t>(c_in) * c_out;
  const int blocks =
      static_cast<int>(std::min<size_t>((n_out * per_k + 255) / 256, 4096));
  dw_mma_reduce_splits_kernel<Lists><<<blocks, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<const int*>(starts),
      static_cast<float*>(out), per_k, per_split, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dwmma

template <typename Pairs>
int launch_dw(const void* x, const void* y, Pairs pairs, void* out,
              void* part, int n_out, int n_rows, int c_in, int c_out,
              int splits, int rows_per_split, int dtype, cudaStream_t s) {
  if (n_out <= 0 || n_rows <= 0 || c_in <= 0 || c_out <= 0 || splits <= 0 ||
      rows_per_split <= 0 ||
      static_cast<long long>(splits) * rows_per_split < n_rows ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ((c_in + kTI - 1) / kTI) * ((c_out + kTO - 1) / kTO);
  const dim3 grid(tiles, n_out, splits);
  float* dst = static_cast<float*>(splits > 1 ? part : out);
  if (dtype == taseg::kF32) {
    dw_kernel<float, Pairs><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(y), pairs,
        dst, n_rows, rows_per_split, c_in, c_out);
  } else if (dtype == taseg::kBF16) {
    dw_kernel<__nv_bfloat16, Pairs><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(y), pairs, dst, n_rows,
        rows_per_split, c_in, c_out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(n_out) * c_in * c_out;
  const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
  reduce_splits_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(part),
                                              static_cast<float*>(out), n,
                                              splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats (V, C_in), grad (V, C_out), rb_bwd (27, V) int32 -> out (27, C_in,
// C_out) f32; part (splits, 27, C_in, C_out) f32 scratch when splits > 1
extern "C" int taseg_k3_conv_dw(const void* feats, const void* grad,
                                const void* rb_bwd, void* out, void* part,
                                int v, int c_in, int c_out, int splits,
                                int rows_per_split, int dtype, void* stream) {
  const PairsK3 pairs{static_cast<const int*>(rb_bwd), v};
  return launch_dw(feats, grad, pairs, out, part, 27, v, c_in, c_out, splits,
                   rows_per_split, dtype, static_cast<cudaStream_t>(stream));
}

// down (up = 0): x = fine feats (V_fine, C_in), y = coarse grad
// (V_coarse, C_out); up (up = 1): x = coarse feats (V_coarse, C_in),
// y = fine grad (V_fine, C_out).  parent/slot (V_fine,) int32 -> out
// (8, C_in, C_out) f32; part as for K4
extern "C" int taseg_strided_dw(const void* x, const void* y,
                                const void* parent, const void* slot,
                                void* out, void* part, int v_fine, int c_in,
                                int c_out, int up, int splits,
                                int rows_per_split, int dtype, void* stream) {
  const PairsStrided pairs{static_cast<const int*>(parent),
                           static_cast<const int*>(slot), up};
  return launch_dw(x, y, pairs, out, part, 8, v_fine, c_in, c_out, splits,
                   rows_per_split, dtype, static_cast<cudaStream_t>(stream));
}

// K4's tensor-core route.  feats (V, C_in), grad (V, C_out) bf16, 16-byte
// aligned, C_in % 8 == 0 and C_out % 8 == 0; pairs (27 V,) int2 and
// starts (28,) int32 from f3conv.k3_pair_lists -> out (27, C_in, C_out)
// f32; part (splits, 27, C_in, C_out) f32 scratch when splits > 1, with
// splits * per_split >= V.
extern "C" int taseg_k3_conv_dw_mma(const void* feats, const void* grad,
                                    const void* pairs, const void* starts,
                                    void* out, void* part, int c_in,
                                    int c_out, int splits, int per_split,
                                    void* stream) {
  return dwmma::launch_dw_mma<dwmma::K3Lists>(
      feats, grad, pairs, starts, out, part, c_in, c_out, 0, splits,
      per_split, static_cast<cudaStream_t>(stream));
}

// K5's tensor-core route.  pairs (V_fine, 2) int32 (fine row, parent)
// and starts (9,) int32 from strided_conv.slot_pair_lists; down (up = 0):
// x = fine feats (V_fine, C_in), y = coarse grad (V_coarse, C_out); up
// (up = 1, the pairs read as (parent, fine row)): x = coarse feats
// (V_coarse, C_in), y = fine grad (V_fine, C_out); bf16, 16-byte aligned,
// C_in % 8 == 0 and C_out % 8 == 0 -> out (8, C_in, C_out) f32; part
// (splits, 8, C_in, C_out) f32 scratch when splits > 1, with splits *
// per_split >= V_fine.
extern "C" int taseg_strided_dw_mma(const void* x, const void* y,
                                    const void* pairs, const void* starts,
                                    void* out, void* part, int c_in,
                                    int c_out, int up, int splits,
                                    int per_split, void* stream) {
  return dwmma::launch_dw_mma<dwmma::SlotLists>(
      x, y, pairs, starts, out, part, c_in, c_out, up, splits, per_split,
      static_cast<cudaStream_t>(stream));
}
