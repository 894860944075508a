// K4 k3_conv_dw and K5 strided_dw: the weight gradients of the stride-1
// k3 conv and of the ks=2 / stride=2 conv pair; K4 at K offsets
// (sparse_conv_dw), the weight gradient of the conv over a general
// kernel volume.
//
// K4 replaces the d_W half of taseg_tpu/ops/f3conv.py:219 f3_bwd_fused
// (the backward of ops/tgf.py:217 tgf_conv_apply, _tgf_vjp_bwd :231):
//
//   d_W[k] = sum_i feats[i]^T (x) g[rb_bwd[k, i]]     (rb_bwd == -1: none)
//
// with rb_bwd the flipped rulebook: rb_bwd[k, i] = v <=> rb_fwd[k, v] = i.
// K4 at K offsets replaces the d_W half of taseg_tpu/ops/sparse_conv.py
// :157 _conv_vjp_bwd (d_W[k] = gathered_k(feats, rb_fwd)^T g), summed
// over the reverse table instead: the same sum, over the same pairs, in
// row order of the input.  rb_bwd (K, V_in) holds rows of g (V_out, C_out),
// and V_in != V_out for the pooling and transposed convs.
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
// row: ~12 GFLOP per step, so its bytes set its floor (0.047 ms per bf16
// MinkUNet step, 0.26 ms per f32 TIAF step).
//
// K4 and K5 run over pair lists: every present pair (x row, y row) of
// an output index o (K4's offset k, K5's slot s) compacted, list by
// list in row order, into one int2 buffer with a start table, on the
// device.  For K4 the topology compacts the (i, rb_bwd[k, i]) pairs of
// each offset into a (27 V,) buffer with (28,) starts
// (f3conv.k3_pair_lists), once per level and step, shared by every conv
// of the level.  For K5 every live fine row f has one slot, so the train
// topology compacts the (f, parent f) pairs slot by slot into a (V_fine,)
// buffer with (9,) starts (strided_conv.slot_pair_lists); the down and
// the up conv of a level share it, the up direction reading each pair
// swapped (X = coarse feats[parent f], Y = fine grad[f]).  d_W[o] is then
// a dense product over o's list,
//
//   d_W[o] = X_o^T Y_o,  X_o = x[x rows of o's pairs], Y_o = y[y rows],
//
// with the contraction over pairs.
//
// dw_wgmma_kernel (namespace lists; bf16, widths in 8s: K4's 47 of the
// 48 convs of a step, every K5 call of the bf16 steps): Hopper's
// warpgroup MMA, one launch per call.  A block owns (64 CW C_in rows,
// BN C_out columns, list o, a split of o's list).  A = X^T and B = Y are
// both gathered pair-major, so both operands are MN-major (tnspA = tnspB
// = 1): A in 128-byte swizzled atoms of 8 pairs x 64 channels, one atom
// column per consumer warpgroup, B in the atoms K2's W takes
// (wgmma_tile.cuh).  The producer warpgroup stages each window of the
// list's pairs in shared memory (the next window's pairs in registers
// meanwhile) and gathers X and Y rows, 64 pairs a stage, by 16-byte
// cp.async into a 4-stage mbarrier ring; CW consumer warpgroups run
// m64nBNk16 over them.  K4's tile (f3conv.k4_tile): the whole C_out up
// to 256 columns, so each gathered x row feeds all of C_out once, and two
// consumer warpgroups (128 C_in rows) where C_in >= 128, so each gathered
// g row feeds 128 of them (at 384 -> 256 a g row is gathered 3 times and
// a feats row once; the mma.sync tile before it, 64 x <= 128, gathered
// them 6 and 2 times).  K5's: one consumer warpgroup, C_out up to 128.
//
// Splits and pieces (lists::split_pairs, piece_of, finish_pieces): a
// list is cut into splits of `per` pairs.  K5 takes per from the shapes
// (f3conv.k5_splits); K4 from the lists' lengths, read on the device:
// the least per, at least K4_MIN_PAIRS, at which the pieces fill one
// wave of the H100's SMs (f3conv.k4_plan's target).  Split z of list o is piece
// (starts[o] - starts[0]) / per + o + z (no two lists collide, all below
// total / per + kOut), and the grid has one block per (tile, piece), so
// no block waits on a split past its list's end.  A list of one split
// writes d_W[o] directly; else each split writes its partial to its
// piece and counts on its (tile, list) counter, and the last split to
// arrive adds the pieces in split order with all its threads, writes the
// tile and sets the counter back to 0.  So a call is one launch and the
// same inputs give the same bits.  K4's mma.sync tile before it
// (dw_mma_kernel; now only chip_smoke.py's yardstick) took its
// splits from a cap on the partials, 6 912 blocks at 32 -> 32 of which
// most exited at once, a (splits, 27, C_in, C_out) buffer and a second
// launch to add them, and drained its cp.async ring at each window.
//
// dw_tf32_wgmma_kernel (namespace lists; f32, widths in 4s: K4 at K
// offsets, every weight gradient of Cylinder3D and of the f32 MinkUNets'
// 3^3 convs, over the per-offset lists of f3conv.pair_lists, and K5 in
// f32, TIAF's 16 calls a step, over the slot lists): Hopper's wgmma on
// 3xTF32 (wgmma_tf32_dw.cuh: A = X^T split in registers, B = Y transposed
// and split K-major in shared memory by the producer warpgroup), one
// launch a call over the pieces above (split_pairs at 32-pair stages,
// f3conv.dw_tf32_plan's target).  It replaced two mma.sync tiles, kept
// only as chip_smoke.py's yardstick `old_ms` (C entries
// taseg_sparse_conv_dw_tf32_mma, taseg_strided_dw_tf32_mma):
// sparse_conv_dw_tf32_kernel, the mma.sync pair-list tile in f32 on 3xTF32
// tensor cores (16 pairs per stage, mma.sync m16n8k8 .tf32 with each
// operand split into TF32 high and low parts and each product taken as
// three: gather_mma.cuh, namespace tf32), its splits from a cap on the
// partials, a (splits, K, C_in, C_out) buffer and a second launch
// (dw_mma_reduce_splits_kernel) to add them; and strided_dw_tf32_kernel,
// that tile over the slot lists with the pieces above (it replaced the
// CUDA-core dw_kernel over the parent and slot tables, whose every block
// scanned all fine rows for the ~1/8 of its slot and multiplied them in
// f32 FMA).
//
// dw_kernel (a direct f32 call of K4 at 27, a bf16 call of K4 at K;
// K5's CUDA-core kernel, off every route since the wrappers pad ragged
// widths onto the tensor-core ones, kept as their yardstick): CUDA
// cores, f32 FMA on operands widened in shared memory:
#include <algorithm>

#include "common.cuh"
#include "gather_mma.cuh"
#include "wgmma_tf32_dw.cuh"
#include "wgmma_tile.cuh"

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

// K4 at K offsets (sparse_conv_dw): pair (i, rb_bwd[k, i]) of offset k
// over the V_in input rows; the grad rows it names are output rows of
// the forward (V_out of them), so the two sides have their own row
// counts.  A type of its own so that a profile tells it from K4 at 27.
struct PairsOffsets {
  const int* rb;
  int v_in;
  __device__ __forceinline__ bool get(int o, int i, int& xr, int& yr) const {
    const int y = rb[static_cast<size_t>(o) * v_in + i];
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
struct OffsetLists {};  // K4 at K offsets: K at run time

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
// (n_out lists; Lists names the kernel in a profile)
template <typename Lists>
__global__ void dw_mma_reduce_splits_kernel(const float* __restrict__ part,
                                          const int* __restrict__ starts,
                                          float* __restrict__ out, int n_out,
                                          size_t per_k, int per_split,
                                          int splits) {
  const size_t n = static_cast<size_t>(n_out) * per_k;
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
      static_cast<float*>(out), n_out, per_k, per_split, splits);
  return static_cast<int>(cudaGetLastError());
}

// ---- K4 at K offsets on 3xTF32 tensor cores, over per-offset pair lists
namespace dwtf32 {

namespace tf = taseg::tf32;

constexpr int kBM = 64;        // C_in rows of d_W per block
constexpr int kBK = 16;        // pairs per stage
constexpr int kStages = 4;     // cp.async ring depth
constexpr int kThreads = 128;  // 4 warps: 2 (C_in) x 2 (C_out)
constexpr int kWin = 1024;     // pairs staged in shared memory at a time
constexpr int kAS = kBM + 8;   // floats per shared X row (pair-major)

template <int BN>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kStages) * kBK * kAS * 4 +
         static_cast<size_t>(kStages) * kBK * tf::b_stride<BN>() * 4 +
         static_cast<size_t>(kWin) * sizeof(int2);
}

// issue the cp.asyncs of stage t of the window: pairs [t kBK, t kBK + kBK)
template <int BN>
__device__ __forceinline__ void load_stage(float* as, float* bs, const int2* ps,
                                           int buf, int t, int n_w,
                                           const float* x, const float* y,
                                           int c_in, int c_out, int m0, int n0) {
  constexpr int kBS = tf::b_stride<BN>(), kAC = kBM / 4, kBC = BN / 4;
  float* a = as + buf * kBK * kAS;
  float* b = bs + buf * kBK * kBS;
#pragma unroll
  for (int e = threadIdx.x; e < kBK * kAC; e += kThreads) {
    const int r = e / kAC, cc = (e % kAC) * 4, c = m0 + cc, p = t * kBK + r;
    const bool ok = p < n_w && c < c_in;
    mma::cp_async16(a + r * kAS + cc,
                    ok ? x + static_cast<size_t>(ps[p].x) * c_in + c : x, ok);
  }
#pragma unroll
  for (int e = threadIdx.x; e < kBK * kBC; e += kThreads) {
    const int r = e / kBC, cc = (e % kBC) * 4, col = n0 + cc, p = t * kBK + r;
    const bool ok = p < n_w && col < c_out;
    mma::cp_async16(b + r * kBS + cc,
                    ok ? y + static_cast<size_t>(ps[p].y) * c_out + col : y, ok);
  }
}

// acc += X(stage)^T Y(stage) for this warp's 32 x BN/2 sub-tile; X is
// stored [pair][C_in], so A = X^T reads a(m, k) = X[k][m]: with g = lane /
// 4, t = lane % 4 the fragment (m g, k t), (m g + 8, k t), (m g, k t + 4),
// (m g + 8, k t + 4) sits at X[t][g], X[t][g + 8], X[t + 4][g], X[t + 4][g
// + 8]; the 72-float row stride puts the 32 lanes on 32 banks
template <int BN>
__device__ __forceinline__ void mma_stage(const float* as, const float* bs, int buf,
                                          float (&acc)[2][BN / 16][4]) {
  constexpr int kBS = tf::b_stride<BN>();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2, g = lane / 4, t = lane % 4;
  const float* a = as + buf * kBK * kAS + t * kAS + wm * 32 + g;
  const float* b = bs + buf * kBK * kBS + t * kBS + wn * (BN / 2) + g;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    unsigned ah[2][4], al[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* p = a + kk * kAS + i * 16;
      tf::split(p[0], ah[i][0], al[i][0]);
      tf::split(p[8], ah[i][1], al[i][1]);
      tf::split(p[4 * kAS], ah[i][2], al[i][2]);
      tf::split(p[4 * kAS + 8], ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const float* p = b + kk * kBS + j * 8;
      unsigned bh[2], bl[2];
      tf::split(p[0], bh[0], bl[0]);
      tf::split(p[4 * kBS], bh[1], bl[1]);
#pragma unroll
      for (int i = 0; i < 2; ++i) tf::mma_3xtf32(acc[i][j], ah[i], al[i], bh, bl);
    }
  }
}

// grid: x = C_in tiles * C_out tiles, y = offset k (of n_out = gridDim.y),
// z = split.  Split z of list k takes pairs [z per_split, (z + 1)
// per_split) of k's list and writes its (C_in, C_out) partial at out + (z
// * n_out + k) C_in C_out; with one split, out is d_W itself.
template <int BN>
__global__ void __launch_bounds__(kThreads)
    sparse_conv_dw_tf32_kernel(const float* __restrict__ x,
                               const float* __restrict__ y,
                               const int2* __restrict__ pairs,
                               const int* __restrict__ starts,
                               float* __restrict__ out, int c_in, int c_out,
                               int per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kBS = tf::b_stride<BN>();
  float* as = reinterpret_cast<float*>(smem);
  float* bs = as + kStages * kBK * kAS;
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
    for (int e = threadIdx.x; e < n_w; e += kThreads) ps[e] = pairs[beg + lo + w0 + e];
    __syncthreads();
    const int total = (n_w + kBK - 1) / kBK;
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < total) load_stage<BN>(as, bs, ps, t, t, n_w, x, y, c_in, c_out, m0, n0);
      mma::cp_async_commit();
    }
    for (int t = 0; t < total; ++t) {
      mma::cp_async_wait<kStages - 2>();  // stage t landed (own part)
      __syncthreads();  // everyone's part; stage t - 1 is consumed
      const int nxt = t + kStages - 1;
      if (nxt < total)
        load_stage<BN>(as, bs, ps, nxt % kStages, nxt, n_w, x, y, c_in, c_out, m0, n0);
      mma::cp_async_commit();
      mma_stage<BN>(as, bs, t % kStages, acc);
    }
    mma::cp_async_wait<0>();
  }

  float* dst = out + (static_cast<size_t>(blockIdx.z) * gridDim.y + k) *
                         static_cast<size_t>(c_in) * c_out;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + wm * 32 + i * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int col = n0 + wn * (BN / 2) + j * 8 + (lane % 4) * 2;
      if (col >= c_out) continue;  // c_out % 4 == 0: col + 1 < c_out too
      if (r < c_in)
        *reinterpret_cast<float2*>(dst + static_cast<size_t>(r) * c_out + col) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (r + 8 < c_in)
        *reinterpret_cast<float2*>(dst + static_cast<size_t>(r + 8) * c_out + col) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

int launch(const void* x, const void* y, const void* pairs, const void* starts,
           void* out, void* part, int c_in, int c_out, int n_out, int splits,
           int per_split, cudaStream_t s) {
  if (c_in <= 0 || c_out <= 0 || c_in % 4 || c_out % 4 || n_out <= 0 ||
      n_out > 32 || splits <= 0 || per_split <= 0 ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* dst = static_cast<float*>(splits > 1 ? part : out);
  const int err = tf::with_tile_n_f32(c_out, [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    const size_t bytes = smem_bytes<BN>();
    cudaError_t e = cudaFuncSetAttribute(
        sparse_conv_dw_tf32_kernel<BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    const int tiles = ((c_in + kBM - 1) / kBM) * ((c_out + BN - 1) / BN);
    sparse_conv_dw_tf32_kernel<BN><<<dim3(tiles, n_out, splits), kThreads, bytes, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const int2*>(pairs), static_cast<const int*>(starts), dst,
        c_in, c_out, per_split);
    return static_cast<int>(cudaGetLastError());
  });
  if (err != 0 || splits == 1) return err;
  const size_t per_k = static_cast<size_t>(c_in) * c_out;
  const int blocks =
      static_cast<int>(std::min<size_t>((n_out * per_k + 255) / 256, 4096));
  dw_mma_reduce_splits_kernel<OffsetLists><<<blocks, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<const int*>(starts),
      static_cast<float*>(out), n_out, per_k, per_split, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dwtf32

}  // namespace dwmma

// ---- K4 and K5 over pair lists, one launch per call ----
//
// What K4's 27 offset lists and K5's 8 slot lists share (`Lists::kOut`
// lists, consecutive in one pair buffer): the pairs per split, the
// pieces of the splits, the last block's sum of them, and the bf16 wgmma
// tile that runs over them.
namespace lists {

namespace wg = taseg::wg;
using bf16 = __nv_bfloat16;

// K4's lists (27 offsets) and K5's (8 slots); the tag also names the
// kernel in a profile
struct K3Lists {
  static constexpr int kOut = 27;
};
struct SlotLists {
  static constexpr int kOut = 8;
};

// Pairs per split: with a target, the least multiple of `stage`, at
// least per_min, at which the lists' pieces (each list at least one)
// number at most `target`, or the longest list's length where none does
// (every list in one piece); target 0: per_min.  Found by bisection over
// the lists' lengths, one lane per list (n_out <= 32), each warp on its
// own: the split follows the data, nothing is read back on the host, and
// every block of a call computes the same number from the same starts.
// Call it from all 32 lanes of every warp.
__device__ __forceinline__ int split_pairs(const int* __restrict__ starts, int n_out,
                                           int per_min, int target, int stage) {
  if (target <= 0) return per_min;
  const int lane = threadIdx.x % 32;
  const int n = lane < n_out ? starts[lane + 1] - starts[lane] : 0;
  const int longest = __reduce_max_sync(0xffffffffu, n);
  int lo = max(1, (per_min + stage - 1) / stage);  // in stages
  int hi = max(lo, (longest + stage - 1) / stage);
  while (lo < hi) {
    const int mid = (lo + hi) / 2, per = mid * stage;
    const int pieces =
        __reduce_add_sync(0xffffffffu, lane < n_out ? max(1, (n + per - 1) / per) : 0);
    if (pieces <= target)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo * stage;
}

// Split z of list k is its piece p(k, z) = (starts[k] - starts[0]) / per
// + k + z of the partial buffer: the lists are consecutive in the pair
// buffer, so these indices never collide and stay below total / per + N
// (with split_pairs' target: below max(target, N) + N).
// A list of one piece (at most `per` pairs, or none) is written straight
// to out.  piece_of gives the (list, split) of piece p (blockIdx.y: one
// block per piece, no block for a split past its list's end); false for
// the few indices between two lists' pieces and past the last.
__device__ __forceinline__ bool piece_of(const int* __restrict__ starts, int n, int p, int per,
                                         int& k, int& z, int& live) {
  const int s0 = starts[0];
  for (int kk = 0; kk < n; ++kk) {
    const int fp = (starts[kk] - s0) / per + kk;
    const int lv = max(1, (starts[kk + 1] - starts[kk] + per - 1) / per);
    if (p >= fp && p < fp + lv) {
      k = kk;
      z = p - fp;
      live = lv;
      return true;
    }
  }
  return false;
}

// After the block's (C_in, C_out) tile [m0, m0 + bm) x [n0, n0 + bn) of
// piece `pc` is in part: count it on cnt (its list's and tile's
// counter), and if it is the last of `live` pieces to arrive, write the
// tile of out as the sum of the pieces in split order and set the
// counter back to 0.  `t` of `nt` threads take part, each summing its
// own float4s of the tile over the pieces; `sync` is their barrier.
template <typename Sync>
__device__ __forceinline__ void finish_pieces(const float* part, float* out, int* cnt,
                                              int* flag, int p0, int live, int c_in,
                                              int c_out, int m0, int n0, int bm, int bn,
                                              int t, int nt, Sync sync) {
  __threadfence();
  sync();
  if (t == 0) *flag = atomicAdd(cnt, 1) == live - 1;
  sync();
  if (!*flag) return;
  __threadfence();
  const size_t per_piece = static_cast<size_t>(c_in) * c_out;
  const int c4 = bn / 4;
  for (int e = t; e < bm * c4; e += nt) {
    const int r = m0 + e / c4, col = n0 + (e % c4) * 4;
    if (r >= c_in || col >= c_out) continue;  // c_out % 4 == 0
    const size_t at = static_cast<size_t>(r) * c_out + col;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int z = 0; z < live; ++z) {
      const float4 q = __ldcg(reinterpret_cast<const float4*>(part + (p0 + z) * per_piece + at));
      s.x += q.x;
      s.y += q.y;
      s.z += q.z;
      s.w += q.w;
    }
    *reinterpret_cast<float4*>(out + at) = s;
  }
  if (t == 0) *cnt = 0;
}

// ---- bf16: wgmma over the lists ----
// A = X^T (C_in rows x 64 pairs per stage) and B = Y (64 pairs x BN
// C_out columns) are both gathered pair-major, so both are MN-major:
// 128-byte (or, for B at BN = 96, 64-byte) swizzled atoms of 8 pair rows,
// A in atom columns of 64 channels (128 bytes), one per consumer
// warpgroup, read with tnspA = tnspB = 1.  The producer warpgroup stages
// each window of the piece's pairs in shared memory and gathers the rows
// by cp.async into the mbarrier ring of wgmma_tile.cuh; each consumer
// warpgroup runs m64nBNk16 on its 64 C_in rows and stores them.
constexpr int kBK = 64;     // pairs per stage
constexpr int kWin = 1024;  // pairs staged in shared memory at a time
constexpr int kABytes = wg::kBM * kBK * 2;  // one 64-channel atom column
constexpr int kProd = 128;  // the producer warpgroup

template <int BN>
struct WgTile {
  static constexpr int BSW = BN % 64 == 0 ? 128 : 64;  // B swizzle bytes
  static constexpr int AW = BSW / 2;                   // B columns per atom
  static constexpr int B_BYTES = kBK * BN * 2;
};

template <int CW, int BN>
constexpr size_t wg_smem_bytes() {
  return 1024 + static_cast<size_t>(wg::kStages) * (CW * kABytes + WgTile<BN>::B_BYTES) +
         2 * wg::kStages * 8 + static_cast<size_t>(kWin) * sizeof(int2);
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// this producer thread's pairs [w0 + pt + 128 j] of the piece (zeros
// past its end), loaded into registers
template <int J>
__device__ __forceinline__ void fetch_window(int2 (&nxt)[J], const int2* __restrict__ src,
                                             int w0, int n_pairs, int pt) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int e = w0 + pt + j * kProd;
    nxt[j] = e < n_pairs ? src[e] : make_int2(0, 0);
  }
}

// producer warpgroup: the piece's n_pairs pairs at src, window by
// window; each window's pairs are loaded into registers while the window
// before it is issued, so no barrier but the producers' own stands
// between two windows
template <int CW, int BN>
__device__ __forceinline__ void produce_pairs(uint32_t a_ring, uint32_t b_ring, uint64_t* empty,
                                        uint64_t* full, int2* ps, const int2* __restrict__ src,
                                        int n_pairs, int swap, const bf16* __restrict__ x,
                                        const bf16* __restrict__ y, int c_in, int c_out,
                                        int m0, int n0) {
  using T = WgTile<BN>;
  constexpr int A_BYTES = CW * kABytes, AC = CW * wg::kBM / 8, BC = BN / 8;
  constexpr int ATOM_C = T::AW / 8, J = kWin / kProd;
  const int pt = threadIdx.x % kProd;
  int2 nxt[J];
  fetch_window(nxt, src, 0, n_pairs, pt);
  for (int w0 = 0; w0 < n_pairs; w0 += kWin) {
    const int n_w = min(kWin, n_pairs - w0);
    named_sync(1, kProd);  // every producer has issued the previous window
#pragma unroll
    for (int j = 0; j < J; ++j)
      ps[pt + j * kProd] = swap ? make_int2(nxt[j].y, nxt[j].x) : nxt[j];
    named_sync(1, kProd);
    if (w0 + kWin < n_pairs) fetch_window(nxt, src, w0 + kWin, n_pairs, pt);
    const int stages = (n_w + kBK - 1) / kBK;
    for (int t = 0; t < stages; ++t) {
      const int i = w0 / kBK + t, st = i % wg::kStages;
      wg::mbar_wait(empty + st, ((i / wg::kStages) & 1) ^ 1);
      const uint32_t a = a_ring + st * A_BYTES, b = b_ring + st * T::B_BYTES;
#pragma unroll
      for (int e = pt; e < kBK * AC; e += kProd) {
        const int r = e / AC, cc = e % AC, c = m0 + cc * 8, q = t * kBK + r;
        const bool ok = q < n_w && c < c_in;
        wg::cp_async16(a + (cc / 8) * kABytes + (r / 8) * 1024 + (r % 8) * 128 +
                           (wg::swz<128>(r % 8, cc % 8) << 4),
                       ok ? x + static_cast<size_t>(ps[q].x) * c_in + c : x, ok);
      }
#pragma unroll 4
      for (int e = pt; e < kBK * BC; e += kProd) {
        const int r = e / BC, nc = e % BC, col = n0 + nc * 8, q = t * kBK + r;
        const bool ok = q < n_w && col < c_out;
        const int atom = nc / ATOM_C, kr = r % 8;
        wg::cp_async16(b + (atom * (kBK / 8) + r / 8) * (8 * T::BSW) + kr * T::BSW +
                           (wg::swz<T::BSW>(kr, nc % ATOM_C) << 4),
                       ok ? y + static_cast<size_t>(ps[q].y) * c_out + col : y, ok);
      }
      wg::cp_async_arrive(full + st);
    }
  }
}

// consumer warpgroup g: its 64 C_in rows [m0 + 64 g, m0 + 64 g + 64) of
// the tile over the piece's stages, stored at dst (f32, row-major C_in x
// C_out); a warpgroup whose rows all lie past C_in runs no wgmma and only
// releases the stages
template <int CW, int BN>
__device__ __forceinline__ void consume_pairs(uint32_t a_ring, uint32_t b_ring, uint64_t* empty,
                                        uint64_t* full, int n_pairs, float* dst, int c_in,
                                        int c_out, int m0, int n0) {
  using T = WgTile<BN>;
  constexpr int A_BYTES = CW * kABytes;
  const int g = threadIdx.x / 128, lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int r0 = m0 + 64 * g;
  const bool idle = r0 >= c_in;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int n_st = (n_pairs + kBK - 1) / kBK;
  for (int i = 0; i < n_st; ++i) {
    const int st = i % wg::kStages;
    wg::mbar_wait(full + st, (i / wg::kStages) & 1);
    if (!idle) {
      __syncwarp();
      wg::fence_proxy_async();
      const uint32_t a = a_ring + st * A_BYTES + g * kABytes, b = b_ring + st * T::B_BYTES;
      wg::fence_regs(acc);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = wg::make_desc(a + kk * 2 * 1024, kABytes, 1024, 128);
        const uint64_t db =
            wg::make_desc(b + kk * 2 * 8 * T::BSW, kBK * T::BSW, 8 * T::BSW, T::BSW);
        wg::MmaTA<BN>::run(acc, da, db);
      }
      wg::wgmma_commit();
      wg::wgmma_wait<1>();
      wg::fence_regs(acc);
    }
    if (i > 0 && lane == 0) wg::mbar_arrive(empty + (i - 1) % wg::kStages);
  }
  wg::wgmma_wait<0>();
  wg::fence_regs(acc);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + warp * 16 + lane / 4 + 8 * h;
    if (r >= c_in) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + (lane % 4) * 2;
      if (col >= c_out) continue;  // c_out % 8 == 0: col + 1 < c_out too
      *reinterpret_cast<float2*>(dst + static_cast<size_t>(r) * c_out + col) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// grid: x = C_in tiles (64 CW rows) * C_out tiles (BN columns), y =
// piece (`piece_of`, its pairs per split from `split_pairs`).  Threads:
// CW consumer warpgroups, then the producer warpgroup.  `swap` reads each
// pair as (y row, x row): K5's up direction over the (fine, parent)
// lists.  out (kOut, C_in, C_out) f32; part (pieces, C_in, C_out) f32 and
// cnt (kOut * tiles) int32, zero on entry and on exit, where a list
// splits.  The last block of a (list, tile) sums its pieces with all its
// threads.
template <int CW, int BN, typename Lists>
__global__ void __launch_bounds__((CW + 1) * 128, 1)
    dw_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                    const int2* __restrict__ pairs, const int* __restrict__ starts,
                    float* __restrict__ out, float* __restrict__ part, int* __restrict__ cnt,
                    int c_in, int c_out, int per_min, int target, int swap) {
  using T = WgTile<BN>;
  constexpr int kCons = CW * 128, BM = CW * wg::kBM;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int flag;
  const uint32_t base = wg::smem_addr(smem_raw);
  unsigned char* p = smem_raw + (((base + 1023u) & ~1023u) - base);
  const uint32_t a_ring = wg::smem_addr(p);
  const uint32_t b_ring = a_ring + wg::kStages * CW * kABytes;
  p += wg::kStages * (CW * kABytes + T::B_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(p);
  uint64_t* empty = full + wg::kStages;
  int2* ps = reinterpret_cast<int2*>(empty + wg::kStages);

  const int tiles_n = (c_out + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int per = split_pairs(starts, Lists::kOut, per_min, target, kBK);
  int k, z, live;
  if (!piece_of(starts, Lists::kOut, blockIdx.y, per, k, z, live)) return;
  const int beg = starts[k], n_k = starts[k + 1] - beg;
  const int n_pairs = max(0, min(per, n_k - z * per));
  if (threadIdx.x == 0) {
    for (int i = 0; i < wg::kStages; ++i) {
      wg::mbar_init(full + i, kProd);
      wg::mbar_init(empty + i, kCons / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const size_t per_k = static_cast<size_t>(c_in) * c_out;
  if (threadIdx.x >= kCons)
    produce_pairs<CW, BN>(a_ring, b_ring, empty, full, ps, pairs + beg + z * per, n_pairs,
                          swap, x, y, c_in, c_out, m0, n0);
  else
    consume_pairs<CW, BN>(
        a_ring, b_ring, empty, full, n_pairs,
        live == 1 ? out + k * per_k : part + static_cast<size_t>(blockIdx.y) * per_k, c_in,
        c_out, m0, n0);
  if (live == 1) return;
  finish_pieces(part, out + k * per_k, cnt + k * gridDim.x + blockIdx.x, &flag,
                blockIdx.y - z, live, c_in, c_out, m0, n0, BM, BN, threadIdx.x, kCons + kProd,
                [] { __syncthreads(); });
}

// one call of the tile at (CW, BN) over `pieces` pieces
template <int CW, int BN, typename Lists>
int launch_wgmma(const void* x, const void* y, const void* pairs, const void* starts,
                 void* out, void* part, void* cnt, int c_in, int c_out, int pieces,
                 int per_min, int target, int swap, cudaStream_t s) {
  // the attribute once per instance: a launch then sets nothing more
  static const cudaError_t set = cudaFuncSetAttribute(
      dw_wgmma_kernel<CW, BN, Lists>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(wg_smem_bytes<CW, BN>()));
  if (set != cudaSuccess) return static_cast<int>(set);
  const int tiles = ((c_in + CW * wg::kBM - 1) / (CW * wg::kBM)) * ((c_out + BN - 1) / BN);
  dw_wgmma_kernel<CW, BN, Lists>
      <<<dim3(tiles, pieces), (CW + 1) * 128, wg_smem_bytes<CW, BN>(), s>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(y),
          static_cast<const int2*>(pairs), static_cast<const int*>(starts),
          static_cast<float*>(out), static_cast<float*>(part), static_cast<int*>(cnt), c_in,
          c_out, per_min, target, swap);
  return static_cast<int>(cudaGetLastError());
}

// K4 on wgmma at the tile (cw consumer warpgroups, bn columns) that
// f3conv.k4_tile picks: cw 1 or 2, bn 32, 64, 96, 128 or 256
int launch_k4(const void* x, const void* y, const void* pairs, const void* starts, void* out,
              void* part, void* cnt, int c_in, int c_out, int cw, int bn, int pieces,
              int per_min, int target, cudaStream_t s) {
  auto by_n = [&](auto cwc) {
    constexpr int CW = decltype(cwc)::value;
    auto go = [&](auto bnc) {
      return launch_wgmma<CW, decltype(bnc)::value, K3Lists>(
          x, y, pairs, starts, out, part, cnt, c_in, c_out, pieces, per_min, target, 0, s);
    };
    switch (bn) {
      case 32: return go(std::integral_constant<int, 32>{});
      case 64: return go(std::integral_constant<int, 64>{});
      case 96: return go(std::integral_constant<int, 96>{});
      case 128: return go(std::integral_constant<int, 128>{});
      case 256: return go(std::integral_constant<int, 256>{});
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  if (cw == 1) return by_n(std::integral_constant<int, 1>{});
  if (cw == 2) return by_n(std::integral_constant<int, 2>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- f32: the 3xTF32 wgmma tile over the lists (wgmma_tf32_dw.cuh) ----
namespace wtd = taseg::wtd;

struct OffsetLists {};  // K4 at K offsets (n_out <= 32 at run time); names the kernel

// grid: x = C_in tiles (64 rows) * C_out tiles (BN columns), y = piece
// (`piece_of` over the n_out lists, its pairs per split from
// `split_pairs` at 32-pair stages).  Threads: the consumer warpgroup,
// then the producer warpgroup.  `swap` reads each pair as (y row, x row):
// K5's up direction over the (fine, parent) lists.  out (n_out, C_in,
// C_out) f32; part (pieces, C_in, C_out) f32 and cnt (n_out * tiles)
// int32, zero on entry and on exit, where a list splits.  The last block
// of a (list, tile) sums its pieces with all its threads.
template <int BN, typename Lists>
__global__ void __launch_bounds__(wtd::kThreads, wtd::Tile<BN>::MIN_BLOCKS)
    dw_tf32_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ y,
                         const int2* __restrict__ pairs, const int* __restrict__ starts,
                         float* __restrict__ out, float* __restrict__ part, int* __restrict__ cnt,
                         int n_out, int c_in, int c_out, int per_min, int target, int swap) {
  using T = wtd::Tile<BN>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int flag;
  const wtd::Smem s = wtd::carve<T>(smem_raw);
  const int tiles_n = (c_out + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * wtd::kBM, n0 = (blockIdx.x % tiles_n) * BN;
  const int per = split_pairs(starts, n_out, per_min, target, wtd::kBK);
  int k, z, live;
  if (!piece_of(starts, n_out, blockIdx.y, per, k, z, live)) return;
  const int beg = starts[k], n_k = starts[k + 1] - beg;
  const int n_pairs = max(0, min(per, n_k - z * per));
  if (threadIdx.x == 0) wtd::init_barriers<T>(s);
  __syncthreads();

  const size_t per_k = static_cast<size_t>(c_in) * c_out;
  // the warpgroup's role, warp-uniform to the compiler: behind a branch on
  // threadIdx.x alone ptxas serializes every wgmma (C7518, "in divergent
  // path"), as it still does in sparse_conv.cu's 3xTF32 tile
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 1) {
    wtd::produce<T>(s, pairs + beg + z * per, n_pairs, swap, x, y, c_in, c_out, m0, n0);
  } else {
    float acc[BN / 2];
#pragma unroll
    for (int q = 0; q < BN / 2; ++q) acc[q] = 0.f;
    wtd::consume<T>(s, (n_pairs + wtd::kBK - 1) / wtd::kBK, acc);
    wtd::store<BN>(acc, live == 1 ? out + k * per_k : part + static_cast<size_t>(blockIdx.y) * per_k,
                   c_in, c_out, m0, n0);
  }
  if (live == 1) return;
  finish_pieces(part, out + k * per_k, cnt + k * gridDim.x + blockIdx.x, &flag, blockIdx.y - z,
                live, c_in, c_out, m0, n0, wtd::kBM, BN, threadIdx.x, wtd::kThreads,
                [] { __syncthreads(); });
}

// one call of the f32 tile over n_out lists, `pieces` blocks a tile
template <typename Lists>
int launch_tf32(const void* x, const void* y, const void* pairs, const void* starts, void* out,
                void* part, void* cnt, int n_out, int c_in, int c_out, int swap, int pieces,
                int per_min, int target, cudaStream_t s) {
  if (c_in <= 0 || c_out <= 0 || c_in % 4 || c_out % 4 || n_out < 1 || n_out > 32 ||
      pieces < n_out || per_min <= 0 || target < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return taseg::wt::with_tile(c_out, [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    constexpr size_t bytes = wtd::smem_bytes<wtd::Tile<BN>>();
    // the attribute once per instance: a launch then sets nothing more
    static const cudaError_t set = cudaFuncSetAttribute(
        dw_tf32_wgmma_kernel<BN, Lists>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (set != cudaSuccess) return static_cast<int>(set);
    const int tiles = ((c_in + wtd::kBM - 1) / wtd::kBM) * ((c_out + BN - 1) / BN);
    dw_tf32_wgmma_kernel<BN, Lists><<<dim3(tiles, pieces), wtd::kThreads, bytes, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const int2*>(pairs), static_cast<const int*>(starts),
        static_cast<float*>(out), static_cast<float*>(part), static_cast<int*>(cnt), n_out, c_in,
        c_out, per_min, target, swap);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace lists

// ---- K5 over the slot pair lists, one launch per call ----
namespace k5 {

namespace mma = taseg::mma;
namespace tf = taseg::tf32;

// ---- f32: the 3xTF32 tile of K4 at K over the 8 slot lists ----
// grid: x = C_in tiles * C_out tiles, y = piece (`lists::piece_of`).
// `swap` reads each (fine, parent) pair as (parent, fine): the up
// direction.
template <int BN>
__global__ void __launch_bounds__(dwmma::dwtf32::kThreads)
    strided_dw_tf32_kernel(const float* __restrict__ x, const float* __restrict__ y,
                           const int2* __restrict__ pairs, const int* __restrict__ starts,
                           float* __restrict__ out, float* __restrict__ part,
                           int* __restrict__ cnt, int c_in, int c_out, int per_split,
                           int swap) {
  namespace d = dwmma::dwtf32;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kBS = tf::b_stride<BN>();
  float* as = reinterpret_cast<float*>(smem);
  float* bs = as + d::kStages * d::kBK * d::kAS;
  int2* ps = reinterpret_cast<int2*>(bs + d::kStages * d::kBK * kBS);
  __shared__ int flag;
  const int tiles_n = (c_out + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * d::kBM, n0 = (blockIdx.x % tiles_n) * BN;
  int k, z, live;
  if (!lists::piece_of(starts, 8, blockIdx.y, per_split, k, z, live)) return;
  const int beg = starts[k], n_k = starts[k + 1] - beg;
  const int lo = z * per_split;
  const int n_pairs = max(0, min(per_split, n_k - lo));
  float acc[2][BN / 16][4] = {};

  for (int w0 = 0; w0 < n_pairs; w0 += d::kWin) {
    const int n_w = min(d::kWin, n_pairs - w0);
    __syncthreads();  // the previous window is consumed
    for (int e = threadIdx.x; e < n_w; e += d::kThreads) {
      const int2 q = pairs[beg + lo + w0 + e];
      ps[e] = swap ? make_int2(q.y, q.x) : q;
    }
    __syncthreads();
    const int total = (n_w + d::kBK - 1) / d::kBK;
#pragma unroll
    for (int t = 0; t < d::kStages - 1; ++t) {
      if (t < total) d::load_stage<BN>(as, bs, ps, t, t, n_w, x, y, c_in, c_out, m0, n0);
      mma::cp_async_commit();
    }
    for (int t = 0; t < total; ++t) {
      mma::cp_async_wait<d::kStages - 2>();
      __syncthreads();
      const int nxt = t + d::kStages - 1;
      if (nxt < total)
        d::load_stage<BN>(as, bs, ps, nxt % d::kStages, nxt, n_w, x, y, c_in, c_out, m0, n0);
      mma::cp_async_commit();
      d::mma_stage<BN>(as, bs, t % d::kStages, acc);
    }
    mma::cp_async_wait<0>();
  }

  const size_t per_k = static_cast<size_t>(c_in) * c_out;
  const int p0 = blockIdx.y - z;
  float* dst = live == 1 ? out + k * per_k : part + static_cast<size_t>(blockIdx.y) * per_k;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + wm * 32 + i * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int col = n0 + wn * (BN / 2) + j * 8 + (lane % 4) * 2;
      if (col >= c_out) continue;  // c_out % 4 == 0: col + 1 < c_out too
      if (r < c_in)
        *reinterpret_cast<float2*>(dst + static_cast<size_t>(r) * c_out + col) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (r + 8 < c_in)
        *reinterpret_cast<float2*>(dst + static_cast<size_t>(r + 8) * c_out + col) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
  if (live == 1) return;
  lists::finish_pieces(part, out + k * per_k, cnt + k * gridDim.x + blockIdx.x, &flag, p0,
                       live, c_in, c_out, m0, n0, d::kBM, BN, threadIdx.x, d::kThreads,
                       [] { __syncthreads(); });
}

// f(std::integral_constant<int, BN>{}): C_out columns per block of K5's
// wgmma tile, the whole C_out up to 128 (a 256-wide tile's 160 KB ring
// leaves one block per SM; two 128-wide ones run 2 blocks per SM)
template <typename F>
int with_bn(int c_out, F&& f) {
  if (c_out <= 32) return f(std::integral_constant<int, 32>{});
  if (c_out <= 64) return f(std::integral_constant<int, 64>{});
  if (c_out <= 96) return f(std::integral_constant<int, 96>{});
  return f(std::integral_constant<int, 128>{});
}

// K5 over the slot lists on either route, one block per (tile, piece):
// pieces = V / per_split + 9 covers every list's splits (8 where no list
// is split).  out (8, C_in, C_out) f32; part (pieces, C_in, C_out) f32 and
// cnt (8 tiles,) int32 (zero on entry and on exit) where pieces > 8.  The
// wgmma route is the lists' tile with one consumer warpgroup.
template <bool Wgmma>
int launch(const void* x, const void* y, const void* pairs, const void* starts,
           void* out, void* part, void* cnt, int c_in, int c_out, int up, int pieces,
           int per_split, cudaStream_t s) {
  if (c_in <= 0 || c_out <= 0 || c_in % (Wgmma ? 8 : 4) || c_out % (Wgmma ? 8 : 4) ||
      pieces < 8 || per_split <= 0 || (pieces > 8 && (part == nullptr || cnt == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (Wgmma) {
    return with_bn(c_out, [&](auto bn) {
      return lists::launch_wgmma<1, decltype(bn)::value, lists::SlotLists>(
          x, y, pairs, starts, out, part, cnt, c_in, c_out, pieces, per_split, 0, up, s);
    });
  } else {
    auto go = [&](auto bn) {
      constexpr int BN = decltype(bn)::value;
      const int tiles = ((c_in + kTI - 1) / kTI) * ((c_out + BN - 1) / BN);
      const size_t bytes = dwmma::dwtf32::smem_bytes<BN>();
      cudaError_t e = cudaFuncSetAttribute(strided_dw_tf32_kernel<BN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
      if (e != cudaSuccess) return static_cast<int>(e);
      strided_dw_tf32_kernel<BN><<<dim3(tiles, pieces), dwmma::dwtf32::kThreads, bytes, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(y),
          static_cast<const int2*>(pairs), static_cast<const int*>(starts),
          static_cast<float*>(out), static_cast<float*>(part), static_cast<int*>(cnt),
          c_in, c_out, per_split, up);
      return static_cast<int>(cudaGetLastError());
    };
    // 3xTF32 at the widths of wgmma's tile but 256: 96 columns are one
    // 96-wide tile, not a 128-wide one with a quarter of it idle
    if (c_out > 64 && c_out <= 96) return go(std::integral_constant<int, 96>{});
    return tf::with_tile_n_f32(c_out, go);
  }
}

}  // namespace k5

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

// K4 at K offsets (1 <= n_off): feats (V_in, C_in), grad (V_out, C_out),
// rb_bwd (n_off, V_in) int32 of grad rows -> out (n_off, C_in, C_out)
// f32; part (splits, n_off, C_in, C_out) f32 scratch when splits > 1
extern "C" int taseg_sparse_conv_dw(const void* feats, const void* grad,
                                    const void* rb_bwd, void* out, void* part,
                                    int v_in, int c_in, int c_out, int n_off,
                                    int splits, int rows_per_split, int dtype,
                                    void* stream) {
  const PairsOffsets pairs{static_cast<const int*>(rb_bwd), v_in};
  return launch_dw(feats, grad, pairs, out, part, n_off, v_in, c_in, c_out,
                   splits, rows_per_split, dtype,
                   static_cast<cudaStream_t>(stream));
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

// K4's mma.sync tile before the wgmma one (no longer on the path: the
// yardstick `old_ms` of chip_smoke.py).  feats (V, C_in), grad (V,
// C_out) bf16, 16-byte aligned, C_in % 8 == 0 and C_out % 8 == 0; pairs
// (27 V,) int2 and starts (28,) int32 from f3conv.k3_pair_lists -> out
// (27, C_in, C_out) f32; part (splits, 27, C_in, C_out) f32 scratch when
// splits > 1, with splits * per_split >= V.
extern "C" int taseg_k3_conv_dw_mma(const void* feats, const void* grad,
                                    const void* pairs, const void* starts,
                                    void* out, void* part, int c_in,
                                    int c_out, int splits, int per_split,
                                    void* stream) {
  return dwmma::launch_dw_mma<dwmma::K3Lists>(
      feats, grad, pairs, starts, out, part, c_in, c_out, 0, splits,
      per_split, static_cast<cudaStream_t>(stream));
}

// K4 on wgmma over the 27 offset lists, one launch per call.  feats (V,
// C_in), grad (V, C_out) bf16, 16-byte aligned, C_in % 8 == 0 and C_out %
// 8 == 0; pairs (27 V,) int2 and starts (28,) int32 from
// f3conv.k3_pair_lists -> out (27, C_in, C_out) f32.  The tile: cw
// consumer warpgroups (1 or 2: 64 cw C_in rows) and bn columns (32, 64,
// 96, 128 or 256), f3conv.k4_tile.  Pairs per split from per_min and
// target (`lists::split_pairs`; target 0: per_min); pieces >= 27 blocks
// per tile, at least max(target, 27) + 27 (target 0: 27 V / per_min +
// 27).  part (pieces,
// C_in, C_out) f32 and cnt (27 * tiles,) int32, zero on entry and on exit,
// unless no list can split (target 0 and per_min >= V): then null.
extern "C" int taseg_k3_conv_dw_wgmma(const void* feats, const void* grad, const void* pairs,
                                      const void* starts, void* out, void* part, void* cnt,
                                      int c_in, int c_out, int cw, int bn, int pieces,
                                      int per_min, int target, void* stream) {
  if (c_in <= 0 || c_out <= 0 || c_in % 8 || c_out % 8 || pieces < 27 || per_min <= 0 ||
      (target > 0 && (part == nullptr || cnt == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  return lists::launch_k4(feats, grad, pairs, starts, out, part, cnt, c_in, c_out, cw, bn,
                          pieces, per_min, target, static_cast<cudaStream_t>(stream));
}

// K5 over the slot lists, one launch per call.  pairs (V_fine, 2) int32
// (fine row, parent) and starts (9,) int32 from
// strided_conv.slot_pair_lists; down (up = 0): x = fine feats (V_fine,
// C_in), y = coarse grad (V_coarse, C_out); up (up = 1, the pairs read as
// (parent, fine row)): x = coarse feats (V_coarse, C_in), y = fine grad
// (V_fine, C_out); 16-byte aligned -> out (8, C_in, C_out) f32.  pieces:
// 8 where per_split >= V_fine, else V_fine / per_split + 9, with part
// (pieces, C_in, C_out) f32 and cnt (8 * tiles,) int32, zero on entry and
// on exit.
// bf16 with C_in % 8 == 0 and C_out % 8 == 0 on wgmma:
extern "C" int taseg_strided_dw_wgmma(const void* x, const void* y, const void* pairs,
                                      const void* starts, void* out, void* part,
                                      void* cnt, int c_in, int c_out, int up,
                                      int pieces, int per_split, void* stream) {
  return k5::launch<true>(x, y, pairs, starts, out, part, cnt, c_in, c_out, up, pieces,
                          per_split, static_cast<cudaStream_t>(stream));
}

// f32 with C_in % 4 == 0 and C_out % 4 == 0 on the 3xTF32 mma.sync tile
// (no longer on the path: chip_smoke.py's yardstick `old_ms`):
extern "C" int taseg_strided_dw_tf32_mma(const void* x, const void* y, const void* pairs,
                                         const void* starts, void* out, void* part, void* cnt,
                                         int c_in, int c_out, int up, int pieces, int per_split,
                                         void* stream) {
  return k5::launch<false>(x, y, pairs, starts, out, part, cnt, c_in, c_out, up, pieces,
                           per_split, static_cast<cudaStream_t>(stream));
}

// K5 in f32 (C_in % 4 == 0, C_out % 4 == 0) on the 3xTF32 wgmma tile, one
// launch a call: pairs per split from per_min and target
// (`lists::split_pairs` at 32-pair stages, f3conv.dw_tf32_plan); pieces
// (f3conv.dw_pieces(8, ...)) blocks a tile; part (pieces, C_in, C_out)
// f32 and cnt (8 * tiles,) int32, zero on entry and on exit, or both null
// where no list can split (per_min >= V_fine).
extern "C" int taseg_strided_dw_tf32(const void* x, const void* y, const void* pairs,
                                     const void* starts, void* out, void* part, void* cnt,
                                     int c_in, int c_out, int up, int pieces, int per_min,
                                     int target, void* stream) {
  return lists::launch_tf32<lists::SlotLists>(x, y, pairs, starts, out, part, cnt, 8, c_in, c_out,
                                              up, pieces, per_min, target,
                                              static_cast<cudaStream_t>(stream));
}

// K4 at K offsets on the 3xTF32 mma.sync tile (no longer on the path:
// chip_smoke.py's yardstick `old_ms`).  feats (V_in, C_in), grad (V_out,
// C_out) f32, 16-byte aligned, C_in % 4 == 0 and C_out % 4 == 0; pairs
// (n_off V_in,) int2 and starts (n_off + 1,) int32 from
// f3conv.pair_lists(rb_bwd) -> out (n_off, C_in, C_out) f32; part
// (splits, n_off, C_in, C_out) f32 scratch when splits > 1, with splits *
// per_split >= V_in.
extern "C" int taseg_sparse_conv_dw_tf32_mma(const void* feats, const void* grad,
                                             const void* pairs, const void* starts, void* out,
                                             void* part, int c_in, int c_out, int n_off,
                                             int splits, int per_split, void* stream) {
  return dwmma::dwtf32::launch(feats, grad, pairs, starts, out, part, c_in, c_out, n_off, splits,
                               per_split, static_cast<cudaStream_t>(stream));
}

// K4 at K offsets on the 3xTF32 wgmma tile, one launch a call.  feats
// (V_in, C_in), grad (V_out, C_out) f32, 16-byte aligned, C_in % 4 == 0
// and C_out % 4 == 0; pairs (n_off V_in,) int2 and starts (n_off + 1,)
// int32 from f3conv.pair_lists(rb_bwd), 1 <= n_off <= 32 -> out (n_off,
// C_in, C_out) f32.  Pairs per split from per_min and target
// (`lists::split_pairs` at 32-pair stages, f3conv.dw_tf32_plan); pieces
// (f3conv.dw_pieces) blocks a tile; part (pieces, C_in, C_out) f32 and cnt
// (n_off * tiles,) int32, zero on entry and on exit, or both null where no
// list can split (per_min >= V_in).
extern "C" int taseg_sparse_conv_dw_tf32(const void* feats, const void* grad, const void* pairs,
                                         const void* starts, void* out, void* part, void* cnt,
                                         int c_in, int c_out, int n_off, int pieces, int per_min,
                                         int target, void* stream) {
  return lists::launch_tf32<lists::OffsetLists>(feats, grad, pairs, starts, out, part, cnt, n_off,
                                                c_in, c_out, 0, pieces, per_min, target,
                                                static_cast<cudaStream_t>(stream));
}
