// K9: the range view's KNN clean-up of per-point labels.
//
// Replaces JAX `taseg_tpu/models/range2d/postproc.py:19 knn_postprocess`
// (no Pallas kernel: an XLA chain of 25 shifted image copies, a (25, P)
// gather, top_k, a (P, k, C) one-hot vote and two reductions).  Each
// point reads its ks x ks window of the range and label images, keeps the
// k nearest candidates in registers by insertion and votes among them:
// one pass, no intermediate in device memory.
//
// Bound: the bytes.  Per point 4 x 4 bytes in (its range, column, row and
// image) and 4 out; the window's pixels (8 bytes each, the centre's label
// among them) overlap between neighbouring points and come mostly from
// L1 / L2, so the images are read about once from device memory.  At
// 120 000 points and a 64 x 512 image that is ~2.7 MB, under a
// microsecond at 3.35 TB/s; a launch costs more.
//
// What holds it at ~10-16x that bound is not device memory: 50 window
// loads a point, each an L1 request (on the shuffled synthetic scans a
// warp's 32 windows touch 32 lines a window row; in beam order, as real
// scans arrive, they overlap and hit L1), the latency of those loads with
// 3-4 blocks an SM (469 blocks at 120 000 points), the insertions'
// instructions and, at CENet's 34 000 points, the launch.  The first
// design (kept below as the yardstick `taseg_knn_postproc_v1`) added 25
// loads of the window weights and int64 address math with a bounds test
// per pixel.  This design:
//   * the weights travel by value among the kernel's arguments (a struct
//     of 25 floats, read from the constant bank): no per-pixel load;
//   * 32-bit index math, the row's bounds tested once a window row, and
//     a row's 5 pixel loads issued before its insertions;
//   * one thread a point in blocks of 256 consecutive points, the first
//     design's grid.
// Measured and left off (tools/k9k10_ablate.py; the variants are built
// from tools/k9_variants.cu): each window row read as the two aligned
// 16-byte pieces of ranges and of labels that hold its 5 pixels (4% faster
// on the shuffled scans, 2-3% slower in beam order), two points a thread
// (fewer warps to hide the loads' latency), a block staging the image rows
// its points' windows cover in shared memory (its shared memory shrinks
// the L1 of every block beside it, and beam order is served from L1
// already), the grid rounded up to whole waves of the SMs (slower at
// CENet's call), and a candidate not below the fifth kept distance
// skipping the insertion (no gain).
//
// Built for the one window and k that every caller uses (JAX's defaults,
// engine.py:858): a 5 x 5 window, k = 5, a cutoff above 0.  The wrapper
// refuses other values; the plain version keeps JAX's general signature.
//
// Semantics (held bit for bit against the plain version, and that against
// JAX): window offsets in dy-major order; outside the image range 1e9 and
// label 0; d = |r - u|, then d * w[o] + d with the multiply and the add
// rounded apart (__fmul_rn / __fadd_rn: a fused multiply-add would round
// once and reorder near-ties against XLA); the k smallest by a strict <
// insertion, so ties keep the lower window index (lax.top_k); the vote
// over labels 1 .. C-1 within the cutoff, the lowest label among equal
// counts; class 0 within the cutoff counts as a vote (JAX's has_vote), so
// only class-0 votes give label 1; no vote keeps the point's own pixel's
// label.
#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 5;  // the window's side
constexpr int kK = 5;       // the candidates kept
constexpr int kHalf = kWindow / 2;
constexpr int kThreads = 256;

struct Weights {
  float w[kWindow * kWindow];
};

// The k best in registers: every loop over them is unrolled, so no array
// is indexed at run time (which would put it in local memory).  A new
// candidate enters where its distance is strictly below the kept one's
// (it has the highest window index so far, so it goes after equal
// distances); the kept ones behind it shift down by one, the last drops
// out.
__device__ __forceinline__ void insert(float (&bd)[kK], int (&bl)[kK], float d, int l) {
  bool shift = false;
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    if (shift || d < bd[j]) {
      const float td = bd[j];
      const int tl = bl[j];
      bd[j] = d;
      bl[j] = l;
      d = td;
      l = tl;
      shift = true;
    }
  }
}

// The vote among the kept candidates; -1 where none is within the cutoff
// (the caller keeps the point's own pixel's label).  A label outside
// [0, C) never votes.
__device__ __forceinline__ int vote(const float (&bd)[kK], const int (&bl)[kK], int num_classes,
                                    float cutoff) {
  bool ok[kK];
  bool has_vote = false;
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    ok[j] = bd[j] <= cutoff && bl[j] >= 0 && bl[j] < num_classes;
    has_vote |= ok[j];
  }
  int voted = 1, voted_count = 0;
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    if (ok[j] && bl[j] != 0) {
      int count = 0;
#pragma unroll
      for (int m = 0; m < kK; ++m) count += ok[m] && bl[m] == bl[j];
      if (count > voted_count || (count == voted_count && bl[j] < voted)) {
        voted = bl[j];
        voted_count = count;
      }
    }
  }
  return has_vote ? voted : -1;
}

// One thread a point in blocks of kThreads consecutive points; the
// window's pixels read from the images, the weights from the arguments.
__global__ void __launch_bounds__(kThreads) knn_postproc_kernel(
    const float* __restrict__ range, const int* __restrict__ label,
    const float* __restrict__ unproj, const int* __restrict__ px,
    const int* __restrict__ py, const int* __restrict__ img,
    const Weights wt, int* __restrict__ out, int p, int h, int w,
    int num_classes, float cutoff) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p) return;
  const float u = __ldg(unproj + i);
  const int x0 = __ldg(px + i), y0 = __ldg(py + i);
  const int base = __ldg(img + i) * h * w;  // fits: the wrapper checks B H W < 2^31

  float bd[kK];
  int bl[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    bd[j] = __int_as_float(0x7f800000);  // +inf
    bl[j] = 0;
  }
#pragma unroll
  for (int dy = 0; dy < kWindow; ++dy) {
    const int y = y0 + dy - kHalf;
    const bool row_in = y >= 0 && y < h;
    const int row_at = base + y * w;
    float rr[kWindow];
    int ll[kWindow];
    // the window row's pixels first, then its insertions
#pragma unroll
    for (int dx = 0; dx < kWindow; ++dx) {
      const int x = x0 + dx - kHalf;
      rr[dx] = 1e9f;
      ll[dx] = 0;
      if (row_in && x >= 0 && x < w) {
        rr[dx] = __ldg(range + row_at + x);
        ll[dx] = __ldg(label + row_at + x);
      }
    }
#pragma unroll
    for (int dx = 0; dx < kWindow; ++dx) {
      float d = fabsf(rr[dx] - u);
      d = __fadd_rn(__fmul_rn(d, wt.w[dy * kWindow + dx]), d);
      insert(bd, bl, d, ll[dx]);
    }
  }
  const int v = vote(bd, bl, num_classes, cutoff);
  out[i] = v >= 0 ? v : __ldg(label + base + y0 * w + x0);
}

// ------------------------------------------------------------------------
// The first design, the yardstick `old_ms`, on no path: one
// thread a point in 256-thread blocks, the window read straight from the
// images, the weights from device memory.
__global__ void knn_postproc_v1_kernel(
    const float* __restrict__ range, const int* __restrict__ label,
    const float* __restrict__ unproj, const int* __restrict__ px,
    const int* __restrict__ py, const int* __restrict__ img,
    const float* __restrict__ weight, int* __restrict__ out, int p, int h,
    int w, int num_classes, float cutoff) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const float u = unproj[i];
  const int x0 = px[i], y0 = py[i];
  const long long base = static_cast<long long>(img[i]) * h * w;

  float best_d[kK];
  int best_l[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    best_d[j] = __int_as_float(0x7f800000);  // +inf
    best_l[j] = 0;
  }
#pragma unroll
  for (int dy = 0; dy < kWindow; ++dy) {
    const int y = y0 + dy - kHalf;
#pragma unroll
    for (int dx = 0; dx < kWindow; ++dx) {
      const int x = x0 + dx - kHalf;
      float r = 1e9f;
      int l = 0;
      if (y >= 0 && y < h && x >= 0 && x < w) {
        const long long at = base + static_cast<long long>(y) * w + x;
        r = __ldg(range + at);
        l = __ldg(label + at);
      }
      float d = fabsf(r - u);
      d = __fadd_rn(__fmul_rn(d, __ldg(weight + dy * kWindow + dx)), d);
      bool shift = false;
#pragma unroll
      for (int j = 0; j < kK; ++j) {
        if (shift || d < best_d[j]) {
          const float td = best_d[j];
          const int tl = best_l[j];
          best_d[j] = d;
          best_l[j] = l;
          d = td;
          l = tl;
          shift = true;
        }
      }
    }
  }
  const int v = vote(best_d, best_l, num_classes, cutoff);
  out[i] = v >= 0 ? v : __ldg(label + base + static_cast<long long>(y0) * w + x0);
}

}  // namespace

// range, label (B, H, W) f32 / int32 (B H W < 2^31); unproj, px, py, img
// (P,) f32 / int32; weight (25,) f32 in host memory, passed by value ->
// out (P,) int32.  cutoff > 0.  One launch.
extern "C" int taseg_knn_postproc(const void* range, const void* label, const void* unproj,
                                  const void* px, const void* py, const void* img,
                                  const void* weight, void* out, int p, int h, int w,
                                  int num_classes, float cutoff, void* stream) {
  if (!(cutoff > 0.f)) return static_cast<int>(cudaErrorInvalidValue);
  if (p == 0) return 0;
  Weights wt;
  for (int k = 0; k < kWindow * kWindow; ++k) wt.w[k] = static_cast<const float*>(weight)[k];
  knn_postproc_kernel<<<(p + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(range), static_cast<const int*>(label),
      static_cast<const float*>(unproj), static_cast<const int*>(px),
      static_cast<const int*>(py), static_cast<const int*>(img), wt, static_cast<int*>(out), p, h, w,
      num_classes, cutoff);
  return static_cast<int>(cudaGetLastError());
}

// The first design: weight (25,) f32 in device memory.
extern "C" int taseg_knn_postproc_v1(const void* range, const void* label,
                                     const void* unproj, const void* px,
                                     const void* py, const void* img,
                                     const void* weight, void* out, int p, int h,
                                     int w, int num_classes, float cutoff,
                                     void* stream) {
  if (!(cutoff > 0.f)) return static_cast<int>(cudaErrorInvalidValue);
  if (p == 0) return 0;
  const int threads = 256;
  const int blocks = (p + threads - 1) / threads;
  knn_postproc_v1_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(range), static_cast<const int*>(label),
      static_cast<const float*>(unproj), static_cast<const int*>(px),
      static_cast<const int*>(py), static_cast<const int*>(img),
      static_cast<const float*>(weight), static_cast<int*>(out), p, h, w,
      num_classes, cutoff);
  return static_cast<int>(cudaGetLastError());
}
