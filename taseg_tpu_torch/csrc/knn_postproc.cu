// K9: the range view's KNN clean-up of per-point labels.
//
// Replaces JAX `taseg_tpu/models/range2d/postproc.py:19 knn_postprocess`
// (no Pallas kernel: an XLA chain of 25 shifted image copies, a (25, P)
// gather, top_k, a (P, k, C) one-hot vote and two reductions).  Here one
// thread per point reads its ks x ks window straight from the range and
// label images, keeps the k nearest candidates in registers by insertion
// and votes among them: one pass, no intermediate in device memory.
//
// Bound: the bytes.  Per point 4 x 4 bytes in (its range, column, row and
// image) and 4 out; the window's pixels (8 bytes each, the centre's label
// among them) overlap between neighbouring points and come mostly from L1
// / L2, so the images are read about once from device memory.  At 120 000
// points and a 64 x 512 image that is ~2.7 MB, under a microsecond at
// 3.35 TB/s; a launch costs more.
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

// The k best are kept in registers: every loop over them is unrolled, so
// no array is indexed at run time (which would put it in local memory).
// A new candidate enters where its distance is strictly below the kept
// one's (it has the highest window index so far, so it goes after equal
// distances); the kept ones behind it shift down by one, the last drops
// out.
__global__ void knn_postproc_kernel(
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
  constexpr int half = kWindow / 2;

  float best_d[kK];
  int best_l[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    best_d[j] = __int_as_float(0x7f800000);  // +inf
    best_l[j] = 0;
  }
#pragma unroll
  for (int dy = 0; dy < kWindow; ++dy) {
    const int y = y0 + dy - half;
#pragma unroll
    for (int dx = 0; dx < kWindow; ++dx) {
      const int x = x0 + dx - half;
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

  bool ok[kK];
  bool has_vote = false;
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    ok[j] = best_d[j] <= cutoff && best_l[j] >= 0 && best_l[j] < num_classes;
    has_vote |= ok[j];
  }
  int voted = 1, voted_count = 0;
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    if (ok[j] && best_l[j] != 0) {
      int count = 0;
#pragma unroll
      for (int m = 0; m < kK; ++m) count += ok[m] && best_l[m] == best_l[j];
      if (count > voted_count || (count == voted_count && best_l[j] < voted)) {
        voted = best_l[j];
        voted_count = count;
      }
    }
  }
  out[i] = has_vote ? voted : __ldg(label + base + static_cast<long long>(y0) * w + x0);
}

}  // namespace

// range, label (B, H, W) f32 / int32; unproj, px, py, img (P,) f32 /
// int32; weight (25,) f32 -> out (P,) int32.  cutoff > 0.
extern "C" int taseg_knn_postproc(const void* range, const void* label,
                                  const void* unproj, const void* px,
                                  const void* py, const void* img,
                                  const void* weight, void* out, int p, int h,
                                  int w, int num_classes, float cutoff,
                                  void* stream) {
  if (!(cutoff > 0.f)) return static_cast<int>(cudaErrorInvalidValue);
  if (p == 0) return 0;
  const int threads = 256;
  const int blocks = (p + threads - 1) / threads;
  knn_postproc_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(range), static_cast<const int*>(label),
      static_cast<const float*>(unproj), static_cast<const int*>(px),
      static_cast<const int*>(py), static_cast<const int*>(img),
      static_cast<const float*>(weight), static_cast<int*>(out), p, h, w,
      num_classes, cutoff);
  return static_cast<int>(cudaGetLastError());
}
