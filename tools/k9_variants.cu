// K9's launch choices that the shipped kernel (`taseg_tpu_torch/csrc/
// knn_postproc.cu`) left out, for tools/k9k10_ablate.py alone (no path
// builds this file): kQ points a thread, a block staging the image rows
// its points' windows cover in shared memory where they fit kStage pixels
// (kStaged), and each window row read as the two aligned 16-byte pieces
// of ranges and of labels that hold its 5 pixels (kVecRows).  The
// semantics are the shipped kernel's, bit for bit: every choice is held to
// the plain version's labels before it is timed.
//
//     nvcc -arch=sm_90a -O3 -shared -Xcompiler -fPIC -o libk9v.so tools/k9_variants.cu
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 5;  // the window's side
constexpr int kK = 5;       // the candidates kept
constexpr int kHalf = kWindow / 2;
constexpr int kThreads = 256;
constexpr int kStage = 4096;      // pixels a block can stage
constexpr unsigned kFull = 0xffffffffu;

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

// The staged box: rows [y0, y0 + bh) and columns [x0, x0 + bw) of one
// image, bw a multiple of 4.
struct Box {
  int img, y0, x0, bh, bw;
};

// Element dx + o of the 8 pixels [xa, xa + 8) of a window row, o the
// window's offset in them (0-3, the same for every dx of the row).
template <typename V>
__device__ __forceinline__ V pick(const V (&a)[8], int o, int dx) {
  return o == 0 ? a[dx] : o == 1 ? a[dx + 1] : o == 2 ? a[dx + 2] : a[dx + 3];
}

// kQ points a thread (points t, t + kThreads, ... of the block's run).
// The window's pixels come from the block's staged box where kStaged and
// the box fits, else from the images: with kVecRows (W in whole 16-byte
// pieces, aligned rows), each window row as the two aligned 16-byte
// pieces of ranges and of labels that hold its 5 pixels; else pixel by
// pixel.
template <int kQ, bool kVecRows, bool kStaged>
__global__ void __launch_bounds__(kThreads) knn_postproc_kernel(
    const float* __restrict__ range, const int* __restrict__ label,
    const float* __restrict__ unproj, const int* __restrict__ px,
    const int* __restrict__ py, const int* __restrict__ img,
    const Weights wt, int* __restrict__ out, int p, int h, int w,
    int num_classes, float cutoff, int per_block) {
  // the staged box, in dynamic shared memory (none where not kStaged: a
  // static buffer would take its share of L1 from the blocks that read
  // through it): kStage ranges, kStage label bytes, then the box's
  // bounds (img min, img max, y min, y max, x min, x max)
  extern __shared__ __align__(16) unsigned char stage_buf[];
  float* s_r = reinterpret_cast<float*>(stage_buf);
  unsigned char* s_l = stage_buf + kStage * sizeof(float);
  int* s_box = reinterpret_cast<int*>(s_l + kStage);
  const int first = blockIdx.x * per_block;
  const int last = min(first + per_block, p);

  int ix[kQ], iy[kQ], im[kQ];
  float u[kQ];
  bool valid[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int i = first + threadIdx.x + q * kThreads;
    valid[q] = i < last;
    ix[q] = iy[q] = im[q] = 0;
    u[q] = 0.f;
    if (valid[q]) {
      ix[q] = __ldg(px + i);
      iy[q] = __ldg(py + i);
      im[q] = __ldg(img + i);
      u[q] = __ldg(unproj + i);
    }
  }
  bool staged = false;
  Box box{0, 0, 0, 0, 0};
  if constexpr (kStaged) {
    // the block's box
    int lo[3] = {INT_MAX, INT_MAX, INT_MAX}, hi[3] = {INT_MIN, INT_MIN, INT_MIN};  // img, y, x
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      if (valid[q]) {
        const int v[3] = {im[q], iy[q], ix[q]};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          lo[k] = min(lo[k], v[k]);
          hi[k] = max(hi[k], v[k]);
        }
      }
    }
    if (threadIdx.x == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s_box[2 * k] = INT_MAX;
        s_box[2 * k + 1] = INT_MIN;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int a = __reduce_min_sync(kFull, lo[k]), b = __reduce_max_sync(kFull, hi[k]);
      if ((threadIdx.x & 31) == 0) {
        atomicMin(s_box + 2 * k, a);
        atomicMax(s_box + 2 * k + 1, b);
      }
    }
    __syncthreads();
    box = Box{s_box[0], max(s_box[2] - kHalf, 0), max(s_box[4] - kHalf, 0) & ~3, 0, 0};
    box.bh = min(s_box[3] + kHalf, h - 1) - box.y0 + 1;
    box.bw = (min(s_box[5] + kHalf, w - 1) | 3) - box.x0 + 1;
    const bool aligned = ((reinterpret_cast<uintptr_t>(range) | reinterpret_cast<uintptr_t>(label)) & 15) == 0;
    staged = s_box[0] == s_box[1] && num_classes <= 255 && (w & 3) == 0 && aligned &&
             static_cast<long long>(box.bh) * box.bw <= kStage && last > first;
  }
  if (staged) {
    const int q4 = box.bw >> 2;
    const long long base = (static_cast<long long>(box.img) * h + box.y0) * w + box.x0;
    for (int t = threadIdx.x; t < box.bh * q4; t += kThreads) {
      const int row = t / q4, c4 = t - row * q4;
      const long long at = base + static_cast<long long>(row) * w + 4 * c4;
      const float4 r4 = __ldg(reinterpret_cast<const float4*>(range + at));
      const int4 l4 = __ldg(reinterpret_cast<const int4*>(label + at));
      const int ls[4] = {l4.x, l4.y, l4.z, l4.w};
      unsigned packed = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned b = (ls[k] >= 0 && ls[k] < num_classes) ? static_cast<unsigned>(ls[k]) : 255u;
        packed |= b << (8 * k);
      }
      const int o = row * box.bw + 4 * c4;
      *reinterpret_cast<float4*>(s_r + o) = r4;
      *reinterpret_cast<unsigned*>(s_l + o) = packed;
    }
    __syncthreads();
  }

  float bd[kQ][kK];
  int bl[kQ][kK];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
#pragma unroll
    for (int j = 0; j < kK; ++j) {
      bd[q][j] = __int_as_float(0x7f800000);  // +inf
      bl[q][j] = 0;
    }
  }
#pragma unroll
  for (int dy = 0; dy < kWindow; ++dy) {
    float rr[kQ][kWindow];
    int ll[kQ][kWindow];
    // the window row's pixels of every point first, then the insertions
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int y = iy[q] + dy - kHalf;
      const bool row_in = valid[q] && y >= 0 && y < h;
      const int row_at = (im[q] * h + y) * w;  // fits: the wrapper checks B H W < 2^31
      const int xl = ix[q] - kHalf;
#pragma unroll
      for (int dx = 0; dx < kWindow; ++dx) {
        rr[q][dx] = 1e9f;
        ll[q][dx] = 0;
      }
      if (!row_in) continue;
      if (staged) {
        const int so = (y - box.y0) * box.bw - box.x0;
#pragma unroll
        for (int dx = 0; dx < kWindow; ++dx) {
          const int x = xl + dx;
          if (x >= 0 && x < w) {
            rr[q][dx] = s_r[so + x];
            const int b = s_l[so + x];
            ll[q][dx] = b == 255 ? -1 : b;
          }
        }
      } else if constexpr (kVecRows) {
        const int xa = xl & ~3;  // the aligned piece at or left of the window's first pixel
        const int o = xl - xa;
        float4 ra = make_float4(1e9f, 1e9f, 1e9f, 1e9f), rb = ra;
        int4 la = make_int4(0, 0, 0, 0), lb = la;
        if (xa >= 0) {
          ra = __ldg(reinterpret_cast<const float4*>(range + row_at + xa));
          la = __ldg(reinterpret_cast<const int4*>(label + row_at + xa));
        }
        if (xa + 4 < w) {
          rb = __ldg(reinterpret_cast<const float4*>(range + row_at + xa + 4));
          lb = __ldg(reinterpret_cast<const int4*>(label + row_at + xa + 4));
        }
        const float r8[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
        const int l8[8] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
#pragma unroll
        for (int dx = 0; dx < kWindow; ++dx) {
          rr[q][dx] = pick(r8, o, dx);
          ll[q][dx] = pick(l8, o, dx);
        }
      } else {
#pragma unroll
        for (int dx = 0; dx < kWindow; ++dx) {
          const int x = xl + dx;
          if (x >= 0 && x < w) {
            rr[q][dx] = __ldg(range + row_at + x);
            ll[q][dx] = __ldg(label + row_at + x);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
#pragma unroll
      for (int dx = 0; dx < kWindow; ++dx) {
        float d = fabsf(rr[q][dx] - u[q]);
        d = __fadd_rn(__fmul_rn(d, wt.w[dy * kWindow + dx]), d);
        insert(bd[q], bl[q], d, ll[q][dx]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    if (!valid[q]) continue;
    const int i = first + threadIdx.x + q * kThreads;
    const int v = vote(bd[q], bl[q], num_classes, cutoff);
    out[i] = v >= 0 ? v : __ldg(label + (im[q] * h + iy[q]) * w + ix[q]);
  }
}

struct KnnArgs {
  const float* range;
  const int* label;
  const float* unproj;
  const int *px, *py, *img;
  int* out;
  int p, h, w, num_classes;
  float cutoff;
  int per_block;
};

template <int kQ, bool kVecRows, bool kStaged>
void launch_knn(const KnnArgs& a, const Weights& wt, int blocks, cudaStream_t st) {
  const size_t smem = kStaged ? kStage * (sizeof(float) + 1) + 6 * sizeof(int) : 0;
  knn_postproc_kernel<kQ, kVecRows, kStaged><<<blocks, kThreads, smem, st>>>(
      a.range, a.label, a.unproj, a.px, a.py, a.img, wt, a.out, a.p, a.h, a.w, a.num_classes, a.cutoff,
      a.per_block);
}

template <int kQ>
void launch_knn_any(const KnnArgs& a, const Weights& wt, int blocks, int stage, int vec_rows, cudaStream_t st) {
  if (stage) {
    if (vec_rows) launch_knn<kQ, true, true>(a, wt, blocks, st); else launch_knn<kQ, false, true>(a, wt, blocks, st);
  } else {
    if (vec_rows) launch_knn<kQ, true, false>(a, wt, blocks, st); else launch_knn<kQ, false, false>(a, wt, blocks, st);
  }
}

}  // namespace

// range, label (B, H, W) f32 / int32; unproj, px, py, img (P,) f32 /
// int32; weight (25,) f32 in host memory, passed by value -> out (P,)
// int32.  cutoff > 0; `blocks` x `per_block` covers the points, `pts`
// (1 or 2) points a thread, `stage` lets blocks stage their box,
// `vec_rows` reads window rows in 16-byte pieces (W a multiple of 4, the
// images 16-byte aligned).  One launch.
extern "C" int k9_variant_postproc(const void* range, const void* label, const void* unproj,
                                   const void* px, const void* py, const void* img,
                                   const void* weight, void* out, int p, int h, int w,
                                   int num_classes, float cutoff, int blocks, int per_block, int pts,
                                   int stage, int vec_rows, void* stream) {
  if (!(cutoff > 0.f)) return static_cast<int>(cudaErrorInvalidValue);
  if (p == 0) return 0;
  if ((pts != 1 && pts != 2) || per_block < 1 || per_block > kThreads * pts ||
      static_cast<long long>(blocks) * per_block < p || (vec_rows && w % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Weights wt;
  for (int k = 0; k < kWindow * kWindow; ++k) wt.w[k] = static_cast<const float*>(weight)[k];
  const KnnArgs a{static_cast<const float*>(range), static_cast<const int*>(label),
                  static_cast<const float*>(unproj), static_cast<const int*>(px),
                  static_cast<const int*>(py), static_cast<const int*>(img), static_cast<int*>(out),
                  p, h, w, num_classes, cutoff, per_block};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pts == 1) {
    launch_knn_any<1>(a, wt, blocks, stage, vec_rows, st);
  } else {
    launch_knn_any<2>(a, wt, blocks, stage, vec_rows, st);
  }
  return static_cast<int>(cudaGetLastError());
}
