// Multi-level FPN ROIAlignV2 (aligned, bilinear, adaptive sampling grid):
// forward, and its exact transpose with respect to the features.
//
// Replaces ubteacher_tpu/ops/pallas/roi_align_pallas.py:
// multilevel_roi_align_pallas (_fwd_kernel, _fwd_tiled_kernel, _bwd_kernel,
// _bwd_tiled_kernel). Each roi is pooled from the pyramid level that
// ops/roi_align.py:assign_levels gives it (the wrapper passes those levels in,
// so kernel and plain version pool every roi from the same level). On that
// level the roi is shifted by half a pixel, cut into P x P bins, and each bin
// averages s_y x s_x bilinear samples, where s = sampling_ratio or, for
// sampling_ratio 0, ceil(extent / P) capped at 8 per axis (the adaptive grid
// of ops/roi_align.py:bin_sample_positions, ADAPTIVE_MAX_S). Sample
// positions are clipped into [0, H - 1] x [0, W - 1], as the JAX package's
// exact formulation (roi_align_matmul) clips them. The coordinate arithmetic
// uses the __f*_rn intrinsics in the order of the plain version, so both
// place every sample on the same float32 position.
//
// The port computes exact ROIAlignV2 for every roi. The Pallas kernel pools
// from a fixed window of the feature map and clamps the outer samples of a
// roi whose span exceeds it (oversized rois clamped into p5,
// roi_align_pallas.py:39-41); that clamp was a TPU artefact and is not
// reproduced here.
//
// What bounds it on the H100: the forward is a gather. At the main path's
// shapes (24 images x 512 rois x 256 channels x 7 x 7 outputs = 154 M
// outputs, each an average of 4 to 16 samples of 4 corners) it issues a few
// billion scattered 2- or 4-byte reads, which mostly hit L2 (p2 of 24 images
// is 0.8 GB in bf16, read about once from HBM). The backward is the same
// pattern with float32 atomic adds in place of the reads.
//
// What the design does about it (a simple kernel, detectron2's layout):
//   * one thread per output element (roi, c, ph, pw), pw fastest, over NCHW
//     features; a warp covers neighbouring bins of one channel of one roi,
//     so its corner reads fall on a few rows of one feature plane. The
//     output is written (N, C, P, P), contiguous per thread, and the wrapper
//     returns it permuted to the JAX layout (N, P, P, C);
//   * accumulation in float32, one rounding to the feature dtype (float32
//     or bfloat16) at the end;
//   * the backward scatters each output gradient's weighted corners with
//     atomicAdd into one float32 gradient buffer per level (B, C, H, W),
//     which the wrapper casts to the feature dtype. Boxes get no gradient:
//     the proposals are detached.
// Reading channels-last features with channel-fastest threads would make
// every warp's reads and atomics contiguous; that is left for a later
// optimisation.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libubt_roi_align.so roi_align.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

constexpr int kMaxLevels = 4;

// Per-level feature (forward) or float32 gradient (backward) planes. Outside
// the anonymous namespace: the extern "C" entry points take it, and a type
// with internal linkage would keep them from being exported.
struct Levels {
  void* data[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];  // 1 / stride of the level
  int count;                // levels in use
};

namespace {

constexpr int kThreads = 256;
constexpr float kAdaptiveMaxS = 8.0f;

__device__ __forceinline__ float to_float(const float v) { return v; }
__device__ __forceinline__ float to_float(const __nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One axis of a roi on its level (ops/roi_align.py:_sample_coords and
// bin_sample_positions).
struct Axis {
  float start;  // roi start in level pixels, minus half a pixel
  float bin;    // extent / P
  float s;      // samples per bin
  int n;        // the same as an int
};

__device__ __forceinline__ Axis make_axis(float lo, float hi, float scale, int P, int sampling_ratio) {
  const float a = __fsub_rn(__fmul_rn(lo, scale), 0.5f);
  const float b = __fsub_rn(__fmul_rn(hi, scale), 0.5f);
  const float extent = fmaxf(__fsub_rn(b, a), 1e-6f);
  Axis ax;
  ax.start = a;
  ax.bin = __fdiv_rn(extent, static_cast<float>(P));
  ax.s = sampling_ratio > 0 ? static_cast<float>(sampling_ratio)
                            : fminf(fmaxf(ceilf(ax.bin), 1.0f), kAdaptiveMaxS);
  ax.n = static_cast<int>(ax.s);
  return ax;
}

// Sample i of bin `bin`, clipped into [0, len - 1]; lo/hi are the two
// neighbouring pixel indices and w_hi the weight of hi.
struct Tap {
  int lo, hi;
  float w_lo, w_hi;
};

__device__ __forceinline__ Tap sample_tap(const Axis& ax, int bin, int i, int len) {
  const float off = __fdiv_rn(__fadd_rn(static_cast<float>(i), 0.5f), ax.s);
  const float frac = __fadd_rn(static_cast<float>(bin), off);
  float pos = __fadd_rn(ax.start, __fmul_rn(frac, ax.bin));
  pos = fminf(fmaxf(pos, 0.0f), static_cast<float>(len - 1));
  const float fl = floorf(pos);
  Tap t;
  t.lo = static_cast<int>(fl);
  t.hi = min(t.lo + 1, len - 1);
  t.w_hi = __fsub_rn(pos, fl);
  t.w_lo = __fsub_rn(1.0f, t.w_hi);
  return t;
}

struct Site {
  long long n;  // roi
  int c, ph, pw, level, b;
};

__device__ __forceinline__ Site decode(long long idx, const int* __restrict__ level, int rois_per_image,
                                       int C, int P) {
  Site s;
  s.pw = static_cast<int>(idx % P);
  s.ph = static_cast<int>((idx / P) % P);
  s.c = static_cast<int>((idx / (static_cast<long long>(P) * P)) % C);
  s.n = idx / (static_cast<long long>(P) * P * C);
  s.level = level[s.n];
  s.b = static_cast<int>(s.n / rois_per_image);
  return s;
}

// features per level (B, C, H, W) of T; boxes (N, 4) f32 xyxy image pixels;
// level (N,) i32 0-based; out (N, C, P, P) of T.
template <typename T>
__global__ void roi_align_forward(const Levels feats, const float4* __restrict__ boxes,
                                  const int* __restrict__ level, int rois_per_image, int C,
                                  int P, int sampling_ratio, long long total,
                                  T* __restrict__ out) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const Site s = decode(idx, level, rois_per_image, C, P);
  if (s.level < 0 || s.level >= feats.count) {  // a non-finite box: NaN out, no stray read
    out[idx] = from_float<T>(NAN);
    return;
  }
  const int H = feats.height[s.level];
  const int W = feats.width[s.level];
  const T* f = static_cast<const T*>(feats.data[s.level]) +
               (static_cast<size_t>(s.b) * C + s.c) * H * W;
  const float4 box = boxes[s.n];
  const Axis ay = make_axis(box.y, box.w, feats.scale[s.level], P, sampling_ratio);
  const Axis ax = make_axis(box.x, box.z, feats.scale[s.level], P, sampling_ratio);
  float acc = 0.0f;
  for (int iy = 0; iy < ay.n; ++iy) {
    const Tap ty = sample_tap(ay, s.ph, iy, H);
    const T* row_lo = f + static_cast<size_t>(ty.lo) * W;
    const T* row_hi = f + static_cast<size_t>(ty.hi) * W;
    for (int ix = 0; ix < ax.n; ++ix) {
      const Tap tx = sample_tap(ax, s.pw, ix, W);
      acc += ty.w_lo * (tx.w_lo * to_float(row_lo[tx.lo]) + tx.w_hi * to_float(row_lo[tx.hi])) +
             ty.w_hi * (tx.w_lo * to_float(row_hi[tx.lo]) + tx.w_hi * to_float(row_hi[tx.hi]));
    }
  }
  const float coef = __fmul_rn(__fdiv_rn(1.0f, ay.s), __fdiv_rn(1.0f, ax.s));
  out[idx] = from_float<T>(acc * coef);
}

// grads per level (B, C, H, W) f32, zero-filled; grad_out (N, C, P, P) of T.
template <typename T>
__global__ void roi_align_backward(const Levels grads, const float4* __restrict__ boxes,
                                   const int* __restrict__ level, int rois_per_image, int C,
                                   int P, int sampling_ratio, long long total,
                                   const T* __restrict__ grad_out) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const Site s = decode(idx, level, rois_per_image, C, P);
  if (s.level < 0 || s.level >= grads.count) return;
  const int H = grads.height[s.level];
  const int W = grads.width[s.level];
  float* gf = static_cast<float*>(grads.data[s.level]) + (static_cast<size_t>(s.b) * C + s.c) * H * W;
  const float4 box = boxes[s.n];
  const Axis ay = make_axis(box.y, box.w, grads.scale[s.level], P, sampling_ratio);
  const Axis ax = make_axis(box.x, box.z, grads.scale[s.level], P, sampling_ratio);
  const float g = to_float(grad_out[idx]) * __fmul_rn(__fdiv_rn(1.0f, ay.s), __fdiv_rn(1.0f, ax.s));
  if (g == 0.0f) return;
  for (int iy = 0; iy < ay.n; ++iy) {
    const Tap ty = sample_tap(ay, s.ph, iy, H);
    float* row_lo = gf + static_cast<size_t>(ty.lo) * W;
    float* row_hi = gf + static_cast<size_t>(ty.hi) * W;
    const float g_lo = g * ty.w_lo;
    const float g_hi = g * ty.w_hi;
    for (int ix = 0; ix < ax.n; ++ix) {
      const Tap tx = sample_tap(ax, s.pw, ix, W);
      atomicAdd(row_lo + tx.lo, g_lo * tx.w_lo);
      atomicAdd(row_lo + tx.hi, g_lo * tx.w_hi);
      atomicAdd(row_hi + tx.lo, g_hi * tx.w_lo);
      atomicAdd(row_hi + tx.hi, g_hi * tx.w_hi);
    }
  }
}

unsigned int blocks_for(long long total) {
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

}  // namespace

// is_bf16: 0 for float32 features, 1 for bfloat16. feats: per-level (B, C, H,
// W) planes; boxes (N, 4) f32; level (N,) i32 0-based; out (N, C, P, P).
// Returns the cudaError_t of the launch (0 on success); launches on `stream`
// and does not synchronise.
extern "C" int ubt_roi_align_forward(int is_bf16, const Levels* feats, const float* boxes,
                                     const int* level, int num_rois, int rois_per_image,
                                     int channels, int pooled, int sampling_ratio, void* out,
                                     void* stream) {
  const long long total = static_cast<long long>(num_rois) * channels * pooled * pooled;
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* b4 = reinterpret_cast<const float4*>(boxes);
  if (is_bf16) {
    roi_align_forward<__nv_bfloat16><<<blocks_for(total), kThreads, 0, s>>>(
        *feats, b4, level, rois_per_image, channels, pooled, sampling_ratio, total,
        static_cast<__nv_bfloat16*>(out));
  } else {
    roi_align_forward<float><<<blocks_for(total), kThreads, 0, s>>>(
        *feats, b4, level, rois_per_image, channels, pooled, sampling_ratio, total,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// grads: per-level (B, C, H, W) f32 planes, zero-filled by the caller;
// grad_out (N, C, P, P) in the feature dtype (is_bf16 as above).
extern "C" int ubt_roi_align_backward(int is_bf16, const Levels* grads, const float* boxes,
                                      const int* level, int num_rois, int rois_per_image,
                                      int channels, int pooled, int sampling_ratio,
                                      const void* grad_out, void* stream) {
  const long long total = static_cast<long long>(num_rois) * channels * pooled * pooled;
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* b4 = reinterpret_cast<const float4*>(boxes);
  if (is_bf16) {
    roi_align_backward<__nv_bfloat16><<<blocks_for(total), kThreads, 0, s>>>(
        *grads, b4, level, rois_per_image, channels, pooled, sampling_ratio, total,
        static_cast<const __nv_bfloat16*>(grad_out));
  } else {
    roi_align_backward<float><<<blocks_for(total), kThreads, 0, s>>>(
        *grads, b4, level, rois_per_image, channels, pooled, sampling_ratio, total,
        static_cast<const float*>(grad_out));
  }
  return static_cast<int>(cudaGetLastError());
}
