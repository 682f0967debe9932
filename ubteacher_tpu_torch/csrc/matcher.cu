// Batched anchor-to-ground-truth matcher (detectron2 Matcher semantics).
//
// Replaces ubteacher_tpu/ops/pallas/matcher_pallas.py:match_anchors_pallas
// (_gm_kernel, _match_kernel). For every image and anchor: the best IoU over
// the image's valid gt boxes and its first argmax, the threshold labels
// (IoU < t_lo -> l0, [t_lo, t_hi) -> l1, >= t_hi -> l2), and the
// allow-low-quality promotion of every anchor that reaches some gt's best
// IoU (when that best IoU is > 0) to label l2.
//
// The results are bitwise those of the plain PyTorch version
// (ops/boxes.py:pairwise_iou + modeling/matcher.py:match): the IoU is
// computed in the same order of float32 operations, each rounded on its own
// with the __f*_rn intrinsics, so that nvcc does not contract
// `a1 + a2 - inter` or the area products into fused multiply-adds, and the
// division is the IEEE one (__fdiv_rn), not an approximate reciprocal.
// Otherwise an IoU within an ulp of 0.3 or 0.7 changes its label.
//
// What bounds it on the H100: at the RPN's shapes (24 images, 100 gt slots,
// 257,796 anchors) the plain version writes and rereads a (B, M, A) float32
// quality matrix of 2.5 GB several times. Here the quality never leaves
// registers; the work is about twenty flops per (gt, anchor) pair, and only
// the gt slots up to each image's last valid one are visited (the bound
// matcher_pallas.py:209-214 prefetches), so the kernel is bound by those
// flops and by the launch, not by memory.
//
// What the design does about it (two passes per image, as Pallas has two
// kernels):
//   * match_best_per_gt: each block takes kAnchorsPerBlock anchors of one
//     image, stages the image's gt boxes in shared memory and, per valid gt,
//     reduces the block's best IoU (warp shuffles, then shared memory) and
//     publishes it with an atomic max on the float's bits into gm (B, M),
//     which the wrapper fills with -1. Valid IoUs are >= 0, whose bit
//     patterns order as signed ints like the floats do, and -1.0f is a
//     negative int below them all, so the atomic max is exact; a -0.0 IoU
//     is canonicalised to +0.0 first.
//   * match_anchors: one thread per anchor keeps the running max and first
//     argmax over the gt slots (strict > keeps the earlier slot on ties, as
//     argmax does), applies the thresholds and the promotion, and writes the
//     matched index and label as int64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libubt_matcher.so matcher.cu

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAnchorsPerThread = 8;
constexpr int kAnchorsPerBlock = kThreads * kAnchorsPerThread;

__device__ __forceinline__ float box_area(const float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// ops/boxes.py:pairwise_iou for one (gt, anchor) pair.
__device__ __forceinline__ float pair_iou(const float4 g, const float ga,
                                          const float4 a, const float aa) {
  const float iw = fmaxf(__fsub_rn(fminf(g.z, a.z), fmaxf(g.x, a.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(g.w, a.w), fmaxf(g.y, a.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(ga, aa), inter);
  return uni > 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.0f;
}

// Stage one image's first `ngt` gt boxes, areas and validity in shared memory.
__device__ __forceinline__ void stage_gt(const float4* __restrict__ gt,
                                         const unsigned char* __restrict__ mask,
                                         int b, int M, int ngt, float4* s_box,
                                         float* s_area, unsigned char* s_valid) {
  for (int j = threadIdx.x; j < ngt; j += blockDim.x) {
    const float4 g = gt[static_cast<size_t>(b) * M + j];
    s_box[j] = g;
    s_area[j] = box_area(g);
    s_valid[j] = mask[static_cast<size_t>(b) * M + j];
  }
  __syncthreads();
}

// grid (ceil(A / kAnchorsPerBlock), B); dynamic shared memory 24 * M bytes.
__global__ void match_best_per_gt(const float4* __restrict__ anchors, int A,
                                  const float4* __restrict__ gt,
                                  const unsigned char* __restrict__ mask,
                                  const int* __restrict__ ngt_per_image, int M,
                                  float* __restrict__ gm) {
  extern __shared__ float4 smem[];
  float4* s_box = smem;
  float* s_area = reinterpret_cast<float*>(s_box + M);
  unsigned char* s_valid = reinterpret_cast<unsigned char*>(s_area + M);
  __shared__ float s_warp[kThreads / 32];

  const int b = blockIdx.y;
  const int ngt = ngt_per_image[b];
  if (ngt == 0) return;
  stage_gt(gt, mask, b, M, ngt, s_box, s_area, s_valid);

  float4 a[kAnchorsPerThread];
  float aa[kAnchorsPerThread];
  const int base = blockIdx.x * kAnchorsPerBlock + threadIdx.x;
  for (int i = 0; i < kAnchorsPerThread; ++i) {
    const int k = base + i * kThreads;
    if (k < A) {
      a[i] = anchors[k];
      aa[i] = box_area(a[i]);
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = 0; j < ngt; ++j) {
    if (!s_valid[j]) continue;  // uniform over the block
    float best = -1.0f;
    for (int i = 0; i < kAnchorsPerThread; ++i) {
      if (base + i * kThreads < A) best = fmaxf(best, pair_iou(s_box[j], s_area[j], a[i], aa[i]));
    }
    for (int off = 16; off > 0; off >>= 1) best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
    if (lane == 0) s_warp[warp] = best;
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = s_warp[0];
      for (int w = 1; w < kThreads / 32; ++w) v = fmaxf(v, s_warp[w]);
      if (v >= 0.0f) {
        v = __fadd_rn(v, 0.0f);  // -0.0 -> +0.0
        atomicMax(reinterpret_cast<int*>(gm + static_cast<size_t>(b) * M + j), __float_as_int(v));
      }
    }
    __syncthreads();
  }
}

// grid (ceil(A / kThreads), B); dynamic shared memory 28 * M bytes.
__global__ void match_anchors(const float4* __restrict__ anchors, int A,
                              const float4* __restrict__ gt,
                              const unsigned char* __restrict__ mask,
                              const int* __restrict__ ngt_per_image, int M,
                              const float* __restrict__ gm, float t_lo,
                              float t_hi, int l0, int l1, int l2,
                              int allow_low_quality,
                              long long* __restrict__ matched_idx,
                              long long* __restrict__ labels) {
  extern __shared__ float4 smem[];
  float4* s_box = smem;
  float* s_area = reinterpret_cast<float*>(s_box + M);
  float* s_gm = s_area + M;
  unsigned char* s_valid = reinterpret_cast<unsigned char*>(s_gm + M);

  const int b = blockIdx.y;
  const int ngt = ngt_per_image[b];
  for (int j = threadIdx.x; j < ngt; j += blockDim.x) s_gm[j] = gm[static_cast<size_t>(b) * M + j];
  stage_gt(gt, mask, b, M, ngt, s_box, s_area, s_valid);

  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= A) return;
  const float4 a = anchors[k];
  const float aa = box_area(a);
  float mv = -INFINITY;
  int mi = 0;
  bool promote = false;
  for (int j = 0; j < ngt; ++j) {
    const float q = s_valid[j] ? pair_iou(s_box[j], s_area[j], a, aa) : -1.0f;
    if (q > mv) {
      mv = q;
      mi = j;
    }
    if (allow_low_quality && s_gm[j] > 0.0f && q == s_gm[j]) promote = true;
  }
  int lab = l0;
  if (mv >= t_lo) lab = l1;
  if (mv >= t_hi) lab = l2;
  if (promote) lab = l2;
  const size_t o = static_cast<size_t>(b) * A + k;
  matched_idx[o] = mi;
  labels[o] = lab;
}

}  // namespace

// anchors (A, 4) f32; gt (B, M, 4) f32; mask (B, M) bool bytes; ngt (B,) i32
// = last valid gt slot + 1; gm (B, M) f32 filled with -1 by the caller;
// matched_idx, labels (B, A) int64. Returns the cudaError_t of the launches
// (0 on success); launches on `stream` and does not synchronise.
extern "C" int ubt_match_anchors(const float* anchors, int A, const float* gt,
                                 const unsigned char* mask, const int* ngt,
                                 int B, int M, float t_lo, float t_hi, int l0,
                                 int l1, int l2, int allow_low_quality,
                                 float* gm, long long* matched_idx,
                                 long long* labels, void* stream) {
  if (B == 0 || A == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* a4 = reinterpret_cast<const float4*>(anchors);
  const float4* g4 = reinterpret_cast<const float4*>(gt);
  if (allow_low_quality && M > 0) {
    const dim3 grid((A + kAnchorsPerBlock - 1) / kAnchorsPerBlock, B);
    match_best_per_gt<<<grid, kThreads, static_cast<size_t>(M) * 24, s>>>(a4, A, g4, mask, ngt, M, gm);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((A + kThreads - 1) / kThreads, B);
  match_anchors<<<grid, kThreads, static_cast<size_t>(M) * 28, s>>>(
      a4, A, g4, mask, ngt, M, gm, t_lo, t_hi, l0, l1, l2, allow_low_quality,
      matched_idx, labels);
  return static_cast<int>(cudaGetLastError());
}
