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
// registers, and the kernel must write the two int64 (B, A) outputs: 99 MB,
// 0.03 ms at 3.35 TB/s. The IoU of every (anchor, gt slot up to the last
// valid one) pair, twice, is about 20 float32 operations and an IEEE
// division per pair; most pairs do not overlap, and their IoU is exactly 0
// (inter = 0, so 0 / union or the union <= 0 branch), so the design
// computes only the pairs whose boxes can overlap.
//
// What the design does about it. Each block stages its image's gt slots in
// shared memory and finds the first and last valid slot itself (the
// launcher runs nothing else but the memset of gm). Anchors are ordered (level, H, W, 3), so
// the 32 anchors of a warp lie along one row of one level's grid (about 11
// cells; a warp that straddles a row end gets a wide rectangle, which costs
// speed, not correctness). Each warp reduces its anchors' union rectangle
// with shuffles; its lanes test the staged gts against it, 32 slots at a
// time, as a closed intersection, and a ballot gives the candidate mask in
// slot order: valid slots whose box meets the rectangle, or that have a
// non-finite coordinate (their IoU is 0 too, but the rule keeps them). A
// valid gt outside the rectangle is strictly left, right, above or below
// every anchor of the warp, so its IoU with each is exactly +0.
//   * match_best_per_gt (pass 1, only with the low-quality promotion): one
//     warp per group of 32 anchors, 8 a block. Only an IoU > 0 can promote
//     (the promotion needs a best > 0), so a lane whose candidate IoU is > 0
//     and above the block's best for that gt so far (read first, in shared
//     memory) raises it by an atomic max on the float's bits; the block then
//     publishes one global atomic max per gt it raised into gm (B, M),
//     which the launcher fills with -1 (memset). IoUs > 0 order as signed
//     ints like the floats do, and -1 is below them all. A gt no block
//     raised keeps -1 (NaN as a float) instead of a best of 0; either way
//     nothing is promoted to it.
//   * match_anchors (pass 2): one lane per anchor starts from what the
//     culled pairs would give, (0, first valid slot) when some slot is
//     valid, (-inf, 0) when none is (an invalid slot scores -1, and either
//     labels l0), and keeps the running max and first argmax over the
//     candidates in slot order (strict > keeps the earlier slot on ties, as
//     argmax does); then the thresholds, and the promotion of an anchor that
//     reaches some gt's best IoU gm[j] > 0. q = gm[j] > 0 needs an overlap,
//     so the candidates cover it. The matched index and label are written as
//     int64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libubt_matcher.so matcher.cu

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;                  // 8 warps, one group of 32 anchors each
constexpr int kAnchorsPerBlock = kThreads;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEmpty = -1;                     // gm's fill: below every IoU's bits, NaN as a float

__device__ __forceinline__ float box_area(const float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// ops/boxes.py:pairwise_iou for one (gt, anchor) pair. A pair that does not
// overlap (inter = 0) skips the division: its IoU is 0 either way (of
// either sign, which no comparison here tells apart).
__device__ __forceinline__ float pair_iou(const float4 g, const float ga,
                                          const float4 a, const float aa) {
  const float iw = fmaxf(__fsub_rn(fminf(g.z, a.z), fmaxf(g.x, a.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(g.w, a.w), fmaxf(g.y, a.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(ga, aa), inter);
  return inter > 0.0f && uni > 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.0f;
}

__device__ __forceinline__ bool finite4(const float4 b) {
  return isfinite(b.x) && isfinite(b.y) && isfinite(b.z) && isfinite(b.w);
}

// Shared memory of a block: one image's M gt slots (boxes, areas, validity),
// its first valid slot and its last valid slot + 1 (ngt), and a per-slot
// word (pass 1: the block's best IoU bits; pass 2: gm).
struct Stage {
  float4* box;
  float* area;
  int* word;
  int* first;
  int* ngt;
  unsigned char* valid;
};

__host__ __device__ __forceinline__ size_t stage_bytes(int M) { return static_cast<size_t>(M) * 24 + 8 + M; }

__device__ __forceinline__ Stage carve(unsigned char* smem, int M) {
  Stage s;
  s.box = reinterpret_cast<float4*>(smem);
  s.area = reinterpret_cast<float*>(s.box + M);
  s.word = reinterpret_cast<int*>(s.area + M);
  s.first = s.word + M;
  s.ngt = s.first + 1;
  s.valid = reinterpret_cast<unsigned char*>(s.ngt + 1);
  return s;
}

// Stage image b's slots; `word` is filled from `init` (gm) or with kEmpty.
// The first and last valid slots come from the mask itself.
__device__ __forceinline__ void stage_gt(const float4* __restrict__ gt, const unsigned char* __restrict__ mask,
                                         const int* __restrict__ init, int b, int M, const Stage& s) {
  if (threadIdx.x == 0) {
    *s.first = M;
    *s.ngt = 0;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < M; j += blockDim.x) {
    const size_t o = static_cast<size_t>(b) * M + j;
    const unsigned char v = mask[o];
    s.valid[j] = v;
    s.word[j] = init ? init[o] : kEmpty;
    if (v) {
      const float4 g = gt[o];
      s.box[j] = g;
      s.area[j] = box_area(g);
      atomicMin(s.first, j);
      atomicMax(s.ngt, j + 1);
    }
  }
  __syncthreads();
}

// The warp's 32 anchors: the lane's anchor k (zeros past A) and area, and
// the union rectangle of the warp's anchors below A.
struct WarpAnchors {
  float4 a;
  float aa;
  float4 rect;
  int k;
};

__device__ __forceinline__ float4 load_anchor(const float4* __restrict__ anchors, int A, int k) {
  return k < A ? anchors[k] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ WarpAnchors group_of(float4 a, int A, int k) {
  WarpAnchors w;
  w.k = k;
  w.a = a;
  w.aa = box_area(a);
  float4 r = k < A ? a : make_float4(INFINITY, INFINITY, -INFINITY, -INFINITY);
  for (int off = 16; off > 0; off >>= 1) {
    r.x = fminf(r.x, __shfl_xor_sync(kFull, r.x, off));
    r.y = fminf(r.y, __shfl_xor_sync(kFull, r.y, off));
    r.z = fmaxf(r.z, __shfl_xor_sync(kFull, r.z, off));
    r.w = fmaxf(r.w, __shfl_xor_sync(kFull, r.w, off));
  }
  w.rect = r;
  return w;
}

// Candidate mask of slots 32 c .. 32 c + 31 (< ngt) against the warp's
// rectangle: valid, and meeting it (closed) or non-finite. Warp-uniform.
__device__ __forceinline__ unsigned candidates(const Stage& s, int ngt, int c, const float4 r) {
  const int j = 32 * c + (threadIdx.x & 31);
  bool cand = false;
  if (j < ngt && s.valid[j]) {
    const float4 g = s.box[j];
    cand = (g.x <= r.z && g.z >= r.x && g.y <= r.w && g.w >= r.y) || !finite4(g);
  }
  return __ballot_sync(kFull, cand);
}

// grid (ceil(A / 256), B); dynamic shared memory stage_bytes(M).
__global__ void __launch_bounds__(kThreads)
match_best_per_gt(const float4* __restrict__ anchors, int A, const float4* __restrict__ gt,
                  const unsigned char* __restrict__ mask, int M, int* __restrict__ gm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int k = blockIdx.x * kAnchorsPerBlock + threadIdx.x;
  const float4 a = load_anchor(anchors, A, k);  // in flight while the gts are staged
  const Stage s = carve(smem, M);
  stage_gt(gt, mask, nullptr, b, M, s);
  const int ngt = *s.ngt;
  if (ngt == 0) return;  // uniform over the block

  const WarpAnchors w = group_of(a, A, k);
  const int chunks = (ngt + 31) / 32;
  for (int c = 0; c < chunks; ++c) {
    unsigned word = candidates(s, ngt, c, w.rect);
    while (word) {
      const int j = 32 * c + __ffs(word) - 1;
      word &= word - 1;
      // only an IoU > 0 can promote; it is read first and raised only when
      // this lane beats the block's best so far
      const float q = k < A ? pair_iou(s.box[j], s.area[j], w.a, w.aa) : 0.0f;
      if (q > 0.0f && __float_as_int(q) > s.word[j]) atomicMax(s.word + j, __float_as_int(q));
    }
  }
  __syncthreads();
  // one global atomic per gt this block raised
  for (int j = threadIdx.x; j < ngt; j += blockDim.x)
    if (s.word[j] != kEmpty) atomicMax(gm + static_cast<size_t>(b) * M + j, s.word[j]);
}

// grid (ceil(A / 256), B); dynamic shared memory stage_bytes(M).
__global__ void __launch_bounds__(kThreads)
match_anchors(const float4* __restrict__ anchors, int A, const float4* __restrict__ gt,
              const unsigned char* __restrict__ mask, int M, const int* __restrict__ gm, float t_lo, float t_hi,
              int l0, int l1, int l2, long long* __restrict__ matched_idx, long long* __restrict__ labels) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int k = blockIdx.x * kAnchorsPerBlock + threadIdx.x;
  const float4 a = load_anchor(anchors, A, k);
  const Stage s = carve(smem, M);
  stage_gt(gt, mask, gm, b, M, s);
  const int ngt = *s.ngt, first = *s.first;
  const float* s_gm = reinterpret_cast<const float*>(s.word);  // kEmpty reads as NaN: never > 0

  const WarpAnchors w = group_of(a, A, k);
  // what the culled pairs give: IoU 0 at the first valid slot; with no
  // valid slot every slot scores -1 (or there is none), and either way the
  // label is l0 and the index 0
  float mv = ngt ? 0.0f : -INFINITY;
  int mi = ngt ? first : 0;
  bool promote = false;
  const int chunks = (ngt + 31) / 32;
  for (int c = 0; c < chunks; ++c) {
    unsigned word = candidates(s, ngt, c, w.rect);
    while (word) {
      const int j = 32 * c + __ffs(word) - 1;
      word &= word - 1;
      const float q = pair_iou(s.box[j], s.area[j], w.a, w.aa);
      if (q > mv) {
        mv = q;
        mi = j;
      }
      if (gm && s_gm[j] > 0.0f && q == s_gm[j]) promote = true;
    }
  }
  if (k < A) {
    int lab = l0;
    if (mv >= t_lo) lab = l1;
    if (mv >= t_hi) lab = l2;
    if (promote) lab = l2;
    const size_t o = static_cast<size_t>(b) * A + k;
    matched_idx[o] = mi;
    labels[o] = lab;
  }
}

}  // namespace

// anchors (A, 4) f32; gt (B, M, 4) f32; mask (B, M) bool bytes; gm (B, M)
// int32 scratch (each gt's best IoU bits); matched_idx, labels (B, A)
// int64. Returns the cudaError_t of the launches (0 on success); launches
// on `stream` and does not synchronise.
extern "C" int ubt_match_anchors(const float* anchors, int A, const float* gt, const unsigned char* mask, int B,
                                 int M, float t_lo, float t_hi, int l0, int l1, int l2, int allow_low_quality,
                                 int* gm, long long* matched_idx, long long* labels, void* stream) {
  if (B == 0 || A == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* a4 = reinterpret_cast<const float4*>(anchors);
  const float4* g4 = reinterpret_cast<const float4*>(gt);
  const size_t smem = stage_bytes(M);
  const dim3 grid((A + kAnchorsPerBlock - 1) / kAnchorsPerBlock, B);
  const bool promote = allow_low_quality && M > 0;
  if (promote) {
    cudaError_t err = cudaMemsetAsync(gm, 0xff, static_cast<size_t>(B) * M * sizeof(int), s);  // kEmpty
    if (err != cudaSuccess) return static_cast<int>(err);
    match_best_per_gt<<<grid, kThreads, smem, s>>>(a4, A, g4, mask, M, gm);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  match_anchors<<<grid, kThreads, smem, s>>>(a4, A, g4, mask, M, promote ? gm : nullptr, t_lo, t_hi, l0, l1, l2,
                                            matched_idx, labels);
  return static_cast<int>(cudaGetLastError());
}
