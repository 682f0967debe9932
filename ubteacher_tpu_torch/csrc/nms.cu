// Exact greedy NMS over score-sorted candidates, as a bitmask NMS for Hopper.
//
// Replaces ubteacher_tpu/ops/pallas/nms_pallas.py:nms_keep_pallas
// (_nms_core / _nms_kernel). Same kept set: a candidate is suppressed by any
// earlier (higher-scoring) kept candidate with IoU > t, compared without a
// division as inter > t * union, the form nms_pallas.py:106-116 uses.
//
// What bounds it on the H100: the all-pairs overlap test is
// K^2 / 2 box pairs of about twenty flops (K = 5000 candidates per image, 8
// images per decode), and the greedy pass after it is a chain of dependent
// steps, one per candidate. Neither is bound by memory bandwidth: the first is
// plain f32 ALU work spread over the SMs, the second is latency.
//
// What the design does about it:
//   * nms_mask_kernel: one 64-thread block per (column tile, row tile, image).
//     The block stages its 64 column boxes in shared memory; each thread owns
//     one row and packs the 64 overlap bits into one 64-bit word. Only the
//     upper triangle (column tile >= row tile) is computed, and blocks whose
//     tiles lie past the image's valid count return at once, so the work
//     follows the candidates that passed the score threshold, as
//     nms_pallas.py:70-71 bounds its block loops.
//   * nms_sweep_kernel: one block per image turns the words into the keep
//     mask. Per 64-row tile, the tile's diagonal words are staged in shared
//     memory and one thread resolves the in-tile chain in registers; then all
//     threads OR the kept rows' words into the later tiles' suppression words.
//   * One launch of each covers all B images of a decode, the counterpart of
//     the custom_vmap flattening at nms_pallas.py:190-197.
//
// The arithmetic uses the __f*_rn intrinsics so that nvcc does not contract
// it into fused multiply-adds: the compare then rounds exactly as the plain
// PyTorch version (ops/kernels/nms_cuda.py) and the Pallas kernel do.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libubt_nms.so nms.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kSweepThreads = 128;

__device__ __forceinline__ float box_area(const float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

// Row box a (earlier in score order) suppresses column box b?
__device__ __forceinline__ bool suppresses(const float4 a, const float area_a,
                                           const float4 b, const float area_b,
                                           const float t) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return inter > __fmul_rn(t, uni);
}

// boxes (B, K, 4) f32 score-sorted; nvalid (B,) i32; mask (B, K, words) u64.
__global__ void nms_mask_kernel(const float4* __restrict__ boxes,
                                const int* __restrict__ nvalid, int K,
                                int words, float t,
                                unsigned long long* __restrict__ mask) {
  const int col_tile = blockIdx.x;
  const int row_tile = blockIdx.y;
  const int b = blockIdx.z;
  if (col_tile < row_tile) return;
  const int nv = nvalid[b];
  const int row0 = row_tile * kTile;
  const int col0 = col_tile * kTile;
  if (row0 >= nv || col0 >= nv) return;

  __shared__ float4 col_box[kTile];
  __shared__ float col_area[kTile];
  const float4* img = boxes + static_cast<size_t>(b) * K;
  const int tid = threadIdx.x;
  const int ncols = min(kTile, nv - col0);
  if (tid < ncols) {
    const float4 v = img[col0 + tid];
    col_box[tid] = v;
    col_area[tid] = box_area(v);
  }
  __syncthreads();

  const int row = row0 + tid;
  if (row >= nv) return;
  const float4 rb = img[row];
  const float ra = box_area(rb);
  unsigned long long bits = 0ULL;
  const int start = (col_tile == row_tile) ? tid + 1 : 0;
  for (int j = start; j < ncols; ++j) {
    if (suppresses(rb, ra, col_box[j], col_area[j], t)) bits |= 1ULL << j;
  }
  mask[(static_cast<size_t>(b) * K + row) * words + col_tile] = bits;
}

// mask (B, K, words) u64 from nms_mask_kernel; keep (B, K) bool as bytes.
__global__ void nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                                 const int* __restrict__ nvalid, int K,
                                 int words,
                                 unsigned char* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];  // [words]
  __shared__ unsigned long long diag[kTile];
  __shared__ unsigned long long kept_word;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nv = nvalid[b];
  const int nwv = (nv + kTile - 1) / kTile;
  const unsigned long long* m = mask + static_cast<size_t>(b) * K * words;
  unsigned char* out = keep + static_cast<size_t>(b) * K;

  for (int w = tid; w < words; w += blockDim.x) removed[w] = 0ULL;
  for (int i = nv + tid; i < K; i += blockDim.x) out[i] = 0;
  __syncthreads();

  for (int tile = 0; tile < nwv; ++tile) {
    const int row0 = tile * kTile;
    const int nrows = min(kTile, nv - row0);
    if (tid < nrows) {
      diag[tid] = m[static_cast<size_t>(row0 + tid) * words + tile];
    }
    __syncthreads();
    if (tid == 0) {
      unsigned long long rem = removed[tile];
      unsigned long long kw = 0ULL;
      for (int i = 0; i < nrows; ++i) {
        if (!((rem >> i) & 1ULL)) {
          kw |= 1ULL << i;
          rem |= diag[i];
        }
      }
      kept_word = kw;
    }
    __syncthreads();
    const unsigned long long kw = kept_word;
    for (int w = tile + 1 + tid; w < nwv; w += blockDim.x) {
      unsigned long long acc = removed[w];
      unsigned long long k = kw;
      while (k) {
        const int i = __ffsll(static_cast<long long>(k)) - 1;
        k &= k - 1ULL;
        acc |= m[static_cast<size_t>(row0 + i) * words + w];
      }
      removed[w] = acc;
    }
    if (tid < nrows) out[row0 + tid] = static_cast<unsigned char>((kw >> tid) & 1ULL);
    __syncthreads();
  }
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success). Launches on
// `stream` and does not synchronise; the caller allocates mask and keep.
extern "C" int ubt_nms_keep_sorted(const float* boxes, const int* nvalid,
                                   int batch, int K, float iou_threshold,
                                   unsigned long long* mask,
                                   unsigned char* keep, void* stream) {
  if (batch == 0 || K == 0) return 0;
  const int words = (K + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(words, words, batch);
  nms_mask_kernel<<<grid, kTile, 0, s>>>(reinterpret_cast<const float4*>(boxes),
                                         nvalid, K, words, iou_threshold, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_sweep_kernel<<<batch, kSweepThreads,
                     static_cast<size_t>(words) * sizeof(unsigned long long), s>>>(
      mask, nvalid, K, words, keep);
  return static_cast<int>(cudaGetLastError());
}
