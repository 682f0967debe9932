// Exact greedy NMS over score-sorted candidates, as a bitmask NMS for Hopper.
//
// Replaces ubteacher_tpu/ops/pallas/nms_pallas.py:nms_keep_pallas
// (_nms_core / _nms_kernel). Same kept set: a candidate is suppressed by any
// earlier (higher-scoring) kept candidate with IoU > t, compared without a
// division as inter > t * union, the form nms_pallas.py:106-116 uses.
//
// What bounds it on the H100: the all-pairs overlap test is K^2 / 2 box
// pairs of about twenty flops (8 images x 5,000 candidates per FCOS decode,
// 120 rows x 2,000 in the R-CNN's RPN), well under 0.1 ms of CUDA-core time,
// and the greedy pass after it is a chain of dependent steps, one per 64-row
// tile of an image. Neither is bound by memory bandwidth: the first is plain
// f32 ALU work spread over the SMs, the second is latency, and every round
// trip to L2 or every single-thread loop on the chain adds to it.
//
// What the design does about it:
//   * The overlap bits are 64-bit words stored column-word-major, mask
//     (B, words, K): the 64 rows of one word of a tile are 512 contiguous
//     bytes, so the mask kernel's stores and the sweep's loads are coalesced.
//   * nms_mask_kernel: one 64-thread block per (column tile, row tile,
//     image). The block stages its 64 column boxes in shared memory; each
//     thread owns one row and packs the 64 overlap bits into one word. Only
//     the upper triangle (column tile >= row tile) is computed, and blocks
//     whose tiles lie past the image's valid count return at once, so the
//     work follows the candidates that passed the score threshold, as
//     nms_pallas.py:70-71 bounds its block loops.
//   * nms_sweep_kernel: one block of kSweepWarps warps per image walks its
//     tiles in order, two barriers per tile. At the top of a tile every
//     warp loads the words it will fold (word w of the tile's 64 rows, one
//     coalesced load, two rows a lane) and warp 0 the next tile's diagonal,
//     so no L2 round trip sits on the chain. Warp 0 resolves the in-tile
//     chain as the Pallas kernel does, by the fixpoint k = k0 & ~(k U) (U
//     the strictly upper diagonal words: the unique fixpoint is the greedy
//     answer, reached in chain-depth steps), each step an OR-reduction of
//     the kept lanes' words across the warp. Then every warp masks its
//     loaded words by the kept bits and OR-reduces them into the later
//     tiles' suppression words in shared memory.
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
constexpr int kSweepWarps = 16;
constexpr int kSweepThreads = kSweepWarps * 32;
constexpr int kPrefetch = 8;  // later words a warp holds in registers per tile

using u64 = unsigned long long;

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

// OR of a 64-bit value across the 32 lanes of a warp.
__device__ __forceinline__ u64 warp_or(u64 v) {
  const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v));
  const unsigned hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v >> 32));
  return (static_cast<u64>(hi) << 32) | lo;
}

// The kept rows' words: lane l holds rows l and l + 32 of a tile.
__device__ __forceinline__ u64 kept_or(u64 kept, int lane, u64 lo, u64 hi) {
  u64 v = ((kept >> lane) & 1ULL) ? lo : 0ULL;
  if ((kept >> (lane + 32)) & 1ULL) v |= hi;
  return warp_or(v);
}

// boxes (B, K, 4) f32 score-sorted; nvalid (B,) i32; mask (B, words, K) u64.
__global__ void nms_mask_kernel(const float4* __restrict__ boxes,
                                const int* __restrict__ nvalid, int K,
                                int words, float t,
                                u64* __restrict__ mask) {
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
  u64 bits = 0ULL;
  const int start = (col_tile == row_tile) ? tid + 1 : 0;
  for (int j = start; j < ncols; ++j) {
    if (suppresses(rb, ra, col_box[j], col_area[j], t)) bits |= 1ULL << j;
  }
  mask[(static_cast<size_t>(b) * words + col_tile) * K + row] = bits;
}

// mask (B, words, K) u64 from nms_mask_kernel; keep (B, K) bool as bytes.
// Only the words the mask kernel wrote are read: rows below nvalid, column
// tiles at or after the row tile and below the image's valid tiles.
__global__ void __launch_bounds__(kSweepThreads)
nms_sweep_kernel(const u64* __restrict__ mask, const int* __restrict__ nvalid, int K, int words,
                 unsigned char* __restrict__ keep) {
  extern __shared__ u64 removed[];  // [words]: suppression bits found so far
  __shared__ u64 kept_word;

  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nv = nvalid[b];
  const int nwv = (nv + kTile - 1) / kTile;
  const u64* m = mask + static_cast<size_t>(b) * words * K;
  unsigned char* out = keep + static_cast<size_t>(b) * K;

  for (int w = threadIdx.x; w < words; w += kSweepThreads) removed[w] = 0ULL;
  for (int i = nv + threadIdx.x; i < K; i += kSweepThreads) out[i] = 0;

  // warp 0: the diagonal words of the current tile, two rows a lane (rows
  // past nv are never written by the mask kernel and never read)
  auto diag = [&](int tile, int r) -> u64 {
    const int row = tile * kTile + r;
    return row < nv ? m[static_cast<size_t>(tile) * K + row] : 0ULL;
  };
  u64 d_lo = 0ULL, d_hi = 0ULL;
  if (warp == 0 && nwv > 0) {
    d_lo = diag(0, lane);
    d_hi = diag(0, lane + 32);
  }
  __syncthreads();

  for (int tile = 0; tile < nwv; ++tile) {
    const int row0 = tile * kTile;
    const int nrows = min(kTile, nv - row0);
    // this warp's later words of the tile's rows, loaded before the chain
    // is resolved: word w = tile + 1 + warp + kSweepWarps * j
    u64 lo[kPrefetch], hi[kPrefetch];
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      const int w = tile + 1 + warp + kSweepWarps * j;
      lo[j] = hi[j] = 0ULL;
      if (w < nwv) {
        const u64* src = m + static_cast<size_t>(w) * K + row0;
        if (lane < nrows) lo[j] = src[lane];
        if (lane + 32 < nrows) hi[j] = src[lane + 32];
      }
    }
    if (warp == 0) {
      // the next tile's diagonal, in flight while this one resolves
      u64 n_lo = 0ULL, n_hi = 0ULL;
      if (tile + 1 < nwv) {
        n_lo = diag(tile + 1, lane);
        n_hi = diag(tile + 1, lane + 32);
      }
      const u64 valid = nrows == kTile ? ~0ULL : (1ULL << nrows) - 1ULL;
      const u64 k0 = ~removed[tile] & valid;
      u64 k = k0;
      for (;;) {  // at most chain depth + 1 rounds
        const u64 next = k0 & ~kept_or(k, lane, d_lo, d_hi);
        if (next == k) break;
        k = next;
      }
      if (lane == 0) kept_word = k;
      if (lane < nrows) out[row0 + lane] = static_cast<unsigned char>((k >> lane) & 1ULL);
      if (lane + 32 < nrows) out[row0 + lane + 32] = static_cast<unsigned char>((k >> (lane + 32)) & 1ULL);
      d_lo = n_lo;
      d_hi = n_hi;
    }
    __syncthreads();
    const u64 kw = kept_word;
    if (kw) {
#pragma unroll
      for (int j = 0; j < kPrefetch; ++j) {
        const int w = tile + 1 + warp + kSweepWarps * j;
        if (w < nwv) {
          const u64 sup = kept_or(kw, lane, lo[j], hi[j]);
          if (lane == 0) removed[w] |= sup;
        }
      }
      // words past the prefetched ones (K above 64 * (1 + kSweepWarps *
      // kPrefetch)), loaded here
      for (int w = tile + 1 + warp + kSweepWarps * kPrefetch; w < nwv; w += kSweepWarps) {
        const u64* src = m + static_cast<size_t>(w) * K + row0;
        const u64 a = lane < nrows ? src[lane] : 0ULL;
        const u64 c = lane + 32 < nrows ? src[lane + 32] : 0ULL;
        const u64 sup = kept_or(kw, lane, a, c);
        if (lane == 0) removed[w] |= sup;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success). Launches on
// `stream` and does not synchronise; the caller allocates mask (B, words, K)
// and keep.
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
                     static_cast<size_t>(words) * sizeof(u64), s>>>(
      mask, nvalid, K, words, keep);
  return static_cast<int>(cudaGetLastError());
}
