// Fused ResNet stem: 7x7/s2 convolution (padding 3) with the FrozenBN scale
// folded into the weights, + bias, ReLU, and 3x3/s2 max-pool (padding 1).
//
// Replaces ubteacher_tpu/ops/pallas/stem_pallas.py:stem_conv_pool
// (_stem_kernel), which JAX runs under TPU.STEM_MODE="pallas". What it
// computes, in the order of the Pallas kernel: x (B, H, W, 3) float32,
// rounded to the compute dtype; weights k = kernel * scale folded in float32
// and rounded to the compute dtype (_fold_weights), here in the kernel, so a
// call launches nothing else; the conv sum accumulated in float32; the sum
// rounded to the output dtype, the bias
// (rounded to that dtype) added in it, ReLU; the max-pool. Output
// (B, ceil(H/4), ceil(W/4), 64) NHWC, float32 or bfloat16. Pool taps that
// fall outside the conv output are skipped, not taken as the conv of zero
// padding (that value is ReLU(bias), not 0): every window holds its centre
// tap, and all values are >= 0 after the ReLU, so a skipped tap is a 0.
//
// The image is read where it lies: both kernels take its four element
// strides, so the model passes its NCHW batch as the permuted (B, H, W, 3)
// view and no NHWC copy is made; with NCHW strides the staging loops walk
// each channel plane along its rows, so the reads are coalesced.
//
// What bounds it on the H100: at the eval shape (8, 800, 1344, 3) the conv
// is 8 x 400 x 672 x 64 outputs x 147 multiply-adds = 40.5 GFLOP, against
// 103 MB of float32 image read and 69 MB of bfloat16 output written. On the
// tensor cores (bf16, 989 TFLOP/s) that is 0.04 ms of arithmetic against
// 0.05 ms of memory traffic; on the CUDA cores (float32 FMA, 67 TFLOP/s) the
// arithmetic alone is 0.6 ms.
//
// bfloat16 output (the path eval takes under autocast): an implicit GEMM on
// the tensor cores, mma.sync.m16n8k16 bf16 -> f32. A tile is 8 pooled rows
// x 31 pooled columns x 64 channels of one image, from 17 conv rows x 64
// conv columns (63 used; 10% recomputed). The grid is persistent, one block
// of 256 threads an SM, each walking tiles blockIdx.x, + gridDim.x, ...:
//   * the 39 x 134 input pixels a tile needs (zero outside the image) are
//     copied by cp.async into a float32 buffer while the block computes the
//     tile before, one warp per window row (coalesced along NCHW rows);
//     then converted once to bf16 in shared memory, channels interleaved, one row of
//     402 values padded to 404. For a fixed ky the 21 taps (kx, ci) of conv
//     pixel (row r, column c) are then the 21 consecutive values starting at
//     element 6c of staged row 2r + ky: A is a strided view of shared memory
//     and no im2col buffer exists. Every (k, k+1) pair starts on a 4-byte
//     boundary (12c + 2t bytes), so A fragments are plain 32-bit loads; the
//     8 rows of a fragment are 8 consecutive conv columns, 3 words apart, so
//     the 32 lanes touch 25 distinct words in 25 banks.
//   * K = 147 is taken as 7 ky slices of 24 taps (21 real, 3 zero weights),
//     168, padded to 176 = 11 k16 steps. The pad taps would read the next
//     pixel, and NaN x 0 is NaN, so their A halves are masked to zero in
//     registers: a non-finite pixel outside a window cannot reach it.
//   * The folded weights sit in registers: warp w takes 16 conv columns
//     (w & 3) and 32 channels (w >> 2), and each lane folds and rounds its
//     B fragments for all 11 k steps (88 registers) once per block, from
//     the kernel and scale read at their strides.
//   * The warp walks its 17 conv rows in order: per row 11 x 4 MMAs, then
//     the epilogue on channel pairs in bf16x2 (round, add the bias, ReLU;
//     conv rows or columns outside the conv output become 0). The
//     3-row max is taken in registers as the rows go by (each pooled row
//     keeps the pair before it), and each pooled row's values go to shared
//     memory, channel stride padded so the 8 columns of a store hit 32 banks.
//   * The 3-column max is taken from shared memory and the 8 x 31 x 64
//     outputs are written channel-fastest with 16-byte stores.
// Only the pooled output reaches device memory, as in the Pallas kernel.
//
// float32 output stays on the CUDA cores (TF32 would not meet the float32
// tolerance; eval does not take this path). One block of 256 threads
// computes 4 pooled rows x 15 pooled columns x 64 channels: the 23 x 67 x 3
// input pixels, each channel plane split into even and odd columns, and the
// 7 x 7 x 3 x 64 folded weights (37.6 KB) in shared memory; lane k of warp
// g computes conv column k for the 9 conv rows and the 8 channels
// 8g..8g+7 (72 accumulators); the 3-row max in registers, the 3-column max
// through shared memory, channel-fastest stores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libubt_stem.so stem.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// element strides of the image (batch, row, column, channel) or of the
// kernel (ky, kx, ci, n)
struct UbtStemStrides {
  long long b, h, w, c;
};

namespace {

constexpr int kC = 64;     // output channels
constexpr int kCin = 3;    // input channels
constexpr int kK = 7;      // conv kernel size
constexpr int kThreads = 256;

// Load the float32 kernel's window: input rows r_base.., pixel columns
// u_base.., zero outside the image; put(lr, lc, ci, v) stores one value.
// With channel-planar strides (c != 1) the column runs fastest, so a warp
// reads consecutive addresses of one plane's row.
template <int kRows, int kCols, typename Put>
__device__ __forceinline__ void stage_window(const float* __restrict__ x, const UbtStemStrides st, int b, int H,
                                             int W, int r_base, int u_base, Put put) {
  const float* xb = x + b * st.b;
  constexpr int kN = kRows * kCols * kCin;
  if (st.c == 1) {
    for (int i = threadIdx.x; i < kN; i += blockDim.x) {
      const int lr = i / (kCols * kCin);
      const int rem = i - lr * (kCols * kCin);
      const int lc = rem / kCin;
      const int ci = rem - lc * kCin;
      const int gr = r_base + lr, gc = u_base + lc;
      float v = 0.0f;
      if (gr >= 0 && gr < H && gc >= 0 && gc < W) v = __ldg(xb + gr * st.h + gc * st.w + ci);
      put(lr, lc, ci, v);
    }
  } else {
    for (int i = threadIdx.x; i < kN; i += blockDim.x) {
      const int ci = i / (kRows * kCols);
      const int rem = i - ci * (kRows * kCols);
      const int lr = rem / kCols;
      const int lc = rem - lr * kCols;
      const int gr = r_base + lr, gc = u_base + lc;
      float v = 0.0f;
      if (gr >= 0 && gr < H && gc >= 0 && gc < W) v = __ldg(xb + gr * st.h + gc * st.w + ci * st.c);
      put(lr, lc, ci, v);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: implicit GEMM on the tensor cores
// ---------------------------------------------------------------------------
namespace mma {

constexpr int kTP = 8;                            // pooled rows per block
constexpr int kTQ = 31;                           // pooled columns per block
constexpr int kConvRows = 2 * kTP + 1;            // 17
constexpr int kConvCols = 64;                     // 2 kTQ + 1 = 63 used
constexpr int kInRows = 2 * (kConvRows - 1) + kK; // 39
constexpr int kInCols = 2 * (kConvCols - 1) + kK + 1;  // 134: the last pad taps stay in the row
constexpr int kRowStride = 404;                   // bf16 values per staged row (402 used)
constexpr int kSlice = 24;                        // taps per ky slice: 21 real, 3 zero
constexpr int kKSteps = 11;                       // 7 x 24 = 168, padded to 176
constexpr int kPoolStride = 72;                   // bf16 channels per pooled column, padded
constexpr int kSmemIn = (kInRows * kRowStride * 2 + 15) / 16 * 16;  // bytes, 16-byte aligned
constexpr int kSmemPool = kTP * kConvCols * kPoolStride * 2;
constexpr int kSmemRaw = kCin * kInRows * kInCols * 4;  // the next window, float32 by plane
constexpr size_t kSmemBytes = kSmemIn + kSmemPool + kSmemRaw;

static_assert(kInCols * kCin <= kRowStride, "staged row");
static_assert(kRowStride % 2 == 0, "4-byte aligned rows");
static_assert(6 * (kConvCols - 1) + kSlice <= kRowStride, "pad taps stay in the staged row");
static_assert(kThreads == 32 * (kConvCols / 16) * 2, "one warp per (16 conv columns, 32 channels)");
static_assert(kSmemIn % 16 == 0 && (kPoolStride * 2) % 16 == 0, "16-byte pooled columns");
static_assert(kSmemBytes <= 227 * 1024, "one block an SM");

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 m = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&m);
}

// The folded weight of tap t (0..23) of slice ky for channel n, float32;
// 0 for the pad taps and slices.
__device__ __forceinline__ float folded_tap(const float* __restrict__ kern, const UbtStemStrides& ks,
                                            const float* __restrict__ scale, int ky, int t, int n) {
  if (ky >= kK || t >= kK * kCin) return 0.0f;
  const int kx = t / kCin, ci = t - kx * kCin;
  return __fmul_rn(__ldg(kern + ky * ks.b + kx * ks.h + ci * ks.w + n * ks.c), __ldg(scale + n));
}

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* src, bool fill) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(fill ? 4 : 0));
}

// Tile t of the grid of (B, ceil(Hp / kTP), ceil(Wp / kTQ)) tiles, columns fastest.
struct Tile {
  int b, p0, q0;
};

__device__ __forceinline__ Tile tile_of(int t, int ntx, int nty) {
  Tile r;
  r.b = t / (ntx * nty);
  const int rem = t - r.b * ntx * nty;
  r.p0 = (rem / ntx) * kTP;
  r.q0 = (rem % ntx) * kTQ;
  return r;
}

// Start copying tile t's window (input rows 4 p0 - 5 .., pixel columns
// 4 q0 - 5 ..) into raw, float32 by channel plane, zero outside the image;
// one warp per window row, so with NCHW strides a warp reads one plane row.
__device__ __forceinline__ void prefetch(float* raw, const float* __restrict__ x, const UbtStemStrides& st, int H,
                                         int W, const Tile& t) {
  const int lane = threadIdx.x & 31;
  const int r_base = 4 * t.p0 - 5, u_base = 4 * t.q0 - 5;
  for (int row = threadIdx.x >> 5; row < kCin * kInRows; row += kThreads / 32) {
    const int ci = row / kInRows;
    const int gr = r_base + (row - ci * kInRows);
    const bool row_ok = gr >= 0 && gr < H;
    const float* src = x + t.b * st.b + (row_ok ? gr : 0) * st.h + ci * st.c;
    for (int lc = lane; lc < kInCols; lc += 32) {
      const int gc = u_base + lc;
      const bool ok = row_ok && gc >= 0 && gc < W;
      cp_async4(raw + row * kInCols + lc, ok ? src + gc * st.w : x, ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// kern (7, 7, 3, 64) float32 at strides ks, scale and bias (64,) float32.
// A persistent grid: each block folds its B fragments once and walks the
// tiles t = blockIdx.x, + gridDim.x, ..., copying the next tile's window
// (cp.async) while it computes the current one.
__global__ void __launch_bounds__(kThreads, 1)
stem_conv_pool_mma(const float* __restrict__ x, UbtStemStrides st, const float* __restrict__ kern,
                   UbtStemStrides ks, const float* __restrict__ scale, const float* __restrict__ bias, int B,
                   int H, int W, int Ho, int Wo, int Hp, int Wp, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_pool = reinterpret_cast<__nv_bfloat16*>(smem + kSmemIn);
  float* raw = reinterpret_cast<float*>(smem + kSmemIn + kSmemPool);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;   // fragment row group: conv column g and g + 8 of the m-tile
  const int tig = lane & 3;  // thread in group: k pair / channel pair
  const int cb = warp & 3;   // conv columns 16 cb .. 16 cb + 15
  const int nh = warp >> 2;  // channels 32 nh .. 32 nh + 31
  const int ntx = (Wp + kTQ - 1) / kTQ, nty = (Hp + kTP - 1) / kTP;
  const int ntiles = ntx * nty * B;

  if (blockIdx.x < ntiles) prefetch(raw, x, st, H, W, tile_of(blockIdx.x, ntx, nty));

  // B fragments for all 11 k steps and the warp's 4 n-tiles: bf[s][j][h]
  // holds k = 16 s + 8 h + 2 tig, +1 (slice (2 s + h) / 3, taps
  // 8 ((2 s + h) % 3) + 2 tig, +1) of channel 32 nh + 8 j + g, rounded to bf16
  uint32_t bf[kKSteps][4][2];
#pragma unroll
  for (int s = 0; s < kKSteps; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ky = (2 * s + h) / 3, t = 8 * ((2 * s + h) % 3) + 2 * tig, n = 32 * nh + 8 * j + g;
        bf[s][j][h] = pack_bf16(folded_tap(kern, ks, scale, ky, t, n), folded_tap(kern, ks, scale, ky, t + 1, n));
      }
  __nv_bfloat162 bv[4];  // the bias of the lane's channel pairs, rounded to bf16
#pragma unroll
  for (int j = 0; j < 4; ++j)
    bv[j] = __floats2bfloat162_rn(__ldg(bias + 32 * nh + 8 * j + 2 * tig), __ldg(bias + 32 * nh + 8 * j + 2 * tig + 1));
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.0f, 0.0f);

  // the pad taps t = 21, 22, 23 sit in the k block t0 = 16 of each slice:
  // (20, 21) keeps its low half, (22, 23) is zero
  const uint32_t pad_mask = tig < 2 ? 0xffffffffu : (tig == 2 ? 0x0000ffffu : 0u);
  const int c_lo = 16 * cb + g;  // local conv columns of fragment rows g and g + 8
  const __nv_bfloat16* a_base = s_in + 6 * c_lo + 2 * tig;

#pragma unroll 1
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const Tile t = tile_of(tile, ntx, nty);
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();  // the window has landed; the last tile's pooled rows are written out
    // bf16, channels interleaved: s_in[lr][3 lc + ci]
    for (int i = threadIdx.x; i < kInRows * kInCols; i += kThreads) {
      const int lr = i / kInCols, lc = i - lr * kInCols;
#pragma unroll
      for (int ci = 0; ci < kCin; ++ci)
        s_in[lr * kRowStride + lc * kCin + ci] = __float2bfloat16_rn(raw[(ci * kInRows + lr) * kInCols + lc]);
    }
    __syncthreads();
    if (tile + gridDim.x < ntiles) prefetch(raw, x, st, H, W, tile_of(tile + gridDim.x, ntx, nty));

    const int gc_lo = 2 * t.q0 - 1 + c_lo, gc_hi = gc_lo + 8;
    const bool col_lo = gc_lo >= 0 && gc_lo < Wo, col_hi = gc_hi >= 0 && gc_hi < Wo;
    uint32_t pair[4][2];  // the running max of the pooled row's first two conv rows
#pragma unroll 2  // two rows in flight: the next row's loads overlap this row's epilogue
    for (int r = 0; r < kConvRows; ++r) {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
      const __nv_bfloat16* a_row = a_base + 2 * r * kRowStride;
#pragma unroll
      for (int s = 0; s < kKSteps; ++s) {
        uint32_t a[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int blk = 2 * s + h;  // k block of 8: slice blk / 3, taps 8 (blk % 3) ..
          if (blk / 3 >= kK) {
            a[2 * h] = a[2 * h + 1] = 0u;
            continue;
          }
          const __nv_bfloat16* ap = a_row + (blk / 3) * kRowStride + 8 * (blk % 3);
          uint32_t lo = *reinterpret_cast<const uint32_t*>(ap);
          uint32_t hi = *reinterpret_cast<const uint32_t*>(ap + 48);  // conv column + 8: 6 x 8 values on
          if (blk % 3 == 2) {
            lo &= pad_mask;
            hi &= pad_mask;
          }
          a[2 * h] = lo;
          a[2 * h + 1] = hi;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[j], a, bf[s][j][0], bf[s][j][1]);
      }

      // epilogue on channel pairs: round to bf16, add the bias in bf16 (one
      // rounding of the exact sum, which for two bf16 values is the float32
      // sum rounded to bf16), ReLU; 0 outside the conv output
      const int gr = 2 * t.p0 - 1 + r;
      const bool row_ok = gr >= 0 && gr < Ho;
      uint32_t v[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool ok = row_ok && (h ? col_hi : col_lo);
          const __nv_bfloat162 e =
              __hmax2(__hadd2(__floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]), bv[j]), zero2);
          v[j][h] = ok ? *reinterpret_cast<const uint32_t*>(&e) : 0u;
        }
      }
      // pooled row i covers local conv rows 2i, 2i + 1, 2i + 2
      if (r > 0 && (r & 1) == 0) {
        const int i = r / 2 - 1;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ch = 32 * nh + 8 * j + 2 * tig;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(s_pool + (i * kConvCols + c_lo + 8 * h) * kPoolStride + ch) =
                max_bf16x2(pair[j][h], v[j][h]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) pair[j][h] = (r & 1) ? max_bf16x2(pair[j][h], v[j][h]) : v[j][h];
    }
    __syncthreads();

    // pooled column jq covers local conv columns 2 jq .. 2 jq + 2; 8 channels
    // (16 bytes) a thread, channel-fastest
    for (int f = threadIdx.x; f < kTP * kTQ * (kC / 8); f += kThreads) {
      const int c8 = f % (kC / 8);
      const int jq = (f / (kC / 8)) % kTQ;
      const int i = f / ((kC / 8) * kTQ);
      const int p = t.p0 + i, q = t.q0 + jq;
      if (p >= Hp || q >= Wp) continue;
      const uint4* col = reinterpret_cast<const uint4*>(s_pool + (i * kConvCols + 2 * jq) * kPoolStride + 8 * c8);
      constexpr int kStep = kPoolStride / 8;  // one conv column in uint4
      const uint4 u0 = col[0], u1 = col[kStep], u2 = col[2 * kStep];
      uint4 m;
      m.x = max_bf16x2(max_bf16x2(u0.x, u1.x), u2.x);
      m.y = max_bf16x2(max_bf16x2(u0.y, u1.y), u2.y);
      m.z = max_bf16x2(max_bf16x2(u0.z, u1.z), u2.z);
      m.w = max_bf16x2(max_bf16x2(u0.w, u1.w), u2.w);
      *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(t.b) * Hp + p) * Wp + q) * kC + 8 * c8) = m;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

}  // namespace mma

// ---------------------------------------------------------------------------
// float32: direct conv on the CUDA cores
// ---------------------------------------------------------------------------
namespace direct {

constexpr int kTP = 4;                           // pooled rows per block
constexpr int kTQ = 15;                          // pooled columns per block
constexpr int kConvRows = 2 * kTP + 1;           // 9 conv rows pooled over
constexpr int kConvCols = 2 * kTQ + 1;           // 31 conv columns
constexpr int kInRows = 2 * (kConvRows - 1) + kK;  // 23 input rows
constexpr int kInCols = 2 * (kConvCols - 1) + kK;  // 67 input columns
constexpr int kHalf = (kInCols + 1) / 2;         // 34 entries per column parity
constexpr int kInRowStride = 2 * kHalf;          // one input row: even half, odd half
constexpr int kInPlane = kInRows * kInRowStride; // one input channel
constexpr int kCg = 8;                           // channels per thread
constexpr int kPoolStride = 33;                  // conv columns per row-pooled line, padded
constexpr int kTaps = kK * kK * kCin;

constexpr int kSmemIn = kCin * kInPlane;
constexpr int kSmemW = kTaps * kC;
constexpr int kSmemPool = kTP * kC * kPoolStride;
constexpr size_t kSmemBytes = (kSmemIn + kSmemW + kSmemPool) * sizeof(float);

static_assert(kConvCols <= 32, "one lane per conv column");
static_assert(kThreads == 32 * (kC / kCg), "one warp per channel group");
static_assert(kSmemW % 4 == 0 && kSmemIn % 4 == 0, "float4 weight reads");

// kern (7, 7, 3, 64) float32 at strides ks, scale and bias (64,) float32.
__global__ void __launch_bounds__(kThreads, 2)
stem_conv_pool_f32(const float* __restrict__ x, UbtStemStrides st, const float* __restrict__ kern,
                   UbtStemStrides ks, const float* __restrict__ scale, const float* __restrict__ bias,
                   int /* B: blockIdx.z */, int H, int W, int Ho, int Wo, int Hp, int Wp, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);
  float* s_in = s_w + kSmemW;
  float* s_pool = s_in + kSmemIn;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int group = tid >> 5;
  const int q0 = blockIdx.x * kTQ;
  const int p0 = blockIdx.y * kTP;
  const int b = blockIdx.z;

  // folded weights (7, 7, 3, 64): kernel * scale in float32
  for (int i = tid; i < kSmemW; i += kThreads) {
    const int n = i % kC, tap = i / kC;
    const int ky = tap / (kK * kCin), kx = (tap / kCin) % kK, ci = tap % kCin;
    s_w[i] = __fmul_rn(__ldg(kern + ky * ks.b + kx * ks.h + ci * ks.w + n * ks.c), __ldg(scale + n));
  }

  // the input window: rows 4 p0 - 5 .., columns 4 q0 - 5 .., zero outside
  stage_window<kInRows, kInCols>(x, st, b, H, W, 4 * p0 - 5, 4 * q0 - 5,
                                        [&](int lr, int lc, int ci, float v) {
                                          s_in[ci * kInPlane + lr * kInRowStride + (lc & 1) * kHalf + (lc >> 1)] = v;
                                        });
  __syncthreads();

  // lane k: conv column 2 q0 - 1 + k; local conv row j: conv row 2 p0 - 1 + j
  const int k = lane;
  const int c0 = group * kCg;
  float acc[kConvRows][kCg];
#pragma unroll
  for (int j = 0; j < kConvRows; ++j)
#pragma unroll
    for (int c = 0; c < kCg; ++c) acc[j][c] = 0.0f;

  if (k < kConvCols) {
#pragma unroll 1
    for (int ky = 0; ky < kK; ++ky) {
#pragma unroll
      for (int kx = 0; kx < kK; ++kx) {
#pragma unroll
        for (int ci = 0; ci < kCin; ++ci) {
          // conv row j reads local input row 2 j + ky, column 2 k + kx
          const float* in = s_in + ci * kInPlane + ky * kInRowStride + (kx & 1) * kHalf + k + (kx >> 1);
          const float4* wp = reinterpret_cast<const float4*>(s_w + ((ky * kK + kx) * kCin + ci) * kC + c0);
          const float4 wa = wp[0];
          const float4 wb = wp[1];
#pragma unroll
          for (int j = 0; j < kConvRows; ++j) {
            const float v = in[j * 2 * kInRowStride];
            acc[j][0] = fmaf(v, wa.x, acc[j][0]);
            acc[j][1] = fmaf(v, wa.y, acc[j][1]);
            acc[j][2] = fmaf(v, wa.z, acc[j][2]);
            acc[j][3] = fmaf(v, wa.w, acc[j][3]);
            acc[j][4] = fmaf(v, wb.x, acc[j][4]);
            acc[j][5] = fmaf(v, wb.y, acc[j][5]);
            acc[j][6] = fmaf(v, wb.z, acc[j][6]);
            acc[j][7] = fmaf(v, wb.w, acc[j][7]);
          }
        }
      }
    }

    float bv[kCg];
#pragma unroll
    for (int c = 0; c < kCg; ++c) bv[c] = __ldg(bias + c0 + c);
    const int conv_c = 2 * q0 - 1 + k;
    const bool col_ok = conv_c >= 0 && conv_c < Wo;
#pragma unroll
    for (int j = 0; j < kConvRows; ++j) {
      const int conv_r = 2 * p0 - 1 + j;
      const bool ok = col_ok && conv_r >= 0 && conv_r < Ho;
#pragma unroll
      for (int c = 0; c < kCg; ++c) acc[j][c] = ok ? fmaxf(acc[j][c] + bv[c], 0.0f) : 0.0f;
    }
    // pooled row i covers local conv rows 2i, 2i + 1, 2i + 2
#pragma unroll
    for (int i = 0; i < kTP; ++i)
#pragma unroll
      for (int c = 0; c < kCg; ++c)
        s_pool[(i * kC + c0 + c) * kPoolStride + k] =
            fmaxf(fmaxf(acc[2 * i][c], acc[2 * i + 1][c]), acc[2 * i + 2][c]);
  }
  __syncthreads();

  // pooled column j covers local conv columns 2j, 2j + 1, 2j + 2
  for (int f = tid; f < kTP * kTQ * kC; f += kThreads) {
    const int c = f % kC;
    const int jq = (f / kC) % kTQ;
    const int i = f / (kC * kTQ);
    const int p = p0 + i;
    const int q = q0 + jq;
    if (p >= Hp || q >= Wp) continue;
    const float* line = s_pool + (i * kC + c) * kPoolStride + 2 * jq;
    out[((static_cast<size_t>(b) * Hp + p) * Wp + q) * kC + c] = fmaxf(fmaxf(line[0], line[1]), line[2]);
  }
}

}  // namespace direct

template <typename Kernel, typename OT>
int launch(Kernel kernel, size_t smem, dim3 grid, const float* x, UbtStemStrides st, const float* kern,
           UbtStemStrides ks, const float* scale, const float* bias, int B, int H, int W, OT* out,
           cudaStream_t stream) {
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const int Hp = (Ho - 1) / 2 + 1, Wp = (Wo - 1) / 2 + 1;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(x, st, kern, ks, scale, bias, B, H, W, Ho, Wo, Hp, Wp, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, H, W, 3) float32 at element strides xs; kern (7, 7, 3, 64) float32
// HWIO at element strides ks; scale and bias (64,) float32, contiguous;
// H, W >= 1. out (B, ceil(H/4), ceil(W/4), 64), contiguous, bfloat16 when
// `bf16` is nonzero, else float32. Returns the cudaError_t of the launch
// (0 on success); launches on `stream` and does not synchronise.
extern "C" int ubt_stem_conv_pool(int bf16, const float* x, UbtStemStrides xs, const float* kern, UbtStemStrides ks,
                                  const float* scale, const float* bias, int B, int H, int W, void* out,
                                  void* stream) {
  if (B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Hp = ((H - 1) / 2) / 2 + 1, Wp = ((W - 1) / 2) / 2 + 1;
  if (bf16) {
    // persistent: one block an SM, each walking the tiles of all B images
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tiles = static_cast<long long>((Wp + mma::kTQ - 1) / mma::kTQ) * ((Hp + mma::kTP - 1) / mma::kTP) * B;
    const dim3 grid(static_cast<unsigned>(tiles < sms ? tiles : sms));
    return launch(mma::stem_conv_pool_mma, mma::kSmemBytes, grid, x, xs, kern, ks, scale, bias, B, H, W,
                  static_cast<__nv_bfloat16*>(out), s);
  }
  const dim3 grid((Wp + direct::kTQ - 1) / direct::kTQ, (Hp + direct::kTP - 1) / direct::kTP, B);
  return launch(direct::stem_conv_pool_f32, direct::kSmemBytes, grid, x, xs, kern, ks, scale, bias, B, H, W,
                static_cast<float*>(out), s);
}
