// Fused ResNet stem: 7x7/s2 convolution (padding 3) with the FrozenBN scale
// folded into the weights, + bias, ReLU, and 3x3/s2 max-pool (padding 1).
//
// Replaces ubteacher_tpu/ops/pallas/stem_pallas.py:stem_conv_pool
// (_stem_kernel), which JAX runs under TPU.STEM_MODE="pallas". What it
// computes, in the order of the Pallas kernel: x (B, H, W, 3) float32 NHWC,
// rounded to the compute dtype; weights k = kernel * scale folded in float32
// and rounded to the compute dtype by the wrapper (_fold_weights); the conv
// sum accumulated in float32; the sum rounded to the output dtype, the bias
// (rounded to that dtype) added in it, ReLU; the max-pool. Output
// (B, ceil(H/4), ceil(W/4), 64) NHWC, float32 or bfloat16. Pool taps that
// fall outside the conv output are skipped, not taken as the conv of zero
// padding (that value is ReLU(bias), not 0): every window holds its centre
// tap, and all values are >= 0 after the ReLU, so a skipped tap is a 0.
//
// What bounds it on the H100: at the eval shape (8, 800, 1344, 3) the conv
// is 8 x 400 x 672 x 64 outputs x 147 multiply-adds = 40.5 GFLOP, against
// 103 MB of float32 image read and 69 MB of bfloat16 output written. On the
// tensor cores (bf16, 989 TFLOP/s) that is 0.04 ms of arithmetic against
// 0.05 ms of memory traffic; on the CUDA cores (float32 FMA, 67 TFLOP/s) the
// arithmetic alone is 0.6 ms. This first kernel runs on the CUDA cores, so
// the float32 multiply-adds bound it; tensor cores (wgmma over im2col tiles
// fed by TMA) are a later kernel's work.
//
// What the design does about it. The Pallas kernel's mod-4 phase split and
// 84-wide H-im2col exist because Mosaic has no strided lane gather, and its
// shape limits come from the TPU's (8, 128) tiling; neither is carried over,
// and this kernel takes every H and W. One block of 256 threads computes a
// tile of 4 pooled rows x 15 pooled columns x 64 channels of one image:
//   * the 23 x 67 x 3 input pixels the tile needs (zero outside the image)
//     are staged in shared memory, each channel plane split into even and
//     odd columns so that the stride-2 reads of neighbouring conv columns
//     land on neighbouring words; the 7 x 7 x 3 x 64 folded weights
//     (37.6 KB) sit beside them;
//   * lane k of warp g computes conv column k (31 of the 32 lanes work) for
//     the 9 conv rows the tile pools over and the 8 channels 8g..8g+7: 72
//     float32 accumulators per thread, 9 input and two 16-byte (broadcast)
//     weight reads per 72 FMAs;
//   * bias, rounding and ReLU run on the registers, conv rows or columns
//     outside the conv output become 0, and the 3-row max is taken in
//     registers; the row-pooled values go to shared memory, column-major
//     with a padded stride so neither the writes nor the reads conflict;
//   * the 3-column max is taken from shared memory and the 4 x 15 x 64
//     outputs are written channel-fastest, so a warp writes contiguous runs.
// Only the pooled output reaches device memory, as in the Pallas kernel.
// The tile recomputes one conv row and column shared with its neighbours
// (9 rows for 8, 31 columns for 30).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libubt_stem.so stem.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kC = 64;                           // output channels
constexpr int kCin = 3;                          // input channels
constexpr int kK = 7;                            // conv kernel size
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
constexpr int kThreads = 32 * (kC / kCg);        // one warp per channel group
constexpr int kPoolStride = 33;                  // conv columns per row-pooled line, padded
constexpr int kTaps = kK * kK * kCin;

constexpr int kSmemIn = kCin * kInPlane;
constexpr int kSmemW = kTaps * kC;
constexpr int kSmemPool = kTP * kC * kPoolStride;
constexpr size_t kSmemBytes = (kSmemIn + kSmemW + kSmemPool) * sizeof(float);

static_assert(kConvCols <= 32, "one lane per conv column");
static_assert(kSmemW % 4 == 0 && kSmemIn % 4 == 0, "float4 weight staging");

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

template <bool kBf16>
__device__ __forceinline__ float epilogue(float acc, float bias) {
  if (kBf16) return fmaxf(round_bf16(round_bf16(acc) + bias), 0.0f);
  return fmaxf(acc + bias, 0.0f);
}

template <bool kBf16>
__device__ __forceinline__ void store(float* out, size_t i, float v) { out[i] = v; }
template <>
__device__ __forceinline__ void store<true>(float* out, size_t i, float v) {
  reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
stem_conv_pool(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
               int H, int W, int Ho, int Wo, int Hp, int Wp, float* __restrict__ out) {
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

  // folded weights (7, 7, 3, 64), already rounded to the compute dtype
  for (int i = tid; i < kSmemW / 4; i += kThreads) smem4[i] = reinterpret_cast<const float4*>(w)[i];

  // the input window: rows 4 p0 - 5 .., columns 4 q0 - 5 .., zero outside
  const int r_base = 4 * p0 - 5;
  const int u_base = 4 * q0 - 5;
  const float* xb = x + static_cast<size_t>(b) * H * W * kCin;
  for (int i = tid; i < kInRows * kInCols * kCin; i += kThreads) {
    const int lr = i / (kInCols * kCin);
    const int rem = i - lr * (kInCols * kCin);
    const int lc = rem / kCin;
    const int ci = rem - lc * kCin;
    const int gr = r_base + lr;
    const int gc = u_base + lc;
    float v = 0.0f;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
      v = __ldg(xb + (static_cast<size_t>(gr) * W + gc) * kCin + ci);
      if (kBf16) v = round_bf16(v);
    }
    s_in[ci * kInPlane + lr * kInRowStride + (lc & 1) * kHalf + (lc >> 1)] = v;
  }
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
      for (int c = 0; c < kCg; ++c) acc[j][c] = ok ? epilogue<kBf16>(acc[j][c], bv[c]) : 0.0f;
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
    const float m = fmaxf(fmaxf(line[0], line[1]), line[2]);
    store<kBf16>(out, ((static_cast<size_t>(b) * Hp + p) * Wp + q) * kC + c, m);
  }
}

template <bool kBf16>
int launch(const float* x, const float* w, const float* bias, int B, int H, int W, void* out,
           cudaStream_t stream) {
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const int Hp = (Ho - 1) / 2 + 1, Wp = (Wo - 1) / 2 + 1;
  cudaError_t err = cudaFuncSetAttribute(stem_conv_pool<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Wp + kTQ - 1) / kTQ, (Hp + kTP - 1) / kTP, B);
  stem_conv_pool<kBf16><<<grid, kThreads, kSmemBytes, stream>>>(x, w, bias, H, W, Ho, Wo, Hp, Wp,
                                                                 static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, H, W, 3) f32; w (7, 7, 3, 64) f32 folded and rounded to the compute
// dtype; bias (64,) f32 rounded to it; out (B, Hp, Wp, 64) bfloat16 when
// `bf16` is nonzero, else float32. H, W >= 1. Returns the cudaError_t of the
// launch (0 on success); launches on `stream` and does not synchronise.
extern "C" int ubt_stem_conv_pool(int bf16, const float* x, const float* w, const float* bias, int B, int H,
                                  int W, void* out, void* stream) {
  if (B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<true>(x, w, bias, B, H, W, out, s) : launch<false>(x, w, bias, B, H, W, out, s);
}
