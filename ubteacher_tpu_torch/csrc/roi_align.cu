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
// Forward. What bounds it on the H100: the bytes are the feature pixels the
// rois read (about 1.4 M pixels x 256 channels at the main path's shapes,
// 24 images x 512 rois, 0.73 GB in bf16) and the pooled output (0.31 GB):
// 0.31 ms at 3.35 TB/s; the multiply-adds are a few 1e9, far under that on
// the CUDA cores. An earlier kernel, a thread for each pooled value with pw
// fastest, ran at 20x that bound: every output rebuilt its roi's axes and
// taps with a dozen divisions, a warp's corner reads were scalar gathers
// from scattered sectors of one plane, it was bound by load instructions,
// and its (N, C, P, P) output cost a second pass to reach the box head's
// (N, P * P * C) layout. The TPU kernel copied a window of the level into
// VMEM and contracted it with separable bin weights on the MXU.
//
// What the design does about it:
//   * One block per (roi, group of kFwdGroup channels). The roi's taps along
//     both axes (one thread per sample and axis, make_axis / sample_tap, as
//     the backward builds them) and its separable bin weights within its
//     footprint (Ay: P x fh, Ax: P x fw, bin_weight x 1 / s) are computed
//     once into shared memory; the footprint is the pixel rectangle the
//     first and last taps bound (positions are monotone along each axis).
//   * The footprint of kFwdChunk channels is staged in shared memory strip
//     by strip with cp.async (8-byte pieces where the level's rows are
//     aligned to them; a warp copies whole rows of the NCHW planes, several
//     rows a warp where they are short, with no division per row), two
//     strip buffers deep, so the next strip or channel chunk is in flight
//     while the current one is contracted.
//   * The contraction is tap-free: out[ph, pw, c] = sum_y Ay[ph, y] sum_x
//     Ax[pw, x] F[c, y, x] over the bin's own rows and columns, float32
//     accumulation in registers. A lane owns two channels (lane, lane + 32)
//     and a warp a set of bins, so a feature read is one conflict-free
//     shared load per lane (the channel stride is an odd number of words)
//     and a weight read is a broadcast shared by both channels.
//   * The output is written contiguous in the JAX layout (N, P, P, C), in
//     the feature dtype, rounded once: through shared memory as 16-byte
//     stores where C is a multiple of the chunk, else one element a lane
//     (still coalesced). The box head's reshape is then a view.
//   * A roi whose footprint exceeds the staging budget (a side over
//     kMaxFoot pixels, or a row wider than a strip) is pooled by the same
//     block straight from the global planes, tap by tap, exactly.
//   * P = 7 with the adaptive grid is a compile-time instance; other P in
//     [1, kMaxPooled] and sampling_ratio > 0 take the general instance.
// A roi whose level lies outside [0, count) (a non-finite box) gets NaN and
// reads nothing.
//
// Backward. The gradient of level l is
//   dF[b, c, y, x] = sum over the rois n of image b on level l of
//                    sum_ph Ay_n[ph, y] * sum_pw Ax_n[pw, x] * G[n, ph, pw, c],
// with Ay, Ax the bin-averaged bilinear axis weights (the rows of
// ops/roi_align.py:bin_axis_weights, 1/s folded in). Boxes get no gradient:
// the proposals are detached. What bounds it on the H100: the bytes are the
// pooled gradient in (0.3 GB at the main path's shapes, bf16) and every
// level's gradient out, zeros included (1.06 GB): 0.41 ms at 3.35 TB/s. The
// multiply-adds over the rois' footprints are about 1e10 in float32, well
// under that on the CUDA cores. What the kernel actually spends its time on
// is instruction throughput and latency: per (roi, tile) it builds the tile's
// weights and walks the bins. The first design scattered every tap with a
// float32 atomic add (5.1e9 atomics, 47.5 ms, plus a zero fill, a cast and
// a permute of the gradient around it); it was bound by the L2 atomic units
// and not reproducible from run to run. The TPU kernel sorted the rois by
// (image, level, tile) and did one read-modify-write of each tile per roi,
// the transpose as a matmul.
//
// What the design does about it: every output tile is owned by one block,
// which writes it once, in the feature dtype; no atomics, no zero fill.
//   * The wrapper groups the rois by (image, level) with a stable sort
//     (segment s = image * count + level is order[seg[s] : seg[s + 1]]) and
//     gives each roi its footprint on its level: the pixel rectangle its
//     clipped samples' corners touch, widened by one pixel (plain torch on
//     the device, no host sync; ops/kernels/roi_align_cuda.py).
//   * One block per (image, level, 16 x 32 pixel tile, 32 channels). Its
//     threads compact, in order, the rois of the segment whose footprint
//     meets the tile, with their boxes, and take them kBatch at a time,
//     three barriers per batch:
//     (a) the rois' G[n, :, :, chunk] is copied with cp.async from the
//     channel-contiguous (N, P, P, C) gradient into shared memory while the
//     threads compute every sample's taps (one thread per sample and axis),
//     then the tile's axis weights (Ay: P x 16, Ax: P x 32, a thread per
//     entry, summing its bin's taps in order) and, by ballot, a bit mask per
//     bin of the tile rows / columns it touches;
//     (b) per roi, acc[y, x, c] += sum_ph Ay[ph, y] sum_pw Ax[pw, x]
//     G[ph, pw, c] in float32 registers: a warp owns 4 tile columns, a lane
//     one channel, a thread all 16 rows of its 4 columns. A warp skips a roi
//     whose bins miss its columns and walks only the set bits of the masks,
//     4 rows at a time.
//   * The tile is transposed through shared memory (a stride one word past
//     a multiple of 32 words, free of bank conflicts) and stored once, zeros
//     included, as rows of 32 consecutive pixels (NCHW, the layout of
//     feats[l]) with streaming stores. The sum over rois runs in a fixed
//     order, so the result is bitwise the same from run to run.
//   * The main path's P = 7 and adaptive grid (at most 8 samples) are
//     compile-time constants of one instance of the kernel, so its loops
//     unroll; other shapes take the general instance.
// A roi whose level lies outside [0, count) (a non-finite box) is grouped
// after every segment and gets no gradient.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libubt_roi_align.so roi_align.cu

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

constexpr int kMaxLevels = 4;

// Per-level planes (B, C, H, W): the features (forward) or the gradient
// written, in the feature dtype (backward). Outside the anonymous
// namespace: the extern "C" entry points take it, and a type with internal
// linkage would keep them from being exported.
struct Levels {
  void* data[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];  // 1 / stride of the level
  int count;                // levels in use
};

namespace {

constexpr float kAdaptiveMaxS = 8.0f;

// forward: a block pools one roi for kFwdGroup channels, kFwdChunk at a time
constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kFwdChunk = 64;   // channels staged together: two per lane
constexpr int kFwdGroup = 256;  // channels per block
constexpr int kFwdStageBytes = 32768;  // one strip buffer; there are two
constexpr int kMaxFoot = 128;   // footprint side (pixels) the staged path takes

// backward tiling: a block owns kTileY x kTileX pixels of kChunk channels
constexpr int kWarps = 8;
constexpr int kBwdThreads = kWarps * 32;
constexpr int kMinBlocks = 2;  // resident blocks per SM the registers are budgeted for
constexpr int kColsPerWarp = 4;
static_assert(kColsPerWarp == 4, "phase (b) reads a warp's columns of Ax as one float4");
constexpr int kTileY = 16;
constexpr int kTileX = kWarps * kColsPerWarp;
static_assert(kTileX == 32, "a tile is one warp of columns wide: the column masks are 32-bit ballots");
constexpr int kChunk = 32;  // channels per block, one per lane
constexpr int kBatch = 8;  // rois staged together: three barriers per batch
constexpr int kMaxPooled = 16;
constexpr int kMainPooled = 7;  // the box head's pooler resolution

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

// Weight of pixel h in one bin along one axis, from the bin's n taps: the
// bilinear weights of the samples that land on h, summed (the 1 / s of
// bin_axis_weights is applied by the caller). A sample clipped onto the last
// pixel puts both its weights there.
__device__ __forceinline__ float bin_weight(const Tap* taps, int n, int h) {
  if (h < taps[0].lo || h > taps[n - 1].hi) return 0.0f;  // the taps run in order along the axis
  float w = 0.0f;
  for (int i = 0; i < n; ++i) {
    const Tap t = taps[i];
    if (t.lo == h) w += t.w_lo;
    if (t.hi == h) w += t.w_hi;
  }
  return w;
}

// Bytes of the forward's dynamic shared memory before the strip buffers:
// the taps of both axes and the bin weights Ay, Ax (P x kMaxFoot floats each).
__host__ __device__ constexpr int fwd_taps_bytes(int P, int max_s) {
  return (2 * P * max_s * static_cast<int>(sizeof(Tap)) + 15) / 16 * 16;
}
__host__ __device__ constexpr int fwd_head_bytes(int P, int max_s) {
  return fwd_taps_bytes(P, max_s) + 2 * P * kMaxFoot * static_cast<int>(sizeof(float));
}

// features per level (B, C, H, W) of T; boxes (N, 4) f32 xyxy image pixels;
// level (N,) i32 0-based; out (N, P, P, C) of T. max_s the most samples per
// bin along an axis; vec_out: C is a multiple of kFwdChunk and out 16-byte
// aligned, so a chunk's outputs go out as 16-byte pieces. kMainPath: P ==
// kMainPooled and max_s == 8, known to the compiler.
template <typename T, bool kMainPath>
__global__ void __launch_bounds__(kFwdThreads)
roi_align_forward(const Levels feats, const float4* __restrict__ boxes, const int* __restrict__ level,
                  int rois_per_image, int C, int pooled, int sampling_ratio, int max_samples, bool vec_out,
                  T* __restrict__ out) {
  const int P = kMainPath ? kMainPooled : pooled;
  const int max_s = kMainPath ? static_cast<int>(kAdaptiveMaxS) : max_samples;
  const int PP = P * P;
  // output bins per warp: bin q = warp + kFwdWarps * j
  constexpr int kBins = ((kMainPath ? kMainPooled * kMainPooled : kMaxPooled * kMaxPooled) + kFwdWarps - 1) / kFwdWarps;
  constexpr int kStageElems = kFwdStageBytes / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  Tap* const taps = reinterpret_cast<Tap*>(smem);  // [axis][p][i]
  float* const Ay = reinterpret_cast<float*>(smem + fwd_taps_bytes(P, max_s));  // [ph][y - fy_lo]
  float* const Ax = Ay + P * kMaxFoot;                                            // [pw][x - fx_lo]
  T* const stage = reinterpret_cast<T*>(smem + fwd_head_bytes(P, max_s));       // two strip buffers
  __shared__ int range[4][kMaxPooled];  // per bin: first and last row, first and last column its taps touch
  __shared__ Axis axes[2];

  const long long n = blockIdx.x;
  const int c_begin = blockIdx.y * kFwdGroup;
  const int group = min(kFwdGroup, C - c_begin);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int l = level[n];
  if (l < 0 || l >= feats.count) {  // a non-finite box: NaN out, no stray read
    for (int e = threadIdx.x; e < PP * group; e += kFwdThreads) {
      out[(n * PP + e / group) * C + c_begin + e % group] = from_float<T>(NAN);
    }
    return;
  }
  const int H = feats.height[l];
  const int W = feats.width[l];
  const int b = static_cast<int>(n / rois_per_image);
  const T* const plane0 = static_cast<const T*>(feats.data[l]) + static_cast<size_t>(b) * C * H * W;

  // every sample's taps along both axes: item u is the tap [axis][p][i]
  // (slots past an adaptive grid stay unused)
  {
    const float4 box = boxes[n];
    for (int u = threadIdx.x; u < 2 * P * max_s; u += kFwdThreads) {
      const int axis = u / (P * max_s), p = u % (P * max_s) / max_s, i = u % max_s;
      const Axis a = axis == 0 ? make_axis(box.y, box.w, feats.scale[l], P, sampling_ratio)
                               : make_axis(box.x, box.z, feats.scale[l], P, sampling_ratio);
      if (p == 0 && i == 0) axes[axis] = a;
      if (i < a.n) taps[u] = sample_tap(a, p, i, axis == 0 ? H : W);
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * P) {
    const int axis = threadIdx.x / P, p = threadIdx.x % P;
    const Tap* const t = taps + (axis * P + p) * max_s;
    range[2 * axis][p] = t[0].lo;
    range[2 * axis + 1][p] = t[axes[axis].n - 1].hi;
  }
  __syncthreads();
  const int fy_lo = range[0][0], fy_hi = range[1][P - 1];
  const int fx_lo = range[2][0], fx_hi = range[3][P - 1];
  const int fh = fy_hi - fy_lo + 1, fw = fx_hi - fx_lo + 1;
  const int ny = axes[0].n, nx = axes[1].n;
  const float inv_sy = __fdiv_rn(1.0f, axes[0].s), inv_sx = __fdiv_rn(1.0f, axes[1].s);

  // staging geometry: rows move in 8-byte cp.async pieces where the level's
  // rows stay 8-byte aligned, else in 4-byte pieces, else (bf16 rows of an
  // odd width) element by element. 16-byte pieces measured slower: their
  // channel stride is a multiple of 4 words, so the contraction's loads
  // meet 4-way bank conflicts (8-byte pieces: 2-way).
  auto aligned = [&](int bytes) {
    return (W * static_cast<int>(sizeof(T))) % bytes == 0 && reinterpret_cast<uintptr_t>(plane0) % bytes == 0;
  };
  const int piece = aligned(8) ? 8 : aligned(4) ? 4 : static_cast<int>(sizeof(T));
  const int E = piece / static_cast<int>(sizeof(T));                  // elements per piece
  const int x_al = fx_lo / E * E;                                      // first staged column
  const int pitch = ((fx_hi - x_al) / E + 1) * E;                      // staged row, elements
  constexpr int kSlack = 16 / static_cast<int>(sizeof(T));            // room to pad the channel stride
  const int rows = min(fh, (kStageElems / kFwdChunk - kSlack) / pitch);  // rows per strip
  const bool staged = fh <= kMaxFoot && fw <= kMaxFoot && rows >= 1;

  float acc0[kBins], acc1[kBins];  // channels lane and lane + 32 of this warp's bins

  // one chunk's outputs: through shared memory as 16-byte pieces, or a lane
  // at a time
  auto store = [&](int c0, T* st) {
    if (vec_out && PP * kFwdChunk * static_cast<int>(sizeof(T)) <= kFwdStageBytes) {
#pragma unroll
      for (int j = 0; j < kBins; ++j) {
        const int q = warp + kFwdWarps * j;
        if (q < PP) {
          st[q * kFwdChunk + lane] = from_float<T>(acc0[j]);
          st[q * kFwdChunk + lane + 32] = from_float<T>(acc1[j]);
        }
      }
      __syncthreads();
      constexpr int kVec = 16 / static_cast<int>(sizeof(T));
      constexpr int kPieces = kFwdChunk / kVec;  // per bin
      for (int e = threadIdx.x; e < PP * kPieces; e += kFwdThreads) {
        const int q = e / kPieces, k = e % kPieces;
        *reinterpret_cast<uint4*>(out + (n * PP + q) * C + c0 + k * kVec) =
            *reinterpret_cast<const uint4*>(st + q * kFwdChunk + k * kVec);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kBins; ++j) {
        const int q = warp + kFwdWarps * j;
        if (q < PP) {
          T* const o = out + (n * PP + q) * C + c0;
          if (c0 + lane < C) o[lane] = from_float<T>(acc0[j]);
          if (c0 + lane + 32 < C) o[lane + 32] = from_float<T>(acc1[j]);
        }
      }
    }
  };

  const int chunks = (group + kFwdChunk - 1) / kFwdChunk;
  if (!staged) {
    // a footprint past the staging budget: tap by tap from the planes
    for (int ch = 0; ch < chunks; ++ch) {
      const int c0 = c_begin + ch * kFwdChunk;
#pragma unroll
      for (int j = 0; j < kBins; ++j) {
        acc0[j] = acc1[j] = 0.0f;
        const int q = warp + kFwdWarps * j;
        if (q >= PP) continue;
        const Tap* const ty = taps + (q / P) * max_s;
        const Tap* const tx = taps + (P + q % P) * max_s;
        for (int k = 0; k < 2; ++k) {
          const int c = c0 + lane + 32 * k;
          if (c >= C) continue;
          const T* const f = plane0 + static_cast<size_t>(c) * H * W;
          float a = 0.0f;
          for (int iy = 0; iy < ny; ++iy) {
            const T* const r_lo = f + static_cast<size_t>(ty[iy].lo) * W;
            const T* const r_hi = f + static_cast<size_t>(ty[iy].hi) * W;
            for (int ix = 0; ix < nx; ++ix) {
              const Tap t = tx[ix];
              a += ty[iy].w_lo * (t.w_lo * to_float(r_lo[t.lo]) + t.w_hi * to_float(r_lo[t.hi])) +
                   ty[iy].w_hi * (t.w_lo * to_float(r_hi[t.lo]) + t.w_hi * to_float(r_hi[t.hi]));
            }
          }
          if (k) {
            acc1[j] = a * __fmul_rn(inv_sy, inv_sx);
          } else {
            acc0[j] = a * __fmul_rn(inv_sy, inv_sx);
          }
        }
      }
      __syncthreads();  // the store's staging area is the first strip buffer
      store(c0, stage);
      __syncthreads();
    }
    return;
  }

  // the separable bin weights within the footprint
  for (int e = threadIdx.x; e < P * (fh + fw); e += kFwdThreads) {
    if (e < P * fh) {
      const int p = e / fh, y = e % fh;
      Ay[p * kMaxFoot + y] = bin_weight(taps + p * max_s, ny, fy_lo + y) * inv_sy;
    } else {
      const int p = (e - P * fh) / fw, x = (e - P * fh) % fw;
      Ax[p * kMaxFoot + x] = bin_weight(taps + (P + p) * max_s, nx, fx_lo + x) * inv_sx;
    }
  }

  // channel stride in the strip buffer: an odd number of pieces of at least
  // a word, so that the 32 lanes (32 channels) of a shared load spread over
  // as many banks as the piece alignment allows (all 32 for 4-byte pieces)
  const int unit = max(E, 4 / static_cast<int>(sizeof(T)));  // elements
  int stride = (rows * pitch + unit - 1) / unit;
  stride = (stride | 1) * unit;
  const int strips = (fh + rows - 1) / rows;
  const int tiles = chunks * strips;
  // copy strip `tile` (chunk tile / strips, rows of strip tile % strips)
  // into buffer tile % 2, in the background
  auto issue = [&](int tile) {
    const int c0 = c_begin + (tile / strips) * kFwdChunk;
    const int ys = fy_lo + (tile % strips) * rows;
    const int nr = min(rows, fy_hi + 1 - ys);
    T* const dst = stage + (tile & 1) * kStageElems;
    const T* const src = plane0 + static_cast<size_t>(c0) * H * W + static_cast<size_t>(ys) * W + x_al;
    const int units = pitch / E;  // pieces per staged row
    const int lanes = units <= 8 ? 8 : units <= 16 ? 16 : 32;  // lanes per staged row
    const int per_warp = 32 / lanes;
    // warp w copies channels w, w + kFwdWarps, ..., per_warp rows at a time
    for (int cc = warp; cc < min(kFwdChunk, C - c0); cc += kFwdWarps) {
      const T* s = src + static_cast<size_t>(cc) * H * W + static_cast<size_t>(lane / lanes) * W;
      T* d = dst + cc * stride + (lane / lanes) * pitch;
      for (int r = lane / lanes; r < nr; r += per_warp, s += per_warp * W, d += per_warp * pitch) {
        for (int x = lane % lanes; x < units; x += lanes) {
          if (piece == 8) {
            __pipeline_memcpy_async(d + x * E, s + x * E, 8);
          } else if (piece == 4) {
            __pipeline_memcpy_async(d + x * E, s + x * E, 4);
          } else {
            d[x] = s[x];
          }
        }
      }
    }
    __pipeline_commit();
  };

  issue(0);
  for (int tile = 0; tile < tiles; ++tile) {
    if (tile + 1 < tiles) {
      issue(tile + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // the strip (and, on the first tile, the weights) is in shared memory
    const int strip = tile % strips;
    const int ys = fy_lo + strip * rows;
    const int ye = min(ys + rows, fy_hi + 1);
    const T* const buf = stage + (tile & 1) * kStageElems;
#pragma unroll
    for (int j = 0; j < kBins; ++j) {
      if (strip == 0) acc0[j] = acc1[j] = 0.0f;
      const int q = warp + kFwdWarps * j;
      if (q >= PP) continue;
      const int ph = q / P, pw = q % P;
      const int y0 = max(range[0][ph], ys), y1 = min(range[1][ph], ye - 1);
      const int xa = range[2][pw], xn = range[3][pw] - xa + 1;
      const float* const ax = Ax + pw * kMaxFoot + (xa - fx_lo);
      const float* wy = Ay + ph * kMaxFoot + (y0 - fy_lo);
      const T* f = buf + lane * stride + (y0 - ys) * pitch + (xa - x_al);
      float a0 = acc0[j], a1 = acc1[j];
      for (int y = y0; y <= y1; ++y, ++wy, f += pitch) {
        float s0 = 0.0f, s1 = 0.0f;
        for (int x = 0; x < xn; ++x) {
          const float w = ax[x];
          s0 += w * to_float(f[x]);
          s1 += w * to_float(f[x + 32 * stride]);
        }
        a0 += *wy * s0;
        a1 += *wy * s1;
      }
      acc0[j] = a0;
      acc1[j] = a1;
    }
    if (strip == strips - 1) {
      __syncthreads();  // every warp is done with this buffer: the store stages through it
      store(c_begin + (tile / strips) * kFwdChunk, stage + (tile & 1) * kStageElems);
    }
    __syncthreads();  // the next iteration's copies overwrite this buffer
  }
}

__host__ __device__ __forceinline__ int tiles_of(int H, int W) {
  return ((H + kTileY - 1) / kTileY) * ((W + kTileX - 1) / kTileX);
}

// Bytes of the work area of one batch of rois: per roi the taps of both
// axes (2 * P * max_s), G (P * P * kChunk of T), Ay (P * kTileY floats) and
// Ax (P * kTileX floats), each array 16-byte aligned.
__host__ __device__ constexpr int roi_taps_bytes(int P, int max_s) { return 2 * P * max_s * static_cast<int>(sizeof(Tap)); }
template <typename T>
__host__ __device__ constexpr int roi_g_bytes(int P) { return (P * P * kChunk * static_cast<int>(sizeof(T)) + 15) / 16 * 16; }
template <typename T>
__host__ __device__ constexpr int roi_work_bytes(int P, int max_s) {
  return roi_taps_bytes(P, max_s) + roi_g_bytes<T>(P) + 4 * P * (kTileY + kTileX);
}

// Staging stride per channel, in elements: one 32-bit word past a multiple
// of 32 words, so that the transposing stores (lanes one channel apart) fall
// in 32 different banks.
template <typename T>
__host__ __device__ constexpr int stage_stride() {
  return kTileY * kTileX + 4 / static_cast<int>(sizeof(T));
}

// grads: the per-level gradient planes (B, C, H, W) of T, every element
// written here; boxes (N, 4) f32; order (N,) i64 roi indices grouped by
// (image, level); seg (B * count + 1,) segment starts into order; foot
// (N, 4) i32 [y_lo, y_hi, x_lo, x_hi] of the roi at each position of order;
// grad_out (N, P, P, C) of T; max_s the most samples per bin along an axis;
// vec: C is a multiple of kChunk and of 16 bytes, so G rows are copied in
// 16-byte pieces. kMainPath: P == kMainPooled and max_s == 8, known to the
// compiler.
template <typename T, bool kMainPath>
__global__ void __launch_bounds__(kBwdThreads, kMinBlocks)
roi_align_backward(const Levels grads, const float4* __restrict__ boxes, const long long* __restrict__ order,
                   const int* __restrict__ seg, const int4* __restrict__ foot, int C, int pooled,
                   int sampling_ratio, int max_samples, bool vec, const T* __restrict__ grad_out) {
  // the main path's P = 7 and adaptive grid (at most 8 samples) as constants
  const int P = kMainPath ? kMainPooled : pooled;
  const int max_s = kMainPath ? static_cast<int>(kAdaptiveMaxS) : max_samples;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int hit_roi[kBwdThreads];
  __shared__ float4 hit_box[kBwdThreads];
  __shared__ int warp_hits[kWarps];
  __shared__ unsigned mask_y[kBatch][kMaxPooled];  // per roi and bin ph: tile rows with a nonzero weight
  __shared__ unsigned mask_x[kBatch][kMaxPooled];  // per roi and bin pw: tile columns
  __shared__ Axis axes[kBatch][2];                 // per roi: y, x
  __shared__ float inv_s[kBatch][2];               // 1 / s of each

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunks = (C + kChunk - 1) / kChunk;
  const int chunk = blockIdx.x % chunks;
  int tile = blockIdx.x / chunks;
  int per_image = 0;
  for (int k = 0; k < grads.count; ++k) per_image += tiles_of(grads.height[k], grads.width[k]);
  const int b = tile / per_image;
  tile -= b * per_image;
  int l = 0;
  while (tile >= tiles_of(grads.height[l], grads.width[l])) {
    tile -= tiles_of(grads.height[l], grads.width[l]);
    ++l;
  }
  const int H = grads.height[l];
  const int W = grads.width[l];
  const int tiles_x = (W + kTileX - 1) / kTileX;
  const int y0 = (tile / tiles_x) * kTileY;
  const int x0 = (tile % tiles_x) * kTileX;

  // the work area of roi r of a batch
  const int work = roi_work_bytes<T>(P, max_s);
  auto taps_of = [&](int r) { return reinterpret_cast<Tap*>(smem + r * work); };
  auto g_of = [&](int r) { return reinterpret_cast<T*>(smem + r * work + roi_taps_bytes(P, max_s)); };
  auto ay_of = [&](int r) {
    return reinterpret_cast<float*>(smem + r * work + roi_taps_bytes(P, max_s) + roi_g_bytes<T>(P));
  };
  const int gsize = P * P * kChunk;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte piece
  const int pieces = gsize / kVec;                          // of one roi's G
  const int ay_warps = (P * kTileY + 31) / 32;  // Ay's entries padded to whole warps
  const int entries = (ay_warps + P) * 32;      // then one warp per bin of Ax
  float acc[kColsPerWarp][kTileY] = {};

  const int s0 = seg[b * grads.count + l];
  const int s1 = seg[b * grads.count + l + 1];
  for (int base = s0; base < s1; base += kBwdThreads) {
    // the rois of this round whose footprint meets the tile, in order, with
    // their boxes
    const int i = base + threadIdx.x;
    bool hit = false;
    if (i < s1) {
      const int4 f = foot[i];
      hit = f.x < y0 + kTileY && f.y >= y0 && f.z < x0 + kTileX && f.w >= x0;
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(m);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_hits[w] : 0;
      total += warp_hits[w];
    }
    if (hit) {
      const int slot = before + __popc(m & ((1u << lane) - 1u));
      const int n = static_cast<int>(order[i]);
      hit_roi[slot] = n;
      hit_box[slot] = boxes[n];
    }
    __syncthreads();

    // the hits in batches of kBatch rois: three barriers per batch
    for (int h0 = 0; h0 < total; h0 += kBatch) {
      const int nb = min(kBatch, total - h0);
      // (a) each roi's pooled gradient for this chunk of channels, copied
      // to shared memory in the background while the weights are built
      if (vec) {
        for (int t = threadIdx.x; t < nb * pieces; t += kBwdThreads) {
          const int r = t / pieces, e = (t % pieces) * kVec;
          const T* src = grad_out + (static_cast<size_t>(hit_roi[h0 + r]) * P * P + e / kChunk) * C +
                         chunk * kChunk + e % kChunk;
          __pipeline_memcpy_async(g_of(r) + e, src, 16);
        }
        __pipeline_commit();
      } else {
        for (int t = threadIdx.x; t < nb * gsize; t += kBwdThreads) {
          const int r = t / gsize, e = t % gsize, cc = chunk * kChunk + e % kChunk;
          g_of(r)[e] = cc < C ? grad_out[(static_cast<size_t>(hit_roi[h0 + r]) * P * P + e / kChunk) * C + cc]
                              : from_float<T>(0.0f);
        }
      }
      // every sample's taps along both axes, once per roi: item u of roi r
      // is the tap [axis][p][i] (slots past an adaptive grid stay unused)
      const int items = 2 * P * max_s;
      for (int t = threadIdx.x; t < nb * items; t += kBwdThreads) {
        const int r = t / items, u = t % items;
        const int axis = u / (P * max_s), p = u % (P * max_s) / max_s, i = u % max_s;
        const float4 box = hit_box[h0 + r];
        const Axis a = axis == 0 ? make_axis(box.y, box.w, grads.scale[l], P, sampling_ratio)
                                 : make_axis(box.x, box.z, grads.scale[l], P, sampling_ratio);
        if (p == 0 && i == 0) {
          axes[r][axis] = a;
          inv_s[r][axis] = __fdiv_rn(1.0f, a.s);
        }
        if (i < a.n) taps_of(r)[u] = sample_tap(a, p, i, axis == 0 ? H : W);
      }
      __syncthreads();
      // the axis weights within the tile, and the masks of what they touch
      for (int v = threadIdx.x; v < nb * entries; v += kBwdThreads) {  // whole warps: the ballot is safe
        const int r = v / entries, e = v % entries;
        const Tap* const taps_y = taps_of(r);
        const Tap* const taps_x = taps_y + P * max_s;
        float* const Ay = ay_of(r);
        float* const Ax = Ay + P * kTileY;
        float w = 0.0f;
        int p;
        if (e < ay_warps * 32) {
          p = e / kTileY;
          if (p < P) {
            w = bin_weight(taps_y + p * max_s, axes[r][0].n, y0 + e % kTileY) * inv_s[r][0];
            Ay[e] = w;
          }
        } else {
          p = e / 32 - ay_warps;
          w = bin_weight(taps_x + p * max_s, axes[r][1].n, x0 + e % 32) * inv_s[r][1];
          Ax[p * kTileX + e % 32] = w;
        }
        const unsigned nz = __ballot_sync(0xffffffffu, w != 0.0f);
        if (e < ay_warps * 32) {
          if (lane % kTileY == 0 && p < P) mask_y[r][p] = (nz >> lane) & ((1u << kTileY) - 1u);
        } else if (lane == 0) {
          mask_x[r][p] = nz;
        }
      }
      if (vec) __pipeline_wait_prior(0);
      __syncthreads();

      // (b) per roi, this warp's columns x kTileY rows of the lane's channel
      for (int r = 0; r < nb; ++r) {
        const T* const G = g_of(r);
        const float* const Ay = ay_of(r);
        const float* const Ax = Ay + P * kTileY;
        unsigned bins_x = 0;  // bins pw that touch this warp's columns, and bins ph with a row in the tile
        unsigned bins_y = 0;
        for (int k = 0; k < P; ++k) {
          if ((mask_x[r][k] >> (kColsPerWarp * warp)) & ((1u << kColsPerWarp) - 1u)) bins_x |= 1u << k;
          if (mask_y[r][k]) bins_y |= 1u << k;
        }
        if (!bins_x) continue;
        for (unsigned ys = bins_y; ys; ys &= ys - 1) {
          const int ph = __ffs(ys) - 1;
          const unsigned rows = mask_y[r][ph];
          float t[kColsPerWarp] = {};
          for (unsigned xs = bins_x; xs; xs &= xs - 1) {
            const int pw = __ffs(xs) - 1;
            const float gv = to_float(G[(ph * P + pw) * kChunk + lane]);
            const float4 a = *reinterpret_cast<const float4*>(Ax + pw * kTileX + kColsPerWarp * warp);
            t[0] += a.x * gv;
            t[1] += a.y * gv;
            t[2] += a.z * gv;
            t[3] += a.w * gv;
          }
#pragma unroll
          for (int q = 0; q < kTileY / 4; ++q) {
            if (!((rows >> (4 * q)) & 0xfu)) continue;
            const float4 wy = *reinterpret_cast<const float4*>(Ay + ph * kTileY + 4 * q);
            const float wv[4] = {wy.x, wy.y, wy.z, wy.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
#pragma unroll
              for (int j = 0; j < kColsPerWarp; ++j) acc[j][4 * q + u] += wv[u] * t[j];
            }
          }
        }
      }
      __syncthreads();  // the next batch reuses the work area
    }
  }

  // store the tile once: transpose through shared memory, then rows of 32
  // consecutive pixels per warp, with streaming (evict-first) stores
  T* const stage = reinterpret_cast<T*>(smem);
  constexpr int stride = stage_stride<T>();
#pragma unroll
  for (int y = 0; y < kTileY; ++y) {
#pragma unroll
    for (int j = 0; j < kColsPerWarp; ++j) {
      stage[lane * stride + y * kTileX + kColsPerWarp * warp + j] = from_float<T>(acc[j][y]);
    }
  }
  __syncthreads();
  T* const out = static_cast<T*>(grads.data[l]);
  const int x = x0 + lane;
  for (int r = warp; r < kChunk * kTileY; r += kWarps) {
    const int cl = r / kTileY;
    const int cg = chunk * kChunk + cl;
    const int y = y0 + r % kTileY;
    if (cg < C && y < H && x < W) {
      __stcs(out + ((static_cast<size_t>(b) * C + cg) * H + y) * W + x, stage[cl * stride + (r % kTileY) * kTileX + lane]);
    }
  }
}

template <typename T>
int launch_backward(const Levels& grads, const float4* boxes, const long long* order, const int* seg,
                    const int4* foot, int batch, int C, int P, int sampling_ratio, const T* grad_out,
                    cudaStream_t s) {
  long long tiles = 0;
  for (int k = 0; k < grads.count; ++k) tiles += tiles_of(grads.height[k], grads.width[k]);
  const long long blocks = tiles * batch * ((C + kChunk - 1) / kChunk);
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int max_s = sampling_ratio > 0 ? sampling_ratio : static_cast<int>(kAdaptiveMaxS);
  const size_t work = static_cast<size_t>(kBatch) * roi_work_bytes<T>(P, max_s);
  const size_t stage = sizeof(T) * kChunk * stage_stride<T>();
  const size_t bytes = work > stage ? work : stage;
  const bool vec = C % kChunk == 0 && (C * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(grad_out) % 16 == 0;
  auto kernel = P == kMainPooled && max_s == static_cast<int>(kAdaptiveMaxS) ? roi_align_backward<T, true>
                                                                            : roi_align_backward<T, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned int>(blocks), kBwdThreads, bytes, s>>>(grads, boxes, order, seg, foot, C, P,
                                                                       sampling_ratio, max_s, vec, grad_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// is_bf16: 0 for float32 features, 1 for bfloat16. feats: per-level (B, C, H,
// W) planes; boxes (N, 4) f32; level (N,) i32 0-based; out (N, P, P, C),
// contiguous. Returns the cudaError_t of the launch (0 on success); launches
// on `stream` and does not synchronise.
extern "C" int ubt_roi_align_forward(int is_bf16, const Levels* feats, const float* boxes,
                                     const int* level, int num_rois, int rois_per_image,
                                     int channels, int pooled, int sampling_ratio, void* out,
                                     void* stream) {
  if (pooled < 1 || pooled > kMaxPooled || sampling_ratio < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rois == 0 || channels == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* b4 = reinterpret_cast<const float4*>(boxes);
  const int max_s = sampling_ratio > 0 ? sampling_ratio : static_cast<int>(kAdaptiveMaxS);
  const bool main_path = pooled == kMainPooled && max_s == static_cast<int>(kAdaptiveMaxS);
  const size_t bytes = static_cast<size_t>(fwd_head_bytes(pooled, max_s)) + 2 * kFwdStageBytes;
  const bool vec_out = channels % kFwdChunk == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(static_cast<unsigned int>(num_rois), (channels + kFwdGroup - 1) / kFwdGroup);
  auto launch = [&](auto kernel, auto* typed_out) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kFwdThreads, bytes, s>>>(*feats, b4, level, rois_per_image, channels, pooled, sampling_ratio,
                                             max_s, vec_out, typed_out);
    return static_cast<int>(cudaGetLastError());
  };
  if (is_bf16) {
    auto* o = static_cast<__nv_bfloat16*>(out);
    return main_path ? launch(roi_align_forward<__nv_bfloat16, true>, o)
                     : launch(roi_align_forward<__nv_bfloat16, false>, o);
  }
  auto* o = static_cast<float*>(out);
  return main_path ? launch(roi_align_forward<float, true>, o) : launch(roi_align_forward<float, false>, o);
}

// grads: per-level (B, C, H, W) planes in the feature dtype (is_bf16 as
// above), each element written by the kernel; order, seg, foot as the
// wrapper's group_rois and roi_footprints give them (foot in the order of
// `order`); grad_out (N, P, P, C), contiguous, in the feature dtype.
extern "C" int ubt_roi_align_backward(int is_bf16, const Levels* grads, const float* boxes,
                                      const long long* order, const int* seg, const int* foot, int batch,
                                      int channels, int pooled, int sampling_ratio,
                                      const void* grad_out, void* stream) {
  if (pooled < 1 || pooled > kMaxPooled) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* b4 = reinterpret_cast<const float4*>(boxes);
  const int4* f4 = reinterpret_cast<const int4*>(foot);
  if (is_bf16) {
    return launch_backward(*grads, b4, order, seg, f4, batch, channels, pooled, sampling_ratio,
                           static_cast<const __nv_bfloat16*>(grad_out), s);
  }
  return launch_backward(*grads, b4, order, seg, f4, batch, channels, pooled, sampling_ratio,
                         static_cast<const float*>(grad_out), s);
}
