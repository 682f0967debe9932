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
// Forward. What bounds it on the H100: it is a gather. At the main path's
// shapes (24 images x 512 rois x 256 channels x 7 x 7 outputs = 154 M
// outputs, each an average of 4 to 16 samples of 4 corners) it issues a few
// billion scattered 2- or 4-byte reads, which mostly hit L2 (p2 of 24 images
// is 0.8 GB in bf16, read about once from HBM). The design (a simple kernel,
// detectron2's layout): one thread per output element (roi, c, ph, pw), pw
// fastest, over NCHW features; a warp covers neighbouring bins of one
// channel of one roi, so its corner reads fall on a few rows of one feature
// plane. The output is written (N, C, P, P), contiguous per thread, and the
// wrapper returns it permuted to the JAX layout (N, P, P, C). Accumulation
// in float32, one rounding to the feature dtype (float32 or bfloat16).
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

constexpr int kThreads = 256;
constexpr float kAdaptiveMaxS = 8.0f;

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

unsigned int blocks_for(long long total) {
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
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
