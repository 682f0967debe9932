// Row scatter-add: the transpose of the batched row gather used by the RPN
// losses.
//
// Replaces ubteacher_tpu/ops/pallas/row_gather_pallas.py:scatter_rows_pallas
// (_scatter_rows_kernel), the backward of take_rows: out (B, L, D) float32
// receives g[b, k, :] added at row rows[b, k]; duplicate rows accumulate, and
// a row index outside [0, L) is dropped, as XLA's scatter drops it.
//
// What bounds it on the H100: almost nothing is computed. At the RPN's shapes
// the gradient rows are 24 x 320 x 3 and 24 x 320 x 12 floats (at most 370 KB
// in, 92 K adds), while the output is 24 x 85,932 x D floats (25 MB and
// 99 MB), almost all zeros. Writing the output once is the cost: 0.030 ms at
// 3.35 TB/s for D = 12; a plain fill of it takes 0.033 ms. The first design
// zero-filled the output with a separate pass and then added every element
// with an atomic: two launches, the output written twice, and sums of
// duplicates in no fixed order.
//
// What the design does about it: one launch, and each output byte written
// once. A block owns a run of kRun floats of one image's (L, D) grid, as a
// tile in shared memory. It reads the image's K row indices (kSlots per
// thread in one round, loads first), keeps in k order those whose row meets
// the run (a ballot and a prefix over the warps), loads the g rows of those
// hits into shared memory together, and lets one warp add them into the
// tile hit after hit, a lane per column. Duplicate rows (the anchors of one
// cell share a row) meet only on the same column, so each lane sums a run of
// hits on one row in a register:
// the sums run in k order, the same from run to run, and forty duplicates
// cost no chain of shared-memory round trips. Then the tile is stored once,
// zeros included, with 16-byte streaming (evict-first) stores, which keep
// the writes at the fill's rate. The Pallas kernel kept the whole per-image
// grid in VMEM to avoid a serial XLA scatter on the TPU; here the grid is
// cut into runs that blocks own.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libubt_row_scatter.so row_scatter.cu

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 4096;    // floats of a block's run: a 16 KB tile in shared memory
constexpr int kSlots = 2;     // row indices a thread reads per round: K <= 512 in one round
constexpr int kRound = kThreads * kSlots;
constexpr int kStage = 2048;  // g floats of the hits staged in shared memory at once

// g (B, K, D) f32; rows (B, K) i64; out (B, L, D) f32, every element written.
// Block (b, j) owns the run [j * kRun, (j + 1) * kRun) of image b's grid.
__global__ void __launch_bounds__(kThreads)
scatter_rows(const float* __restrict__ g, const long long* __restrict__ rows, int K, int L, int D,
             int per_image, bool aligned, float* __restrict__ out) {
  __shared__ float4 tile4[kRun / 4];
  __shared__ int hit_k[kRound];
  __shared__ int hit_first[kRound];  // the hit row's first float, from the start of the run
  __shared__ int warp_hits[kSlots][kWarps];
  __shared__ float hit_g[kStage];
  float* const tile = reinterpret_cast<float*>(tile4);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x / per_image;
  const long long e0 = static_cast<long long>(blockIdx.x % per_image) * kRun;
  const long long span = static_cast<long long>(L) * D;  // floats of one image
  const int n = static_cast<int>(min(static_cast<long long>(kRun), span - e0));
  const long long* rb = rows + static_cast<long long>(b) * K;
  const float* gb = g + static_cast<long long>(b) * K * D;

  for (int i = threadIdx.x; i < kRun / 4; i += kThreads) tile4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int base = 0; base < K; base += kRound) {
    // the k of this round whose row meets the run, in order: all loads
    // first, then a ballot and a prefix over (slot, warp)
    long long r[kSlots];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int k = base + q * kThreads + threadIdx.x;
      r[q] = k < K ? rb[k] : -1;
    }
    bool hit[kSlots];
    unsigned m[kSlots];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      hit[q] = r[q] >= 0 && r[q] < L && r[q] * D < e0 + n && (r[q] + 1) * D > e0;
      m[q] = __ballot_sync(0xffffffffu, hit[q]);
      if (lane == 0) warp_hits[q][warp] = __popc(m[q]);
    }
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      int before = total;
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? warp_hits[q][w] : 0;
        total += warp_hits[q][w];
      }
      if (hit[q]) {
        const int slot = before + __popc(m[q] & ((1u << lane) - 1u));
        hit_k[slot] = base + q * kThreads + threadIdx.x;
        hit_first[slot] = static_cast<int>(r[q] * D - e0);  // in (-D, kRun)
      }
    }
    __syncthreads();
    // the hits' g rows, loaded by all threads together (one load latency,
    // not one per hit); then one warp adds them into the tile, hit after
    // hit in k order, a lane per column, so duplicate rows sum in k order
    const int per_stage = D <= kStage ? kStage / D : 1;
    for (int h0 = 0; h0 < total; h0 += per_stage) {
      const int nh = min(per_stage, total - h0);
      if (D <= kStage) {
        for (int t = threadIdx.x; t < nh * D; t += kThreads) {
          hit_g[t] = gb[static_cast<long long>(hit_k[h0 + t / D]) * D + t % D];
        }
        __syncthreads();
      }
      if (warp == 0) {
        // a lane owns a column d of the hit rows; two hits meet on an
        // element only if they share a row, and then on the same column. A
        // run of hits on one row sums in a register, so the tile is read
        // and written once per run: duplicate rows cost no chain of
        // shared-memory round trips
        for (int d = lane; d < D; d += 32) {
          int cur = INT_MIN;
          float acc = 0.0f;
#pragma unroll 4
          for (int h = 0; h < nh; ++h) {
            const int o = hit_first[h0 + h] + d;
            const float gv = D <= kStage ? hit_g[h * D + d] : gb[static_cast<long long>(hit_k[h0 + h]) * D + d];
            if (o != cur) {
              if (cur >= 0 && cur < n) tile[cur] = acc;
              cur = o;
              acc = o >= 0 && o < n ? tile[o] : 0.0f;
            }
            acc += gv;
          }
          if (cur >= 0 && cur < n) tile[cur] = acc;
        }
      }
      __syncthreads();  // the tile is complete, or the next stage rewrites hit_g
    }
    if (base + kRound < K) __syncthreads();  // the next round rewrites the hit lists
  }

  // the tile once, zeros included, with streaming (evict-first) 16-byte
  // stores where the grid is 16-byte aligned: nothing reads it again here
  float* const ob = out + static_cast<long long>(b) * span + e0;
  for (int i = threadIdx.x; 4 * i < n; i += kThreads) {
    if (aligned && 4 * i + 3 < n) {
      __stcs(reinterpret_cast<float4*>(ob) + i, tile4[i]);
    } else {
      for (int u = 4 * i; u < min(4 * i + 4, n); ++u) ob[u] = tile[u];
    }
  }
}

}  // namespace

// g (B, K, D) f32; rows (B, K) int64; out (B, L, D) f32, 16-byte aligned,
// every element written here (the caller need not clear it). Returns the
// cudaError_t of the launch (0 on success); launches on `stream` and does not
// synchronise.
extern "C" int ubt_scatter_rows(const float* g, const long long* rows, int B,
                                int K, int L, int D, float* out, void* stream) {
  const long long span = static_cast<long long>(L) * D;
  if (B == 0 || span == 0) return 0;
  const long long per_image = (span + kRun - 1) / kRun;
  if (per_image * B > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  scatter_rows<<<static_cast<unsigned int>(per_image * B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, rows, K, L, D, static_cast<int>(per_image), span % 4 == 0, out);
  return static_cast<int>(cudaGetLastError());
}
