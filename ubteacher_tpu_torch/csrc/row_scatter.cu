// Row scatter-add: the transpose of the batched row gather used by the RPN
// losses.
//
// Replaces ubteacher_tpu/ops/pallas/row_gather_pallas.py:scatter_rows_pallas
// (_scatter_rows_kernel), the backward of take_rows: out (B, L, D) float32,
// zero-filled by the caller, receives g[b, k, :] added at row rows[b, k];
// duplicate rows accumulate.
//
// What bounds it on the H100: almost nothing is computed. At the RPN's shapes
// the gradient rows are 24 x 320 x 3 and 24 x 320 x 12 floats (at most 370 KB
// in, 2,300 adds), while the zero-filled output is 24 x 85,932 x D floats
// (25 MB and 99 MB). The output's zero fill, done by the caller, is the
// cost; the scatter itself is launch latency.
//
// What the design does about it: one thread per (b, k, d) element, with
// neighbouring threads on neighbouring d so that a row's D values are one
// contiguous run, and one atomicAdd each, so duplicates in `rows` add up in
// any order (float32 sums of the same terms; the order may change the last
// bit). The Pallas kernel kept the whole per-image grid in VMEM to avoid a
// serial XLA scatter on the TPU; on the GPU the atomics make that needless.
// A row index outside [0, L) is dropped, as XLA's scatter drops it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libubt_row_scatter.so row_scatter.cu

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void scatter_rows(const float* __restrict__ g,
                             const long long* __restrict__ rows, int B, int K,
                             int L, int D, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(B) * K * D;
  if (i >= total) return;
  const int d = static_cast<int>(i % D);
  const long long bk = i / D;
  const int b = static_cast<int>(bk / K);
  const long long r = rows[bk];
  if (r < 0 || r >= L) return;
  atomicAdd(out + (static_cast<size_t>(b) * L + r) * D + d, g[i]);
}

}  // namespace

// g (B, K, D) f32; rows (B, K) int64; out (B, L, D) f32 zero-filled. Returns
// the cudaError_t of the launch (0 on success); launches on `stream` and does
// not synchronise.
extern "C" int ubt_scatter_rows(const float* g, const long long* rows, int B,
                                int K, int L, int D, float* out, void* stream) {
  const long long total = static_cast<long long>(B) * K * D;
  if (total == 0) return 0;
  const unsigned int blocks = static_cast<unsigned int>((total + kThreads - 1) / kThreads);
  scatter_rows<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(g, rows, B, K, L, D, out);
  return static_cast<int>(cudaGetLastError());
}
