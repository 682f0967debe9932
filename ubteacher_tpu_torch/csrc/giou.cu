// GIoU loss on aligned ltrb distances, forward and backward, one pass each.
//
// Replaces ubteacher_tpu/ops/pallas/giou_pallas.py:giou_loss_pallas
// (_fwd_kernel) and its VJP (giou_pallas.py:85-93, jax.grad of the plain
// formula, which XLA fuses into one pass on the TPU). Per row: the weighted
// 1 - GIoU with the reference's (I+1)/(U+1) smoothing and the `ac == 0`
// guard; the backward gives d/d(pred) only, as the VJP does.
//
// What bounds it on the H100: bytes moved. The forward reads two ltrb rows
// and a weight and writes one float, 40 bytes a row (13.75 MB at the FCOS
// step's 343,776 rows, 0.0041 ms at 3.35 TB/s); the backward reads the same
// 36 bytes plus the upstream gradient (none when it is the stride-0 expand
// of a scalar that rows.sum() hands back) and writes a 16-byte gradient row.
// Each row costs some thirty float operations forward and seventy backward,
// far under the memory rate. Eager PyTorch runs the forward as about twenty
// passes and the backward, autograd over the formula, as about ninety.
//
// What the design does about it: one thread a row, a grid-stride loop over
// a grid of kBlocksPerSm blocks per SM. A thread loads its pred and target
// rows as one 16-byte float4 each, keeps every intermediate in registers and
// writes one float (forward) or one float4 (backward). The backward
// recomputes the forward's intermediates and applies the chain rule by hand,
// each step as autograd applies it to iou_loss_rows(...) * weight
// (ops/losses.py:giou_loss_grad is the same arithmetic in PyTorch):
//   * minimum / maximum send half the gradient to each side of a tie, and
//     the forward propagates a NaN operand as torch.minimum does (fmin/fmax
//     drop it). Their gradient multiplies the upstream gradient by 1, 1/2 or
//     0 as jax.grad does, where autograd's masked_fill writes 0: the two
//     agree on finite rows and differ only in where a non-finite row's
//     gradient is NaN, and there the kernel follows the JAX reference;
//   * where(ac == 0, 1, ac) sends gradient to ac only where ac != 0;
//   * no row is skipped: a weight-0 row with a non-finite pred gives NaN
//     where jax.grad gives NaN;
//   * the arithmetic uses the __f*_rn intrinsics so that nvcc contracts
//     nothing into fused multiply-adds and every operation rounds as the
//     PyTorch op does; default division is IEEE (no fast math).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libubt_giou.so giou.cu

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2,048 threads, an SM's limit
constexpr int kMaxDevices = 64;

// torch.minimum / torch.maximum: a NaN operand gives NaN
__device__ __forceinline__ float min_nan(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

// The forward's intermediates of one row, in the order of
// ops/losses.py:iou_loss_rows. ltrb rows: x = l, y = t, z = r, w = b.
struct Row {
  float s_w, s_h;      // pred l + r, t + b
  float w_i, h_i;      // intersection width and height
  float g_w, g_h;      // enclosing width and height
  float ac, uni, num, den, safe, d;
  float loss;          // 1 - GIoU
};

__device__ __forceinline__ Row giou_row(const float4 p, const float4 t) {
  Row r;
  const float target_area = __fmul_rn(__fadd_rn(t.x, t.z), __fadd_rn(t.y, t.w));
  r.s_w = __fadd_rn(p.x, p.z);
  r.s_h = __fadd_rn(p.y, p.w);
  const float pred_area = __fmul_rn(r.s_w, r.s_h);
  r.w_i = __fadd_rn(min_nan(p.x, t.x), min_nan(p.z, t.z));
  r.h_i = __fadd_rn(min_nan(p.w, t.w), min_nan(p.y, t.y));
  r.g_w = __fadd_rn(max_nan(p.x, t.x), max_nan(p.z, t.z));
  r.g_h = __fadd_rn(max_nan(p.w, t.w), max_nan(p.y, t.y));
  r.ac = __fmul_rn(r.g_w, r.g_h);
  const float inter = __fmul_rn(r.w_i, r.h_i);
  r.uni = __fsub_rn(__fadd_rn(target_area, pred_area), inter);
  r.num = __fadd_rn(inter, 1.0f);
  r.den = __fadd_rn(r.uni, 1.0f);
  const float ious = __fdiv_rn(r.num, r.den);
  r.safe = r.ac == 0.0f ? 1.0f : r.ac;
  r.d = __fsub_rn(r.ac, r.uni);
  r.loss = __fsub_rn(1.0f, __fsub_rn(ious, __fdiv_rn(r.d, r.safe)));
  return r;
}

// The gradient that minimum(a, b) / maximum(a, b) hands to a, by JAX's rule
// (lax._balanced_eq): g times 1 where a wins, 1/2 on a tie, 0 where a loses
// or an operand is NaN. A product, so 0 x inf or NaN is NaN as in jax.grad.
__device__ __forceinline__ float through_min(float a, float b, float g) {
  return __fmul_rn(g, a == b ? 0.5f : (a < b ? 1.0f : 0.0f));
}
__device__ __forceinline__ float through_max(float a, float b, float g) {
  return __fmul_rn(g, a == b ? 0.5f : (a > b ? 1.0f : 0.0f));
}

// pred, target (n, 4) f32, 16-byte aligned; weight, out (n,) f32.
__global__ void __launch_bounds__(kThreads)
giou_fwd(const float4* __restrict__ pred, const float4* __restrict__ target,
         const float* __restrict__ weight, float* __restrict__ out, int n) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    const float4 p = __ldg(pred + i);
    const float4 t = __ldg(target + i);
    const float w = __ldg(weight + i);
    out[i] = __fmul_rn(giou_row(p, t).loss, w);
  }
}

// d(rows)/d(pred) * grad for rows = (1 - GIoU) * weight; grad[i * grad_stride]
// is row i's upstream gradient (stride 0: one scalar for all rows).
__global__ void __launch_bounds__(kThreads)
giou_bwd(const float4* __restrict__ pred, const float4* __restrict__ target,
         const float* __restrict__ weight, const float* __restrict__ grad,
         long long grad_stride, float4* __restrict__ dpred, int n) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    const float4 p = __ldg(pred + i);
    const float4 t = __ldg(target + i);
    const float w = __ldg(weight + i);
    const float g = __ldg(grad + i * grad_stride);
    const Row r = giou_row(p, t);
    // rows = loss * w; loss = 1 - (ious - q); q = d / safe
    const float g_loss = __fmul_rn(g, w);
    const float g_ious = -g_loss;
    const float g_q = g_loss;
    const float g_d = __fdiv_rn(g_q, r.safe);
    const float g_safe = __fmul_rn(-g_q, __fdiv_rn(__fdiv_rn(r.d, r.safe), r.safe));
    const float g_ac = __fadd_rn(g_d, r.ac == 0.0f ? 0.0f : g_safe);
    // ious = num / den; d = ac - union; den = union + 1
    const float g_den = __fmul_rn(-g_ious, __fdiv_rn(__fdiv_rn(r.num, r.den), r.den));
    const float g_uni = __fadd_rn(-g_d, g_den);
    // num = inter + 1; union = (target_area + pred_area) - inter
    const float g_inter = __fadd_rn(__fdiv_rn(g_ious, r.den), -g_uni);
    const float g_wi = __fmul_rn(g_inter, r.h_i);
    const float g_hi = __fmul_rn(g_inter, r.w_i);
    const float g_gw = __fmul_rn(g_ac, r.g_h);
    const float g_gh = __fmul_rn(g_ac, r.g_w);
    const float g_sw = __fmul_rn(g_uni, r.s_h);  // pred_area = s_w * s_h
    const float g_sh = __fmul_rn(g_uni, r.s_w);
    // each coordinate sums its three uses as autograd does: the enclosing
    // box's, the intersection's, then pred_area's
    float4 dp;
    dp.x = __fadd_rn(__fadd_rn(through_max(p.x, t.x, g_gw), through_min(p.x, t.x, g_wi)), g_sw);
    dp.y = __fadd_rn(__fadd_rn(through_max(p.y, t.y, g_gh), through_min(p.y, t.y, g_hi)), g_sh);
    dp.z = __fadd_rn(__fadd_rn(through_max(p.z, t.z, g_gw), through_min(p.z, t.z, g_wi)), g_sw);
    dp.w = __fadd_rn(__fadd_rn(through_max(p.w, t.w, g_gh), through_min(p.w, t.w, g_hi)), g_sh);
    dpred[i] = dp;
  }
}

// Launches `launch(blocks)` with `device` current, then restores the
// caller's device. blocks: enough for n rows, at most kBlocksPerSm per SM
// (the SM count read once per device).
template <typename F>
int launch_on(int device, int n, F launch) {
  static int sms[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err;
  if (sms[device] == 0 &&
      (err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  int current = 0;
  if ((err = cudaGetDevice(&current)) != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  const int need = (n + kThreads - 1) / kThreads;
  launch(need < sms[device] * kBlocksPerSm ? need : sms[device] * kBlocksPerSm);
  err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // namespace

// pred, target (n, 4) f32, 16-byte aligned; weight, out (n,) f32; all on
// `device`. out[i] = (1 - GIoU(pred[i], target[i])) * weight[i]. Returns the
// cudaError_t of the launch (0 on success, and no launch for n = 0);
// launches on `stream` and does not synchronise.
extern "C" int ubt_giou_fwd(const float* pred, const float* target, const float* weight, int n,
                            float* out, int device, void* stream) {
  if (n <= 0) return 0;
  return launch_on(device, n, [&](int blocks) {
    giou_fwd<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(pred), reinterpret_cast<const float4*>(target), weight, out, n);
  });
}

// As ubt_giou_fwd, and grad[i * grad_stride] the upstream gradient of row i;
// dpred (n, 4) f32, 16-byte aligned, receives d(out)/d(pred) * grad.
extern "C" int ubt_giou_bwd(const float* pred, const float* target, const float* weight,
                            const float* grad, long long grad_stride, int n, float* dpred,
                            int device, void* stream) {
  if (n <= 0) return 0;
  return launch_on(device, n, [&](int blocks) {
    giou_bwd<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(pred), reinterpret_cast<const float4*>(target), weight, grad,
        grad_stride, reinterpret_cast<float4*>(dpred), n);
  });
}
