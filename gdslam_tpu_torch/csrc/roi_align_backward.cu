// The gradient of ROIAlign with respect to the FPN levels, for Hopper (sm_90a).
//
// Replaces the transpose of the JAX package's `roi_align`
// (gdslam_tpu/models/maskrcnn.py:222) that jax.grad builds when Mask R-CNN
// trains (`train_losses` :352, `train_losses_sampled` :438): the transpose of
// the gather `flat[off + yi * fwr + xi]` (:265) is a scatter-add of each
// bin's cotangent, times the forward's two bilinear factors, into the
// [sum(h * w), C] level buffer. There is no Pallas kernel for it. Plain twin:
// gdslam_tpu_torch/ops/detect_kernels.py roi_align_backward_plain. Two call
// sites per image and training step: the box head's crops (R = 64, out = 7)
// and the mask head's (R = 64, out = 14), C = 256.
//
// What it computes. The forward's term for tap t of bin (r, i, j) is
// (flat[row_t] * a_t) * b_t, with a_t the row factor ((1 - fy) or fy) and b_t
// the column factor ((1 - fx) or fx). Its transpose sends (g[r, i, j] * b_t)
// * a_t to flat[row_t]. The wrapper's prologue (PyTorch, shared with the
// plain twin) lists every (tap, box, bin) contribution with its target row
// and factors, ids tap-major in the order the JAX transpose accumulates the
// taps ((1, 1), (1, 0), (0, 1), (0, 0)), and sorts them stably by target row.
// A row's gradient is then summed in that fixed order: each tap's
// contributions serially into a partial sum, the partial sums of the taps
// added to the total in turn, as the JAX transpose adds the four scatter-adds
// of its gathers. No float atomics: the result is the same bits on every run,
// and each product and sum is rounded once (__fmul_rn / __fadd_rn, and
// -fmad=false), so the kernel equals the plain twin to the bit. Taps clipped
// to a level's border land on one row and are summed there, as XLA's
// scatter-add sums them.
//
// What bounds it on this card. Bytes: the cotangent [R, out, out, C] read
// once and the touched rows of the gradient written once, plus 16 bytes of
// lists per contribution: ~20 MB at the mask head's shape, a few
// microseconds at HBM rate. Design (simple first): one warp per contribution
// that starts a run of equal targets (the others return at once), the lanes
// over C with 16-byte loads (float4), walking its run serially. A long run
// (many bins on one row) is one warp's serial work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

struct DeviceGuard {                          // the launch goes to `device`
  int prev = -1;
  explicit DeviceGuard(int device) {
    cudaGetDevice(&prev);
    if (prev != device) cudaSetDevice(device); else prev = -1;
  }
  ~DeviceGuard() { if (prev >= 0) cudaSetDevice(prev); }
};

__device__ __forceinline__ float4 add4(float4 s, float4 v) {
  return make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y), __fadd_rn(s.z, v.z),
                     __fadd_rn(s.w, v.w));
}

// (g * b) * a per lane of a float4: one contribution, as the JAX transpose
// multiplies it
__device__ __forceinline__ float4 contribution(float4 g, float a, float b) {
  return make_float4(__fmul_rn(__fmul_rn(g.x, b), a), __fmul_rn(__fmul_rn(g.y, b), a),
                     __fmul_rn(__fmul_rn(g.z, b), a), __fmul_rn(__fmul_rn(g.w, b), a));
}

__global__ void __launch_bounds__(THREADS)
roi_align_backward_kernel(const float4* __restrict__ grad, int c4,
                          const int* __restrict__ target, const int* __restrict__ order,
                          const float* __restrict__ fa, const float* __restrict__ fb, int n,
                          int bins, float4* __restrict__ out) {
  const long long k = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (k >= n) return;
  const int row = target[k];
  if (k > 0 && target[k - 1] == row) return;          // not the start of a run
  int end = static_cast<int>(k) + 1;
  while (end < n && target[end] == row) ++end;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = lane; c < c4; c += 32) {
    float4 total = zero, part = zero;
    int group = -1;
    for (int m = static_cast<int>(k); m < end; ++m) {
      const int id = order[m];
      const int tap = id / bins;
      if (tap != group) {                               // the next tap's scatter-add
        if (group >= 0) total = add4(total, part);
        part = zero;
        group = tap;
      }
      const float4 g = __ldg(grad + static_cast<size_t>(id - tap * bins) * c4 + c);
      part = add4(part, contribution(g, __ldg(fa + id), __ldg(fb + id)));
    }
    out[static_cast<size_t>(row) * c4 + c] = add4(total, part);
  }
}

}  // namespace

// grad [bins, C] f32 (bins = R * out * out; 16-byte aligned, C a multiple of
// 4); target [n] int32 sorted, order [n] int32 (the contribution id of each
// sorted entry: tap * bins + bin), fa, fb [n] f32 by contribution id; out
// [S, C] f32, zero where no contribution lands (the wrapper zero-fills it).
extern "C" int roi_align_backward_launch(const void* grad, int C, const void* target,
                                         const void* order, const void* fa, const void* fb,
                                         int n, int bins, void* out, int device, void* stream) {
  if (C % 4 || n < 0 || bins < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(device);
  const int blocks = static_cast<int>((static_cast<long long>(n) * 32 + THREADS - 1) / THREADS);
  roi_align_backward_kernel<<<blocks, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(grad), C / 4, static_cast<const int*>(target),
      static_cast<const int*>(order), static_cast<const float*>(fa),
      static_cast<const float*>(fb), n, bins, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
