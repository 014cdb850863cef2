// Fixed-budget greedy NMS for Hopper (sm_90a).
//
// Replaces the stage that XLA fuses into the JAX package's Mask R-CNN
// program: `nms_fixed`, gdslam_tpu/models/maskrcnn.py:202 (there is no Pallas
// kernel for it). Plain twin: gdslam_tpu_torch/ops/detect_kernels.py
// nms_fixed_plain. Two call sites per frame: the proposals (N = 1024,
// n_out = 128, IoU threshold 0.7) and the detections (N = 128, n_out = 32,
// threshold 0.3, scores -inf below the score threshold).
//
// What it computes. n_out steps; each picks the alive box of highest score
// (the lowest index among ties, as jnp.argmax) and writes its index, or -1
// once no box is alive; then clears every box j with iou(best, j) > th, and
// best itself. A box is alive at the start when its score is above -inf.
//
// What bounds it on this card. The inputs are N x 20 bytes (20 KB at
// N = 1024) and the work is n_out x N IoUs: nothing for the card's bandwidth
// or issue rate. What limits it is the chain of n_out dependent steps, each
// a block-wide argmax and a sweep separated by barriers, a few hundred
// nanoseconds of latency per step.
//
// Design. One CTA of up to 1024 threads, one box per thread, kept in
// registers (and in shared memory for the step's winner to be read by all).
// A step is a warp-shuffle argmax, one barrier to publish the 32 warp
// winners, which every thread then reduces itself, and the sweep. The IoU is
// box_iou's formula term by term with single IEEE roundings (__fmul_rn and
// friends, and the file is built with -fmad=false), so no threshold
// comparison can flip against the plain version.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int MAX_N = 1024;

struct DeviceGuard {                          // the launch goes to `device`
  int prev = -1;
  explicit DeviceGuard(int device) {
    cudaGetDevice(&prev);
    if (prev != device) cudaSetDevice(device); else prev = -1;
  }
  ~DeviceGuard() { if (prev >= 0) cudaSetDevice(prev); }
};

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// iou(a, b) as box_iou computes it: inter / max(area_a + area_b - inter, 1e-9)
__device__ __forceinline__ float box_iou(float4 a, float area_a, float4 b, float area_b) {
  const float y1 = fmaxf(a.x, b.x), x1 = fmaxf(a.y, b.y);
  const float y2 = fminf(a.z, b.z), x2 = fminf(a.w, b.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(y2, y1), 0.f), fmaxf(__fsub_rn(x2, x1), 0.f));
  const float den = fmaxf(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-9f);
  return __fdiv_rn(inter, den);
}

// (v, i) beats (v2, i2): the higher value, the lower index among equals
__device__ __forceinline__ bool better(float v, int i, float v2, int i2) {
  return v > v2 || (v == v2 && i < i2);
}

__global__ void __launch_bounds__(MAX_N)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores, int n,
           float th, int n_out, int* __restrict__ out) {
  __shared__ float4 s_box[MAX_N];
  __shared__ float s_area[MAX_N];
  __shared__ float w_val[32];
  __shared__ int w_idx[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, n_warps = blockDim.x >> 5;

  float4 mine = make_float4(0.f, 0.f, 0.f, 0.f);
  float my_area = 0.f, my_score = -INFINITY;
  bool alive = false;
  if (t < n) {
    mine = boxes[t];
    my_area = box_area(mine);
    my_score = scores[t];
    alive = my_score > -INFINITY;
    s_box[t] = mine;
    s_area[t] = my_area;
  }
  __syncthreads();

  for (int step = 0; step < n_out; ++step) {
    float v = alive ? my_score : -INFINITY;
    int i = alive ? t : INT_MAX;
    for (int off = 16; off; off >>= 1) {
      const float v2 = __shfl_down_sync(0xffffffffu, v, off);
      const int i2 = __shfl_down_sync(0xffffffffu, i, off);
      if (better(v2, i2, v, i)) { v = v2; i = i2; }
    }
    if (lane == 0) { w_val[warp] = v; w_idx[warp] = i; }
    __syncthreads();
    float bv = -INFINITY;
    int best = INT_MAX;
    for (int w = 0; w < n_warps; ++w)
      if (better(w_val[w], w_idx[w], bv, best)) { bv = w_val[w]; best = w_idx[w]; }
    if (best == INT_MAX) {                    // nothing alive: the rest is -1
      for (int s = step + t; s < n_out; s += blockDim.x) out[s] = -1;
      return;
    }
    if (t == 0) out[step] = best;
    if (alive && (t == best || !(box_iou(s_box[best], s_area[best], mine, my_area) <= th)))
      alive = false;
    __syncthreads();                          // w_val / w_idx are rewritten next step
  }
}

}  // namespace

// boxes [n, 4] f32 (16-byte aligned), scores [n] f32, 1 <= n <= 1024;
// out [n_out] int32.
extern "C" int nms_fixed_launch(const void* boxes, const void* scores, int n, float th,
                                int n_out, void* out, int device, void* stream) {
  if (n < 1 || n > MAX_N || n_out < 0) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  const int threads = (n + 31) / 32 * 32;
  nms_kernel<<<1, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores), n, th, n_out,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
