// ROIAlign over the FPN levels P2..P5 for Hopper (sm_90a).
//
// Replaces the stage that XLA fuses into the JAX package's Mask R-CNN
// program: `roi_align`, gdslam_tpu/models/maskrcnn.py:222 (there is no Pallas
// kernel for it). Plain twin: gdslam_tpu_torch/ops/detect_kernels.py
// roi_align_plain. Two call sites per frame: the box head's crops (R = 128,
// out = 7) and the mask head's (R = 32, out = 14), C = 256.
//
// What it computes. For box r and output bin (i, j), the bilinear blend of
// four taps of the box's level, read from one [sum(h * w), C] channels-last
// buffer (P2..P5 one after the other, as :238 flattens them):
//   t(y, x) = flat[off_r + clip(y, 0, h_r - 1) * w_r + clip(x, 0, w_r - 1)]
//   out[r, i, j] = t(y0, x0) * (1 - fy) * (1 - fx) + t(y0, x0 + 1) * (1 - fy) * fx
//                + t(y0 + 1, x0) * fy * (1 - fx) + t(y0 + 1, x0 + 1) * fy * fx
// with y0 = y0[r, i], fy = fy[r, i], x0 = x0[r, j], fx = fx[r, j]. The
// per-box prologue (the level by the sqrt(hw) / 224 rule, the sample
// coordinates, their floors) is computed by the same PyTorch code for both
// routes, so a log2 rounding cannot move a box to another level. The blend
// is evaluated in the JAX order, each product left to right, the four terms
// summed left to right, with no fused multiply-add (__fmul_rn / __fadd_rn,
// and -fmad=false): the kernel equals the plain version to the bit.
//
// What bounds it on this card. Bytes: four taps of C floats read per bin and
// one written, R * out^2 * C * 20 bytes at most (the taps of neighbouring
// bins overlap and mostly hit L1/L2); a few microseconds at HBM rate.
// Design: one warp per output bin, the lanes over C with 16-byte loads
// (float4), so a tap is one coalesced 1 KB row at C = 256; the output is
// written channels last, which the box head flattens as the JAX does.

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

__device__ __forceinline__ int clip(int v, int hi) { return min(max(v, 0), hi); }

// ((t * a) * b): one term of the blend, as the JAX multiplies it
__device__ __forceinline__ float term(float t, float a, float b) {
  return __fmul_rn(__fmul_rn(t, a), b);
}

__device__ __forceinline__ float blend(float t00, float t01, float t10, float t11, float oy,
                                       float wy, float ox, float wx) {
  return __fadd_rn(__fadd_rn(__fadd_rn(term(t00, oy, ox), term(t01, oy, wx)), term(t10, wy, ox)),
                   term(t11, wy, wx));
}

__global__ void __launch_bounds__(THREADS)
roi_align_kernel(const float4* __restrict__ flat, int c4, const int* __restrict__ info,
                 const int* __restrict__ y0, const int* __restrict__ x0,
                 const float* __restrict__ fy, const float* __restrict__ fx, int R, int S,
                 float4* __restrict__ out) {
  const int bin = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (bin >= R * S * S) return;
  const int r = bin / (S * S), i = (bin / S) % S, j = bin % S;
  const int off = info[3 * r], h = info[3 * r + 1], w = info[3 * r + 2];
  const int yi = y0[r * S + i], xi = x0[r * S + j];
  const float wy = fy[r * S + i], wx = fx[r * S + j];
  const float oy = __fsub_rn(1.f, wy), ox = __fsub_rn(1.f, wx);
  const int ya = clip(yi, h - 1), yb = clip(yi + 1, h - 1);
  const int xa = clip(xi, w - 1), xb = clip(xi + 1, w - 1);
  const float4* p00 = flat + static_cast<size_t>(off + ya * w + xa) * c4;
  const float4* p01 = flat + static_cast<size_t>(off + ya * w + xb) * c4;
  const float4* p10 = flat + static_cast<size_t>(off + yb * w + xa) * c4;
  const float4* p11 = flat + static_cast<size_t>(off + yb * w + xb) * c4;
  float4* o = out + static_cast<size_t>(bin) * c4;
  for (int c = lane; c < c4; c += 32) {
    const float4 a = __ldg(p00 + c), b = __ldg(p01 + c), d = __ldg(p10 + c), e = __ldg(p11 + c);
    float4 v;
    v.x = blend(a.x, b.x, d.x, e.x, oy, wy, ox, wx);
    v.y = blend(a.y, b.y, d.y, e.y, oy, wy, ox, wx);
    v.z = blend(a.z, b.z, d.z, e.z, oy, wy, ox, wx);
    v.w = blend(a.w, b.w, d.w, e.w, oy, wy, ox, wx);
    o[c] = v;
  }
}

}  // namespace

// flat [S_total, C] f32 (16-byte aligned, C a multiple of 4); info [R, 3]
// int32 (level offset in rows, h, w); y0, fy [R, S]; x0, fx [R, S];
// out [R, S, S, C] f32.
extern "C" int roi_align_launch(const void* flat, int C, const void* info, const void* y0,
                                const void* x0, const void* fy, const void* fx, int R, int S,
                                void* out, int device, void* stream) {
  if (C % 4 || R < 0 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(device);
  const long long warps = static_cast<long long>(R) * S * S;
  const int blocks = static_cast<int>((warps * 32 + THREADS - 1) / THREADS);
  roi_align_kernel<<<blocks, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(flat), C / 4, static_cast<const int*>(info),
      static_cast<const int*>(y0), static_cast<const int*>(x0), static_cast<const float*>(fy),
      static_cast<const float*>(fx), R, S, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
