// Mask pasting (GetDynSeg) for Hopper (sm_90a).
//
// Replaces the stage that XLA fuses into the JAX package's segmenter
// program: `paste_masks`, gdslam_tpu/models/maskrcnn.py:744 (there is no
// Pallas kernel for it). Plain twin: gdslam_tpu_torch/ops/detect_kernels.py
// paste_masks_plain. One call per frame: D = 32 detections' 28 x 28 masks
// into the 480 x 640 output frame.
//
// What it computes. out[y, x] = 1 where some detection d that pastes (valid,
// and of a dynamic class: ok[d], decided by the wrapper) has its box around
// the pixel (box.y1 <= y < box.y2, box.x1 <= x < box.x2) and a resampled mask
// value v > th, else 0. v is the JAX package's separable bilinear
// (Ky @ m) @ Kx^T at that pixel: per axis interp_matrix's
//   f = (c - lo) / max(hi - lo, 1) * 28 - 0.5, k0 = clip(floor(f), 0, 26),
//   w = clip(f - k0, 0, 1),
// so a row of Ky holds 1 - w at k0 and w at k0 + 1. The row pass comes first
// (the two mask rows blended for the two columns the pixel needs), then the
// column pass, with single IEEE roundings (-fmad=false).
//
// What bounds it on this card. Bytes: 307,200 output bytes and ~100 KB of
// masks; a fraction of a microsecond at HBM rate. The work is D box tests
// per pixel and a dozen flops for each box that holds it.
// Design: one thread per pixel, a block per 32 x 32 tile; the block stages
// the boxes, flags and masks in dynamic shared memory (D * 3,156 bytes) and
// each thread walks the detections until one sets its pixel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int M = 28;                         // mask side
constexpr int TILE = 32;                      // pixels per tile side
constexpr int ROWS = 8;                       // thread rows per block: 4 pixels each

struct DeviceGuard {                          // the launch goes to `device`
  int prev = -1;
  explicit DeviceGuard(int device) {
    cudaGetDevice(&prev);
    if (prev != device) cudaSetDevice(device); else prev = -1;
  }
  ~DeviceGuard() { if (prev >= 0) cudaSetDevice(prev); }
};

// interp_matrix's row for pixel coordinate c on a box side [lo, hi)
__device__ __forceinline__ void interp(float c, float lo, float hi, int& k0, float& w) {
  const float f = __fsub_rn(__fmul_rn(__fdiv_rn(__fsub_rn(c, lo), fmaxf(__fsub_rn(hi, lo), 1.f)),
                                      static_cast<float>(M)), 0.5f);
  const float k = fminf(fmaxf(floorf(f), 0.f), static_cast<float>(M - 2));
  k0 = static_cast<int>(k);
  w = fminf(fmaxf(__fsub_rn(f, k), 0.f), 1.f);
}

__global__ void __launch_bounds__(TILE * ROWS)
paste_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ ok,
             const float* __restrict__ masks, int D, int H, int W, float th,
             uint8_t* __restrict__ out) {
  extern __shared__ float4 smem[];
  float4* s_box = smem;                                       // [D]
  float* s_mask = reinterpret_cast<float*>(smem + D);         // [D, 28, 28]
  int* s_ok = reinterpret_cast<int*>(s_mask + D * M * M);     // [D]
  const int tid = threadIdx.y * TILE + threadIdx.x;
  for (int k = tid; k < D * M * M; k += TILE * ROWS) s_mask[k] = masks[k];
  for (int d = tid; d < D; d += TILE * ROWS) { s_box[d] = boxes[d]; s_ok[d] = ok[d]; }
  __syncthreads();

  const int x = blockIdx.x * TILE + threadIdx.x;
  if (x >= W) return;
  const float fxc = static_cast<float>(x);
  for (int y = blockIdx.y * TILE + threadIdx.y; y < min(H, (blockIdx.y + 1) * TILE); y += ROWS) {
    const float fyc = static_cast<float>(y);
    uint8_t hit = 0;
    for (int d = 0; d < D && !hit; ++d) {
      if (!s_ok[d]) continue;
      const float4 b = s_box[d];
      if (!(fyc >= b.x && fyc < b.z && fxc >= b.y && fxc < b.w)) continue;
      int ky, kx;
      float wy, wx;
      interp(fyc, b.x, b.z, ky, wy);
      interp(fxc, b.y, b.w, kx, wx);
      const float* m = s_mask + d * M * M + ky * M + kx;
      const float oy = __fsub_rn(1.f, wy), ox = __fsub_rn(1.f, wx);
      const float r0 = __fadd_rn(__fmul_rn(oy, m[0]), __fmul_rn(wy, m[M]));       // column kx
      const float r1 = __fadd_rn(__fmul_rn(oy, m[1]), __fmul_rn(wy, m[M + 1]));   // column kx + 1
      const float v = __fadd_rn(__fmul_rn(ox, r0), __fmul_rn(wx, r1));
      hit = v > th;
    }
    out[static_cast<size_t>(y) * W + x] = hit;
  }
}

}  // namespace

// boxes [D, 4] f32 (16-byte aligned), ok [D] uint8, masks [D, 28, 28] f32,
// out [H, W] uint8; 0 <= D <= 64.
extern "C" int paste_masks_launch(const void* boxes, const void* ok, const void* masks, int D,
                                  int H, int W, float th, void* out, int device, void* stream) {
  if (D < 0 || D > 64 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  const size_t smem = static_cast<size_t>(D) * (sizeof(float4) + M * M * sizeof(float) +
                                                sizeof(int));
  static int configured[64] = {0};            // the large-shared-memory opt-in, per device
  if (!configured[device & 63]) {
    cudaError_t e = cudaFuncSetAttribute(paste_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         64 * (sizeof(float4) + M * M * sizeof(float) + sizeof(int)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[device & 63] = 1;
  }
  const dim3 block(TILE, ROWS), grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE);
  paste_kernel<<<grid, block, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(ok),
      static_cast<const float*>(masks), D, H, W, th, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
