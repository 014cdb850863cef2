// Mask pasting (GetDynSeg) for Hopper (sm_90a).
//
// Replaces the stage that XLA fuses into the JAX package's segmenter
// program: `paste_masks`, gdslam_tpu/models/maskrcnn.py:744 (there is no
// Pallas kernel for it). Plain twin: gdslam_tpu_torch/ops/detect_kernels.py
// paste_masks_plain. One call per frame: D = 32 detections' 28 x 28 masks
// into the 480 x 640 output frame.
//
// What it computes. out[y, x] = 1 where some detection d that pastes (valid
// and, with dyn_only, of a dynamic class: bit classes[d] of the 96-bit class
// mask) has its box around the pixel (box.y1 <= y < box.y2, box.x1 <= x <
// box.x2) and a resampled mask value v > th, else 0. v is the JAX
// package's separable bilinear (Ky @ m) @ Kx^T at that pixel: per axis
// interp_matrix's
//   f = (c - lo) / max(hi - lo, 1) * 28 - 0.5, k0 = clip(floor(f), 0, 26),
//   w = clip(f - k0, 0, 1),
// so a row of Ky holds 1 - w at k0 and w at k0 + 1. The row pass comes first
// (the two mask rows blended for the two columns the pixel needs), then the
// column pass, with single IEEE roundings (-fmad=false).
//
// What bounds it on this card. Bytes: 307,200 output bytes and the masks
// that touch the frame (~100 KB at most); a fraction of a microsecond at
// HBM rate. The work is D box tests per pixel and a dozen flops for each
// box that holds it.
// Design: a block per 32 x 32 tile, one thread per pixel column and 4 rows.
// The first warp lists the detections that paste and whose box meets the
// tile (a ballot per 32 detections, the list and the boxes in detection
// order in shared memory); the block then computes each listed box's
// interp_matrix rows for the tile's 32 rows and 32 columns (64 divisions a
// box instead of two a pixel), and each thread walks the list for its
// pixels until one sets them, reading the four mask cells it needs through
// the read-only cache (a tile samples a few cells of each mask: nothing is
// staged). Two barriers a block. A tile no box meets reads no mask. The
// union is the plain version's: the list holds every box that can hold a
// pixel of the tile (y2 > the tile's first row, y1 <= its last, the same
// for columns), so the same boxes set each pixel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int M = 28;                         // mask side
constexpr int TILE = 32;                      // pixels per tile side
constexpr int ROWS = 8;                       // thread rows per block: 4 pixels each
constexpr int PIX = TILE / ROWS;
constexpr int MAX_D = 64;

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
paste_kernel(const float4* __restrict__ boxes, const int* __restrict__ classes,
             const uint8_t* __restrict__ valid, const float* __restrict__ masks, int D, int H,
             int W, float th, uint32_t cls0, uint32_t cls1, uint32_t cls2, int dyn_only,
             uint8_t* __restrict__ out) {
  __shared__ int s_list[MAX_D];
  __shared__ int s_n;
  __shared__ float4 s_box[MAX_D];
  __shared__ int s_k0[MAX_D][2 * TILE];       // interp_matrix per listed box: the tile's
  __shared__ float s_w[MAX_D][2 * TILE];      // rows, then its columns
  const int tid = threadIdx.y * TILE + threadIdx.x;
  const int tx0 = blockIdx.x * TILE, ty0 = blockIdx.y * TILE;
  if (threadIdx.y == 0) {                     // warp 0 lists the boxes that meet the tile
    const int lane = threadIdx.x;
    const float ylo = static_cast<float>(ty0), yhi = static_cast<float>(min(ty0 + TILE, H) - 1);
    const float xlo = static_cast<float>(tx0), xhi = static_cast<float>(min(tx0 + TILE, W) - 1);
    int n = 0;
    for (int base = 0; base < D; base += 32) {
      const int d = base + lane;
      bool keep = false;
      float4 b;
      if (d < D) {
        b = boxes[d];
        const int c = classes[d];
        const uint32_t word = c < 32 ? cls0 : c < 64 ? cls1 : cls2;
        const bool cls_ok = !dyn_only || (c >= 0 && c < 96 && ((word >> (c & 31)) & 1u));
        keep = valid[d] && cls_ok && yhi >= b.x && ylo < b.z && xhi >= b.y && xlo < b.w;
      }
      const unsigned m = __ballot_sync(0xFFFFFFFFu, keep);   // every lane votes
      if (keep) {
        const int at = n + __popc(m & ((1u << lane) - 1u));
        s_list[at] = d;
        s_box[at] = b;
      }
      n += __popc(m);
    }
    if (lane == 0) s_n = n;
  }
  __syncthreads();
  const int n = s_n;
  for (int k = tid; k < n * 2 * TILE; k += TILE * ROWS) {
    const int e = k / (2 * TILE), q = k % (2 * TILE);
    const float4 b = s_box[e];
    if (q < TILE) interp(static_cast<float>(ty0 + q), b.x, b.z, s_k0[e][q], s_w[e][q]);
    else interp(static_cast<float>(tx0 + q - TILE), b.y, b.w, s_k0[e][q], s_w[e][q]);
  }
  __syncthreads();
  const int x = tx0 + threadIdx.x;
  if (x >= W) return;
  const float fxc = static_cast<float>(x);
#pragma unroll
  for (int p = 0; p < PIX; ++p) {
    const int py = threadIdx.y + ROWS * p, y = ty0 + py;
    if (y >= H) continue;
    const float fyc = static_cast<float>(y);
    uint8_t hit = 0;
    for (int e = 0; e < n && !hit; ++e) {
      const float4 b = s_box[e];
      if (!(fyc >= b.x && fyc < b.z && fxc >= b.y && fxc < b.w)) continue;
      const int ky = s_k0[e][py], kx = s_k0[e][TILE + threadIdx.x];
      const float wy = s_w[e][py], wx = s_w[e][TILE + threadIdx.x];
      const float* m = masks + static_cast<size_t>(s_list[e]) * M * M + ky * M + kx;
      const float m00 = __ldg(m), m01 = __ldg(m + 1), m10 = __ldg(m + M), m11 = __ldg(m + M + 1);
      const float oy = __fsub_rn(1.f, wy), ox = __fsub_rn(1.f, wx);
      const float r0 = __fadd_rn(__fmul_rn(oy, m00), __fmul_rn(wy, m10));       // column kx
      const float r1 = __fadd_rn(__fmul_rn(oy, m01), __fmul_rn(wy, m11));       // column kx + 1
      const float v = __fadd_rn(__fmul_rn(ox, r0), __fmul_rn(wx, r1));
      hit = v > th;
    }
    out[static_cast<size_t>(y) * W + x] = hit;
  }
}

}  // namespace

// boxes [D, 4] f32 (16-byte aligned), classes [D] int32, valid [D] uint8,
// masks [D, 28, 28] f32, out [H, W] uint8; 0 <= D <= 64; cls0..cls2 the
// 96-bit mask of the classes that paste when dyn_only.
extern "C" int paste_masks_launch(const void* boxes, const void* classes, const void* valid,
                                  const void* masks, int D, int H, int W, float th,
                                  unsigned cls0, unsigned cls1, unsigned cls2, int dyn_only,
                                  void* out, int device, void* stream) {
  if (D < 0 || D > MAX_D || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  const dim3 block(TILE, ROWS), grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE);
  paste_kernel<<<grid, block, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const int*>(classes),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(masks), D, H, W, th, cls0,
      cls1, cls2, dyn_only, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
