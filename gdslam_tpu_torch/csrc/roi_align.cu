// ROIAlign over the FPN levels P2..P5 for Hopper (sm_90a), with its
// per-box prologue.
//
// Replaces the stage that XLA fuses into the JAX package's Mask R-CNN
// program: `roi_align`, gdslam_tpu/models/maskrcnn.py:222 (there is no Pallas
// kernel for it). Plain twin: gdslam_tpu_torch/ops/detect_kernels.py
// roi_align_plain on roi_prologue. Two call sites per frame: the box head's
// crops (R = 128, out = 7) and the mask head's (R = 32, out = 14), C = 256;
// four a training step.
//
// What it computes. For box r (y1, x1, y2, x2) the prologue: the level L by
// the sqrt(hw) / 224 rule, the stride 4 << L, and per output row i the
// sample row y = (y1 + t_i * (y2 - y1)) / stride - 0.5 (t_i the i-th point of
// linspace(0, 1, out): i times the float reciprocal of out - 1, the last
// exactly 1), its floor y0 and fraction fy = y - y0; the same per column.
// Then for each output bin (i, j) the bilinear blend of four taps of level
// L, read from one [sum(h * w), C] channels-last buffer (P2..P5 one after
// the other, as :238 flattens them):
//   t(y, x) = flat[off_L + clip(y, 0, h_L - 1) * w_L + clip(x, 0, w_L - 1)]
//   out[r, i, j] = t(y0, x0) * (1 - fy) * (1 - fx) + t(y0, x0 + 1) * (1 - fy) * fx
//                + t(y0 + 1, x0) * fy * (1 - fx) + t(y0 + 1, x0 + 1) * fy * fx.
// The level rule is exact, with no log2 (CUDA's log2f is not the CPU's):
// with A = fl(max(y2 - y1, 1) * max(x2 - x1, 1)) the level is the number of
// thresholds in LEVEL_AREA that A reaches, the smallest float areas at
// which the JAX expression floor(2 + log2(sqrt(A) / 224 + 1e-9)), evaluated
// op by op in float32 on the CPU, reaches levels 1, 2 and 3 (the last below
// 448^2: 2 + log2 rounds up to 3 a few ulps below it). Every step of that
// expression is monotone in A, so the thresholds decide it everywhere;
// detect_kernels.roi_levels is the plain mirror, tested against the JAX
// roi_align's levels on boxes a few ulps either side of each threshold. The
// coordinates and the blend take single roundings (__fmul_rn / __fadd_rn;
// the division is by a power of two, an exact product), in the JAX order, each product
// left to right and the four terms summed left to right (-fmad=false): the
// kernel equals the plain version to the bit. For the gradient the kernel
// also writes the prologue out (info, y0, x0, fy, fx, what roi_prologue
// returns), which the backward kernel reads.
//
// What bounds it on this card. Bytes: four taps of C floats read per bin and
// one written, R * out^2 * C * 20 bytes at most (the taps of neighbouring
// bins overlap and mostly hit L1/L2); a few microseconds at HBM rate.
// Design: one warp per output bin, as the parent kernel: the warp loads its
// box (one 16-byte load), decides the level and computes the bin's sample
// row and column in registers, a few dozen instructions with no division
// (the reciprocal of out - 1 comes from the host, correctly rounded; the
// stride's is a power of two), no shared memory, no barrier, no shuffle;
// then the lanes run over C with 16-byte loads (float4), so a tap is one
// coalesced 1 KB row at C = 256; the output is written channels last, which
// the box head flattens as the JAX does. The warps of column 0 write the
// rows of the prologue, those of row 0 its columns. The call is one launch:
// no prologue on the host.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;                  // 8 output bins per CTA
// the smallest float h * w of levels 1, 2, 3 (see the header)
__constant__ float LEVEL_AREA[3] = {12544.0f, 50176.0f, 200703.96875f};

struct DeviceGuard {                          // the launch goes to `device`
  int prev = -1;
  explicit DeviceGuard(int device) {
    cudaGetDevice(&prev);
    if (prev != device) cudaSetDevice(device); else prev = -1;
  }
  ~DeviceGuard() { if (prev >= 0) cudaSetDevice(prev); }
};

struct Levels {                               // P2..P5 in flat: first row, h, w
  int off0, off1, off2, off3, h0, h1, h2, h3, w0, w1, w2, w3;
};

// v0..v3 by L, as selects: an indexed kernel parameter would go through
// the stack
__device__ __forceinline__ int pick(int L, int v0, int v1, int v2, int v3) {
  return L == 0 ? v0 : L == 1 ? v1 : L == 2 ? v2 : v3;
}

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

// the sample coordinate k of a box side [lo, hi): t_k = k * step (step the
// float reciprocal of S - 1; the last point 1, a lone point 0), then
// (lo + t_k * (hi - lo)) / stride - 0.5, the division by the power of two
// an exact product by its inverse
__device__ __forceinline__ float sample(float lo, float hi, int k, int S, float step,
                                        float inv_stride) {
  const float t = S == 1 ? 0.f : k == S - 1 ? 1.f : __fmul_rn(static_cast<float>(k), step);
  return __fsub_rn(__fmul_rn(__fadd_rn(lo, __fmul_rn(t, __fsub_rn(hi, lo))), inv_stride), 0.5f);
}

__global__ void __launch_bounds__(THREADS)
roi_align_kernel(const float4* __restrict__ flat, int c4, const float4* __restrict__ boxes,
                 Levels lv, int R, int S, float step, float4* __restrict__ out,
                 int* __restrict__ p_info,
                 int* __restrict__ p_y0, int* __restrict__ p_x0, float* __restrict__ p_fy,
                 float* __restrict__ p_fx) {
  const int bin = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (bin >= R * S * S) return;               // whole warps leave together
  const int r = bin / (S * S), i = (bin / S) % S, j = bin % S;
  const float4 b = boxes[r];                  // (y1, x1, y2, x2), one load for the warp
  const float area = __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 1.f), fmaxf(__fsub_rn(b.w, b.y), 1.f));
  const int L = (area >= LEVEL_AREA[0]) + (area >= LEVEL_AREA[1]) + (area >= LEVEL_AREA[2]);
  const float inv_stride = L == 0 ? 0.25f : L == 1 ? 0.125f : L == 2 ? 0.0625f : 0.03125f;
  const int off = pick(L, lv.off0, lv.off1, lv.off2, lv.off3);
  const int h = pick(L, lv.h0, lv.h1, lv.h2, lv.h3), w = pick(L, lv.w0, lv.w1, lv.w2, lv.w3);
  // every lane computes the bin's sample row and column (no shuffle, no barrier)
  const float cy = sample(b.x, b.z, i, S, step, inv_stride);
  const float cx = sample(b.y, b.w, j, S, step, inv_stride);
  const float fy0 = floorf(cy), fx0 = floorf(cx);
  const int yi = static_cast<int>(fy0), xi = static_cast<int>(fx0);
  const float wy = __fsub_rn(cy, fy0), wx = __fsub_rn(cx, fx0);
  if (p_info != nullptr) {                    // the prologue, each value once
    if (j == 0 && lane == 0) { p_y0[r * S + i] = yi; p_fy[r * S + i] = wy; }
    if (i == 0 && lane == 1) { p_x0[r * S + j] = xi; p_fx[r * S + j] = wx; }
    if (i == 0 && j == 0 && lane == 2) {
      p_info[3 * r] = off;
      p_info[3 * r + 1] = h;
      p_info[3 * r + 2] = w;
    }
  }
  const float oy = __fsub_rn(1.f, wy), ox = __fsub_rn(1.f, wx);
  const int ya = clip(yi, h - 1), yb = clip(yi + 1, h - 1);
  const int xa = clip(xi, w - 1), xb = clip(xi + 1, w - 1);
  const float4* p00 = flat + static_cast<size_t>(off + ya * w + xa) * c4;
  const float4* p01 = flat + static_cast<size_t>(off + ya * w + xb) * c4;
  const float4* p10 = flat + static_cast<size_t>(off + yb * w + xa) * c4;
  const float4* p11 = flat + static_cast<size_t>(off + yb * w + xb) * c4;
  float4* o = out + static_cast<size_t>(bin) * c4;
  for (int k = lane; k < c4; k += 32) {
    const float4 a = __ldg(p00 + k), bb = __ldg(p01 + k), d = __ldg(p10 + k), e = __ldg(p11 + k);
    float4 v;
    v.x = blend(a.x, bb.x, d.x, e.x, oy, wy, ox, wx);
    v.y = blend(a.y, bb.y, d.y, e.y, oy, wy, ox, wx);
    v.z = blend(a.z, bb.z, d.z, e.z, oy, wy, ox, wx);
    v.w = blend(a.w, bb.w, d.w, e.w, oy, wy, ox, wx);
    o[k] = v;
  }
}

}  // namespace

// flat [S_total, C] f32 (16-byte aligned, C a multiple of 4, S_total the
// sum of h * w); boxes [R, 4] f32 (16-byte aligned); step: the float32
// 1 / (S - 1) (any value when S = 1); hw: the four levels' h, w; out [R, S,
// S, C] f32. info [R, 3] int32 (level offset in rows, h, w), y0, fy, x0, fx
// [R, S]: the prologue, written when info is not null.
extern "C" int roi_align_launch(const void* flat, int C, const void* boxes, int R, int S,
                                float step, int h2, int w2, int h3, int w3, int h4, int w4,
                                int h5, int w5, void* out, void* info, void* y0, void* x0,
                                void* fy, void* fx, int device, void* stream) {
  if (C % 4 || R < 0 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(device);
  const Levels lv = {0, h2 * w2, h2 * w2 + h3 * w3, h2 * w2 + h3 * w3 + h4 * w4,
                     h2, h3, h4, h5, w2, w3, w4, w5};
  const long long warps = static_cast<long long>(R) * S * S;
  const int blocks = static_cast<int>((warps * 32 + THREADS - 1) / THREADS);
  roi_align_kernel<<<blocks, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(flat), C / 4, static_cast<const float4*>(boxes), lv, R, S,
      step, static_cast<float4*>(out), static_cast<int*>(info), static_cast<int*>(y0),
      static_cast<int*>(x0), static_cast<float*>(fy), static_cast<float*>(fx));
  return static_cast<int>(cudaGetLastError());
}
