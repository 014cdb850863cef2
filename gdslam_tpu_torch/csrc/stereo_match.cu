// Rectified stereo matching for Hopper (sm_90a).
//
// Replaces the program that XLA fuses in the JAX package:
// `stereo_match`, gdslam_tpu/ops/stereo.py:28 (there is no Pallas kernel for
// it). Plain twin: gdslam_tpu_torch/ops/stereo.py stereo_match_plain. One
// call per stereo frame, left keypoints x right keypoints (2000 x 2000 at
// KITTI's settings).
//
// What it computes. For each left keypoint i, over every right keypoint j
// with both valid, |vL - vR| <= band[level_i], -1 <= uL - uR <= b_over and
// |level_i - level_j| <= 1: the least Hamming distance of the two 256-bit
// descriptors, and the lowest j reaching it (jnp.argmin's rule). Under 75 it
// is a match; then 11 SADs of the left 11x11 patch (centred at round(uv),
// pixels outside the image are 0) against the right window slid -5..5 px
// around round(uR), the lowest offset of least SAD, and a parabola through
// it and its neighbours (clipped to +-1, only at interior offsets) refine
// uR. A disparity in (0.1, b_over] gives ur = uR and depth = bf / disparity;
// anything else -1 and 0.
//
// What bounds it on this card. The inputs are a few tens of KB of keypoints
// and, for the matched keypoints, their patches; the work is N x M gate
// tests, a 256-bit popcount for each pair inside the gates (the row band
// keeps a few per cent of them) and 121 x 11 absolute differences per match.
// Both are microseconds at the card's rates; the simple design below is
// bound by the latency of its per-warp loops, not by either.
//
// Design (simple first). One warp per left keypoint: lanes stride over the
// right keypoints in order, test the gates first and load a descriptor only
// for a pair inside them, keep their own (cost, j) minimum, and a shuffle
// reduction takes the least cost, the lowest j among equals. The same warp
// then computes the 11 SADs, one lane per offset; each SAD sums every window
// row left to right and then the rows top to bottom, the order the plain
// twin repeats, and the parabola's products and sums are single IEEE
// roundings (the file is built with -fmad=false), so the outputs equal the
// twin's to the bit. Bucketing the right keypoints by row band in shared
// memory is later work (ROADMAP.md section 2).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int WARPS = 8;                     // left keypoints per block
constexpr int SAD_HALF = 5;
constexpr int SLIDE = 5;
constexpr int N_OFF = 2 * SLIDE + 1;
constexpr int TH_ORB_DIST = 75;
constexpr int BIG = 1 << 20;
constexpr int BAND_LEVELS = 32;

struct DeviceGuard {                          // the launch goes to `device`
  int prev = -1;
  explicit DeviceGuard(int device) {
    cudaGetDevice(&prev);
    if (prev != device) cudaSetDevice(device); else prev = -1;
  }
  ~DeviceGuard() { if (prev >= 0) cudaSetDevice(prev); }
};

__device__ __forceinline__ float pixel(const float* img, int h, int w, int y, int x) {
  return (y >= 0 && y < h && x >= 0 && x < w) ? img[y * w + x] : 0.f;
}

__device__ __forceinline__ int hamming(const uint4 a0, const uint4 a1, const uint4* b) {
  const uint4 b0 = b[0], b1 = b[1];
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
         __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) + __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

__global__ void __launch_bounds__(WARPS * 32)
stereo_kernel(const float2* __restrict__ l_uv, const int* __restrict__ l_level,
              const uint4* __restrict__ l_desc, const unsigned char* __restrict__ l_valid, int n,
              const float2* __restrict__ r_uv, const int* __restrict__ r_level,
              const uint4* __restrict__ r_desc, const unsigned char* __restrict__ r_valid, int m,
              const float* __restrict__ band_tab, const float* __restrict__ img_l,
              const float* __restrict__ img_r, int h, int w, float bf, float b_over,
              float* __restrict__ ur_out, float* __restrict__ depth_out) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i >= n) return;                         // whole warps leave together

  const float2 luv = l_uv[i];
  const int llv = l_level[i];
  const bool lok = l_valid[i] != 0;
  const float band = band_tab[min(max(llv, 0), BAND_LEVELS - 1)];
  const uint4 a0 = l_desc[2 * i], a1 = l_desc[2 * i + 1];

  // the coarse match: least cost, lowest j among equals
  int best = BIG, arg = INT_MAX;
  if (lok) {
    for (int j = lane; j < m; j += 32) {
      const float2 ruv = r_uv[j];
      const float disp = __fsub_rn(luv.x, ruv.x);
      const bool in = r_valid[j] != 0 && fabsf(__fsub_rn(luv.y, ruv.y)) <= band &&
                      disp >= -1.f && disp <= b_over && abs(llv - r_level[j]) <= 1;
      if (in) {
        const int c = hamming(a0, a1, r_desc + 2 * j);
        if (c < best) { best = c; arg = j; }
      }
    }
  }
  for (int off = 16; off; off >>= 1) {
    const int b2 = __shfl_xor_sync(0xffffffffu, best, off);
    const int a2 = __shfl_xor_sync(0xffffffffu, arg, off);
    if (b2 < best || (b2 == best && a2 < arg)) { best = b2; arg = a2; }
  }
  if (best >= TH_ORB_DIST) {                  // unmatched: its index is immaterial
    if (lane == 0) { ur_out[i] = -1.f; depth_out[i] = 0.f; }
    return;
  }

  const float uR0 = r_uv[arg].x;
  float uR = uR0;
  if (img_l != nullptr) {
    // lane k < 11: the SAD at offset k - 5, rows summed left to right, then
    // the rows top to bottom
    const int uc = static_cast<int>(rintf(luv.x)), vc = static_cast<int>(rintf(luv.y));
    const int rc = static_cast<int>(rintf(uR0));
    float sad = 0.f;
    if (lane < N_OFF) {
      const int x0 = rc + (lane - SLIDE) - SAD_HALF;
      for (int r = 0; r <= 2 * SAD_HALF; ++r) {
        const int y = vc - SAD_HALF + r;
        float row = 0.f;
        for (int c = 0; c <= 2 * SAD_HALF; ++c) {
          const float d = fabsf(__fsub_rn(pixel(img_r, h, w, y, x0 + c),
                                          pixel(img_l, h, w, y, uc - SAD_HALF + c)));
          row = c == 0 ? d : __fadd_rn(row, d);
        }
        sad = r == 0 ? row : __fadd_rn(sad, row);
      }
    }
    float s[N_OFF];
#pragma unroll
    for (int k = 0; k < N_OFF; ++k) s[k] = __shfl_sync(0xffffffffu, sad, k);
    int kb = 0;
#pragma unroll
    for (int k = 1; k < N_OFF; ++k)
      if (s[k] < s[kb]) kb = k;
    const bool interior = kb > 0 && kb < 2 * SLIDE;
    const int km = min(max(kb, 1), 2 * SLIDE - 1);
    const float s_m1 = s[km - 1], s_0 = s[km], s_p1 = s[km + 1];
    const float denom = fmaxf(__fadd_rn(__fsub_rn(s_m1, __fmul_rn(2.f, s_0)), s_p1), 1e-6f);
    const float delta = fminf(fmaxf(__fdiv_rn(__fmul_rn(0.5f, __fsub_rn(s_m1, s_p1)), denom),
                                    -1.f), 1.f);
    const float refine = __fadd_rn(static_cast<float>(km - SLIDE), interior ? delta : 0.f);
    uR = __fadd_rn(uR0, refine);
  }
  if (lane == 0) {
    const float disparity = __fsub_rn(luv.x, uR);
    const bool ok = disparity > 0.1f && disparity <= b_over;
    ur_out[i] = ok ? uR : -1.f;
    depth_out[i] = ok ? __fdiv_rn(bf, fmaxf(disparity, 1e-6f)) : 0.f;
  }
}

}  // namespace

// l_uv [n, 2] f32 (8-byte aligned), l_level [n] int32, l_desc [n, 32] uint8
// (16-byte aligned), l_valid [n] bool; r_* likewise with m rows; band_tab
// [32] f32; img_l, img_r [h, w] f32, or both null (no SAD refinement);
// ur, depth [n] f32.
extern "C" int stereo_match_launch(const void* l_uv, const void* l_level, const void* l_desc,
                                   const void* l_valid, int n, const void* r_uv,
                                   const void* r_level, const void* r_desc, const void* r_valid,
                                   int m, const void* band_tab, const void* img_l,
                                   const void* img_r, int h, int w, float bf, float b_over,
                                   void* ur, void* depth, int device, void* stream) {
  if (n < 0 || m < 0 || ((img_l == nullptr) != (img_r == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(device);
  const int blocks = (n + WARPS - 1) / WARPS;
  stereo_kernel<<<blocks, WARPS * 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(l_uv), static_cast<const int*>(l_level),
      static_cast<const uint4*>(l_desc), static_cast<const unsigned char*>(l_valid), n,
      static_cast<const float2*>(r_uv), static_cast<const int*>(r_level),
      static_cast<const uint4*>(r_desc), static_cast<const unsigned char*>(r_valid), m,
      static_cast<const float*>(band_tab), static_cast<const float*>(img_l),
      static_cast<const float*>(img_r), h, w, bf, b_over, static_cast<float*>(ur),
      static_cast<float*>(depth));
  return static_cast<int>(cudaGetLastError());
}
