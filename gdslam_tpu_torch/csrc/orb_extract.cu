// The ORB front end's per-level work for Hopper (sm_90a): four kernels.
//
// Replaces the program that XLA fuses in the JAX package's
// `frontend/extractor.extract` (gdslam_tpu/frontend/extractor.py:74; there is
// no Pallas kernel for it): `ops/fast.fast_strength` (:59) and `nms3x3`
// (:98), the per-cell fallback and `_level_candidates` (extractor.py:50,
// :97), the per-level `lax.top_k` quota (:118-123), `ops/image.gaussian_blur`
// (:32) and `ops/orb` `extract_patches`, `ic_angle_from_patches`,
// `brief_from_patches`, `pack_bits` (:63, :100, :140, :168). Plain twins:
// gdslam_tpu_torch/ops/orb_kernel.py fast_cells_plain, quota_select_plain,
// describe_plain and ops/image.py gaussian_blur. Every product and sum that
// can round is one IEEE rounding (the __f*_rn intrinsics, built with
// -fmad=false), in the twins' order, so all four equal their twins bit for
// bit.
//
// The pyramid lives in one [L, H, W] float32 canvas: level l fills its top
// left (h_l, w_l), the rest is zero. At 480 x 640 with 8 levels the levels
// hold 3632 cells of 16 x 16 px, 7264 candidates, 1500 keypoints.
//
// (1) orb_fast_cells: one CTA of 256 threads per (level, 16 x 16 cell), all
// levels in one launch. The cell and a 4-px halo (24 x 24, indices taken
// modulo the level's own (h, w), as torch.roll wraps) are staged in shared
// memory; the FAST-9/16 strength (the max over the 16 circular 9-arcs of
// the min of tap - centre, and of centre - tap; 0 within 3 px of the
// level's border) on the cell and a 1-px halo, thresholded at th_hi and
// th_lo with `>`; a strict 3x3 non-maximum suppression of each on the cell;
// has_hi = any suppressed high score in the cell (before the edge mask); the
// high map where has_hi, else the low one; 0 within EDGE = 16 px of the
// level's border; then the cell's top two (a block argmax twice, larger
// score first, the lower in-cell index y * 16 + x among ties: the order of
// a stable descending sort). An all-zero cell gives (0, index 0) and (0,
// index 1). Bound: ~200 min / max / compare operations a pixel over the
// ~1.0 M level pixels (~6 us on the FP32 pipes), 4 bytes a pixel read.
//
// (2) orb_quota_select: one CTA of 1024 threads per level. The level's
// candidates as 64-bit keys (the score's bits in an order-preserving
// transform over the index's complement, -0 taken as +0) in shared memory,
// a bitonic sort descending: the order of torch.sort(descending, stable).
// The first k rows (the level's quota) give the response, the level
// coordinates, the level-0 uv = uv_lv * scale_l (one f32 product), the level
// and valid = response > 0; rows past the level's candidates (a small
// image's top levels) take response 0 and candidate 0's uv, as the twin's
// zero-padded indices do. Up to MAX_CAND candidates a level (the stereo
// cell's 1241 x 376 level 0 has 3542): 128 KB of shared memory at most.
//
// (3) gaussian_blur7: the separable 7-tap blur of the whole canvas, one CTA
// per 32 x 16 output tile of a level plane, the tile and a 3-px halo
// (numpy "reflect" at the canvas's edges) in shared memory; the vertical
// pass on the tile's 38 columns, then the horizontal pass, each tap added
// in order, acc = acc + x * k[i], product and sum rounded apart. Both
// passes' intermediate values are float32 either way, so one kernel is the
// twin's two passes to the bit. Bound: 8 bytes a pixel (read, write).
//
// (4) orb_describe: one warp per keypoint. Lane r < 31 sums row r of the
// 31 x 31 disc of the raw level around round(uv_lv) (zeros outside the
// canvas): (pixel * mask) * dx (and * dy), the 31 columns in order; then
// every lane adds the 31 row sums in order (shuffles): the twin's order.
// The angle is atan2f(m01, m10) (the CUDA library's, torch.atan2's); its
// bin rint(angle * RCP) mod 30 with RCP the float32 reciprocal of the bin
// width (the product XLA makes of the JAX package's division); lane j then
// makes descriptor byte j from 8 tests I(tap 2i) < I(tap 2i + 1) of the
// blurred level at the bin's rotated pattern (zeros outside the canvas).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int CELL = 16;                      // candidate cell (px), two kept a cell
constexpr int EDGE = 16;                      // extractor.EDGE_MARGIN
constexpr int HALO = 4;                       // FAST's radius 3 + the NMS's 1
constexpr int TILE = CELL + 2 * HALO;         // 24: the staged cell
constexpr int SPAN = CELL + 2;                // 18: the strengths the NMS reads
constexpr int MAX_CAND = 16384;               // candidates a level: 128 KB of keys
constexpr int SORT_T = 1024;                  // quota_select's threads
constexpr int BX = 32, BY = 16, R = 3;        // blur tile and radius
constexpr int PATCH_HALF = 15;                // the IC disc's radius
constexpr int EXT = 37;                       // the rBRIEF patch's side
constexpr int N_BINS = 30;
constexpr int DESC_WARPS = 4;

// the Bresenham circle of radius 3, clockwise from 12 o'clock (dy, dx)
__constant__ int c_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int c_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

struct Levels {
  int n;                                      // levels
  int h[MAX_LEVELS], w[MAX_LEVELS];           // each level's size
  int cell0[MAX_LEVELS + 1];                  // its first cell; cell0[n] = all cells
  int row0[MAX_LEVELS + 1];                   // its first output row; row0[n] = N
  float scale[MAX_LEVELS];                    // float32(scale_factor ** l)
};

struct Taps7 { float k[7]; };

struct DeviceGuard {                          // the launch goes to `device`
  int prev = -1;
  explicit DeviceGuard(int device) {
    cudaGetDevice(&prev);
    if (prev != device) cudaSetDevice(device); else prev = -1;
  }
  ~DeviceGuard() { if (prev >= 0) cudaSetDevice(prev); }
};

__device__ __forceinline__ int wrap(int i, int n) {  // i mod n in [0, n)
  i %= n;
  return i < 0 ? i + n : i;
}

// (v, i) beats (bv, bi): larger, or equal with a lower index
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// ----------------------------------------------------------------------------
// (1) FAST cells
// ----------------------------------------------------------------------------

// FAST-9/16 strength at tile (y, x): max over the 16 circular 9-arcs of the
// min of the arc's differences, for tap - centre and for centre - tap
__device__ __forceinline__ float fast_strength(const float (*s)[TILE + 1], int y, int x) {
  const float c = s[y][x];
  float d[16], e[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float t = s[y + c_dy[k]][x + c_dx[k]];
    d[k] = __fsub_rn(t, c);
    e[k] = __fsub_rn(c, t);
  }
  float bd = -INFINITY, be = -INFINITY;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    float md = d[k], me = e[k];
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      md = fminf(md, d[(k + j) & 15]);
      me = fminf(me, e[(k + j) & 15]);
    }
    bd = fmaxf(bd, md);
    be = fmaxf(be, me);
  }
  return fmaxf(bd, be);
}

// strict 3x3 non-maximum suppression at (y, x) of the span
__device__ __forceinline__ float nms3x3(const float (*s)[SPAN + 1], int y, int x) {
  float m = s[y - 1][x - 1];
  m = fmaxf(m, s[y - 1][x]);
  m = fmaxf(m, s[y - 1][x + 1]);
  m = fmaxf(m, s[y][x - 1]);
  m = fmaxf(m, s[y][x + 1]);
  m = fmaxf(m, s[y + 1][x - 1]);
  m = fmaxf(m, s[y + 1][x]);
  m = fmaxf(m, s[y + 1][x + 1]);
  const float v = s[y][x];
  return v > m ? v : 0.0f;
}

// the block's best (v, i) by `beats`, on every thread (256 threads)
__device__ __forceinline__ void block_best(float v, int i, float* s_v, int* s_i, float& bv,
                                           int& bi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {          // every lane shuffles, then compares
    const float ov = __shfl_xor_sync(0xFFFFFFFFu, v, s);
    const int oi = __shfl_xor_sync(0xFFFFFFFFu, i, s);
    if (beats(ov, oi, v, i)) { v = ov; i = oi; }
  }
  if (lane == 0) { s_v[warp] = v; s_i[warp] = i; }
  __syncthreads();
  bv = s_v[0];
  bi = s_i[0];
#pragma unroll
  for (int w = 1; w < 8; ++w)
    if (beats(s_v[w], s_i[w], bv, bi)) { bv = s_v[w]; bi = s_i[w]; }
  __syncthreads();                            // s_v, s_i free again
}

__global__ void __launch_bounds__(256)
fast_cells_kernel(const float* __restrict__ canvas, int H, int W, Levels L, float th_hi,
                  float th_lo, float* __restrict__ scores, float* __restrict__ uv) {
  __shared__ float s_img[TILE][TILE + 1];
  __shared__ float s_hi[SPAN][SPAN + 1];
  __shared__ float s_lo[SPAN][SPAN + 1];
  __shared__ float s_v[8];
  __shared__ int s_i[8];
  const int b = blockIdx.x, tid = threadIdx.x;
  int lv = 0;
  while (lv + 1 < L.n && L.cell0[lv + 1] <= b) ++lv;
  const int h = L.h[lv], w = L.w[lv], wc = w / CELL;
  const int c = b - L.cell0[lv], cy = c / wc, cx = c % wc;
  const float* img = canvas + static_cast<size_t>(lv) * H * W;
  const int y0 = cy * CELL - HALO, x0 = cx * CELL - HALO;

  for (int i = tid; i < TILE * TILE; i += 256) {
    const int r = i / TILE, q = i % TILE;
    s_img[r][q] = img[wrap(y0 + r, h) * W + wrap(x0 + q, w)];
  }
  __syncthreads();
  for (int i = tid; i < SPAN * SPAN; i += 256) {
    const int r = i / SPAN, q = i % SPAN;     // tile (r + 3, q + 3)
    const int py = wrap(y0 + 3 + r, h), px = wrap(x0 + 3 + q, w);
    float s = 0.0f;
    if (py >= 3 && py < h - 3 && px >= 3 && px < w - 3) s = fast_strength(s_img, r + 3, q + 3);
    s_hi[r][q] = s > th_hi ? s : 0.0f;
    s_lo[r][q] = s > th_lo ? s : 0.0f;
  }
  __syncthreads();
  const int ty = tid >> 4, tx = tid & 15;
  const float hi = nms3x3(s_hi, ty + 1, tx + 1), lo = nms3x3(s_lo, ty + 1, tx + 1);
  const bool has_hi = __syncthreads_or(hi > 0.0f);
  const int y = cy * CELL + ty, x = cx * CELL + tx;
  const bool ok = y >= EDGE && y < h - EDGE && x >= EDGE && x < w - EDGE;
  const float v = ok ? (has_hi ? hi : lo) : 0.0f;

  float v1, v2;
  int i1, i2;
  block_best(v, tid, s_v, s_i, v1, i1);
  block_best(tid == i1 ? -INFINITY : v, tid, s_v, s_i, v2, i2);
  if (tid < 2) {
    const int j = 2 * b + tid, idx = tid == 0 ? i1 : i2;
    scores[j] = tid == 0 ? v1 : v2;
    uv[2 * j] = static_cast<float>(cx * CELL + (idx & 15));
    uv[2 * j + 1] = static_cast<float>(cy * CELL + (idx >> 4));
  }
}

// ----------------------------------------------------------------------------
// (2) the per-level quota
// ----------------------------------------------------------------------------

// the score's bits, ordered as the floats are (-0 as +0), over the index's
// complement: a larger key is a larger score, or an equal one of lower index
__device__ __forceinline__ unsigned long long sort_key(float s, int i) {
  if (s == 0.0f) s = 0.0f;
  uint32_t u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | (0xFFFFFFFFu - static_cast<uint32_t>(i));
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  uint32_t u = static_cast<uint32_t>(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
  return __uint_as_float(u);
}

__global__ void __launch_bounds__(SORT_T)
quota_select_kernel(const float* __restrict__ scores, const float* __restrict__ cand_uv,
                    Levels L, float* __restrict__ response, float* __restrict__ uv_lv,
                    float* __restrict__ uv, int* __restrict__ level, bool* __restrict__ valid) {
  extern __shared__ unsigned long long s_key[];
  const int lv = blockIdx.x, tid = threadIdx.x;
  const int first = 2 * L.cell0[lv], n = 2 * (L.cell0[lv + 1] - L.cell0[lv]);
  const int k = L.row0[lv + 1] - L.row0[lv], row0 = L.row0[lv];
  if (k == 0) return;
  int P = 1;
  while (P < n) P <<= 1;
  for (int i = tid; i < P; i += SORT_T)       // padding (key 0) sorts after every candidate
    s_key[i] = i < n ? sort_key(scores[first + i], i) : 0ull;
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < P / 2; t += SORT_T) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1)), l = i + j;
        const unsigned long long a = s_key[i], c = s_key[l];
        if ((i & size) == 0 ? a < c : a > c) { s_key[i] = c; s_key[l] = a; }   // descending
      }
      __syncthreads();
    }
  }
  const int k_eff = k < n ? k : n;
  const float sc = L.scale[lv];
  for (int r = tid; r < k; r += SORT_T) {
    float s = 0.0f;
    int idx = 0;                              // rows past the candidates: candidate 0
    if (r < k_eff) {
      const unsigned long long key = s_key[r];
      s = key_score(key);
      idx = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
    }
    const float u = cand_uv[2 * (first + idx)], v = cand_uv[2 * (first + idx) + 1];
    const int o = row0 + r;
    response[o] = s;
    uv_lv[2 * o] = u;
    uv_lv[2 * o + 1] = v;
    uv[2 * o] = __fmul_rn(u, sc);
    uv[2 * o + 1] = __fmul_rn(v, sc);
    level[o] = lv;
    valid[o] = s > 0.0f;
  }
}

// ----------------------------------------------------------------------------
// (3) the 7-tap Gaussian blur
// ----------------------------------------------------------------------------

__device__ __forceinline__ int reflect(int i, int n) {  // numpy "reflect", clamped past it
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__global__ void __launch_bounds__(BX * 8)
blur7_kernel(const float* __restrict__ in, float* __restrict__ out, int H, int W, Taps7 k) {
  __shared__ float s_in[BY + 2 * R][BX + 2 * R];
  __shared__ float s_v[BY][BX + 2 * R];
  const int tid = threadIdx.x, nt = BX * 8;
  const size_t plane = static_cast<size_t>(blockIdx.z) * H * W;
  const int x0 = blockIdx.x * BX, y0 = blockIdx.y * BY;
  for (int i = tid; i < (BY + 2 * R) * (BX + 2 * R); i += nt) {
    const int r = i / (BX + 2 * R), q = i % (BX + 2 * R);
    s_in[r][q] = in[plane + reflect(y0 - R + r, H) * W + reflect(x0 - R + q, W)];
  }
  __syncthreads();
  for (int i = tid; i < BY * (BX + 2 * R); i += nt) {   // vertical: rows r .. r + 6
    const int r = i / (BX + 2 * R), q = i % (BX + 2 * R);
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < 7; ++t) acc = __fadd_rn(acc, __fmul_rn(s_in[r + t][q], k.k[t]));
    s_v[r][q] = acc;
  }
  __syncthreads();
  for (int i = tid; i < BY * BX; i += nt) {             // horizontal: columns q .. q + 6
    const int r = i / BX, q = i % BX;
    if (y0 + r >= H || x0 + q >= W) continue;
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < 7; ++t) acc = __fadd_rn(acc, __fmul_rn(s_v[r][q + t], k.k[t]));
    out[plane + static_cast<size_t>(y0 + r) * W + x0 + q] = acc;
  }
}

// ----------------------------------------------------------------------------
// (4) the IC angle and rBRIEF
// ----------------------------------------------------------------------------

// round_half_even(a * rcp_bin) mod 30
__device__ __forceinline__ int angle_bin(float a, float rcp_bin) {
  const int b = static_cast<int>(rintf(__fmul_rn(a, rcp_bin))) % N_BINS;
  return b < 0 ? b + N_BINS : b;
}

__global__ void __launch_bounds__(DESC_WARPS * 32)
describe_kernel(const float* __restrict__ canvas, const float* __restrict__ blurred, int H,
                int W, const float* __restrict__ uv_lv, const int* __restrict__ level, int N,
                const int* __restrict__ taps, float rcp_bin, float* __restrict__ angle,
                uint8_t* __restrict__ desc) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * DESC_WARPS + (threadIdx.x >> 5);
  if (n >= N) return;                         // whole warps only
  const int u = static_cast<int>(rintf(uv_lv[2 * n]));
  const int v = static_cast<int>(rintf(uv_lv[2 * n + 1]));
  const size_t plane = static_cast<size_t>(level[n]) * H * W;
  const float* img = canvas + plane;

  float rx = 0.0f, ry = 0.0f;                 // lane r: row dy = r - 15 of the disc
  if (lane < 2 * PATCH_HALF + 1) {
    const int dy = lane - PATCH_HALF, row = v + dy;
    const bool row_in = row >= 0 && row < H;
    const float fy = static_cast<float>(dy);
#pragma unroll
    for (int j = 0; j < 2 * PATCH_HALF + 1; ++j) {
      const int dx = j - PATCH_HALF, col = u + dx;
      const float p = (row_in && col >= 0 && col < W) ? img[row * W + col] : 0.0f;
      const float wgt = __fmul_rn(p, dx * dx + dy * dy <= PATCH_HALF * PATCH_HALF ? 1.0f : 0.0f);
      const float px = __fmul_rn(wgt, static_cast<float>(dx)), py = __fmul_rn(wgt, fy);
      rx = j == 0 ? px : __fadd_rn(rx, px);
      ry = j == 0 ? py : __fadd_rn(ry, py);
    }
  }
  float m10 = __shfl_sync(0xFFFFFFFFu, rx, 0), m01 = __shfl_sync(0xFFFFFFFFu, ry, 0);
#pragma unroll
  for (int r = 1; r < 2 * PATCH_HALF + 1; ++r) {
    m10 = __fadd_rn(m10, __shfl_sync(0xFFFFFFFFu, rx, r));
    m01 = __fadd_rn(m01, __shfl_sync(0xFFFFFFFFu, ry, r));
  }
  const float a = atan2f(m01, m10);
  const int bin = angle_bin(a, rcp_bin);

  const float* blr = blurred + plane;
  const int* tp = taps + bin * 512 + lane * 16;
  uint32_t byte = 0u;
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {         // bit i = 8 lane + bit: tap 2i against 2i + 1
    float p[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int f = tp[2 * bit + s];
      const int row = v + f / EXT - EXT / 2, col = u + f % EXT - EXT / 2;
      p[s] = (row >= 0 && row < H && col >= 0 && col < W) ? blr[row * W + col] : 0.0f;
    }
    byte |= (p[0] < p[1] ? 1u : 0u) << bit;
  }
  desc[static_cast<size_t>(n) * 32 + lane] = static_cast<uint8_t>(byte);
  if (lane == 0) angle[n] = a;
}

// describe_kernel's atan2f and its bin, on given values (for the tests)
__global__ void angle_bins_kernel(const float* __restrict__ m10, const float* __restrict__ m01,
                                  const float* __restrict__ angle_in, int n, float rcp_bin,
                                  float* __restrict__ angle, int* __restrict__ bin) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  angle[i] = atan2f(m01[i], m10[i]);
  bin[i] = angle_bin(angle_in[i], rcp_bin);
}

Levels make_levels(int n_levels, const int* hs, const int* ws, const int* quotas,
                   const float* scales) {
  Levels L{};
  L.n = n_levels;
  L.cell0[0] = L.row0[0] = 0;
  for (int l = 0; l < n_levels; ++l) {
    L.h[l] = hs[l];
    L.w[l] = ws[l];
    L.cell0[l + 1] = L.cell0[l] + (hs[l] / CELL) * (ws[l] / CELL);
    L.row0[l + 1] = L.row0[l] + (quotas != nullptr ? quotas[l] : 0);
    L.scale[l] = scales != nullptr ? scales[l] : 1.0f;
  }
  return L;
}

bool levels_ok(int n_levels, const int* hs, const int* ws, int H, int W) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return false;
  for (int l = 0; l < n_levels; ++l)
    if (hs[l] < 1 || ws[l] < 1 || hs[l] > H || ws[l] > W) return false;
  return true;
}

}  // namespace

// canvas [L, H, W] f32; hs, ws: host arrays of the n_levels levels' sizes;
// scores [C] f32 and uv [C, 2] f32 out, C = 2 x the levels' cells.
extern "C" int orb_fast_cells_launch(const void* canvas, int H, int W, int n_levels,
                                     const int* hs, const int* ws, float th_hi, float th_lo,
                                     void* scores, void* uv, int device, void* stream) {
  if (!levels_ok(n_levels, hs, ws, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  const Levels L = make_levels(n_levels, hs, ws, nullptr, nullptr);
  if (L.cell0[n_levels] == 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(device);
  fast_cells_kernel<<<L.cell0[n_levels], 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(canvas), H, W, L, th_hi, th_lo, static_cast<float*>(scores),
      static_cast<float*>(uv));
  return static_cast<int>(cudaGetLastError());
}

// scores [C] f32, cand_uv [C, 2] f32 (orb_fast_cells' order); quotas, scales:
// host arrays; response [N] f32, uv_lv [N, 2] f32, uv [N, 2] f32, level [N]
// int32, valid [N] bool out, N = the quotas' sum.
extern "C" int orb_quota_select_launch(const void* scores, const void* cand_uv, int n_levels,
                                       const int* hs, const int* ws, const int* quotas,
                                       const float* scales, void* response, void* uv_lv,
                                       void* uv, void* level, void* valid, int device,
                                       void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return static_cast<int>(cudaErrorInvalidValue);
  const Levels L = make_levels(n_levels, hs, ws, quotas, scales);
  int P_max = 1;
  for (int l = 0; l < n_levels; ++l) {
    const int n = 2 * (L.cell0[l + 1] - L.cell0[l]);
    if (n > MAX_CAND || (n == 0 && quotas[l] > 0) || quotas[l] < 0)
      return static_cast<int>(cudaErrorInvalidValue);
    while (P_max < n) P_max <<= 1;
  }
  if (L.row0[n_levels] == 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(device);
  const size_t smem = static_cast<size_t>(P_max) * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        quota_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  quota_select_kernel<<<n_levels, SORT_T, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const float*>(cand_uv), L,
      static_cast<float*>(response), static_cast<float*>(uv_lv), static_cast<float*>(uv),
      static_cast<int*>(level), static_cast<bool*>(valid));
  return static_cast<int>(cudaGetLastError());
}

// in, out [L, H, W] f32 (H, W >= 4); taps: host array of the 7 weights.
extern "C" int gaussian_blur7_launch(const void* in, void* out, int L, int H, int W,
                                     const float* taps, int device, void* stream) {
  if (L < 0 || H < R + 1 || W < R + 1) return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return static_cast<int>(cudaSuccess);
  Taps7 k;
  for (int t = 0; t < 7; ++t) k.k[t] = taps[t];
  DeviceGuard guard(device);
  const dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY, L);
  blur7_kernel<<<grid, BX * 8, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), H, W, k);
  return static_cast<int>(cudaGetLastError());
}

// canvas, blurred [L, H, W] f32; uv_lv [N, 2] f32 level coordinates; level
// [N] int32 in [0, L); taps [30, 512] int32 (flat indices into the 37 x 37
// patch); angle [N] f32 and desc [N, 32] uint8 out.
extern "C" int orb_describe_launch(const void* canvas, const void* blurred, int H, int W,
                                   const void* uv_lv, const void* level, int N, const void* taps,
                                   float rcp_bin, void* angle, void* desc, int device,
                                   void* stream) {
  if (N < 0 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(device);
  describe_kernel<<<(N + DESC_WARPS - 1) / DESC_WARPS, DESC_WARPS * 32, 0,
                    reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(canvas), static_cast<const float*>(blurred), H, W,
      static_cast<const float*>(uv_lv), static_cast<const int*>(level), N,
      static_cast<const int*>(taps), rcp_bin, static_cast<float*>(angle),
      static_cast<uint8_t*>(desc));
  return static_cast<int>(cudaGetLastError());
}

// m10, m01, angle_in [n] f32; angle [n] f32 = atan2f(m01, m10) and bin [n]
// int32 = the bin of angle_in, by orb_describe's own device code (for the
// tests: the moment pairs near the axes, the angles next to a bin edge).
extern "C" int orb_angle_bins_launch(const void* m10, const void* m01, const void* angle_in,
                                     int n, float rcp_bin, void* angle, void* bin, int device,
                                     void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(device);
  angle_bins_kernel<<<(n + 255) / 256, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m10), static_cast<const float*>(m01),
      static_cast<const float*>(angle_in), n, rcp_bin, static_cast<float*>(angle),
      static_cast<int*>(bin));
  return static_cast<int>(cudaGetLastError());
}
