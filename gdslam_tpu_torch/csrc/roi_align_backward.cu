// The gradient of ROIAlign with respect to the FPN levels, for Hopper (sm_90a):
// an ordered gather per target row, with no sort and no zero-fill.
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
// the column factor ((1 - fx) or fx), row_t the tap's sample row and column
// clamped to the box's level. Its transpose sends (g[r, i, j] * b_t) * a_t to
// flat[row_t]. The JAX transpose adds its four scatter-adds in the tap order
// (1, 1), (1, 0), (0, 1), (0, 0), and the plain twin sums one row's
// contributions in that order, then by (r, i, j): each tap's contributions
// serially into a partial sum, the partial sums added to the total in turn,
// the row's result total + partial. Single roundings throughout
// (__fmul_rn / __fadd_rn, and -fmad=false): the kernel equals the plain twin
// to the bit, and no float atomics: the same bits on every run.
//
// The same sums as a gather. For one target row, visiting (tap, r, i, j) in
// that nested order is the plain twin's order. For one box and tap the bins
// that land on a row are the i with yi(i) == row_y times the j with
// xi(j) == row_x, so the kernel keeps, per candidate (tap, box), a 32-bit
// mask of i for each row of its tile and one of j for each column, and walks
// their set bits in ascending order. (The forward's sample positions are
// monotone in i for any box, so each mask is an interval; nothing here
// depends on it.)
//
// Design. One CTA per TILE_H x TILE_W tile of one level's rows, 8 warps.
//   1. The CTA takes each box's range of sample rows and columns from the
//      forward's prologue (the taps' shift and clamp keep the order, so the
//      ranges of the four taps follow), and lists in (tap, box) order the
//      candidates whose range meets the tile, with their bin masks: one
//      thread per candidate, a block scan to compact them in order.
//   2. One warp per (row of the tile, 64 float4 of C), two float4 per lane:
//      the row's contributions are listed CAP at a time in the warp's shared
//      memory (32 candidates at a time, each lane writing its candidate's
//      (i, j) pairs at its scanned place, its factors already applied), then
//      summed in order with DEPTH cotangent rows loaded ahead. Every row of
//      the level is written, zeros included: the output needs no zero-fill.
//
// What bounds it on this card. Bytes: the cotangent [R, out, out, C] and the
// prologue read once and the gradient [S, C] written once (~19 MB at the mask
// head's shape, 5.8 us at HBM rate). What the time approaches instead: the
// cotangent rows reach the SMs once per tap from L2 (4 x 12.8 MB at the mask
// head's shape), and the tiles that the training ROIs cluster on hold most
// of the contributions (51 on the busiest row), so those CTAs run the
// longest at their SMs' L2 bandwidth. Small tiles spread them over more SMs;
// each CTA's list costs a few microseconds of latency, which larger tiles
// amortise: 2 x 4 was the fastest of the tiles tried (1 x 2 to 4 x 8, on
// recorded training calls). One launch per call.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int TILE_H = 2, TILE_W = 4;         // a CTA's tile of one level's rows
constexpr int PIXELS = TILE_H * TILE_W;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NV = 2;                         // float4 of C per lane
constexpr int DEPTH = 2;                      // contributions whose rows are loaded ahead
constexpr int CAP = 64;                       // contributions a warp lists before it sums them
constexpr int MAX_OUT = 32;                   // a box's bins along a side fit one 32-bit mask
constexpr int MAX_R = 1024;                   // the listed candidates fit shared memory
constexpr int ENTRY = 2 + TILE_H + TILE_W;    // words per listed candidate, below
constexpr unsigned FULL = 0xffffffffu;

// Shared memory: WARPS x CAP listed contributions, each an int4 (cotangent
// row, tap, a, b), a and b the row and column factors of its tap; then 4 R
// listed candidates of ENTRY words: [0] tap << 28 | r * o, [1] the tile's
// rows it touches (bit ty * TILE_W + tx), [2, 2 + TILE_H) the bins i of each
// tile row, [2 + TILE_H, ENTRY) the bins j of each tile column, as bit masks;
// then each box's range of sample rows and columns [R][4].

struct DeviceGuard {                          // the launch goes to `device`
  int prev = -1;
  explicit DeviceGuard(int device) {
    cudaGetDevice(&prev);
    if (prev != device) cudaSetDevice(device); else prev = -1;
  }
  ~DeviceGuard() { if (prev >= 0) cudaSetDevice(prev); }
};

struct Levels {                               // the four levels' (h, w)
  int h[4], w[4];
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

// the sample row (or column) v + d clamped to [0, n - 1], as tap_rows clamps
// it (d is 0 or 1; no overflow for any v; non-decreasing in v)
__device__ __forceinline__ int clamp_tap(int v, int d, int n) {
  return v >= n - d ? n - 1 : (v < -d ? 0 : v + d);
}

// the position of the n-th (from 0) set bit of m
__device__ __forceinline__ int nth_bit(uint32_t m, int n) {
  for (; n > 0; --n) m &= m - 1;
  return __ffs(m) - 1;
}

// One tile row's sum over one warp's 32 * NV float4 of C, in the plain
// twin's order: the contributions are listed CAP at a time in the warp's
// shared memory, then summed with DEPTH of them loaded ahead.
struct RowSum {
  const float4* grad;
  const float* fy;
  const float* fx;
  int4* seg;                                  // the warp's CAP listed contributions
  int c4, o, c, n = 0, group = -1;
  float4 total[NV], part[NV];

  // the contribution (head, i, j) as listed: its cotangent row, tap, factors
  __device__ __forceinline__ int4 make(uint32_t head, int i, int j) const {
    const int ro = static_cast<int>(head & 0x0fffffffu), tap = static_cast<int>(head >> 28);
    const float fa = __ldg(fy + ro + i), fb = __ldg(fx + ro + j);
    const float a = tap < 2 ? fa : __fsub_rn(1.f, fa);
    const float b = (tap & 1) == 0 ? fb : __fsub_rn(1.f, fb);
    return make_int4((ro + i) * o + j, tap, __float_as_int(a), __float_as_int(b));
  }

  __device__ __forceinline__ void load(int k, float4 (&g)[NV]) const {
    const float4* row = grad + static_cast<size_t>(seg[k].x) * c4 + c;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      g[v] = c + 32 * v < c4 ? __ldg(row + 32 * v) : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // sum the listed contributions in order and empty the list
  __device__ __forceinline__ void flush() {
    __syncwarp();
    float4 g[DEPTH][NV];
#pragma unroll
    for (int q = 0; q < DEPTH; ++q)
      if (q < n) load(q, g[q]);
    for (int base = 0; base < n; base += DEPTH) {
#pragma unroll
      for (int q = 0; q < DEPTH; ++q) {
        const int k = base + q;
        if (k < n) {
          const int4 e = seg[k];
          if (e.y != group) {                 // the next tap's scatter-add
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              if (group >= 0) total[v] = add4(total[v], part[v]);
              part[v] = make_float4(0.f, 0.f, 0.f, 0.f);
            }
            group = e.y;
          }
#pragma unroll
          for (int v = 0; v < NV; ++v)
            part[v] = add4(part[v], contribution(g[q][v], __int_as_float(e.z),
                                                 __int_as_float(e.w)));
          if (k + DEPTH < n) load(k + DEPTH, g[q]);
        }
      }
    }
    n = 0;
    __syncwarp();
  }
};

__global__ void __launch_bounds__(THREADS, 4)
roi_align_backward_kernel(const float4* __restrict__ grad, int c4, int R, int o,
                          const int* __restrict__ info, const int* __restrict__ y0,
                          const int* __restrict__ x0, const float* __restrict__ fy,
                          const float* __restrict__ fx, Levels lv, float4* __restrict__ out) {
  extern __shared__ int4 s_mem[];
  uint32_t* s_list = reinterpret_cast<uint32_t*>(s_mem + WARPS * CAP);
  int* s_range = reinterpret_cast<int*>(s_list + 4 * R * ENTRY);
  __shared__ int s_warp[WARPS];
  __shared__ int s_count;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // this CTA's level and tile
  int b = blockIdx.x, off = 0, h = lv.h[0], w = lv.w[0];
#pragma unroll
  for (int level = 1; level < 4; ++level) {
    const int tiles = (h + TILE_H - 1) / TILE_H * ((w + TILE_W - 1) / TILE_W);
    if (b < tiles) break;
    b -= tiles;
    off += h * w;
    h = lv.h[level];
    w = lv.w[level];
  }
  const int tiles_x = (w + TILE_W - 1) / TILE_W;
  const int ty0 = b / tiles_x * TILE_H, tx0 = b % tiles_x * TILE_W;

  // 1. the candidates (tap, box) that meet the tile, listed in (tap, box)
  //    order. First each box of the tile's level: the range of its sample
  //    rows and columns before the taps' shift and clamp.
  for (int r = threadIdx.x; r < R; r += THREADS) {
    if (__ldg(info + 3 * r) != off) continue;
    int ylo = INT_MAX, yhi = INT_MIN, xlo = INT_MAX, xhi = INT_MIN;
    for (int i = 0; i < o; ++i) {
      const int y = __ldg(y0 + r * o + i), x = __ldg(x0 + r * o + i);
      ylo = min(ylo, y);
      yhi = max(yhi, y);
      xlo = min(xlo, x);
      xhi = max(xhi, x);
    }
    s_range[4 * r] = ylo;
    s_range[4 * r + 1] = yhi;
    s_range[4 * r + 2] = xlo;
    s_range[4 * r + 3] = xhi;
  }
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  //    one thread per candidate: its tap's range against the tile, then its
  //    bins on the tile's rows and columns; a block scan lists it in order
  for (int first = 0; first < 4 * R; first += THREADS) {
    const int cand = first + threadIdx.x;
    uint32_t im[TILE_H], jm[TILE_W], pix = 0;
#pragma unroll
    for (int q = 0; q < TILE_H; ++q) im[q] = 0u;
#pragma unroll
    for (int q = 0; q < TILE_W; ++q) jm[q] = 0u;
    int tap = 0, r = 0;
    if (cand < 4 * R) {
      tap = cand / R;
      r = cand - tap * R;
      if (__ldg(info + 3 * r) == off) {       // the box's level is the tile's
        const int hr = __ldg(info + 3 * r + 1), wr = __ldg(info + 3 * r + 2);
        const int dy = tap < 2, dx = (tap & 1) == 0;
        const int* rg = s_range + 4 * r;
        if (clamp_tap(rg[0], dy, hr) < ty0 + TILE_H && clamp_tap(rg[1], dy, hr) >= ty0 &&
            clamp_tap(rg[2], dx, wr) < tx0 + TILE_W && clamp_tap(rg[3], dx, wr) >= tx0) {
          for (int i = 0; i < o; ++i) {
            const int ty = clamp_tap(__ldg(y0 + r * o + i), dy, hr) - ty0;
            const int tx = clamp_tap(__ldg(x0 + r * o + i), dx, wr) - tx0;
#pragma unroll
            for (int q = 0; q < TILE_H; ++q) im[q] |= static_cast<uint32_t>(ty == q) << i;
#pragma unroll
            for (int q = 0; q < TILE_W; ++q) jm[q] |= static_cast<uint32_t>(tx == q) << i;
          }
#pragma unroll
          for (int y = 0; y < TILE_H; ++y)
#pragma unroll
            for (int x = 0; x < TILE_W; ++x)
              pix |= static_cast<uint32_t>(im[y] != 0u && jm[x] != 0u) << (y * TILE_W + x);
        }
      }
    }
    const unsigned listed = __ballot_sync(FULL, pix != 0u);
    if (lane == 0) s_warp[warp] = __popc(listed);
    __syncthreads();
    int pos = s_count + __popc(listed & ((1u << lane) - 1u)), total = 0;
    for (int v = 0; v < WARPS; ++v) {
      const int nv = s_warp[v];
      if (v < warp) pos += nv;
      total += nv;
    }
    if (pix != 0u) {
      uint32_t* e = s_list + pos * ENTRY;
      e[0] = static_cast<uint32_t>(tap) << 28 | static_cast<uint32_t>(r * o);
      e[1] = pix;
#pragma unroll
      for (int q = 0; q < TILE_H; ++q) e[2 + q] = im[q];
#pragma unroll
      for (int q = 0; q < TILE_W; ++q) e[2 + TILE_H + q] = jm[q];
    }
    __syncthreads();
    if (threadIdx.x == 0) s_count += total;
    __syncthreads();
  }
  const int n_listed = s_count;

  // 2. one warp per (tile row, 32 * NV float4 of C): its contributions listed
  //    in order (32 candidates at a time, each lane writing its candidate's
  //    pairs (i, j) at its scanned place) and summed
  const int chunks = (c4 + 32 * NV - 1) / (32 * NV);
  for (int item = warp; item < PIXELS * chunks; item += WARPS) {
    const int pixel = item % PIXELS, chunk = item / PIXELS;
    const int ty = pixel / TILE_W, tx = pixel % TILE_W;
    if (ty0 + ty >= h || tx0 + tx >= w) continue;           // off the level's edge
    RowSum sum{grad, fy, fx, s_mem + warp * CAP, c4, o, chunk * 32 * NV + lane};
#pragma unroll
    for (int v = 0; v < NV; ++v)
      sum.total[v] = sum.part[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int base = 0; base < n_listed; base += 32) {
      const int k = base + lane;
      const bool touch = k < n_listed && ((s_list[k * ENTRY + 1] >> pixel) & 1u);
      if (!__any_sync(FULL, touch)) continue;
      const uint32_t head = touch ? s_list[k * ENTRY] : 0u;
      const uint32_t im = touch ? s_list[k * ENTRY + 2 + ty] : 0u;
      const uint32_t jm = touch ? s_list[k * ENTRY + 2 + TILE_H + tx] : 0u;
      const int count = __popc(im) * __popc(jm);
      int incl = count;                       // the lanes' places: an inclusive scan
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += v;
      }
      const int all = __shfl_sync(FULL, incl, 31);
      if (sum.n + all > CAP) sum.flush();
      if (all <= CAP) {
        int at = sum.n + incl - count;
        for (uint32_t mi = im; mi; mi &= mi - 1)
          for (uint32_t mj = jm; mj; mj &= mj - 1)
            sum.seg[at++] = sum.make(head, __ffs(mi) - 1, __ffs(mj) - 1);
        sum.n += all;
        continue;
      }
      // more than CAP here: one candidate at a time, its pairs 32 at a time
      for (uint32_t todo = __ballot_sync(FULL, count > 0); todo; todo &= todo - 1) {
        const int t = __ffs(todo) - 1;
        const uint32_t th = __shfl_sync(FULL, head, t), ti = __shfl_sync(FULL, im, t);
        const uint32_t tj = __shfl_sync(FULL, jm, t);
        const int nj = __popc(tj), nc = __popc(ti) * nj;
        for (int q0 = 0; q0 < nc; q0 += 32) {
          const int m = min(32, nc - q0);
          if (sum.n + m > CAP) sum.flush();
          if (lane < m)
            sum.seg[sum.n + lane] = sum.make(th, nth_bit(ti, (q0 + lane) / nj),
                                             nth_bit(tj, (q0 + lane) % nj));
          sum.n += m;
        }
      }
    }
    sum.flush();
    float4* row = out + static_cast<size_t>(off + (ty0 + ty) * w + tx0 + tx) * c4 + sum.c;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      if (sum.c + 32 * v < c4) row[32 * v] = add4(sum.total[v], sum.part[v]);
  }
}

}  // namespace

// grad [R, o, o, C] f32 (16-byte aligned, C a multiple of 4, o <= 32,
// R <= 1024); the forward's prologue: info [R, 3] int32 (level offset, h, w),
// y0, x0 [R, o] int32, fy, fx [R, o] f32; the levels' (h, w); out [S, C] f32,
// every row written.
extern "C" int roi_align_backward_launch(const void* grad, int C, int R, int o, const void* info,
                                         const void* y0, const void* x0, const void* fy,
                                         const void* fx, int h0, int w0, int h1, int w1, int h2,
                                         int w2, int h3, int w3, void* out, int device,
                                         void* stream) {
  if (C % 4 || R < 0 || R > MAX_R || o < 1 || o > MAX_OUT)
    return static_cast<int>(cudaErrorInvalidValue);
  const Levels lv{{h0, h1, h2, h3}, {w0, w1, w2, w3}};
  int tiles = 0;
  for (int l = 0; l < 4; ++l) {
    if (lv.h[l] < 1 || lv.w[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
    tiles += (lv.h[l] + TILE_H - 1) / TILE_H * ((lv.w[l] + TILE_W - 1) / TILE_W);
  }
  if (C == 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(device);
  const size_t smem = static_cast<size_t>(WARPS) * CAP * sizeof(int4) +
                      static_cast<size_t>(4) * R * (ENTRY + 1) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        roi_align_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  roi_align_backward_kernel<<<tiles, THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(grad), C / 4, R, o, static_cast<const int*>(info),
      static_cast<const int*>(y0), static_cast<const int*>(x0), static_cast<const float*>(fy),
      static_cast<const float*>(fx), lv, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
