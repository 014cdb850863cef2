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
// (1) orb_fast_cells: one CTA of 256 threads per strip of 4 x 2 cells of a
// level, all levels in one launch (482 CTAs at the defaults). It computes
// the FAST-9/16 strength (the max over the 16 circular 9-arcs of the min of
// tap - centre, and of centre - tap; 0 within 3 px of the level's border)
// of the strip and a 1-px halo, thresholded at th_hi and th_lo (both >= 0)
// with `>`; a strict 3x3 non-maximum suppression of each on the cells;
// has_hi = any suppressed high score in the cell (before the edge mask);
// the high map where has_hi, else the low one; 0 within EDGE = 16 px of the
// level's border; then the cell's top two (larger score first, the lower
// in-cell index y * 16 + x among ties: the order of a stable descending
// sort). An all-zero cell gives (0, index 0) and (0, index 1).
//   The twin rolls each level as torch.roll does, but no wrapped value can
// matter: a strength is taken only 3 px or more inside the level, where
// every tap lies inside it, and the NMS of a position next to the border
// reads only strengths that are 0 there. So the strip and a 4-px halo are
// staged with zeros past the level, a warp a row, every load issued before
// any store. A sign of the strength can exceed th only if two neighbouring
// compass taps (0, 4, 8, 12; every 9-arc holds two) differ from the centre
// that way by more than th, so a first pass tests that on every position
// at min(th_hi, th_lo) and lists the ~1/4 that pass, by sign, in shared
// memory (a lane's entries in a row, its offset by a shuffle scan, one
// atomic a list a warp); the strengths are computed on the lists only, and
// only for the signs that pass (the others are 0 under both thresholds).
// Rounding is monotone, so min_j fl(t_j - c) = fl(min_j t_j - c): a sign's
// arcs are taken on the taps (runs of 2, 4, 8, the ninth tap, a tree: 79
// min / max) and the centre subtracted once. One map holds the strengths
// above min(th_hi, th_lo); with f(v) = v > th ? v : 0 the NMS of f(v) keeps
// a pixel exactly where v > max(its 8 neighbours, th), so a warp takes a
// cell and each lane suppresses 8 rows of one column at both thresholds
// from a sliding 3-row window; a vote gives has_hi, and the top two come
// from the lanes' own top two and four warp reductions (the largest value,
// as unsigned bits; the least index holding it; again without it). Three
// block barriers. Bound: ~45 operations a level pixel (the compass test,
// the thresholds, two NMS, the selects and the top two) and ~163 (the arcs
// of both signs) a listed one, over the ~1.0 M level pixels, 4 bytes a
// pixel read. It is bound by issue, most of its instructions on the
// half-rate ALU pipe (compare, select, min / max, popcount).
//
// (2) orb_quota_select: each level's candidates ranked by counting. Keys
// are 64-bit (the score's bits in an order-preserving transform over the
// index's complement, -0 taken as +0), all distinct, so a candidate's row
// is the number of its level's keys above its own: the order of
// torch.sort(descending, stable). One CTA per (level, 32 candidates), a
// lane a candidate; its 16 warps split the level's keys, each streaming its
// part through its own shared-memory buffer (no block barrier, no bound on
// a level's candidates; every load issued before any store) and counting
// the keys above each lane's, and a warp stops once every lane's count has
// reached the quota (such lanes are not kept; it leaves only in a CTA with
// no kept candidate, rare at the defaults). The counts are summed, and a
// candidate of row < k (the level's quota) writes its response, level
// coordinates (loaded at the start), level-0 uv = uv_lv * scale_l (one f32
// product), level and valid = response > 0; the level's first CTA writes
// the rows past its candidates (a small image's top levels): response 0
// and candidate 0's uv, as the twin's zero-padded indices give. Work: the
// sum over levels of n^2 key comparisons (10.8 M at the defaults) spread
// over ~230 CTAs.
//
// (3) gaussian_blur7: the separable 7-tap blur of the whole canvas (numpy
// "reflect" at the canvas's edges), each tap added in order, acc = acc +
// x * k[i], product and sum rounded apart: the vertical pass, then the
// horizontal one on its float32 results, so one kernel is the twin's two
// passes to the bit. Precondition: each plane is +0 outside its level's (h,
// w), as build_pyramid leaves it. Then an output at y >= h + 3 or x >= w + 3
// is a sum of +0 products, +0 (a reflected tap there stays past the level),
// and 61% of the defaults' canvas is such. The canvas is cut into tiles of
// 32 columns x 64 rows; a tile wholly past (h + 3, w + 3) is dead and writes
// +0 with 16-byte stores, reading nothing. The live tiles (538 at the
// defaults) come first in the grid, one wave at 5 CTAs a SM (a plain grid of
// tiles across, down and planes, the dead ones returning early, took 8.7 us
// on the device against this order's 7.3-7.5 in tools/orb_smoke.py
// --ab-source, "NVIDIA H100 80GB HBM3, 700.00 W"). A live tile's
// 4 warps each take 16 rows: lane c the vertical pass of column x0 - 3 + c
// (lanes 0-5 also of x0 + 29 + c), its 22 input rows loaded at once (+0
// past the level, not read), then its 16 outputs from registers into shared
// memory; after one barrier a thread makes 4 adjacent outputs of a row from
// 10 shared values and writes them in one 16-byte store where aligned (the
// stereo canvas is 1241 wide: rows are not 16-byte multiples). Bound: the
// whole output written and each level's own pixels read (its band is +0),
// 4.07 us at the defaults; 5.87 with every plane read.
//
// (4) orb_describe: one warp per keypoint, four a CTA. The warp stages the
// raw 31 x 31 square around round(uv_lv) and the blurred 37 x 37 patch in
// shared memory: each patch row as the 16-byte chunks that cover it,
// aligned on the canvas's own addresses (9 and 10 a row), lanes along the
// flat list of chunks, all 21 a lane loaded before any store; a chunk that
// meets the canvas's left or right edge is read a float at a time, and a
// float outside the canvas is +0 (extract_patches' zeros). The chunks' floats
// are stored one by one into rows 31 and 37 words apart. Lane r < 31 sums
// row r of the disc: (pixel * mask) * dx (and * dy), the 31 columns in
// order (an odd row stride: no bank conflict); the row sums go to shared
// memory and every lane adds them in order, its 62 operands loaded before
// the adds: the twin's order. The angle is atan2f(m01, m10) (the CUDA
// library's, torch.atan2's); its bin rint(angle * RCP) mod 30 with RCP the
// float32 reciprocal of the bin width (the product XLA makes of the JAX
// package's division). Lane l loads taps 128 i + 4 l .. + 3 of the bin's
// pattern (coalesced) for i = 0..3, tests I(tap 2k) < I(tap 2k + 1) on the
// staged blurred patch, and two ballots an i give every lane descriptor
// bits 64 i .. 64 i + 63; lane j writes byte j. Bound: the pixels its discs
// and taps cover, read once (0.81 us at the defaults); the kernel is held
// by the SM's load and store traffic a keypoint, not by device memory.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int CELL = 16;                      // candidate cell (px), two kept a cell
constexpr int EDGE = 16;                      // extractor.EDGE_MARGIN
constexpr int HALO = 4;                       // FAST's radius 3 + the NMS's 1
constexpr int STRIP_W = 4, STRIP_H = 2;       // cells a FAST CTA covers, across and down
constexpr int FAST_T = 32 * STRIP_W * STRIP_H;        // 256: a warp a cell
constexpr int PX_H = STRIP_H * CELL + 2 * HALO;       // 40 x 72 staged pixels, rows 73
constexpr int PX_W = STRIP_W * CELL + 2 * HALO;       // apart: listed positions rows apart
constexpr int PX_P = PX_W + 1;                        // fall on other banks
constexpr int SP_H = STRIP_H * CELL + 2;              // 34 x 66 strengths the NMS reads
constexpr int SP_W = STRIP_W * CELL + 2;
constexpr int QS_WARPS = 16;                  // quota_select: warps splitting a level's keys
constexpr int QS_BUF = 256;                   // keys a warp stages at a time
constexpr int R = 3;                          // the blur's radius
constexpr int BT_W = 32, BT_H = 64;           // a blur tile: columns, rows
constexpr int BLUR_T = 128;                   // its threads: 4 warps of 16 rows
constexpr int B_RUN = BT_H / (BLUR_T / 32);   // a warp's output rows
constexpr int B_IN = B_RUN + 2 * R;           // and its input rows
constexpr int BV_W = BT_W + 2 * R;            // vertical results a row: 38 columns,
constexpr int BV_P = BV_W + 1;                // rows 39 words apart (odd: no conflict)
constexpr int PATCH_HALF = 15;                // the IC disc's radius
constexpr int RAW = 2 * PATCH_HALF + 1;       // its square's side
constexpr int EXT = 37;                       // the rBRIEF patch's side
constexpr int N_BINS = 30;
constexpr int N_TAPS = 512;                   // a bin's pattern: 256 pairs
constexpr int DESC_WARPS = 4;                 // keypoints a CTA

struct Levels {
  int n;                                      // levels
  int h[MAX_LEVELS], w[MAX_LEVELS];           // each level's size
  int cell0[MAX_LEVELS + 1];                  // its first cell; cell0[n] = all cells
  int row0[MAX_LEVELS + 1];                   // its first output row; row0[n] = N
  int strip0[MAX_LEVELS + 1];                 // its first FAST CTA; strip0[n] = the grid
  int chunk0[MAX_LEVELS + 1];                 // its first quota CTA; chunk0[n] = the grid
  float scale[MAX_LEVELS];                    // float32(scale_factor ** l)
};

struct Taps7 { float k[7]; };

struct BlurPlan {
  int n, H, W;                                // planes (levels), canvas size
  int nty_all, ntx_all;                       // tiles of a plane, down and across
  int h[MAX_LEVELS], w[MAX_LEVELS];           // each level's size
  int nty[MAX_LEVELS], ntx[MAX_LEVELS];       // its live tiles, down and across
  int live0[MAX_LEVELS + 1];                  // its first live CTA; live0[n] = all live
  int dead0[MAX_LEVELS + 1];                  // its first dead CTA, counted after them
};

struct DeviceGuard {                          // the launch goes to `device`
  int prev = -1;
  explicit DeviceGuard(int device) {
    cudaGetDevice(&prev);
    if (prev != device) cudaSetDevice(device); else prev = -1;
  }
  ~DeviceGuard() { if (prev >= 0) cudaSetDevice(prev); }
};

// the level of CTA b, from a table of first CTAs
__device__ __forceinline__ int level_of(const int* first, int n, int b) {
  int lv = 0;
  while (lv + 1 < n && first[lv + 1] <= b) ++lv;
  return lv;
}

// ----------------------------------------------------------------------------
// (1) FAST cells
// ----------------------------------------------------------------------------

// The max over the 16 circular 9-arcs of the arc's least tap (BRIGHT), or
// the min over them of the arc's greatest: runs of 2, 4, 8, then the ninth
// tap, then a tree. Rounding is monotone, so this minus the centre (the
// centre minus it) is the max over arcs of the min of tap - centre (of
// centre - tap): one sign of the FAST strength.
template <bool BRIGHT>
__device__ __forceinline__ float arc_extreme(const float (&t)[16]) {
  const auto in = [](float a, float b) { return BRIGHT ? fminf(a, b) : fmaxf(a, b); };
  const auto out = [](float a, float b) { return BRIGHT ? fmaxf(a, b) : fminf(a, b); };
  float m2[16], m4[16], m9[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) m2[k] = in(t[k], t[(k + 1) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m4[k] = in(m2[k], m2[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m9[k] = in(in(m4[k], m4[(k + 4) & 15]), t[(k + 8) & 15]);
#pragma unroll
  for (int k = 0; k < 8; ++k) m9[k] = out(m9[k], m9[k + 8]);
#pragma unroll
  for (int k = 0; k < 4; ++k) m9[k] = out(m9[k], m9[k + 4]);
#pragma unroll
  for (int k = 0; k < 2; ++k) m9[k] = out(m9[k], m9[k + 2]);
  return out(m9[0], m9[1]);
}

// Which signs of FAST can exceed th at staged pixel (y, x): bit 0 bright,
// bit 1 dark. A sign can only if two neighbouring compass taps (0, 4, 8,
// 12) both differ from the centre that way by more than th (every 9-arc
// holds two neighbouring ones): min(max(d0, d8), max(d4, d12)) > th, with
// d = tap - centre; c - t rounds to -(t - c) exactly, so for the dark sign
// max(min(d0, d8), min(d4, d12)) < -th.
__device__ __forceinline__ unsigned compass(const float (*s)[PX_P], int y, int x, float th) {
  const float c = s[y][x];
  const float d0 = __fsub_rn(s[y - 3][x], c), d4 = __fsub_rn(s[y][x + 3], c);
  const float d8 = __fsub_rn(s[y + 3][x], c), d12 = __fsub_rn(s[y][x - 3], c);
  const float bright = fminf(fmaxf(d0, d8), fmaxf(d4, d12));
  const float dark = fmaxf(fminf(d0, d8), fminf(d4, d12));
  return (bright > th ? 1u : 0u) | (dark < -th ? 2u : 0u);
}

constexpr int SP_ITEMS = SP_H * 2;           // warp-rows of the inner 64 span columns
constexpr int IT = SP_ITEMS / (FAST_T / 32) + 2;      // a warp's: 8 or 9, then columns 0, 65
constexpr int LIST_B = 1 << 13, LIST_D = 1 << 14;   // a list entry: r << 7 | q, the signs
static_assert(PX_H % (FAST_T / 32) == 0 && (SP_H * SP_W) % 4 == 0, "the strip's layout");

__global__ void __launch_bounds__(FAST_T, 4)
fast_cells_kernel(const float* __restrict__ canvas, int H, int W, Levels L, float th_hi,
                  float th_lo, float* __restrict__ scores, float* __restrict__ uv) {
  __shared__ float s_px[PX_H][PX_P];
  __shared__ __align__(16) float s_v[SP_H][SP_W];  // strengths above min(th_hi, th_lo), else 0
  __shared__ unsigned short s_list[SP_H * SP_W];   // bright entries up from 0, dark down
  __shared__ int s_nb, s_nd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lv = level_of(L.strip0, L.n, blockIdx.x);
  const int h = L.h[lv], w = L.w[lv], hc = h / CELL, wc = w / CELL;
  const int sw = (wc + STRIP_W - 1) / STRIP_W, s = blockIdx.x - L.strip0[lv];
  const int cy0 = (s / sw) * STRIP_H, cx0 = (s % sw) * STRIP_W;   // the strip's first cell
  const int y0 = cy0 * CELL, x0 = cx0 * CELL;
  const float* img = canvas + static_cast<size_t>(lv) * H * W;
  if (tid == 0) s_nb = s_nd = 0;

  // the strip and its halo, a warp a row, every load issued before any
  // store: zeros past the level (no strength reads them); the map zeroed
  constexpr int ROWS = PX_H / (FAST_T / 32), COLS = (PX_W + 31) / 32;
  float px[ROWS][COLS];
  bool x_in[COLS];
#pragma unroll
  for (int cb = 0; cb < COLS; ++cb) {
    const int x = x0 - HALO + cb * 32 + lane;
    x_in[cb] = x >= 0 && x < w && cb * 32 + lane < PX_W;
  }
  const float* row = img + (y0 - HALO + warp) * W + x0 - HALO + lane;
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int y = y0 - HALO + rr * (FAST_T / 32) + warp;
    const bool y_in = y >= 0 && y < h;
#pragma unroll
    for (int cb = 0; cb < COLS; ++cb)
      px[rr][cb] = y_in && x_in[cb] ? row[rr * (FAST_T / 32) * W + cb * 32] : 0.0f;
  }
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
    for (int cb = 0; cb < COLS; ++cb)
      if (cb * 32 + lane < PX_W) s_px[rr * (FAST_T / 32) + warp][cb * 32 + lane] = px[rr][cb];
  float4* zero = reinterpret_cast<float4*>(&s_v[0][0]);
  for (int i = tid; i < SP_H * SP_W / 4; i += FAST_T) zero[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // every position the NMS reads: those where a sign may pass are listed,
  // by sign, one shared-memory atomic a list a warp. Warp w takes the
  // warp-rows (34 rows x 2 of the inner 64 columns) w, w + 8, ...; warps 0-2
  // then columns 0 and 65 (68 positions), by lanes
  const float th_min = fminf(th_hi, th_lo);
  const int r_lo = max(0, 4 - y0), r_hi = min(min(STRIP_H, hc - cy0) * CELL + 2, h - 2 - y0);
  const int q_lo = max(0, 4 - x0), q_hi = min(min(STRIP_W, wc - cx0) * CELL + 2, w - 2 - x0);
  unsigned signs = 0u;                        // 2 bits a slot
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    int r = SP_H, q = 0;                      // no position
    if (it < IT - 1) {
      const int item = it * (FAST_T / 32) + warp;
      if (item < SP_ITEMS) {
        r = item >> 1;
        q = 1 + (item & 1) * 32 + lane;
      }
    } else if (warp < 3) {
      const int p = warp * 32 + lane;
      r = p < 2 * SP_H ? p >> 1 : SP_H;
      q = (p & 1) ? SP_W - 1 : 0;
    }
    if (r >= r_lo && r < r_hi && q >= q_lo && q < q_hi)
      signs |= compass(s_px, r + 3, q + 3, th_min) << (2 * it);
  }
  // the lane's entries go to consecutive places: its offsets in the warp by
  // a shuffle scan of its counts (bright | dark-only << 16), the warp's by
  // one atomic a list
  constexpr unsigned EVEN = 0x55555u;         // bit 2 it: a slot's bright bit
  const unsigned bright = signs & EVEN, dark_only = (signs >> 1) & EVEN & ~bright;
  const int mine = __popc(bright) | (__popc(dark_only) << 16);
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += o;
  }
  const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
  int base_b = 0, base_d = 0;
  if (lane == 0) {
    if (total & 0xFFFF) base_b = atomicAdd(&s_nb, total & 0xFFFF);
    if (total >> 16) base_d = atomicAdd(&s_nd, total >> 16);
  }
  base_b = __shfl_sync(0xFFFFFFFFu, base_b, 0) + ((incl - mine) & 0xFFFF);
  base_d = __shfl_sync(0xFFFFFFFFu, base_d, 0) + ((incl - mine) >> 16);
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const unsigned sg = (signs >> (2 * it)) & 3u;
    if (sg) {
      const int item = it * (FAST_T / 32) + warp, p = warp * 32 + lane;
      const int e = it < IT - 1 ? ((item >> 1) << 7) | (1 + (item & 1) * 32 + lane)
                                : ((p >> 1) << 7) | ((p & 1) ? SP_W - 1 : 0);
      if (sg & 1u)
        s_list[base_b++] = static_cast<unsigned short>(e | LIST_B | ((sg & 2u) ? LIST_D : 0));
      else
        s_list[SP_H * SP_W - 1 - base_d++] = static_cast<unsigned short>(e | LIST_D);
    }
  }
  __syncthreads();

  // the listed positions' strengths above th_min: the bright list first,
  // then the dark one (only the signs that may pass are taken)
  const int nb = s_nb, n_list = nb + s_nd;
  for (int j = tid; j < n_list; j += FAST_T) {
    const int e = s_list[j < nb ? j : SP_H * SP_W - 1 - (j - nb)];
    const int r = (e >> 7) & 63, q = e & 127, y = r + 3, x = q + 3;
    // the Bresenham circle of radius 3, clockwise from 12 o'clock (dy, dx)
    constexpr int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
    constexpr int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
    float t[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) t[k] = s_px[y + dy[k]][x + dx[k]];
    const float c = s_px[y][x];
    float v = -INFINITY;
    if (e & LIST_B) v = __fsub_rn(arc_extreme<true>(t), c);
    if (e & LIST_D) v = fmaxf(v, __fsub_rn(c, arc_extreme<false>(t)));
    s_v[r][q] = v > th_min ? v : 0.0f;
  }
  __syncthreads();

  // a warp a cell: lane (x, half) suppresses rows 8 half .. 8 half + 7 of
  // column x from a sliding window of three span rows. With f(v) = v > th ?
  // v : 0 (th >= 0) the strict NMS of f(v) keeps f(m) > f(max of the 8
  // neighbours) exactly where m > max(neighbours, th)
  const int cy = cy0 + warp / STRIP_W, cx = cx0 + warp % STRIP_W;
  if (cy >= hc || cx >= wc) return;           // whole warps
  const int col = lane & 15, half = lane >> 4;
  const int r0 = (warp / STRIP_W) * CELL + half * 8;          // span row above the first
  const int q = (warp % STRIP_W) * CELL + col + 1;            // span column of the pixel
  float up = fmaxf(fmaxf(s_v[r0][q - 1], s_v[r0][q]), s_v[r0][q + 1]);
  float l = s_v[r0 + 1][q - 1], m = s_v[r0 + 1][q], rt = s_v[r0 + 1][q + 1];
  float hn[8], ln[8];
  bool any_hi = false;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float bl = s_v[r0 + i + 2][q - 1], bm = s_v[r0 + i + 2][q], br = s_v[r0 + i + 2][q + 1];
    const float nb = fmaxf(fmaxf(up, fmaxf(fmaxf(bl, bm), br)), fmaxf(l, rt));
    const bool hi = m > fmaxf(nb, th_hi);
    hn[i] = hi ? m : 0.0f;
    ln[i] = m > fmaxf(nb, th_lo) ? m : 0.0f;
    any_hi |= hi;
    up = fmaxf(fmaxf(l, m), rt);
    l = bl;
    m = bm;
    rt = br;
  }
  const bool has_hi = __any_sync(0xFFFFFFFFu, any_hi);
  const int x = cx * CELL + col;
  const bool x_ok = x >= EDGE && x < w - EDGE;
  float v1 = -INFINITY, v2 = -INFINITY;
  int i1 = 1 << 30, i2 = 1 << 30;
#pragma unroll
  for (int i = 0; i < 8; ++i) {               // in-cell indices rise with i
    const int yy = half * 8 + i, y = cy * CELL + yy;
    const float v = (x_ok && y >= EDGE && y < h - EDGE) ? (has_hi ? hn[i] : ln[i]) : 0.0f;
    if (v > v1) {
      v2 = v1; i2 = i1; v1 = v; i1 = yy * CELL + col;
    } else if (v > v2) {
      v2 = v; i2 = yy * CELL + col;
    }
  }
  // the cell's top two from the lanes' own: the largest value (every value
  // is +0 or more, so its bits order as unsigned) and the least index that
  // holds it; then the same over the lanes' best but for that one
  const unsigned v1b = __reduce_max_sync(0xFFFFFFFFu, __float_as_uint(v1));
  const unsigned i1g = __reduce_min_sync(
      0xFFFFFFFFu, __float_as_uint(v1) == v1b ? static_cast<unsigned>(i1) : 0xFFFFu);
  const bool first_here = static_cast<unsigned>(i1) == i1g;
  const float rv = first_here ? v2 : v1;
  const int ri = first_here ? i2 : i1;
  const unsigned v2b = __reduce_max_sync(0xFFFFFFFFu, __float_as_uint(rv));
  const unsigned i2g = __reduce_min_sync(
      0xFFFFFFFFu, __float_as_uint(rv) == v2b ? static_cast<unsigned>(ri) : 0xFFFFu);
  v1 = __uint_as_float(v1b);
  i1 = static_cast<int>(i1g);
  v2 = __uint_as_float(v2b);
  i2 = static_cast<int>(i2g);
  if (lane < 2) {
    const int j = 2 * (L.cell0[lv] + cy * wc + cx) + lane, idx = lane == 0 ? i1 : i2;
    scores[j] = lane == 0 ? v1 : v2;
    uv[2 * j] = static_cast<float>(cx * CELL + (idx & 15));
    uv[2 * j + 1] = static_cast<float>(cy * CELL + (idx >> 4));
  }
}

// ----------------------------------------------------------------------------
// (2) the per-level quota
// ----------------------------------------------------------------------------

// the score's bits, ordered as the floats are (-0 as +0), over the index's
// complement: a larger key is a larger score, or an equal one of lower index;
// every key of a non-NaN score is above 0
__device__ __forceinline__ unsigned long long sort_key(float s, int i) {
  if (s == 0.0f) s = 0.0f;
  uint32_t u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | (0xFFFFFFFFu - static_cast<uint32_t>(i));
}

__global__ void __launch_bounds__(QS_WARPS * 32)
quota_select_kernel(const float* __restrict__ scores, const float* __restrict__ cand_uv,
                    Levels L, float* __restrict__ response, float* __restrict__ uv_lv,
                    float* __restrict__ uv, int* __restrict__ level, bool* __restrict__ valid) {
  __shared__ __align__(16) unsigned long long s_key[QS_WARPS][QS_BUF];
  __shared__ int s_cnt[QS_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lv = level_of(L.chunk0, L.n, blockIdx.x);
  const int first = 2 * L.cell0[lv], n = 2 * (L.cell0[lv + 1] - L.cell0[lv]);
  const int k = L.row0[lv + 1] - L.row0[lv], row0 = L.row0[lv];
  const float* sc = scores + first;
  const int chunk = blockIdx.x - L.chunk0[lv], c = chunk * 32 + lane;   // this lane's candidate
  const float s = c < n ? sc[c] : 0.0f;
  const float2 uv_c = c < n ? reinterpret_cast<const float2*>(cand_uv)[first + c]
                            : make_float2(0.0f, 0.0f);       // loaded now, used at the end
  const unsigned long long mine = c < n ? sort_key(s, c) : ~0ull;   // no key is above ~0
  int cnt = c < n ? 0 : k;

  // this warp's part of the keys, QS_BUF at a time
  const int part = (n + QS_WARPS - 1) / QS_WARPS;
  const int j0 = min(n, warp * part), j1 = min(n, j0 + part);
  unsigned long long* buf = s_key[warp];
  for (int base = j0; base < j1; base += QS_BUF) {
    if (__all_sync(0xFFFFFFFFu, cnt >= k)) break;   // no lane of the warp is kept
    const int m = min(QS_BUF, j1 - base), m8 = (m + 7) & ~7;
    float v[QS_BUF / 32];                     // every load issued before any store
#pragma unroll
    for (int u = 0; u < QS_BUF / 32; ++u)
      v[u] = lane + 32 * u < m ? sc[base + lane + 32 * u] : 0.0f;
#pragma unroll
    for (int u = 0; u < QS_BUF / 32; ++u) {   // padding (key 0) is above no key
      const int t = lane + 32 * u;
      if (t < m8) buf[t] = t < m ? sort_key(v[u], base + t) : 0ull;
    }
    __syncwarp();
#pragma unroll 4
    for (int t = 0; t < m8; t += 8) {
      const ulonglong2 a = *reinterpret_cast<const ulonglong2*>(buf + t);
      const ulonglong2 b = *reinterpret_cast<const ulonglong2*>(buf + t + 2);
      const ulonglong2 d = *reinterpret_cast<const ulonglong2*>(buf + t + 4);
      const ulonglong2 e = *reinterpret_cast<const ulonglong2*>(buf + t + 6);
      cnt += (a.x > mine) + (a.y > mine) + (b.x > mine) + (b.y > mine) + (d.x > mine) +
             (d.y > mine) + (e.x > mine) + (e.y > mine);
    }
    __syncwarp();
  }
  s_cnt[warp][lane] = cnt;
  __syncthreads();

  const float scl = L.scale[lv];
  if (warp == 0 && c < n) {
    int rank = 0;
#pragma unroll
    for (int q = 0; q < QS_WARPS; ++q) rank += s_cnt[q][lane];
    if (rank < k) {
      const float u = uv_c.x, v = uv_c.y;
      const int o = row0 + rank;
      response[o] = s;
      uv_lv[2 * o] = u;
      uv_lv[2 * o + 1] = v;
      uv[2 * o] = __fmul_rn(u, scl);
      uv[2 * o + 1] = __fmul_rn(v, scl);
      level[o] = lv;
      valid[o] = s > 0.0f;
    }
  }
  if (chunk == 0) {                           // rows past the candidates: candidate 0
    const float u = cand_uv[2 * first], v = cand_uv[2 * first + 1];
    for (int r = n + threadIdx.x; r < k; r += QS_WARPS * 32) {
      const int o = row0 + r;
      response[o] = 0.0f;
      uv_lv[2 * o] = u;
      uv_lv[2 * o + 1] = v;
      uv[2 * o] = __fmul_rn(u, scl);
      uv[2 * o + 1] = __fmul_rn(v, scl);
      level[o] = lv;
      valid[o] = false;
    }
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

// outputs x .. x + 3 of a row: one 16-byte store where aligned and inside
__device__ __forceinline__ void store4(float* row, int x, int W, float4 o) {
  float* p = row + x;
  if (x + 3 < W && (reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
    *reinterpret_cast<float4*>(p) = o;
  } else {
    if (x < W) p[0] = o.x;
    if (x + 1 < W) p[1] = o.y;
    if (x + 2 < W) p[2] = o.z;
    if (x + 3 < W) p[3] = o.w;
  }
}

__global__ void __launch_bounds__(BLUR_T, 5)
blur7_kernel(const float* __restrict__ in, float* __restrict__ out, BlurPlan P, Taps7 k) {
  __shared__ float s_v[BT_H][BV_P];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = P.H, W = P.W;
  const bool live = static_cast<int>(blockIdx.x) < P.live0[P.n];
  int lv, ty, tx;
  if (live) {
    lv = level_of(P.live0, P.n, blockIdx.x);
    const int t = blockIdx.x - P.live0[lv];
    ty = t / P.ntx[lv];
    tx = t % P.ntx[lv];
  } else {                                    // the tiles right of the live ones, then below
    const int b = blockIdx.x - P.live0[P.n];
    lv = level_of(P.dead0, P.n, b);
    int t = b - P.dead0[lv];
    const int right = P.ntx_all - P.ntx[lv];
    if (t < P.nty_all * right) {
      ty = t / right;
      tx = P.ntx[lv] + t % right;
    } else {
      t -= P.nty_all * right;
      ty = P.nty[lv] + t / P.ntx[lv];
      tx = t % P.ntx[lv];
    }
  }
  const int y0 = ty * BT_H, x0 = tx * BT_W;
  const size_t plane = static_cast<size_t>(lv) * H * W;
  const int c4 = tid & 7, rq = tid >> 3;      // outputs 4 c4 .. + 3 of rows rq + 16 i
  float* dst = out + plane;
  if (!live) {                                // past (h + 3, w + 3): +0, nothing read
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < BT_H / 16; ++i) {
      const int y = y0 + rq + 16 * i;
      if (y < H) store4(dst + static_cast<size_t>(y) * W, x0 + 4 * c4, W, zero);
    }
    return;
  }

  // the vertical pass: warp w rows 16 w .. 16 w + 15 of the tile; lane c
  // column x0 - 3 + c, lanes 0-5 also x0 + 29 + c. Every load first; a tap
  // past the level is +0 (the precondition) and is not read
  const int h = P.h[lv], w = P.w[lv];
  const float* img = in + plane;
  const int r0 = warp * B_RUN;
  if (y0 + r0 < H) {
    const int xa = reflect(x0 - R + lane, W), xb = reflect(x0 - R + 32 + lane, W);
    const bool a_in = xa < w, b_in = lane < 2 * R && xb < w;
    float pa[B_IN], pb[B_IN];
#pragma unroll
    for (int i = 0; i < B_IN; ++i) {
      const int y = reflect(y0 + r0 - R + i, H);
      const float* row = img + static_cast<size_t>(y) * W;
      pa[i] = y < h && a_in ? row[xa] : 0.0f;
      pb[i] = y < h && b_in ? row[xb] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < B_RUN; ++r) {
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < 7; ++t) acc = __fadd_rn(acc, __fmul_rn(pa[r + t], k.k[t]));
      s_v[r0 + r][lane] = acc;
    }
    if (lane < 2 * R) {
#pragma unroll
      for (int r = 0; r < B_RUN; ++r) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < 7; ++t) acc = __fadd_rn(acc, __fmul_rn(pb[r + t], k.k[t]));
        s_v[r0 + r][32 + lane] = acc;
      }
    }
  }
  __syncthreads();

  // the horizontal pass: 4 adjacent outputs of a row from 10 vertical results
#pragma unroll
  for (int i = 0; i < BT_H / 16; ++i) {
    const int r = rq + 16 * i, y = y0 + r;
    if (y >= H) break;
    const float* sv = &s_v[r][4 * c4];
    float v[10];
#pragma unroll
    for (int j = 0; j < 10; ++j) v[j] = sv[j];
    float o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < 7; ++t) acc = __fadd_rn(acc, __fmul_rn(v[q + t], k.k[t]));
      o[q] = acc;
    }
    store4(dst + static_cast<size_t>(y) * W, x0 + 4 * c4, W, make_float4(o[0], o[1], o[2], o[3]));
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

// Patch staging: each row of a patch read as the 16-byte chunks that cover
// it (aligned on the plane's own address, so a row may start 0-3 floats
// into its first chunk); a chunk that crosses the canvas's left or right
// edge is read a float at a time, and a float outside the canvas is +0.
template <int LEN>
struct PatchChunks {
  static constexpr int PER_ROW = (LEN + 3 + 3) / 4;   // chunks a row, at most
  static constexpr int N = LEN * PER_ROW;             // of the patch
  static constexpr int IT = (N + 31) / 32;            // a lane's
};

// chunk q of a LEN x LEN patch whose top left is (y0, x0) on `img` (H x W;
// a0 = the plane's address / 4): its floats, and in `at` its patch row << 8
// | its first patch column + 3 (that column is -3 or more)
template <int LEN>
__device__ __forceinline__ float4 load_chunk(const float* img, int H, int W, unsigned a0, int y0,
                                             int x0, int q, int& at) {
  const int row = q / PatchChunks<LEN>::PER_ROW;
  const int k = q - row * PatchChunks<LEN>::PER_ROW, y = y0 + row;
  const int mis = static_cast<int>((a0 + static_cast<unsigned>(y * W + x0)) & 3u);
  const int col = 4 * k - mis, x = x0 + col;
  at = (row << 8) | (col + 3);
  float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (q >= PatchChunks<LEN>::N || y < 0 || y >= H || x + 3 < 0 || x >= W || col >= LEN) return c;
  const float* p = img + y * W + x;
  if (x >= 0 && x + 3 < W) return *reinterpret_cast<const float4*>(p);
  c.x = x >= 0 && x < W ? p[0] : 0.0f;
  c.y = x + 1 >= 0 && x + 1 < W ? p[1] : 0.0f;
  c.z = x + 2 >= 0 && x + 2 < W ? p[2] : 0.0f;
  c.w = x + 3 >= 0 && x + 3 < W ? p[3] : 0.0f;
  return c;
}

// a chunk's floats (load_chunk's `at`) into a LEN-wide patch, those inside it
template <int LEN>
__device__ __forceinline__ void store_chunk(float* s, int at, int q, float4 c) {
  if (q >= PatchChunks<LEN>::N) return;
  const int col = (at & 255) - 3;
  float* d = s + (at >> 8) * LEN + col;
  if (col >= 0 && col < LEN) d[0] = c.x;
  if (col + 1 >= 0 && col + 1 < LEN) d[1] = c.y;
  if (col + 2 >= 0 && col + 2 < LEN) d[2] = c.z;
  if (col + 3 >= 0 && col + 3 < LEN) d[3] = c.w;
}

// nibble b3 b2 b1 b0 -> bits 6, 4, 2, 0
__device__ __forceinline__ unsigned spread4(unsigned n) {
  return (n & 1u) | ((n & 2u) << 1) | ((n & 4u) << 2) | ((n & 8u) << 3);
}

__global__ void __launch_bounds__(DESC_WARPS * 32, 4)
describe_kernel(const float* __restrict__ canvas, const float* __restrict__ blurred, int H,
                int W, const float* __restrict__ uv_lv, const int* __restrict__ level, int N,
                const int* __restrict__ taps, float rcp_bin, float* __restrict__ angle,
                uint8_t* __restrict__ desc) {
  __shared__ float s_raw[DESC_WARPS][RAW * RAW];
  __shared__ float s_blr[DESC_WARPS][EXT * EXT];
  __shared__ __align__(16) float s_sum[DESC_WARPS][2][32];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int n = blockIdx.x * DESC_WARPS + wib;
  if (n >= N) return;                         // whole warps only
  const int u = static_cast<int>(rintf(uv_lv[2 * n]));
  const int v = static_cast<int>(rintf(uv_lv[2 * n + 1]));
  const size_t plane = static_cast<size_t>(level[n]) * H * W;
  const float* img = canvas + plane;
  const float* blr = blurred + plane;
  float* sr = s_raw[wib];
  float* sb = s_blr[wib];

  // stage both patches: every lane's chunks loaded, then stored
  const unsigned a0 = static_cast<unsigned>(reinterpret_cast<uintptr_t>(img) >> 2);
  const unsigned b0 = static_cast<unsigned>(reinterpret_cast<uintptr_t>(blr) >> 2);
  float4 cr[PatchChunks<RAW>::IT], cb[PatchChunks<EXT>::IT];
  int ar[PatchChunks<RAW>::IT], ab[PatchChunks<EXT>::IT];
#pragma unroll
  for (int it = 0; it < PatchChunks<RAW>::IT; ++it)
    cr[it] = load_chunk<RAW>(img, H, W, a0, v - PATCH_HALF, u - PATCH_HALF, it * 32 + lane,
                             ar[it]);
#pragma unroll
  for (int it = 0; it < PatchChunks<EXT>::IT; ++it)
    cb[it] = load_chunk<EXT>(blr, H, W, b0, v - EXT / 2, u - EXT / 2, it * 32 + lane, ab[it]);
#pragma unroll
  for (int it = 0; it < PatchChunks<RAW>::IT; ++it)
    store_chunk<RAW>(sr, ar[it], it * 32 + lane, cr[it]);
#pragma unroll
  for (int it = 0; it < PatchChunks<EXT>::IT; ++it)
    store_chunk<EXT>(sb, ab[it], it * 32 + lane, cb[it]);
  __syncwarp();

  // lane r < 31: row dy = r - 15 of the disc, its 31 columns in order
  float rx = 0.0f, ry = 0.0f;
  if (lane < RAW) {
    const int dy = lane - PATCH_HALF;
    const float fy = static_cast<float>(dy);
    const float* row = sr + lane * RAW;
#pragma unroll
    for (int j = 0; j < RAW; ++j) {
      const int dx = j - PATCH_HALF;
      const float in_disc = dx * dx + dy * dy <= PATCH_HALF * PATCH_HALF ? 1.0f : 0.0f;
      const float wgt = __fmul_rn(row[j], in_disc);
      const float px = __fmul_rn(wgt, static_cast<float>(dx)), py = __fmul_rn(wgt, fy);
      rx = j == 0 ? px : __fadd_rn(rx, px);
      ry = j == 0 ? py : __fadd_rn(ry, py);
    }
  }
  s_sum[wib][0][lane] = rx;
  s_sum[wib][1][lane] = ry;
  __syncwarp();
  // every lane: the 31 row sums in order, all loaded before the adds
  float sx[32], sy[32];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 a = reinterpret_cast<const float4*>(s_sum[wib][0])[q];
    const float4 b = reinterpret_cast<const float4*>(s_sum[wib][1])[q];
    sx[4 * q] = a.x; sx[4 * q + 1] = a.y; sx[4 * q + 2] = a.z; sx[4 * q + 3] = a.w;
    sy[4 * q] = b.x; sy[4 * q + 1] = b.y; sy[4 * q + 2] = b.z; sy[4 * q + 3] = b.w;
  }
  float m10 = sx[0], m01 = sy[0];
#pragma unroll
  for (int r = 1; r < RAW; ++r) {
    m10 = __fadd_rn(m10, sx[r]);
    m01 = __fadd_rn(m01, sy[r]);
  }
  const float a = atan2f(m01, m10);
  const int bin = angle_bin(a, rcp_bin);

  // lane l: taps 128 i + 4 l .. + 3, tests 64 i + 2 l (lo) and + 1 (hi)
  const int4* tp = reinterpret_cast<const int4*>(taps + bin * N_TAPS);
  int4 tq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) tq[i] = tp[i * 32 + lane];
  unsigned lo[4], hi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo[i] = __ballot_sync(0xFFFFFFFFu, sb[tq[i].x] < sb[tq[i].y]);
    hi[i] = __ballot_sync(0xFFFFFFFFu, sb[tq[i].z] < sb[tq[i].w]);
  }
  // byte j = bits 8 j .. 8 j + 7 = tests of lanes 4 (j % 8) .. + 3 of i = j / 8
  const int i = lane >> 3, sh = 4 * (lane & 7);
  const unsigned l_i = i == 0 ? lo[0] : i == 1 ? lo[1] : i == 2 ? lo[2] : lo[3];
  const unsigned h_i = i == 0 ? hi[0] : i == 1 ? hi[1] : i == 2 ? hi[2] : hi[3];
  const unsigned byte = spread4((l_i >> sh) & 15u) | (spread4((h_i >> sh) & 15u) << 1);
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
  for (int l = 0; l < n_levels; ++l) {
    const int hc = hs[l] / CELL, wc = ws[l] / CELL, k = quotas != nullptr ? quotas[l] : 0;
    L.h[l] = hs[l];
    L.w[l] = ws[l];
    L.cell0[l + 1] = L.cell0[l] + hc * wc;
    L.row0[l + 1] = L.row0[l] + k;
    L.strip0[l + 1] = L.strip0[l] +
                      ((hc + STRIP_H - 1) / STRIP_H) * ((wc + STRIP_W - 1) / STRIP_W);
    L.chunk0[l + 1] = L.chunk0[l] + (k > 0 ? (2 * hc * wc + 31) / 32 : 0);
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
// th_hi, th_lo >= 0; scores [C] f32 and uv [C, 2] f32 out, C = 2 x the
// levels' cells.
extern "C" int orb_fast_cells_launch(const void* canvas, int H, int W, int n_levels,
                                     const int* hs, const int* ws, float th_hi, float th_lo,
                                     void* scores, void* uv, int device, void* stream) {
  if (!levels_ok(n_levels, hs, ws, H, W) || !(th_hi >= 0.0f) || !(th_lo >= 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  const Levels L = make_levels(n_levels, hs, ws, nullptr, nullptr);
  if (L.cell0[n_levels] == 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(device);
  fast_cells_kernel<<<L.strip0[n_levels], FAST_T, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
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
  for (int l = 0; l < n_levels; ++l)
    if (hs[l] < 1 || ws[l] < 1 || quotas[l] < 0 ||
        (quotas[l] > 0 && hs[l] / CELL * (ws[l] / CELL) == 0))
      return static_cast<int>(cudaErrorInvalidValue);
  const Levels L = make_levels(n_levels, hs, ws, quotas, scales);
  if (L.row0[n_levels] == 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(device);
  quota_select_kernel<<<L.chunk0[n_levels], QS_WARPS * 32, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const float*>(cand_uv), L,
      static_cast<float*>(response), static_cast<float*>(uv_lv), static_cast<float*>(uv),
      static_cast<int*>(level), static_cast<bool*>(valid));
  return static_cast<int>(cudaGetLastError());
}

// in, out [L, H, W] f32 (H, W >= 4), plane l +0 outside its level (hs[l],
// ws[l]) (n_levels = L, host arrays); taps: host array of the 7 weights.
extern "C" int gaussian_blur7_launch(const void* in, void* out, int L, int H, int W,
                                     int n_levels, const int* hs, const int* ws,
                                     const float* taps, int device, void* stream) {
  if (L < 1 || H < R + 1 || W < R + 1 || n_levels != L || !levels_ok(n_levels, hs, ws, H, W))
    return static_cast<int>(cudaErrorInvalidValue);
  BlurPlan P{};
  P.n = L;
  P.H = H;
  P.W = W;
  P.nty_all = (H + BT_H - 1) / BT_H;
  P.ntx_all = (W + BT_W - 1) / BT_W;
  for (int l = 0; l < L; ++l) {
    P.h[l] = hs[l];
    P.w[l] = ws[l];
    const int live_h = hs[l] + R < H ? hs[l] + R : H, live_w = ws[l] + R < W ? ws[l] + R : W;
    P.nty[l] = (live_h + BT_H - 1) / BT_H;
    P.ntx[l] = (live_w + BT_W - 1) / BT_W;
    P.live0[l + 1] = P.live0[l] + P.nty[l] * P.ntx[l];
    P.dead0[l + 1] = P.dead0[l] + P.nty_all * P.ntx_all - P.nty[l] * P.ntx[l];
  }
  Taps7 k;
  for (int t = 0; t < 7; ++t) k.k[t] = taps[t];
  DeviceGuard guard(device);
  blur7_kernel<<<P.live0[L] + P.dead0[L], BLUR_T, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), P, k);
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
