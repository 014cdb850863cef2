// Rectified stereo matching for Hopper (sm_90a).
//
// Replaces the program that XLA fuses in the JAX package:
// `stereo_match`, gdslam_tpu/ops/stereo.py:28 (there is no Pallas kernel for
// it). Plain twin: gdslam_tpu_torch/ops/stereo.py stereo_match_plain; the
// bucket build's twin is row_buckets_plain there. One call per stereo frame,
// left keypoints x right keypoints (2000 x 2000 at KITTI's settings).
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
// and, for the matched keypoints, their patches; the work is the gate tests
// of the pairs in each row band (2.4% of the N x M pairs at KITTI's
// settings), a 256-bit popcount for the 0.6% inside every gate, and 121 x 11
// absolute differences per match: under a microsecond at the card's rates,
// below one launch's floor. So the kernel is bound by the latency of its
// dependent steps, and the design shortens them.
//
// Design. (1) Row buckets: the valid right keypoints are counting-sorted by
// row b = clamp(floor(vR), 0, rows - 1) (shared-memory atomics, an exclusive
// scan, a scatter of 48-byte records: u, v, level, original j and the
// descriptor), with an offsets table [rows + 1]. Wherever the table fits a
// block's shared memory (up to ~4100 right keypoints with images) every CTA
// sorts again in its own shared memory: one launch, a CTA of 16 warps per
// SM, a left keypoint per warp. Past that a first launch of one CTA sorts
// into a scratch buffer in device memory, and the walk follows it on the
// stream (two launches a call). On an H100 at 2000 x 2000 the one-launch
// build took 7.9 us a call from a CUDA graph, a two-launch one 10.4 even
// with its records staged in shared memory (PERF.md). Up to 2048 right
// keypoints the sort loads every record once, all loads issued before any
// is used. (2) Band walk: one warp per left keypoint walks only the
// buckets floor(vL - band) - 1 .. floor(vL + band) + 1 (clamped), one
// contiguous run of records; the one-row margin absorbs the f32 rounding
// of vL +- band, and every record still passes the exact gates, so the
// walk skips only pairs that fail them. Lanes keep their own (cost, j, u)
// minimum with the lower j winning a tie, and a shuffle reduction by the
// same rule makes the result independent of the order inside a bucket.
// (3) SAD on all 32 lanes: the left 11x11 patch and the right 11x21 strip
// are staged in the warp's shared memory (zeros outside the image), every
// pixel load in flight at once; lanes compute the 121 (offset, row) sums,
// each row left to right, then lanes 0-10 add their offset's rows top to
// bottom: the twin's order, with a chain of ~22 adds instead of 121
// dependent loads and adds. The parabola's products and sums are single
// IEEE roundings (-fmad=false), so the outputs equal the twin's to the bit.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int WARPS0 = 8;                    // after a bucket launch: keypoints per block
constexpr int WARPS1 = 16;                   // buckets in every CTA: a block per SM
constexpr int SORT_THREADS = 1024;           // the one-CTA bucket launch
constexpr int MAX_ROWS = 4096;               // rows of the bucket table, at most
constexpr int SAD_HALF = 5;
constexpr int SLIDE = 5;
constexpr int N_OFF = 2 * SLIDE + 1;
constexpr int PATCH = 2 * SAD_HALF + 1;      // 11
constexpr int STRIP = PATCH + 2 * SLIDE;     // 21
constexpr int SAD_FLOATS = 476;              // 121 + 231 + 121, padded to 16 bytes
constexpr int TH_ORB_DIST = 75;
constexpr int BIG = 1 << 20;
constexpr int BAND_LEVELS = 32;
constexpr unsigned FULL = 0xffffffffu;

struct alignas(16) Rec {                      // a valid right keypoint, in bucket order
  float u, v;
  int level, j;
  uint4 d0, d1;                               // its descriptor
};

struct DeviceGuard {                          // the launch goes to `device`
  int prev = -1;
  explicit DeviceGuard(int device) {
    cudaGetDevice(&prev);
    if (prev != device) cudaSetDevice(device); else prev = -1;
  }
  ~DeviceGuard() { if (prev >= 0) cudaSetDevice(prev); }
};

// a row as a bucket index: NaN to 0, then clamped into [0, rows)
__device__ __forceinline__ int clamp_row(float r, int rows) {
  return static_cast<int>(fminf(fmaxf(r, 0.f), static_cast<float>(rows - 1)));
}

__device__ __forceinline__ int bucket_of(float v, int rows) { return clamp_row(floorf(v), rows); }

__device__ __forceinline__ float pixel(const float* img, int h, int w, int y, int x) {
  return (y >= 0 && y < h && x >= 0 && x < w) ? img[y * w + x] : 0.f;
}

__device__ __forceinline__ int hamming(const uint4 a0, const uint4 a1, const uint4 b0,
                                       const uint4 b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
         __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) + __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

// Exclusive scan of cnt[0, n) into off[0, n] (off[n] the total) by one block
// of T threads, each over a contiguous run; cnt becomes a copy of off[0, n),
// the scatter's cursors. warp_tot: 32 ints of shared memory.
template <int T>
__device__ void block_scan(int* cnt, int* off, int n, int* warp_tot) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int per = (n + T - 1) / T;
  const int b0 = min(tid * per, n), b1 = min(b0 + per, n);
  int s = 0;
  for (int b = b0; b < b1; ++b) s += cnt[b];
  int incl = s;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_tot[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int t = lane < T / 32 ? warp_tot[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t += y;
    }
    if (lane < T / 32) warp_tot[lane] = t;
  }
  __syncthreads();
  int run = incl - s + (wid ? warp_tot[wid - 1] : 0);
  for (int b = b0; b < b1; ++b) {
    const int c = cnt[b];
    off[b] = run;
    cnt[b] = run;
    run += c;
  }
  if (tid == T - 1) off[n] = run;            // its run ends at n
}

// The counting sort of the valid right keypoints by row, by one block of T
// threads: cnt (rows ints) and warp_tot (32) in shared memory; off [rows + 1]
// and recs [valid count] in shared or device memory. Order inside a bucket
// follows the atomics (the walk does not depend on it). Up to ITEMS * T
// keypoints (2048) one pass loads every record into registers (all loads
// issued before any is used, the counters zeroed meanwhile), takes each
// record's rank in its bucket from the count's atomic, and after the scan
// stores it at off[b] + rank: one memory round trip. Past that, a count pass
// and a scatter pass of ITEMS keypoints a thread at a time.
template <int T>
__device__ void build_buckets(const float2* __restrict__ r_uv, const int* __restrict__ r_level,
                              const uint4* __restrict__ r_desc,
                              const unsigned char* __restrict__ r_valid, int m, int rows,
                              int* cnt, int* off, Rec* recs, int* warp_tot) {
  constexpr int ITEMS = 2048 / T;
  if (m <= ITEMS * T) {
    Rec rec[ITEMS];
    int b[ITEMS];
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int j = threadIdx.x + q * T;
      const bool in = j < m;
      const bool ok = in && r_valid[j];
      const float2 uv = in ? r_uv[j] : make_float2(0.f, 0.f);
      rec[q] = in ? Rec{uv.x, uv.y, r_level[j], j, r_desc[2 * j], r_desc[2 * j + 1]} : Rec{};
      b[q] = ok ? bucket_of(uv.y, rows) : -1;
    }
    for (int r = threadIdx.x; r < rows; r += T) cnt[r] = 0;
    __syncthreads();
    int rank[ITEMS];
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) rank[q] = b[q] >= 0 ? atomicAdd(&cnt[b[q]], 1) : 0;
    __syncthreads();
    block_scan<T>(cnt, off, rows, warp_tot);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < ITEMS; ++q)
      if (b[q] >= 0) recs[cnt[b[q]] + rank[q]] = rec[q];     // cnt now holds off[0, rows)
    return;
  }
  for (int r = threadIdx.x; r < rows; r += T) cnt[r] = 0;
  __syncthreads();
  for (int base = threadIdx.x; base < m; base += ITEMS * T) {
    int b[ITEMS];
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int j = base + q * T;
      const bool ok = j < m && r_valid[j];
      const float v = j < m ? r_uv[j].y : 0.f;
      b[q] = ok ? bucket_of(v, rows) : -1;
    }
#pragma unroll
    for (int q = 0; q < ITEMS; ++q)
      if (b[q] >= 0) atomicAdd(&cnt[b[q]], 1);
  }
  __syncthreads();
  block_scan<T>(cnt, off, rows, warp_tot);
  __syncthreads();
  for (int base = threadIdx.x; base < m; base += ITEMS * T) {
    int b[ITEMS];
    Rec rec[ITEMS];
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int j = base + q * T;
      const bool in = j < m;
      const bool ok = in && r_valid[j];
      const float2 uv = in ? r_uv[j] : make_float2(0.f, 0.f);
      rec[q] = in ? Rec{uv.x, uv.y, r_level[j], j, r_desc[2 * j], r_desc[2 * j + 1]} : Rec{};
      b[q] = ok ? bucket_of(uv.y, rows) : -1;
    }
#pragma unroll
    for (int q = 0; q < ITEMS; ++q)
      if (b[q] >= 0) recs[atomicAdd(&cnt[b[q]], 1)] = rec[q];
  }
}

// The bucket launch (where the table does not fit a block's shared memory):
// the buckets built by one CTA straight into device memory.
__global__ void __launch_bounds__(SORT_THREADS)
bucket_kernel(const float2* __restrict__ r_uv, const int* __restrict__ r_level,
              const uint4* __restrict__ r_desc, const unsigned char* __restrict__ r_valid,
              int m, int rows, int* __restrict__ off, Rec* __restrict__ recs) {
  extern __shared__ int s_cnt[];              // cnt [rows], then 32 warp totals
  build_buckets<SORT_THREADS>(r_uv, r_level, r_desc, r_valid, m, rows, s_cnt, off, recs,
                              s_cnt + rows);
}

struct LeftKp {                               // one left keypoint's inputs
  float2 uv;
  int level;
  bool valid;
  uint4 a0, a1;
};

__device__ __forceinline__ LeftKp load_left(const float2* __restrict__ l_uv,
                                            const int* __restrict__ l_level,
                                            const uint4* __restrict__ l_desc,
                                            const unsigned char* __restrict__ l_valid, int i) {
  return LeftKp{l_uv[i], l_level[i], l_valid[i] != 0, l_desc[2 * i], l_desc[2 * i + 1]};
}

// Left keypoint i on one warp: the band walk, the SADs, the outputs.
__device__ __forceinline__ void match_one(
    int i, const LeftKp& kp, const int* off, const Rec* recs, int rows,
    const float* __restrict__ band_tab, const float* __restrict__ img_l,
    const float* __restrict__ img_r, int h, int w, float bf, float b_over, float* sad_s,
    float* __restrict__ ur_out, float* __restrict__ depth_out) {
  const int lane = threadIdx.x & 31;
  const float2 luv = kp.uv;
  const int llv = kp.level;
  const float band = band_tab[min(max(llv, 0), BAND_LEVELS - 1)];

  // the coarse match over the band's buckets: least cost, lowest j among
  // equals, with the winner's u carried along
  int best = BIG, arg = INT_MAX;
  float bu = 0.f;
  if (kp.valid) {
    const int lo = clamp_row(__fsub_rn(floorf(__fsub_rn(luv.y, band)), 1.f), rows);
    const int hi = clamp_row(__fadd_rn(floorf(__fadd_rn(luv.y, band)), 1.f), rows);
    const int end = off[hi + 1];
    for (int k = off[lo] + lane; k < end; k += 64) {   // two records a lane, loaded first
      Rec r2[2]{};
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (k + 32 * q < end) r2[q] = recs[k + 32 * q];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const Rec& r = r2[q];
        const float disp = __fsub_rn(luv.x, r.u);
        const bool in = k + 32 * q < end && fabsf(__fsub_rn(luv.y, r.v)) <= band &&
                        disp >= -1.f && disp <= b_over && abs(llv - r.level) <= 1;
        if (in) {
          const int c = hamming(kp.a0, kp.a1, r.d0, r.d1);
          if (c < best || (c == best && r.j < arg)) { best = c; arg = r.j; bu = r.u; }
        }
      }
    }
  }
  for (int o = 16; o; o >>= 1) {               // every lane shuffles, then compares
    const int b2 = __shfl_xor_sync(FULL, best, o);
    const int a2 = __shfl_xor_sync(FULL, arg, o);
    const float u2 = __shfl_xor_sync(FULL, bu, o);
    if (b2 < best || (b2 == best && a2 < arg)) { best = b2; arg = a2; bu = u2; }
  }
  if (best >= TH_ORB_DIST) {                    // unmatched: its index is immaterial
    if (lane == 0) { ur_out[i] = -1.f; depth_out[i] = 0.f; }
    return;
  }

  const float uR0 = bu;
  float uR = uR0;
  if (img_l != nullptr) {
    // stage the left patch (L, 11 x 11) and the right strip (S, 11 x 21)
    float* L = sad_s;
    float* S = sad_s + PATCH * PATCH;
    float* RS = S + PATCH * STRIP;             // RS[k * 11 + r]: offset k, row r
    const int uc = static_cast<int>(rintf(luv.x)), vc = static_cast<int>(rintf(luv.y));
    const int rc = static_cast<int>(rintf(uR0));
    constexpr int NL = (PATCH * PATCH + 31) / 32, NS = (PATCH * STRIP + 31) / 32;
    float lv[NL], sv[NS];                       // every pixel load in flight at once
#pragma unroll
    for (int q = 0; q < NL; ++q) {
      const int t = lane + 32 * q, r = t / PATCH, c = t - r * PATCH;
      lv[q] = t < PATCH * PATCH ? pixel(img_l, h, w, vc - SAD_HALF + r, uc - SAD_HALF + c) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      const int t = lane + 32 * q, r = t / STRIP, c = t - r * STRIP;
      sv[q] = t < PATCH * STRIP
          ? pixel(img_r, h, w, vc - SAD_HALF + r, rc - SAD_HALF - SLIDE + c) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < NL; ++q)
      if (lane + 32 * q < PATCH * PATCH) L[lane + 32 * q] = lv[q];
#pragma unroll
    for (int q = 0; q < NS; ++q)
      if (lane + 32 * q < PATCH * STRIP) S[lane + 32 * q] = sv[q];
    __syncwarp();
#pragma unroll
    for (int q = 0; q < (N_OFF * PATCH + 31) / 32; ++q) {   // one row of one offset's window
      const int t = lane + 32 * q;
      if (t < N_OFF * PATCH) {
        const int k = t / PATCH, r = t - k * PATCH;
        const float* sr = S + r * STRIP + k;
        const float* lr = L + r * PATCH;
        float row = fabsf(__fsub_rn(sr[0], lr[0]));
#pragma unroll
        for (int c = 1; c < PATCH; ++c) row = __fadd_rn(row, fabsf(__fsub_rn(sr[c], lr[c])));
        RS[t] = row;
      }
    }
    __syncwarp();
    float sad = 0.f;
    if (lane < N_OFF) {                         // the rows top to bottom
      sad = RS[lane * PATCH];
#pragma unroll
      for (int r = 1; r < PATCH; ++r) sad = __fadd_rn(sad, RS[lane * PATCH + r]);
    }
    __syncwarp();                               // RS is read before the next stage
    // the lowest offset of least SAD (every lane shuffles, then compares)
    int kb = 0;
    float sb = __shfl_sync(FULL, sad, 0);
#pragma unroll
    for (int k = 1; k < N_OFF; ++k) {
      const float sk = __shfl_sync(FULL, sad, k);
      if (sk < sb) { sb = sk; kb = k; }
    }
    const bool interior = kb > 0 && kb < 2 * SLIDE;
    const int km = min(max(kb, 1), 2 * SLIDE - 1);
    const float s_m1 = __shfl_sync(FULL, sad, km - 1), s_0 = __shfl_sync(FULL, sad, km),
                s_p1 = __shfl_sync(FULL, sad, km + 1);
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

template <bool CTA_SORT, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
walk_kernel(const float2* __restrict__ l_uv, const int* __restrict__ l_level,
            const uint4* __restrict__ l_desc, const unsigned char* __restrict__ l_valid, int n,
            const float2* __restrict__ r_uv, const int* __restrict__ r_level,
            const uint4* __restrict__ r_desc, const unsigned char* __restrict__ r_valid, int m,
            int rows, const int* __restrict__ g_off, const Rec* __restrict__ g_recs,
            const float* __restrict__ band_tab, const float* __restrict__ img_l,
            const float* __restrict__ img_r, int h, int w, float bf, float b_over,
            float* __restrict__ ur_out, float* __restrict__ depth_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  float* sad_s = reinterpret_cast<float*>(smem) + warp * SAD_FLOATS;
  const int i0 = blockIdx.x * WARPS + warp, stride = gridDim.x * WARPS;   // warp-uniform
  LeftKp kp{};
  if (i0 < n) kp = load_left(l_uv, l_level, l_desc, l_valid, i0);
  const int* off = g_off;
  const Rec* recs = g_recs;
  if constexpr (CTA_SORT) {
    Rec* s_recs = reinterpret_cast<Rec*>(smem + (img_l != nullptr ? WARPS * SAD_FLOATS * 4 : 0));
    int* s_off = reinterpret_cast<int*>(s_recs + m);
    int* s_cnt = s_off + rows + 1;
    build_buckets<WARPS * 32>(r_uv, r_level, r_desc, r_valid, m, rows, s_cnt, s_off, s_recs,
                              s_cnt + rows);
    __syncthreads();
    off = s_off;
    recs = s_recs;
  }
  for (int i = i0; i < n; i += stride) {
    if (i != i0) kp = load_left(l_uv, l_level, l_desc, l_valid, i);
    match_one(i, kp, off, recs, rows, band_tab, img_l, img_r, h, w, bf, b_over, sad_s, ur_out,
              depth_out);
  }
}

// shared memory of the buckets built in every CTA: m records, then off
// [rows + 1], cnt [rows] and 32 warp totals
size_t bucket_smem(int m, int rows) {
  return static_cast<size_t>(m) * sizeof(Rec) + (2 * static_cast<size_t>(rows) + 33) * sizeof(int);
}

size_t walk_smem(bool cta_sort, bool images, int m, int rows) {
  const int warps = cta_sort ? WARPS1 : WARPS0;
  return (images ? static_cast<size_t>(warps) * SAD_FLOATS * sizeof(float) : 0) +
         (cta_sort ? bucket_smem(m, rows) : 0);
}

struct DeviceInfo {                           // read once per device
  int sms = 0, max_smem = 0;
};

const DeviceInfo& device_info(int device) {
  static DeviceInfo info[64];
  DeviceInfo& d = info[device & 63];
  if (d.sms == 0) {
    cudaDeviceGetAttribute(&d.max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    // the buckets built in every CTA may take all of it (set once, outside
    // any graph capture)
    cudaFuncSetAttribute(walk_kernel<true, WARPS1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         d.max_smem);
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    d.sms = sms > 0 ? sms : 1;
  }
  return d;
}

// the bucket launch into scratch: records [m], then off [rows + 1]
cudaError_t launch_buckets(const float2* r_uv, const int* r_level, const uint4* r_desc,
                           const unsigned char* r_valid, int m, int rows, void* scratch,
                           cudaStream_t st) {
  Rec* recs = static_cast<Rec*>(scratch);
  bucket_kernel<<<1, SORT_THREADS, (static_cast<size_t>(rows) + 32) * sizeof(int), st>>>(
      r_uv, r_level, r_desc, r_valid, m, rows, reinterpret_cast<int*>(recs + m), recs);
  return cudaGetLastError();
}

}  // namespace

// The bucket launch alone, as stereo_match_launch makes it past a block's
// shared memory, into scratch: records [m] of 48 bytes (u, v, level, j, the
// descriptor; the first off[rows] of them written), then the offsets
// [rows + 1] int32.
extern "C" int stereo_buckets_launch(const void* r_uv, const void* r_level, const void* r_desc,
                                     const void* r_valid, int m, int rows, void* scratch,
                                     int device, void* stream) {
  if (m < 0 || rows < 1 || rows > MAX_ROWS || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  return static_cast<int>(launch_buckets(
      static_cast<const float2*>(r_uv), static_cast<const int*>(r_level),
      static_cast<const uint4*>(r_desc), static_cast<const unsigned char*>(r_valid), m, rows,
      scratch, reinterpret_cast<cudaStream_t>(stream)));
}

// l_uv [n, 2] f32 (8-byte aligned), l_level [n] int32, l_desc [n, 32] uint8
// (16-byte aligned), l_valid [n] bool; r_* likewise with m rows; band_tab
// [32] f32; img_l, img_r [h, w] f32, or both null (no SAD refinement);
// rows: the bucket table's rows (1..4096; keypoints past it clamp into the
// last); scratch: m * 48 + (rows + 1) * 4 bytes, 16-byte aligned, laid out
// as stereo_buckets_launch's (used only where the buckets do not fit a
// block's shared memory: then the bucket launch, then the walk; else every
// CTA builds them in its own shared memory, one launch); ur, depth [n] f32.
extern "C" int stereo_match_launch(const void* l_uv, const void* l_level, const void* l_desc,
                                   const void* l_valid, int n, const void* r_uv,
                                   const void* r_level, const void* r_desc, const void* r_valid,
                                   int m, const void* band_tab, const void* img_l,
                                   const void* img_r, int h, int w, float bf, float b_over,
                                   int rows, void* scratch, void* ur, void* depth, int device,
                                   void* stream) {
  if (n < 0 || m < 0 || rows < 1 || rows > MAX_ROWS || ((img_l == nullptr) != (img_r == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(device);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool images = img_l != nullptr;
  const DeviceInfo& dev = device_info(device);
  const size_t smem1 = walk_smem(true, images, m, rows);
  const bool cta_sort = smem1 <= static_cast<size_t>(dev.max_smem);

  const auto* luv = static_cast<const float2*>(l_uv);
  const auto* llv = static_cast<const int*>(l_level);
  const auto* ldesc = static_cast<const uint4*>(l_desc);
  const auto* lval = static_cast<const unsigned char*>(l_valid);
  const auto* ruv = static_cast<const float2*>(r_uv);
  const auto* rlv = static_cast<const int*>(r_level);
  const auto* rdesc = static_cast<const uint4*>(r_desc);
  const auto* rval = static_cast<const unsigned char*>(r_valid);
  const auto* band = static_cast<const float*>(band_tab);
  const auto* il = static_cast<const float*>(img_l);
  const auto* ir = static_cast<const float*>(img_r);
  auto* out_ur = static_cast<float*>(ur);
  auto* out_depth = static_cast<float*>(depth);
  if (cta_sort) {
    walk_kernel<true, WARPS1><<<min((n + WARPS1 - 1) / WARPS1, dev.sms), WARPS1 * 32, smem1, st>>>(
        luv, llv, ldesc, lval, n, ruv, rlv, rdesc, rval, m, rows, nullptr, nullptr, band, il, ir,
        h, w, bf, b_over, out_ur, out_depth);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_buckets(ruv, rlv, rdesc, rval, m, rows, scratch, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Rec* recs = static_cast<const Rec*>(scratch);
  walk_kernel<false, WARPS0><<<(n + WARPS0 - 1) / WARPS0, WARPS0 * 32,
                               walk_smem(false, images, m, rows), st>>>(
      luv, llv, ldesc, lval, n, ruv, rlv, rdesc, rval, m, rows,
      reinterpret_cast<const int*>(recs + m), recs, band, il, ir, h, w, bf, b_over, out_ur,
      out_depth);
  return static_cast<int>(cudaGetLastError());
}
