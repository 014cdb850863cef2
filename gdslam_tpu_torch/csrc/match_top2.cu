// Fused projection-guided descriptor matcher for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// gdslam_tpu/ops/pallas_match.py:98 (match_top2, body _kernel at :37).
//
// For each keypoint n and candidate row m:
//   cost[m, n] = Hamming(cand_desc[m], kp_desc[n])   if du^2 + dv^2 <= r_m^2,
//                                                      |level_m - level_n| <= slack,
//                                                      and both rows are valid
//              = BIG (2^20)                           otherwise.
// Outputs, all int32:
//   best[n], second[n] (second smallest, counting duplicates), arg[n] (lowest
//   row among ties, -1 when every cost is BIG), and best_cand[m] = min over
//   keypoints, which the matcher's one-to-one rule needs. No [M, N] matrix is
//   materialised.
//
// Design. One block per tile of 32 keypoints, one keypoint per lane; the
// block's WARPS warps split the candidate rows (warp w walks rows
// j = w, w + WARPS, ... of each staged block in ascending order with a strict
// `<` update, so ties keep the lowest row), and the per-warp top-2 are merged
// at the end, lowest row first among equal costs. Candidate blocks (uv, r^2,
// level, 8 descriptor words) are staged through shared memory; every lane of
// a warp reads the same candidate word, which is a broadcast. The geometric
// window is tested first; only a row that some lane of the warp can match
// pays for the descriptor: Hamming is sum(__popc(a ^ b)) over the packed
// 8 x 32-bit words. On the tracker's inputs under 1% of the pairs fall in
// the window. best_cand is a warp min-reduction per row followed by one int
// atomicMin; min commutes, so the result does not depend on the order of
// the atomics.
//
// The radius test rounds each product and sum separately (__fmul_rn,
// __fadd_rn, and the file is built with -fmad=false): a fused multiply-add
// would round differently from the reference's separate f32 operations, and
// a pair exactly on the radius could flip.
//
// Bound on the card: every pair needs the window test (6 f32 + 5 int32
// operations) and each pair inside the window 8 XOR + 8 POPC + 9 adds and
// compares, against about (M + N) * 48 bytes of input: it is bound by
// operations, not bytes (chip_smoke.py computes the bound from each call's
// data; PERF.md has the numbers). With 32 keypoints per block, N = 1500
// fills 47 of the card's 132 SMs; splitting the rows across blocks would
// need a merge pass and is left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 20;
constexpr int KP_TILE = 32;      // keypoints per block: one per lane
constexpr int WARPS = 16;        // warps per block, each walks 1/WARPS of the rows
constexpr int THREADS = KP_TILE * WARPS;
constexpr int CAND_BLK = THREADS;  // candidate rows staged per step: one per thread
constexpr int DESC_WORDS = 8;    // 256 bits

__global__ void fill_kernel(int* __restrict__ p, int n, int v) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) p[i] = v;
}

__global__ void __launch_bounds__(THREADS)
match_top2_kernel(const float* __restrict__ cand_uv,
                  const uint32_t* __restrict__ cand_desc,
                  const float* __restrict__ cand_radius,
                  const int* __restrict__ cand_level,
                  const uint8_t* __restrict__ cand_valid, int M,
                  const float* __restrict__ kp_uv,
                  const uint32_t* __restrict__ kp_desc,
                  const int* __restrict__ kp_level,
                  const uint8_t* __restrict__ kp_valid, int N,
                  int level_slack,
                  int* __restrict__ best_out, int* __restrict__ second_out,
                  int* __restrict__ arg_out, int* __restrict__ best_cand) {
  __shared__ float s_u[CAND_BLK];
  __shared__ float s_v[CAND_BLK];
  __shared__ float s_r2[CAND_BLK];   // radius^2, or -1 for an invalid row
  __shared__ int s_lvl[CAND_BLK];
  __shared__ uint32_t s_desc[CAND_BLK][DESC_WORDS];
  __shared__ int s_best[WARPS][KP_TILE];
  __shared__ int s_second[WARPS][KP_TILE];
  __shared__ int s_arg[WARPS][KP_TILE];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.x * KP_TILE + lane;

  float ku = 0.f, kv = 0.f;
  int kl = 0;
  bool kval = false;
  uint32_t kd[DESC_WORDS];
#pragma unroll
  for (int i = 0; i < DESC_WORDS; ++i) kd[i] = 0u;
  if (k < N) {
    ku = kp_uv[2 * k];
    kv = kp_uv[2 * k + 1];
    kl = kp_level[k];
    kval = kp_valid[k] != 0;
#pragma unroll
    for (int i = 0; i < DESC_WORDS; ++i) kd[i] = kp_desc[DESC_WORDS * k + i];
  }

  int best = BIG, second = BIG, arg = -1;
  for (int base = 0; base < M; base += CAND_BLK) {
    __syncthreads();  // the previous stage has been consumed
    {
      const int t = threadIdx.x;
      const int row = base + t;
      if (row < M) {
        s_u[t] = cand_uv[2 * row];
        s_v[t] = cand_uv[2 * row + 1];
        const float r = cand_radius[row];
        s_r2[t] = cand_valid[row] ? __fmul_rn(r, r) : -1.0f;
        s_lvl[t] = cand_level[row];
#pragma unroll
        for (int i = 0; i < DESC_WORDS; ++i)
          s_desc[t][i] = cand_desc[DESC_WORDS * row + i];
      }
    }
    __syncthreads();
    const int rows = min(CAND_BLK, M - base);
    for (int j = warp; j < rows; j += WARPS) {
      const float du = __fsub_rn(s_u[j], ku);
      const float dv = __fsub_rn(s_v[j], kv);
      const float d2 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
      const int dl = abs(s_lvl[j] - kl);
      const bool ok = kval && (d2 <= s_r2[j]) && (dl <= level_slack);
      // A pair outside the window costs BIG, which changes neither top-2 nor
      // best_cand: rows that no lane of the warp can match are skipped.
      if (!__any_sync(0xffffffffu, ok)) continue;
      int h = 0;
#pragma unroll
      for (int i = 0; i < DESC_WORDS; ++i) h += __popc(s_desc[j][i] ^ kd[i]);
      const int cost = ok ? h : BIG;
      const int row = base + j;
      if (cost < best) {
        second = best;
        best = cost;
        arg = row;
      } else if (cost < second) {
        second = cost;
      }
      const int wmin = __reduce_min_sync(0xffffffffu, cost);
      if (lane == 0 && wmin < BIG) atomicMin(&best_cand[row], wmin);
    }
  }

  s_best[warp][lane] = best;
  s_second[warp][lane] = second;
  s_arg[warp][lane] = arg;
  __syncthreads();
  if (warp == 0 && k < N) {
    int b = s_best[0][lane], s = s_second[0][lane], a = s_arg[0][lane];
    for (int w = 1; w < WARPS; ++w) {
      const int b2 = s_best[w][lane], s2 = s_second[w][lane], a2 = s_arg[w][lane];
      if (b2 < b || (b2 == b && b2 < BIG && a2 < a)) {
        s = min(s2, b);
        b = b2;
        a = a2;
      } else {
        s = min(s, b2);
      }
    }
    best_out[k] = b;
    second_out[k] = s;
    arg_out[k] = a;
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t passed as a pointer-sized int) and
// returns cudaGetLastError() as an int (0 = success). Descriptors are packed
// 32-byte rows read as 8 little-endian uint32 words.
extern "C" int match_top2_launch(const float* cand_uv, const uint32_t* cand_desc,
                                 const float* cand_radius, const int* cand_level,
                                 const uint8_t* cand_valid, int M,
                                 const float* kp_uv, const uint32_t* kp_desc,
                                 const int* kp_level, const uint8_t* kp_valid, int N,
                                 int level_slack, int* best, int* second, int* arg,
                                 int* best_cand, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M > 0) fill_kernel<<<(M + 255) / 256, 256, 0, s>>>(best_cand, M, BIG);
  if (N > 0) {
    match_top2_kernel<<<(N + KP_TILE - 1) / KP_TILE, THREADS, 0, s>>>(
        cand_uv, cand_desc, cand_radius, cand_level, cand_valid, M,
        kp_uv, kp_desc, kp_level, kp_valid, N, level_slack,
        best, second, arg, best_cand);
  }
  return static_cast<int>(cudaGetLastError());
}
