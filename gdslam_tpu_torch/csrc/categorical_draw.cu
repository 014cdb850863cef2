// JAX's categorical draw (Threefry-2x32 Gumbel noise, then an argmax) for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package draws its RANSAC samples with
// `jax.random.categorical` (gdslam_tpu/backend/solvers.py:85, :141), which
// XLA fuses. The port must draw the same samples, since the draw decides
// which hypothesis wins (the GD pose, relocalization, the mono bootstrap,
// the loop's Sim3), and on the GD path the key changes every frame: a host
// replay would hash 900 x n counters in numpy each frame. Plain twin:
// gdslam_tpu_torch/ops/draw_kernel.py categorical_draw_plain; numpy
// reference: gdslam_tpu_torch/core/prng.py.
//
// What it computes. out[r] = argmax_j (g[r * n + j] + logits[j]) for r <
// rows, the lowest j among equal maxima, where g[f] is jax.random.gumbel's
// noise of flat index f under the key: the Threefry-2x32 hash of the
// counter pair (f >> 32, f & 0xffffffff), its two words XORed (the
// partitionable layout), the top 23 bits as a float in [1, 2) minus 1,
// floored at the smallest normal float, then -log(-log(u)). The key is two
// 32-bit words, the launch's arguments; with `fold` it is first replaced by
// fold_in(key, fold[0]), the hash of the counter (0, fold[0]), so a key
// derived from a device frame id needs no host value. The logf is the CUDA
// library's accurate one (no fast math), the one torch.log calls, so the
// noise equals the twin's bit for bit.
//
// What bounds it on this card. Operations: per element 77 integer
// operations (the counter, 20 rounds of add, rotate and xor, 5 key
// injections, the uniform's bits) plus two logf on the FP32 pipes; at
// 900 x 1500 ~1.04e8 integer operations, ~6.2 us on the INT32 lanes (132
// SMs x 64 lanes x 1.98 GHz). Bytes are negligible (the logits once, 8
// bytes a row).
//
// Design. One CTA a row, its columns split over WARPS = 4 warps (16 such
// CTAs fit an SM, so 900 rows and 1800 rows each run in one wave, 27-55
// warps an SM hide the hash chains' latency, and the SMs' loads differ by
// one row at most; on an H100 4 warps took 10.3 and 17.7 us at 900 and 1800
// rows, 8 warps 10.4 and 19.1, 16 warps 11.6 and 21.9, all from CUDA
// graphs, PERF.md), the logits staged
// once a CTA in shared memory (read from device memory past MAX_STAGED).
// The folded key is hashed once a CTA by its first warp. Each thread walks
// its columns two at a time (two independent hash chains in flight), the
// flat index a 64-bit counter advanced by the CTA's width (an add with an
// exact carry into the high word), keeping its running (score, index);
// then a shuffle argmax in each warp (every lane shuffles, then compares)
// and the warps' pairs combined in shared memory by the same total order,
// so the result does not depend on which warp holds which column. Two
// variants from one template: the one every call site launches stores
// nothing but the index; the one that also writes the noise (for the
// comparison with the twin) shares the same `gumbel`.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_STAGED = 12000;             // logits staged in 47 KB of shared memory
constexpr int WARPS = 4;                      // the warps of a row's CTA
constexpr int T = WARPS * 32;                 // its threads

struct DeviceGuard {                          // the launch goes to `device`
  int prev = -1;
  explicit DeviceGuard(int device) {
    cudaGetDevice(&prev);
    if (prev != device) cudaSetDevice(device); else prev = -1;
  }
  ~DeviceGuard() { if (prev >= 0) cudaSetDevice(prev); }
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// Threefry-2x32, 20 rounds (jax._src.prng's _threefry2x32_lowering)
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define TF_ROUND(r) x0 += x1; x1 = rotl(x1, r) ^ x0;
  x0 += k0; x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24) x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24) x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)  x0 += k2; x1 += k0 + 5u;
#undef TF_ROUND
}

// jax.random.gumbel's noise of flat index f (float32, "low" mode)
__device__ __forceinline__ float gumbel(uint32_t k0, uint32_t k1, unsigned long long f) {
  uint32_t a = static_cast<uint32_t>(f >> 32), b = static_cast<uint32_t>(f);
  threefry(k0, k1, a, b);
  const float u = __uint_as_float(((a ^ b) >> 9) | 0x3F800000u) - 1.0f;
  const float tiny = 1.17549435e-38f;
  return -logf(-logf(fmaxf(tiny, u + tiny)));
}

// (v, i) beats (bv, bi): larger, or equal with a lower index
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <bool WRITE_NOISE>
__global__ void __launch_bounds__(T, 2048 / T)
categorical_kernel(const float* __restrict__ logits, int n, uint32_t k0, uint32_t k1,
                   const long long* __restrict__ fold, long long* __restrict__ out,
                   float* __restrict__ noise) {
  extern __shared__ float s_logits[];
  __shared__ uint32_t s_key[2];
  __shared__ float s_best[WARPS];
  __shared__ int s_arg[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool staged = n <= MAX_STAGED;
  if (staged)
    for (int j = tid; j < n; j += T) s_logits[j] = logits[j];
  if (fold != nullptr && warp == 0) {         // the folded key, once a CTA
    uint32_t a = 0u, b = static_cast<uint32_t>(fold[0]);
    threefry(k0, k1, a, b);
    if (lane == 0) { s_key[0] = a; s_key[1] = b; }
  }
  __syncthreads();
  if (fold != nullptr) { k0 = s_key[0]; k1 = s_key[1]; }
  const float* lg = staged ? s_logits : logits;

  float best = -INFINITY;
  int arg = n;                                // beaten by any element, -inf included
  unsigned long long f = static_cast<unsigned long long>(blockIdx.x) * n + tid;   // row * n + j
  int j = tid;
  for (; j + T < n; j += 2 * T, f += 2 * T) { // two columns, two hash chains
    const float g0 = gumbel(k0, k1, f), g1 = gumbel(k0, k1, f + T);
    if constexpr (WRITE_NOISE) { noise[f] = g0; noise[f + T] = g1; }
    const float v0 = g0 + lg[j], v1 = g1 + lg[j + T];
    if (beats(v0, j, best, arg)) { best = v0; arg = j; }
    if (beats(v1, j + T, best, arg)) { best = v1; arg = j + T; }
  }
  if (j < n) {
    const float g = gumbel(k0, k1, f);
    if constexpr (WRITE_NOISE) noise[f] = g;
    const float v = g + lg[j];
    if (beats(v, j, best, arg)) { best = v; arg = j; }
  }
  for (int s = 16; s > 0; s >>= 1) {          // every lane shuffles, then compares
    const float ov = __shfl_xor_sync(0xFFFFFFFFu, best, s);
    const int oi = __shfl_xor_sync(0xFFFFFFFFu, arg, s);
    if (beats(ov, oi, best, arg)) { best = ov; arg = oi; }
  }
  if (lane == 0) { s_best[warp] = best; s_arg[warp] = arg; }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int w = 1; w < WARPS; ++w)
      if (beats(s_best[w], s_arg[w], best, arg)) { best = s_best[w]; arg = s_arg[w]; }
    out[blockIdx.x] = arg;
  }
}

}  // namespace

// logits [n] f32 (finite or -inf); k0, k1: the key's words; fold: [1]
// int64 on the device or null; out [rows] int64; noise: [rows, n] f32 or
// null, the Gumbel noise written out (for the comparison with the plain
// twin; null launches the variant that stores nothing else).
extern "C" int categorical_draw_launch(const void* logits, int n, int rows, unsigned k0,
                                       unsigned k1, const void* fold, void* out, void* noise,
                                       int device, void* stream) {
  if (n < 1 || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(device);
  const size_t smem = n <= MAX_STAGED ? static_cast<size_t>(n) * sizeof(float) : 0;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* lg = static_cast<const float*>(logits);
  const long long* fd = static_cast<const long long*>(fold);
  long long* o = static_cast<long long*>(out);
  float* nz = static_cast<float*>(noise);
  if (nz != nullptr)
    categorical_kernel<true><<<rows, T, smem, st>>>(lg, n, k0, k1, fd, o, nz);
  else
    categorical_kernel<false><<<rows, T, smem, st>>>(lg, n, k0, k1, fd, o, nullptr);
  return static_cast<int>(cudaGetLastError());
}
