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
// Design: one warp per row, ROWS_PER_CTA rows per CTA sharing the logits
// staged once in shared memory; each lane strides over j keeping its
// running (score, index), then a shuffle argmax on all 32 lanes (no shuffle
// under a divergent condition).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ROWS_PER_CTA = 4;
constexpr int THREADS = 32 * ROWS_PER_CTA;
constexpr int MAX_STAGED = 12288;             // logits staged in 48 KB of shared memory

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

__global__ void __launch_bounds__(THREADS)
categorical_kernel(const float* __restrict__ logits, int n, int rows,
                   uint32_t k0, uint32_t k1,
                   const long long* __restrict__ fold, long long* __restrict__ out,
                   float* __restrict__ noise) {
  extern __shared__ float s_logits[];
  const bool staged = n <= MAX_STAGED;
  if (staged)
    for (int j = threadIdx.x; j < n; j += THREADS) s_logits[j] = logits[j];
  if (fold != nullptr) {
    uint32_t a = 0u, b = static_cast<uint32_t>(fold[0]);
    threefry(k0, k1, a, b);
    k0 = a;
    k1 = b;
  }
  __syncthreads();
  const float* lg = staged ? s_logits : logits;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_CTA + (threadIdx.x >> 5);
  float best = -INFINITY;
  int arg = n;                                // beaten by any element, -inf included
  if (row < rows) {
    const unsigned long long base = static_cast<unsigned long long>(row) * n;
#pragma unroll 4
    for (int j = lane; j < n; j += 32) {
      const float g = gumbel(k0, k1, base + j);
      if (noise != nullptr) noise[base + j] = g;
      const float v = g + lg[j];
      if (beats(v, j, best, arg)) { best = v; arg = j; }
    }
  }
  for (int s = 16; s > 0; s >>= 1) {          // every lane shuffles, then compares
    const float ov = __shfl_xor_sync(0xFFFFFFFFu, best, s);
    const int oi = __shfl_xor_sync(0xFFFFFFFFu, arg, s);
    if (beats(ov, oi, best, arg)) { best = ov; arg = oi; }
  }
  if (row < rows && lane == 0) out[row] = arg;
}

}  // namespace

// logits [n] f32 (finite or -inf); k0, k1: the key's words; fold: [1]
// int64 on the device or null; out
// [rows] int64; noise: [rows, n] f32 or null, the Gumbel noise written out
// (for the comparison with the plain twin).
extern "C" int categorical_draw_launch(const void* logits, int n, int rows, unsigned k0,
                                       unsigned k1, const void* fold, void* out,
                                       void* noise, int device, void* stream) {
  if (n < 1 || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(device);
  const size_t smem = n <= MAX_STAGED ? static_cast<size_t>(n) * sizeof(float) : 0;
  const int blocks = (rows + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  categorical_kernel<<<blocks, THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), n, rows, k0, k1,
      static_cast<const long long*>(fold), static_cast<long long*>(out),
      static_cast<float*>(noise));
  return static_cast<int>(cudaGetLastError());
}
