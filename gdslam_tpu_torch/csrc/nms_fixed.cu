// Fixed-budget greedy NMS for Hopper (sm_90a): a suppression bitmask, then
// one warp walking it.
//
// Replaces the stage that XLA fuses into the JAX package's Mask R-CNN
// program: `nms_fixed`, gdslam_tpu/models/maskrcnn.py:202 (there is no Pallas
// kernel for it). Plain twin: gdslam_tpu_torch/ops/detect_kernels.py
// nms_fixed_plain. Two call sites per frame: the proposals (N = 1024,
// n_out = 128, IoU threshold 0.7) and the detections (N = 128, n_out = 32,
// threshold 0.3, scores -inf below the score threshold).
//
// What it computes. n_out steps; each picks the alive box of highest score
// (the lowest index among ties, as jnp.argmax) and writes its index, or -1
// once no box is alive; then clears every box j with !(iou(best, j) <= th)
// (a NaN IoU suppresses), and best itself. A box is alive at the start when
// its score is above -inf.
//
// The same indices as a walk in sorted order. Rank the boxes by (score
// descending, index ascending), the dead ones (score -inf or NaN) last. The
// greedy step's argmax is always the first box in that order that no kept
// box has suppressed, so walking the order and keeping each box that no
// earlier kept box suppresses gives the greedy's picks, in its order. Stop
// at n_out kept or at the first dead box, and pad with -1.
//
// Design: one wrapper call is two CUDA launches.
//   1. nms_mask_kernel, one CTA per box i, one warp per 32-column word:
//      mask[i][w] bit b is !(iou(box_i, box_{32w+b}) <= th), box_i as the
//      `a` argument as iou[best] is in JAX, and box i's rank (the boxes that
//      beat it, counted by ballots) gives order[rank] = i. N^2 IoUs, all in
//      parallel; no atomics, so the result is the same on every run.
//   2. nms_walk_kernel, one warp. Lane w holds word w of the removed set. A
//      chunk of 32 candidates of `order` is decided at once: their mask rows
//      are loaded together (the loads do not depend on the decisions), a
//      32 x 32 matrix of which candidate suppresses which is gathered by
//      shuffles and ballots, and the serial part is a walk over 32 bits in
//      one register. The kept rows are then OR-ed into the removed set.
// The IoU is box_iou's formula term by term with single IEEE roundings
// (__fmul_rn and friends, and the file is built with -fmad=false), so no
// threshold comparison can flip against the plain version.
//
// What bounds it on this card. The inputs are N x 20 bytes (20 KB at
// N = 1024) and the work is N^2 IoUs, all independent: neither bytes nor
// operations bound it. The time approaches the walk's chain:
// at most N / 32 chunks, each a round of dependent loads (order, then the
// rows) and a 32-step bit walk. The bound that chip_smoke.py reports counts
// the greedy's operations, the same work whatever implements it.
// Scratch (N x ceil(N / 32) words of mask, then N of order; 132 KB at
// N = 1024) comes from the wrapper: the kernel allocates nothing.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int MAX_N = 1024;
constexpr int MAX_WORDS = MAX_N / 32;
constexpr unsigned FULL = 0xffffffffu;

struct DeviceGuard {                          // the launch goes to `device`
  int prev = -1;
  explicit DeviceGuard(int device) {
    cudaGetDevice(&prev);
    if (prev != device) cudaSetDevice(device); else prev = -1;
  }
  ~DeviceGuard() { if (prev >= 0) cudaSetDevice(prev); }
};

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// iou(a, b) as box_iou computes it: inter / max(area_a + area_b - inter, 1e-9)
__device__ __forceinline__ float box_iou(float4 a, float area_a, float4 b, float area_b) {
  const float y1 = fmaxf(a.x, b.x), x1 = fmaxf(a.y, b.y);
  const float y2 = fminf(a.z, b.z), x2 = fminf(a.w, b.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(y2, y1), 0.f), fmaxf(__fsub_rn(x2, x1), 0.f));
  const float den = fmaxf(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-9f);
  return __fdiv_rn(inter, den);
}

// the sort key: the score of an alive box, -inf for a dead one (NaN included)
__device__ __forceinline__ float sort_key(float s) { return s > -INFINITY ? s : -INFINITY; }

__global__ void __launch_bounds__(MAX_N)
nms_mask_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores, int n,
                int words, float th, uint32_t* __restrict__ mask, int* __restrict__ order) {
  __shared__ int s_beaten[MAX_WORDS];
  const int i = blockIdx.x, j = threadIdx.x, lane = j & 31, w = j >> 5;
  const float4 bi = boxes[i];
  const float ki = sort_key(scores[i]);
  bool suppress = false, beats = false;
  if (j < n) {
    const float4 bj = boxes[j];
    suppress = !(box_iou(bi, box_area(bi), bj, box_area(bj)) <= th);
    const float kj = sort_key(scores[j]);
    beats = kj > ki || (kj == ki && j < i);
  }
  const unsigned word = __ballot_sync(FULL, suppress);
  const unsigned beaten = __ballot_sync(FULL, beats);
  if (lane == 0) {
    mask[static_cast<size_t>(i) * words + w] = word;
    s_beaten[w] = __popc(beaten);
  }
  __syncthreads();
  if (j == 0) {
    int rank = 0;
    for (int v = 0; v < words; ++v) rank += s_beaten[v];
    order[rank] = i;
  }
}

__global__ void __launch_bounds__(32)
nms_walk_kernel(const float* __restrict__ scores, const uint32_t* __restrict__ mask,
                const int* __restrict__ order, int n, int words, int n_out,
                int* __restrict__ out) {
  const int lane = threadIdx.x;
  uint32_t removed = 0;                       // word `lane` of the suppressed set
  int kept_n = 0;
  for (int base = 0; base < n && kept_n < n_out; base += 32) {
    const int k = base + lane;
    const int c = k < n ? order[k] : 0;       // this lane's candidate
    const bool alive = k < n && scores[c] > -INFINITY;
    const unsigned alive_bits = __ballot_sync(FULL, alive);   // a prefix: dead boxes sort last
    uint32_t row[32];                         // word `lane` of each candidate's mask row
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const int ct = __shfl_sync(FULL, c, t);
      row[t] = (lane < words && ((alive_bits >> t) & 1u))
                   ? __ldg(mask + static_cast<size_t>(ct) * words + lane) : 0u;
    }
    const int cw = c >> 5, cb = c & 31;
    uint32_t local[32];                       // bit u of local[t]: candidate t suppresses u
#pragma unroll
    for (int t = 0; t < 32; ++t)
      local[t] = __ballot_sync(FULL, (__shfl_sync(FULL, row[t], cw) >> cb) & 1u);
    const uint32_t removed_word = __shfl_sync(FULL, removed, cw);   // every lane shuffles
    uint32_t open = __ballot_sync(FULL, alive && !((removed_word >> cb) & 1u));
    uint32_t kept = 0;
#pragma unroll
    for (int t = 0; t < 32; ++t)
      if ((open >> t) & 1u) {
        kept |= 1u << t;
        open &= ~local[t];
      }
    while (__popc(kept) > n_out - kept_n) kept &= ~(1u << (31 - __clz(kept)));
    if ((kept >> lane) & 1u) out[kept_n + __popc(kept & ((1u << lane) - 1u))] = c;
#pragma unroll
    for (int t = 0; t < 32; ++t)
      if ((kept >> t) & 1u) removed |= row[t];
    kept_n += __popc(kept);
    if (alive_bits != FULL) break;            // the first dead box: the rest are dead too
  }
  for (int s = kept_n + lane; s < n_out; s += 32) out[s] = -1;
}

}  // namespace

// boxes [n, 4] f32 (16-byte aligned), scores [n] f32, 1 <= n <= 1024;
// out [n_out] int32; scratch: n * ceil(n / 32) + n int32 words. Two launches.
extern "C" int nms_fixed_launch(const void* boxes, const void* scores, int n, float th,
                                int n_out, void* out, void* scratch, int device, void* stream) {
  if (n < 1 || n > MAX_N || n_out < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(device);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int words = (n + 31) / 32;
  uint32_t* mask = static_cast<uint32_t*>(scratch);
  int* order = reinterpret_cast<int*>(mask + static_cast<size_t>(n) * words);
  nms_mask_kernel<<<n, words * 32, 0, s>>>(static_cast<const float4*>(boxes),
                                            static_cast<const float*>(scores), n, words, th,
                                            mask, order);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_walk_kernel<<<1, 32, 0, s>>>(static_cast<const float*>(scores), mask, order, n, words,
                                   n_out, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
