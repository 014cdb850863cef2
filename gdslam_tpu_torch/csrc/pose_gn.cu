// The pose Gauss-Newton solve for Hopper (sm_90a): one kernel, pose_gn.
//
// Replaces the program XLA fuses for the JAX package's
// `backend/optimizer.py::pose_optimization` (gdslam_tpu/backend/optimizer.py:84;
// `gn_iter` :99 inside the `fori_loop` :114; there is no Pallas kernel for
// it). Plain twin: gdslam_tpu_torch/ops/pose_kernel.py `pose_gn_plain`,
// which writes out this kernel's order. Every product and sum is one IEEE
// rounding (built with -fmad=false; sqrtf and `/` correctly rounded), in the
// twin's order, so the two are equal bit for bit.
//
// One CTA of BLOCK = 512 threads solves one pose, all rounds * iters
// iterations in one launch. The N observation rows (pw, uv, ur, inv_sigma2,
// valid: 8 floats a row) are read from device memory once, into shared
// memory, where every iteration reads them again; rows past the first
// MAX_ROWS (5120) stay in device memory and are read from there each
// iteration, the same values in the same order. Thread t takes rows t,
// t + 512, t + 1024, ... In an iteration each row gives, at the pose in
// shared memory, its residuals (u, v and, where ur >= 0, the right u), its
// Huber weight against 5.991 / 7.815 times inv_sigma2, gated by `valid` and
// by z > 1e-6, and its 3 x 6 Jacobian under T <- exp(dxi) T; from them 27
// sums: H's upper triangle row by row (Jw_i * J_j over the three residual
// rows, added in order) and b (Jw_i * r). A thread adds its rows in order
// from +0; the block adds the threads by a fixed tree, a[t] += a[t + s] for
// s = 256, ..., 1: the first four levels by one lane from 16 values in
// shared memory, the last five by shuffles, a warp a sum. No atomics on
// floats.
// Thread 0 then adds 1e-5 to H's diagonal, factors it (Cholesky, each
// entry minus L_ik L_jk for k ascending), solves L y = b (k ascending)
// and L^T x = y (k descending), keeps dx = -x only if all six are finite (a
// pivot that is not positive gives a NaN or an infinity, so this also stands
// for a failed factorisation) and sets T <- se3_exp(dx) T in shared memory.
// After the last iteration every row's chi2 at the final T gives the inlier
// mask (valid, chi2 <= its gate, z > 1e-6) and its count (int64).
//
// The width is part of the order (each width is one rounding of the same
// sums) and is chosen for speed: on an H100 the tracker's 1500-row solve
// took 108 us at 512 threads, 115 at 256 and 140 at 128 (PERF.md). The
// block tree's first levels run in registers with fixed trip counts: with
// a loop bounded by the level the lane's 16 values went to local memory
// and the solve took 137 us.
//
// Bound (chip_smoke.py's POSE_OPS_*): 262 float operations a row and
// iteration (arithmetic, compares and selects; 126 of them H's products and
// sums), ~460 for the 6 x 6 solve and se3_exp of an iteration and 46 a row
// for the inlier mask: 7.9 M at 1500 rows and 20 iterations, ~0.12 us at the
// H100's 67 TFLOP/s; 29 bytes a row read once and 1 written (45 KB, ~0.013
// us). Both lie under one launch's ~1 us floor. One CTA sits on one SM,
// whose 128 float lanes issue one operation a cycle each: ~35 us at 1.755
// GHz is the least a one-CTA design can take, before the serial solve of
// thread 0 (six square roots, 27 divisions, a sin and a cos in one dependent
// chain) and three block barriers, every iteration. Spreading a solve over a
// thread-block cluster is the way past that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 512;                   // ops/pose_kernel.py BLOCK
constexpr int WARPS = BLOCK / 32;
constexpr int NS = 27;                       // H's 21 upper entries row by row, then b's 6
constexpr int ROW_F = 8;                     // floats staged a row
constexpr int MAX_ROWS = 5120;               // rows staged in shared memory (STAGED_ROWS)
constexpr int SMEM_BYTES = (NS * BLOCK + ROW_F * MAX_ROWS) * 4;
constexpr float Z_MIN = 1e-6f;
constexpr float CHI2_MONO = 5.991f, CHI2_STEREO = 7.815f;
constexpr float E2_MIN = 1e-12f;
constexpr float DAMPING = 1e-5f;
constexpr float EPS_THETA2 = 1e-8f, EPS2 = 1e-16f;
constexpr float RCP6 = 1.0f / 6.0f, RCP24 = 1.0f / 24.0f, RCP120 = 1.0f / 120.0f;
constexpr unsigned FULL = 0xffffffffu;

struct Cam {
  float fx, fy, cx, cy, bf;
};

struct DeviceGuard {                          // the launch goes to `device`
  int prev = -1;
  explicit DeviceGuard(int device) {
    cudaGetDevice(&prev);
    if (prev != device) cudaSetDevice(device); else prev = -1;
  }
  ~DeviceGuard() { if (prev >= 0) cudaSetDevice(prev); }
};

// One observation row: the world point, the observed u, v and right u,
// inv_sigma2 and valid as 1 or 0.
struct Row {
  float p0, p1, p2, u, v, ur, is2, valid;
};

// Row i as the inputs hold it in device memory.
__device__ __forceinline__ Row input_row(const float* __restrict__ pw,
                                         const float* __restrict__ uv,
                                         const float* __restrict__ ur,
                                         const float* __restrict__ is2,
                                         const bool* __restrict__ valid, int i) {
  return {pw[3 * i], pw[3 * i + 1], pw[3 * i + 2], uv[2 * i], uv[2 * i + 1], ur[i], is2[i],
          valid[i] ? 1.0f : 0.0f};
}

// Row i: from shared memory ([ROW_F][cap]) if it is among the first `cap`,
// else from the inputs (kStaged: every row is staged). Both give a row the
// same values.
template <bool kStaged>
__device__ __forceinline__ Row row_at(const float* s, int cap, const float* __restrict__ pw,
                                      const float* __restrict__ uv,
                                      const float* __restrict__ ur,
                                      const float* __restrict__ is2,
                                      const bool* __restrict__ valid, int i) {
  if (kStaged || i < cap)
    return {s[i], s[cap + i], s[2 * cap + i], s[3 * cap + i], s[4 * cap + i], s[5 * cap + i],
            s[6 * cap + i], s[7 * cap + i]};
  return input_row(pw, uv, ur, is2, valid, i);
}

// A row at pose T (row-major 4 x 4, the top three rows read): camera
// coordinates, 1 / z_safe, its square and the residuals (the twin's
// `_residuals`).
struct Proj {
  float x, y, z, iz, iz2, r0, r1, r2;
  bool stereo;
};

__device__ __forceinline__ Proj project(const float* T, const Row q, const Cam& c) {
  Proj o;
  o.x = ((T[0] * q.p0 + T[1] * q.p1) + T[2] * q.p2) + T[3];
  o.y = ((T[4] * q.p0 + T[5] * q.p1) + T[6] * q.p2) + T[7];
  o.z = ((T[8] * q.p0 + T[9] * q.p1) + T[10] * q.p2) + T[11];
  o.iz = 1.0f / (o.z > Z_MIN ? o.z : Z_MIN);
  o.iz2 = o.iz * o.iz;
  const float u = (c.fx * o.x) * o.iz + c.cx;
  const float v = (c.fy * o.y) * o.iz + c.cy;
  o.stereo = q.ur >= 0.0f;
  o.r0 = u - q.u;
  o.r1 = v - q.v;
  o.r2 = o.stereo ? (u - c.bf * o.iz) - q.ur : 0.0f;
  return o;
}

__device__ __forceinline__ float chi2_of(const Proj& o, float is2) {
  return ((o.r0 * o.r0 + o.r1 * o.r1) + o.r2 * o.r2) * is2;
}

// One row's 27 terms added to acc (the twin's weight, `_jacobian` and sums).
__device__ __forceinline__ void add_row(float* acc, const float* T, const Row q,
                                        const Cam& c) {
  const Proj o = project(T, q, c);
  const float e2 = chi2_of(o, q.is2);
  const float chi = o.stereo ? CHI2_STEREO : CHI2_MONO;
  const float wh = e2 <= chi ? 1.0f : sqrtf(chi / (e2 < E2_MIN ? E2_MIN : e2));
  const float w = o.z <= Z_MIN ? 0.0f : (wh * q.is2) * q.valid;

  const float a = c.fx * o.iz, bb = c.fy * o.iz;
  const float cc = (-c.fx * o.x) * o.iz2;
  const float d = (-c.fy * o.y) * o.iz2;
  const float e = cc + c.bf * o.iz2;
  const float az = a * o.z, nay = -(a * o.y);
  const float zero = 0.0f;
  float J[3][6] = {
      {a, zero, cc, cc * o.y, az - cc * o.x, nay},
      {zero, bb, d, d * o.y - bb * o.z, -(d * o.x), bb * o.x},
      {a, zero, e, e * o.y, az - e * o.x, nay}};
#pragma unroll
  for (int k = 0; k < 6; ++k) J[2][k] = o.stereo ? J[2][k] : 0.0f;
  float Jw[3][6];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 6; ++k) Jw[r][k] = J[r][k] * w;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
      if (j >= i) {
        const int k = i * (11 - i) / 2 + j;
        acc[k] = acc[k] + ((Jw[0][i] * J[0][j] + Jw[1][i] * J[1][j]) + Jw[2][i] * J[2][j]);
      }
#pragma unroll
  for (int i = 0; i < 6; ++i)
    acc[21 + i] = acc[21 + i] + ((Jw[0][i] * o.r0 + Jw[1][i] * o.r1) + Jw[2][i] * o.r2);
}

// The damped 6 x 6 solve and the update T <- se3_exp(dx) T (the twin's
// `_solve` and `_se3_exp_times`), by one thread.
__device__ void gn_step(const float* s, float* T) {
  float H[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
      if (j >= i) H[j][i] = H[i][j] = s[i * (11 - i) / 2 + j];
#pragma unroll
  for (int i = 0; i < 6; ++i) H[i][i] = H[i][i] + DAMPING;

  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j)
#pragma unroll
    for (int i = 0; i < 6; ++i)
      if (i >= j) {
        float a = H[i][j];
#pragma unroll
        for (int k = 0; k < 6; ++k)
          if (k < j) a = a - L[i][k] * L[j][k];
        if (i == j) L[j][j] = sqrtf(a); else L[i][j] = a / L[j][j];
      }
  float y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float a = s[21 + i];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      if (k < i) a = a - L[i][k] * y[k];
    y[i] = a / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float a = y[i];
#pragma unroll
    for (int k = 5; k >= 0; --k)
      if (k > i) a = a - L[k][i] * x[k];
    x[i] = a / L[i][i];
  }
  float dx[6];
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    dx[i] = -x[i];
    ok = ok && isfinite(dx[i]);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) dx[i] = ok ? dx[i] : 0.0f;

  // se3_exp: v = dx[0:3], w = dx[3:6]
  const float w0 = dx[3], w1 = dx[4], w2 = dx[5];
  const float theta2 = (w0 * w0 + w1 * w1) + w2 * w2;
  const float theta = sqrtf(theta2 + EPS2);
  const bool big = theta2 > EPS_THETA2;
  const float sn = sinf(theta), cs = cosf(theta);
  const float A = big ? sn / theta : 1.0f - theta2 * RCP6;
  const float B = big ? (1.0f - cs) / theta2 : 0.5f - theta2 * RCP24;
  const float C = big ? (theta - sn) / (theta2 * theta) : RCP6 - theta2 * RCP120;
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float E[4][4];
  float V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float W2 = (W[i][0] * W[0][j] + W[i][1] * W[1][j]) + W[i][2] * W[2][j];
      const float I = i == j ? 1.0f : 0.0f;
      E[i][j] = (I + A * W[i][j]) + B * W2;
      V[i][j] = (I + B * W[i][j]) + C * W2;
    }
#pragma unroll
  for (int i = 0; i < 3; ++i) E[i][3] = (V[i][0] * dx[0] + V[i][1] * dx[1]) + V[i][2] * dx[2];
  E[3][0] = E[3][1] = E[3][2] = 0.0f;
  E[3][3] = 1.0f;
  float Tn[16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Tn[4 * i + j] = ((E[i][0] * T[j] + E[i][1] * T[4 + j]) + E[i][2] * T[8 + j]) +
                      E[i][3] * T[12 + j];
#pragma unroll
  for (int k = 0; k < 16; ++k) T[k] = Tn[k];
}

// The solve, by one CTA (pose_gn_kernel: n <= MAX_ROWS, every row staged;
// pose_gn_kernel_wide: more rows).
template <bool kStaged>
__device__ __forceinline__ void solve(const float* __restrict__ T_in,
                                      const float* __restrict__ pw,
                                      const float* __restrict__ uv,
                                      const float* __restrict__ ur,
                                      const float* __restrict__ is2,
                                      const bool* __restrict__ valid, int n, const Cam& cam,
                                      int n_iter, float* __restrict__ T_out,
                                      bool* __restrict__ inlier,
                                      long long* __restrict__ n_inlier) {
  extern __shared__ float smem[];
  float* red = smem;                          // [NS][BLOCK]
  float* staged = smem + NS * BLOCK;          // [ROW_F][cap]: p0 p1 p2 u v ur inv_sigma2 valid
  __shared__ float T[16];
  __shared__ float sums[NS];
  __shared__ int count;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int cap = kStaged ? n : MAX_ROWS;

  for (int i = t; i < cap; i += BLOCK) {
    const Row q = input_row(pw, uv, ur, is2, valid, i);
    const float v[ROW_F] = {q.p0, q.p1, q.p2, q.u, q.v, q.ur, q.is2, q.valid};
#pragma unroll
    for (int f = 0; f < ROW_F; ++f) staged[f * cap + i] = v[f];
  }
  if (t < 16) T[t] = T_in[t];
  if (t == 0) count = 0;
  __syncthreads();

  for (int it = 0; it < n_iter; ++it) {
    float Tr[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) Tr[k] = T[k];
    float acc[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) acc[k] = 0.0f;
    for (int i = t; i < n; i += BLOCK)
      add_row(acc, Tr, row_at<kStaged>(staged, cap, pw, uv, ur, is2, valid, i), cam);
#pragma unroll
    for (int k = 0; k < NS; ++k) red[k * BLOCK + t] = acc[k];
    __syncthreads();
    for (int k = warp; k < NS; k += WARPS) {
      const float* a = red + k * BLOCK + lane;
      float v[WARPS];                                  // a[lane + 32 m]
#pragma unroll
      for (int m = 0; m < WARPS; ++m) v[m] = a[32 * m];
#pragma unroll
      for (int lv = 1; lv < WARPS; lv <<= 1)          // h = WARPS / 2 lv: s = 32 h
#pragma unroll
        for (int m = 0; m < WARPS / 2; ++m)
          if (m < WARPS / 2 / lv) v[m] = v[m] + v[m + WARPS / 2 / lv];
      float e = v[0];
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) e = e + __shfl_down_sync(FULL, e, s);
      if (lane == 0) sums[k] = e;
    }
    __syncthreads();
    if (t == 0) gn_step(sums, T);
    __syncthreads();
  }

  int mine = 0;
  for (int i = t; i < n; i += BLOCK) {
    const Row q = row_at<kStaged>(staged, cap, pw, uv, ur, is2, valid, i);
    const Proj o = project(T, q, cam);
    const bool good = q.valid != 0.0f &&
                      chi2_of(o, q.is2) <= (o.stereo ? CHI2_STEREO : CHI2_MONO) &&
                      !(o.z <= Z_MIN);
    inlier[i] = good;
    mine += good;
  }
  mine = __reduce_add_sync(FULL, mine);
  if (lane == 0 && mine != 0) atomicAdd(&count, mine);
  __syncthreads();
  if (t < 16) T_out[t] = T[t];
  if (t == 0) *n_inlier = count;
}

#define POSE_GN_PARAMS                                                                      \
  const float *__restrict__ T_in, const float *__restrict__ pw, const float *__restrict__ uv, \
      const float *__restrict__ ur, const float *__restrict__ inv_sigma2,                   \
      const bool *__restrict__ valid, int n, Cam cam, int n_iter, float *__restrict__ T_out, \
      bool *__restrict__ inlier, long long *__restrict__ n_inlier

__global__ void __launch_bounds__(BLOCK, 1) pose_gn_kernel(POSE_GN_PARAMS) {
  solve<true>(T_in, pw, uv, ur, inv_sigma2, valid, n, cam, n_iter, T_out, inlier, n_inlier);
}

__global__ void __launch_bounds__(BLOCK, 1) pose_gn_kernel_wide(POSE_GN_PARAMS) {
  solve<false>(T_in, pw, uv, ur, inv_sigma2, valid, n, cam, n_iter, T_out, inlier, n_inlier);
}

#undef POSE_GN_PARAMS

__global__ void math_kernel(const float* __restrict__ x, int n, float* __restrict__ s,
                            float* __restrict__ c, float* __restrict__ q) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  s[i] = sinf(x[i]);
  c[i] = cosf(x[i]);
  q[i] = sqrtf(x[i]);
}

}  // namespace

// T [4, 4] f32; pw [n, 3], uv [n, 2], ur [n], inv_sigma2 [n] f32, valid [n]
// bool; K and bf by value; n_iter = rounds * iters. T_out [4, 4] f32,
// inlier [n] bool and n_inlier int64 out.
extern "C" int pose_gn_launch(const void* T, const void* pw, const void* uv, const void* ur,
                              const void* inv_sigma2, const void* valid, int n, float fx,
                              float fy, float cx, float cy, float bf, int n_iter, void* T_out,
                              void* inlier, void* n_inlier, int device, void* stream) {
  if (n < 0 || n_iter < 0) return static_cast<int>(cudaErrorInvalidValue);
  static bool attribute_set[64];
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  DeviceGuard guard(device);
  if (!attribute_set[device]) {
    decltype(&pose_gn_kernel) const kernels[] = {pose_gn_kernel, pose_gn_kernel_wide};
    for (const auto kernel : kernels) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    attribute_set[device] = true;
  }
  const Cam cam{fx, fy, cx, cy, bf};
  const bool staged = n <= MAX_ROWS;
  const size_t smem = static_cast<size_t>(NS * BLOCK + ROW_F * (staged ? n : MAX_ROWS)) * 4;
  const auto kernel = staged ? pose_gn_kernel : pose_gn_kernel_wide;
  kernel<<<1, BLOCK, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(T), static_cast<const float*>(pw),
      static_cast<const float*>(uv), static_cast<const float*>(ur),
      static_cast<const float*>(inv_sigma2), static_cast<const bool*>(valid), n, cam, n_iter,
      static_cast<float*>(T_out), static_cast<bool*>(inlier),
      static_cast<long long*>(n_inlier));
  return static_cast<int>(cudaGetLastError());
}

// x [n] f32 in; s, c, q [n] f32 out: the kernel's sinf, cosf and sqrtf of x
// (for the tests, against torch.sin, torch.cos and torch.sqrt on the card).
extern "C" int pose_gn_math_launch(const void* x, int n, void* s, void* c, void* q, int device,
                                   void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(device);
  math_kernel<<<(n + 255) / 256, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<float*>(s), static_cast<float*>(c),
      static_cast<float*>(q));
  return static_cast<int>(cudaGetLastError());
}
