"""The pose Gauss-Newton solve as one hand-written CUDA kernel
(`csrc/pose_gn.cu`) and its plain PyTorch twin.

`pose_gn` computes what backend/optimizer.pose_optimization computes:
rounds * iters Gauss-Newton steps of one SE3 camera pose T_cw over N padded
observation rows, with Huber weights against the chi2 gates 5.991 (mono) /
7.815 (stereo, `ur >= 0`) times `inv_sigma2`, gated by `valid` alone in
every iteration (the JAX package's quirk, see optimizer.py), a damped 6 x 6
Cholesky solve, the step taken only if it is finite, then the chi2 inlier
mask after the last step. On the card one CTA of BLOCK threads runs the
whole solve in one launch; `pose_gn_plain` is its twin.

The twin writes out the kernel's order, so that the two are equal bit for
bit on the card:

- Per row: the JAX source's expressions, each product and sum rounded once
  (`_residuals`, `_jacobian`); the Jacobian's structural zeros are zeros.
- The 27 sums (H's upper triangle row by row, each entry the three residual
  rows' Jw_i * J_j added in order, then b's 6): thread t of the kernel adds
  rows t, t + BLOCK, t + 2 BLOCK, ... in order from +0, then the block adds
  the threads by a fixed tree, a[t] += a[t + s] for s = BLOCK / 2, ..., 1
  (`_block_sum`). H's lower triangle is its upper one.
- The 6 x 6 solve: 1e-5 on H's diagonal, Cholesky (each entry's products
  subtracted in ascending k), L y = b (ascending k), L^T x = y (descending
  k), dx = -x (`_solve`).
- se3_exp(dx) @ T written out entry by entry (`_se3_exp_times`); a division
  by a Python scalar is the product by the float32 reciprocal, as torch
  computes it on a CUDA tensor (`RCP6`, `RCP24`, `RCP120`).

Against the JAX package (XLA's dots are chains of fused multiply-adds) T
moves by ~1e-7, and no test case holds a row at a chi2 gate. The wrapper
takes the twin only for tensors on the CPU; for a CUDA tensor it launches
the kernel, counting the launch in `pose_gn.launches`, or raises. It reads
nothing back from the card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from gdslam_tpu_torch.core import lie
from gdslam_tpu_torch.ops import cuda_build

LIB = "pose_gn"
BLOCK = 512           # the kernel's threads, one CTA a solve; the twin's tree spans it
STAGED_ROWS = 5120    # rows the kernel keeps in shared memory; the rest it reads from HBM
CHI2_MONO = 5.991     # Optimizer.cc:292 (2-dof 95%)
CHI2_STEREO = 7.815   # Optimizer.cc:320 (3-dof 95%)
Z_MIN = 1e-6          # z at or below it: behind the camera (weight 0, no inlier)
E2_MIN = 1e-12
DAMPING = 1e-5        # on H's diagonal
EPS_THETA2 = 1e-8     # lie._EPS: theta^2 above it takes the closed forms
EPS2 = 1e-8 * 1e-8
RCP6 = float(np.float32(1.0) / np.float32(6.0))      # also 1 / 6.0 as a float32 constant
RCP24 = float(np.float32(1.0) / np.float32(24.0))
RCP120 = float(np.float32(1.0) / np.float32(120.0))
_IU, _JU = np.triu_indices(6)


def _declare(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pose_gn_launch.argtypes = [p, p, p, p, p, p, i, f, f, f, f, f, i, p, p, p, i, p]
    lib.pose_gn_math_launch.argtypes = [p, i, p, p, p, i, p]
    for fn in (lib.pose_gn_launch, lib.pose_gn_math_launch):
        fn.restype = i


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> tuple:
    """The twin's index tables and constants on `device`."""
    h_at = np.zeros((6, 6), np.int64)
    h_at[_IU, _JU] = np.arange(len(_IU))
    h_at[_JU, _IU] = np.arange(len(_IU))
    return (torch.from_numpy(_IU).to(device), torch.from_numpy(_JU).to(device),
            torch.from_numpy(h_at).to(device),
            DAMPING * torch.eye(6, dtype=torch.float32, device=device),
            torch.eye(3, dtype=torch.float32, device=device))


# ----------------------------------------------------------------------------
# the plain twin
# ----------------------------------------------------------------------------

def _residuals(T: torch.Tensor, p: torch.Tensor, uo, vo, ur_o, stereo, K, bf: float):
    """Camera coordinates x, y, z [N], 1 / z_safe and its square, and the
    residuals r [3, N] (u, v, ur) of the rows p [3, N] at pose T."""
    fx, fy, cx, cy = K
    Xc = T[:3, 0:1] * p[0] + T[:3, 1:2] * p[1] + T[:3, 2:3] * p[2] + T[:3, 3:4]
    x, y, z = Xc[0], Xc[1], Xc[2]
    iz = torch.reciprocal(torch.where(z > Z_MIN, z, Z_MIN))
    iz2 = iz * iz
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    r = torch.stack([u - uo, v - vo, torch.where(stereo, u - bf * iz - ur_o, 0.0)])
    return x, y, z, iz, iz2, r


def _chi2(r: torch.Tensor, inv_sigma2: torch.Tensor) -> torch.Tensor:
    rr = r * r
    return (rr[0] + rr[1] + rr[2]) * inv_sigma2


def _jacobian(x, y, z, iz, iz2, stereo, K, bf: float) -> torch.Tensor:
    """[3, 6, N]: d(u, v, ur) / d(upsilon, omega) under T <- exp(dxi) T, the
    JAX source's dproj @ [I | -hat(Xc)] with its zero products left out."""
    fx, fy = K[0], K[1]
    a, bb = fx * iz, fy * iz
    c = -fx * x * iz2
    d = -fy * y * iz2
    e = c + bf * iz2
    az, nay = a * z, -(a * y)
    zero = torch.zeros_like(x)
    J0 = torch.stack([a, zero, c, c * y, az - c * x, nay])
    J1 = torch.stack([zero, bb, d, d * y - bb * z, -(d * x), bb * x])
    J2 = torch.stack([a, zero, e, e * y, az - e * x, nay])
    return torch.stack([J0, J1, torch.where(stereo, J2, 0.0)])


def _block_sum(q: torch.Tensor) -> torch.Tensor:
    """[S, N] -> [S]: the kernel's order. Row i goes to thread i % BLOCK,
    which adds its rows in order from +0; then a[t] += a[t + s] for s =
    BLOCK / 2, ..., 1."""
    S, n = q.shape
    rounds = max(1, -(-n // BLOCK))
    qp = torch.nn.functional.pad(q, (0, rounds * BLOCK - n)).view(S, rounds, BLOCK)
    acc = torch.zeros(S, BLOCK, dtype=q.dtype, device=q.device)
    for k in range(rounds):
        acc = acc + qp[:, k]
    s = BLOCK // 2
    while s:
        acc = acc[:, :s] + acc[:, s:2 * s]
        s //= 2
    return acc[:, 0]


def _solve(sums: torch.Tensor, h_at: torch.Tensor, damping: torch.Tensor) -> torch.Tensor:
    """dx = -(H + 1e-5 I)^-1 b from the 27 sums: Cholesky L L^T (each entry
    minus L_ik L_jk for k ascending, then the square root or the division by
    L_jj), L y = b (ascending k), L^T x = y (descending k)."""
    A = sums[h_at] + damping
    diag, cols = [], []
    for _ in range(6):
        dk = torch.sqrt(A[0, 0:1])
        lk = A[1:, 0] / dk
        diag.append(dk)
        cols.append(lk)
        A = A[1:, 1:] - lk[:, None] * lk[None, :]
    z, ys = sums[21:], []
    for k in range(6):
        yk = z[0:1] / diag[k]
        ys.append(yk)
        z = z[1:] - cols[k] * yk
    L = torch.stack([torch.cat([sums.new_zeros(k), diag[k], cols[k]]) for k in range(6)], dim=1)
    w, xs = torch.cat(ys), [None] * 6
    for k in range(5, -1, -1):
        xs[k] = w[k:k + 1] / diag[k]
        w = w[:k] - L[k, :k] * xs[k]
    return -torch.cat(xs)


def _se3_exp_times(dx: torch.Tensor, T: torch.Tensor, eye3: torch.Tensor) -> torch.Tensor:
    """se3_exp(dx) @ T, entry by entry in the JAX source's order."""
    v, w = dx[:3], dx[3:]
    ww = w * w
    theta2 = ww[0] + ww[1] + ww[2]
    theta = torch.sqrt(theta2 + EPS2)
    big = theta2 > EPS_THETA2
    sn, cs = torch.sin(theta), torch.cos(theta)
    A = torch.where(big, sn / theta, 1.0 - theta2 * RCP6)
    B = torch.where(big, (1.0 - cs) / theta2, 0.5 - theta2 * RCP24)
    C = torch.where(big, (theta - sn) / (theta2 * theta), RCP6 - theta2 * RCP120)
    W = lie.hat(w)
    W2 = W[:, 0:1] * W[0:1] + W[:, 1:2] * W[1:2] + W[:, 2:3] * W[2:3]
    R = eye3 + A * W + B * W2
    V = eye3 + B * W + C * W2
    E = lie.rt_to_mat(R, V[:, 0] * v[0] + V[:, 1] * v[1] + V[:, 2] * v[2])
    return E[:, 0:1] * T[0:1] + E[:, 1:2] * T[1:2] + E[:, 2:3] * T[2:3] + E[:, 3:4] * T[3:4]


def pose_gn_plain(T_init: torch.Tensor, obs, K: tuple, bf: float, rounds: int = 4,
                  iters: int = 5):
    """The kernel's twin: (T [4, 4] f32, inlier [N] bool, n_inliers int64)."""
    iu, ju, h_at, damping, eye3 = _consts(T_init.device)
    K = tuple(float(k) for k in K)
    bf = float(bf)
    p = obs.pw.T
    uo, vo = obs.uv[:, 0], obs.uv[:, 1]
    stereo = obs.ur >= 0
    chi2_th = torch.where(stereo, CHI2_STEREO, CHI2_MONO)
    valid_f = obs.valid.to(torch.float32)
    T = T_init
    for _ in range(rounds * iters):
        x, y, z, iz, iz2, r = _residuals(T, p, uo, vo, obs.ur, stereo, K, bf)
        e2 = _chi2(r, obs.inv_sigma2)
        w_huber = torch.where(e2 <= chi2_th, 1.0,
                              torch.sqrt(chi2_th / torch.clamp(e2, min=E2_MIN)))
        w = torch.where(z <= Z_MIN, 0.0, w_huber * obs.inv_sigma2 * valid_f)
        J = _jacobian(x, y, z, iz, iz2, stereo, K, bf)
        Jw = J * w
        Hq = Jw[:, iu] * J[:, ju]
        bq = Jw * r[:, None]
        sums = _block_sum(torch.cat([Hq[0] + Hq[1] + Hq[2], bq[0] + bq[1] + bq[2]]))
        dx = _solve(sums, h_at, damping)
        T = _se3_exp_times(torch.where(torch.isfinite(dx).all(), dx, 0.0), T, eye3)
    _, _, z, _, _, r = _residuals(T, p, uo, vo, obs.ur, stereo, K, bf)
    inlier = obs.valid & (_chi2(r, obs.inv_sigma2) <= chi2_th) & ~(z <= Z_MIN)
    return T, inlier, inlier.sum()


# ----------------------------------------------------------------------------
# the wrapper
# ----------------------------------------------------------------------------

def pose_gn(T_init: torch.Tensor, obs, K: tuple, bf: float, rounds: int = 4, iters: int = 5):
    """pose_optimization's solve: (T [4, 4] f32, inlier [N] bool, n_inliers
    int64 0-d). obs holds pw [N, 3], uv [N, 2], ur [N], inv_sigma2 [N] f32
    and valid [N] bool. One launch on the card, nothing read back."""
    name = "pose_gn"
    dev = T_init.device
    if dev.type == "cpu":
        return pose_gn_plain(T_init, obs, K, bf, rounds, iters)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    n = obs.pw.shape[0]
    f32 = torch.float32
    cuda_build.check(name, "T_init", T_init, f32, (4, 4), dev)
    for what, t, dtype, shape in (("pw", obs.pw, f32, (n, 3)), ("uv", obs.uv, f32, (n, 2)),
                                  ("ur", obs.ur, f32, (n,)),
                                  ("inv_sigma2", obs.inv_sigma2, f32, (n,)),
                                  ("valid", obs.valid, torch.bool, (n,))):
        cuda_build.check(name, what, t, dtype, shape, dev)
    if rounds < 0 or iters < 0:
        raise ValueError(f"{name}: rounds and iters must be >= 0")
    lib = cuda_build.load(LIB, _declare)
    T = torch.empty(4, 4, dtype=f32, device=dev)
    inlier = torch.empty(n, dtype=torch.bool, device=dev)
    n_inliers = torch.empty((), dtype=torch.int64, device=dev)
    fx, fy, cx, cy = (float(k) for k in K)
    cuda_build.launch(name, dev, lib.pose_gn_launch, T_init.data_ptr(), obs.pw.data_ptr(),
                      obs.uv.data_ptr(), obs.ur.data_ptr(), obs.inv_sigma2.data_ptr(),
                      obs.valid.data_ptr(), n, fx, fy, cx, cy, float(bf), rounds * iters,
                      T.data_ptr(), inlier.data_ptr(), n_inliers.data_ptr())
    pose_gn.launches += 1
    return T, inlier, n_inliers


def math_on_card(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's own sinf, cosf and sqrtf of x ([n] f32 CUDA tensor), for
    the tests: their twins are torch.sin, torch.cos and torch.sqrt. Not
    counted."""
    name, dev, n = "pose_gn_math", x.device, x.shape[0]
    cuda_build.check(name, "x", x, torch.float32, (n,), dev)
    lib = cuda_build.load(LIB, _declare)
    out = torch.empty(3, n, dtype=torch.float32, device=dev)
    cuda_build.launch(name, dev, lib.pose_gn_math_launch, x.data_ptr(), n, out[0].data_ptr(),
                      out[1].data_ptr(), out[2].data_ptr())
    return out[0], out[1], out[2]


pose_gn.launches = 0
