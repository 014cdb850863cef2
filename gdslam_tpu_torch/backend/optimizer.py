"""Gauss-Newton pose optimization with Huber weights and chi2 outlier gating
(port of gdslam_tpu.backend.optimizer).

Behavioral twin of Optimizer::PoseOptimization (reference Optimizer.cc:
239-451): 4 rounds x 5 GN iterations over one SE3 pose with Huber weights,
a chi2 inlier classification (5.991 mono / 7.815 stereo) and per-level
information scaling. Residuals and Jacobians are closed-form over a
fixed-size padded match set; the 6x6 normal equations are solved by
Cholesky, with no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gdslam_tpu_torch.core import lie

CHI2_MONO = 5.991     # Optimizer.cc:292 (2-dof 95%)
CHI2_STEREO = 7.815   # Optimizer.cc:320 (3-dof 95%)


class PoseObs(NamedTuple):
    """Fixed-size padded observation set for single-pose optimization."""

    pw: torch.Tensor          # [N, 3] world points
    uv: torch.Tensor          # [N, 2] observed (undistorted) pixel coords
    ur: torch.Tensor          # [N] observed right-view u; <0 => mono obs
    inv_sigma2: torch.Tensor  # [N] information scale (1 / 1.2^(2 level))
    valid: torch.Tensor       # [N] bool


def _residual_jacobian(T: torch.Tensor, obs: PoseObs, K: tuple, bf: float):
    """Stacked [N, 3] residuals (u, v, ur) and [N, 3, 6] Jacobians."""
    fx, fy, cx, cy = K
    Xc = lie.se3_apply(T, obs.pw)
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    z_safe = torch.where(z > 1e-6, z, 1e-6)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    ur = u - bf * iz
    is_stereo = obs.ur >= 0
    r = torch.stack([u - obs.uv[:, 0], v - obs.uv[:, 1],
                     torch.where(is_stereo, ur - obs.ur, 0.0)], dim=1)

    zero = torch.zeros_like(x)
    du = torch.stack([fx * iz, zero, -fx * x * iz2], dim=1)
    dv = torch.stack([zero, fy * iz, -fy * y * iz2], dim=1)
    dur = torch.stack([fx * iz, zero, -fx * x * iz2 + bf * iz2], dim=1)
    dproj = torch.stack([du, dv, torch.where(is_stereo[:, None], dur, 0.0)], dim=1)
    # left perturbation T <- exp(dxi) T: dXc/dxi = [I | -hat(Xc)]
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[0], 3, 3)
    dXc = torch.cat([eye, -lie.hat(Xc)], dim=2)                      # [N, 3, 6]
    J = dproj @ dXc                                                  # [N, 3, 6]
    return r, J, z <= 1e-6


def _robust_weights(r: torch.Tensor, obs: PoseObs, inlier: torch.Tensor):
    """Huber weights per observation (delta^2 = chi2 gate)."""
    chi2_th = torch.where(obs.ur >= 0, CHI2_STEREO, CHI2_MONO)
    e2 = torch.sum(r * r, dim=1) * obs.inv_sigma2
    w_huber = torch.where(e2 <= chi2_th, 1.0,
                          torch.sqrt(chi2_th / torch.clamp(e2, min=1e-12)))
    w = w_huber * obs.inv_sigma2 * (inlier & obs.valid)
    return w, e2


def pose_optimization(T_init: torch.Tensor, obs: PoseObs, K: tuple, bf: float,
                      rounds: int = 4, iters: int = 5):
    """Optimize camera pose T_cw. Returns (T, inlier_mask, n_inliers).

    The weights of every GN iteration are gated by `obs.valid` alone, and the
    chi2 inlier set is classified once, after the last iteration. That is
    what the JAX package computes: its per-round reclassification never
    reaches the weights, because the `fori_loop` body is traced once and
    keeps the first round's inlier set (obs.valid) in all rounds. The port
    reproduces the reference's numbers (see ROADMAP.md section 3).
    """
    chi2_th = torch.where(obs.ur >= 0, CHI2_STEREO, CHI2_MONO)
    eye6 = 1e-5 * torch.eye(6, dtype=T_init.dtype, device=T_init.device)
    T = T_init
    for _ in range(rounds * iters):
        r, J, behind = _residual_jacobian(T, obs, K, bf)
        w, _ = _robust_weights(r, obs, obs.valid)
        w = torch.where(behind, 0.0, w)
        Jw = J * w[:, None, None]
        H = torch.einsum("nri,nrj->ij", Jw, J) + eye6
        b = torch.einsum("nri,nr->i", Jw, r)
        L, info = torch.linalg.cholesky_ex(H)
        dx = -torch.cholesky_solve(b[:, None], L)[:, 0]
        ok = (info == 0) & torch.all(torch.isfinite(dx))
        T = lie.se3_exp(torch.where(ok, dx, torch.zeros_like(dx))) @ T
    r, _, behind = _residual_jacobian(T, obs, K, bf)
    e2 = torch.sum(r * r, dim=1) * obs.inv_sigma2
    inlier = obs.valid & (e2 <= chi2_th) & ~behind
    return T, inlier, inlier.sum()
