"""Gauss-Newton pose optimization with Huber weights and chi2 outlier gating
(port of gdslam_tpu.backend.optimizer).

Behavioral twin of Optimizer::PoseOptimization (reference Optimizer.cc:
239-451): 4 rounds x 5 GN iterations over one SE3 pose with Huber weights,
a chi2 inlier classification (5.991 mono / 7.815 stereo) and per-level
information scaling. Residuals and Jacobians are closed-form over a
fixed-size padded match set; the 6x6 normal equations are solved by
Cholesky, with no host sync. The solve is one hand-written CUDA kernel on
the card and its plain twin on the CPU (ops/pose_kernel.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gdslam_tpu_torch.ops import pose_kernel
from gdslam_tpu_torch.ops.pose_kernel import CHI2_MONO, CHI2_STEREO  # noqa: F401 (ba, gba)


class PoseObs(NamedTuple):
    """Fixed-size padded observation set for single-pose optimization."""

    pw: torch.Tensor          # [N, 3] world points
    uv: torch.Tensor          # [N, 2] observed (undistorted) pixel coords
    ur: torch.Tensor          # [N] observed right-view u; <0 => mono obs
    inv_sigma2: torch.Tensor  # [N] information scale (1 / 1.2^(2 level))
    valid: torch.Tensor       # [N] bool


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
    return pose_kernel.pose_gn(T_init, obs, K, bf, rounds, iters)
