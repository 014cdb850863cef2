"""Trajectory evaluation: ATE and RPE RMSE (TUM benchmark semantics), numpy.

The port's own copy of gdslam_tpu.utils.metrics' ate_rmse (rigid
Horn/Umeyama alignment of estimated to ground-truth positions, then RMSE of
the residual translations) and rpe_rmse.
"""

from __future__ import annotations

import numpy as np


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares rigid alignment est -> gt. est, gt: [N, 3]."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    E = est - mu_e
    G = gt - mu_g
    H = E.T @ G / est.shape[0]
    U, S, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    s = float((np.trace(np.diag(S) @ D) / (E ** 2).mean())) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             align: bool = True) -> float:
    """Absolute trajectory error RMSE after rigid alignment (meters)."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    if est.shape != gt.shape:
        raise ValueError(f"ate_rmse: shapes differ {est.shape} vs {gt.shape}")
    if align:
        R, t, s = align_umeyama(est, gt)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def rpe_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1) -> float:
    """Relative pose error RMSE (translation, meters) at frame spacing delta."""
    est = np.asarray(est_poses, np.float64)   # [N, 4, 4] T_wc
    gt = np.asarray(gt_poses, np.float64)
    errs = []
    for i in range(len(est) - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        errs.append(np.linalg.norm((np.linalg.inv(dg) @ de)[:3, 3]))
    return float(np.sqrt(np.mean(np.square(errs))))
