"""Inputs of the pose Gauss-Newton kernel (ops/pose_kernel.py): the seeded
observation sets the CPU tests hold the twin to the JAX package on, and the
card tests and chip_smoke.py hold the kernel to the twin on. Each is made
from a numpy seed (the start and true poses through the port's se3_exp on
the CPU), so every caller makes the same input. Invalid rows are padded as
the tracker pads them (pw = 0).

    mixed          300 rows of the 120x160 rig (fx 160, bf 12.8), 4 levels:
                   70% stereo, 20% gross outliers, 5% invalid, a perturbed
                   start (tests/test_torch_pose.py's case)
    tracker_1500   the SlamConfig() camera (fx 535.4, fy 539.2, cx 320.1, cy
                   247.6, bf 40), 8 levels, 1500 rows of which 40% invalid
                   padding; RGB-D rows stereo where they have depth
    stereo_2000    ORB-SLAM2's KITTI00-02.yaml (1241 x 376, bf 386.1448), 2000
                   rows, stereo up to 40 baselines, far rows mono
    mono_boot      the mono bootstrap's refinement: bf 0, every ur = -1,
                   inv_sigma2 = 1, rounds 1, iters 8
    none_valid     no row valid: T comes back as it went in, no inlier
    behind         rows behind the camera (z < 0): weight 0, never inliers
    nan_row        one valid row whose world point is NaN: H and dx are not
                   finite in every iteration, every step is skipped, T comes
                   back as it went in and that row is no inlier
    rank_deficient every valid row on one point: the Cholesky meets pivots at
                   rounding level (held kernel against twin on the card only:
                   the outcome rests on rounding)
    ragged_1       N = 1 (its row invalid: one valid row leaves H of rank 3,
                   the rank_deficient case)
    ragged_513     N = 513, 1501: not multiples of the kernel's block
    ragged_1501
    ragged_6001    N = 6001: past the 5120 rows the kernel stages in shared
                   memory (the rest it reads from device memory)
"""

from __future__ import annotations

import numpy as np
import torch

from gdslam_tpu_torch.backend.optimizer import PoseObs
from gdslam_tpu_torch.config import CameraConfig
from gdslam_tpu_torch.core import lie

CASES = ("mixed", "tracker_1500", "stereo_2000", "mono_boot", "none_valid", "behind", "nan_row",
         "rank_deficient", "ragged_1", "ragged_513", "ragged_1501", "ragged_6001")
CARD_ONLY = ("rank_deficient",)
KITTI = dict(K=(718.856, 718.856, 607.1928, 185.2157), size=(1241, 376), bf=386.1448)


def _se3(xi) -> np.ndarray:
    return lie.se3_exp(torch.tensor(np.asarray(xi, np.float32))).numpy()


def _rows(r, n: int, K, bf: float, size, T_true, depth, levels: int, outliers: float,
          invalid: float, stereo_upto: float) -> dict:
    """n observations of points seen by T_true inside the image: pixel noise
    of 0.5 px x 1.2^level, a share of gross outliers (+-40 px), stereo rows
    (ur = u - bf / z + noise) where z <= stereo_upto, a share invalid."""
    fx, fy, cx, cy = K
    u = r.uniform(0, size[0], n)
    v = r.uniform(0, size[1], n)
    z = r.uniform(*depth, n)
    pc = np.stack([(u - cx) * z / fx, (v - cy) * z / fy, z], 1)
    R, t = T_true[:3, :3].astype(np.float64), T_true[:3, 3].astype(np.float64)
    pw = (pc - t) @ R                                  # R^T (pc - t)
    level = r.integers(0, levels, n)
    sigma = 0.5 * 1.2 ** level
    uv = np.stack([u, v], 1) + r.normal(0, 1, (n, 2)) * sigma[:, None]
    bad = r.uniform(size=n) < outliers
    uv[bad] += r.uniform(-40, 40, (int(bad.sum()), 2))
    ur = np.where(z <= stereo_upto, uv[:, 0] - bf / z + r.normal(0, 1, n) * sigma, -1.0)
    valid = r.uniform(size=n) >= invalid
    pw = np.where(valid[:, None], pw, 0.0)
    return dict(pw=pw.astype(np.float32), uv=uv.astype(np.float32), ur=ur.astype(np.float32),
                inv_sigma2=(1.0 / 1.2 ** (2 * level)).astype(np.float32), valid=valid)


def pose_input(name: str) -> dict:
    """Case `name` as numpy arrays: T [4, 4] f32, pw [N, 3], uv [N, 2], ur [N],
    inv_sigma2 [N] f32, valid [N] bool, and K, bf, rounds, iters."""
    seed = CASES.index(name)
    r = np.random.default_rng(100 + seed)
    cam = CameraConfig()
    K, bf, size = (cam.fx, cam.fy, cam.cx, cam.cy), cam.bf, (cam.width, cam.height)
    rounds, iters = 4, 5
    T_true = _se3([0.05, -0.02, 0.03, 0.02, -0.01, 0.015])
    xi0 = np.concatenate([r.normal(0, 0.02, 3), r.normal(0, 0.01, 3)])
    tracker = dict(depth=(0.5, 6.0), levels=8, outliers=0.1, invalid=0.4, stereo_upto=6.0)
    if name == "mixed":
        K, bf, size = (160.0, 160.0, 80.0, 60.0), 12.8, (160, 120)
        d = _rows(r, 300, K, bf, size, T_true, (1.5, 4.0), 4, 0.2, 0.05, stereo_upto=4.0)
        d["ur"] = np.where(r.uniform(size=300) < 0.7, d["ur"], np.float32(-1.0))
    elif name == "tracker_1500":
        d = _rows(r, 1500, K, bf, size, T_true, **tracker)
    elif name == "stereo_2000":
        K, bf, size = KITTI["K"], KITTI["bf"], KITTI["size"]
        d = _rows(r, 2000, K, bf, size, T_true, (3.0, 60.0), 8, 0.1, 0.15,
                  stereo_upto=40 * bf / K[0])
    elif name == "mono_boot":
        bf, rounds, iters = 0.0, 1, 8
        T_true = _se3([0.1, 0.0, 0.02, 0.0, 0.03, 0.0])
        d = _rows(r, 400, K, bf, size, T_true, (1.0, 4.0), 1, 0.05, 0.2, stereo_upto=-1.0)
        xi0 = np.concatenate([r.normal(0, 0.02, 3), r.normal(0, 0.02, 3)])
    elif name == "none_valid":
        d = _rows(r, 200, K, bf, size, T_true, **dict(tracker, invalid=1.0))
    elif name == "behind":
        d = _rows(r, 500, K, bf, size, T_true, **dict(tracker, invalid=0.2))
        back = r.uniform(size=500) < 0.15
        pc = np.stack([r.uniform(-2, 2, 500), r.uniform(-2, 2, 500), r.uniform(-2, -0.05, 500)], 1)
        R, t = T_true[:3, :3].astype(np.float64), T_true[:3, 3].astype(np.float64)
        d["pw"][back] = ((pc - t) @ R)[back].astype(np.float32)
        d["valid"][back] = True
    elif name == "nan_row":
        d = _rows(r, 500, K, bf, size, T_true, **dict(tracker, invalid=0.2))
        i = int(np.flatnonzero(d["valid"])[7])
        d["pw"][i] = np.nan
    elif name == "rank_deficient":
        d = _rows(r, 300, K, bf, size, T_true, **dict(tracker, invalid=0.3))
        for k in ("pw", "uv", "ur", "inv_sigma2"):
            d[k][:] = d[k][int(np.flatnonzero(d["valid"])[0])]
        d["pw"] = np.where(d["valid"][:, None], d["pw"], np.float32(0.0))
    elif name.startswith("ragged_"):
        n = int(name.split("_")[1])
        d = _rows(r, n, K, bf, size, T_true, **tracker)
        if n == 1:
            d["valid"][:] = False
            d["pw"][:] = 0.0
    else:
        raise KeyError(name)
    T = (_se3(xi0) @ T_true).astype(np.float32)
    return dict(T=T, **d, K=tuple(float(k) for k in K), bf=float(bf), rounds=rounds, iters=iters)


def pose_args(name: str, device="cpu") -> tuple:
    """Case `name` as pose_optimization's arguments on `device`: (T_init,
    PoseObs, K, bf, rounds, iters)."""
    d = pose_input(name)
    t = {k: torch.from_numpy(np.ascontiguousarray(d[k])).to(device)
         for k in ("T", "pw", "uv", "ur", "inv_sigma2", "valid")}
    return (t["T"], PoseObs(t["pw"], t["uv"], t["ur"], t["inv_sigma2"], t["valid"]), d["K"],
            d["bf"], d["rounds"], d["iters"])
