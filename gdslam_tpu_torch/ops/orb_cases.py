"""Inputs of the ORB front end's kernels (ops/orb_kernel.py): the frames the
card tests and chip_smoke.py hold each kernel to its plain twin on, and the
CPU tests' degenerate frames. Each is made from the port's renderer or a
numpy seed, so every caller makes the same input.

    rendered      the defaults' static scene at 480x640 (frame 0)
    gd_dynamic    the dynamic scene at 480x640 (frame 60) in the GD path's
                  uint8 values
    stereo        the stereo cell's left image (ORB-SLAM2's KITTI00-02.yaml:
                  1241 x 376, 2000 features), uint8 values
    rig           the 120x160 rig, 384 features on 4 levels: levels 1-3 have
                  fewer candidates than their quota (padded rows)
    flat          every pixel 128: no corner, every row invalid
    saturated     every pixel 255: the same
    noise         seeded integer noise: many equal strengths
    checker       8-px squares: every corner the same strength, ties inside
                  and across cells
"""

from __future__ import annotations

import numpy as np
import torch

from gdslam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig

CASES = ("rendered", "gd_dynamic", "stereo", "rig", "flat", "saturated", "noise", "checker")
KITTI_CAMERA = CameraConfig(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, width=1241,
                            height=376, bf=386.1448, fps=10.0,
                            th_depth=35.0)
KITTI_ORB = OrbConfig(n_features=2000, scale_factor=1.2, n_levels=8, ini_th_fast=20,
                      min_th_fast=7)
RIG_CAMERA = CameraConfig(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160, height=120, bf=12.8)
RIG_ORB = OrbConfig(n_features=384, n_levels=4)


def pattern(name: str, height: int, width: int) -> np.ndarray:
    """[height, width] f32 frames of the degenerate cases (numpy only)."""
    if name == "flat":
        return np.full((height, width), 128.0, np.float32)
    if name == "saturated":
        return np.full((height, width), 255.0, np.float32)
    if name == "noise":
        return np.random.default_rng(5).integers(0, 256, (height, width)).astype(np.float32)
    if name == "checker":
        ys, xs = np.mgrid[0:height, 0:width]
        return (((ys // 8 + xs // 8) % 2) * 180 + 40).astype(np.float32)
    raise ValueError(f"no pattern {name}")


def orb_input(name: str, device, cfg: SlamConfig | None = None):
    """(gray [H, W] f32 on device, OrbConfig, CameraConfig) of case `name`;
    cfg: the defaults' configuration (SlamConfig() if None)."""
    from gdslam_tpu_torch.io import synthetic
    cfg = cfg or SlamConfig()
    cam, u8 = cfg.camera, (lambda g: torch.round(g).clamp(0, 255))
    if name == "rendered":
        return synthetic.render_frame(0, cam, with_dynamic=False, device=device).gray, cfg.orb, cam
    if name == "gd_dynamic":
        return u8(synthetic.render_frame(60, cam, with_dynamic=True, device=device).gray), \
            cfg.orb, cam
    if name == "stereo":
        T = synthetic.gt_pose(0, KITTI_CAMERA.fps, device)
        return u8(synthetic.render(T, KITTI_CAMERA, False, KITTI_CAMERA.fps, 0).gray), \
            KITTI_ORB, KITTI_CAMERA
    if name == "rig":
        return synthetic.render_frame(3, RIG_CAMERA, with_dynamic=False, device=device).gray, \
            RIG_ORB, RIG_CAMERA
    gray = torch.from_numpy(pattern(name, cam.height, cam.width)).to(device)
    return gray, cfg.orb, cam


def bin_edge_angles(rcp_bin: float, ulps: int = 4) -> np.ndarray:
    """[30, 2 ulps + 1] f32 angles around each edge of the 30 rotation bins:
    the f32 nearest (b + 0.5) / rcp_bin for b = -15 .. 14, and `ulps` f32
    steps either side of it."""
    out = []
    for b in range(-15, 15):
        e = np.float32((b + 0.5) / np.float32(rcp_bin))
        row, lo, hi = [e], e, e
        for _ in range(ulps):
            lo, hi = np.nextafter(lo, np.float32(-np.inf)), np.nextafter(hi, np.float32(np.inf))
            row = [lo, *row, hi]
        out.append(row)
    return np.asarray(out, np.float32)


def axis_moment_pairs(seed: int = 11, n: int = 1000) -> np.ndarray:
    """[k, 2] f32 (m10, m01) pairs on and near the axes: (0, 0) with every
    sign of zero, the axes, denormal and huge components, and n seeded pairs
    with one component 1e-6 of the other."""
    tiny, big = 1.4e-45, 3.0e38
    axes = [(0.0, 0.0), (-0.0, 0.0), (0.0, -0.0), (-0.0, -0.0), (1.0, 0.0), (-1.0, 0.0),
            (0.0, 1.0), (0.0, -1.0), (-1.0, -0.0), (1.0, tiny), (1.0, -tiny), (-1.0, tiny),
            (-1.0, -tiny), (tiny, 1.0), (-tiny, 1.0), (tiny, -1.0), (-tiny, -1.0),
            (big, 1.0), (-big, -1.0), (1.0, big), (3e-7, 2e5), (-2e5, 5e-7), (1e5, -1e5)]
    rng = np.random.default_rng(seed)
    near = rng.normal(0, 1, (n, 2)) * np.where(rng.uniform(size=(n, 1)) < 0.5,
                                               [1.0, 1e-6], [1e-6, 1.0])
    return np.concatenate([np.array(axes), near]).astype(np.float32)
